"""Full-workflow tests through the CLI: db set-targets -> build -> classify
-> abundance -> merge -> report -> verify -> cluster."""

import os

import numpy as np
import pytest

from jn_cuclark_tpu import cli

from .test_builder import rand_seq

K = 9


@pytest.fixture(scope="module")
def dbdir(tmp_path_factory):
    """A reference-layout database directory with toy genomes + taxonomy."""
    root = tmp_path_factory.mktemp("clidb")
    db = root / "db"
    (db / "Custom").mkdir(parents=True)
    tax = db / "taxonomy"
    tax.mkdir()

    rng = np.random.default_rng(77)
    genomes = {}
    accs = ["NC_000001", "NC_000002", "NC_000003"]
    taxids = [562, 28901, 99901]
    for acc, tid in zip(accs, taxids):
        seq = rand_seq(rng, 1200)
        genomes[tid] = seq
        with open(db / "Custom" / f"{acc}.fa", "w") as f:
            f.write(f">{acc}.1 toy genome tax{tid}\n")
            for j in range(0, len(seq), 70):
                f.write(seq[j : j + 70] + "\n")

    # taxonomy dumps (same toy tree as the abundance goldens)
    nodes = [
        (1, 1, "no rank"), (2, 1, "superkingdom"), (1224, 2, "phylum"),
        (1236, 1224, "class"), (91347, 1236, "order"), (543, 91347, "family"),
        (561, 543, "genus"), (562, 561, "species"), (590, 543, "genus"),
        (28901, 590, "species"), (86661, 543, "species group"),
        (99901, 86661, "species"),
    ]
    with open(tax / "nodes.dmp", "w") as f:
        for tid, parent, rank in nodes:
            f.write(f"{tid}\t|\t{parent}\t|\t{rank}\t|\tXX\t|\n")
    names = [
        (1, "root"), (2, "Bacteria"), (1224, "Proteobacteria"),
        (1236, "Gammaproteobacteria"), (91347, "Enterobacterales"),
        (543, "Enterobacteriaceae"), (561, "Escherichia"),
        (562, "Escherichia coli"), (590, "Salmonella"),
        (28901, "Salmonella enterica"), (99901, "Cereus group thing"),
    ]
    with open(tax / "names.dmp", "w") as f:
        for tid, nm in names:
            f.write(f"{tid}\t|\t{nm}\t|\t\t|\tscientific name\t|\n")
    with open(tax / "merged.dmp", "w") as f:
        f.write("900\t|\t562\t|\n")  # a remap
    with open(tax / "nucl_accss", "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        f.write("NC_000001\tNC_000001.1\t900\t1\n")  # remapped -> 562
        f.write("NC_000002\tNC_000002.1\t28901\t2\n")
        f.write("NC_000003\tNC_000003.1\t99901\t3\n")
    for fn in ["citations.dmp", "delnodes.dmp", "division.dmp", "gc.prt",
               "gencode.dmp", "images.dmp"]:
        (tax / fn).touch()

    # reads drawn from the genomes
    reads_path = root / "reads.fa"
    with open(reads_path, "w") as f:
        for i in range(120):
            tid = taxids[i % 3]
            g = genomes[tid]
            pos = rng.integers(0, len(g) - 100)
            f.write(f">r{i}\n{g[pos:pos+100]}\n")
    return root, db, reads_path, taxids, genomes


def run_cli(*argv):
    return cli.main(list(argv))


def test_set_targets_and_build(dbdir, capsys):
    root, db, reads, taxids, genomes = dbdir
    rc = run_cli("db", "set-targets", str(db), "--rank", "species",
                 "--full", "--htsize", "1048573", "-k", str(K))
    assert rc == 0
    tgt = open(db / "targets.txt").read().strip().splitlines()
    assert len(tgt) == 3
    got = {line.split("\t")[1] for line in tgt}
    assert got == {"562", "28901", "99901"}  # incl. merged.dmp remap for 900

    rc = run_cli("db", "build", str(db), "--htsize", "1048573", "-k", str(K))
    assert rc == 0
    out = capsys.readouterr().out
    assert "Database built" in out
    files = os.listdir(db / f"custom_0_canonical")
    assert any(f.endswith(".sz") for f in files)


def test_classify_and_abundance(dbdir, capsys, tmp_path, monkeypatch):
    root, db, reads, taxids, genomes = dbdir
    res = tmp_path / "out"
    rc = run_cli("classify", "-D", str(db), "-O", str(reads), "-R", str(res))
    assert rc == 0
    lines = open(str(res) + ".csv").read().splitlines()
    assert len(lines) == 121
    # every read should be assigned to its source taxid
    right = sum(
        1 for i, l in enumerate(lines[1:]) if l.split(",")[2] == str(taxids[i % 3])
    )
    assert right > 115

    ab = tmp_path / "ab.csv"
    rc = run_cli("abundance", "-D", str(db), "-F", str(res) + ".csv",
                 "-o", str(ab))
    assert rc == 0
    text = open(ab).read()
    assert "Escherichia coli" in text and "Salmonella enterica" in text

    merged = tmp_path / "merged.csv"
    rc = run_cli("merge", str(ab), str(ab), "-o", str(merged))
    assert rc == 0
    rep = tmp_path / "report.txt"
    rc = run_cli("report", str(merged), "-o", str(rep))
    assert rc == 0
    assert open(rep).read().startswith("RESULT")


def test_classify_list_mode_and_gzip(dbdir, tmp_path):
    root, db, reads, taxids, genomes = dbdir
    import gzip as _gz

    # gzip the reads
    gz = tmp_path / "reads.fa.gz"
    with open(reads, "rb") as f, _gz.open(gz, "wb") as g:
        g.write(f.read())
    res = tmp_path / "gzout"
    rc = run_cli("classify", "-D", str(db), "-O", str(gz), "-R", str(res),
                 "--gzipped")
    assert rc == 0
    plain = tmp_path / "plainout"
    run_cli("classify", "-D", str(db), "-O", str(reads), "-R", str(plain))
    assert open(str(res) + ".csv").read() == open(str(plain) + ".csv").read()

    # list mode: objects file of paths + results file of paths
    lst_o = tmp_path / "objects.txt"
    lst_r = tmp_path / "results.txt"
    lst_o.write_text(f"{reads}\n{reads}\n")
    lst_r.write_text(f"{tmp_path}/lst1\n{tmp_path}/lst2\n")
    rc = run_cli("classify", "-D", str(db), "-O", str(lst_o), "-R", str(lst_r))
    assert rc == 0
    assert (tmp_path / "lst1.csv").exists() and (tmp_path / "lst2.csv").exists()
    assert open(tmp_path / "lst1.csv").read() == open(str(plain) + ".csv").read()


def test_verify(dbdir, capsys):
    root, db, reads, taxids, genomes = dbdir
    rc = run_cli("verify", "--db", str(db))
    out = capsys.readouterr().out
    assert "STATUS:" in out
    assert "platform cpu, cpu x 8" in out  # platform and device_kind shown
    assert rc == 0, out


def test_cluster_local(dbdir, tmp_path, capsys):
    root, db, reads, taxids, genomes = dbdir
    # second sample file
    reads2 = tmp_path / "nodeB.fa"
    rng = np.random.default_rng(5)
    with open(reads2, "w") as f:
        for i in range(40):
            g = genomes[taxids[i % 3]]
            pos = rng.integers(0, len(g) - 90)
            f.write(f">b{i}\n{g[pos:pos+90]}\n")
    conf = tmp_path / "cluster.conf"
    import socket
    host = socket.gethostname()
    conf.write_text(
        f"""[cluster]
master = {host}
workers = nodeB

[paths]
cuclark_dir = {tmp_path}
database = {db}
results_dir = results

[reads]
{host} = {reads}
nodeB = {reads2}

[classification]
batch_size = 32

[logging]
level = info
file = cluster_run.log
"""
    )
    rc = run_cli("cluster", "-c", str(conf), "-p")
    assert rc == 0
    rc = run_cli("cluster", "-c", str(conf))
    assert rc == 0
    report = (tmp_path / "results" / "cluster_report.txt").read_text()
    assert "Nodes processed: 2/2" in report
    assert "Speedup:" in report
    assert (tmp_path / "results" / "cluster_abundance.csv").exists()
    log = (tmp_path / "logs" / "cluster_run.log").read_text()
    assert "[INFO]" in log


def test_multi_sample_batch_and_merge(dbdir, tmp_path):
    """BASELINE config 4: classify 8 FASTQ runs on one host, estimate
    abundance per run, merge (kent -m), report."""
    root, db, reads, taxids, genomes = dbdir
    rng = np.random.default_rng(99)
    csvs = []
    for s in range(8):
        fq = tmp_path / f"run{s}.fq"
        with open(fq, "w") as f:
            for i in range(30):
                tid = taxids[(i + s) % 3]
                g = genomes[tid]
                pos = rng.integers(0, len(g) - 80)
                f.write(f"@run{s}_r{i}\n{g[pos:pos+80]}\n+\n{'I'*80}\n")
        res = tmp_path / f"run{s}"
        assert run_cli("classify", "-D", str(db), "-O", str(fq), "-R", str(res)) == 0
        ab = tmp_path / f"run{s}_ab.csv"
        assert run_cli(
            "abundance", "-D", str(db), "-F", str(res) + ".csv", "-o", str(ab)
        ) == 0
        csvs.append(str(ab))
    merged = tmp_path / "all.csv"
    assert run_cli("merge", *csvs, "-o", str(merged)) == 0
    text = open(merged).read().splitlines()
    # 8 x 30 = 240 reads total across the three species + UNKNOWN row
    import re
    counts = [int(l.split(",")[3]) for l in text[1:] if not l.startswith("UNKNOWN")]
    assert sum(counts) >= 230  # nearly all classified
    rep = tmp_path / "rep.txt"
    assert run_cli("report", str(merged), "-o", str(rep)) == 0
    assert "among classified" in open(rep).read()


def test_db_clean(tmp_path):
    db = tmp_path / "cleanme"
    (db / "Custom").mkdir(parents=True)
    (db / "custom_0_canonical").mkdir()
    (db / "targets.txt").write_text("x 1\n")
    (db / ".custom").write_text("x\n")
    (db / "config.json").write_text("{}")
    assert run_cli("db", "clean", str(db), "--yes") == 0
    assert (db / "Custom").exists()
    assert not (db / "custom_0_canonical").exists()
    assert not (db / "targets.txt").exists()


def test_db_update_taxonomy_from_local(tmp_path, capsys):
    """updateTaxonomy.sh equivalent, fetch replaced by --from: extracts
    taxdump.tar.gz, concatenates nucl_gb then nucl_wgs into nucl_accss
    (gunzipping), touches <db>/.taxondata."""
    import gzip
    import tarfile

    dl = tmp_path / "downloads"
    dl.mkdir()
    dmp_names = [
        "citations.dmp", "delnodes.dmp", "division.dmp", "gc.prt",
        "gencode.dmp", "images.dmp", "merged.dmp", "names.dmp", "nodes.dmp",
    ]
    src = tmp_path / "dumps"
    src.mkdir()
    for n in dmp_names:
        (src / n).write_text(f"content of {n}\n")
    with tarfile.open(dl / "taxdump.tar.gz", "w:gz") as t:
        for n in dmp_names:
            t.add(src / n, arcname=n)
    (dl / "nucl_gb.accession2taxid").write_text("A1\t1\tgb\n")
    with gzip.open(dl / "nucl_wgs.accession2taxid.gz", "wt") as f:
        f.write("A2\t2\twgs\n")

    db = tmp_path / "mydb"
    db.mkdir()
    rc = run_cli("db", "update-taxonomy", str(db), "--from", str(dl))
    out = capsys.readouterr().out
    assert rc == 0, out
    tax = db / "taxonomy"
    for n in dmp_names:
        assert (tax / n).read_text() == f"content of {n}\n"
    # nucl_gb first, then nucl_wgs (updateTaxonomy.sh concatenation order)
    assert (tax / "nucl_accss").read_text() == "A1\t1\tgb\nA2\t2\twgs\n"
    assert (db / ".taxondata").exists()

    # without --from: instructions, and exit 1 while files are missing
    db2 = tmp_path / "otherdb"
    db2.mkdir()
    rc = run_cli("db", "update-taxonomy", str(db2))
    out = capsys.readouterr().out
    assert rc == 1 and "taxdump.tar.gz" in out and "missing" in out


def test_dp_requires_shard_db(dbdir, tmp_path):
    """--dp without --shard-db must error, not silently change topology."""
    root, db, reads, taxids, genomes = dbdir
    import pytest

    with pytest.raises(SystemExit, match="shard-db"):
        run_cli(
            "classify", "-D", str(db), "-O", str(reads),
            "-R", str(tmp_path / "x"), "--dp", "2", "-d", "8",
        )
