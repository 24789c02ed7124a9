"""DB builder vs. independent oracle: discriminative k-mer selection,
multiplicity rules, light-mode gap sampling."""

import numpy as np
import pytest

from jn_cuclark_tpu import params
from jn_cuclark_tpu.db import builder
from jn_cuclark_tpu.io import dbformat
from jn_cuclark_tpu.io.targets import TargetsDef, parse_targets

from . import oracle


def write_fasta(path, records, width=0):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            if width:
                for i in range(0, len(seq), width):
                    f.write(seq[i : i + width] + "\n")
            else:
                f.write(seq + "\n")


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


@pytest.fixture
def toy(tmp_path):
    rng = np.random.default_rng(7)
    genomes = {
        "g1": rand_seq(rng, 500),
        "g2": rand_seq(rng, 400),
        "g3": rand_seq(rng, 300),
    }
    # introduce shared subsequence between g1 and g2 (common k-mers)
    shared = rand_seq(rng, 60)
    genomes["g1"] += shared
    genomes["g2"] += shared
    files = {}
    for name, seq in genomes.items():
        p = tmp_path / f"{name}.fa"
        write_fasta(p, [(name, seq)], width=70)
        files[name] = str(p)
    tpath = tmp_path / "targets.txt"
    with open(tpath, "w") as f:
        f.write(f"{files['g1']} 1001\n{files['g2']} 1002\n{files['g3']} 1003\n")
    return tmp_path, tpath, genomes


def test_build_matches_oracle(toy, tmp_path):
    folder, tpath, genomes = toy
    k = 9
    prof = params.tiny(htsize=1021, k=k)
    targets = parse_targets(str(tpath))
    db = builder.build_database(targets, str(folder), prof, k)

    want = oracle.build_db(
        [(genomes["g1"], 0), (genomes["g2"], 1), (genomes["g3"], 2)],
        k,
        label_names=targets.labels,
    )
    got = dict(zip(db.canonical.tolist(), db.labels.tolist()))
    assert got == want
    # the shared block must have produced some common (dropped) k-mers
    assert db.n_mother > len(got)

    # on-disk round trip
    stem = str(folder / prof.db_stem(k, 3, 0, prof.default_gap))
    assert dbformat.db_exists(stem)
    c2, l2 = dbformat.read_db(stem, prof, k)
    assert dict(zip(c2.tolist(), l2.tolist())) == want


def test_build_light_gap(toy):
    folder, tpath, genomes = toy
    k = 9
    prof = params.tiny(htsize=1021, light=True, k=k, gap=4)
    targets = parse_targets(str(tpath))
    db = builder.build_database(targets, str(folder), prof, k, gap=4)
    want = oracle.build_db(
        [(genomes["g1"], 0), (genomes["g2"], 1), (genomes["g3"], 2)],
        k,
        light=True,
        gap=4,
        label_names=targets.labels,
    )
    got = dict(zip(db.canonical.tolist(), db.labels.tolist()))
    assert got == want
    assert len(got) > 0


def test_light_counter_spans_records(tmp_path):
    """The light-mode gap counter is per-file, continuing across records."""
    k = 5
    rng = np.random.default_rng(3)
    recs = [("r1", rand_seq(rng, 23)), ("r2", rand_seq(rng, 17))]
    p = tmp_path / "t.fa"
    write_fasta(p, recs)
    with open(p, "rb") as f:
        occ = builder.extract_occurrences(f.read(), k, light=True, gap=3)
    concat = recs[0][1] + "\x00" + recs[1][1]
    kmers = oracle.nonoverlap_kmers(concat, k)
    want = [v for j, v in enumerate(kmers) if j % 3 == 0]
    assert list(occ.canonical) == want


def test_multiline_fasta_windows_cross_lines(tmp_path):
    """K-mers span line breaks inside a record (newlines are not breaks)."""
    k = 9
    rng = np.random.default_rng(5)
    seq = rand_seq(rng, 100)
    p = tmp_path / "t.fa"
    write_fasta(p, [("x", seq)], width=10)
    with open(p, "rb") as f:
        occ = builder.extract_occurrences(f.read(), k, light=False, gap=0)
    assert list(occ.canonical) == oracle.seq_kmers(seq, k)


def test_invalid_chars_break_runs(tmp_path):
    k = 7
    seq = "ACGTACGTACNGTACGTACGT"
    p = tmp_path / "t.fa"
    write_fasta(p, [("x", seq)])
    with open(p, "rb") as f:
        occ = builder.extract_occurrences(f.read(), k, light=False, gap=0)
    assert list(occ.canonical) == oracle.seq_kmers(seq, k)


def test_min_count_target(tmp_path):
    """count > minT filter: a k-mer must occur more than minT times."""
    k = 5
    # one repeated kmer (3x) and the rest unique-ish
    seq = "AACCGTTGCAACCGTCCCTTAACCGT"  # contains 'AACCG' three times
    p = tmp_path / "t.fa"
    write_fasta(p, [("x", seq)])
    tpath = tmp_path / "targets.txt"
    with open(tpath, "w") as f:
        f.write(f"{p} 77\n")
    prof = params.tiny(htsize=1021, k=k)
    targets = parse_targets(str(tpath))
    db2 = builder.build_database(targets, str(tmp_path), prof, k, min_count_target=2)
    want = oracle.build_db([(seq, 0)], k, min_count_target=2, label_names=["77"])
    assert dict(zip(db2.canonical.tolist(), db2.labels.tolist())) == want
    assert len(db2.canonical) >= 1  # the triple-repeat survives


def test_centromere_labels(tmp_path):
    """Third targets.txt column: multiplicity-2 k-mers with a matching
    centromere label are kept and relabeled."""
    k = 5
    rng = np.random.default_rng(11)
    shared = rand_seq(rng, 40)
    s1 = rand_seq(rng, 60) + shared
    s2 = rand_seq(rng, 60) + shared
    p1, p2 = tmp_path / "a.fa", tmp_path / "b.fa"
    write_fasta(p1, [("a", s1)])
    write_fasta(p2, [("b", s2)])
    tpath = tmp_path / "targets.txt"
    # labels chr1A / chr1B share the prefix "chr1"; centromere label chr1C
    with open(tpath, "w") as f:
        f.write(f"{p1} chr1A chr1C\n{p2} chr1B chr1C\n")
    prof = params.tiny(htsize=1021, k=k)
    targets = parse_targets(str(tpath))
    db = builder.build_database(targets, str(tmp_path), prof, k)
    got = dict(zip(db.canonical.tolist(), db.labels.tolist()))
    # shared kmers get multiplicity 2 (same prefix) -> relabeled to chr1C (idx 2)
    c_idx = targets.label_index["chr1C"]
    shared_kmers = set(oracle.seq_kmers(shared, k))
    only1 = set(oracle.seq_kmers(s1, k)) - set(oracle.seq_kmers(s2, k))
    assert any(got.get(v) == c_idx for v in shared_kmers)
    for v in only1:
        if v in got:
            assert got[v] == 0


def test_device_aggregation_matches_host(toy):
    """Device sort+segment aggregation == host aggregation."""
    folder, tpath, genomes = toy
    k = 9
    prof = params.tiny(htsize=1021, k=k)
    import shutil, os
    d1 = str(folder / "host")
    d2 = str(folder / "dev")
    os.makedirs(d1, exist_ok=True)
    os.makedirs(d2, exist_ok=True)
    targets = parse_targets(str(tpath))
    db1 = builder.build_database(targets, d1, prof, k, device=False)
    db2 = builder.build_database(targets, d2, prof, k, device=True)
    assert np.array_equal(db1.canonical, db2.canonical)
    assert np.array_equal(db1.labels, db2.labels)
    assert db1.n_mother == db2.n_mother
    stem = prof.db_stem(k, targets.n_targets, 0, prof.default_gap)
    for ext in (".sz", ".ky", ".lb"):
        with open(os.path.join(d1, stem + ext), "rb") as a, open(
            os.path.join(d2, stem + ext), "rb"
        ) as b:
            assert a.read() == b.read(), ext


def test_saturating_group_sum_paths():
    """Native, vectorized-fallback, and brute-force saturating sums agree
    (lElement.AddToCount, dataType.hh:333-334)."""
    import numpy as np

    from jn_cuclark_tpu.db.builder import _saturating_group_sum
    from jn_cuclark_tpu.utils import native

    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 40, size=200)
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(bounds[-1])
    v = rng.integers(1, 120, size=n).astype(np.int64)  # many groups saturate

    def brute(bounds, v):
        out = np.zeros(len(bounds) - 1, np.int64)
        for g in range(len(bounds) - 1):
            s = 0
            for val in v[bounds[g] : bounds[g + 1]]:
                if s + val < 255:
                    s += val
            out[g] = s
        return out

    want = brute(bounds, v)
    assert np.array_equal(_saturating_group_sum(bounds, v), want)
    if native.available():
        assert np.array_equal(native.saturating_group_sum(bounds, v), want)
    # force the numpy fallback path too
    import unittest.mock as mock

    with mock.patch.object(native, "available", return_value=False):
        assert np.array_equal(_saturating_group_sum(bounds, v), want)
    assert (want >= 255).sum() == 0 and (want >= 200).sum() > 0


def test_spectrum_input_build(tmp_path):
    """End-to-end DB build from spectrum-form target files ("<kmer> <count>"
    lines, CuCLARK_hh.hh:861-877, 1298-1308): min-count filtering, weighted
    lElement saturation at 254, and cross-target RemoveCommon."""
    import numpy as np

    from jn_cuclark_tpu import params
    from jn_cuclark_tpu.db import builder
    from jn_cuclark_tpu.db.builder import _canon_of_string
    from jn_cuclark_tpu.io import dbformat
    from jn_cuclark_tpu.io.targets import parse_targets

    k = 9
    prof = params.tiny(htsize=1021, k=k)
    rng = np.random.default_rng(21)
    kmers = ["".join(rng.choice(list("ACGT"), size=k)) for _ in range(40)]
    kmers = list(dict.fromkeys(kmers))
    shared, only1, only2 = kmers[0], kmers[1:20], kmers[20:]

    with open(tmp_path / "t1.spec", "w") as f:
        f.write(f"{shared} 9\n")
        for s in only1:
            f.write(f"{s} 5\n")
        f.write(f"{only1[0]} 300\n")  # re-listed: counts saturate, mult 1
    with open(tmp_path / "t2.spec", "w") as f:
        f.write(f"{shared} 4\n")
        for s in only2:
            f.write(f"{s} 1\n")  # filtered out at min_count_target=2
    with open(tmp_path / "targets.txt", "w") as f:
        f.write(f"{tmp_path}/t1.spec 700\n{tmp_path}/t2.spec 701\n")
    targets = parse_targets(str(tmp_path / "targets.txt"))
    builder.build_database(targets, str(tmp_path), prof, k, min_count_target=2)
    stem = str(tmp_path / prof.db_stem(k, 2, 2, prof.default_gap))
    c, l = dbformat.read_db(stem, prof, k)
    got = dict(zip(c.tolist(), l.tolist()))
    # spectrum entries with count <= minT never enter the mother table
    # (CuCLARK_hh.hh:1302: "if (mfreq > minT)"), so t2's count-1 k-mers are
    # absent and the shared k-mer (mult 2) is removed by RemoveCommon
    want = {_canon_of_string(s): 0 for s in only1}
    assert got == want


def _one_target_db(tmp_path, seed, n=500):
    rng = np.random.default_rng(seed)
    write_fasta(tmp_path / "g.fa", [("g", rand_seq(rng, n))])
    (tmp_path / "targets.txt").write_text(f"{tmp_path}/g.fa 600\n")
    return parse_targets(str(tmp_path / "targets.txt"))


@pytest.mark.parametrize("part_min", [str(1 << 40), "0"])
def test_device_build_failure_raises(tmp_path, monkeypatch, part_min):
    """db build --device never hides a device error behind the host
    build: a failing device aggregate fails the build, in the one-shot
    and in the partitioned path."""
    from jn_cuclark_tpu.db import device_build

    targets = _one_target_db(tmp_path, 33)
    prof = params.tiny(htsize=1021, k=9)

    def boom(*a, **k):
        raise RuntimeError("device aggregate failed")

    monkeypatch.setattr(device_build, "aggregate_device", boom)
    monkeypatch.setenv("CLARK_TPU_BUILD_PART_MIN", part_min)
    with pytest.raises(RuntimeError, match="device aggregate failed"):
        builder.build_database(targets, str(tmp_path), prof, 9, device=True)
    stem = str(tmp_path / prof.db_stem(9, 1, 0, prof.default_gap))
    assert not dbformat.db_exists(stem)


def test_too_many_targets_rejected(tmp_path):
    """Labels are u16 (MTRGTS, dataType.hh:46); past the cap the build must
    fail loudly instead of silently truncating labels."""
    n = params.MTRGTS + 1
    targets = TargetsDef(
        files=[], file_labels=[], file_labels_c=[],
        labels=[f"L{i}" for i in range(n)], labels_c=[],
    )
    with pytest.raises(ValueError, match="16-bit"):
        builder.build_database(targets, str(tmp_path), params.FULL, 31)


def test_partitioned_build_byte_identical(tmp_path, monkeypatch):
    """The bounded-memory partitioned build (canonical-range partitioned
    aggregate + remainder-partitioned serializer) must write byte-identical
    .sz/.ky/.lb to the one-shot native path."""
    from jn_cuclark_tpu.utils import native

    if not native.available():
        pytest.skip("native partitioned build unavailable")
    rng = np.random.default_rng(31)
    d1, d2 = tmp_path / "oneshot", tmp_path / "parts"
    d1.mkdir(), d2.mkdir()
    genomes = [rand_seq(rng, 5000) for _ in range(4)]
    shared = rand_seq(rng, 200)
    genomes[0] += shared
    genomes[1] += shared  # common k-mers exercise RemoveCommon
    tpath = tmp_path / "targets.txt"
    with open(tpath, "w") as f:
        for i, g in enumerate(genomes):
            p = tmp_path / f"pg{i}.fa"
            write_fasta(p, [(f"pg{i}", g)], width=70)
            f.write(f"{p} {5000 + i}\n")
    targets = parse_targets(str(tpath))
    prof = params.tiny(htsize=65521, k=13)
    monkeypatch.setenv("CLARK_TPU_BUILD_PART_MIN", str(1 << 40))  # force off
    one = builder.build_database(targets, str(d1), prof, 13)
    monkeypatch.setenv("CLARK_TPU_BUILD_PART_MIN", "0")  # force on
    part = builder.build_database(targets, str(d2), prof, 13)
    assert np.array_equal(one.canonical, part.canonical)
    assert np.array_equal(one.labels, part.labels)
    assert one.n_mother == part.n_mother
    stem = prof.db_stem(13, targets.n_targets, 0, prof.default_gap)
    for ext in (".sz", ".ky", ".lb"):
        a = (d1 / (stem + ext)).read_bytes()
        b = (d2 / (stem + ext)).read_bytes()
        assert a == b, ext


def test_serialize_db_parts_byte_identical():
    """Remainder-partitioned serializer vs one-shot vs numpy, all widths."""
    from jn_cuclark_tpu.io import dbformat
    from jn_cuclark_tpu.utils import native

    if not native.available():
        pytest.skip("native partitioned build unavailable")
    rng = np.random.default_rng(33)
    htsize = 65521
    k = 13
    canon = np.unique(
        rng.integers(0, 1 << (2 * k), size=200_000, dtype=np.uint64)
    )
    labels = rng.integers(0, 50, size=len(canon)).astype(np.uint16)
    rem_bits = max(int(htsize - 1).bit_length(), 1)
    a = native.serialize_db(canon, labels, htsize, rem_bits, np.uint16)
    for pbits in (1, 3, 5):
        b = native.serialize_db_parts(
            canon, labels, htsize, rem_bits, np.uint16, pbits
        )
        for x, y in zip(a, b):
            assert np.array_equal(x, y), pbits


def test_partitioned_device_build_matches_host(tmp_path, monkeypatch):
    """Chunked device aggregation (per-partition, padded shape ladder)
    must produce the same DB as the host partitioned path."""
    from jn_cuclark_tpu.utils import native

    if not native.available():
        pytest.skip("native partitioned build unavailable")
    rng = np.random.default_rng(41)
    d1, d2 = tmp_path / "host", tmp_path / "dev"
    d1.mkdir(), d2.mkdir()
    genomes = [rand_seq(rng, 4000) for _ in range(3)]
    genomes[0] += genomes[1][:150]  # overlap -> common k-mers
    tpath = tmp_path / "targets.txt"
    with open(tpath, "w") as f:
        for i, g in enumerate(genomes):
            p = tmp_path / f"dg{i}.fa"
            write_fasta(p, [(f"dg{i}", g)], width=70)
            f.write(f"{p} {7000 + i}\n")
    targets = parse_targets(str(tpath))
    prof = params.tiny(htsize=65521, k=13)
    monkeypatch.setenv("CLARK_TPU_BUILD_PART_MIN", "0")
    host = builder.build_database(targets, str(d1), prof, 13)
    dev = builder.build_database(targets, str(d2), prof, 13, device=True)
    assert np.array_equal(host.canonical, dev.canonical)
    assert np.array_equal(host.labels, dev.labels)
    assert host.n_mother == dev.n_mother


def test_device_build_cli_matches_host(tmp_path):
    """`clark-tpu db build --device` writes the host build's files."""
    from jn_cuclark_tpu import cli
    from jn_cuclark_tpu.database import DBConfig

    rng = np.random.default_rng(44)
    db = tmp_path / "db"
    sub = db / "sub"
    sub.mkdir(parents=True)
    with open(db / "targets.txt", "w") as f:
        for i in range(3):
            write_fasta(db / f"g{i}.fa", [(f"g{i}", rand_seq(rng, 600))])
            f.write(f"{db}/g{i}.fa {601 + i}\n")
    prof = params.tiny(htsize=1021, k=9)
    DBConfig(
        db_dir=str(db), targets=str(db / "targets.txt"), subdb=str(sub),
        rank=0, profile_name=prof.name, k=9, gap=prof.default_gap,
        min_count_target=0, htsize=prof.htsize, light=prof.light,
    ).save()
    stem = prof.db_stem(9, 3, 0, prof.default_gap)
    files = {}
    for flags in ([], ["--device"]):
        assert cli.main(["db", "build", str(db), "--htsize", "1021",
                         "-k", "9", *flags]) == 0
        files[bool(flags)] = [
            (sub / (stem + ext)).read_bytes() for ext in (".sz", ".ky", ".lb")
        ]
    assert files[True] == files[False]
