"""Two-process jax.distributed cluster run on local CPU: exercises the cross-host
allgather result merge and coordinator report (the kent-mpi multi-node path,
without SSH/MPI)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from .test_builder import rand_seq, write_fasta


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cluster(tmp_path):
    rng = np.random.default_rng(31)
    # tiny database directory with config.json
    dbdir = tmp_path / "db"
    (dbdir / "sub").mkdir(parents=True)
    genomes = [rand_seq(rng, 400) for _ in range(2)]
    with open(dbdir / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = dbdir / f"g{i}.fa"
            write_fasta(p, [(f"g{i}", g)])
            tf.write(f"{p} {700 + i}\n")
    # minimal taxonomy so per-node abundance estimation works
    tax = dbdir / "taxonomy"
    tax.mkdir()
    with open(tax / "nodes.dmp", "w") as f:
        f.write("1\t|\t1\t|\tno rank\t|\tX\t|\n")
        f.write("700\t|\t1\t|\tspecies\t|\tX\t|\n")
        f.write("701\t|\t1\t|\tspecies\t|\tX\t|\n")
    with open(tax / "names.dmp", "w") as f:
        f.write("700\t|\tSpecies A\t|\t\t|\tscientific name\t|\n")
        f.write("701\t|\tSpecies B\t|\t\t|\tscientific name\t|\n")

    from jn_cuclark_tpu import params
    from jn_cuclark_tpu.database import DBConfig
    from jn_cuclark_tpu.db import builder
    from jn_cuclark_tpu.io.targets import parse_targets

    prof = params.tiny(htsize=2039, k=9)
    targets = parse_targets(str(dbdir / "targets.txt"))
    builder.build_database(targets, str(dbdir / "sub"), prof, 9)
    cfg = DBConfig(
        db_dir=str(dbdir),
        targets=str(dbdir / "targets.txt"),
        subdb=str(dbdir / "sub"),
        rank=0,
        profile_name=prof.name,
        k=9,
        gap=prof.default_gap,
        min_count_target=0,
        htsize=prof.htsize,
        light=prof.light,
    )
    cfg.save()

    # per-node reads
    for node in ("nodeA", "nodeB"):
        with open(tmp_path / f"{node}.fa", "w") as f:
            for i in range(20):
                g = genomes[i % 2]
                pos = rng.integers(0, len(g) - 60)
                f.write(f">{node}_{i}\n{g[pos:pos+60]}\n")

    port = free_port()
    conf = tmp_path / "cluster.conf"
    conf.write_text(
        f"""[cluster]
master = nodeA
workers = nodeB
backend = jax_distributed
coordinator_address = 127.0.0.1:{port}

[paths]
cuclark_dir = {tmp_path}
database = {dbdir}
results_dir = results

[reads]
nodeA = {tmp_path}/nodeA.fa
nodeB = {tmp_path}/nodeB.fa

[logging]
level = info
file = cluster_run.log
"""
    )

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    env["CLARK_TPU_NUM_PROCESSES"] = "2"
    env.pop("XLA_FLAGS", None)

    procs = []
    for pid, node in enumerate(("nodeA", "nodeB")):
        e = dict(env)
        e["CLARK_TPU_PROCESS_ID"] = str(pid)
        e["CLARK_TPU_NODE_NAME"] = node
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "jn_cuclark_tpu.cli", "cluster", "-c", str(conf)],
                env=e,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            pytest.fail(f"cluster process hung:\n{err.decode()[-2000:]}")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, err.decode()[-2000:]

    report = (tmp_path / "results" / "cluster_report.txt").read_text()
    assert "Nodes processed: 2/2" in report
    assert "nodeA" in report and "nodeB" in report
    assert (tmp_path / "results" / "cluster_abundance.csv").exists()
    # both per-node result CSVs exist with 20 rows each
    for node in ("nodeA", "nodeB"):
        csv = (tmp_path / "results" / f"{node}_{node}.csv").read_text().splitlines()
        assert len(csv) == 21


def test_allgather_bytes_large_payload():
    """Round 1 silently truncated gathered payloads at 64 KiB; now the
    gather sizes itself from the max payload length."""
    from jn_cuclark_tpu.cluster import allgather_bytes

    payload = b"x" * (1 << 17) + b"END"
    rows = allgather_bytes(payload)
    assert rows == [payload]


def test_two_process_db_sharded(tmp_path):
    """BASELINE config 5 / north-star mode: the DB sharded ACROSS PROCESSES
    (1 CPU device each), reads classified jointly, counts merged with psum
    over the distributed mesh — output byte-equal to single-process."""
    rng = np.random.default_rng(77)
    dbdir = tmp_path / "db"
    (dbdir / "sub").mkdir(parents=True)
    genomes = [rand_seq(rng, 500) for _ in range(3)]
    with open(dbdir / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = dbdir / f"g{i}.fa"
            write_fasta(p, [(f"g{i}", g)])
            tf.write(f"{p} {800 + i}\n")
    tax = dbdir / "taxonomy"
    tax.mkdir()
    with open(tax / "nodes.dmp", "w") as f:
        f.write("1\t|\t1\t|\tno rank\t|\tX\t|\n")
        for t in (800, 801, 802):
            f.write(f"{t}\t|\t1\t|\tspecies\t|\tX\t|\n")
    with open(tax / "names.dmp", "w") as f:
        for t in (800, 801, 802):
            f.write(f"{t}\t|\tSpecies {t}\t|\t\t|\tscientific name\t|\n")

    from jn_cuclark_tpu import params
    from jn_cuclark_tpu.database import DBConfig
    from jn_cuclark_tpu.db import builder
    from jn_cuclark_tpu.io.targets import parse_targets

    prof = params.tiny(htsize=2039, k=9)
    targets = parse_targets(str(dbdir / "targets.txt"))
    builder.build_database(targets, str(dbdir / "sub"), prof, 9)
    cfg = DBConfig(
        db_dir=str(dbdir),
        targets=str(dbdir / "targets.txt"),
        subdb=str(dbdir / "sub"),
        rank=0,
        profile_name=prof.name,
        k=9,
        gap=prof.default_gap,
        min_count_target=0,
        htsize=prof.htsize,
        light=prof.light,
    )
    cfg.save()

    for node in ("nodeA", "nodeB"):
        with open(tmp_path / f"{node}.fa", "w") as f:
            for i in range(30):
                g = genomes[i % 3]
                pos = rng.integers(0, len(g) - 70)
                f.write(f">{node}_{i}\n{g[pos:pos+70]}\n")

    port = free_port()
    conf = tmp_path / "cluster.conf"
    conf.write_text(
        f"""[cluster]
master = nodeA
workers = nodeB
backend = jax_distributed
coordinator_address = 127.0.0.1:{port}

[paths]
cuclark_dir = {tmp_path}
database = {dbdir}
results_dir = results

[classification]
shard_db = true
db_cycles = 2

[reads]
nodeA = {tmp_path}/nodeA.fa
nodeB = {tmp_path}/nodeB.fa

[logging]
level = info
file = cluster_run.log
"""
    )

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    env["CLARK_TPU_NUM_PROCESSES"] = "2"
    env.pop("XLA_FLAGS", None)

    procs = []
    for pid in range(2):
        e = dict(env)
        e["CLARK_TPU_PROCESS_ID"] = str(pid)
        e["CLARK_TPU_NODE_NAME"] = "nodeA" if pid == 0 else "nodeB"
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "jn_cuclark_tpu.cli", "cluster", "-c", str(conf)],
                env=e,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            pytest.fail(f"sharded cluster process hung:\n{err.decode()[-2000:]}")
        assert p.returncode == 0, err.decode()[-2000:]

    report = (tmp_path / "results" / "cluster_report.txt").read_text()
    assert "Nodes processed: 2/2" in report
    assert (tmp_path / "results" / "cluster_abundance.csv").exists()

    # byte-equality vs single-process classification of the same inputs
    from jn_cuclark_tpu.engine import Classifier

    clf = Classifier.load(str(dbdir / "sub"), targets, prof, 9)
    for node in ("nodeA", "nodeB"):
        want = tmp_path / f"{node}_ref"
        clf.classify_file(str(tmp_path / f"{node}.fa"), str(want))
        got = (tmp_path / "results" / f"{node}_{node}.csv").read_bytes()
        assert got == (tmp_path / f"{node}_ref.csv").read_bytes(), node


def test_two_process_2d_dpdb(tmp_path):
    """2-D dp x db over processes: table rows sharded across the 2 processes
    (db axis, cross-host analogue) AND read rows across each process's 2 local CPU
    devices (dp axis) — output byte-equal to single-process."""
    rng = np.random.default_rng(55)
    dbdir = tmp_path / "db"
    (dbdir / "sub").mkdir(parents=True)
    genomes = [rand_seq(rng, 500) for _ in range(3)]
    with open(dbdir / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = dbdir / f"g{i}.fa"
            write_fasta(p, [(f"g{i}", g)])
            tf.write(f"{p} {900 + i}\n")
    tax = dbdir / "taxonomy"
    tax.mkdir()
    with open(tax / "nodes.dmp", "w") as f:
        f.write("1\t|\t1\t|\tno rank\t|\tX\t|\n")
        for t in (900, 901, 902):
            f.write(f"{t}\t|\t1\t|\tspecies\t|\tX\t|\n")
    with open(tax / "names.dmp", "w") as f:
        for t in (900, 901, 902):
            f.write(f"{t}\t|\tSpecies {t}\t|\t\t|\tscientific name\t|\n")

    from jn_cuclark_tpu import params
    from jn_cuclark_tpu.database import DBConfig
    from jn_cuclark_tpu.db import builder
    from jn_cuclark_tpu.io.targets import parse_targets

    prof = params.tiny(htsize=2039, k=9)
    targets = parse_targets(str(dbdir / "targets.txt"))
    builder.build_database(targets, str(dbdir / "sub"), prof, 9)
    DBConfig(
        db_dir=str(dbdir), targets=str(dbdir / "targets.txt"),
        subdb=str(dbdir / "sub"), rank=0, profile_name=prof.name, k=9,
        gap=prof.default_gap, min_count_target=0, htsize=prof.htsize,
        light=prof.light,
    ).save()

    with open(tmp_path / "sample.fa", "w") as f:
        for i in range(40):
            g = genomes[i % 3]
            pos = rng.integers(0, len(g) - 70)
            f.write(f">s_{i}\n{g[pos:pos+70]}\n")

    port = free_port()
    conf = tmp_path / "cluster.conf"
    conf.write_text(
        f"""[cluster]
master = nodeA
workers = nodeB
backend = jax_distributed
coordinator_address = 127.0.0.1:{port}

[paths]
cuclark_dir = {tmp_path}
database = {dbdir}
results_dir = results

[classification]
shard_db = true
dp = 2

[reads]
nodeA = {tmp_path}/sample.fa

[logging]
level = info
file = cluster_run.log
"""
    )

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    env["CLARK_TPU_NUM_PROCESSES"] = "2"
    # two virtual CPU devices per process -> global mesh [dp=2, db=2]
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    procs = []
    for pid in range(2):
        e = dict(env)
        e["CLARK_TPU_PROCESS_ID"] = str(pid)
        e["CLARK_TPU_NODE_NAME"] = "nodeA" if pid == 0 else "nodeB"
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "jn_cuclark_tpu.cli", "cluster", "-c", str(conf)],
                env=e,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            pytest.fail(f"2-D cluster process hung:\n{err.decode()[-2000:]}")
        assert p.returncode == 0, err.decode()[-2000:]

    from jn_cuclark_tpu.engine import Classifier

    clf = Classifier.load(str(dbdir / "sub"), targets, prof, 9)
    clf.classify_file(str(tmp_path / "sample.fa"), str(tmp_path / "ref"))
    got = (tmp_path / "results" / "nodeA_sample.csv").read_bytes()
    assert got == (tmp_path / "ref.csv").read_bytes()


def test_cluster_self_launch(tmp_path):
    """ONE command starts the whole 2-process jax_distributed run: `cluster
    --launch` SSH-spawns each worker with process ids preset and streams
    logs (kent-mpi launcher mode, kent_mpi.cpp:753-915; SSH stubbed to run
    locally)."""
    rng = np.random.default_rng(13)
    dbdir = tmp_path / "db"
    (dbdir / "sub").mkdir(parents=True)
    genomes = [rand_seq(rng, 400) for _ in range(2)]
    with open(dbdir / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = dbdir / f"g{i}.fa"
            write_fasta(p, [(f"g{i}", g)])
            tf.write(f"{p} {750 + i}\n")
    tax = dbdir / "taxonomy"
    tax.mkdir()
    with open(tax / "nodes.dmp", "w") as f:
        f.write("1\t|\t1\t|\tno rank\t|\tX\t|\n")
        for t in (750, 751):
            f.write(f"{t}\t|\t1\t|\tspecies\t|\tX\t|\n")
    with open(tax / "names.dmp", "w") as f:
        for t in (750, 751):
            f.write(f"{t}\t|\tSpecies {t}\t|\t\t|\tscientific name\t|\n")

    from jn_cuclark_tpu import params
    from jn_cuclark_tpu.database import DBConfig
    from jn_cuclark_tpu.db import builder
    from jn_cuclark_tpu.io.targets import parse_targets

    prof = params.tiny(htsize=2039, k=9)
    targets = parse_targets(str(dbdir / "targets.txt"))
    builder.build_database(targets, str(dbdir / "sub"), prof, 9)
    DBConfig(
        db_dir=str(dbdir), targets=str(dbdir / "targets.txt"),
        subdb=str(dbdir / "sub"), rank=0, profile_name=prof.name, k=9,
        gap=prof.default_gap, min_count_target=0, htsize=prof.htsize,
        light=prof.light,
    ).save()

    for node in ("nodeA", "nodeB"):
        with open(tmp_path / f"{node}.fa", "w") as f:
            for i in range(15):
                g = genomes[i % 2]
                pos = rng.integers(0, len(g) - 60)
                f.write(f">{node}_{i}\n{g[pos:pos+60]}\n")

    # "ssh" stub: drop the hostname, run the remote command locally
    stub = tmp_path / "fakessh"
    stub.write_text("#!/bin/sh\nshift\nexec sh -c \"$*\"\n")
    stub.chmod(0o755)

    port = free_port()
    conf = tmp_path / "cluster.conf"
    conf.write_text(
        f"""[cluster]
master = nodeA
workers = nodeB
backend = jax_distributed
coordinator_address = 127.0.0.1:{port}
ssh_command = {stub}
launch_command = {sys.executable} -m jn_cuclark_tpu.cli

[paths]
cuclark_dir = {tmp_path}
database = {dbdir}
results_dir = results

[reads]
nodeA = {tmp_path}/nodeA.fa
nodeB = {tmp_path}/nodeB.fa

[logging]
level = info
file = cluster_run.log
"""
    )

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    env.pop("XLA_FLAGS", None)

    r = subprocess.run(
        [sys.executable, "-m", "jn_cuclark_tpu.cli", "cluster",
         "-c", str(conf), "--launch"],
        env=env, capture_output=True, text=True, timeout=240,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    combined = r.stdout + r.stderr
    assert "[nodeB] SSH preflight OK" in combined
    assert "spawned as process 0/2" in combined
    report = (tmp_path / "results" / "cluster_report.txt").read_text()
    assert "Nodes processed: 2/2" in report
    assert (tmp_path / "results" / "cluster_abundance.csv").exists()
    for node in ("nodeA", "nodeB"):
        csv = (tmp_path / "results" / f"{node}_{node}.csv").read_text().splitlines()
        assert len(csv) == 16


def test_launch_duplicate_workers_rejected(tmp_path):
    """Duplicate hosts in [cluster] workers would collapse process
    identities (hostname-based) — the launcher lints and refuses."""
    from jn_cuclark_tpu import cluster
    from jn_cuclark_tpu.utils.logging import ClusterLogger

    conf = tmp_path / "c.conf"
    conf.write_text(
        "[cluster]\nmaster = hostA\nworkers = hostB, hostB\n"
        "backend = jax_distributed\n"
        f"[paths]\ncuclark_dir = {tmp_path}\ndatabase_dir = {tmp_path}\n"
        f"results_dir = {tmp_path}\n[reads]\nhostA = {tmp_path}/r.fa\n"
    )
    cfg = cluster.ClusterConfig.load(str(conf))
    log = ClusterLogger(level="ERROR", logfile=str(tmp_path / "l.log"))
    assert cluster.launch(cfg, log, str(conf)) == 1
    assert "duplicate host" in (tmp_path / "l.log").read_text()


def test_worker_death_contained(tmp_path):
    """Kill one of 2 processes mid-run (after classify,
    before reporting) — the master must NOT hang on a collective, must
    report the dead worker's node FAILED, and must finish its own sample
    (kent_mpi.cpp:518-521, 712-727 containment parity)."""
    rng = np.random.default_rng(41)
    dbdir = tmp_path / "db"
    (dbdir / "sub").mkdir(parents=True)
    genomes = [rand_seq(rng, 400) for _ in range(2)]
    with open(dbdir / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = dbdir / f"g{i}.fa"
            write_fasta(p, [(f"g{i}", g)])
            tf.write(f"{p} {760 + i}\n")
    tax = dbdir / "taxonomy"
    tax.mkdir()
    with open(tax / "nodes.dmp", "w") as f:
        f.write("1\t|\t1\t|\tno rank\t|\tX\t|\n")
        for t in (760, 761):
            f.write(f"{t}\t|\t1\t|\tspecies\t|\tX\t|\n")
    with open(tax / "names.dmp", "w") as f:
        for t in (760, 761):
            f.write(f"{t}\t|\tSpecies {t}\t|\t\t|\tscientific name\t|\n")

    from jn_cuclark_tpu import params
    from jn_cuclark_tpu.database import DBConfig
    from jn_cuclark_tpu.db import builder
    from jn_cuclark_tpu.io.targets import parse_targets

    prof = params.tiny(htsize=2039, k=9)
    targets = parse_targets(str(dbdir / "targets.txt"))
    builder.build_database(targets, str(dbdir / "sub"), prof, 9)
    DBConfig(
        db_dir=str(dbdir), targets=str(dbdir / "targets.txt"),
        subdb=str(dbdir / "sub"), rank=0, profile_name=prof.name, k=9,
        gap=prof.default_gap, min_count_target=0, htsize=prof.htsize,
        light=prof.light,
    ).save()

    for node in ("nodeA", "nodeB"):
        with open(tmp_path / f"{node}.fa", "w") as f:
            for i in range(12):
                g = genomes[i % 2]
                pos = rng.integers(0, len(g) - 60)
                f.write(f">{node}_{i}\n{g[pos:pos+60]}\n")

    port = free_port()
    conf = tmp_path / "cluster.conf"
    conf.write_text(
        f"""[cluster]
master = nodeA
workers = nodeB
backend = jax_distributed
coordinator_address = 127.0.0.1:{port}
report_port = {free_port()}
report_timeout = 20

[paths]
cuclark_dir = {tmp_path}
database = {dbdir}
results_dir = results

[reads]
nodeA = {tmp_path}/nodeA.fa
nodeB = {tmp_path}/nodeB.fa

[logging]
level = info
file = cluster_run.log
"""
    )

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    env["CLARK_TPU_NUM_PROCESSES"] = "2"
    env.pop("XLA_FLAGS", None)

    procs = []
    for pid, node in enumerate(("nodeA", "nodeB")):
        e = dict(env)
        e["CLARK_TPU_PROCESS_ID"] = str(pid)
        e["CLARK_TPU_NODE_NAME"] = node
        if pid == 1:
            e["CLARK_TPU_FAULT_DIE_BEFORE_REPORT"] = "1"  # kill mid-run
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "jn_cuclark_tpu.cli", "cluster",
                 "-c", str(conf)],
                env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )
        )
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            pytest.fail(f"master hung on dead worker:\n{err.decode()[-2000:]}")
        outs.append((p.returncode, out, err))
    # the worker died by injection; the master must exit 1 (partial) but
    # NOT hang and NOT crash
    assert outs[1][0] == 3
    assert outs[0][0] == 1, outs[0][2].decode()[-2000:]

    report = (tmp_path / "results" / "cluster_report.txt").read_text()
    assert "Nodes processed: 1/2" in report
    assert "no report from process 1" in report
    # master's own sample completed
    csv = (tmp_path / "results" / "nodeA_nodeA.csv").read_text().splitlines()
    assert len(csv) == 13
    # dead worker's node is reported FAILED
    nb = report.split("nodeB:")[1]
    assert "FAILED" in nb.split("\n\n")[0]


def test_card_per_process():
    """Processes that share a machine get one card each; a process alone
    on its machine keeps all of its cards."""
    from jn_cuclark_tpu.cluster import card_per_process

    here = {"gpu-host"}
    assert card_per_process(["gpu-host", "nodeB", "nodeC"], here) == [
        None, None, None
    ]
    assert card_per_process(
        ["m", "localhost", "gpu-host", "nodeB", "127.0.0.1"], here
    ) == ["0", "1", "2", None, "3"]


def test_launch_gives_colocated_processes_their_own_card(tmp_path):
    """`cluster --launch` with the master and a worker on this machine: the
    spawned processes see CUDA_VISIBLE_DEVICES 0 and 1 (the launch command
    is stubbed to print it)."""
    from jn_cuclark_tpu import cluster
    from jn_cuclark_tpu.utils.logging import ClusterLogger

    stub = tmp_path / "fakessh"
    stub.write_text("#!/bin/sh\nshift\nexec sh -c \"$*\"\n")
    stub.chmod(0o755)
    show = tmp_path / "show"
    show.write_text("#!/bin/sh\necho card=$CUDA_VISIBLE_DEVICES "
                    "pid=$CLARK_TPU_PROCESS_ID\n")
    show.chmod(0o755)
    conf = tmp_path / "c.conf"
    conf.write_text(
        "[cluster]\nmaster = hostA\nworkers = localhost\n"
        f"backend = jax_distributed\nssh_command = {stub}\n"
        f"launch_command = {show}\n"
        f"[paths]\ncuclark_dir = {tmp_path}\ndatabase = {tmp_path}\n"
        f"results_dir = {tmp_path}\n[reads]\nhostA = {tmp_path}/r.fa\n"
        f"localhost = {tmp_path}/r.fa\n"
    )
    cfg = cluster.ClusterConfig.load(str(conf))
    log = ClusterLogger(level="INFO", logfile=str(tmp_path / "l.log"))
    assert cluster.launch(cfg, log, str(conf)) == 0
    log.close()
    text = (tmp_path / "l.log").read_text()
    assert "[hostA] card=0 pid=0" in text
    assert "[localhost] card=1 pid=1" in text
