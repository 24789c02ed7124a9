#!/usr/bin/env python3
"""Smoke run of the classifier on one NVIDIA GPU, through the user's entry
points, at a RefSeq-shape database size.

    python chip_smoke.py            # phases 0-5 on one card
    python chip_smoke.py --four     # read- and DB-sharded meshes on 4 cards

Phases (one process; the only child process is nvidia-smi):
  0  device: card name and power limit, JAX devices; exits 1 unless the
     platform is gpu
  1  native runtime: compile native/clark_native.cpp, require it loaded
     and running more than one thread
  2  parity on the card: reference-engine CSV goldens, u32 goldens at
     HTSIZE 16,777,259, the seeded oracle sweep (tests/)
  3  main path through the CLI: 5,000 targets x 50 kbp, full profile (k=31,
     HTSIZE 1,610,612,741), 1M reads of 150 bp with 20% junk; db
     set-targets, db build, classify (resident), the same classify with
     the device limit declared exactly at the auto-cycling threshold (must
     stay resident), classify --extended; a seeded sample of 2,000 reads
     re-derived with tests/oracle.py and a host searchsorted over the DB
     files must match byte for byte
  4  the other one-card paths must match phase 3's CSV byte for byte:
     --db-cycles 2 with both cycle strategies, the dense table, list input
     with --jobs 4; db build --device must write the host build's files
  5  memory: compiled memory_analysis of the default batch step, whether
     the probe's [Q, 2C] row gather is materialized, and the card's peak
     during phase 3's plain classify minus the table, which must fit what
     utils/memory charges beside the table (RESERVED + batch transients)

Device memory in use and the peak so far are printed after every step of
phases 3-4 (after a garbage collection, so a dropped Classifier's table is
gone); a step that raised the peak is marked.

Timings printed here are smoke numbers of one run, not benchmark numbers.
The last stdout line is {"ok": true, "device": {...}}; any failed phase
raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "smoke_work")
ACGT = np.frombuffer(b"ACGT", np.uint8)
T0 = time.time()
CARD = "unknown card"
PEAK = [0]  # the card's peak_bytes_in_use at the last mem_step


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def mem_step(what: str) -> int:
    """Collect garbage, then log card 0's memory in use and its peak so
    far; returns the peak in bytes."""
    import jax

    gc.collect()
    st = jax.devices()[0].memory_stats()
    peak = st["peak_bytes_in_use"]
    rose = " (this step raised the peak)" if peak > PEAK[0] else ""
    PEAK[0] = max(PEAK[0], peak)
    log(f"memory after {what}, {CARD}: in use "
        f"{st['bytes_in_use']:,} B, peak so far {peak:,} B{rose}")
    return peak


def table_bytes(db: str):
    """(table bytes, (m1, lb, c), n_targets) of the DB's radix table, from
    the index cache its first classify wrote."""
    from jn_cuclark_tpu.database import DBConfig
    from jn_cuclark_tpu.io.targets import parse_targets

    cfg = DBConfig.load(db)
    n_t = parse_targets(cfg.targets).n_targets
    stem = os.path.join(
        cfg.subdb, cfg.profile.db_stem(cfg.k, n_t, cfg.min_count_target,
                                       cfg.gap)
    )
    m1, lb, c = (int(x) for x in np.load(stem + ".idx.npz")["meta"])
    # slots [2^m1, 2C] u32; labels are packed into the slots
    return (1 << m1) * 2 * c * 4, (m1, lb, c), n_t


# ------------------------------------------------------------------ phase 0
def phase0_device(n_expected: int):
    import jax

    devs = jax.devices()
    for d in devs:
        log(f"jax device {d.id}: platform={d.platform} kind={d.device_kind}")
    log(f"jax device count: {len(devs)}")
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX platform is {devs[0].platform!r}", file=sys.stderr)
        sys.exit(1)
    if len(devs) < n_expected:
        print(f"need {n_expected} GPUs, JAX sees {len(devs)}", file=sys.stderr)
        sys.exit(1)
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    CARD = smi[0].strip()
    for line in smi:
        print(f"card: {line.strip()}", flush=True)
    return devs


# ------------------------------------------------------------------ phase 1
def phase1_native():
    from jn_cuclark_tpu.utils import native

    t0 = time.time()
    path = native.build()
    if path is None or not native.available():
        raise RuntimeError("native runtime did not build: no C++ compiler?")
    n = native.threads()
    if n < 2:
        raise RuntimeError(f"native runtime runs {n} thread: host scan, "
                           "pack and format would be serial")
    log(f"native runtime {os.path.basename(path)} ready in "
        f"{time.time() - t0:.1f}s, built by {native.find_cxx()}, {n} threads")


# ------------------------------------------------------------------ phase 2
def _params(fn):
    """argvalues of a test function's parametrize mark."""
    (mark,) = [m for m in fn.pytestmark if m.name == "parametrize"]
    return mark.args[1]


def phase2_parity(work: Path):
    from jn_cuclark_tpu.engine import Classifier
    from jn_cuclark_tpu.io.targets import parse_targets
    from tests import test_csv_goldens as tcg
    from tests import test_property as tp
    from tests import test_u32_goldens as tu

    # reference-engine CSV goldens (tests/test_csv_goldens.py's fixture)
    tmp = work / "csv"
    tmp.mkdir(parents=True)
    with open(os.path.join(tcg.INPUTS, "targets.txt")) as f, open(
        tmp / "targets.txt", "w"
    ) as g:
        for line in f:
            path, lbl = line.split()
            g.write(f"{os.path.join(tcg.INPUTS, os.path.basename(path))} {lbl}\n")
    shutil.copytree(os.path.join(tcg.GOLD_DB, "full_k9"), tmp / "db")
    clf = Classifier.load(
        str(tmp / "db"), parse_targets(str(tmp / "targets.txt")),
        tcg.Profile(name="g65521", htsize=65521, light=False, default_k=9), 9,
    )
    for case, kwargs in _params(tcg.test_csv_matches_reference_engine):
        d = tmp / f"out_{case}"
        d.mkdir()
        tcg.test_csv_matches_reference_engine(clf, d, case, kwargs)
        log(f"csv golden {case}: byte-identical")
    del clf
    for case, profile, stem in _params(tu.test_u32_db_and_csv_match_reference):
        d = work / f"u32_{case}"
        d.mkdir()
        tu.test_u32_db_and_csv_match_reference(d, case, profile, stem)
        log(f"u32 golden {case}: DB files and CSV byte-identical")
    for seed, k, light in _params(tp.test_random_equivalence):
        d = work / f"prop_{seed}"
        d.mkdir()
        tp.test_random_equivalence(d, seed, k, light)
    log(f"oracle sweep: {len(_params(tp.test_random_equivalence))} seeded "
        "cases identical")


# ------------------------------------------------------------------ phase 3
def make_workload(root: str, n_targets: int, glen: int, n_reads: int,
                  read_len: int = 150, junk: float = 0.2, seed: int = 1234):
    """Reference-layout DB directory (Custom/ genomes + NCBI-format
    taxonomy) and a reads FASTA, all from `seed`.  Returns (db_dir,
    reads_path, names, seqs) with seqs a [n_reads, read_len] uint8 array."""
    rng = np.random.default_rng(seed)
    db = os.path.join(root, "db")
    custom = os.path.join(db, "Custom")
    tax = os.path.join(db, "taxonomy")
    os.makedirs(custom)
    os.makedirs(tax)
    genome = ACGT[rng.integers(0, 4, size=n_targets * glen, dtype=np.uint8)]
    for i in range(n_targets):
        with open(os.path.join(custom, f"t{i:05d}.fa"), "wb") as f:
            f.write(b">NC_%06d.1 synthetic genome %d\n" % (i + 1, i))
            f.write(genome[i * glen : (i + 1) * glen].tobytes() + b"\n")
    nodes = [(1, 1, "no rank"), (2, 1, "superkingdom"), (100, 2, "phylum"),
             (110, 100, "class"), (120, 110, "order"), (130, 120, "family")]
    names = [(1, "root"), (2, "Bacteria"), (100, "Synthphyla"),
             (110, "Synthclassia"), (120, "Synthorder"), (130, "Synthaceae")]
    for g in range(-(-n_targets // 4)):
        nodes.append((200 + g, 130, "genus"))
        names.append((200 + g, f"Synthgenus {g}"))
    for i in range(n_targets):
        nodes.append((100000 + i, 200 + i // 4, "species"))
        names.append((100000 + i, f"Synthspecies {i}"))
    with open(os.path.join(tax, "nodes.dmp"), "w") as f:
        f.writelines(f"{t}\t|\t{p}\t|\t{r}\t|\tXX\t|\n" for t, p, r in nodes)
    with open(os.path.join(tax, "names.dmp"), "w") as f:
        f.writelines(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
                     for t, n in names)
    with open(os.path.join(tax, "nucl_accss"), "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        f.writelines(f"NC_{i + 1:06d}\tNC_{i + 1:06d}.1\t{100000 + i}\t{i}\n"
                     for i in range(n_targets))
    for fn in ("merged.dmp", "citations.dmp", "delnodes.dmp", "division.dmp",
               "gc.prt", "gencode.dmp", "images.dmp"):
        open(os.path.join(tax, fn), "w").close()

    rr = np.random.default_rng(seed + 1)
    gsel = rr.integers(0, n_targets, size=n_reads)
    pos = rr.integers(0, glen - read_len, size=n_reads)
    is_junk = rr.random(n_reads) < junk
    seqs = genome[(gsel * glen + pos)[:, None] + np.arange(read_len)]
    seqs[is_junk] = ACGT[rr.integers(0, 4, size=(int(is_junk.sum()), read_len))]
    rnames = [f"r{j}_junk" if is_junk[j] else f"r{j}_t{gsel[j]}"
              for j in range(n_reads)]
    reads = os.path.join(root, "reads.fa")
    write_fasta(reads, rnames, seqs)
    return db, reads, rnames, seqs


def write_fasta(path, names, seqs):
    with open(path, "wb") as f:
        f.write(b"".join(b">%s\n%s\n" % (n.encode(), s.tobytes())
                         for n, s in zip(names, seqs)))


def cli(*argv: str, capture: bool = False) -> str:
    """Run the CLI in this process; raise on a non-zero exit.  With
    capture, stderr is also returned (and still shown)."""
    from jn_cuclark_tpu import cli as _cli

    err = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            err.write(s)
            return sys.__stderr__.write(s)

    ctx = contextlib.redirect_stderr(Tee()) if capture else contextlib.nullcontext()
    with ctx:
        rc = _cli.main(list(argv))
    if rc != 0:
        raise RuntimeError(f"clark-tpu {' '.join(argv)} exited {rc}")
    return err.getvalue()


def db_lookup(db_dir: str, queries: np.ndarray):
    """(found, label) of each canonical query in the DB files, from
    io/dbformat.read_db and a host sort + np.searchsorted; independent of
    the radix table and of the device code."""
    from jn_cuclark_tpu.database import DBConfig
    from jn_cuclark_tpu.io import dbformat
    from jn_cuclark_tpu.io.targets import parse_targets

    cfg = DBConfig.load(db_dir)
    prof = cfg.profile
    n_t = parse_targets(cfg.targets).n_targets
    stem = os.path.join(
        cfg.subdb, prof.db_stem(cfg.k, n_t, cfg.min_count_target, cfg.gap)
    )
    canon, labels = dbformat.read_db(stem, prof, cfg.k)
    # sort only keys that can match: a 2^24-entry filter on the low bits
    # keeps the host sort small at 10^8 keys
    mask = np.uint64((1 << 24) - 1)
    hit = np.zeros(1 << 24, bool)
    hit[(queries & mask).astype(np.int64)] = True
    cand = hit[(canon & mask).astype(np.int64)]
    keys, labs = canon[cand], labels[cand]
    order = np.argsort(keys, kind="stable")
    keys, labs = keys[order], labs[order]
    if not len(keys):
        return np.zeros(len(queries), bool), np.zeros(len(queries), np.uint16)
    i = np.minimum(np.searchsorted(keys, queries), len(keys) - 1)
    return keys[i] == queries, labs[i]


def oracle_rows(db_dir: str, names, seqs, idx, extended: bool = False):
    """CSV rows of reads `idx`, derived with tests/oracle.py from the DB
    files (see db_lookup)."""
    from jn_cuclark_tpu.database import DBConfig
    from jn_cuclark_tpu.io.targets import parse_targets
    from tests import oracle

    cfg = DBConfig.load(db_dir)
    k = cfg.k
    tnames = parse_targets(cfg.targets).target_names
    reads = [seqs[j].tobytes().decode() for j in idx]
    kmers = [oracle.seq_kmers(s, k) for s in reads]
    allk = np.array(sorted({v for ks in kmers for v in ks}), np.uint64)
    found, labs = db_lookup(db_dir, allk)
    db = {int(v): int(l) for v, l, f in zip(allk, labs, found) if f}
    rows = []
    for j, s in zip(idx, reads):
        total, ib, b, sb, counts = oracle.classify_read(db, s, k)
        rows.append(oracle.format_row(
            names[j], total, ib, b, sb, len(s), k, tnames,
            counts=counts if extended else None,
            n_targets=len(tnames) - 1,
        ))
    return rows


def csv_body(path: str) -> list[bytes]:
    with open(path, "rb") as f:
        return f.read().split(b"\n")[1:-1]


def check_sample(db_dir, csv_path, names, seqs, n_sample, seed=7,
                 extended=False):
    body = csv_body(csv_path)
    if len(body) != len(names):
        raise AssertionError(f"{csv_path}: {len(body)} rows for "
                             f"{len(names)} reads")
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(len(names), size=min(n_sample, len(names)),
                             replace=False))
    want = oracle_rows(db_dir, names, seqs, idx, extended=extended)
    for j, w in zip(idx, want):
        if body[j].decode() != w:
            raise AssertionError(
                f"read {j}: card row {body[j][:200]!r} != oracle {w[:200]!r}"
            )
    return len(idx)


def assert_same(a: str, b: str, what: str, ref: str = "the plain CSV"):
    if Path(a).read_bytes() != Path(b).read_bytes():
        raise AssertionError(f"{what}: {a} differs from {b}")
    log(f"{what}: byte-equal to {ref}")


def phase3_main_path(work: Path, n_targets, glen, n_reads, n_sample,
                     n_extended, prof_args=("--full",)):
    from jn_cuclark_tpu.engine import BatchPlan
    from jn_cuclark_tpu.utils import memory

    mem_step("phase 2")
    t0 = time.time()
    db, reads, names, seqs = make_workload(str(work), n_targets, glen, n_reads)
    log(f"workload: {n_targets} targets x {glen} bp, {n_reads} reads "
        f"of 150 bp (20% junk), written in {time.time() - t0:.1f}s")
    cli("db", "set-targets", db, "--rank", "species", *prof_args)
    t0 = time.time()
    cli("db", "build", db, *prof_args)
    log(f"db build (host): {time.time() - t0:.1f}s")

    plain = str(work / "plain")
    t0 = time.time()
    err = cli("classify", "-D", db, "-O", reads, "-R", plain, capture=True)
    wall = time.time() - t0
    if "cycles" in err or "dense" in err:
        raise AssertionError("phase-3 classify did not run resident")
    # the CLI's "Done in Xs (N reads/min" is classify_file's own time; the
    # rest of the call is loading (DB read, table build, upload)
    done = n_reads * 60 / int(err.split("s (")[1].split(" reads/min")[0])
    log(f"smoke numbers, {CARD}: load {wall - done:.1f}s, classify wall "
        f"{done:.2f}s, {n_reads / done:,.0f} reads/s (includes first "
        "compiles; not a benchmark)")
    peak_plain = mem_step("phase-3 plain classify")
    n = check_sample(db, plain + ".csv", names, seqs, n_sample)
    log(f"sampled {n} reads: card CSV rows == oracle re-derivation")

    # the device limit declared exactly where auto-cycling starts: the
    # budget left for the table equals the table, so it stays resident
    tbytes = table_bytes(db)[0]
    limit = (tbytes + memory.RESERVED
             + memory.probe_transient_bytes(BatchPlan().window_budget))
    thr = str(work / "threshold")
    os.environ["CLARK_TPU_DEVICE_MEM_BYTES"] = str(limit)
    try:
        err = cli("classify", "-D", db, "-O", reads, "-R", thr, capture=True)
    finally:
        del os.environ["CLARK_TPU_DEVICE_MEM_BYTES"]
    if "cycles" in err or "dense" in err:
        raise AssertionError("at the auto-cycling threshold the table did "
                             "not stay resident")
    assert_same(thr + ".csv", plain + ".csv",
                f"device limit declared at the threshold ({limit:,} B)")
    mem_step("threshold classify")

    ext_reads = str(work / "ext_reads.fa")
    write_fasta(ext_reads, names[:n_extended], seqs[:n_extended])
    ext = str(work / "ext")
    cli("classify", "-D", db, "-O", ext_reads, "-R", ext, "--extended")
    body = csv_body(ext + ".csv")
    plain_body = csv_body(plain + ".csv")[:n_extended]
    for j, (e, p) in enumerate(zip(body, plain_body)):
        f = e.split(b",")
        if b",".join([f[0]] + f[-4:]) != p:
            raise AssertionError(f"--extended row {j} disagrees with plain")
    n = check_sample(db, ext + ".csv", names[:n_extended],
                     seqs[:n_extended], n_sample // 4, extended=True)
    log(f"--extended on the first {n_extended} reads (per-target columns "
        f"make each row ~{len(body[0]) if body else 0} bytes): matches "
        f"plain, {n} sampled rows == oracle")
    mem_step("classify --extended")
    return db, reads, names, seqs, plain + ".csv", peak_plain


# ------------------------------------------------------------------ phase 4
def phase4_other_paths(work: Path, db, reads, plain_csv, n_device_targets,
                       glen, prof_args=("--full",)):
    from jn_cuclark_tpu.database import DBConfig
    from jn_cuclark_tpu.engine import BatchPlan, Classifier

    cfg = DBConfig.load(db)
    for strategy in ("counts", "labels"):
        t0 = time.time()
        clf = Classifier.load(
            cfg.subdb, cfg.targets, cfg.profile, cfg.k, db_cycles=2,
            plan=BatchPlan(cycle_strategy=strategy),
        )
        out = str(work / f"cycled_{strategy}")
        clf.classify_file(reads, out)
        del clf
        log(f"--db-cycles 2 ({strategy}) in {time.time() - t0:.1f}s")
        assert_same(out + ".csv", plain_csv, f"--db-cycles 2 {strategy}")
        mem_step(f"--db-cycles 2 {strategy}")

    os.environ["CLARK_TPU_DENSE"] = "force"
    try:
        t0 = time.time()
        out = str(work / "dense")
        cli("classify", "-D", db, "-O", reads, "-R", out)
        log(f"dense table in {time.time() - t0:.1f}s")
    finally:
        del os.environ["CLARK_TPU_DENSE"]
    assert_same(out + ".csv", plain_csv, "dense two-choice table")
    mem_step("dense table")

    # list input: the reads split into 4 files, classified 4 at a time
    data = Path(reads).read_bytes()
    recs = data.split(b"\n>")
    q = -(-len(recs) // 4)
    parts, results = [], []
    for i in range(4):
        chunk = b"\n>".join(recs[i * q : (i + 1) * q])
        if i:
            chunk = b">" + chunk
        if not chunk.endswith(b"\n"):
            chunk += b"\n"
        p = work / f"part{i}.fa"
        p.write_bytes(chunk)
        parts.append(str(p))
        results.append(str(work / f"part{i}"))
    (work / "objects.txt").write_text("\n".join(parts) + "\n")
    (work / "results.txt").write_text("\n".join(results) + "\n")
    t0 = time.time()
    cli("classify", "-D", db, "-O", str(work / "objects.txt"),
        "-R", str(work / "results.txt"), "--jobs", "4")
    joined = Path(plain_csv).read_bytes().split(b"\n", 1)[0] + b"\n" + b"".join(
        Path(r + ".csv").read_bytes().split(b"\n", 1)[1] for r in results
    )
    (work / "jobs4.csv").write_bytes(joined)
    log(f"list input --jobs 4 in {time.time() - t0:.1f}s")
    assert_same(str(work / "jobs4.csv"), plain_csv, "list input --jobs 4")
    mem_step("list input --jobs 4")

    # db build --device on a smaller DB vs the host build
    small = work / "small"
    small.mkdir()
    sdb, _, _, _ = make_workload(str(small), n_device_targets, glen, 10,
                                 seed=99)
    cli("db", "set-targets", sdb, "--rank", "species", *prof_args)
    scfg = DBConfig.load(sdb)
    t0 = time.time()
    cli("db", "build", sdb, *prof_args)
    t_host = time.time() - t0
    host_files = {p.name: p.read_bytes() for p in Path(scfg.subdb).iterdir()
                  if p.suffix in (".sz", ".ky", ".lb")}
    t0 = time.time()
    cli("db", "build", sdb, *prof_args, "--device")
    t_dev = time.time() - t0
    for name, want in host_files.items():
        if (Path(scfg.subdb) / name).read_bytes() != want:
            raise AssertionError(f"db build --device: {name} differs")
    log(f"db build --device ({n_device_targets} targets): files byte-equal "
        f"to the host build (host {t_host:.1f}s, device {t_dev:.1f}s)")
    sort_ns = device_sort_ns(n_device_targets * (glen - 30))
    log(f"device aggregate, {CARD}: {sort_ns:.2f} ns/element at "
        f"{n_device_targets * (glen - 30):,} occurrences (smoke number)")
    mem_step("db build --device and the aggregate timing")


def device_sort_ns(n: int) -> float:
    """Per-element time of db/device_build.aggregate_device on n random
    occurrences (second call; the first compiles)."""
    from jn_cuclark_tpu.db import device_build

    rng = np.random.default_rng(5)
    canon = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    label = rng.integers(0, 100, size=n).astype(np.int32)
    pg = np.arange(100, dtype=np.int32)
    device_build.aggregate_device(canon, label, pg, True)
    t0 = time.perf_counter()
    device_build.aggregate_device(canon, label, pg, True)
    return (time.perf_counter() - t0) / n * 1e9


# ------------------------------------------------------------------ phase 5
def phase5_memory(db, peak_plain: int):
    import jax
    import jax.numpy as jnp

    from jn_cuclark_tpu.database import DBConfig
    from jn_cuclark_tpu.engine import BatchPlan
    from jn_cuclark_tpu.ops import device_pipeline
    from jn_cuclark_tpu.utils import memory

    cfg = DBConfig.load(db)
    tbytes, (m1, lb, c), n_t = table_bytes(db)
    plan = BatchPlan()
    stride = 192
    rows = min(plan.max_reads, plan.window_budget // stride)
    probe_cols = 128  # 150 bp reads at k=31, as engine._probe_cols picks
    sds = jax.ShapeDtypeStruct
    args = (
        sds((1 << m1, 2 * c), jnp.uint32), sds((0,), jnp.uint32),
        sds((64,), jnp.uint64), sds((64,), jnp.int32),
        sds((rows, stride // 32 + 1), jnp.uint64),
        sds((rows, stride // 64 + 1), jnp.uint64),
    )
    compiled = device_pipeline.classify_batch.lower(
        *args, k=cfg.k, m1=m1, lb=lb, c=c, n_targets=n_t, extended=False,
        probe_cols=probe_cols,
    ).compile()
    ma = compiled.memory_analysis()
    q = rows * probe_cols
    block = q * 2 * c * 4
    log(f"classify_batch memory_analysis (window_budget 2^23, stride "
        f"{stride}, C={c}, {rows} rows, Q={q}): temp "
        f"{ma.temp_size_in_bytes:,} B, argument "
        f"{ma.argument_size_in_bytes:,} B, output "
        f"{ma.output_size_in_bytes:,} B")
    formula = memory.probe_transient_bytes(plan.window_budget)
    fused = ma.temp_size_in_bytes < block
    log(f"[Q, 2C] u32 gather block would be {block:,} B: "
        + ("NOT materialized (temp is smaller; XLA fuses the gather into "
           "the compare/max)" if fused else "materialized (temp holds it)")
        + f"; utils/memory.probe_transient_bytes = {formula:,} B "
        f"({formula / max(ma.temp_size_in_bytes, 1):.2f}x the measured temp)")
    beside = peak_plain - tbytes
    charged = memory.RESERVED + formula
    log(f"phase-3 plain classify, {CARD}: peak {peak_plain:,} B - table "
        f"{tbytes:,} B = {beside:,} B beside the table; utils/memory "
        f"charges RESERVED {memory.RESERVED:,} B + transients {formula:,} B "
        f"= {charged:,} B")
    if beside > charged:
        raise AssertionError(
            f"the card needed {beside:,} B beside the table but auto-cycling "
            f"charges {charged:,} B: a DB at the threshold would not fit")


# ------------------------------------------------------------------ --four
def peak_gib() -> list[float]:
    """Peak device memory of each card so far, GiB."""
    import jax

    return [d.memory_stats()["peak_bytes_in_use"] / 2**30
            for d in jax.devices()]


def four_cards(work: Path, n_targets, glen, n_reads, prof_args=("--full",)):
    """The DB-sharded meshes run first, so each card's peak is its own
    share; card 0 must not hold more than 1.5x any other card."""
    db, reads, names, seqs = make_workload(str(work), n_targets, glen, n_reads)
    log(f"workload: {n_targets} targets x {glen} bp, {n_reads} reads")
    cli("db", "set-targets", db, "--rank", "species", *prof_args)
    t0 = time.time()
    cli("db", "build", db, *prof_args)
    log(f"db build (host): {time.time() - t0:.1f}s")
    runs = {
        "shard-db -d 4": ("--shard-db", "-d", "4"),
        "shard-db --dp 2 -d 4": ("--shard-db", "--dp", "2", "-d", "4"),
        "-d 4": ("-d", "4"),
        "one card": (),
    }
    out = {}
    for label, flags in runs.items():
        res = str(work / label.replace(" ", "_"))
        t0 = time.time()
        cli("classify", "-D", db, "-O", reads, "-R", res, *flags)
        out[label] = res + ".csv"
        gc.collect()
        peaks = peak_gib()
        log(f"{label}: {time.time() - t0:.1f}s wall; peak GiB per card "
            + ", ".join(f"{p:.3f}" for p in peaks))
        if label.startswith("shard-db") and peaks[0] > 1.5 * min(peaks[1:]):
            raise AssertionError(
                f"{label}: card 0 peaks at {peaks[0]:.3f} GiB, more than "
                "1.5x another card: something stages the table on card 0")
    for label, path in out.items():
        if label != "one card":
            assert_same(path, out["one card"], f"four cards, {label}",
                        "the one-card CSV")
    n = check_sample(db, out["one card"], names, seqs, 500)
    log(f"sampled {n} reads: one-card CSV == oracle re-derivation")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh comparison")
    ap.add_argument("--targets", type=int, default=5000)
    ap.add_argument("--genome-len", type=int, default=50_000)
    ap.add_argument("--reads", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    if args.targets != 5000:
        print(f"phase 3 cut: {args.targets} targets instead of 5000 "
              "(--targets)", flush=True)
    n_cards = 4 if args.four else 1
    devs = phase0_device(n_cards)
    sys.path.insert(0, REPO)
    phase1_native()
    shutil.rmtree(WORK, ignore_errors=True)
    work = Path(WORK)
    work.mkdir()
    try:
        if args.four:
            four_cards(work, args.targets, args.genome_len, args.reads)
        else:
            phase2_parity(work / "parity")
            db, reads, _, _, plain, peak_plain = phase3_main_path(
                work / "main", args.targets, args.genome_len, args.reads,
                n_sample=2000, n_extended=10_000,
            )
            phase4_other_paths(work / "main", db, reads, plain,
                               n_device_targets=400, glen=args.genome_len)
            phase5_memory(db, peak_plain)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log("all phases passed")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
