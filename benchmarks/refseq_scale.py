"""RefSeq-shape scale run (BASELINE configs 3/5's missing half): ~5000
targets x 50 kbp synthetic genomes -> ~250M distinct discriminative k-mers
at k=31 (u32 on-disk quotients, full-profile HTSIZE), classified on the
device with the auto memory budget, with forced
out-of-core cycling (labels strategy), and optionally with the DB sharded
over the virtual CPU mesh.

Run:  python benchmarks/refseq_scale.py   (or bench.py with BENCH_CONFIGS=5)
Env:  RS_TARGETS (5000), RS_GLEN (50000), RS_READS (1000000),
      RS_MODES (comma of: plain,cycled,mesh)
Prints one JSON line at the end; records host-memory high-water.
"""

from __future__ import annotations

import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CACHE = os.environ.get(
    "BENCH_CACHE_ROOT",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "bench_cache"),
)
ACGT = np.frombuffer(b"ACGT", np.uint8)


def mark(s):
    print(f"[{time.time() - T0:8.1f}s] {s}", flush=True)


def maxrss_gb():
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 2)


def rand_seq_bytes(rng, n) -> bytes:
    return ACGT[rng.integers(0, 4, size=n, dtype=np.uint8)].tobytes()


def build_workload(td, n_targets, glen, n_reads, read_len=150):
    os.makedirs(td, exist_ok=True)
    tpath = os.path.join(td, "targets.txt")
    gdir = os.path.join(td, "genomes")
    os.makedirs(gdir, exist_ok=True)
    rng = np.random.default_rng(1234)
    if not os.path.exists(tpath + ".done"):
        mark(f"writing {n_targets} x {glen}bp genomes")
        with open(tpath, "w") as tf:
            for i in range(n_targets):
                p = os.path.join(gdir, f"t{i}.fa")
                seq = rand_seq_bytes(rng, glen)
                with open(p, "wb") as f:
                    f.write(b">t%d\n" % i + seq + b"\n")
                tf.write(f"{p} {100000 + i}\n")
        open(tpath + ".done", "w").write("1")
    else:
        # keep the rng stream position identical on warm runs
        rng = np.random.default_rng(4321)
    reads_path = os.path.join(td, "reads.fa")
    if not os.path.exists(reads_path + ".done"):
        mark(f"writing {n_reads} reads")
        rr = np.random.default_rng(99)
        gsel = rr.integers(0, n_targets, size=n_reads)
        pos = rr.integers(0, glen - read_len, size=n_reads)
        junk = rr.random(n_reads) < 0.2
        with open(reads_path, "wb") as f:
            cur_g, cur_seq = -1, b""
            order = np.argsort(gsel, kind="stable")  # group by genome: one
            # file read per genome instead of n_reads reopens
            out = [None] * n_reads
            for j in order:
                g = int(gsel[j])
                if g != cur_g:
                    with open(os.path.join(gdir, f"t{g}.fa"), "rb") as gf:
                        gf.readline()
                        cur_seq = gf.readline().strip()
                    cur_g = g
                if junk[j]:
                    seq = rand_seq_bytes(rr, read_len)
                    tag = b"junk"
                else:
                    p = int(pos[j])
                    seq = cur_seq[p : p + read_len]
                    tag = b"t%d" % g
                out[j] = b">r%d_%s\n%s\n" % (j, tag, seq)
            f.write(b"".join(out))
        open(reads_path + ".done", "w").write("1")
    return tpath, reads_path


def run() -> dict:
    """Build (or reuse) the workload and DB, classify, return the numbers."""
    global T0
    T0 = time.time()
    n_targets = int(os.environ.get("RS_TARGETS", "5000"))
    glen = int(os.environ.get("RS_GLEN", "50000"))
    n_reads = int(os.environ.get("RS_READS", "1000000"))
    modes = os.environ.get("RS_MODES", "plain,cycled").split(",")
    td = os.path.join(CACHE, f"refseq_{n_targets}x{glen}")
    tpath, reads_path = build_workload(td, n_targets, glen, n_reads)

    from jn_cuclark_tpu import params
    from jn_cuclark_tpu.db import builder
    from jn_cuclark_tpu.engine import BatchPlan, Classifier
    from jn_cuclark_tpu.io import dbformat
    from jn_cuclark_tpu.io.targets import parse_targets

    prof = params.FULL
    k = prof.default_k
    targets = parse_targets(tpath)
    stem = os.path.join(td, prof.db_stem(k, targets.n_targets, 0, prof.default_gap))
    out = {
        "targets": n_targets, "genome_bp": n_targets * glen,
        "k": k, "profile": prof.name, "reads": n_reads,
    }
    if not dbformat.db_exists(stem):
        mark("building database")
        t0 = time.time()
        builder.build_database(targets, td, prof, k)
        out["db_build_seconds"] = round(time.time() - t0, 1)
        mark(f"db build done in {out['db_build_seconds']}s")
    sz = sum(
        os.path.getsize(stem + ext) for ext in (".sz", ".ky", ".lb")
    )
    out["db_disk_gb"] = round(sz / 2**30, 2)

    with open(reads_path, "rb") as f:
        fa = f.read()

    def run(clf, label, warm_frac=8):
        for _ in clf.classify_bytes(fa[: len(fa) // warm_frac])[0]:
            pass
        best = 0.0
        for rep in range(2):
            t0 = time.time()
            n = 0
            for c in clf.classify_bytes(fa)[0]:
                n += c.count(b"\n")
            r = n / (time.time() - t0)
            mark(f"{label} rep{rep}: {r:,.0f} reads/s")
            best = max(best, r)
        return round(best, 1)

    if "plain" in modes:
        mark("loading classifier (auto memory budget)")
        t0 = time.time()
        clf = Classifier.load(td, targets, prof, k)
        out["load_seconds"] = round(time.time() - t0, 1)
        out["auto_db_cycles"] = clf.db_cycles
        out["table_gb"] = round(
            getattr(clf, "slots", np.zeros(0)).nbytes / 2**30, 2
        ) if hasattr(clf, "slots") else None
        mark(f"loaded in {out['load_seconds']}s, cycles={clf.db_cycles}")
        out["plain_reads_per_sec"] = run(clf, "plain")
        del clf
    if "cycled" in modes:
        mark("loading classifier (db_cycles=3, labels strategy)")
        clf = Classifier.load(
            td, targets, prof, k, db_cycles=3,
            plan=BatchPlan(cycle_strategy="labels"),
        )
        out["cycled_reads_per_sec"] = run(clf, "cycled", warm_frac=8)
        del clf
    out["host_maxrss_gb"] = maxrss_gb()
    return out


def main():
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
