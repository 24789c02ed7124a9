"""Cycle-outer multi-sample scheduling A/B.

8 samples classified against an out-of-core DB (db_cycles=3, labels
strategy).  A: serial per-file runs (each sample streams the whole table
through the device once — the round-2 behavior under --db-cycles).
B: classify_files cycle-outer scheduling (each table chunk uploads ONCE
and every sample's batches run through it before advancing).

Bar: B >= 1.8x A aggregate.  Reference behavior amortized:
swapDbParts re-upload per cycle, CuClarkDB.cu:776-815.

Run: PYTHONPATH=. python benchmarks/cycle_outer_ab.py
Env: CO_SAMPLES (8), CO_READS (8000 per sample), CO_KEYS_MBP (genome Mbp,
     default 16x3 -> ~46M keys reuses the bench config-2 cached DB if
     present under BENCH_CACHE_ROOT).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CACHE = os.environ.get(
    "BENCH_CACHE_ROOT",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "bench_cache"),
)
ACGT = np.frombuffer(b"ACGT", np.uint8)


def main():
    n_samples = int(os.environ.get("CO_SAMPLES", "8"))
    n_reads = int(os.environ.get("CO_READS", "8000"))

    from jn_cuclark_tpu import params
    from jn_cuclark_tpu.engine import BatchPlan, Classifier
    from jn_cuclark_tpu.io.targets import parse_targets

    # reuse the bench config-2 DB (16 x 3 Mbp, ~46M keys) if cached
    wdir = os.path.join(CACHE, "bench_c2_16x3000000")
    prof = params.FULL
    k = prof.default_k
    if not os.path.exists(os.path.join(wdir, "targets.txt")):
        raise SystemExit(
            "config-2 workload cache missing; run `python bench.py` once "
            f"(BENCH_CONFIGS=2) to populate {wdir}"
        )
    targets = parse_targets(os.path.join(wdir, "targets.txt"))

    rng = np.random.default_rng(7)
    genomes = []
    for line in open(os.path.join(wdir, "targets.txt")):
        p = line.split()[0]
        genomes.append(
            b"".join(
                ln.strip() for ln in open(p, "rb") if not ln.startswith(b">")
            )
        )

    td = tempfile.mkdtemp(prefix="cycle_ab_")
    items = []
    for s in range(n_samples):
        path = os.path.join(td, f"s{s}.fa")
        with open(path, "wb") as f:
            for i in range(n_reads):
                if rng.random() < 0.5:
                    seq = ACGT[
                        rng.integers(0, 4, size=150, dtype=np.uint8)
                    ].tobytes()
                else:
                    g = genomes[int(rng.integers(0, len(genomes)))]
                    p0 = int(rng.integers(0, len(g) - 150))
                    seq = g[p0 : p0 + 150]
                f.write(b">s%d_r%d\n%s\n" % (s, i, seq))
        items.append((path, None, os.path.join(td, f"s{s}_serial")))

    clf = Classifier.load(
        wdir, targets, prof, k, db_cycles=3,
        plan=BatchPlan(cycle_strategy="labels"),
    )

    # warm compile on one small sample
    clf.classify_file(items[0][0], os.path.join(td, "warm"))

    t0 = time.time()
    for o, p, r in items:
        clf.classify_file(o, r, paired_path=p)
    t_serial = time.time() - t0

    items_b = [(o, p, r.replace("_serial", "_outer")) for o, p, r in items]
    t0 = time.time()
    clf.classify_files(items_b, jobs=4)
    t_outer = time.time() - t0

    same = all(
        open(a[2] + ".csv", "rb").read() == open(b[2] + ".csv", "rb").read()
        for a, b in zip(items, items_b)
    )
    total = n_samples * n_reads
    print(json.dumps(dict(
        samples=n_samples, reads_per_sample=n_reads, db_cycles=3,
        serial_seconds=round(t_serial, 2),
        cycle_outer_seconds=round(t_outer, 2),
        speedup=round(t_serial / t_outer, 2),
        serial_reads_per_sec=round(total / t_serial, 1),
        cycle_outer_reads_per_sec=round(total / t_outer, 1),
        csv_identical=same,
    )), flush=True)


if __name__ == "__main__":
    main()
