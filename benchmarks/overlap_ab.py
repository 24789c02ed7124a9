"""Out-of-core chunk-upload overlap A/B.

Measures the cycled engine end-to-end at the RefSeq shape (cached
refseq_5000x50000 workload, forced db_cycles=3, labels strategy) with the
double-buffered chunk prefetch ON vs OFF, REP-INTERLEAVED in one process
(on, off, on, off, ...) so drift hits both arms equally; medians are
reported.

The overlap hides chunk j+1's host->device upload behind pass j's probes
(swapDbParts parity, CuClarkDB.cu:776-815).  Upper bound for the ratio =
(upload + compute) / max(upload, compute) per pass.

Run:  PYTHONPATH=. python benchmarks/overlap_ab.py
Env:  OV_READS (250000), OV_REPS (3 per arm), RS_* as refseq_scale.
Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: F401  (workload helpers)

from benchmarks.refseq_scale import build_workload, CACHE, mark  # noqa: E402


def main():
    import benchmarks.refseq_scale as rs

    rs.T0 = time.time()
    n_targets = int(os.environ.get("RS_TARGETS", "5000"))
    glen = int(os.environ.get("RS_GLEN", "50000"))
    n_reads = int(os.environ.get("OV_READS", "250000"))
    reps = int(os.environ.get("OV_REPS", "3"))
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
    stem = os.path.join(
        td, prof.db_stem(k, targets.n_targets, 0, prof.default_gap)
    )
    if not dbformat.db_exists(stem):
        mark("building database (cold cache)")
        builder.build_database(targets, td, prof, k)

    with open(reads_path, "rb") as f:
        fa = f.read()
    # slice to OV_READS records
    pos, seen = 0, 0
    while seen < n_reads:
        nxt = fa.find(b">", pos + 1)
        if nxt < 0:
            break
        pos, seen = nxt, seen + 1
    fa = fa[:pos] if seen >= n_reads else fa

    mark("loading classifier (db_cycles=3, labels strategy)")
    clf = Classifier.load(
        td, targets, prof, k, db_cycles=3,
        plan=BatchPlan(cycle_strategy="labels"),
    )

    def one_pass():
        t0 = time.time()
        n = 0
        for c in clf.classify_bytes(fa)[0]:
            n += c.count(b"\n")
        return n / (time.time() - t0)

    # warm (compile + first uploads)
    os.environ["CLARK_TPU_PREFETCH_CHUNKS"] = "1"
    mark("warmup pass")
    one_pass()

    arms = {"1": [], "0": []}
    for r in range(reps):
        for pf in ("1", "0"):
            os.environ["CLARK_TPU_PREFETCH_CHUNKS"] = pf
            rate = one_pass()
            arms[pf].append(round(rate, 1))
            mark(f"prefetch={pf} rep{r}: {rate:,.0f} reads/s")
    out = {
        "workload": f"{n_targets}x{glen}bp, {seen} reads, db_cycles=3, "
                    "labels strategy",
        "prefetch_on_reads_per_sec": arms["1"],
        "prefetch_off_reads_per_sec": arms["0"],
        "median_on": statistics.median(arms["1"]),
        "median_off": statistics.median(arms["0"]),
    }
    out["overlap_ratio"] = round(out["median_on"] / out["median_off"], 3)
    from jn_cuclark_tpu.utils import fetch

    out["fetch_stats"] = dict(fetch.stats)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
