"""Interleaved A/B of two engine choices on bench.py's config-1 workload,
reps of each variant alternating in ONE process:

  * hybrid length-bucketed planner (sort_batches=True) vs file-order
  * radix-table load factor 0.69c (default) vs the old 0.44c

Run:  PYTHONPATH=. python benchmarks/r3_suspects_ab.py
Env:  RSAB_READS (1000000), RSAB_REPS (3)
Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import bench
    from jn_cuclark_tpu import params
    from jn_cuclark_tpu.engine import BatchPlan, Classifier
    from jn_cuclark_tpu.io import dbformat
    from jn_cuclark_tpu.io.targets import parse_targets
    from jn_cuclark_tpu.ops import radix_table

    n_reads = int(os.environ.get("RSAB_READS", "1000000"))
    reps = int(os.environ.get("RSAB_REPS", "3"))
    td = os.path.join(bench.CACHE_ROOT, "bench_full_2000000_1000000")
    genomes = bench._write_genomes(td, np.random.default_rng(0), 3, 2000000)
    targets = parse_targets(os.path.join(td, "targets.txt"))
    prof = params.FULL
    stem = os.path.join(td, prof.db_stem(31, targets.n_targets, 0, 0))
    if not dbformat.db_exists(stem):
        from jn_cuclark_tpu.db import builder

        builder.build_database(targets, td, prof, 31)
    canonical, labels = dbformat.read_db(stem, prof, 31, 1)
    fa = bench._sim_reads(np.random.default_rng(100), genomes, n_reads, 150)

    def mk(load, sort_batches):
        table = radix_table.build(
            np.asarray(canonical, np.uint64),
            np.asarray(labels, np.int32) + 1,
            k=31, load=(None if load is None else load * 128),
        )
        return Classifier(
            prof, 31, targets.target_names,
            np.zeros(0, np.uint64), np.zeros(0, np.uint16),
            plan=BatchPlan(max_reads=1 << 16, window_budget=1 << 23,
                           pipeline_depth=6, sort_batches=sort_batches),
            prebuilt_table=table,
        )

    variants = {
        "hybrid_load069": mk(None, True),      # the r3/r4 default
        "fileorder_load069": mk(None, False),  # planner suspect
        "hybrid_load044": mk(0.44, True),      # load-factor suspect
    }
    for clf in variants.values():  # warm every jit tier first
        for _ in clf.classify_bytes(fa[: len(fa) // 4])[0]:
            pass
    rates = {k: [] for k in variants}
    for r in range(reps):
        for name, clf in variants.items():
            t0 = time.time()
            n = 0
            for chunk in clf.classify_bytes(fa)[0]:
                n += chunk.count(b"\n")
            rates[name].append(round(n / (time.time() - t0), 1))
    out = {"reads": n_reads, "reps": reps}
    for name in variants:
        out[name] = {
            "reads_per_sec": rates[name],
            "best": max(rates[name]),
            "median": float(np.median(rates[name])),
            "m1": variants[name].table_meta["m1"],
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
