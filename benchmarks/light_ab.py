"""LIGHT vs FULL profile interleaved A/B.

The light profile (k=27, gap 4) is the one `kent -c` always runs
(kent.cpp:522).  This measures both profiles interleaved in ONE process
(rep-level A/B/A/B), same read set, with per-phase breakdowns, so a gap
between them is attributable to a stage.

Run:  python benchmarks/light_ab.py   (JAX_PLATFORMS=cpu for a smoke run)
Env:  LAB_READS (300000), LAB_REPS (4)
Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CACHE = os.environ.get(
    "BENCH_CACHE_ROOT",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "bench_cache"),
)


def main():
    from jn_cuclark_tpu import params
    from jn_cuclark_tpu.db import builder
    from jn_cuclark_tpu.engine import BatchPlan, Classifier
    from jn_cuclark_tpu.io import dbformat
    from jn_cuclark_tpu.io.targets import parse_targets
    from jn_cuclark_tpu.utils import profiling

    n_reads = int(os.environ.get("LAB_READS", "300000"))
    reps = int(os.environ.get("LAB_REPS", "4"))
    glen = 2_000_000
    td = os.path.join(CACHE, f"light_ab_{glen}")
    os.makedirs(td, exist_ok=True)
    rng = np.random.default_rng(0)
    genomes = []
    tpath = os.path.join(td, "targets.txt")
    with open(tpath, "w") as tf:
        for i in range(3):
            p = os.path.join(td, f"g{i}.fa")
            if os.path.exists(p):
                seq = "".join(
                    ln.strip() for ln in open(p) if not ln.startswith(">")
                )
            else:
                seq = "".join(rng.choice(list("ACGT"), size=glen))
                with open(p, "w") as f:
                    f.write(f">g{i}\n{seq}\n")
            genomes.append(seq)
            tf.write(f"{p} {1000 + i}\n")
    targets = parse_targets(tpath)

    rr = np.random.default_rng(7)
    reads = []
    for i in range(n_reads):
        g = genomes[i % 3]
        pos = int(rr.integers(0, len(g) - 150))
        reads.append(f">r{i}\n{g[pos:pos+150]}\n")
    fa = "".join(reads).encode()

    clfs = {}
    for name, prof in (("full", params.FULL), ("light", params.LIGHT)):
        k = prof.default_k
        stem = os.path.join(
            td, prof.db_stem(k, targets.n_targets, 0, prof.default_gap)
        )
        if not dbformat.db_exists(stem):
            builder.build_database(targets, td, prof, k)
        clfs[name] = (
            Classifier.load(
                td, targets, prof, k,
                plan=BatchPlan(max_reads=1 << 16, window_budget=1 << 23,
                               pipeline_depth=6),
            ),
            k,
        )

    out = {"reads": n_reads, "reps": reps}
    rates = {"full": [], "light": []}
    phases = {}
    for name, (clf, k) in clfs.items():  # warm both first
        for _ in clf.classify_bytes(fa[: len(fa) // 4])[0]:
            pass
    for r in range(reps):
        for name, (clf, k) in clfs.items():  # interleaved A/B
            with profiling.collect() as ph:
                t0 = time.time()
                n = 0
                for chunk in clf.classify_bytes(fa)[0]:
                    n += chunk.count(b"\n")
                dt = time.time() - t0
            rates[name].append(round(n / dt, 1))
            if n / dt >= max(rates[name]):
                phases[name] = {
                    k2: round(v, 3) for k2, v in ph.totals.items()
                }
                phases[name]["wall"] = round(dt, 3)
    for name in rates:
        out[name] = {
            "reads_per_sec": rates[name],
            "best": max(rates[name]),
            "median": float(np.median(rates[name])),
            "best_phases": phases.get(name, {}),
            "m1": clfs[name][0].table_meta.get("m1"),
        }
    out["light_over_full_median"] = round(
        out["light"]["median"] / max(out["full"]["median"], 1e-9), 3
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
