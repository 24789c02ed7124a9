"""Extended-mode scoring A/B on the device.

Measures the full device step (classify_batch: window extraction + probe +
scoring) for the three extended modes at T=500 and T=10000 targets:

  False    — sort-runs top-2 only (non-extended CSV)
  "sorted"  — the round-3 path: ships the sorted label grid as the
              compressed per-target counts (O(windows) regardless of T)
  True     — dense [R, T+1] segment-sum count matrix (round-2 extended;
              still used where counts must psum/accumulate: mesh + cycles)

Bar: extended device step <= 1.5x non-extended at T=500, and the T=10k
case measured.  Replaces resultKernel-side count materialization
(reference: CuClarkDB.cu:1361-1411).

Run: PYTHONPATH=. python benchmarks/extended_ab.py
"""

from __future__ import annotations

import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks.roofline import _timeit, make_table


def bench_modes(n_keys: int, k: int, n_targets: int, R=8192, S=512):
    from jn_cuclark_tpu.ops import device_pipeline as dp

    table, _, _ = make_table(n_keys, k, n_targets)
    rng = np.random.default_rng(3)
    W = S // 32
    words = jnp.asarray(
        rng.integers(0, 2**63, size=(R, W + 1), dtype=np.uint64)
    )
    vwords = jnp.asarray(
        np.full((R, S // 64 + 1), 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)
    )
    slots = jnp.asarray(table.slots)
    labels = jnp.asarray(table.labels)
    sk = jnp.asarray(table.stash_keys)
    sl = jnp.asarray(table.stash_labels)

    out = {}
    for mode, name in ((False, "plain"), ("sorted", "sorted"), (True, "dense")):
        fn = functools.partial(
            dp.classify_batch, k=k, m1=table.m1, lb=table.lb,
            c=table.slot_width, n_targets=n_targets, extended=mode,
        )
        t = _timeit(fn, slots, labels, sk, sl, words, vwords)
        fetched = fn(slots, labels, sk, sl, words, vwords)
        fetch_mb = sum(np.asarray(a).nbytes for a in fetched) / 2**20
        out[name] = dict(
            step_ms=round(t * 1e3, 2), fetch_mb=round(fetch_mb, 1)
        )
    out["sorted_vs_plain"] = round(
        out["sorted"]["step_ms"] / out["plain"]["step_ms"], 2
    )
    out["dense_vs_plain"] = round(
        out["dense"]["step_ms"] / out["plain"]["step_ms"], 2
    )
    return dict(
        n_keys=n_keys, n_targets=n_targets, batch=dict(reads=R, stride=S),
        **out,
    )


def main():
    k = 31
    res = [bench_modes(6_000_000, k, t) for t in (500, 10_000)]
    print(json.dumps(res, indent=2), flush=True)


if __name__ == "__main__":
    main()
