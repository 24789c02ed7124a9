"""Probe roofline measurement on the live device.

Measures, steady-state (best-of-3 after warmup):
  1. raw XLA random-row gather bandwidth across (rows, slot-width) geometries
  2. the production probe (radix_table.probe) in isolation
  3. the full classify_batch, plus its stage breakdown
     (windows/canonicalize -> probe -> counts -> top-2)

Prints a JSON report; runs on the default JAX device (JAX_PLATFORMS=cpu for
a CPU smoke run).

Usage: python benchmarks/roofline.py [--keys 6000000] [--queries 4194304]
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def _sync(out):
    """Force a device->host fetch; device execution is in-order, so
    fetching the last result drains the whole dispatch queue."""
    leaf = jax.tree_util.tree_leaves(out)[-1]
    np.asarray(jax.device_get(leaf.ravel()[:1]))


def _timeit(fn, *args, reps=2, iters=20):
    """Per-iteration steady-state seconds: dispatch `iters` back-to-back,
    sync once at the end; best of `reps`."""
    out = fn(*args)
    _sync(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _sync(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def bench_raw_gather(n_queries: int):
    """XLA gather of random rows: per-row cost vs geometry."""
    rng = np.random.default_rng(0)
    results = []
    for m1, c in [(17, 128), (20, 16), (20, 128), (23, 16), (23, 128)]:
        n_rows = 1 << m1
        tbl = jnp.asarray(
            rng.integers(0, 2**63, size=(n_rows, c), dtype=np.uint64)
        )
        idx = jnp.asarray(
            rng.integers(0, n_rows, size=n_queries, dtype=np.int32)
        )

        @jax.jit
        def g(tbl, idx):
            return jnp.max(tbl[idx], axis=1)

        dt = _timeit(g, tbl, idx)
        rows_per_s = n_queries / dt
        results.append(
            dict(
                rows=n_rows,
                slots=c,
                row_bytes=c * 8,
                table_mb=round(tbl.nbytes / 2**20, 1),
                rows_per_sec=round(rows_per_s / 1e6, 2),
                gathered_gb_per_sec=round(rows_per_s * c * 8 / 2**30, 2),
            )
        )
        del tbl, idx
    return results


def make_table(n_keys: int, k: int, n_targets: int, c=None):
    from jn_cuclark_tpu.ops import radix_table

    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1 << (2 * k), size=n_keys, dtype=np.uint64)
    keys = np.unique(keys)
    labels1 = rng.integers(1, n_targets + 1, size=len(keys)).astype(np.int32)
    return radix_table.build(keys, labels1, k=k, c=c), keys, labels1


def bench_probe(table, keys, n_queries: int, hit_rate=0.5):
    from jn_cuclark_tpu.ops import radix_table

    rng = np.random.default_rng(2)
    k_hits = rng.choice(keys, size=n_queries)
    k_miss = rng.integers(0, np.uint64(1) << np.uint64(50), size=n_queries,
                          dtype=np.uint64)
    q = np.where(rng.random(n_queries) < hit_rate, k_hits, k_miss)
    qd = jnp.asarray(q)
    slots = jnp.asarray(table.slots)
    labels = jnp.asarray(table.labels)
    sk = jnp.asarray(table.stash_keys)
    sl = jnp.asarray(table.stash_labels)

    import functools

    probe = jax.jit(
        functools.partial(
            radix_table.probe, m1=table.m1, lb=table.lb, c=table.slot_width
        )
    )
    dt = _timeit(probe, slots, labels, sk, sl, qd)
    return dict(
        n_queries=n_queries,
        table_rows=table.slots.shape[0],
        slot_width=table.slot_width,
        table_mb=round(table.nbytes / 2**20, 1),
        probes_per_sec_m=round(n_queries / dt / 1e6, 2),
        gathered_gb_per_sec=round(
            n_queries / dt * table.slot_width * 8 / 2**30, 2
        ),
    )


def bench_stages(table, k: int, n_targets: int, R=8192, S=512):
    """Full classify_batch + per-stage costs at one batch geometry."""
    import functools

    from jn_cuclark_tpu.ops import device_pipeline as dp
    from jn_cuclark_tpu.ops import radix_table, score

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

    full = functools.partial(
        dp.classify_batch, k=k, m1=table.m1, lb=table.lb,
        c=table.slot_width, n_targets=n_targets,
    )
    t_full = _timeit(full, slots, labels, sk, sl, words, vwords)

    win = jax.jit(functools.partial(dp.window_canonicals, k=k))
    t_win = _timeit(win, words, vwords)

    canon, valid = win(words, vwords)
    q = jnp.where(valid, canon, radix_table.EMPTY).ravel()
    probe = jax.jit(
        functools.partial(
            radix_table.probe, m1=table.m1, lb=table.lb, c=table.slot_width
        )
    )
    t_probe = _timeit(probe, slots, labels, sk, sl, q)

    lab = probe(slots, labels, sk, sl, q)
    rid = jnp.repeat(jnp.arange(R, dtype=jnp.int32), S)
    cnt = jax.jit(
        functools.partial(score.counts_from_hits, n_reads=R,
                          n_targets=n_targets)
    )
    t_counts = _timeit(cnt, lab, rid)
    counts = cnt(lab, rid)
    t_top2 = _timeit(jax.jit(score.read_results), counts)

    nw = R * S
    return dict(
        batch=dict(reads=R, stride=S, windows=nw),
        full_ms=round(t_full * 1e3, 2),
        windows_per_sec_m=round(nw / t_full / 1e6, 2),
        stage_ms=dict(
            window_canonicals=round(t_win * 1e3, 2),
            probe=round(t_probe * 1e3, 2),
            counts=round(t_counts * 1e3, 2),
            top2=round(t_top2 * 1e3, 2),
        ),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=6_000_000)
    ap.add_argument("--queries", type=int, default=1 << 22)
    ap.add_argument("--targets", type=int, default=500)
    ap.add_argument("--k", type=int, default=27)
    ap.add_argument("--skip-raw", action="store_true")
    args = ap.parse_args()

    dev = jax.devices()[0]
    report = dict(device=str(dev), platform=dev.platform)

    if not args.skip_raw:
        report["raw_gather"] = bench_raw_gather(args.queries)

    table, keys, _ = make_table(args.keys, args.k, args.targets)
    report["probe"] = bench_probe(table, keys, args.queries)
    report["stages"] = bench_stages(table, args.k, args.targets)

    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
