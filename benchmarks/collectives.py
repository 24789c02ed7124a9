"""Collective-cost trend vs mesh size P on the virtual CPU mesh.

The >=80% multi-host scaling bar (BASELINE.md) was model-only; nothing
measured how collective time GROWS with P.  Absolute CPU-mesh numbers say
nothing about a GPU, but the TREND (per-batch overhead of the psum merge as
P doubles, against the dp-mode zero-collective baseline) is the shape the
model needs: the psum payload is O(windows) for the labels kind and
O(reads*targets) for counts, both independent of P per device, so healthy
scaling shows near-flat per-batch collective cost as P grows.

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python benchmarks/collectives.py
Writes one JSON line per (mode, P).
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _timeit(fn, *args, reps=3, iters=5):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def main(n_keys=200_000, k=27, T=500, R=512, S=256):
    from jn_cuclark_tpu.ops import radix_table
    from jn_cuclark_tpu.parallel.mesh import ShardedRadixTable, make_mesh, shard_reads

    rng = np.random.default_rng(0)
    keys = np.unique(
        rng.integers(0, 1 << (2 * k), size=n_keys, dtype=np.uint64)
    )
    labels1 = rng.integers(1, T + 1, size=len(keys)).astype(np.int32)
    words = rng.integers(0, 2**63, size=(R, S // 32 + 1), dtype=np.uint64)
    words[:, -1] = 0
    vwords = np.full((R, S // 64 + 1), ~np.uint64(0), dtype=np.uint64)
    vwords[:, -1] = 0

    results = []
    # dp baseline (zero collectives): replicated table, reads sharded
    table = radix_table.build(keys, labels1, k=k)
    for P in (1, 2, 4, 8):
        mesh = make_mesh(P, axis="dp")
        _, batch_fn = shard_reads(mesh, table, T, k)
        t = _timeit(
            lambda w, v: batch_fn(w, v, extended=False),
            jnp.asarray(words), jnp.asarray(vwords),
        )
        r = dict(mode="dp", P=P, ms_per_batch=round(t * 1e3, 2))
        print(json.dumps(r), flush=True)
        results.append(r)

    # psum-only microbenchmark: the labels merge is ONE psum of [R*S] i32
    # partials, the counts merge ONE psum of [R*(T+1)] i32 — payload is
    # P-independent per device, so on dedicated NVLink links the cost is
    # ~flat in P (ring all-reduce moves 2(P-1)/P * payload per device);
    # on the shared-core CPU mesh it grows with P because all P virtual
    # devices share the same memory bandwidth
    from jn_cuclark_tpu.parallel.mesh import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as PS

    for name, payload in (("labels", R * S), ("counts", R * (T + 1))):
        for P in (2, 4, 8):
            mesh = make_mesh(P, axis="x")
            x = jax.device_put(
                jnp.ones((P, payload), jnp.int32),
                NamedSharding(mesh, PS("x")),
            )
            f = jax.jit(
                shard_map(
                    lambda blk: jax.lax.psum(blk, "x"),
                    mesh, in_specs=PS("x"), out_specs=PS(),
                )
            )
            t = _timeit(f, x)
            r = dict(
                mode=f"psum:{name}", P=P,
                payload_mb=round(payload * 4 / 2**20, 2),
                ms=round(t * 1e3, 3),
            )
            print(json.dumps(r), flush=True)
            results.append(r)

    # db-sharded: per-device probe of 1/P of the table + ONE psum
    for kind in ("classify_top2", "classify"):
        for P in (2, 4, 8):
            mesh = make_mesh(P)
            sh = ShardedRadixTable(mesh, keys, labels1, T, k, db_cycles=1)
            t = _timeit(
                lambda w, v: sh.classify(w, v, extended=(kind == "classify")),
                jnp.asarray(words), jnp.asarray(vwords),
            )
            r = dict(
                mode=f"db:{'counts' if kind == 'classify' else 'labels'}",
                P=P, ms_per_batch=round(t * 1e3, 2),
            )
            print(json.dumps(r), flush=True)
            results.append(r)
    return results


if __name__ == "__main__":
    main()
