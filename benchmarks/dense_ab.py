"""Dense two-choice table A/B.

Two measurements, both with the carry-perturbed chain method (each
step's queries depend on the previous step's labels):

1. PROBE COST: standard single-gather probe vs dense two-gather probe,
   both resident, at a mid-scale DB (both fit device memory).

2. RESIDENT-DENSE vs CYCLED at a >=500M-key synthetic DB whose STANDARD
   table exceeds the device budget (the regime the layout exists
   for): dense = one upload + probe steps; cycled = per-pass chunk
   re-upload + probe steps.  Reports per-pass walls and the throughput
   ratio.  The reference would cycle here (CuClarkDB.cu:526-565).

Run:  PYTHONPATH=. python benchmarks/dense_ab.py
Env:  DENSE_AB_SMALL=1 for a CPU-smoke-sized run;
      DENSE_AB_PART=probe|cycle|all (default all).
Prints one JSON line per part.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _chain_probe(probe_fn, arrs, qbase, k):
    """Serially-dependent probe chain: iteration j+1's queries depend on
    iteration j's labels, so the runtime cannot overlap/elide steps.

    `arrs` (the table arrays) are jit ARGUMENTS — a closure capture would
    bake them into the lowered program as multi-GB constants."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("n",))
    def chain(arrs, q, n):
        def body(_, carry):
            lab = probe_fn(arrs, q ^ carry.astype(jnp.uint64))
            return (carry + lab) & jnp.int32(255)

        return jax.lax.fori_loop(
            0, n, body, jnp.zeros(q.shape, jnp.int32)
        )

    def timed(n):
        jax.device_get(chain(arrs, qbase, n)[:4])  # compile + sync
        best = 1e30
        for _ in range(3):
            t0 = time.perf_counter()
            jax.device_get(chain(arrs, qbase, n)[:4])
            best = min(best, time.perf_counter() - t0)
        return best

    k0 = max(k // 5, 1)
    return (timed(k) - timed(k0)) / (k - k0)


def part_probe(small):
    """Standard vs dense probe cost, both resident."""
    import jax
    import jax.numpy as jnp

    from jn_cuclark_tpu.ops import radix_table as rt

    n = 1 << 20 if small else 220_000_000
    q_n = 1 << 16 if small else 1 << 22
    chain_k = 5 if small else 10
    rng = np.random.default_rng(0)
    keys = rng.integers(1, 1 << 62, size=n, dtype=np.uint64)
    labels1 = rng.integers(1, 5000, size=n).astype(np.int32)
    t0 = time.time()
    std = rt.build(keys, labels1)
    t_std = time.time() - t0
    t0 = time.time()
    dn = rt.build_dense(keys, labels1)
    t_dn = time.time() - t0
    out = {
        "part": "probe", "n_keys": n,
        "std": {"m1": std.m1, "gb": round(std.nbytes / 1e9, 2),
                "build_s": round(t_std, 1)},
        "dense": {"m1": dn.m1, "m2": dn.m2,
                  "gb": round(dn.nbytes / 1e9, 2),
                  "build_s": round(t_dn, 1)},
    }
    qb = jnp.asarray(rng.integers(1, 1 << 62, size=q_n, dtype=np.uint64))

    s_arrs = (jax.device_put(std.slots), jax.device_put(std.stash_keys),
              jax.device_put(std.stash_labels))
    meta = std.meta

    def p_std(arrs, q):
        return rt.probe(arrs[0], None, arrs[1], arrs[2], q, **meta)

    per_std = _chain_probe(p_std, s_arrs, qb, chain_k)
    out["std"]["ms_per_step"] = round(per_std * 1e3, 2)
    out["std"]["mprobes_s"] = round(q_n / per_std / 1e6, 1)
    del s_arrs

    d_arrs = (jax.device_put(dn.slots1), jax.device_put(dn.slots2),
              jax.device_put(dn.stash_keys), jax.device_put(dn.stash_labels))
    dmeta = dn.meta

    def p_dn(arrs, q):
        return rt.probe_dense(arrs[0], arrs[1], arrs[2], arrs[3], q, **dmeta)

    per_dn = _chain_probe(p_dn, d_arrs, qb, chain_k)
    out["dense"]["ms_per_step"] = round(per_dn * 1e3, 2)
    out["dense"]["mprobes_s"] = round(q_n / per_dn / 1e6, 1)
    out["dense_cost_ratio"] = round(per_dn / per_std, 3)
    print(json.dumps(out), flush=True)


def part_cycle(small):
    """Resident-dense vs cycled-standard at a DB whose standard table
    exceeds the device budget."""
    import jax
    import jax.numpy as jnp

    from jn_cuclark_tpu.ops import radix_table as rt

    n = 1 << 20 if small else 800_000_000
    # 2^21 queries: the dense arm holds TWO [Q, 2C] u32 gather outputs at
    # once (plane 1 + plane 2, ~2.1 GB each) next to the 8.6 GB plane;
    # 2^22 would need ~17 GB.  (Before the u32-halves layout the u64
    # X64-split temps alone OOMed this part: 20.17G requested.)
    q_n = 1 << 16 if small else 1 << 21
    chain_k = 5 if small else 10
    n_chunks = 3
    rng = np.random.default_rng(1)

    def _to_halves(a, c):
        """Convert a cached u64 [rows, C] slot array to the current u32
        contiguous-halves layout (radix_table layout comment); u32 arrays
        pass through."""
        if a.dtype == np.uint32:
            return a
        rows = a.shape[0]
        return np.ascontiguousarray(
            a.view(np.uint32).reshape(rows, c, 2).transpose(0, 2, 1)
        ).reshape(rows, 2 * c)

    def cached_builds():
        """Cache the two 800M-key host builds on disk so device-side
        retries are cheap."""
        cache = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench_cache", f"dense_ab_{n}")
        os.makedirs(cache, exist_ok=True)
        meta_p = os.path.join(cache, "meta.json")
        if os.path.exists(meta_p):
            m = json.load(open(meta_p))
            c = m["c"]
            dn = rt.DenseTable(
                slots1=_to_halves(
                    np.load(os.path.join(cache, "d1.npy"), mmap_mode="r"), c
                ),
                slots2=_to_halves(
                    np.load(os.path.join(cache, "d2.npy"), mmap_mode="r"), c
                ),
                stash_keys=np.load(os.path.join(cache, "dsk.npy")),
                stash_labels=np.load(os.path.join(cache, "dsl.npy")),
                m1=m["dm1"], m2=m["dm2"], lb=m["dlb"], slot_width=c,
            )
            std = rt.RadixTable(
                slots=_to_halves(
                    np.load(os.path.join(cache, "s.npy"), mmap_mode="r"), c
                ),
                labels=np.zeros(0, np.uint32),
                stash_keys=np.load(os.path.join(cache, "ssk.npy")),
                stash_labels=np.load(os.path.join(cache, "ssl.npy")),
                m1=m["sm1"], lb=m["slb"], slot_width=c,
            )
            return dn, std, m["build_dn"], m["build_std"]
        keys = rng.integers(1, 1 << 62, size=n, dtype=np.uint64)
        labels1 = rng.integers(1, 5000, size=n).astype(np.int32)
        t0 = time.time()
        dn = rt.build_dense(keys, labels1)
        build_dn = time.time() - t0
        t0 = time.time()
        std = rt.build(keys, labels1)
        build_std = time.time() - t0
        del keys, labels1
        if not small:
            np.save(os.path.join(cache, "d1.npy"), dn.slots1)
            np.save(os.path.join(cache, "d2.npy"), dn.slots2)
            np.save(os.path.join(cache, "dsk.npy"), dn.stash_keys)
            np.save(os.path.join(cache, "dsl.npy"), dn.stash_labels)
            np.save(os.path.join(cache, "s.npy"), std.slots)
            np.save(os.path.join(cache, "ssk.npy"), std.stash_keys)
            np.save(os.path.join(cache, "ssl.npy"), std.stash_labels)
            json.dump(
                dict(dm1=dn.m1, dm2=dn.m2, dlb=dn.lb, c=dn.slot_width,
                     sm1=std.m1, slb=std.lb, build_dn=round(build_dn, 1),
                     build_std=round(build_std, 1)),
                open(meta_p, "w"),
            )
        return dn, std, build_dn, build_std

    dn, std, build_dn, build_std = cached_builds()
    chunks = rt.chunk_table(std, n_chunks)
    out = {
        "part": "cycle", "n_keys": n, "n_chunks": n_chunks,
        "std_gb": round(std.nbytes / 1e9, 2),
        "dense_gb": round(dn.nbytes / 1e9, 2),
        "std_build_s": round(build_std, 1),
        "dense_build_s": round(build_dn, 1),
    }
    qb = jnp.asarray(rng.integers(1, 1 << 62, size=q_n, dtype=np.uint64))

    # dense: one upload, then steady-state probe steps
    t0 = time.time()
    d_arrs = (jax.device_put(dn.slots1), jax.device_put(dn.slots2),
              jax.device_put(dn.stash_keys), jax.device_put(dn.stash_labels))
    jax.block_until_ready(d_arrs[0])
    jax.device_get(d_arrs[2][:1])
    up_dense = time.time() - t0
    dmeta = dn.meta

    def p_dn(arrs, q):
        return rt.probe_dense(arrs[0], arrs[1], arrs[2], arrs[3], q, **dmeta)

    per_dense = _chain_probe(p_dn, d_arrs, qb, chain_k)
    del d_arrs
    out["dense_upload_s"] = round(up_dense, 1)
    out["dense_ms_per_step"] = round(per_dense * 1e3, 2)

    # cycled: each pass re-uploads its chunk, then runs the same steps.
    # B batch-steps per pass amortize the upload the way the engine's
    # pipeline does within one sample window.
    B = 4
    sk = jax.device_put(std.stash_keys)
    sl = jax.device_put(std.stash_labels)
    meta = std.meta
    pass_walls = []
    per_chunk_probe = []
    for ch in chunks:
        t0 = time.time()
        blk = jax.device_put(ch["slots"])
        jax.block_until_ready(blk)
        jax.device_get(sk[:1])
        up = time.time() - t0
        start = jnp.int32(ch["start_row"])
        use = jnp.bool_(ch["use_stash"])

        def p_ch(arrs, q):
            blk_, sk_, sl_, start_, use_ = arrs
            return rt.probe_chunk(
                blk_, None, sk_, sl_, q, start_, use_stash=use_, **meta
            )

        per = _chain_probe(p_ch, (blk, sk, sl, start, use), qb, chain_k)
        per_chunk_probe.append(per)
        pass_walls.append(up + B * per)
        del blk
    out["cycled_upload_s_per_pass"] = [
        round(w - B * p, 1) for w, p in zip(pass_walls, per_chunk_probe)
    ]
    out["cycled_ms_per_step"] = [
        round(p * 1e3, 2) for p in per_chunk_probe
    ]
    # throughput over one full workload window of B batch-steps:
    # dense = B steps; cycled = sum over chunks of (upload + B steps)
    dense_wall = B * per_dense
    cycled_wall = sum(pass_walls)
    out["B_steps_per_pass"] = B
    out["dense_window_s"] = round(dense_wall, 2)
    out["cycled_window_s"] = round(cycled_wall, 2)
    out["dense_over_cycled"] = round(cycled_wall / dense_wall, 1)
    print(json.dumps(out), flush=True)


def main():
    small = os.environ.get("DENSE_AB_SMALL") == "1"
    part = os.environ.get("DENSE_AB_PART", "all")
    if part in ("probe", "all"):
        part_probe(small)
    if part in ("cycle", "all"):
        part_cycle(small)


if __name__ == "__main__":
    main()
