"""u64-slot vs u32-halves probe A/B (ROADMAP S2 step 3).

The table is stored as u32 contiguous halves (radix_table.py) because
earlier hardware emulated u64 and split u64 jit arguments into hi/lo
copies.  This compares the two layouts (identical bytes, ONE row gather
each): compiled memory analysis (argument + temp bytes) and
carry-perturbed chain timing.

Run:  PYTHONPATH=. python benchmarks/u32_probe_ab.py
Env:  U32_AB_M1 (22 -> 4 GB table), U32_AB_Q (1<<21), U32_AB_SMALL=1.
Prints one JSON line.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

C = 128
LB = 14  # label bits, production-typical


def _chain(probe_fn, arrs, qbase, k):
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("n",))
    def chain(arrs, q, n):
        def body(_, carry):
            lab = probe_fn(arrs, q ^ carry.astype(jnp.uint64))
            return (carry + lab) & jnp.int32(255)

        return jax.lax.fori_loop(0, n, body, jnp.zeros(q.shape, jnp.int32))

    def timed(n):
        jax.device_get(chain(arrs, qbase, n)[:4])
        best = 1e30
        for _ in range(3):
            t0 = time.perf_counter()
            jax.device_get(chain(arrs, qbase, n)[:4])
            best = min(best, time.perf_counter() - t0)
        return best

    k0 = max(1, k // 5)
    per = (timed(k) - timed(k0)) / (k - k0)
    return per, chain


def _mem(chain, arrs, qbase, k):
    import jax

    c = jax.jit(chain.__wrapped__, static_argnames=("n",)).lower(
        arrs, qbase, n=k
    ).compile()
    m = c.memory_analysis()
    if m is None:
        return {}
    return {
        "argument_mb": round(m.argument_size_in_bytes / 1e6, 1),
        "temp_mb": round(m.temp_size_in_bytes / 1e6, 1),
        "total_mb": round(
            (m.argument_size_in_bytes + m.temp_size_in_bytes
             + m.output_size_in_bytes) / 1e6, 1),
    }


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    small = os.environ.get("U32_AB_SMALL") == "1"
    # m1 >= LB keeps (quotient << LB) within 64 bits (the production
    # layout invariant: slot = (quotient << lb) | label, 64-m1+lb <= 64)
    m1 = int(os.environ.get("U32_AB_M1", "16" if small else "22"))
    q_n = int(os.environ.get("U32_AB_Q", str(1 << (10 if small else 21))))
    chain_k = 5 if small else 10
    rows = 1 << m1
    rng = np.random.default_rng(0)

    # synthetic slots with the production encoding: (quotient << LB) | lab
    slots = rng.integers(0, 1 << 62, size=(rows, C), dtype=np.uint64)
    slots = (slots & ~np.uint64((1 << LB) - 1)) | rng.integers(
        1, 1 << LB, size=(rows, C), dtype=np.uint64
    )
    slots32 = slots.view(np.uint32).reshape(rows, 2 * C)  # [lo, hi] pairs
    qb = jnp.asarray(rng.integers(1, 1 << 62, size=q_n, dtype=np.uint64))

    def probe64(arrs, qq):
        (s,) = arrs
        mixed = qq * jnp.uint64(np.uint64(0x9E3779B97F4A7C15))
        b = (mixed >> jnp.uint64(64 - m1)).astype(jnp.int32)
        qlow = mixed & jnp.uint64((1 << (64 - m1)) - 1)
        rows_g = s[b]
        x = rows_g ^ (qlow << jnp.uint64(LB))[:, None]
        hit = jnp.where(x < jnp.uint64(1 << LB), x, jnp.uint64(0))
        return jnp.max(hit, axis=1).astype(jnp.int32)

    def probe32(arrs, qq):
        (s32,) = arrs
        mixed = qq * jnp.uint64(np.uint64(0x9E3779B97F4A7C15))
        b = (mixed >> jnp.uint64(64 - m1)).astype(jnp.int32)
        qlow = mixed & jnp.uint64((1 << (64 - m1)) - 1)
        ql = qlow << jnp.uint64(LB)
        t_lo = (ql & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
        t_hi = (ql >> jnp.uint64(32)).astype(jnp.uint32)
        rows_g = s32[b].reshape(-1, C, 2)  # [Q, C, (lo, hi)]
        x_lo = rows_g[:, :, 0] ^ t_lo[:, None]
        x_hi = rows_g[:, :, 1] ^ t_hi[:, None]
        hit = (x_hi == 0) & (x_lo < jnp.uint32(1 << LB))
        lab = jnp.where(hit, x_lo.astype(jnp.int32), 0)
        return jnp.max(lab, axis=1)

    # contiguous-halves layout: row = [lo_0..lo_{C-1}, hi_0..hi_{C-1}] so
    # the probe slices two contiguous halves instead of stride-2 columns
    slots32h = np.ascontiguousarray(
        slots.view(np.uint32).reshape(rows, C, 2).transpose(0, 2, 1)
    ).reshape(rows, 2 * C)

    def probe32h(arrs, qq):
        (s32,) = arrs
        mixed = qq * jnp.uint64(np.uint64(0x9E3779B97F4A7C15))
        b = (mixed >> jnp.uint64(64 - m1)).astype(jnp.int32)
        qlow = mixed & jnp.uint64((1 << (64 - m1)) - 1)
        ql = qlow << jnp.uint64(LB)
        t_lo = (ql & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
        t_hi = (ql >> jnp.uint64(32)).astype(jnp.uint32)
        rows_g = s32[b]  # [Q, 2C]: lo half then hi half
        x_lo = rows_g[:, :C] ^ t_lo[:, None]
        x_hi = rows_g[:, C:] ^ t_hi[:, None]
        hit = (x_hi == 0) & (x_lo < jnp.uint32(1 << LB))
        lab = jnp.where(hit, x_lo.astype(jnp.int32), 0)
        return jnp.max(lab, axis=1)

    out = {
        "m1": m1, "rows": rows, "table_gb": round(slots.nbytes / 1e9, 2),
        "q_n": q_n,
    }
    # one layout resident at a time: three 4 GB tables plus the u64 arm's
    # split temps do not coexist on a 16 GB chip
    ref_labels = None
    variants = os.environ.get("U32_AB_VARIANTS", "u64,u32,u32h").split(",")
    host = {"u64": slots, "u32": slots32, "u32h": slots32h}
    fns = {"u64": probe64, "u32": probe32, "u32h": probe32h}
    per = {}
    for name in variants:
        arrs = (jnp.asarray(host[name]),)
        lab = np.asarray(jax.jit(fns[name])(arrs, qb[: 1 << 10]))
        if ref_labels is None:
            ref_labels = lab
        else:
            assert np.array_equal(ref_labels, lab), f"{name} disagrees"
        p, ch = _chain(fns[name], arrs, qb, chain_k)
        per[name] = p
        out[f"{name}_ms_per_step"] = round(p * 1e3, 2)
        try:
            out[f"{name}_mem"] = _mem(ch, arrs, qb, chain_k)
        except Exception as e:
            out[f"{name}_mem_error"] = str(e)[:200]
        del arrs
        print(json.dumps({k: out[k] for k in out if k.startswith(name)}),
              flush=True)
    if "u64" in per:
        for name in per:
            if name != "u64":
                out[f"{name}_over_u64"] = round(per[name] / per["u64"], 3)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
