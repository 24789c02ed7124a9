"""Gather-width A/B.

The probe is ONE [Q, C] row gather of u64 slots.  A u32-slot table would
halve the gathered bytes — but exactness forbids it at production scale
(the quotient needs 64-m1 ~ 45 bits; 32-bit slots cannot hold
quotient+label, and truncated slots would need a verification gather that
forfeits the win on hit-heavy workloads).  This measures what that
hypothetical ceiling is worth: the SAME row-count gather at u64 vs u32
width, device-timed (no fetch).

Run:  PYTHONPATH=. python benchmarks/gather_width_ab.py
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
    import jax
    import jax.numpy as jnp

    M1, C, Q = 17, 128, 1 << 23
    rng = np.random.default_rng(0)
    t64 = jnp.asarray(
        rng.integers(0, 2**63, size=(1 << M1, C), dtype=np.uint64)
    )
    t32 = jnp.asarray(
        rng.integers(0, 2**31, size=(1 << M1, C), dtype=np.uint32)
    )
    idx = jnp.asarray(rng.integers(0, 1 << M1, size=Q, dtype=np.int32))

    import functools

    mask = jnp.int32((1 << M1) - 1)

    # serially-dependent gather chain: iteration j+1's rows depend on
    # iteration j's values, so the runtime cannot overlap or elide the
    # gathers; per-gather cost = slope between K and K0 chains.  A tiny
    # device_get ends each timed chain.
    @functools.partial(jax.jit, static_argnames=("k",))
    def chain(t, i, k):
        def body(_, carry):
            r = jnp.max(t[carry], axis=1)
            return (carry + r.astype(jnp.int32)) & mask

        return jax.lax.fori_loop(0, k, body, i)

    def timed(t, k):
        jax.device_get(chain(t, idx, k)[:4])  # compile + sync
        best = 1e30
        for _ in range(3):
            t0 = time.perf_counter()
            jax.device_get(chain(t, idx, k)[:4])
            best = min(best, time.perf_counter() - t0)
        return best

    out = {"rows": 1 << M1, "c": C, "queries": Q}
    K0, K = 2, 10
    for name, t in (("u64", t64), ("u32", t32)):
        per = (timed(t, K) - timed(t, K0)) / (K - K0)
        bytes_moved = Q * C * (8 if name == "u64" else 4)
        out[name] = {
            "ms_per_gather": round(per * 1e3, 2),
            "gb_s": round(bytes_moved / per / 1e9, 1),
            "probes_per_s_M": round(Q / per / 1e6, 1),
        }
    out["u32_speedup"] = round(
        out["u64"]["ms_per_gather"] / out["u32"]["ms_per_gather"], 2
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
