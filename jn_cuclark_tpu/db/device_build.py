"""Device-side DB aggregation (`clark-tpu db build --device`).

The build-time hot loop — grouping ~10^8 canonical k-mer occurrences and
applying the multiplicity rules — is a sort + segmented reduction.  This
path sorts (canon, seqno) on device, computes first-occurrence labels by
forward-fill, and reduces multiplicity/count/first-seq with segment sums;
the host only compacts the group-start mask.  The native host aggregate
stays the default; chip_smoke.py prints the device path's time per
element on the card.  A failure on the device is an error, never a
silent switch to the host build.

Equivalence with the host aggregation is tested for every mode.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.partial(
    __import__("jax").jit, static_argnames=("lelement",)
)
def _aggregate_device(canon, label, pg_of_label, *, lelement: bool):
    import jax
    import jax.numpy as jnp

    n = canon.shape[0]
    seq = jnp.arange(n, dtype=jnp.int64)
    c, s, l = jax.lax.sort((canon, seq, label.astype(jnp.int32)), num_keys=2)

    grp_start = jnp.concatenate([jnp.ones(1, bool), c[1:] != c[:-1]])
    gid = jnp.cumsum(grp_start.astype(jnp.int64)) - 1
    # forward-fill the first label of each group
    start_pos = jnp.where(grp_start, jnp.arange(n, dtype=jnp.int64), -1)
    ff = jax.lax.associative_scan(jnp.maximum, start_pos)
    L0_of = l[ff]
    pg = pg_of_label
    d = (l != L0_of).astype(jnp.int32) + (pg[l] != pg[L0_of]).astype(jnp.int32)
    d = jnp.where(grp_start, 0, d)
    mult_g = 1 + jax.ops.segment_sum(d, gid, num_segments=n)
    mult_g = jnp.minimum(mult_g, 255)
    gsize = jax.ops.segment_sum(jnp.ones(n, jnp.int32), gid, num_segments=n)
    count_g = jnp.minimum(gsize, 254) if lelement else gsize
    first_g = jax.ops.segment_min(s, gid, num_segments=n)
    return c, grp_start, L0_of, mult_g, count_g, first_g, gid


def aggregate_device(canon, label, pg, lelement: bool):
    """Same contract as native.aggregate_occurrences (unit counts)."""
    import jax.numpy as jnp

    n = len(canon)
    if n == 0:
        return (
            np.zeros(0, np.uint64),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
        )
    c, grp_start, L0_of, mult_g, count_g, first_g, gid = _aggregate_device(
        jnp.asarray(np.ascontiguousarray(canon, np.uint64)),
        jnp.asarray(np.ascontiguousarray(label, np.int32)),
        jnp.asarray(np.ascontiguousarray(pg, np.int32)),
        lelement=lelement,
    )
    c = np.asarray(c)
    mask = np.asarray(grp_start)
    L0_of = np.asarray(L0_of)
    mult_g = np.asarray(mult_g)
    count_g = np.asarray(count_g)
    first_g = np.asarray(first_g)
    idx = np.nonzero(mask)[0]
    ng = len(idx)
    return (
        c[idx],
        L0_of[idx].astype(np.int32),
        mult_g[:ng].astype(np.int32),
        count_g[:ng].astype(np.int64),
        first_g[:ng].astype(np.int64),
    )
