"""Fixed-slot hash table for device k-mer lookup — the hot-path index.

This table answers a query with ONE wide row gather and in-row compares,
instead of a binary search's log2(N) dependent scalar gathers:

  * single level: [n1, C] 64-bit slots, bucket = top m1 bits of an odd-
    multiplier Fibonacci mix of the canonical value (C=128 slots/bucket
    at a mean of 44-88 keys per bucket: 12-23 B/key).  The row width and
    the slot layout below were tuned on earlier hardware; ROADMAP S2
    measures them on the H100
  * quotient storage: the mix (odd-multiplier mod 2^64) is a BIJECTION, so a
    slot only needs the mixed value's low 64-m1 bits — the bucket index
    supplies the rest.  This is the reference's own quotient/remainder trick
    (it stores quotient = kmer / HTSIZE keyed by remainder,
    hashTable_hh.hh:473-546) recast for power-of-2 buckets.  The freed m1
    bits hold the label: slot = (mixed_lo << lb) | (label+1), and EVERY
    configuration (any k, up to the reference's 65535-target MTRGTS cap) is
    a single-gather lookup — no separate label array.
  * stash: build-time bucket overflow (~1e-6 of keys at load 4.5) goes to a
    tiny replicated stash (<= 64 entries) checked with a broadcast compare —
    elementwise work, no gather; if the stash would overflow, the table is
    rebuilt one bit larger

Empty slots are all-ones.  No false hits: lb < m1 makes EMPTY >> lb wider
than any 64-m1-bit query quotient, the all-ones label field is reserved
(lb sized for maxlabel+2), and bijectivity means a padded/invalid query
(canonical = EMPTY, never a real k-mer value) cannot collide with a stored
key — so misses resolve to label 0 ("NA"), the engine's miss convention.

This replaces the reference's bucketed quotient/remainder probe
(CuClarkDB.cu:1189-1254) as the in-memory layout only; the on-disk format is
still the reference's .sz/.ky/.lb (io/dbformat.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
EMPTY32 = np.uint32(0xFFFFFFFF)  # both u32 halves of an EMPTY slot
_MIX1 = np.uint64(0x9E3779B97F4A7C15)  # 2^64 / golden ratio, odd
_MIX2 = np.uint64(0xC2B2AE3D27D4EB4F)  # xxhash64 prime_2, odd -> bijective
STASH_CAP = 64

# Slot storage is uint32 in CONTIGUOUS-HALVES layout: row i is
# [lo_0..lo_{C-1}, hi_0..hi_{C-1}], the two u32 halves of the C logical
# u64 slots.  Same bytes, same single row gather, with the xor/compare/max
# done in native u32 ops.  The layout was chosen on hardware that emulates
# u64; whether it still pays on the H100 is not measured (ROADMAP S2).
#
# The hit test splits exactly: slot == (qlow << lb) | lab  <=>
# (x_hi == 0) & (x_lo < 2^lb) where x_* = slot_* ^ target_*, because
# lb <= 17 < 32 keeps the label field entirely in the low half.


def _mix_np(q: np.ndarray, mbits: int, mult: np.uint64 = _MIX1) -> np.ndarray:
    with np.errstate(over="ignore"):
        return ((q * mult) >> np.uint64(64 - mbits)).astype(np.int64)


@dataclasses.dataclass
class RadixTable:
    """Host-side build result; arrays are ready for jax.device_put."""

    slots: np.ndarray  # [n1, 2C] uint32 halves of (key << lb) | (label+1)
    #                    (lo half then hi half per row; EMPTY32 if free)
    labels: np.ndarray  # [n1*C] uint32 label+1 (only when lb == 0), else [0]
    stash_keys: np.ndarray  # [STASH_CAP] uint64 (EMPTY padded)
    stash_labels: np.ndarray  # [STASH_CAP] int32 label+1
    m1: int  # log2(n1)
    lb: int  # label bits packed into slots (0 = separate label array)
    slot_width: int

    @property
    def nbytes(self) -> int:
        return self.slots.nbytes + self.labels.nbytes

    @property
    def meta(self) -> dict:
        return dict(m1=self.m1, lb=self.lb, c=self.slot_width)


@dataclasses.dataclass
class TablePlan:
    """Deterministic global layout of a radix table, computed WITHOUT
    materializing the slot array — every process of a multi-host run derives
    the identical plan from the (identical) key set and then fills only its
    own row range with `fill_rows`."""

    m1: int  # log2(row count)
    lb: int  # label bits packed into slots (0 = separate label array)
    c: int  # slots per row
    stash_keys: np.ndarray  # [STASH_CAP] uint64 (EMPTY padded)
    stash_labels: np.ndarray  # [STASH_CAP] int32 label+1
    bucket: np.ndarray  # [n] int64 row of each key
    rank: np.ndarray  # [n] int64 slot rank of each key within its row

    @property
    def n_rows(self) -> int:
        return 1 << self.m1

    @property
    def meta(self) -> dict:
        return dict(m1=self.m1, lb=self.lb, c=self.c)


def _bucket_ranks(keys: np.ndarray, mbits: int, mult: np.uint64 = _MIX1):
    """Per-key (bucket, within-bucket rank) in original key order; rank
    follows the stable sort by bucket, so overflow selection is
    deterministic."""
    b = _mix_np(keys, mbits, mult)
    order = np.argsort(b, kind="stable")
    bs = b[order]
    start_of_run = np.concatenate([[True], bs[1:] != bs[:-1]])
    run_id = np.cumsum(start_of_run) - 1
    run_first = np.nonzero(start_of_run)[0]
    rank_sorted = np.arange(len(bs), dtype=np.int64) - run_first[run_id]
    rank = np.empty(len(bs), dtype=np.int64)
    rank[order] = rank_sorted
    return b, rank


def plan_table(
    keys: np.ndarray,
    labels1: np.ndarray,
    k: int | None = None,
    c: int | None = None,
    load: float | None = None,
) -> TablePlan:
    """Choose (m1, lb, c) and the overflow stash for a key set.

    Pure function of its inputs: independent processes planning the same DB
    agree bit-for-bit (required for multi-host sharding).  `k` is accepted
    for API stability but unused: quotient storage packs the label for every
    key width (see module docstring)."""
    del k
    keys = np.asarray(keys, dtype=np.uint64)
    labels1 = np.asarray(labels1, dtype=np.int32)
    n = max(len(keys), 1)
    if c is None:
        c = 128 if n >= 500_000 else 16
    if load is None:
        # mean keys/bucket lands in (load/2, load]; 0.69*c keeps the
        # binomial overflow tail within the stash at any n while rounding
        # m1 down one step vs 0.44*c in most cases: half the table bytes
        # (a 4.3 GB table instead of 8.6 GB at 244M keys)
        load = c * 0.69
    maxlab = int(labels1.max()) if len(labels1) else 1
    # label bits: the all-ones field is reserved so a valid slot never equals
    # EMPTY, hence maxlab + 2 values must fit
    lb = max(int(np.ceil(np.log2(maxlab + 2))), 2)
    m1 = max(int(np.ceil(np.log2(max(n / load, 1.0)))), 1)
    # lb < m1 keeps slot bits within 64 AND makes EMPTY >> lb wider than any
    # (64 - m1)-bit quotient, so EMPTY slots can never satisfy the compare
    m1 = max(m1, lb + 1)
    while True:
        b, rank = _bucket_ranks(keys, m1)
        ovf = rank >= c
        n_ovf = int(ovf.sum())
        if n_ovf <= STASH_CAP:
            break
        m1 += 1
    sk = np.full(STASH_CAP, EMPTY, dtype=np.uint64)
    sl = np.zeros(STASH_CAP, dtype=np.int32)
    if n_ovf:
        sk[:n_ovf] = keys[ovf]
        sl[:n_ovf] = labels1[ovf]
    return TablePlan(
        m1=m1, lb=lb, c=c, stash_keys=sk, stash_labels=sl, bucket=b, rank=rank
    )


def fill_rows(
    keys: np.ndarray,
    labels1: np.ndarray,
    plan: TablePlan,
    row_start: int,
    row_end: int,
):
    """Materialize rows [row_start, row_end) of the planned table.

    Slot = (mixed_lo << lb) | (label+1) where mixed_lo is the low 64-m1 bits
    of the bijective mix (the bucket row supplies the top m1 bits).  The
    returned labels array is always empty (kept for API stability with the
    callers' (slots, labels) plumbing).  row_end may exceed plan.n_rows
    (padding rows for even device splits stay EMPTY)."""
    keys = np.asarray(keys, dtype=np.uint64)
    labels1 = np.asarray(labels1, dtype=np.int32)
    c, lb = plan.c, plan.lb
    rows = row_end - row_start
    sel = (plan.bucket >= row_start) & (plan.bucket < row_end) & (plan.rank < c)
    bb = plan.bucket[sel] - row_start
    rr = plan.rank[sel]
    with np.errstate(over="ignore"):
        mixed = keys[sel] * _MIX1
    qlow = mixed & np.uint64((1 << (64 - plan.m1)) - 1)
    lo = labels1[sel].astype(np.uint64)
    val = (qlow << np.uint64(lb)) | lo
    slots = np.full((rows, 2 * c), EMPTY32, dtype=np.uint32)
    slots[bb, rr] = (val & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    slots[bb, c + rr] = (val >> np.uint64(32)).astype(np.uint32)
    return slots, np.zeros(0, dtype=np.uint32)


def build(
    keys: np.ndarray,
    labels1: np.ndarray,
    k: int | None = None,
    c: int | None = None,
    load: float | None = None,
) -> RadixTable:
    """Build from unique uint64 canonical keys and int32 labels(+1).

    k enables label packing (single-gather probe); None disables it.
    c/load default by DB size: wide 128-slot buckets for real DBs, narrow
    16-slot buckets for tiny ones (cheaper on CPU and for toy tables).
    """
    keys = np.asarray(keys, dtype=np.uint64)
    labels1 = np.asarray(labels1, dtype=np.int32)
    plan = plan_table(keys, labels1, k=k, c=c, load=load)
    slots, labels = fill_rows(keys, labels1, plan, 0, plan.n_rows)
    return RadixTable(
        slots=slots,
        labels=labels,
        stash_keys=plan.stash_keys,
        stash_labels=plan.stash_labels,
        m1=plan.m1,
        lb=plan.lb,
        slot_width=plan.c,
    )


_CACHE_VERSION = 5  # v5: u32 contiguous-halves slots (v4: load 0.69)


def db_signature(stem: str) -> np.ndarray:
    """Cheap content signature of the DB files backing a cached index:
    (.ky size, .sz size, crc32 of .ky head+tail).  Guards against a DB
    rebuilt within mtime granularity or copied with `cp -p` (which round 1's
    mtime-only check missed)."""
    import os
    import zlib

    ky, sz = stem + ".ky", stem + ".sz"
    n_ky = os.path.getsize(ky)
    n_sz = os.path.getsize(sz)
    crc = 0
    with open(ky, "rb") as f:
        crc = zlib.crc32(f.read(1 << 16), crc)
        if n_ky > (1 << 16):
            f.seek(-min(1 << 16, n_ky - (1 << 16)), os.SEEK_END)
            crc = zlib.crc32(f.read(), crc)
    return np.array([n_ky, n_sz, crc], dtype=np.int64)


def save_cache(path: str, table: RadixTable, signature: np.ndarray | None = None):
    """Persist the built table so repeat loads skip the ~1s/M-key build.
    Written atomically (tmp + rename) so concurrent processes never observe a
    truncated file."""
    import os
    import tempfile

    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                version=_CACHE_VERSION,
                slots=table.slots,
                labels=table.labels,
                stash_keys=table.stash_keys,
                stash_labels=table.stash_labels,
                meta=np.array([table.m1, table.lb, table.slot_width]),
                signature=(
                    signature
                    if signature is not None
                    else np.zeros(3, dtype=np.int64)
                ),
            )
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load_cache(path: str, signature: np.ndarray | None = None) -> RadixTable | None:
    try:
        z = np.load(path)
        if int(z["version"]) != _CACHE_VERSION:
            return None
        if signature is not None and not np.array_equal(
            np.asarray(z["signature"]), signature
        ):
            return None
        m1, lb, c = (int(x) for x in z["meta"])
        return RadixTable(
            slots=z["slots"],
            labels=z["labels"],
            stash_keys=z["stash_keys"],
            stash_labels=z["stash_labels"],
            m1=m1,
            lb=lb,
            slot_width=c,
        )
    except Exception:  # corrupt/partial cache -> rebuild from the DB files
        return None


def _probe_rows(slots, qlow, b, lb):
    """Match the query quotients against their gathered rows; returns
    label+1 per query (0 = miss).

    xor trick, on the u32 halves (see the layout comment at EMPTY32):
    slot = (quotient << lb) | (label+1), so x = slot ^ (qlow << lb)
    equals label+1 (< 2^lb) exactly when the quotients match and
    >= 2^lb otherwise (any differing quotient bit lands above lb;
    EMPTY's all-ones quotient field can never cancel — see module
    docstring).  With the target split into u32 halves that is
    (x_hi == 0) & (x_lo < 2^lb), and the label is x_lo — all native
    u32 ops on ONE [Q, 2C] row gather."""
    import jax.numpy as jnp

    rows = slots[b]  # [Q, 2C]: lo half then hi half
    c = rows.shape[1] // 2
    ql = qlow << jnp.uint64(lb)
    t_lo = (ql & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    t_hi = (ql >> jnp.uint64(32)).astype(jnp.uint32)
    x_lo = rows[:, :c] ^ t_lo[:, None]
    x_hi = rows[:, c:] ^ t_hi[:, None]
    hit = (x_hi == 0) & (x_lo < jnp.uint32(1 << lb))
    hitlab = jnp.where(hit, x_lo.astype(jnp.int32), 0)
    return jnp.max(hitlab, axis=1)


def _stash_lookup(stash_keys, stash_labels, q):
    """Broadcast compare against the tiny stash (elementwise, no gather)."""
    import jax.numpy as jnp

    eq = q[:, None] == stash_keys[None, :]  # [Q, STASH_CAP]
    return jnp.max(jnp.where(eq, stash_labels[None, :], 0), axis=1)


# queries per probe chunk: bounds the [chunk, C] gather/compare temporaries
# so arbitrarily large batch plans fit device memory.  Set at 2^23 (= the
# default window budget), so default plans never enter lax.map and only
# larger plans pay for chunking.
_PROBE_CHUNK = 1 << 23


def _chunked_q(fn, q):
    """Apply fn over EMPTY-padded chunks of q (EMPTY probes miss to 0)."""
    import jax
    import jax.numpy as jnp

    n_q = q.shape[0]
    if n_q <= _PROBE_CHUNK:
        return fn(q)
    n = -(-n_q // _PROBE_CHUNK)
    pad = n * _PROBE_CHUNK - n_q
    if pad:
        q = jnp.concatenate([q, jnp.full((pad,), EMPTY, q.dtype)])
    lab = jax.lax.map(fn, q.reshape(n, _PROBE_CHUNK))
    return lab.reshape(-1)[:n_q]


def probe(slots, labels, stash_keys, stash_labels, q, *, m1: int, lb: int, c: int):
    """Device-side lookup: label+1 per query, 0 on miss.  `labels`/`c` are
    accepted for signature stability; the label rides in the slot."""
    import jax.numpy as jnp

    del labels, c

    def one(qq):
        mixed = qq * jnp.uint64(_MIX1)
        b = (mixed >> jnp.uint64(64 - m1)).astype(jnp.int32)
        qlow = mixed & jnp.uint64((1 << (64 - m1)) - 1)
        lab = _probe_rows(slots, qlow, b, lb)
        slab = _stash_lookup(stash_keys, stash_labels, qq)
        return jnp.maximum(lab, slab)

    return _chunked_q(one, q)


def probe_chunk(
    slots_blk, labels_blk, stash_keys, stash_labels, q, start_row, *,
    m1: int, lb: int, c: int, use_stash,
):
    """Masked probe of a contiguous row chunk (out-of-core cycling / mesh
    sharding).  `use_stash` gates the replicated stash so it is counted by
    exactly one chunk/shard."""
    import jax.numpy as jnp

    del labels_blk, c
    rows_per = slots_blk.shape[0]

    def one(qq):
        mixed = qq * jnp.uint64(_MIX1)
        b = (mixed >> jnp.uint64(64 - m1)).astype(jnp.int32)
        qlow = mixed & jnp.uint64((1 << (64 - m1)) - 1)
        lrow = b - start_row
        inrange = (lrow >= 0) & (lrow < rows_per)
        lrow = jnp.clip(lrow, 0, rows_per - 1)
        lab = _probe_rows(slots_blk, qlow, lrow, lb)
        lab = jnp.where(inrange, lab, 0)
        slab = _stash_lookup(stash_keys, stash_labels, qq)
        slab = jnp.where(use_stash, slab, 0)
        return jnp.maximum(lab, slab)

    return _chunked_q(one, q)


# --------------------------------------------------------------- dense table
#
# Two-choice ("cuckoo-style") dense layout for DBs between 1x and 2x the
# device budget.  The standard table targets load 0.69
# so the binomial overflow tail fits the 64-entry stash with ONE bucket
# choice; pushing occupancy to ~0.9 halves the row count (one m1 bit) but
# overflows ~0.5% of keys — far past any stash.  Those spill into a SECOND
# tiny plane keyed by an independent bijective mix (_MIX2), probed with a
# second row gather.  Plane 2 is ~1/64 the bytes of plane 1.
#
# Within each plane the quotient trick holds unchanged (per-plane mix is a
# bijection, the plane's bucket index supplies the top m-bits), so both
# probes stay exact with zero false hits; a key lives in exactly one plane
# (or the stash), so max(lab1, lab2, stash) is the unique answer.
#
# This buys the reference's any-size-DB guarantee (CuClarkDB.cu:526-565,
# parts/cycles on any GPU) a better point on the curve: a DB that would
# cycle (re-streaming the table every pass) instead stays RESIDENT at
# ~2 gathers/probe.  Cycling remains for DBs past ~2x budget.


@dataclasses.dataclass
class DenseTable:
    """Two-plane dense build result; arrays ready for jax.device_put."""

    slots1: np.ndarray  # [2^m1, 2C] uint32 halves, plane 1 (load ~0.9)
    slots2: np.ndarray  # [2^m2, 2C] uint32 halves, plane 2 (plane-1 overflow)
    stash_keys: np.ndarray  # [STASH_CAP] uint64 (EMPTY padded)
    stash_labels: np.ndarray  # [STASH_CAP] int32 label+1
    m1: int
    m2: int
    lb: int
    slot_width: int

    @property
    def nbytes(self) -> int:
        return self.slots1.nbytes + self.slots2.nbytes

    @property
    def meta(self) -> dict:
        return dict(m1=self.m1, m2=self.m2, lb=self.lb, c=self.slot_width)


_MIX1_INV = np.uint64(pow(int(_MIX1), -1, 1 << 64))  # mix is odd -> invertible


def occupied_count(slots: np.ndarray, c: int) -> int:
    """Number of stored keys in a u32-halves slot array (a slot is EMPTY
    iff its hi half is all-ones — see recover_keys)."""
    return int((slots[:, c:] != EMPTY32).sum())


def recover_keys(table: RadixTable):
    """(keys, labels1) recovered EXACTLY from a built standard table.

    The slot layout is information-preserving: slot = (qlow << lb) | label1
    with qlow the low 64-m1 bits of key * _MIX1 and the bucket row the top
    m1 bits, and the odd multiplier is invertible mod 2^64 — so a table
    loaded from the .idx cache can seed a dense rebuild without re-reading
    the DB files."""
    c = table.slot_width
    lo_h, hi_h = table.slots[:, :c], table.slots[:, c:]
    # a stored slot's hi half is (val >> 32) < 2^31 (val < 2^63), so the
    # all-ones hi half identifies EMPTY exactly
    mask = hi_h != EMPTY32
    rows, _ = np.nonzero(mask)
    vals = lo_h[mask].astype(np.uint64) | (
        hi_h[mask].astype(np.uint64) << np.uint64(32)
    )
    lab = (vals & np.uint64((1 << table.lb) - 1)).astype(np.int32)
    qlow = vals >> np.uint64(table.lb)
    mixed = (rows.astype(np.uint64) << np.uint64(64 - table.m1)) | qlow
    with np.errstate(over="ignore"):
        keys = mixed * _MIX1_INV
    smask = table.stash_keys != EMPTY
    keys = np.concatenate([keys, table.stash_keys[smask]])
    lab = np.concatenate([lab, table.stash_labels[smask].astype(np.int32)])
    return keys, lab


def _fill_plane(keys, labels1, bucket, rank, m, c, lb, mult):
    """[2^m, c] slot plane for the keys with rank < c (quotient = low
    64-m bits of this plane's mix)."""
    sel = rank < c
    bb = bucket[sel]
    rr = rank[sel]
    with np.errstate(over="ignore"):
        mixed = keys[sel] * mult
    qlow = mixed & np.uint64((1 << (64 - m)) - 1)
    lo = labels1[sel].astype(np.uint64)
    val = (qlow << np.uint64(lb)) | lo
    slots = np.full((1 << m, 2 * c), EMPTY32, dtype=np.uint32)
    slots[bb, rr] = (val & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    slots[bb, c + rr] = (val >> np.uint64(32)).astype(np.uint32)
    return slots


def build_dense(
    keys: np.ndarray,
    labels1: np.ndarray,
    c: int | None = None,
    load: float = 0.90,
) -> DenseTable:
    """Build the two-choice dense table (see block comment above)."""
    keys = np.asarray(keys, dtype=np.uint64)
    labels1 = np.asarray(labels1, dtype=np.int32)
    n = max(len(keys), 1)
    if c is None:
        c = 128 if n >= 500_000 else 16
    maxlab = int(labels1.max()) if len(labels1) else 1
    lb = max(int(np.ceil(np.log2(maxlab + 2))), 2)
    m1 = max(int(np.ceil(np.log2(max(n / (load * c), 1.0)))), 1, lb + 1)
    b1, r1 = _bucket_ranks(keys, m1, _MIX1)
    slots1 = _fill_plane(keys, labels1, b1, r1, m1, c, lb, _MIX1)
    ovf = r1 >= c
    k2, l2 = keys[ovf], labels1[ovf]
    n2 = max(len(k2), 1)
    m2 = max(int(np.ceil(np.log2(max(n2 / (0.69 * c), 1.0)))), 1, lb + 1)
    while True:
        b2, r2 = _bucket_ranks(k2, m2, _MIX2)
        n_ovf2 = int((r2 >= c).sum())
        if n_ovf2 <= STASH_CAP:
            break
        m2 += 1
    slots2 = _fill_plane(k2, l2, b2, r2, m2, c, lb, _MIX2)
    sk = np.full(STASH_CAP, EMPTY, dtype=np.uint64)
    sl = np.zeros(STASH_CAP, dtype=np.int32)
    if n_ovf2:
        sel = r2 >= c
        sk[:n_ovf2] = k2[sel]
        sl[:n_ovf2] = l2[sel]
    return DenseTable(
        slots1=slots1, slots2=slots2, stash_keys=sk, stash_labels=sl,
        m1=m1, m2=m2, lb=lb, slot_width=c,
    )


def dense_nbytes(n_keys: int, n_targets: int, c: int = 128,
                 load: float = 0.90) -> int:
    """Predicted dense-table HBM bytes WITHOUT building it (plane 1 exactly;
    plane 2 estimated from the binomial spill at `load` + pow2 rounding) —
    lets the residency policy decide dense-vs-cycle before paying a build."""
    n = max(n_keys, 1)
    lb = max(int(np.ceil(np.log2(n_targets + 2))), 2)
    m1 = max(int(np.ceil(np.log2(max(n / (load * c), 1.0)))), 1, lb + 1)
    # Poisson spill estimate: mean a = n / 2^m1 per bucket, sigma = sqrt(a);
    # E[(X - c)+] ~ sigma * (phi(z) - z * (1 - Phi(z))), z = (c - a) / sigma.
    # A 2x safety factor absorbs the approximation (plane 2 is tiny anyway).
    import math

    a = n / (1 << m1)
    sig = max(math.sqrt(a), 1.0)
    z = (c - a) / sig
    phi = math.exp(-z * z / 2) / math.sqrt(2 * math.pi)
    bigphi = 0.5 * (1 + math.erf(z / math.sqrt(2)))
    spill = max(sig * (phi - z * (1 - bigphi)) * (1 << m1) * 2, 1.0)
    m2 = max(int(np.ceil(np.log2(max(spill / (0.69 * c), 1.0)))), 1, lb + 1)
    return ((1 << m1) + (1 << m2)) * c * 8


def probe_dense(
    slots1, slots2, stash_keys, stash_labels, q, *,
    m1: int, m2: int, lb: int, c: int,
):
    """Device-side dense lookup: label+1 per query, 0 on miss."""
    import jax.numpy as jnp

    del c

    def one(qq):
        x1 = qq * jnp.uint64(_MIX1)
        b1 = (x1 >> jnp.uint64(64 - m1)).astype(jnp.int32)
        lab1 = _probe_rows(
            slots1, x1 & jnp.uint64((1 << (64 - m1)) - 1), b1, lb
        )
        x2 = qq * jnp.uint64(_MIX2)
        b2 = (x2 >> jnp.uint64(64 - m2)).astype(jnp.int32)
        lab2 = _probe_rows(
            slots2, x2 & jnp.uint64((1 << (64 - m2)) - 1), b2, lb
        )
        slab = _stash_lookup(stash_keys, stash_labels, qq)
        return jnp.maximum(jnp.maximum(lab1, lab2), slab)

    return _chunked_q(one, q)


_DENSE_CACHE_VERSION = 2  # v2: u32 contiguous-halves planes


def save_dense_cache(path: str, table: DenseTable,
                     signature: np.ndarray | None = None):
    """Atomic persist of a dense build (same contract as save_cache)."""
    import os
    import tempfile

    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                version=_DENSE_CACHE_VERSION,
                slots1=table.slots1,
                slots2=table.slots2,
                stash_keys=table.stash_keys,
                stash_labels=table.stash_labels,
                meta=np.array([table.m1, table.m2, table.lb,
                               table.slot_width]),
                signature=(
                    signature
                    if signature is not None
                    else np.zeros(3, dtype=np.int64)
                ),
            )
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load_dense_cache(path: str,
                     signature: np.ndarray | None = None) -> DenseTable | None:
    try:
        z = np.load(path)
        if int(z["version"]) != _DENSE_CACHE_VERSION:
            return None
        if signature is not None and not np.array_equal(
            np.asarray(z["signature"]), signature
        ):
            return None
        m1, m2, lb, c = (int(x) for x in z["meta"])
        return DenseTable(
            slots1=z["slots1"], slots2=z["slots2"],
            stash_keys=z["stash_keys"], stash_labels=z["stash_labels"],
            m1=m1, m2=m2, lb=lb, slot_width=c,
        )
    except Exception:  # corrupt/partial cache -> rebuild
        return None


def chunk_table(table: RadixTable, n_chunks: int):
    """Split row-wise into contiguous chunks for out-of-core cycling
    (the reference's DB parts/cycles scheme, CuClarkDB.cu:526-565): every
    key lives in exactly one chunk (the stash rides with chunk 0), so
    per-chunk hit counts add across cycles."""
    c = table.slot_width
    slots = table.slots
    r = (-slots.shape[0]) % n_chunks
    if r:
        slots = np.concatenate(
            [slots, np.full((r, 2 * c), EMPTY32, dtype=np.uint32)]
        )
    rows_per = slots.shape[0] // n_chunks
    empty_labels = np.zeros(0, dtype=np.uint32)  # labels ride in the slots
    return [
        dict(
            slots=slots[i * rows_per : (i + 1) * rows_per],
            labels=empty_labels,
            start_row=i * rows_per,
            use_stash=(i == 0),
        )
        for i in range(n_chunks)
    ]
