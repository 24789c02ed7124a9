"""Fused device classification pipeline (plain JAX, gather-minimal).

windows-from-packed-words -> Jellyfish canonicalization -> radix-table probe
-> per-read counts -> top-2 results.  Everything except the probe's row
gather is elementwise work on [R, S] grids; window values are reconstructed with
`repeat` + shifts (no gathers), reproducing exactly the k-mer set the
reference counts (all length-k windows of valid chars within a read,
CuClarkDB.cu:1042-1117).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import radix_table, score


def window_canonicals(words, vwords, k: int, probe_cols: int | None = None):
    """[R, W] canonical window values + validity from packed rows.

    words:  [R, S/32 + 1] uint64 (2-bit codes, first char lowest bits)
    vwords: [R, S/64 + 1] uint64 (validity bits, first char lowest bit)

    W = min(probe_cols, S-k+1).  Only the first S-k+1 columns can ever be
    valid (a window starting in the last k-1 positions runs off the row),
    and the CALLER may trim further with `probe_cols` when it knows the
    batch's true maximum read length: stride quantization pads reads to
    the tier (e.g. 150 bp at stride 192 -> 162 probed slots but only 120
    can be valid), and probing always-invalid pad columns is pure waste.
    The k-mer set is unchanged — trimmed
    columns fail the validity mask by construction.
    """
    R, Wp1 = words.shape
    W = Wp1 - 1
    S = W * 32

    w0 = jnp.repeat(words[:, :W], 32, axis=1)  # word containing char p
    w1 = jnp.repeat(words[:, 1:], 32, axis=1)  # next word
    off = (jnp.arange(S, dtype=jnp.uint64) & jnp.uint64(31)) * jnp.uint64(2)
    off = off[None, :]
    lo = w0 >> off
    hi = jnp.where(off == 0, jnp.uint64(0), w1 << (jnp.uint64(64) - off))
    val = lo | hi
    if k < 32:
        val = val & jnp.uint64((1 << (2 * k)) - 1)

    Wv = vwords.shape[1] - 1
    v0 = jnp.repeat(vwords[:, :Wv], 64, axis=1)
    v1 = jnp.repeat(vwords[:, 1:], 64, axis=1)
    voff = (jnp.arange(S, dtype=jnp.uint64) & jnp.uint64(63))[None, :]
    vbits = (v0 >> voff) | jnp.where(
        voff == 0, jnp.uint64(0), v1 << (jnp.uint64(64) - voff)
    )
    kmask = jnp.uint64((1 << k) - 1)
    valid = (vbits & kmask) == kmask

    canon = jnp.minimum(val, _revcomp(val, k))
    w = max(S - (k - 1), 1)
    if probe_cols is not None:
        w = max(min(w, probe_cols), 1)
    return canon[:, :w], valid[:, :w]


def _revcomp(v, k: int):
    """Jellyfish bit-twiddle on uint64 (kmersConversion.cc:39-47)."""
    x = v
    x = ((x >> jnp.uint64(2)) & jnp.uint64(0x3333333333333333)) | (
        (x & jnp.uint64(0x3333333333333333)) << jnp.uint64(2)
    )
    x = ((x >> jnp.uint64(4)) & jnp.uint64(0x0F0F0F0F0F0F0F0F)) | (
        (x & jnp.uint64(0x0F0F0F0F0F0F0F0F)) << jnp.uint64(4)
    )
    x = ((x >> jnp.uint64(8)) & jnp.uint64(0x00FF00FF00FF00FF)) | (
        (x & jnp.uint64(0x00FF00FF00FF00FF)) << jnp.uint64(8)
    )
    x = ((x >> jnp.uint64(16)) & jnp.uint64(0x0000FFFF0000FFFF)) | (
        (x & jnp.uint64(0x0000FFFF0000FFFF)) << jnp.uint64(16)
    )
    x = (x >> jnp.uint64(32)) | (x << jnp.uint64(32))
    return (jnp.uint64(0xFFFFFFFFFFFFFFFF) - x) >> jnp.uint64(64 - 2 * k)


@functools.partial(
    jax.jit, static_argnames=("k", "m1", "lb", "c", "n_targets", "probe_cols")
)
def classify_batch_counts_chunk(
    slots_blk, labels_blk, stash_keys, stash_labels, words, vwords,
    start_row, use_stash, *, k, m1, lb, c, n_targets, probe_cols=None,
):
    """Out-of-core cycle step: per-read counts against ONE table chunk.
    Counts from disjoint chunks add (host accumulates across cycles),
    mirroring the reference's swapDbParts + host-row merge
    (CuClarkDB.cu:776-815, 931-948)."""
    canon, valid = window_canonicals(words, vwords, k, probe_cols)
    q = jnp.where(valid, canon, radix_table.EMPTY).ravel()
    lab = radix_table.probe_chunk(
        slots_blk, labels_blk, stash_keys, stash_labels, q, start_row,
        m1=m1, lb=lb, c=c, use_stash=use_stash,
    )
    lab = jnp.where(valid.ravel(), lab, 0)
    R, S = valid.shape
    rid = jnp.repeat(jnp.arange(R, dtype=jnp.int32), S)
    return score.counts_from_hits(lab, rid, R, n_targets)


@functools.partial(
    jax.jit, static_argnames=("k", "m1", "lb", "c", "narrow", "probe_cols")
)
def classify_batch_labels_chunk(
    slots_blk, labels_blk, stash_keys, stash_labels, words, vwords,
    start_row, use_stash, *, k, m1, lb, c, narrow, probe_cols=None,
):
    """Out-of-core cycle step returning per-WINDOW matched labels [R, S]
    (label+1, 0 = miss) instead of dense per-read counts.

    Table chunks cover disjoint key ranges, so each window matches in at
    most one cycle: the per-cycle label grids simply CONCATENATE along the
    window axis, and the final top-2 runs once over [R, cycles*S] with
    single-pass semantics.  O(windows) per batch instead of O(targets) —
    dense count accumulation at RefSeq scale (10k+ targets) would need
    ~4*T bytes/read/batch on the host, this needs 2-4*S.  `narrow` packs
    labels into uint16 (valid while n_targets < 65535)."""
    canon, valid = window_canonicals(words, vwords, k, probe_cols)
    q = jnp.where(valid, canon, radix_table.EMPTY).ravel()
    lab = radix_table.probe_chunk(
        slots_blk, labels_blk, stash_keys, stash_labels, q, start_row,
        m1=m1, lb=lb, c=c, use_stash=use_stash,
    )
    lab = jnp.where(valid.ravel(), lab, 0).reshape(valid.shape)
    return lab.astype(jnp.uint16) if narrow else lab


@functools.partial(jax.jit, static_argnames=("n_targets", "extended"))
def score_from_labels(lab, *, n_targets, extended):
    """Final scoring over concatenated per-window labels [R, S_total]:
    (total, ibest, best, sbest, counts) with exactly classify_batch's
    semantics.

    extended modes: False -> sort-runs top-2, counts placeholder [R, 0];
    True -> dense [R, T+1] count matrix (segment-sum; needed where counts
    must psum/accumulate); "sorted" -> the SORTED label grid itself as u16
    [R, S] (top-2 reuses the same sort; the native formatter expands run
    lengths to per-target CSV columns) — O(windows) on device regardless of
    target count, instead of the dense segment-sum and a per-batch count
    fetch of 4*(T+1) bytes per read."""
    lab = lab.astype(jnp.int32)
    R, S = lab.shape
    if not extended:
        total, ib, b, isb, sb = score.top2_from_labels(lab)
        return total, ib, b, sb, jnp.zeros((R, 0), jnp.int32)
    if extended == "sorted":
        s = jax.lax.sort(lab, dimension=1)
        total, ib, b, isb, sb = score.top2_from_sorted(s)
        return total, ib, b, sb, s.astype(jnp.uint16)
    rid = jnp.repeat(jnp.arange(R, dtype=jnp.int32), S)
    counts = score.counts_from_hits(lab.ravel(), rid, R, n_targets)
    total, ib, b, isb, sb = score.read_results(counts)
    return total, ib, b, sb, counts


@functools.partial(
    jax.jit,
    static_argnames=("k", "m1", "m2", "lb", "c", "n_targets", "extended",
                     "probe_cols"),
)
def classify_batch_dense(
    slots1, slots2, stash_keys, stash_labels, words, vwords,
    *, k, m1, m2, lb, c, n_targets, extended=True, probe_cols=None,
):
    """classify_batch against the two-choice DENSE table (radix_table
    block comment): identical semantics, two row gathers per probe (the
    second against the tiny overflow plane).  Used when the standard
    table exceeds the device budget but the dense one fits resident —
    the reference would start cycling here (CuClarkDB.cu:526-565)."""
    canon, valid = window_canonicals(words, vwords, k, probe_cols)
    q = jnp.where(valid, canon, radix_table.EMPTY).ravel()
    lab = radix_table.probe_dense(
        slots1, slots2, stash_keys, stash_labels, q,
        m1=m1, m2=m2, lb=lb, c=c,
    )
    lab = jnp.where(valid.ravel(), lab, 0).reshape(valid.shape)
    return score_from_labels(lab, n_targets=n_targets, extended=extended)


@functools.partial(
    jax.jit,
    static_argnames=("k", "m1", "lb", "c", "n_targets", "extended",
                     "probe_cols"),
)
def classify_batch(
    slots, labels, stash_keys, stash_labels, words, vwords,
    *, k, m1, lb, c, n_targets, extended=True, probe_cols=None,
):
    """Full single-device batch step; returns (total, ibest, best, sbest,
    counts[R, T+1]).

    extended=False skips the dense count matrix (needed only for --extended
    CSV columns) and takes the sort-runs top-2 path (score.top2_from_labels,
    bit-identical results); counts comes back as
    a [R, 0] placeholder.  probe_cols trims always-invalid pad columns
    before the probe (see window_canonicals)."""
    canon, valid = window_canonicals(words, vwords, k, probe_cols)
    q = jnp.where(valid, canon, radix_table.EMPTY).ravel()
    lab = radix_table.probe(
        slots, labels, stash_keys, stash_labels, q, m1=m1, lb=lb, c=c
    )
    lab = jnp.where(valid.ravel(), lab, 0).reshape(valid.shape)
    return score_from_labels(lab, n_targets=n_targets, extended=extended)
