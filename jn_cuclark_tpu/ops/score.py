"""Per-read scoring: hit counts -> (sum, best, second-best) with exact
reference tie-breaking.

Replaces the reference's mergeKernel/resultKernel (CuClarkDB.cu:1261-1411).
The resultKernel scans sparse (target, count) pairs in ascending-target order
with strict '>' updates, which makes (best, second best) exactly the top-2
under the ordering (count desc, target index asc).  `indexBest` is the target
index + 1 so 0 means "NA" (CuClarkDB.cu:1390).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def counts_from_hits(labels1: jnp.ndarray, read_id: jnp.ndarray, n_reads: int, n_targets: int):
    """Dense per-read count matrix [n_reads, n_targets+1] from per-query
    (label+1) values (0 = miss, accumulated in ignored column 0).

    Strategy by size: when the bin count is small, sort the combined
    (read, label) ids and diff bin boundaries; otherwise a scatter-based
    segment_sum.  Integer counts are exact in any order, so both give the
    same matrix.  The crossover was tuned on earlier hardware; its cost on
    the H100 is not measured.
    """
    n_bins = n_reads * (n_targets + 1)
    ids = read_id * (n_targets + 1) + labels1
    if n_bins <= (1 << 20):
        s = jax.lax.sort(ids)
        pos = jnp.searchsorted(s, jnp.arange(n_bins + 1, dtype=ids.dtype))
        return (pos[1:] - pos[:-1]).reshape(n_reads, n_targets + 1)
    flat = jax.ops.segment_sum(
        jnp.ones_like(ids, dtype=jnp.int32),
        ids,
        num_segments=n_bins,
    )
    return flat.reshape(n_reads, n_targets + 1)


def top2_from_labels(lab: jnp.ndarray):
    """(total, index_best, best, index_sbest, s_best) straight from per-window
    (label+1) values [R, S] (0 = miss/padding), WITHOUT materializing the
    dense count matrix.

    Sort each read's labels along the window axis, then compute run lengths
    with cummax/cummin arithmetic — elementwise work, no gather/scatter.
    It is bit-identical to segment_sum+read_results,
    including the reference's tie-breaks (count desc, target index asc;
    resultKernel CuClarkDB.cu:1361-1411).  Used on the single-device
    non-extended path; extended mode and mesh psum still need dense counts.
    """
    return top2_from_sorted(jax.lax.sort(lab, dimension=1))


def top2_from_sorted(s: jnp.ndarray):
    """top2_from_labels on an already-sorted [R, S] label grid (extended
    mode reuses the sorted grid as its compressed per-target counts)."""
    R, S = s.shape
    j = jnp.arange(S, dtype=jnp.int32)[None, :]
    diff = s[:, 1:] != s[:, :-1]
    is_start = jnp.concatenate([jnp.ones((R, 1), bool), diff], axis=1)
    is_end = jnp.concatenate([diff, jnp.ones((R, 1), bool)], axis=1)
    startpos = jax.lax.cummax(jnp.where(is_start, j, -1), axis=1)
    endpos = jax.lax.cummin(jnp.where(is_end, j, S), axis=1, reverse=True)
    runlen = endpos - startpos + 1
    # score each run once (at its start); label 0 is miss/padding
    runlen = jnp.where(is_start & (s > 0), runlen, 0)

    total = jnp.sum((s > 0).astype(jnp.int32), axis=1)
    big = jnp.int32(2**31 - 1)
    best = jnp.max(runlen, axis=1)
    ibest1 = jnp.min(jnp.where(runlen == best[:, None], s, big), axis=1)
    ibest1 = jnp.where(best > 0, ibest1, 0)
    masked = jnp.where(s == ibest1[:, None], 0, runlen)
    sbest = jnp.max(masked, axis=1)
    isbest1 = jnp.min(
        jnp.where((masked == sbest[:, None]) & (masked > 0), s, big), axis=1
    )
    isbest1 = jnp.where(sbest > 0, isbest1, 0)
    return total, ibest1, best, isbest1, sbest


def read_results(counts: jnp.ndarray):
    """counts[:, 1:] -> (total, index_best, best, index_sbest, s_best).

    Exact reference semantics: ties on count resolve to the LOWEST target
    index; indexBest is 0 when no target was hit.
    """
    t = counts[:, 1:]  # [R, T]
    total = jnp.sum(t, axis=1)
    n_targets = t.shape[1]
    tidx = jnp.arange(n_targets, dtype=jnp.int32)

    best = jnp.max(t, axis=1)
    ibest = jnp.argmax(t, axis=1).astype(jnp.int32)  # argmax returns first max
    # second best: mask out the best element, take the next (count desc, idx asc)
    masked = jnp.where(tidx[None, :] == ibest[:, None], -1, t)
    sbest = jnp.max(masked, axis=1)
    isbest = jnp.argmax(masked, axis=1).astype(jnp.int32)
    sbest = jnp.maximum(sbest, 0)

    index_best = jnp.where(best > 0, ibest + 1, 0)
    index_sbest = jnp.where(sbest > 0, isbest + 1, 0)
    return total, index_best, best, index_sbest, sbest
