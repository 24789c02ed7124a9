"""On-disk database format: `.sz` / `.ky` / `.lb` triplet.

Byte-identical to the reference serialization (hashTable_hh.hh:473-546):

  * `<stem>.sz` — HTSIZE bytes; byte i = number of stored entries in bucket i
                  (must be <= 255, enforced like hashTable_hh.hh:499-507)
  * `<stem>.ky` — keys (quotients = canonical // HTSIZE), key_dtype each,
                  bucket-major, ascending within a bucket (sortall, :204-216)
  * `<stem>.lb` — uint16 labels, parallel to `.ky`

Loading supports the full-mode sampling factor `-s`: keep every s-th NONZERO
bucket, counting nonzero buckets from 1 (CuClarkDB.cu:502-513).
"""

from __future__ import annotations

import os

import numpy as np

from ..params import Profile


class DBFormatError(RuntimeError):
    pass


def write_db(
    stem: str,
    profile: Profile,
    k: int,
    canonical: np.ndarray,
    labels: np.ndarray,
) -> int:
    """Serialize (canonical k-mer, label) pairs. Returns number of elements.

    Entries may come in any order; they are laid out bucket-major sorted by
    quotient within each bucket, exactly as the reference's sorted chained
    table writes them.
    """
    canonical = np.asarray(canonical, dtype=np.uint64)
    labels = np.asarray(labels, dtype=np.uint16)
    if canonical.shape != labels.shape:
        raise ValueError("canonical/labels shape mismatch")
    htsize = np.uint64(profile.htsize)
    rem_bits = max(int(profile.htsize - 1).bit_length(), 1)
    key_dtype = profile.key_dtype(k)
    from ..utils import native

    if 2 * k + 1 <= 64 and native.available():
        # fused native path: quotient/remainder + parallel (key, label)
        # sort + sequential .sz emit in one call — ~2.5x the numpy chain
        # below at 250M keys, byte-identical output.  Large tables use the
        # remainder-partitioned variant so the stable sort's temp is one
        # partition instead of a full-table copy (bounded host memory).
        n = len(canonical)
        pbits = 0
        if n >= (1 << 24):
            pbits = min(
                int(np.ceil(np.log2(max(n / (1 << 23), 2)))), 8
            )
        try:
            if pbits > 0:
                sizes, ky, lb = native.serialize_db_parts(
                    canonical, labels, profile.htsize, rem_bits, key_dtype,
                    pbits,
                )
            else:
                sizes, ky, lb = native.serialize_db(
                    canonical, labels, profile.htsize, rem_bits, key_dtype
                )
        except native.BucketOverflowError:
            raise DBFormatError(
                "bucket list size exceeds 255; use a larger hash-table size"
            ) from None
        with open(stem + ".sz", "wb") as f:
            sizes.tofile(f)
        with open(stem + ".ky", "wb") as f:
            ky.tofile(f)
        with open(stem + ".lb", "wb") as f:
            lb.tofile(f)
        return int(canonical.shape[0])

    remainder = (canonical % htsize).astype(np.int64)
    quotient = canonical // htsize

    # single-key radix argsort on (remainder, quotient) packed into u64:
    # bits(remainder) + bits(quotient) <= 2k + 1 <= 63 for k <= 31
    if 2 * k + 1 <= 64:
        composite = (
            remainder.astype(np.uint64) << np.uint64(64 - rem_bits)
        ) | quotient
        if native.available():
            order = native.argsort_u64(composite)  # parallel stable sort
        else:
            order = np.argsort(composite, kind="stable")
    else:  # k == 32: quotient may not fit the packed key
        order = np.lexsort((quotient, remainder))
    remainder = remainder[order]
    quotient = quotient[order]
    labels = labels[order]

    # sparse bucket sizes: remainder is sorted, so run-length encode rather
    # than bincount over HTSIZE (1.6e9 buckets for the full profile)
    sizes = np.zeros(profile.htsize, dtype=np.uint8)
    if len(remainder):
        runs_mask = np.empty(len(remainder), dtype=bool)
        runs_mask[0] = True
        np.not_equal(remainder[1:], remainder[:-1], out=runs_mask[1:])
        runs = np.nonzero(runs_mask)[0]
        counts = np.empty(len(runs), dtype=np.int64)
        counts[:-1] = runs[1:] - runs[:-1]
        counts[-1] = len(remainder) - runs[-1]
        if counts.max(initial=0) > 255:
            raise DBFormatError(
                "bucket list size exceeds 255; use a larger hash-table size"
            )
        sizes[remainder[runs]] = counts.astype(np.uint8)

    with open(stem + ".sz", "wb") as f:
        sizes.tofile(f)
    with open(stem + ".ky", "wb") as f:
        quotient.astype(key_dtype).tofile(f)
    with open(stem + ".lb", "wb") as f:
        labels.tofile(f)
    return int(canonical.shape[0])


def db_exists(stem: str) -> bool:
    return all(os.path.exists(stem + ext) for ext in (".sz", ".ky", ".lb"))


def read_db(
    stem: str,
    profile: Profile,
    k: int,
    sampling_factor: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Load the DB back as (canonical uint64, labels uint16), file order.

    With sampling_factor > 1, only every s-th nonzero bucket is kept
    (CuClarkDB.cu:502-513: nonzero buckets counted from 1; bucket kept when
    count % s == 0).
    """
    sizes = np.fromfile(stem + ".sz", dtype=np.uint8)
    if sizes.size != profile.htsize:
        raise DBFormatError(
            f"{stem}.sz has {sizes.size} buckets, profile expects {profile.htsize}"
        )
    key_dtype = profile.key_dtype(k)
    quotient = np.fromfile(stem + ".ky", dtype=key_dtype)
    labels = np.fromfile(stem + ".lb", dtype=np.uint16)
    if quotient.size != labels.size:
        raise DBFormatError(f"{stem}: .ky/.lb element count mismatch")
    if int(sizes.sum(dtype=np.int64)) != quotient.size:
        raise DBFormatError(f"{stem}: .sz total does not match .ky size")

    nz = np.nonzero(sizes)[0]
    if sampling_factor > 1:
        ordinal = np.arange(1, nz.size + 1)
        keep_nz = nz[ordinal % sampling_factor == 0]
        keep_mask = np.zeros(profile.htsize, dtype=bool)
        keep_mask[keep_nz] = True
        elem_keep = np.repeat(keep_mask[nz], sizes[nz])
        quotient = quotient[elem_keep]
        labels = labels[elem_keep]
        nz = keep_nz
    remainders = np.repeat(nz.astype(np.uint64), sizes[nz])
    canonical = quotient.astype(np.uint64) * np.uint64(profile.htsize) + remainders
    return canonical, labels
