"""Database construction: target genomes -> discriminative canonical k-mer DB.

Vectorized re-implementation of the reference build pipeline
(CuCLARK_hh.hh:691-1329 makeSpecificTargetSets + HashTableStorage_hh.hh):
instead of inserting k-mers one at a time into a chained hash table, all
occurrences are extracted as flat arrays and aggregated with a sort/group-by.
The multiplicity bookkeeping reproduces the reference's update rule exactly
(HashTableStorage_hh.hh:422-461, hashTable_hh.hh:398-410):

  * first occurrence of a canonical k-mer stores its label L0, multiplicity 1
  * each later occurrence with label X adds
        (X != L0) + (prefix(X) != prefix(L0))
    to the multiplicity, where prefix(L) = L without its last char and
    prefixes only compare equal for equal-length labels ("centromere" pairing)
  * counts accumulate; the default (non --tsk) builds use the 8-bit saturating
    lElement counter capped at 254 (dataType.hh:333-334)

RemoveCommon (HashTableStorage_hh.hh:230-280): keep multiplicity==1 entries
with count > minT; when centromere labels exist, also keep multiplicity==2
entries (relabeled to the matching centromere label when one exists).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..io import dbformat
from ..io.fasta import parse_reads, window_starts
from ..io.targets import TargetsDef
from ..kmer import canonical_u64, encode_seq, enc_le, window_values_le
from ..params import Profile


@dataclasses.dataclass
class Occurrences:
    """All k-mer occurrences of one target file, in stream order."""

    canonical: np.ndarray  # uint64
    counts: np.ndarray | None = None  # None => all 1 (sequence input)


def extract_occurrences(
    data: bytes, k: int, light: bool, gap: int
) -> Occurrences:
    """K-mer occurrence stream of one FASTA/FASTQ target file.

    Normal mode: every overlapping valid window.  Light mode: non-overlapping
    windows (the scanner resets after each completed k-mer), with a per-file
    counter selecting every gap-th completed k-mer (CuCLARK_hh.hh:722-729).
    """
    rs = parse_reads(data)
    if not light:
        starts, _ = window_starts(rs, k)
        vals = window_values_le(np.where(rs.codes >= 0, rs.codes, 0).astype(np.int8), k, starts)
        return Occurrences(canonical=canonical_u64(vals, k))

    # Light: within each maximal valid run (runs break at invalid chars and
    # record boundaries), k-mers complete at offsets k-1, 2k-1, ... ; a global
    # per-file counter over completed k-mers picks every gap-th one.
    codes = rs.codes
    valid = codes >= 0
    # run breaks at read boundaries: mark boundary positions as breaks
    run_break = ~valid.copy()
    # read starts begin new runs
    boundary = np.zeros(len(codes) + 1, dtype=bool)
    boundary[rs.read_offsets[1:-1]] = True
    # run ids: increment at each invalid char or read start
    is_start = np.zeros(len(codes), dtype=bool)
    if len(codes):
        is_start[0] = True
        is_start[1:] = run_break[:-1] | boundary[1 : len(codes)]
    run_id = np.cumsum(is_start) - 1
    run_id = np.where(valid, run_id, -1)
    vpos = np.nonzero(valid)[0]
    if len(vpos) == 0:
        return Occurrences(canonical=np.zeros(0, dtype=np.uint64))
    vruns = run_id[vpos]
    # per-run lengths and start offsets in the valid-position stream
    uruns, run_start_idx, run_lens = np.unique(
        vruns, return_index=True, return_counts=True
    )
    nk_per_run = run_lens // k
    total_kmers = int(nk_per_run.sum())
    if total_kmers == 0:
        return Occurrences(canonical=np.zeros(0, dtype=np.uint64))
    # j-th completed kmer of a run occupies valid-stream slots
    # [run_start + j*k, run_start + (j+1)*k)
    from ..io.fasta import _ranges_concat

    kmer_run = np.repeat(np.arange(len(uruns)), nk_per_run)
    j_in_run = _ranges_concat(nk_per_run)
    vstart = run_start_idx[kmer_run] + j_in_run * k
    # completed k-mers in file order == order of their last nucleotide ==
    # vstart order (runs are in file order)
    sel = (np.arange(total_kmers) % gap) == 0
    vstart = vstart[sel]
    # gather codes of each window from the valid stream
    win = vpos[vstart[:, None] + np.arange(k)[None, :]]
    wcodes = codes[win].astype(np.uint64)
    shifts = (np.arange(k, dtype=np.uint64) * np.uint64(2))
    vals = (wcodes << shifts[None, :]).sum(axis=1, dtype=np.uint64)
    return Occurrences(canonical=canonical_u64(vals, k))


def extract_spectrum(
    text: bytes, k: int, light: bool, gap: int, min_count_target: int
) -> Occurrences:
    """Spectrum-form target file: lines of "<kmer-string> <count>"
    (CuCLARK_hh.hh:861-877, 1298-1308)."""
    canon = []
    counts = []
    counter = 0
    for line in text.split(b"\n"):
        parts = line.split()
        if len(parts) < 2:
            continue
        s, val = parts[0].decode(), int(parts[1])
        if light:
            # bug-compatible counter reset (CuCLARK_hh.hh:866-875)
            if counter % gap == 0 and val > min_count_target:
                canon.append(_canon_of_string(s))
                counts.append(val)
                counter = 0
            counter += 1
        else:
            if val > min_count_target:
                canon.append(_canon_of_string(s))
                counts.append(val)
    return Occurrences(
        canonical=np.array(canon, dtype=np.uint64),
        counts=np.array(counts, dtype=np.int64),
    )


def _canon_of_string(s: str) -> int:
    codes = encode_seq(s)
    if (codes < 0).any():
        raise ValueError(f"invalid k-mer {s!r}")
    return int(canonical_u64(np.uint64(enc_le(codes)), len(codes)))


@dataclasses.dataclass
class BuiltDB:
    canonical: np.ndarray  # uint64, specific k-mers (marked entries)
    labels: np.ndarray  # uint16
    n_mother: int  # size of the mother table (distinct canonical k-mers)


def aggregate(
    occ_canon: np.ndarray,
    occ_label: np.ndarray,
    occ_count: np.ndarray,
    targets: TargetsDef,
    min_count_target: int,
    lelement: bool,
):
    """Group occurrences by canonical k-mer and apply the reference's
    multiplicity/count rules.  Returns per-distinct-kmer arrays:
    (canon, L0, mult, count, first_seqno)."""
    n = len(occ_canon)
    order = np.argsort(occ_canon, kind="stable")
    c = occ_canon[order]
    l = occ_label[order]
    v = occ_count[order]

    grp_start = np.empty(n, dtype=bool)
    if n:
        grp_start[0] = True
        np.not_equal(c[1:], c[:-1], out=grp_start[1:])
    first_idx = np.nonzero(grp_start)[0]
    ngroups = len(first_idx)
    L0 = l[first_idx]

    # prefix-group id per combined label index
    all_labels = targets.labels + targets.labels_c
    pgid_map: dict[tuple[int, str], int] = {}
    pg = np.zeros(len(all_labels), dtype=np.int64)
    for i, lbl in enumerate(all_labels):
        key = (len(lbl), lbl[:-1])
        pg[i] = pgid_map.setdefault(key, len(pgid_map))

    # gid values are sorted (groups are contiguous runs), so group reductions
    # are reduceat over run starts — much cheaper than weighted bincounts
    L0_of = np.repeat(L0, np.diff(np.append(first_idx, n)))
    d = (l != L0_of).astype(np.int32) + (pg[l] != pg[L0_of]).astype(np.int32)
    d[first_idx] = 0
    mult = 1 + (np.add.reduceat(d, first_idx) if n else np.zeros(0, np.int32))
    mult = np.minimum(mult, 255)

    gsize = np.diff(np.append(first_idx, n))
    if lelement:
        if np.all(v == 1):
            count = np.minimum(gsize, 254)
        else:
            count = _saturating_group_sum(np.append(first_idx, n), v)
    else:
        count = np.add.reduceat(v, first_idx) if n else np.zeros(0, np.int64)

    return c[first_idx], L0, mult, count, order[first_idx]


def _saturating_group_sum(bounds: np.ndarray, v: np.ndarray) -> np.ndarray:
    """lElement.AddToCount (dataType.hh:333-334): each occurrence's count is
    added only while the 8-bit counter stays < 255.  Order-dependent within a
    group, so it cannot be a plain reduction; native C++ when available,
    otherwise only the (rare) groups whose unsaturated total reaches 255 take
    the sequential path."""
    from ..utils import native

    ngroups = len(bounds) - 1
    if ngroups <= 0:
        return np.zeros(0, np.int64)
    if native.available():
        return native.saturating_group_sum(bounds, v)
    first_idx = bounds[:-1]
    out = np.add.reduceat(v, first_idx).astype(np.int64)
    for g in np.nonzero(out >= 255)[0]:
        s = 0
        for val in v[bounds[g] : bounds[g + 1]]:
            if s + val < 255:
                s += val
        out[g] = s
    return out


def remove_common(
    canon, L0, mult, count, targets: TargetsDef, min_count_target: int
):
    """Select and relabel specific k-mers (HashTableStorage_hh.hh:230-280)."""
    keep1 = (mult == 1) & (count > min_count_target)
    labels = L0.copy()
    if targets.labels_c:
        keep2 = (mult == 2) & (count > min_count_target)
        # relabel to the first centromere label with matching prefix
        lidx = targets.label_index
        relabel = {}
        for i, lbl in enumerate(targets.labels + targets.labels_c):
            for lc in targets.labels_c:
                if len(lc) == len(lbl) and lc[: len(lbl) - 1] == lbl[:-1]:
                    relabel[i] = lidx[lc]
                    break
        if relabel:
            src = np.array(list(relabel.keys()))
            dst = np.array(list(relabel.values()))
            lut = np.arange(len(targets.labels) + len(targets.labels_c))
            lut[src] = dst
            labels = np.where(keep2, lut[L0], labels)
        keep = keep1 | keep2
    else:
        keep = keep1
    return canon[keep], labels[keep].astype(np.uint16)


_HT_DIGITS = "TGCA"  # IndexTovector digit alphabet (kmersConversion.cc:88-131)


def ht_kmer_string(canon: int, k: int) -> str:
    """The k-mer string the reference writes in .ht files: the canonical value
    read as big-endian base-4 with digits T,G,C,A (== revcomp of the
    canonical-form sequence)."""
    out = []
    for j in range(k - 1, -1, -1):
        out.append(_HT_DIGITS[(int(canon) >> (2 * j)) & 3])
    return "".join(out)


def build_database(
    targets: TargetsDef,
    folder: str,
    profile: Profile,
    k: int,
    min_count_target: int = 0,
    gap: int | None = None,
    tsk: bool = False,
    device: bool = False,
) -> BuiltDB:
    """Build and serialize the central DB (and optional per-target .ht files).

    `folder` is the database directory (the reference's -D).
    """
    gap = profile.default_gap if gap is None else gap
    from ..params import MTRGTS

    if targets.n_targets > MTRGTS:
        # labels are u16 on disk and in the native aggregate payload
        # (dataType.hh:46); past the cap they would silently truncate
        raise ValueError(
            f"{targets.n_targets} targets exceed the format's maximum of "
            f"{MTRGTS} (labels are 16-bit, dataType.hh:46); merge targets "
            "or split the database"
        )
    from ..utils import native

    use_native = native.available()
    lidx = targets.label_index
    occ_c: list[np.ndarray] = []
    occ_v: list[np.ndarray] = []
    file_lids: list[int] = []
    all_unit_counts = True
    for path, lbl in zip(targets.files, targets.file_labels):
        with open(path, "rb") as f:
            data = f.read()
        if data[:1] in (b">", b"@"):
            if use_native:
                occ = Occurrences(
                    canonical=native.extract_canonical(data, k, profile.light, gap)
                )
            else:
                occ = extract_occurrences(data, k, profile.light, gap)
        else:
            occ = extract_spectrum(data, k, profile.light, gap, min_count_target)
        occ_c.append(occ.canonical)
        file_lids.append(lidx[lbl])
        occ_v.append(occ.counts)  # None => unit counts
        all_unit_counts = all_unit_counts and occ.counts is None
    # the reference's light build never writes .ht files regardless of --tsk
    # (makeSpecificTargetSets light branch has no Save* calls)
    tsk = tsk and not profile.light
    lelement = not tsk  # --tsk builds use the 32-bit Element counter

    total_occ = sum(len(c) for c in occ_c)
    part_min = int(os.environ.get("CLARK_TPU_BUILD_PART_MIN", str(1 << 25)))
    if (
        use_native
        and all_unit_counts
        and not tsk
        and total_occ >= part_min
    ):
        # bounded-memory partitioned build (reference parity: the chained
        # hash table also builds in bounded memory, hashTable_hh.hh:239-269):
        # occurrences scatter into ONE 16-byte-per-entry buffer bucketed by
        # canonical range; each partition sorts/aggregates/filters
        # independently, so sort temps and n-sized temporaries never
        # coexist at full scale.  Output identical to the one-shot path.
        spec_c, spec_l, n_mother = _build_partitioned(
            occ_c, file_lids, targets, k, min_count_target, lelement,
            device=device,
        )
        stem = os.path.join(
            folder, profile.db_stem(k, targets.n_targets, min_count_target, gap)
        )
        dbformat.write_db(stem, profile, k, spec_c, spec_l)
        return BuiltDB(canonical=spec_c, labels=spec_l, n_mother=n_mother)

    canon_all = np.concatenate(occ_c) if occ_c else np.zeros(0, np.uint64)
    # one int32 repeat instead of per-file full() arrays + a concat (+ an
    # int64->int32 convert in the native wrapper): ~10x less label traffic
    # on multi-100M-occurrence builds
    lbl_all = np.repeat(
        np.asarray(file_lids, np.int32),
        np.asarray([len(c) for c in occ_c], np.int64),
    ) if occ_c else np.zeros(0, np.int32)
    if (use_native or device) and all_unit_counts and not tsk:
        all_labels = targets.labels + targets.labels_c
        pgid_map: dict[tuple[int, str], int] = {}
        pg = np.zeros(max(len(all_labels), 1), dtype=np.int32)
        for i, lbl in enumerate(all_labels):
            pg[i] = pgid_map.setdefault((len(lbl), lbl[:-1]), len(pgid_map))
        if device:
            from .device_build import aggregate_device

            agg = aggregate_device(canon_all, lbl_all, pg, lelement)
        else:
            agg = native.aggregate_occurrences(
                canon_all, lbl_all, pg, lelement
            )
        canon, L0, mult, count, first_seq = agg
    else:
        cnt_all = np.concatenate(
            [
                v if v is not None else np.ones(len(c), dtype=np.int64)
                for v, c in zip(occ_v, occ_c)
            ]
        ) if occ_v else np.zeros(0, np.int64)
        canon, L0, mult, count, first_seq = aggregate(
            canon_all, lbl_all, cnt_all, targets, min_count_target, lelement
        )

    if tsk:
        _write_tsk_files(
            folder, profile, k, targets, canon, L0, mult, count, first_seq,
            min_count_target,
        )

    spec_c, spec_l = remove_common(canon, L0, mult, count, targets, min_count_target)
    stem = os.path.join(
        folder, profile.db_stem(k, targets.n_targets, min_count_target, gap)
    )
    dbformat.write_db(stem, profile, k, spec_c, spec_l)
    return BuiltDB(canonical=spec_c, labels=spec_l, n_mother=len(canon))


def _build_partitioned(
    occ_c, file_lids, targets, k, min_count, lelement, device=False
):
    """Bounded-memory aggregate + discriminativity filter over canonical-
    range partitions (global output order — canonical ascending — is
    preserved because partitions are contiguous canonical ranges).

    Frees each file's occurrence array right after its scatter; peak host
    memory is the 16-byte-per-occurrence KV buffer plus one partition's
    sort temp, instead of the one-shot path's full-size kv + parallel-sort
    temp + five n-sized output arrays.

    device=True aggregates each partition on the accelerator
    (device_build.aggregate_device) with partitions padded to a shape
    ladder so jit executables are reused — bounded DEVICE memory too,
    which is what the one-shot device path lacks at RefSeq scale."""
    from ..utils import native

    all_labels = targets.labels + targets.labels_c
    pgid_map: dict[tuple[int, str], int] = {}
    pg = np.zeros(max(len(all_labels), 1), dtype=np.int32)
    for i, lbl in enumerate(all_labels):
        pg[i] = pgid_map.setdefault((len(lbl), lbl[:-1]), len(pgid_map))
    total = sum(len(c) for c in occ_c)
    # ~16M-entry (256 MB) average partitions, capped at 512 partitions
    pbits = int(np.ceil(np.log2(max(total / (1 << 24), 2))))
    key_bits = 2 * k if k < 32 else 64
    pbits = max(min(pbits, 9, key_bits - 1), 1)
    shift = key_bits - pbits
    P = 1 << pbits
    counts = np.zeros(P, np.int64)
    for c in occ_c:
        native.occ_partition_count(c, shift, counts)
    offs = np.zeros(P + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    kv = np.empty(total, native.KV_DTYPE)
    cursors = offs[:-1].copy()
    base = 0
    for i in range(len(occ_c)):
        c = occ_c[i]
        native.occ_partition_scatter(
            c, int(file_lids[i]), base, shift, cursors, kv
        )
        base += len(c)
        occ_c[i] = None  # free each file's occurrences after scatter
    spec_c_parts: list[np.ndarray] = []
    spec_l_parts: list[np.ndarray] = []
    n_mother = 0
    use_device = bool(device) and k <= 31  # pad sentinel needs 2^64-1 free
    for p in range(P):
        n_p = int(counts[p])
        if n_p == 0:
            continue
        if use_device:
            agg = _aggregate_partition_device(
                kv, int(offs[p]), n_p, pg, lelement
            )
        else:
            agg = native.aggregate_kv_range(
                kv, int(offs[p]), n_p, pg, lelement
            )
        cp, l0p, mp, ctp = agg[:4]
        n_mother += len(cp)
        sc, sl = remove_common(cp, l0p, mp, ctp, targets, min_count)
        spec_c_parts.append(sc)
        spec_l_parts.append(sl)
    del kv
    if not spec_c_parts:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint16), n_mother
    return (
        np.concatenate(spec_c_parts),
        np.concatenate(spec_l_parts),
        n_mother,
    )


_PAD_CANON = np.uint64(0xFFFFFFFFFFFFFFFF)


def _aggregate_partition_device(kv, off, n, pg, lelement):
    """One partition's aggregation on the accelerator, padded to a pow2
    shape ladder (>= 2^20 entries) so the jitted sort/segment executables
    are reused across partitions.  Pad entries use canonical 2^64-1
    (not a real k-mer for k <= 31, caller-gated) and sort to one trailing
    group that is sliced off.  first_seq is partition-local (unused by
    this path's callers: --tsk builds never come here)."""
    from .device_build import aggregate_device

    part = kv[off : off + n]
    canon = np.ascontiguousarray(part["k"])
    label = (part["v"] & 0xFFFF).astype(np.int32)
    pad = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 20)
    padded = pad > n
    if padded:
        canon = np.concatenate(
            [canon, np.full(pad - n, _PAD_CANON, np.uint64)]
        )
        label = np.concatenate([label, np.zeros(pad - n, np.int32)])
    out = aggregate_device(canon, label, pg, lelement)
    if padded:
        # the pad sentinel is the max canonical: exactly one trailing group
        out = tuple(a[:-1] for a in out)
    return out


def _write_tsk_files(
    folder, profile, k, targets, canon, L0, mult, count, first_seq, min_count
):
    """Per-target .ht text files (SaveMultiple / SaveIntersectionMultiple,
    HashTableStorage_hh.hh:283-393).  Line order matches the reference's
    pre-sort hashtable iterator: bucket-major, insertion (first-occurrence)
    order within a bucket."""
    remainder = canon % np.uint64(profile.htsize)
    order = np.lexsort((first_seq, remainder))

    # SaveIntersectionMultiple first (m==2, prefix-matched centromere file)
    handles_c = {}
    for lc in targets.labels_c:
        fname = os.path.join(folder, f"{lc}_k{k}.ht")
        f = open(fname, "w")
        f.write(f"#K-mers specific to chromosome-centromere {lc[:-1]}\n")
        f.write(f"#IKMER ICOUNT {k}-MER\n#\n")
        handles_c[lc] = f
    all_labels = targets.labels + targets.labels_c
    if handles_c:
        for i in order:
            if mult[i] != 2:
                continue
            lbl = all_labels[L0[i]]
            for lc in targets.labels_c:
                if len(lc) == len(lbl) and lc[:-1] == lbl[:-1]:
                    handles_c[lc].write(
                        f"{int(canon[i])}\t{int(count[i])}\t{ht_kmer_string(canon[i], k)}\n"
                    )
                    break
    for f in handles_c.values():
        f.close()

    # SaveMultiple (m==1 entries into their label's file)
    handles = {}
    for lbl in targets.labels:
        fname = os.path.join(folder, f"{lbl}_k{k}.ht")
        f = open(fname, "w")
        f.write(
            f"#Target specific k-mers labeled {lbl} and appearing strictly "
            f"more than {min_count} times.\n"
        )
        f.write(f"#IKMER ICOUNT {k}-MER \n#\n")
        handles[lbl] = f
    lbl_set = set(targets.labels)
    for i in order:
        if mult[i] != 1:
            continue
        lbl = all_labels[L0[i]]
        if lbl in lbl_set:
            handles[lbl].write(
                f"{int(canon[i])}\t{int(count[i])}\t{ht_kmer_string(canon[i], k)}\n"
            )
    for f in handles.values():
        f.close()
