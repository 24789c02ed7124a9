"""ctypes bindings for the native C++ runtime (native/clark_native.cpp).

The library is compiled from the committed source at first use into
native/build/ (gitignored), keyed on a hash of the source, the compiler
line and the host CPU, so a stale build is never loaded.  Every entry
point has a pure-numpy fallback in the package, used only where no C++
compiler exists; callers check `available()` first.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import numpy as np

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U16P = ctypes.POINTER(ctypes.c_uint16)

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
SOURCE = os.path.join(NATIVE_DIR, "clark_native.cpp")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall", "-shared")

_lib = None
_tried = False


def _host_cpu() -> bytes:
    """The CPU model and instruction-set flags `-march=native` compiles
    for, so a build directory copied to another host is rebuilt there."""
    with open("/proc/cpuinfo", "rb") as f:
        info = f.read().split(b"\n\n")[0]
    return b"\n".join(ln for ln in info.splitlines()
                      if ln.startswith((b"model name", b"flags")))


def find_cxx() -> str | None:
    """The C++ compiler to build with: the first of $CXX and the g++
    executables on PATH whose toolchain ships OpenMP (`-print-file-name`
    finds its libgomp.spec; some installed GCCs lack it and cannot link
    -fopenmp), else the first of them at all, whose build then raises
    with its error.  None when there is none."""
    cands = [os.environ["CXX"]] if os.environ.get("CXX") else []
    for d in os.environ.get("PATH", "").split(os.pathsep):
        exe = os.path.join(d, "g++")
        if os.path.isfile(exe) and os.access(exe, os.X_OK):
            cands.append(exe)
    for exe in cands:
        if shutil.which(exe) is None:
            continue
        spec = subprocess.run([exe, "-print-file-name=libgomp.spec"],
                              capture_output=True, text=True).stdout.strip()
        if os.path.isabs(spec) and os.path.exists(spec):
            return exe
    return cands[0] if cands else None


def library_path(cxx: str = "g++") -> str:
    """Where the build of the current source with `cxx` for this CPU
    lives."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join((cxx,) + CXXFLAGS).encode())
    h.update(_host_cpu())
    return os.path.join(BUILD_DIR, f"libclark_native-{h.hexdigest()[:16]}.so")


def build(cxx: str | None = None) -> str | None:
    """Compile the library if this source has no build yet; returns its
    path, or None when no C++ compiler is installed.  A compiler that
    cannot build it raises with its error: set CXX to one that can.

    Concurrent callers (test workers, cluster processes) serialize on a
    lock file; the compiler writes a temporary name that is renamed into
    place, so no process ever loads a half-written library."""
    cxx = cxx or find_cxx()
    if cxx is None or shutil.which(cxx) is None:
        return None
    path = library_path(cxx)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            r = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, SOURCE],
                               capture_output=True, text=True)
            if r.returncode:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(
                    f"building {SOURCE} with {cxx} failed (set CXX to a "
                    f"C++ compiler with OpenMP):\n{r.stderr[-3000:]}"
                )
            os.replace(tmp, path)
    return path


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("CLARK_TPU_NO_NATIVE"):
        _lib = None  # force the pure-numpy fallbacks (testing)
        return None
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.native_threads.restype = ctypes.c_int
    lib.native_threads.argtypes = []
    lib.scan_fasta.restype = ctypes.c_int64
    lib.scan_fasta.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64] + [_I64P] * 5
    lib.scan_fastq.restype = ctypes.c_int64
    lib.scan_fastq.argtypes = lib.scan_fasta.argtypes
    lib.pack_batch.restype = None
    lib.pack_batch.argtypes = [
        _U8P, ctypes.c_int64, _I64P, _I64P, ctypes.c_int64, _U64P, _U64P,
    ]
    lib.format_rows.restype = ctypes.c_int64
    lib.format_rows.argtypes = [
        _U8P, _I64P, _I64P, _I32P, _I32P, _I32P, _I32P, _I64P,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p, _I64P,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.format_rows_extended.restype = ctypes.c_int64
    lib.format_rows_extended.argtypes = [
        _U8P, _I64P, _I64P, _I32P, _I32P, _I32P, _I32P, _I32P, _I64P,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p, _I64P,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.format_rows_extended_sorted.restype = ctypes.c_int64
    lib.format_rows_extended_sorted.argtypes = [
        _U8P, _I64P, _I64P, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64, _I32P, _I32P, _I32P, _I32P, _I64P,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
        _I64P, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.abundance_scan.restype = ctypes.c_int64
    lib.abundance_scan.argtypes = [
        _U8P, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, _U64P,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def threads() -> int:
    """Worker threads of the native parallel loops (OpenMP's count)."""
    return int(_load().native_threads())


def _u8(data) -> tuple[np.ndarray, _U8P]:
    arr = np.frombuffer(data, dtype=np.uint8)
    return arr, arr.ctypes.data_as(_U8P)


def _p(a, tp):
    return a.ctypes.data_as(tp)


def scan_reads(
    data: bytes,
    start: int = 0,
    end: int | None = None,
    is_fasta: bool | None = None,
):
    """(is_fasta, name_start, name_end, seq_start, seq_end, length).

    With start/end, scans only data[start:end] (which must begin at a record
    boundary — a '>' header line or FASTQ line-phase 0) WITHOUT copying;
    returned offsets are absolute into `data`.  Pass is_fasta when scanning
    a chunk of a larger buffer: the format belongs to the WHOLE file (its
    first byte), and a malformed header landing on a chunk boundary must not
    change how that chunk is scanned."""
    lib = _load()
    arr, _ = _u8(data)
    if end is None:
        end = len(arr)
    n = end - start
    if n <= 0:
        raise ValueError("empty input file")
    seg = arr[start:end]
    dp = seg.ctypes.data_as(_U8P)
    if is_fasta is None:
        first = bytes(seg[:1])
        if first == b">":
            is_fasta = True
        elif first == b"@":
            is_fasta = False
        else:
            raise ValueError("failed to recognize the format of the file")
    if is_fasta:
        fn = lib.scan_fasta
        cap = int(np.count_nonzero(seg == ord(">"))) + 16
    else:
        fn = lib.scan_fastq
        cap = int(np.count_nonzero(seg == ord("\n"))) // 4 + 16
    while True:
        ns = np.zeros(cap, np.int64)
        ne = np.zeros(cap, np.int64)
        ss = np.zeros(cap, np.int64)
        se = np.zeros(cap, np.int64)
        ln = np.zeros(cap, np.int64)
        r = fn(dp, n, cap, _p(ns, _I64P), _p(ne, _I64P), _p(ss, _I64P),
               _p(se, _I64P), _p(ln, _I64P))
        if r == -2:
            cap *= 2
            continue
        if r < 0:
            raise ValueError("scan failed")
        break
    if start:
        for a in (ns, ne, ss, se):
            a += start
    return is_fasta, ns[:r], ne[:r], ss[:r], se[:r], ln[:r]


def quick_count(data: bytes) -> int:
    """Exact record count of a FASTA/FASTQ buffer via substring counts only.

    Reproduces the scanners' record rules (scan_fasta: one record per '>' at
    line start; scan_fastq: one record per 4-line group whose sequence line
    START exists — truncated trailing header+sequence kept, lone header
    dropped) so `classify_bytes` can report n_reads before the streamed scan
    finishes.  Parity with scan_reads is regression-tested."""
    if not data:
        raise ValueError("empty input file")
    first = data[0:1]
    if first == b">":
        return data.count(b"\n>") + 1
    if first == b"@":
        nl = data.count(b"\n")
        line_starts = 1 + nl - (1 if data.endswith(b"\n") else 0)
        return (line_starts + 2) // 4
    raise ValueError("failed to recognize the format of the file")


def pack_batch(data: bytes, seq_start: np.ndarray, seq_end: np.ndarray, stride: int):
    lib = _load()
    arr, dp = _u8(data)
    nreads = len(seq_start)
    W = stride // 32 + 1
    WV = stride // 64 + 1
    words = np.empty((nreads, W), np.uint64)
    vwords = np.empty((nreads, WV), np.uint64)
    ss = np.ascontiguousarray(seq_start, np.int64)
    se = np.ascontiguousarray(seq_end, np.int64)
    lib.pack_batch(dp, nreads, _p(ss, _I64P), _p(se, _I64P), stride,
                   _p(words, _U64P), _p(vwords, _U64P))
    return words, vwords


def abundance_scan(
    body, idx: int, min_gamma: float, min_conf: float, offset: int = 0
):
    """(labels, counts, total) of a classification-CSV body (any
    buffer-protocol object, e.g. an mmap, starting at `offset`), or None
    when the native fast path cannot replicate the Python semantics exactly
    (labels >8 bytes / NUL, floats strtod may parse differently).  Labels
    are returned in first-appearance order, matching abundance.estimate's
    dict order."""
    lib = _load()
    if lib is None:
        return None
    arr, _ = _u8(body)
    arr = arr[offset:]
    n = len(arr)
    if n == 0:
        return [], np.zeros(0, np.int64), 0
    dp = arr.ctypes.data_as(_U8P)
    cap = int(np.count_nonzero(arr == ord("\n"))) + int(
        np.count_nonzero(arr == ord("\r"))
    ) + 1
    keys = np.empty(cap, np.uint64)
    total = lib.abundance_scan(
        dp, n, idx, float(min_gamma), float(min_conf), _p(keys, _U64P)
    )
    if total < 0:
        return None
    keys = keys[:total]
    uniq, first, counts = np.unique(keys, return_index=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    try:
        labels = [
            int(u).to_bytes(8, "little").rstrip(b"\x00").decode()
            for u in uniq[order]
        ]
    except UnicodeDecodeError:  # non-UTF8 label: Python path decides
        return None
    return labels, counts[order], int(total)


class NamesBuffer:
    """Target-name table for the native formatter (NUL-joined)."""

    def __init__(self, target_names: list[str]):
        offs = []
        buf = bytearray()
        for t in target_names:
            offs.append(len(buf))
            buf += t.encode() + b"\x00"
        self.buf = bytes(buf)
        self.off = np.array(offs, dtype=np.int64)


def format_rows(
    data: bytes, name_start, name_end, total, ibest, best, sbest, norm,
    k: int, names: NamesBuffer, counts=None, n_targets: int = 0,
    sorted_runs=None,
) -> bytes:
    lib = _load()
    arr, dp = _u8(data)
    nreads = len(total)
    ns = np.ascontiguousarray(name_start, np.int64)
    ne = np.ascontiguousarray(name_end, np.int64)
    tt = np.ascontiguousarray(total, np.int32)
    ib = np.ascontiguousarray(ibest, np.int32)
    bb = np.ascontiguousarray(best, np.int32)
    sb = np.ascontiguousarray(sbest, np.int32)
    nm = np.ascontiguousarray(norm, np.int64)
    if sorted_runs is not None:
        # extended columns expand from each read's sorted label row (run
        # lengths), shipped as u16 [nreads, width] — O(windows) device cost
        # and ~2*width bytes/read fetched instead of 4*(T+1)
        sl = np.ascontiguousarray(sorted_runs, np.uint16)
        width = sl.shape[1] if sl.ndim == 2 else 0
        cap = nreads * (192 + 12 * n_targets) + 1024
        out = ctypes.create_string_buffer(cap)
        w = lib.format_rows_extended_sorted(
            dp, _p(ns, _I64P), _p(ne, _I64P),
            sl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            width, _p(tt, _I32P), _p(ib, _I32P), _p(bb, _I32P),
            _p(sb, _I32P), _p(nm, _I64P), nreads, n_targets, k,
            names.buf, _p(names.off, _I64P), out, cap,
        )
        if w < 0:
            raise RuntimeError("format_rows buffer overflow")
        return out.raw[:w]
    if counts is None:
        cap = nreads * 192 + 1024
        out = ctypes.create_string_buffer(cap)
        w = lib.format_rows(
            dp, _p(ns, _I64P), _p(ne, _I64P), _p(tt, _I32P), _p(ib, _I32P),
            _p(bb, _I32P), _p(sb, _I32P), _p(nm, _I64P), nreads, k,
            names.buf, _p(names.off, _I64P), out, cap,
        )
    else:
        cc = np.ascontiguousarray(counts, np.int32)
        cap = nreads * (192 + 12 * n_targets) + 1024
        out = ctypes.create_string_buffer(cap)
        w = lib.format_rows_extended(
            dp, _p(ns, _I64P), _p(ne, _I64P), _p(cc, _I32P), _p(tt, _I32P),
            _p(ib, _I32P), _p(bb, _I32P), _p(sb, _I32P), _p(nm, _I64P),
            nreads, n_targets, k, names.buf, _p(names.off, _I64P), out, cap,
        )
    if w < 0:
        raise RuntimeError("format_rows buffer overflow")
    return out.raw[:w]


# ---------------------------------------------------------- paired-end merge
def _ensure_merge_sigs(lib):
    if getattr(lib, "_merge_sigs", False):
        return
    lib.merge_paired_chunk.restype = ctypes.c_int64
    lib.merge_paired_chunk.argtypes = [
        _U8P, ctypes.c_int64, _U8P, ctypes.c_int64, _I64P, _I64P,
        _U8P, ctypes.c_int64, _I32P,
    ]
    lib._merge_sigs = True


def merge_paired_stream(data1, data2, chunk_cap: int = 1 << 28):
    """Yield merged-FASTA chunks of two FASTQ buffers (file.cc:205-268
    semantics) through a bounded native buffer; data1/data2 may be mmaps, so
    a multi-GB pair merges with O(chunk_cap) memory."""
    lib = _load()
    _ensure_merge_sigs(lib)
    a1, dp1 = _u8(data1)
    a2, dp2 = _u8(data2)
    try:
        n1, n2 = len(a1), len(a2)
        if a1[:1].tobytes() != b"@" or a2[:1].tobytes() != b"@":
            raise ValueError("paired-end reads must be FASTQ files")
        pos = np.zeros(2, dtype=np.int64)
        status = np.zeros(1, dtype=np.int32)
        # the merged output never exceeds the combined input (+16 framing
        # headroom), so small in-memory merges allocate small buffers
        cap = min(int(chunk_cap), n1 + n2 + 16)
        out = np.empty(cap, dtype=np.uint8)
        while True:
            w = lib.merge_paired_chunk(
                dp1, n1, dp2, n2,
                _p(pos[0:1], _I64P), _p(pos[1:2], _I64P),
                _p(out, _U8P), cap, _p(status, _I32P),
            )
            st = int(status[0])
            if st == -1:
                raise ValueError("read id does not match between files")
            if st == -2:  # a single record exceeds cap
                cap *= 2
                out = np.empty(cap, dtype=np.uint8)
                continue
            if w:
                yield out[:w].tobytes()
            if st == 0:
                return
    finally:
        # drop the buffer views before the caller's mmap close; an exception's
        # traceback keeps this frame alive, and exported views make
        # mmap.close() raise BufferError, masking the real error
        del a1, a2, dp1, dp2


# ------------------------------------------------------------- DB build ops
def _ensure_build_sigs(lib):
    if getattr(lib, "_build_sigs", False):
        return
    lib.extract_canonical.restype = ctypes.c_int64
    lib.extract_canonical.argtypes = [
        _U8P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, _U64P,
    ]
    lib.argsort_u64.restype = None
    lib.argsort_u64.argtypes = [_U64P, ctypes.c_int64, _I64P]
    lib.aggregate_occurrences.restype = ctypes.c_int64
    lib.aggregate_occurrences.argtypes = [
        _U64P, _I32P, ctypes.c_int64, _I32P, ctypes.c_int32,
        _U64P, _I32P, _I32P, _I64P, _I64P,
    ]
    lib.saturating_group_sum.restype = None
    lib.saturating_group_sum.argtypes = [_I64P, ctypes.c_int64, _I64P, _I64P]
    lib.serialize_db.restype = ctypes.c_int32
    lib.serialize_db.argtypes = [
        _U64P, _U16P, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32,
        ctypes.c_int32, _U8P, _U8P, _U16P,
    ]
    lib.serialize_db_parts.restype = ctypes.c_int32
    lib.serialize_db_parts.argtypes = [
        _U64P, _U16P, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, _U8P, _U8P, _U16P,
    ]
    lib.occ_partition_count.restype = None
    lib.occ_partition_count.argtypes = [
        _U64P, ctypes.c_int64, ctypes.c_int32, _I64P,
    ]
    lib.occ_partition_scatter.restype = None
    lib.occ_partition_scatter.argtypes = [
        _U64P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, _I64P, ctypes.c_void_p,
    ]
    lib.aggregate_kv_range.restype = ctypes.c_int64
    lib.aggregate_kv_range.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, _I32P, ctypes.c_int32,
        _U64P, _I32P, _I32P, _I64P, _I64P,
    ]
    lib._build_sigs = True


def extract_canonical(data: bytes, k: int, light: bool, gap: int) -> np.ndarray:
    """Rolling canonical k-mer extraction (native)."""
    lib = _load()
    _ensure_build_sigs(lib)
    arr, dp = _u8(data)
    n = len(arr)
    out = np.empty(max(n, 1), dtype=np.uint64)
    w = lib.extract_canonical(dp, n, k, 1 if light else 0, max(gap, 1),
                              _p(out, _U64P))
    if w < 0:
        raise ValueError("failed to recognize the format of the file")
    return out[:w]  # view; keeps the base buffer alive


def argsort_u64(keys: np.ndarray) -> np.ndarray:
    lib = _load()
    _ensure_build_sigs(lib)
    keys = np.ascontiguousarray(keys, np.uint64)
    idx = np.empty(len(keys), np.int64)
    lib.argsort_u64(_p(keys, _U64P), len(keys), _p(idx, _I64P))
    return idx


def saturating_group_sum(bounds: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Per-group lElement.AddToCount saturating sums (dataType.hh:333-334);
    group g spans v[bounds[g]:bounds[g+1]]."""
    lib = _load()
    _ensure_build_sigs(lib)
    bounds = np.ascontiguousarray(bounds, np.int64)
    v = np.ascontiguousarray(v, np.int64)
    ngroups = len(bounds) - 1
    out = np.empty(max(ngroups, 1), np.int64)
    lib.saturating_group_sum(_p(bounds, _I64P), ngroups, _p(v, _I64P),
                             _p(out, _I64P))
    return out[:ngroups]


class BucketOverflowError(ValueError):
    """A hash bucket exceeded the format's 255-entry cap
    (hashTable_hh.hh:499-507)."""


def serialize_db(canon, labels, htsize: int, rem_bits: int, key_dtype):
    """Fused bucket-major DB layout: (sizes u8[htsize], keys, labels)
    ready for .sz/.ky/.lb tofile — byte-identical to the numpy path.
    Raises BucketOverflowError when a bucket exceeds 255 entries."""
    lib = _load()
    _ensure_build_sigs(lib)
    canon = np.ascontiguousarray(canon, np.uint64)
    labels = np.ascontiguousarray(labels, np.uint16)
    n = len(canon)
    sizes = np.zeros(htsize, np.uint8)
    keys = np.empty(max(n, 1), key_dtype)
    labs = np.empty(max(n, 1), np.uint16)
    rc = lib.serialize_db(
        _p(canon, _U64P), _p(labels, _U16P), n, htsize, rem_bits,
        np.dtype(key_dtype).itemsize, _p(sizes, _U8P),
        keys.ctypes.data_as(_U8P), _p(labs, _U16P),
    )
    if rc != 0:
        raise BucketOverflowError("bucket list size exceeds 255")
    return sizes, keys[:n], labs[:n]


def serialize_db_parts(canon, labels, htsize: int, rem_bits: int, key_dtype,
                       pbits: int):
    """serialize_db with remainder-range partitioning: the stable sort's
    temp is one partition, bounding host memory at RefSeq scale.  Output
    byte-identical to serialize_db."""
    lib = _load()
    _ensure_build_sigs(lib)
    canon = np.ascontiguousarray(canon, np.uint64)
    labels = np.ascontiguousarray(labels, np.uint16)
    n = len(canon)
    sizes = np.zeros(htsize, np.uint8)
    keys = np.empty(max(n, 1), key_dtype)
    labs = np.empty(max(n, 1), np.uint16)
    rc = lib.serialize_db_parts(
        _p(canon, _U64P), _p(labels, _U16P), n, htsize, rem_bits,
        np.dtype(key_dtype).itemsize, pbits, _p(sizes, _U8P),
        keys.ctypes.data_as(_U8P), _p(labs, _U16P),
    )
    if rc != 0:
        raise BucketOverflowError("bucket list size exceeds 255")
    return sizes, keys[:n], labs[:n]


KV_DTYPE = np.dtype([("k", "<u8"), ("v", "<i8")])  # native KV struct layout


def occ_partition_count(canon, shift: int, counts):
    """Accumulate per-partition occurrence counts (pid = canon >> shift)."""
    lib = _load()
    _ensure_build_sigs(lib)
    canon = np.ascontiguousarray(canon, np.uint64)
    lib.occ_partition_count(
        _p(canon, _U64P), len(canon), shift, _p(counts, _I64P)
    )


def occ_partition_scatter(canon, label: int, base_index: int, shift: int,
                          cursors, kv_buf):
    """Scatter one file's occurrences (constant label) into the KV
    partition buffer; cursors advance in place."""
    lib = _load()
    _ensure_build_sigs(lib)
    canon = np.ascontiguousarray(canon, np.uint64)
    lib.occ_partition_scatter(
        _p(canon, _U64P), len(canon), label, base_index, shift,
        _p(cursors, _I64P), kv_buf.ctypes.data,
    )


def aggregate_kv_range(kv_buf, start: int, n: int, pg, lelement: bool):
    """Sort + aggregate one partition [start, start+n) of the KV buffer in
    place; returns (canon, L0, mult, count, first_seq) for that range."""
    lib = _load()
    _ensure_build_sigs(lib)
    pg = np.ascontiguousarray(pg, np.int32)
    oc = np.empty(max(n, 1), np.uint64)
    ol = np.empty(max(n, 1), np.int32)
    om = np.empty(max(n, 1), np.int32)
    on = np.empty(max(n, 1), np.int64)
    of = np.empty(max(n, 1), np.int64)
    ng = lib.aggregate_kv_range(
        kv_buf.ctypes.data + start * KV_DTYPE.itemsize, n, _p(pg, _I32P),
        1 if lelement else 0,
        _p(oc, _U64P), _p(ol, _I32P), _p(om, _I32P), _p(on, _I64P),
        _p(of, _I64P),
    )
    return oc[:ng].copy(), ol[:ng].copy(), om[:ng].copy(), on[:ng].copy(), of[:ng].copy()


def aggregate_occurrences(canon, label, pg, lelement: bool):
    """(canon_u, L0, mult, count, first_seq) for unit-count occurrences."""
    lib = _load()
    _ensure_build_sigs(lib)
    canon = np.ascontiguousarray(canon, np.uint64)
    label = np.ascontiguousarray(label, np.int32)
    pg = np.ascontiguousarray(pg, np.int32)
    n = len(canon)
    oc = np.empty(max(n, 1), np.uint64)
    ol = np.empty(max(n, 1), np.int32)
    om = np.empty(max(n, 1), np.int32)
    on = np.empty(max(n, 1), np.int64)
    of = np.empty(max(n, 1), np.int64)
    ng = lib.aggregate_occurrences(
        _p(canon, _U64P), _p(label, _I32P), n, _p(pg, _I32P),
        1 if lelement else 0,
        _p(oc, _U64P), _p(ol, _I32P), _p(om, _I32P), _p(on, _I64P),
        _p(of, _I64P),
    )
    return oc[:ng], ol[:ng], om[:ng], on[:ng], of[:ng]  # views
