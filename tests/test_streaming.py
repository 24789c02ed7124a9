"""Streaming ingestion: record-aligned slab iteration, native chunked
paired-end merge, and bounded-memory classify_file parity
(reference mmap scan CuCLARK_hh.hh:522-539, mergePairedFiles file.cc:205-268).
"""

import numpy as np
import pytest

from jn_cuclark_tpu.engine import BatchPlan, Classifier
from jn_cuclark_tpu.io.fasta import (
    _merge_paired_py,
    iter_merged_slabs,
    iter_record_slabs,
    merge_paired,
)
from jn_cuclark_tpu.utils import native

from .test_builder import rand_seq
from .test_engine import K, setup  # noqa: F401  (fixture)


def _write(tmp_path, name, data: bytes):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def make_fasta(rng, n_reads, minlen=20, maxlen=200) -> bytes:
    out = []
    for i in range(n_reads):
        seq = rand_seq(rng, int(rng.integers(minlen, maxlen)))
        out.append(f">r{i} desc\n")
        # multi-line records exercise mid-record cuts
        for j in range(0, len(seq), 37):
            out.append(seq[j : j + 37] + "\n")
    return "".join(out).encode()


def make_fastq(rng, n_reads, minlen=20, maxlen=200) -> bytes:
    out = []
    for i in range(n_reads):
        seq = rand_seq(rng, int(rng.integers(minlen, maxlen)))
        out.append(f"@r{i}/1\n{seq}\n+\n{'I' * len(seq)}\n")
    return "".join(out).encode()


@pytest.mark.parametrize("kind", ["fasta", "fastq"])
@pytest.mark.parametrize("slab", [256, 4096, 1 << 20])
def test_slab_iteration_reassembles(tmp_path, kind, slab):
    rng = np.random.default_rng(7)
    data = make_fasta(rng, 40) if kind == "fasta" else make_fastq(rng, 40)
    path = _write(tmp_path, f"in.{kind}", data)
    slabs = list(iter_record_slabs(path, slab_bytes=slab))
    assert b"".join(slabs) == data
    first = b">" if kind == "fasta" else b"@"
    for s in slabs:
        assert s[:1] == first  # every slab begins at a record boundary
    if slab == 256:
        assert len(slabs) > 5  # actually streamed


def test_slab_iteration_record_bigger_than_slab(tmp_path):
    rng = np.random.default_rng(8)
    big = rand_seq(rng, 5000)
    data = (
        f">a\n{big}\n>b\nACGT\n>c\n{big}\n".encode()
    )
    path = _write(tmp_path, "big.fa", data)
    slabs = list(iter_record_slabs(path, slab_bytes=128))
    assert b"".join(slabs) == data
    for s in slabs:
        assert s[:1] == b">"


def test_slab_iteration_fastq_truncated_tail(tmp_path):
    """A truncated trailing record stays in the final slab (EOF cut)."""
    rng = np.random.default_rng(9)
    data = make_fastq(rng, 9) + b"@tail\nACGTACGT"  # no +/quality lines
    path = _write(tmp_path, "trunc.fq", data)
    slabs = list(iter_record_slabs(path, slab_bytes=200))
    assert b"".join(slabs) == data


def test_slab_iteration_errors(tmp_path):
    p = _write(tmp_path, "empty.fa", b"")
    with pytest.raises(ValueError, match="empty input file"):
        next(iter_record_slabs(p))
    p = _write(tmp_path, "bad.txt", b"not a fasta\n")
    with pytest.raises(ValueError, match="format"):
        next(iter_record_slabs(p))


@pytest.mark.skipif(not native.available(), reason="native lib not built")
@pytest.mark.parametrize("chunk", [64, 1024, 1 << 20])
def test_native_merge_matches_python(chunk):
    rng = np.random.default_rng(10)
    r = [(f"p{i}", rand_seq(rng, int(rng.integers(30, 120)))) for i in range(25)]
    fq1 = "".join(f"@{n}/1 x\n{s}\n+\n{'I'*len(s)}\n" for n, s in r).encode()
    fq2 = "".join(f"@{n}/2\n{s[::-1]}\n+\n{'I'*len(s)}\n" for n, s in r).encode()
    want = _merge_paired_py(fq1, fq2)
    got = b"".join(native.merge_paired_stream(fq1, fq2, chunk_cap=chunk))
    assert got == want
    if chunk == 64:
        assert len(list(native.merge_paired_stream(fq1, fq2, chunk_cap=64))) > 3


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_native_merge_edge_cases():
    # trailing newline / missing trailing newline / extra non-@ lines
    fq1 = b"@a/1\nACGT\n+\nIIII\n@b/1\nGGGG\n+\nIIII"
    fq2 = b"@a/2\nTTTT\n+\nIIII\n@b/2\nCCCC\n+\nIIII"
    assert b"".join(native.merge_paired_stream(fq1, fq2)) == _merge_paired_py(
        fq1, fq2
    )
    # id mismatch raises like the python path
    bad = b"@zzz/2\nTTTT\n+\nIIII\n"
    with pytest.raises(ValueError, match="read id"):
        b"".join(native.merge_paired_stream(fq1[:17], bad))
    with pytest.raises(ValueError, match="FASTQ"):
        b"".join(native.merge_paired_stream(b">fa\nACGT\n", fq2))


def test_merge_paired_dispatch_parity():
    """merge_paired (native when available) == pure python on the same input."""
    rng = np.random.default_rng(11)
    r = [(f"q{i}", rand_seq(rng, 50)) for i in range(8)]
    fq1 = "".join(f"@{n}\n{s}\n+\n{'I'*len(s)}\n" for n, s in r).encode()
    fq2 = "".join(f"@{n}\n{s}\n+\n{'I'*len(s)}\n" for n, s in r).encode()
    assert merge_paired(fq1, fq2) == _merge_paired_py(fq1, fq2)


def test_classify_file_streaming_parity(setup, tmp_path):  # noqa: F811
    """classify_file output is independent of slab size (streamed == whole)."""
    dbdir, tpath, prof, targets, genomes, reads = setup
    clf = Classifier.load(str(dbdir), targets, prof, K)
    obj = tmp_path / "reads.fa"
    with open(obj, "w") as f:
        for n, s in reads:
            f.write(f">{n}\n{s}\n")
    a = tmp_path / "whole"
    b = tmp_path / "slabbed"
    sa = clf.classify_file(str(obj), str(a))
    sb = clf.classify_file(str(obj), str(b), slab_bytes=512)
    assert sa["reads"] == sb["reads"] == len(reads)
    assert (tmp_path / "whole.csv").read_bytes() == (
        tmp_path / "slabbed.csv"
    ).read_bytes()


def test_classify_file_paired_streaming_parity(setup, tmp_path):  # noqa: F811
    dbdir, tpath, prof, targets, genomes, reads = setup
    clf = Classifier.load(str(dbdir), targets, prof, K)
    g1 = genomes["g1"]
    r1 = [(f"p{i}", g1[i * 10 : i * 10 + 80]) for i in range(12)]
    r2 = [(f"p{i}", g1[i * 10 + 100 : i * 10 + 180]) for i in range(12)]
    f1 = tmp_path / "r1.fq"
    f2 = tmp_path / "r2.fq"
    f1.write_text("".join(f"@{n}/1\n{s}\n+\n{'I'*len(s)}\n" for n, s in r1))
    f2.write_text("".join(f"@{n}/2\n{s}\n+\n{'I'*len(s)}\n" for n, s in r2))
    a = tmp_path / "pw"
    b = tmp_path / "ps"
    sa = clf.classify_file(str(f1), str(a), paired_path=str(f2))
    sb = clf.classify_file(str(f1), str(b), paired_path=str(f2), slab_bytes=256)
    assert sa["reads"] == sb["reads"] == 12
    assert (tmp_path / "pw.csv").read_bytes() == (tmp_path / "ps.csv").read_bytes()


def test_iter_merged_slabs_parity(tmp_path):
    rng = np.random.default_rng(12)
    r = [(f"m{i}", rand_seq(rng, 60)) for i in range(10)]
    fq1 = "".join(f"@{n}/1\n{s}\n+\n{'I'*len(s)}\n" for n, s in r).encode()
    fq2 = "".join(f"@{n}/2\n{s}\n+\n{'I'*len(s)}\n" for n, s in r).encode()
    p1 = _write(tmp_path, "m1.fq", fq1)
    p2 = _write(tmp_path, "m2.fq", fq2)
    got = b"".join(iter_merged_slabs(p1, p2, slab_bytes=128))
    assert got == _merge_paired_py(fq1, fq2)


def test_classify_file_bad_input_preserves_existing_results(setup, tmp_path):  # noqa: F811
    """A missing/malformed input must raise BEFORE the output CSV is
    touched (round-2 review finding: the streaming rewrite truncated the
    results file first)."""
    dbdir, tpath, prof, targets, genomes, reads = setup
    clf = Classifier.load(str(dbdir), targets, prof, K)
    res = tmp_path / "keep"
    precious = b"Object_ID,Gamma,Assignment,Score,Confidence\nold,1,NA,0,0\n"
    (tmp_path / "keep.csv").write_bytes(precious)
    with pytest.raises(FileNotFoundError):
        clf.classify_file(str(tmp_path / "nope.fa"), str(res))
    assert (tmp_path / "keep.csv").read_bytes() == precious
    bad = tmp_path / "bad.txt"
    bad.write_bytes(b"not a fasta\n")
    with pytest.raises(ValueError, match="format"):
        clf.classify_file(str(bad), str(res))
    assert (tmp_path / "keep.csv").read_bytes() == precious
    # paired: mismatched ids raise during the FIRST slab, before output
    f1 = tmp_path / "a.fq"
    f2 = tmp_path / "b.fq"
    f1.write_text("@x/1\nACGT\n+\nIIII\n")
    f2.write_text("@zzz/2\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="read id"):
        clf.classify_file(str(f1), str(res), paired_path=str(f2))
    assert (tmp_path / "keep.csv").read_bytes() == precious


# ------------------------------------------------- streamed in-memory scan
_QC_CASES = [
    b">a\nACGT\n",
    b">a\nACGT",  # no trailing newline
    b">a\nAC\nGT\n>b\nTTTT\n",  # multi-line records
    b">",  # header only
    b">x\n",
    b">x\n\n>y\nA\n",  # empty sequence lines
    b"@r1\nACGT\n+\nIIII\n",
    b"@r1\nACGT\n+\nIIII",  # no trailing newline
    b"@r1\nACGT\n+\nIIII\n@r2\nAC\n+\nII\n",
    b"@r1\nACGT\n",  # truncated: header+seq kept (reference parity rule)
    b"@r1\nACGT\n+\n",  # truncated after plus line
    b"@r1\nACGT\n+",  # plus line unterminated
    b"@r1\n",  # lone header with newline: no seq line start -> dropped
    b"@r1",  # lone header, unterminated
    b"@r1\n\n+\n\n",  # empty seq/qual lines
]


@pytest.mark.parametrize("data", _QC_CASES, ids=range(len(_QC_CASES)))
def test_quick_count_matches_scanner(data):
    if not native.available():
        pytest.skip("native library unavailable")
    try:
        n = len(native.scan_reads(data)[5])
    except ValueError:
        with pytest.raises(ValueError):
            native.quick_count(data)
        return
    assert native.quick_count(data) == n, data


@pytest.mark.parametrize("kind", ["fasta", "fastq"])
def test_quick_count_randomized(kind):
    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(23)
    for trial in range(20):
        data = (make_fasta if kind == "fasta" else make_fastq)(
            rng, int(rng.integers(1, 40))
        )
        # random truncation exercises every partial-record shape
        if trial % 2:
            data = data[: int(rng.integers(1, len(data)))]
        if data[:1] not in (b">", b"@"):
            continue
        assert native.quick_count(data) == len(native.scan_reads(data)[5]), data


@pytest.mark.parametrize("kind", ["fasta", "fastq"])
@pytest.mark.parametrize("chunk", [64, 257, 1 << 14])
def test_scan_stream_matches_whole_scan(kind, chunk):
    if not native.available():
        pytest.skip("native library unavailable")
    from jn_cuclark_tpu.engine import _ScanStream

    rng = np.random.default_rng(31)
    data = (make_fasta if kind == "fasta" else make_fastq)(rng, 60)
    whole = native.scan_reads(data)[1:]
    scan = _ScanStream(data, chunk_bytes=chunk)
    n = scan.total()
    assert n == len(whole[4])
    got = scan.arrays(0, n)
    for a, b in zip(got, whole):
        np.testing.assert_array_equal(a, b)
    # random sub-slices (spanning chunk boundaries) match too
    for _ in range(10):
        r0 = int(rng.integers(0, n))
        r1 = int(rng.integers(r0, n)) + 1
        got = scan.arrays(r0, r1)
        for a, b in zip(got, whole):
            np.testing.assert_array_equal(a, b[r0:r1])


def test_classify_scan_chunk_parity(setup):  # noqa: F811
    """classify_bytes output and n_reads are independent of the streamed
    scan chunk size (tiny chunks force many chunk-boundary batches)."""
    dbdir, tpath, prof, targets, genomes, reads = setup
    fa = "".join(f">{n}\n{s}\n" for n, s in reads).encode()
    ref_clf = Classifier.load(str(dbdir), targets, prof, K)
    gen, n_ref = ref_clf.classify_bytes(fa)
    ref = b"".join(gen)
    assert n_ref == len(reads)
    small = Classifier.load(
        str(dbdir), targets, prof, K,
        plan=BatchPlan(scan_chunk_bytes=512),
    )
    gen, n_small = small.classify_bytes(fa)
    assert b"".join(gen) == ref
    assert n_small == len(reads)
    # extended mode too (per-batch fetch path)
    a = b"".join(ref_clf.classify_bytes(fa, extended=True)[0])
    b = b"".join(small.classify_bytes(fa, extended=True)[0])
    assert a == b


def test_classify_files_concurrent_parity(setup, tmp_path):  # noqa: F811
    """classify_files with jobs>1 produces byte-identical per-file CSVs to
    sequential classification (shared Classifier, concurrent pipelines)."""
    dbdir, tpath, prof, targets, genomes, reads = setup
    clf = Classifier.load(str(dbdir), targets, prof, K)
    items = []
    rng = np.random.default_rng(17)
    for s in range(5):
        sel = [reads[int(i)] for i in rng.integers(0, len(reads), 40)]
        p = tmp_path / f"s{s}.fa"
        p.write_text("".join(f">{n}\n{q}\n" for n, q in sel))
        items.append((str(p), None, str(tmp_path / f"par{s}")))
    seq_items = [(o, p, r.replace("par", "seq")) for o, p, r in items]
    st_par = clf.classify_files(items, jobs=3)
    st_seq = clf.classify_files(seq_items, jobs=1)
    for s in range(5):
        a = (tmp_path / f"par{s}.csv").read_bytes()
        b = (tmp_path / f"seq{s}.csv").read_bytes()
        assert a == b, f"sample {s}"
        assert st_par[s]["reads"] == st_seq[s]["reads"] == 40


def test_scan_stream_format_pinned_across_chunks():
    """A FASTQ record whose header does not start with '@' scans the same
    streamed (tiny chunks, record at a chunk boundary) as whole-buffer:
    the file's format is detected ONCE from its first byte (review fix)."""
    if not native.available():
        pytest.skip("native library unavailable")
    from jn_cuclark_tpu.engine import _ScanStream

    recs = []
    for i in range(40):
        h = ">odd" if i % 7 == 3 else f"@r{i}"  # some headers malformed
        recs.append(f"{h}\n{'ACGT' * 10}\n+\n{'I' * 40}\n")
    data = "".join(recs).encode()
    whole = native.scan_reads(data)[1:]
    for chunk in (64, 128, 300):
        scan = _ScanStream(data, chunk_bytes=chunk)
        n = scan.total()
        assert n == len(whole[4]), chunk
        got = scan.arrays(0, n)
        for a, b in zip(got, whole):
            np.testing.assert_array_equal(a, b)


def test_pipelined_pool_order_and_errors():
    """The concurrent fetch pool must preserve input order and propagate
    worker exceptions to the consumer."""
    import time as _time

    from jn_cuclark_tpu.engine import Classifier

    pool = Classifier._pipelined_pool

    class Dummy:
        _pipelined = Classifier._pipelined
        plan = type("P", (), {"pipeline_depth": 4})()

    d = Dummy()

    def slow_sq(x):
        _time.sleep(0.01 * ((x % 3) + 1))  # out-of-order completion times
        return x * x

    assert list(pool(d, range(20), slow_sq, workers=3, depth=4)) == [
        x * x for x in range(20)
    ]

    def boom(x):
        if x == 5:
            raise ValueError("boom")
        return x

    import pytest as _pytest

    with _pytest.raises(ValueError, match="boom"):
        list(pool(d, range(10), boom, workers=2, depth=3))
