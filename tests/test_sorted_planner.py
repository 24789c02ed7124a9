"""Length-bucketed batch planning must be invisible in the output.

The sorted planner regroups a planning window's reads by stride tier for
dense same-stride batches, then scatters per-read
results back to file order before formatting — so the CSV must be
byte-identical to the file-order planner on any input, including
mixed-length reads, N's, junk, paired mode, and out-of-core cycling.
Reference behavior matched: variable-length container packing,
CuCLARK_hh.hh:1610-1726.
"""

import numpy as np
import pytest

from jn_cuclark_tpu import params
from jn_cuclark_tpu.db import builder
from jn_cuclark_tpu.engine import (
    BatchPlan,
    Classifier,
    _pad_rows,
    _stride_tiers,
)
from jn_cuclark_tpu.io.targets import parse_targets
from jn_cuclark_tpu.ops import pack
from jn_cuclark_tpu.utils import native

from .test_builder import rand_seq, write_fasta

K = 9


def test_stride_tiers_matches_scalar():
    lens = np.array([1, 17, 64, 65, 100, 1024, 1025, 2048, 2049, 5000, 9000])
    want = np.array([pack.quantized_stride(int(x)) for x in lens])
    got = _stride_tiers(lens)
    assert np.array_equal(got, want)


def test_pad_rows_shapes():
    assert _pad_rows(1, 65536) == 2048
    assert _pad_rows(2048, 65536) == 2048
    assert _pad_rows(2049, 65536) == 4096
    assert _pad_rows(8192, 65536) == 8192
    assert _pad_rows(8193, 65536) == 16384
    assert _pad_rows(38400, 65536) == 40960  # multiple of 8192, not pow2
    assert _pad_rows(50000, 65536) == 57344
    assert _pad_rows(3000, 2500) == 2500  # never exceed the tier cap


def test_pack_batch_idx_matches_contiguous():
    rng = np.random.default_rng(3)
    reads = [rand_seq(rng, int(rng.integers(10, 200))) for _ in range(40)]
    fa = "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)).encode()
    from jn_cuclark_tpu.io.fasta import parse_reads

    rs = parse_reads(fa)
    w1, v1 = pack.pack_batch(rs, 5, 25, 256)
    w2, v2 = pack.pack_batch_idx(rs, np.arange(5, 25), 256)
    assert np.array_equal(w1, w2) and np.array_equal(v1, v2)
    # gathered, non-contiguous, unordered
    idx = np.array([30, 2, 17, 17, 0])
    wg, vg = pack.pack_batch_idx(rs, idx, 192)
    for row, i in enumerate(idx):
        wi, vi = pack.pack_batch(rs, int(i), int(i) + 1, 192)
        assert np.array_equal(wg[row : row + 1], wi)
        assert np.array_equal(vg[row : row + 1], vi)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(77)
    genomes = [rand_seq(rng, 900) for _ in range(3)]
    with open(tmp_path / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = tmp_path / f"g{i}.fa"
            write_fasta(p, [(f"g{i}", g)], width=60)
            tf.write(f"{p} {3000 + i}\n")
    prof = params.tiny(htsize=4093, k=K)
    targets = parse_targets(str(tmp_path / "targets.txt"))
    builder.build_database(targets, str(tmp_path), prof, K)
    # adversarial length mix: interleaved tiers, junk, N's, a long straggler
    reads = []
    for i in range(300):
        if i % 5 == 4:
            s = rand_seq(rng, int(rng.integers(20, 280)))  # junk (miss)
        else:
            g = genomes[i % 3]
            ln = int(rng.integers(20, 280))
            pos = rng.integers(0, max(len(g) - ln, 1))
            s = g[pos : pos + ln]
        if i % 7 == 0 and len(s) > 40:
            s = s[:15] + "N" + s[16:]
        reads.append((f"r{i}", s))
    reads.insert(50, ("long", rand_seq(rng, 1400)))
    reads.append(("tiny", "AC"))
    fa = "".join(f">{n}\n{s}\n" for n, s in reads).encode()
    return tmp_path, prof, targets, fa


def _csv(clf, fa, **kw):
    gen, n = clf.classify_bytes(fa, **kw)
    return b"".join(gen)


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("extended", [False, True])
def test_sorted_equals_fileorder(setup, use_native, extended):
    tmp_path, prof, targets, fa = setup
    if use_native and not native.available():
        pytest.skip("native lib not built")
    kw = dict(max_reads=64, window_budget=1 << 13)
    a = Classifier.load(
        str(tmp_path), targets, prof, K,
        plan=BatchPlan(sort_batches=True, sort_window_batches=3, **kw),
        use_native=use_native,
    )
    b = Classifier.load(
        str(tmp_path), targets, prof, K,
        plan=BatchPlan(sort_batches=False, **kw),
        use_native=use_native,
    )
    assert _csv(a, fa, extended=extended) == _csv(b, fa, extended=extended)


@pytest.mark.parametrize("use_native", [False, True])
def test_sorted_cycled_equals_fileorder(setup, use_native):
    tmp_path, prof, targets, fa = setup
    if use_native and not native.available():
        pytest.skip("native lib not built")
    kw = dict(max_reads=64, window_budget=1 << 13)
    a = Classifier.load(
        str(tmp_path), targets, prof, K,
        plan=BatchPlan(sort_batches=True, **kw),
        use_native=use_native, db_cycles=3,
    )
    b = Classifier.load(
        str(tmp_path), targets, prof, K,
        plan=BatchPlan(sort_batches=False, **kw),
        use_native=use_native, db_cycles=3,
    )
    assert _csv(a, fa) == _csv(b, fa)


def test_sorted_paired_equals_fileorder(setup):
    tmp_path, prof, targets, fa = setup
    rng = np.random.default_rng(5)
    g = rand_seq(rng, 2000)
    fq1, fq2 = [], []
    for i in range(80):
        ln = int(rng.integers(60, 140))
        pos = int(rng.integers(0, len(g) - 500))
        fq1.append(f"@p{i}/1\n{g[pos:pos+ln]}\n+\n{'I'*ln}\n")
        fq2.append(f"@p{i}/2\n{g[pos+250:pos+250+ln]}\n+\n{'I'*ln}\n")
    from jn_cuclark_tpu.io.fasta import merge_paired

    merged = merge_paired("".join(fq1).encode(), "".join(fq2).encode())
    kw = dict(max_reads=64, window_budget=1 << 13)
    a = Classifier.load(
        str(tmp_path), targets, prof, K,
        plan=BatchPlan(sort_batches=True, sort_window_batches=2, **kw),
    )
    b = Classifier.load(
        str(tmp_path), targets, prof, K,
        plan=BatchPlan(sort_batches=False, **kw),
    )
    assert _csv(a, merged, paired=True) == _csv(b, merged, paired=True)


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("extended", [False, True])
def test_hybrid_direct_blocks_equal_fileorder(setup, use_native, extended):
    """Uniform single-tier stretches take the hybrid planner's scan-paced
    direct (file-order) path; tier changes switch to bucketed windows —
    the transitions must keep the CSV byte-identical (and the direct path
    must carry extended counts / sorted runs correctly)."""
    tmp_path, prof, targets, _ = setup
    if use_native and not native.available():
        pytest.skip("native lib not built")
    rng = np.random.default_rng(42)
    g = rand_seq(rng, 900)
    reads = []
    # uniform block (one tier -> several direct batches at max_reads=16)
    for i in range(80):
        pos = int(rng.integers(0, len(g) - 100))
        reads.append((f"u{i}", g[pos : pos + 100]))
    # mixed block (tiers interleave -> bucketed windows)
    for i in range(60):
        ln = int(rng.integers(20, 280))
        pos = int(rng.integers(0, max(len(g) - ln, 1)))
        reads.append((f"m{i}", g[pos : pos + ln]))
    # trailing uniform block (back to direct)
    for i in range(40):
        pos = int(rng.integers(0, len(g) - 150))
        reads.append((f"t{i}", g[pos : pos + 150]))
    fa = "".join(f">{n}\n{s}\n" for n, s in reads).encode()
    kw = dict(max_reads=16, window_budget=1 << 12)
    a = Classifier.load(
        str(tmp_path), targets, prof, K,
        plan=BatchPlan(sort_batches=True, sort_window_batches=2, **kw),
        use_native=use_native,
    )
    b = Classifier.load(
        str(tmp_path), targets, prof, K,
        plan=BatchPlan(sort_batches=False, **kw),
        use_native=use_native,
    )
    assert _csv(a, fa, extended=extended) == _csv(b, fa, extended=extended)
