"""On-disk DB format: byte-level layout and round-trip tests."""

import numpy as np
import pytest

from jn_cuclark_tpu.io import dbformat
from jn_cuclark_tpu import params


@pytest.fixture
def prof():
    return params.tiny(htsize=101, k=9)


def test_write_layout_bytes(tmp_path, prof):
    # hand-placed entries: canonical = quotient*HTSIZE + remainder
    H = prof.htsize
    canon = np.array([5 + 2 * H, 5 + 7 * H, 5 + 1 * H, 42 + 0 * H], dtype=np.uint64)
    labels = np.array([3, 1, 2, 9], dtype=np.uint16)
    stem = str(tmp_path / "db")
    n = dbformat.write_db(stem, prof, 9, canon, labels)
    assert n == 4

    sz = np.fromfile(stem + ".sz", dtype=np.uint8)
    assert sz.shape == (H,)
    assert sz[5] == 3 and sz[42] == 1 and sz.sum() == 4

    ky = np.fromfile(stem + ".ky", dtype=prof.key_dtype(9))
    # bucket 5 first (ascending bucket order), quotients sorted within bucket
    assert list(ky) == [1, 2, 7, 0]
    lb = np.fromfile(stem + ".lb", dtype=np.uint16)
    assert list(lb) == [2, 3, 1, 9]


def test_key_dtype_thresholds():
    full = params.FULL
    light = params.LIGHT
    # main.cc:251-286 — full: 2B for k<=23, 4B for k<=31, else 8B
    assert full.key_dtype(23).itemsize == 2
    assert full.key_dtype(24).itemsize == 4
    assert full.key_dtype(31).itemsize == 4
    assert full.key_dtype(32).itemsize == 8
    # light: 2B for k<=20, 4B for k<=28
    assert light.key_dtype(20).itemsize == 2
    assert light.key_dtype(27).itemsize == 4


def test_roundtrip(tmp_path, prof):
    rng = np.random.default_rng(1)
    canon = rng.integers(0, 4**9, size=300, dtype=np.uint64)
    canon = np.unique(canon)
    labels = rng.integers(0, 50, size=len(canon)).astype(np.uint16)
    stem = str(tmp_path / "db")
    dbformat.write_db(stem, prof, 9, canon, labels)
    c2, l2 = dbformat.read_db(stem, prof, 9)
    # round-trip preserves the (canonical, label) set
    order1 = np.argsort(canon)
    order2 = np.argsort(c2)
    assert np.array_equal(canon[order1], c2[order2])
    assert np.array_equal(labels[order1], l2[order2])


def test_sampling_factor(tmp_path, prof):
    H = prof.htsize
    # buckets 3, 10, 20, 30 nonzero -> ordinals 1,2,3,4; s=2 keeps ordinals 2,4
    canon = np.array([10, 3, 30, 20, 10 + H], dtype=np.uint64)
    labels = np.arange(5, dtype=np.uint16)
    stem = str(tmp_path / "db")
    dbformat.write_db(stem, prof, 9, canon, labels)
    c2, l2 = dbformat.read_db(stem, prof, 9, sampling_factor=2)
    rems = set(int(c % H) for c in c2)
    assert rems == {10, 30}
    assert len(c2) == 3  # bucket 10 has 2 entries


def test_bucket_overflow_rejected(tmp_path):
    prof = params.tiny(htsize=7, k=9)
    canon = (np.arange(300, dtype=np.uint64) * np.uint64(7)) + np.uint64(3)
    labels = np.zeros(300, dtype=np.uint16)
    with pytest.raises(dbformat.DBFormatError):
        dbformat.write_db(str(tmp_path / "db"), prof, 9, canon, labels)


@pytest.mark.parametrize("htsize,k", [(65521, 16), (1048573, 27), (16777259, 31)])
def test_native_serialize_matches_numpy(tmp_path, htsize, k, monkeypatch):
    """The fused native serialize_db must write byte-identical .sz/.ky/.lb
    to the numpy mod/div + argsort + RLE path at every key width."""
    from jn_cuclark_tpu.utils import native

    if not native.available():
        pytest.skip("native serialize_db not built")
    prof = params.tiny(htsize=htsize, k=k)
    rng = np.random.default_rng(3)
    canon = np.unique(rng.integers(0, 1 << (2 * k), size=60000, dtype=np.uint64))
    labels = rng.integers(0, 500, size=len(canon)).astype(np.uint16)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    dbformat.write_db(a, prof, k, canon, labels)
    monkeypatch.setattr(native, "available", lambda: False)
    dbformat.write_db(b, prof, k, canon, labels)
    for ext in (".sz", ".ky", ".lb"):
        assert open(a + ext, "rb").read() == open(b + ext, "rb").read()
