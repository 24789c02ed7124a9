"""Dense two-choice ("cuckoo") table.

A DB between 1x and ~2x the device budget stays RESIDENT at load ~0.9
(two row gathers per probe: the overflow spills into a tiny second plane
keyed by an independent bijective mix) instead of cycling.  Matches and
beats the reference's any-size-DB parts/cycles guarantee
(/root/reference/src/CuClarkDB.cu:526-565): same correctness, no
table re-streaming.
"""

import numpy as np
import pytest

from jn_cuclark_tpu import params
from jn_cuclark_tpu.db import builder
from jn_cuclark_tpu.engine import BatchPlan, Classifier
from jn_cuclark_tpu.io.targets import parse_targets
from jn_cuclark_tpu.ops import radix_table

from .test_builder import rand_seq, write_fasta

K = 9


@pytest.mark.parametrize("n,c", [(500, 16), (20000, 16), (60000, 128)])
def test_probe_dense_oracle(n, c):
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(1, 1 << 40, size=2 * n,
                                  dtype=np.uint64))[:n]
    labels1 = rng.integers(1, 200, size=len(keys)).astype(np.int32)
    t = radix_table.build_dense(keys, labels1, c=c)
    if n >= 20000:  # tiny n: the lb+1 floor on m1 dominates, not density
        # plane 1 is genuinely dense (the point of the layout)
        occ = n / ((1 << t.m1) * c)
        assert occ > 0.45  # pow2 rounding: actual occupancy in (0.45, 0.9]
    # every key resolves to its label; misses resolve to 0
    misses = rng.integers(1 << 41, 1 << 42, size=n, dtype=np.uint64)
    q = np.concatenate([keys, misses])
    got = np.asarray(
        radix_table.probe_dense(
            t.slots1, t.slots2, t.stash_keys, t.stash_labels, q, **t.meta
        )
    )
    np.testing.assert_array_equal(got[:len(keys)], labels1)
    np.testing.assert_array_equal(got[len(keys):], 0)


def test_dense_matches_standard_probe():
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(1, 1 << 50, size=60000,
                                  dtype=np.uint64))[:30000]
    labels1 = rng.integers(1, 50, size=len(keys)).astype(np.int32)
    std = radix_table.build(keys, labels1)
    dn = radix_table.build_dense(keys, labels1)
    q = np.concatenate([keys[::3], rng.integers(1, 1 << 50, 5000,
                                                dtype=np.uint64)])
    a = np.asarray(radix_table.probe(
        std.slots, std.labels, std.stash_keys, std.stash_labels, q,
        **std.meta))
    b = np.asarray(radix_table.probe_dense(
        dn.slots1, dn.slots2, dn.stash_keys, dn.stash_labels, q, **dn.meta))
    np.testing.assert_array_equal(a, b)


def test_recover_keys_roundtrip():
    """The standard slot layout is information-preserving: keys+labels
    recovered from a built table (bijective-mix inversion) must equal the
    input set — this seeds dense rebuilds when only the .idx cache
    survives (engine._try_dense)."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(1, 1 << 52, size=40000, dtype=np.uint64))
    labels1 = rng.integers(1, 500, size=len(keys)).astype(np.int32)
    t = radix_table.build(keys, labels1)
    rk, rl = radix_table.recover_keys(t)
    order = np.argsort(rk)
    korder = np.argsort(keys)
    np.testing.assert_array_equal(rk[order], keys[korder])
    np.testing.assert_array_equal(rl[order], labels1[korder])


def test_dense_nbytes_prediction_covers_build():
    for n in (10_000, 300_000, 2_000_000):
        rng = np.random.default_rng(n)
        keys = np.unique(rng.integers(1, 1 << 48, size=2 * n,
                                      dtype=np.uint64))[:n]
        labels1 = rng.integers(1, 900, size=len(keys)).astype(np.int32)
        t = radix_table.build_dense(keys, labels1)
        pred = radix_table.dense_nbytes(n, 900, c=t.slot_width)
        assert t.nbytes <= pred  # prediction must be an upper bound
        assert pred <= 2 * t.nbytes + (1 << 20)  # ...but not wildly loose


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("dense")
    rng = np.random.default_rng(23)
    genomes = [rand_seq(rng, 900) for _ in range(3)]
    with open(tmp_path / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = tmp_path / f"g{i}.fa"
            write_fasta(p, [(f"g{i}", g)], width=60)
            tf.write(f"{p} {4000 + i}\n")
    prof = params.tiny(htsize=4093, k=K)
    targets = parse_targets(str(tmp_path / "targets.txt"))
    builder.build_database(targets, str(tmp_path), prof, K)
    reads = []
    for i in range(150):
        g = genomes[i % 3]
        ln = int(rng.integers(25, 220))
        pos = rng.integers(0, max(len(g) - ln, 1))
        reads.append((f"r{i}", g[pos : pos + ln]))
    reads.append(("junk", "".join(rng.choice(list("ACGT"), size=100))))
    fa = "".join(f">{n}\n{s}\n" for n, s in reads).encode()
    return tmp_path, prof, targets, fa


@pytest.mark.parametrize("extended", [False, True])
def test_forced_dense_byte_equal(db, monkeypatch, extended):
    tmp_path, prof, targets, fa = db
    plan = BatchPlan(max_reads=64, window_budget=1 << 13)
    monkeypatch.delenv("CLARK_TPU_DEVICE_MEM_BYTES", raising=False)
    ref = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    want = b"".join(ref.classify_bytes(fa, extended=extended)[0])
    monkeypatch.setenv("CLARK_TPU_DENSE", "force")
    clf = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    assert clf.dense_table is not None
    got = b"".join(clf.classify_bytes(fa, extended=extended)[0])
    assert got == want


def test_auto_policy_prefers_dense_over_cycling(db, monkeypatch, capsys):
    tmp_path, prof, targets, fa = db
    plan = BatchPlan(max_reads=64, window_budget=1 << 13)
    monkeypatch.delenv("CLARK_TPU_DEVICE_MEM_BYTES", raising=False)
    ref = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    want = b"".join(ref.classify_bytes(fa)[0])
    # fake "standard table does not fit, generous budget otherwise":
    # cycling would engage; the dense layout must preempt it
    import jn_cuclark_tpu.utils.memory as mem

    monkeypatch.setattr(
        mem, "auto_db_cycles", lambda *a, **kw: (3, 128 << 20)
    )
    clf = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    assert clf.db_cycles == 1
    assert getattr(clf, "dense_table", None) is not None
    assert "dense two-choice" in capsys.readouterr().err
    got = b"".join(clf.classify_bytes(fa)[0])
    assert got == want


def test_auto_policy_falls_back_to_cycling(db, monkeypatch):
    tmp_path, prof, targets, fa = db
    plan = BatchPlan(max_reads=64, window_budget=1 << 13)
    monkeypatch.delenv("CLARK_TPU_DEVICE_MEM_BYTES", raising=False)
    ref = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    want = b"".join(ref.classify_bytes(fa)[0])
    # budget too small even for the dense layout -> cycling proceeds
    import jn_cuclark_tpu.utils.memory as mem

    monkeypatch.setattr(
        mem, "auto_db_cycles", lambda *a, **kw: (3, 1 << 10)
    )
    clf = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    assert clf.db_cycles == 3
    assert getattr(clf, "dense_table", None) is None
    got = b"".join(clf.classify_bytes(fa)[0])
    assert got == want


def test_dense_cache_roundtrip(tmp_path):
    rng = np.random.default_rng(9)
    keys = np.unique(rng.integers(1, 1 << 44, size=10000,
                                  dtype=np.uint64))[:5000]
    labels1 = rng.integers(1, 30, size=len(keys)).astype(np.int32)
    t = radix_table.build_dense(keys, labels1)
    p = str(tmp_path / "d.npz")
    sig = np.array([1, 2, 3], dtype=np.int64)
    radix_table.save_dense_cache(p, t, signature=sig)
    back = radix_table.load_dense_cache(p, signature=sig)
    assert back is not None
    np.testing.assert_array_equal(back.slots1, t.slots1)
    np.testing.assert_array_equal(back.slots2, t.slots2)
    assert (back.m1, back.m2, back.lb) == (t.m1, t.m2, t.lb)
    # signature mismatch -> rebuild
    assert radix_table.load_dense_cache(
        p, signature=np.array([9, 9, 9], dtype=np.int64)
    ) is None
