"""Automatic device-memory budgeting (CuClarkDB.cu:526-565, 178-181 parity).

The reference sizes DB parts x cycles from free device memory minus
RESERVED and refuses below a 200 MB floor; here `db_cycles="auto"` (the
default) derives the cycle count so each resident table chunk fits the
device budget, and a classify of an oversized table succeeds with no flags.
CLARK_TPU_DEVICE_MEM_BYTES fakes the device limit for these tests.
"""

import numpy as np
import pytest

from jn_cuclark_tpu import params
from jn_cuclark_tpu.db import builder
from jn_cuclark_tpu.engine import BatchPlan, Classifier
from jn_cuclark_tpu.io.targets import parse_targets
from jn_cuclark_tpu.utils import memory

from .test_builder import rand_seq, write_fasta

K = 9


def test_auto_cycles_math(monkeypatch):
    monkeypatch.setenv("CLARK_TPU_DEVICE_MEM_BYTES", str(16 << 30))
    trans = memory.probe_transient_bytes(1 << 23)
    budget = (16 << 30) - memory.RESERVED - trans
    # table smaller than budget -> one cycle
    assert memory.auto_db_cycles(budget - 1, 1 << 23) == (1, budget)
    # 2.5x budget -> cycling engages; double-buffered uploads keep two
    # chunks resident, so each chunk fits half the budget -> 5 cycles
    cycles, b = memory.auto_db_cycles(
        int(budget * 2.5), 1 << 23
    )
    assert cycles == 5 and b == budget
    # with prefetch disabled one chunk is resident -> 3 cycles
    monkeypatch.setenv("CLARK_TPU_PREFETCH_CHUNKS", "0")
    cycles, b = memory.auto_db_cycles(
        int(budget * 2.5), 1 << 23
    )
    assert cycles == 3 and b == budget
    monkeypatch.delenv("CLARK_TPU_PREFETCH_CHUNKS")
    # sharding divides the per-device need
    cycles, _ = memory.auto_db_cycles(
        int(budget * 2.5), 1 << 23, n_shards=4
    )
    assert cycles == 1


def test_auto_cycles_floor(monkeypatch):
    # device smaller than RESERVED + transients + floor -> actionable error
    monkeypatch.setenv("CLARK_TPU_DEVICE_MEM_BYTES", str(1 << 30))
    with pytest.raises(RuntimeError, match="--shard-db|CLARK_TPU_DEVICE_MEM"):
        memory.auto_db_cycles(1 << 30, 1 << 23)


def test_device_memory_limit_env(monkeypatch):
    monkeypatch.setenv("CLARK_TPU_DEVICE_MEM_BYTES", "12345678")
    assert memory.device_memory_limit() == 12345678


def test_device_memory_limit_cpu(monkeypatch):
    monkeypatch.delenv("CLARK_TPU_DEVICE_MEM_BYTES", raising=False)
    # CPU devices have no accelerator limit -> None (no auto-cycling)
    assert memory.device_memory_limit() is None


class _FakeDevice:
    platform = "gpu"
    device_kind = "Fake Accelerator"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_device_memory_limit_unsized_accelerator_raises(monkeypatch, stats):
    """An accelerator that reports no memory limit is an error: guessing
    (or returning None, which disables auto-cycling) would turn an
    over-budget DB into a raw out-of-memory crash."""
    monkeypatch.delenv("CLARK_TPU_DEVICE_MEM_BYTES", raising=False)
    with pytest.raises(RuntimeError, match="reports no memory limit"):
        memory.device_memory_limit(_FakeDevice(stats))


def test_device_memory_limit_from_stats(monkeypatch):
    monkeypatch.delenv("CLARK_TPU_DEVICE_MEM_BYTES", raising=False)
    dev = _FakeDevice({"bytes_limit": 60 << 30, "bytes_in_use": 1})
    assert memory.device_memory_limit(dev) == 60 << 30


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("mb")
    rng = np.random.default_rng(11)
    genomes = [rand_seq(rng, 800) for _ in range(3)]
    with open(tmp_path / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = tmp_path / f"g{i}.fa"
            write_fasta(p, [(f"g{i}", g)], width=60)
            tf.write(f"{p} {3000 + i}\n")
    prof = params.tiny(htsize=4093, k=K)
    targets = parse_targets(str(tmp_path / "targets.txt"))
    builder.build_database(targets, str(tmp_path), prof, K)
    reads = []
    for i in range(120):
        g = genomes[i % 3]
        ln = int(rng.integers(30, 200))
        pos = rng.integers(0, max(len(g) - ln, 1))
        reads.append((f"r{i}", g[pos : pos + ln]))
    fa = "".join(f">{n}\n{s}\n" for n, s in reads).encode()
    return tmp_path, prof, targets, fa


def test_oversized_table_autocycles_no_flags(db, monkeypatch, capsys):
    tmp_path, prof, targets, fa = db
    plan = BatchPlan(max_reads=64, window_budget=1 << 13)
    # reference output with an unconstrained device
    monkeypatch.delenv("CLARK_TPU_DEVICE_MEM_BYTES", raising=False)
    ref = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    assert ref.db_cycles == 1
    want = b"".join(ref.classify_bytes(fa)[0])
    # the 200 MB hard floor makes a REAL table-doesn't-fit limit unbuildable
    # at test scale, so fake the budget decision and assert the WIRING
    # (load -> auto_db_cycles -> chunked out-of-core path, message, output)
    import jn_cuclark_tpu.utils.memory as mem

    monkeypatch.setattr(
        mem, "auto_db_cycles", lambda *a, **kw: (3, 12345 << 20)
    )
    # pin the CYCLING path: with a 12 GB fake budget the dense two-choice
    # residency would (correctly) preempt cycling — tested in
    # test_dense_table.py
    monkeypatch.setenv("CLARK_TPU_DENSE", "0")
    clf = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    assert clf.db_cycles == 3  # chosen automatically, no flags
    got = b"".join(clf.classify_bytes(fa)[0])
    assert got == want
    assert "loading in 3 cycles" in capsys.readouterr().err


def test_explicit_cycles_still_win(db, monkeypatch):
    tmp_path, prof, targets, fa = db
    plan = BatchPlan(max_reads=64, window_budget=1 << 13)
    monkeypatch.setenv("CLARK_TPU_DEVICE_MEM_BYTES", str(64 << 30))
    clf = Classifier.load(
        str(tmp_path), targets, prof, K, plan=plan, db_cycles=2
    )
    assert clf.db_cycles == 2


def test_chunk_prefetch_byte_equal(db, monkeypatch):
    """Double-buffered chunk uploads (worker-thread device_put of chunk
    j+1 during pass j, swapDbParts-overlap parity CuClarkDB.cu:776-815)
    must not change output: cycled CSVs byte-equal with prefetch on/off,
    on the host-chunked AND the mesh-sharded cycled paths."""
    from jn_cuclark_tpu.parallel.mesh import make_mesh

    tmp_path, prof, targets, fa = db
    plan = BatchPlan(max_reads=64, window_budget=1 << 13)
    outs = {}
    for pf in ("1", "0"):
        monkeypatch.setenv("CLARK_TPU_PREFETCH_CHUNKS", pf)
        clf = Classifier.load(
            str(tmp_path), targets, prof, K, plan=plan, db_cycles=3
        )
        outs[("host", pf)] = b"".join(clf.classify_bytes(fa)[0])
        sh = Classifier.load(
            str(tmp_path), targets, prof, K, plan=plan, db_cycles=3,
            mesh=make_mesh(4), mesh_mode="db",
        )
        outs[("mesh", pf)] = b"".join(sh.classify_bytes(fa)[0])
    assert outs[("host", "1")] == outs[("host", "0")]
    assert outs[("mesh", "1")] == outs[("mesh", "0")]
    assert outs[("host", "1")] == outs[("mesh", "1")]


@pytest.mark.parametrize("dense", ["0", "force"])
def test_dropped_classifier_frees_at_once(db, monkeypatch, dense):
    """A Classifier is in no reference cycle, so dropping it releases its
    device table at once rather than at some later garbage collection."""
    import gc
    import weakref

    tmp_path, prof, targets, fa = db
    monkeypatch.setenv("CLARK_TPU_DENSE", dense)
    clf = Classifier.load(
        str(tmp_path), targets, prof, K,
        plan=BatchPlan(max_reads=64, window_budget=1 << 13),
    )
    clf.classify_bytes(fa)
    ref = weakref.ref(clf)
    gc.disable()
    try:
        del clf
        assert ref() is None
    finally:
        gc.enable()
