"""Sharded-DB classification over a virtual 8-device mesh must produce
identical results to the single-device path."""

import numpy as np
import pytest

import jax

from jn_cuclark_tpu import params
from jn_cuclark_tpu.db import builder
from jn_cuclark_tpu.engine import BatchPlan, Classifier
from jn_cuclark_tpu.io.targets import parse_targets
from jn_cuclark_tpu.parallel.mesh import make_mesh

from . import oracle
from .test_builder import rand_seq, write_fasta

K = 9


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("meshdb")
    rng = np.random.default_rng(9)
    genomes = [rand_seq(rng, 600) for _ in range(4)]
    with open(tmp_path / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = tmp_path / f"g{i}.fa"
            write_fasta(p, [(f"g{i}", g)])
            tf.write(f"{p} {2000 + i}\n")
    prof = params.tiny(htsize=4093, k=K)
    targets = parse_targets(str(tmp_path / "targets.txt"))
    builder.build_database(targets, str(tmp_path), prof, K)
    reads = []
    for i in range(200):
        g = genomes[i % 4]
        pos = rng.integers(0, len(g) - 80)
        reads.append((f"r{i}", g[pos : pos + 80]))
    fa = "".join(f">{n}\n{s}\n" for n, s in reads).encode()
    return tmp_path, prof, targets, fa


def test_mesh_matches_single(db):
    tmp_path, prof, targets, fa = db
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    plan = BatchPlan(max_queries=1 << 14, max_reads=256)
    single = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    rows1 = oracle.rows(single.classify_bytes(fa)[0])

    mesh = make_mesh()
    sharded = Classifier.load(str(tmp_path), targets, prof, K, plan=plan, mesh=mesh)
    rows8 = oracle.rows(sharded.classify_bytes(fa)[0])
    assert rows1 == rows8


def test_mesh_subset_devices(db):
    tmp_path, prof, targets, fa = db
    plan = BatchPlan(max_queries=1 << 14, max_reads=256)
    single = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    rows1 = oracle.rows(single.classify_bytes(fa)[0])
    mesh = make_mesh(n_devices=3)
    sharded = Classifier.load(str(tmp_path), targets, prof, K, plan=plan, mesh=mesh)
    assert rows1 == oracle.rows(sharded.classify_bytes(fa)[0])


def test_dp_mode_matches_single(db):
    """Read-sharded (data-parallel) mesh mode must match single-device."""
    tmp_path, prof, targets, fa = db
    plan = BatchPlan(window_budget=1 << 14)
    single = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    rows1 = oracle.rows(single.classify_bytes(fa)[0])
    for nd in (8, 3):
        mesh = make_mesh(nd)
        dp = Classifier.load(
            str(tmp_path), targets, prof, K, plan=plan, mesh=mesh, mesh_mode="dp"
        )
        assert rows1 == oracle.rows(dp.classify_bytes(fa)[0]), f"ndev={nd}"
    # extended mode through dp
    ext1 = oracle.rows(single.classify_bytes(fa, extended=True)[0])
    dp = Classifier.load(
        str(tmp_path), targets, prof, K, plan=plan, mesh=make_mesh(4), mesh_mode="dp"
    )
    assert ext1 == oracle.rows(dp.classify_bytes(fa, extended=True)[0])


def test_db_sharded_matches_single(db):
    """DB-sharded mesh mode (the multi-process-capable path): byte-equal CSV
    incl. extended counts, on 8 and 3 devices."""
    tmp_path, prof, targets, fa = db
    plan = BatchPlan(window_budget=1 << 14)
    single = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    rows1 = oracle.rows(single.classify_bytes(fa)[0])
    ext1 = oracle.rows(single.classify_bytes(fa, extended=True)[0])
    for nd in (8, 3):
        sh = Classifier.load(
            str(tmp_path), targets, prof, K, plan=plan,
            mesh=make_mesh(nd), mesh_mode="db",
        )
        assert rows1 == oracle.rows(sh.classify_bytes(fa)[0]), f"ndev={nd}"
        assert ext1 == oracle.rows(sh.classify_bytes(fa, extended=True)[0])


def test_db_sharded_with_cycles(db):
    """Out-of-core cycling composed with the sharded mesh (HBM holds
    1/(P*cycles) of the table per step) must still be byte-identical."""
    tmp_path, prof, targets, fa = db
    plan = BatchPlan(window_budget=1 << 14)
    single = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    rows1 = oracle.rows(single.classify_bytes(fa)[0])
    sh = Classifier.load(
        str(tmp_path), targets, prof, K, plan=plan,
        mesh=make_mesh(4), mesh_mode="db", db_cycles=3,
    )
    assert rows1 == oracle.rows(sh.classify_bytes(fa)[0])
    ext1 = oracle.rows(single.classify_bytes(fa, extended=True)[0])
    assert ext1 == oracle.rows(sh.classify_bytes(fa, extended=True)[0])


def test_db_shard_work_balance():
    """Per-device key ownership under the Fibonacci mix is near-uniform —
    the design-level load-balance evidence for the >=80% scaling bar (each
    device probes every query against its rows; time ~ resident keys).
    Recorded numbers live in docs/MULTICHIP.md."""
    from jn_cuclark_tpu.ops import radix_table

    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(1, 1 << 54, size=120_000, dtype=np.uint64))
    labels1 = rng.integers(1, 100, size=len(keys)).astype(np.int32)
    plan = radix_table.plan_table(keys, labels1)
    ndev = 8
    rpd = -(-plan.n_rows // ndev)
    dev_of_key = np.minimum(plan.bucket // rpd, ndev - 1)
    per_dev = np.bincount(dev_of_key, minlength=ndev)
    mean = per_dev.mean()
    imbalance = per_dev.max() / mean
    assert imbalance < 1.02, f"key imbalance {imbalance:.3f}: {per_dev}"


def test_dp_shard_work_balance(db):
    """dp mode pads the batch to a multiple of the device count, so per-device
    read rows are exactly equal by construction."""
    tmp_path, prof, targets, fa = db
    mesh = make_mesh(8)
    ndev = mesh.devices.size
    from jn_cuclark_tpu.ops import radix_table as rt
    import jax.numpy as jnp

    from jn_cuclark_tpu.parallel.mesh import shard_reads

    rng = np.random.default_rng(12)
    keys = np.unique(rng.integers(1, 1 << 54, size=4096, dtype=np.uint64))
    labels1 = rng.integers(1, 10, size=len(keys)).astype(np.int32)
    table = rt.build(keys, labels1)
    _, batch_fn = shard_reads(mesh, table, 9, k=K)
    words = jnp.zeros((100, 5), jnp.uint64)  # 100 % 8 != 0 -> pads to 104
    vwords = jnp.zeros((100, 3), jnp.uint64)
    out = batch_fn(words, vwords, extended=False)
    total = out[0]
    assert total.shape[0] == 104
    shard_rows = {s.data.shape[0] for s in total.addressable_shards}
    assert shard_rows == {104 // ndev}


def test_dpdb_2d_mesh_matches_single(db):
    """2-D composition (reads sharded over 'dp' x table rows over 'db'):
    byte-equal CSV incl. extended, at 4x2 and 2x4."""
    from jn_cuclark_tpu.parallel.mesh import make_mesh2d

    tmp_path, prof, targets, fa = db
    plan = BatchPlan(window_budget=1 << 14)
    single = Classifier.load(str(tmp_path), targets, prof, K, plan=plan)
    rows1 = oracle.rows(single.classify_bytes(fa)[0])
    ext1 = oracle.rows(single.classify_bytes(fa, extended=True)[0])
    for dp, ndb in ((4, 2), (2, 4)):
        m = make_mesh2d(dp, ndb)
        clf = Classifier.load(str(tmp_path), targets, prof, K, plan=plan, mesh=m)
        assert rows1 == oracle.rows(clf.classify_bytes(fa)[0]), (dp, ndb)
        assert ext1 == oracle.rows(
            clf.classify_bytes(fa, extended=True)[0]
        ), (dp, ndb)


def test_db_sharded_cycles_labels_strategy(db):
    """The O(windows) labels strategy composes with the sharded mesh
    (per-window label grids psum across shards, then concatenate across
    cycles) — byte-identical to counts and to single-device."""
    tmp_path, prof, targets, fa = db
    plan = lambda s: BatchPlan(window_budget=1 << 14, cycle_strategy=s)
    single = Classifier.load(
        str(tmp_path), targets, prof, K, plan=plan("counts")
    )
    rows1 = oracle.rows(single.classify_bytes(fa)[0])
    ext1 = oracle.rows(single.classify_bytes(fa, extended=True)[0])
    for strategy in ("labels", "counts"):
        sh = Classifier.load(
            str(tmp_path), targets, prof, K, plan=plan(strategy),
            mesh=make_mesh(4), mesh_mode="db", db_cycles=3,
        )
        assert rows1 == oracle.rows(sh.classify_bytes(fa)[0]), strategy
        assert ext1 == oracle.rows(
            sh.classify_bytes(fa, extended=True)[0]
        ), strategy


def test_sorted_runs_extended_on_meshes(db):
    """Extended mode on meshes ships the sorted u16 label grid (O(windows)
    fetch) instead of a dense [R, T+1] count matrix — same device step as
    non-extended at any target count.  Checks the
    engine's gate engages and the mesh batch_fns' "sorted" outputs agree
    with their dense-counts outputs."""
    import jax.numpy as jnp

    from jn_cuclark_tpu.parallel.mesh import make_mesh2d
    from jn_cuclark_tpu.utils import native as _native

    if not _native.available():
        pytest.skip("native runtime unavailable")
    tmp_path, prof, targets, fa = db
    plan = BatchPlan(window_budget=1 << 14)
    for mesh, mode in (
        (make_mesh(4), "dp"),
        (make_mesh(4), "db"),
        (make_mesh2d(2, 2), "dp"),
    ):
        clf = Classifier.load(
            str(tmp_path), targets, prof, K, plan=plan, mesh=mesh,
            mesh_mode=mode,
        )
        words = jnp.zeros((8, 3), jnp.uint64)  # stride 64
        vwords = jnp.zeros((8, 2), jnp.uint64)
        t_s, ib_s, b_s, sb_s, runs = clf.batch_fn(
            words, vwords, extended="sorted"
        )
        t_d, ib_d, b_d, sb_d, counts = clf.batch_fn(
            words, vwords, extended=True
        )
        assert np.asarray(runs).dtype == np.uint16
        assert np.asarray(runs).shape[1] > 1  # the window grid, not [R, T+1]
        for a, b in ((t_s, t_d), (ib_s, ib_d), (b_s, b_d), (sb_s, sb_d)):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_dryrun_multichip_raises_when_devices_are_short():
    """No silent platform switch: asking for more devices than exist is an
    error."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from __graft_entry__ import dryrun_multichip

    with pytest.raises(RuntimeError, match="needs 16 devices"):
        dryrun_multichip(2 * len(jax.devices()))


@pytest.mark.parametrize("mode", ["db", "dp", "dpdb"])
def test_table_reaches_each_device_from_the_host(db, monkeypatch, mode):
    """Loading a mesh never commits a host array to the default device
    first: every device_put of the table, stash or cycle index takes the
    host array, so device 0 holds no more than its own share."""
    from jn_cuclark_tpu.parallel.mesh import make_mesh2d

    tmp_path, prof, targets, fa = db
    staged = []
    put = jax.device_put

    def spy(x, *a, **kw):
        if isinstance(x, jax.Array):
            staged.append(x.shape)
        return put(x, *a, **kw)

    monkeypatch.setattr(jax, "device_put", spy)
    mesh = make_mesh2d(2, 2) if mode == "dpdb" else make_mesh(4)
    clf = Classifier.load(
        str(tmp_path), targets, prof, K, plan=BatchPlan(window_budget=1 << 14),
        mesh=mesh, mesh_mode="db" if mode == "db" else "dp",
    )
    assert staged == []
    monkeypatch.setattr(jax, "device_put", put)
    single = Classifier.load(
        str(tmp_path), targets, prof, K, plan=BatchPlan(window_budget=1 << 14)
    )
    assert oracle.rows(clf.classify_bytes(fa)[0]) == oracle.rows(
        single.classify_bytes(fa)[0]
    )
