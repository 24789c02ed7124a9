"""Database sharding over a JAX device mesh.

Replacement for the reference's multi-GPU DB partitioning + P2P result
merging (CuClarkDB.cu:526-565, 842-928): the sorted canonical-key index is
split into equal contiguous shards over a one-axis mesh ("db"); every device
searches the full query batch against its shard (a query hits in at most one
shard) and the per-query label is merged with a `psum` over the device
interconnect instead of peer-to-peer memcpy merge trees.  Scoring then
proceeds replicated on every device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import lookup, score


def shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


class ShardedRadixTable:
    """DB-sharded classification over a (possibly multi-host) mesh axis,
    optionally composed with out-of-core cycling.

    The successor to BOTH the reference's multi-GPU DB
    partitioning (CuClarkDB.cu:526-565: hash range split across devices,
    P2P result-merge trees) and its swapDbParts out-of-core cycling
    (CuClarkDB.cu:776-815) — and strictly stronger than kent-mpi's
    multi-node story (kent_mpi.cpp:508-631, which never shards the DB):

      * the table plan (row count, label packing, stash) is a pure function
        of the key set, so every PROCESS derives it independently and fills
        ONLY the rows its local devices own (1/P of the table in host RAM,
        1/(P*cycles) in HBM);
      * per-cycle global arrays are assembled with
        jax.make_array_from_single_device_arrays — each process contributes
        only its addressable shards, which is exactly the multi-process JAX
        contract (works identically with one process on a virtual mesh);
      * every device probes the full (replicated) window batch against its
        resident rows; a key lives in exactly one row, so per-read partial
        counts are disjoint and one `psum` over the mesh axis (NVLink within
        a host, the network across hosts) yields the global count matrix —
        replacing the reference's cudaMemcpyPeer merge trees and MPI result
        sends;
      * with db_cycles > 1 the per-device row range is streamed to HBM in
        `db_cycles` chunks; the engine accumulates per-read counts across
        cycles host-side (the reference's host-row merge).
    """

    def __init__(self, mesh: Mesh, keys, labels1, n_targets: int, k: int,
                 db_cycles: int | str = 1, window_budget: int = 1 << 23):
        from ..ops import radix_table

        self.mesh = mesh
        if len(mesh.axis_names) == 2:
            # 2-D composition: table rows over the LAST axis ('db'), read
            # rows over the first ('dp').  With make_mesh2d's column-major
            # layout the db axis crosses process boundaries (network) and dp
            # stays within a process, so each device probes only 1/ndp of
            # the batch against 1/ndb of the table.
            self.axis_dp, self.axis = mesh.axis_names
            self.ndp, self.ndb = mesh.devices.shape
        else:
            self.axis_dp = None
            self.axis = mesh.axis_names[0]
            self.ndp, self.ndb = 1, mesh.devices.size
        self.n_targets = n_targets
        self.k = k

        keys = np.asarray(keys, dtype=np.uint64)
        labels1 = np.asarray(labels1, dtype=np.int32)
        plan = radix_table.plan_table(keys, labels1, k=k)
        self.meta = plan.meta
        self.m1, self.lb, self.c = plan.m1, plan.lb, plan.c
        if db_cycles in ("auto", 0, None):
            # reference: parts x cycles from free device memory minus
            # RESERVED (CuClarkDB.cu:526-565) — here per-shard chunk bytes
            # must fit each device's budget
            from ..utils.memory import auto_db_cycles

            db_cycles, _ = auto_db_cycles(
                plan.n_rows * plan.c * 8,
                window_budget,
                n_shards=self.ndb,
                device=mesh.devices.reshape(-1)[0],
            )
        self.n_cycles = db_cycles = int(db_cycles)
        # rows per db shard, divisible by the cycle count
        rpd = -(-plan.n_rows // self.ndb)
        rpd = -(-rpd // db_cycles) * db_cycles
        self.rpd = rpd
        self.rpc = rpd // db_cycles  # rows per (db shard, cycle)

        pid = jax.process_index()
        # local devices with their (dp, db) coordinates
        if self.axis_dp is None:
            coords = [((0, j), d) for j, d in enumerate(mesh.devices.reshape(-1))]
        else:
            coords = [
                ((i, j), mesh.devices[i, j])
                for i in range(self.ndp)
                for j in range(self.ndb)
            ]
        self.local = [(c, d) for c, d in coords if d.process_index == pid]
        if not self.local:
            raise ValueError("mesh contains no devices of this process")
        # host-side chunks: fill only row ranges owned by local devices
        # (one fill per distinct local db coordinate; dp replicas share it)
        self._host = []  # [cycle] -> {db_coord: (slots, labels)}
        local_dbs = sorted({j for (_, j), _ in self.local})
        for cyc in range(db_cycles):
            chunks = {}
            for j in local_dbs:
                r0 = j * rpd + cyc * self.rpc
                chunks[j] = radix_table.fill_rows(
                    keys, labels1, plan, r0, r0 + self.rpc
                )
            self._host.append(chunks)
        self.shard = NamedSharding(mesh, P(self.axis))
        self.repl = NamedSharding(mesh, P())
        self._sk = self._replicated(np.asarray(plan.stash_keys))
        self._sl = self._replicated(np.asarray(plan.stash_labels))
        self._fns = {}
        self._cur = None  # (cycle, slots_global, labels_global)
        if db_cycles == 1:
            self.begin_cycle(0)  # resident table, uploaded once

    # ------------------------------------------------------ array assembly
    # host arrays go straight to each device: staging them through
    # jnp.asarray would first commit the whole array to the default device
    def _replicated(self, x):
        arrs = [jax.device_put(x, d) for _, d in self.local]
        return jax.make_array_from_single_device_arrays(
            x.shape, self.repl, arrs
        )

    def _cycle_global(self, cyc):
        slots_shape = (self.ndb * self.rpc, 2 * self.c)  # u32 halves rows
        sarrs = [
            jax.device_put(self._host[cyc][dbc][0], d)
            for (_, dbc), d in self.local
        ]
        slots = jax.make_array_from_single_device_arrays(
            slots_shape, self.shard, sarrs
        )
        # labels are always packed in the slots (quotient storage); a dummy
        # sharded placeholder keeps the shard_map signature uniform
        larrs = [
            jax.device_put(np.zeros((1, 1), np.uint32), d)
            for _, d in self.local
        ]
        labels = jax.make_array_from_single_device_arrays(
            (self.ndb, 1), self.shard, larrs
        )
        return slots, labels

    def _feed(self, x):
        """Place one host batch array: replicated on a 1-D mesh; row-sharded
        over 'dp' (padded to a multiple of ndp) on a 2-D mesh — every process
        holds the identical host batch, so each fills its own devices'
        slices."""
        if self.axis_dp is None:
            return self._replicated(x)
        x = np.asarray(x)
        r = (-x.shape[0]) % self.ndp
        if r:
            x = np.concatenate([x, np.zeros((r,) + x.shape[1:], x.dtype)])
        rloc = x.shape[0] // self.ndp
        arrs = [
            jax.device_put(x[dpc * rloc : (dpc + 1) * rloc], d)
            for (dpc, _), d in self.local
        ]
        return jax.make_array_from_single_device_arrays(
            x.shape, NamedSharding(self.mesh, P(self.axis_dp)), arrs
        )

    # ----------------------------------------------------------- execution
    def _fn(self, kind, probe_cols=None):
        key = (kind, probe_cols)
        if key in self._fns:
            return self._fns[key]
        from ..ops import device_pipeline, radix_table, score

        axis, k = self.axis, self.k
        axis_dp = self.axis_dp
        m1, lb, c = self.m1, self.lb, self.c
        rpd, rpc = self.rpd, self.rpc
        n_targets = self.n_targets

        def local_counts(slots_blk, lab_blk, sk, sl, words, vwords, cycle):
            canon, valid = device_pipeline.window_canonicals(
                words, vwords, k, probe_cols
            )
            q = jnp.where(valid, canon, radix_table.EMPTY).ravel()
            d = jax.lax.axis_index(axis)
            start = d * rpd + cycle * rpc
            lab = radix_table.probe_chunk(
                slots_blk, lab_blk.reshape(-1), sk, sl, q, start,
                m1=m1, lb=lb, c=c,
                use_stash=(d == 0) & (cycle == 0),
            )
            lab = jnp.where(valid.ravel(), lab, 0)
            R, S = valid.shape
            rid = jnp.repeat(jnp.arange(R, dtype=jnp.int32), S)
            counts = score.counts_from_hits(lab, rid, R, n_targets)
            counts = jax.lax.psum(counts, axis)
            # every shard counts its own misses into column 0; restore the
            # single-device convention (col0 = windows - hits) exactly
            col0 = S - jnp.sum(counts[:, 1:], axis=1)
            return counts.at[:, 0].set(col0.astype(counts.dtype))

        def local_labels(slots_blk, lab_blk, sk, sl, words, vwords, cycle):
            """Per-window (label+1), merged across shards with one psum —
            a key lives in exactly one shard (and the stash is gated to
            shard 0), so per-shard labels are disjoint and add."""
            canon, valid = device_pipeline.window_canonicals(
                words, vwords, k, probe_cols
            )
            q = jnp.where(valid, canon, radix_table.EMPTY).ravel()
            d = jax.lax.axis_index(axis)
            start = d * rpd + cycle * rpc
            lab = radix_table.probe_chunk(
                slots_blk, lab_blk.reshape(-1), sk, sl, q, start,
                m1=m1, lb=lb, c=c,
                use_stash=(d == 0) & (cycle == 0),
            )
            lab = jnp.where(valid.ravel(), lab, 0)
            lab = jax.lax.psum(lab, axis)
            return lab.reshape(valid.shape)

        # 2-D mode: batch in and per-read results out stay sharded over 'dp'
        # (with make_mesh2d's column layout every process holds every dp
        # shard, so np.asarray on the outputs works on all processes)
        row_spec = P() if axis_dp is None else P(axis_dp)
        if kind == "counts":
            f = local_counts
            out_specs = row_spec
        elif kind == "labels":
            # out-of-core labels strategy (engine cycle_strategy="labels"):
            # the merged per-window label grid itself, uint16-packed when
            # the target count allows — O(windows) per cycle instead of
            # O(targets), which dense counts need
            narrow = n_targets < 65535

            def f(slots_blk, lab_blk, sk, sl, words, vwords, cycle):
                lab = local_labels(
                    slots_blk, lab_blk, sk, sl, words, vwords, cycle
                )
                return lab.astype(jnp.uint16) if narrow else lab

            out_specs = row_spec
        elif kind == "classify_top2":
            # non-extended fast path: skip the dense count matrix entirely
            def f(slots_blk, lab_blk, sk, sl, words, vwords, cycle):
                lab = local_labels(
                    slots_blk, lab_blk, sk, sl, words, vwords, cycle
                )
                total, ib, b_, isb, sb = score.top2_from_labels(lab)
                return total, ib, b_, sb, jnp.zeros(
                    (lab.shape[0], 0), jnp.int32
                )

            out_specs = (row_spec,) * 5
        elif kind == "classify_sorted":
            # sorted-runs extended: psum the per-window label grid over the
            # db axis (disjoint shards), sort rows on device, ship u16 runs
            # — extended mode costs the same device step and fetch as
            # non-extended at ANY target count, replacing the dense
            # [R, T+1] psum the counts kind pays
            def f(slots_blk, lab_blk, sk, sl, words, vwords, cycle):
                lab = local_labels(
                    slots_blk, lab_blk, sk, sl, words, vwords, cycle
                )
                s = jax.lax.sort(lab, dimension=1)
                total, ib, b_, isb, sb = score.top2_from_sorted(s)
                return total, ib, b_, sb, s.astype(jnp.uint16)

            out_specs = (row_spec,) * 5
        else:

            def f(slots_blk, lab_blk, sk, sl, words, vwords, cycle):
                counts = local_counts(
                    slots_blk, lab_blk, sk, sl, words, vwords, cycle
                )
                total, ib, b_, isb, sb = score.read_results(counts)
                return total, ib, b_, sb, counts

            out_specs = (row_spec,) * 5

        jfn = jax.jit(
            shard_map(
                f,
                self.mesh,
                in_specs=(
                    P(self.axis), P(self.axis), P(), P(),
                    row_spec, row_spec, P(),
                ),
                out_specs=out_specs,
            )
        )
        self._fns[key] = jfn
        return jfn

    def _upload_cycle(self, j: int):
        slots, labels = self._cycle_global(j)
        cyc = self._replicated(np.int32(j))
        jax.block_until_ready(slots)
        return (j, slots, labels, cyc)

    def begin_cycle(self, j: int, kind: str = "counts"):
        """Upload cycle j's row chunks; returns fn(words, vwords) producing
        per-read counts (kind="counts") or the merged per-window label grid
        (kind="labels").

        Cycle j+1's chunks upload in a worker thread while cycle j's
        batches probe (swapDbParts overlap, CuClarkDB.cu:776-815); two
        chunks are resident at the overlap peak, which auto_db_cycles
        budgets for.  CLARK_TPU_PREFETCH_CHUNKS=0 disables."""
        import os
        import threading

        pre = getattr(self, "_pre", None)
        if pre is not None and pre["j"] == j:
            pre["thread"].join()
            status, payload = pre["out"]
            self._pre = None
            if status == "err":
                raise payload
            self._cur = payload
        elif self._cur is None or self._cur[0] != j:
            self._cur = self._upload_cycle(j)
        if (
            j + 1 < self.n_cycles
            and getattr(self, "_pre", None) is None
            and os.environ.get("CLARK_TPU_PREFETCH_CHUNKS", "1") != "0"
        ):
            pre = {"j": j + 1, "out": None}

            def work(nj=j + 1):
                try:
                    pre["out"] = ("ok", self._upload_cycle(nj))
                except BaseException as e:  # re-raised at next join
                    pre["out"] = ("err", e)

            pre["thread"] = threading.Thread(target=work, daemon=True)
            pre["thread"].start()
            self._pre = pre

        def pass_fn(words, vwords, probe_cols=None):
            _, slots, labels, cyc = self._cur
            return self._fn(kind, probe_cols)(
                slots, labels, self._sk, self._sl,
                self._feed(words), self._feed(vwords), cyc,
            )

        return pass_fn

    def end_cycle(self):
        if self.n_cycles > 1:
            self._cur = None  # free HBM before the next cycle's upload

    def classify(self, words, vwords, extended=True, probe_cols=None):
        """Single-cycle full batch step: (total, ibest, best, sbest, counts),
        replicated on every device/process.  extended="sorted" returns the
        sorted u16 label grid as the 5th output (sorted-runs extended)."""
        assert self.n_cycles == 1
        if extended == "sorted":
            kind = "classify_sorted"
        else:
            kind = "classify" if extended else "classify_top2"
        _, slots, labels, cyc = self._cur
        return self._fn(kind, probe_cols)(
            slots, labels, self._sk, self._sl,
            self._feed(words), self._feed(vwords), cyc,
        )


def shard_reads(mesh: Mesh, table, n_targets: int, k: int):
    """Data-parallel mode: DB replicated, READ ROWS sharded over the mesh.

    This is the throughput-scaling mode (the row-gather probe costs ~15ns per
    QUERY regardless of table size, so splitting the queries divides device
    time by P, while splitting the DB does not).  Equivalent to the
    reference's multi-node sample parallelism (kent-mpi), but within one
    batch over NVLink.  No collectives: every read's windows live on one device;
    outputs come back row-sharded.
    """
    from ..ops import device_pipeline, radix_table, score

    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    repl = NamedSharding(mesh, P())
    rows = NamedSharding(mesh, P(axis))
    # host arrays straight to the mesh (see ShardedRadixTable._replicated)
    slots_d = jax.device_put(table.slots, repl)
    lab_d = jax.device_put(table.labels, repl)
    sk_d = jax.device_put(table.stash_keys, repl)
    sl_d = jax.device_put(table.stash_labels, repl)
    meta = table.meta

    jfns = {}

    def _jfn(extended, probe_cols):
        key = (extended, probe_cols)
        if key not in jfns:

            def local_fn(slots, labels, sk, sl, words, vwords):
                return device_pipeline.classify_batch(
                    slots, labels, sk, sl, words, vwords,
                    k=k, n_targets=n_targets, extended=extended,
                    probe_cols=probe_cols, **meta,
                )

            jfns[key] = jax.jit(
                shard_map(
                    local_fn,
                    mesh,
                    in_specs=(P(), P(), P(), P(), P(axis), P(axis)),
                    out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
                )
            )
        return jfns[key]

    def batch_fn(words, vwords, extended=True, probe_cols=None):
        r = (-words.shape[0]) % ndev
        if r:
            words = jnp.concatenate(
                [words, jnp.zeros((r, words.shape[1]), jnp.uint64)]
            )
            vwords = jnp.concatenate(
                [vwords, jnp.zeros((r, vwords.shape[1]), jnp.uint64)]
            )
        words = jax.device_put(words, rows)
        vwords = jax.device_put(vwords, rows)
        return _jfn(extended, probe_cols)(
            slots_d, lab_d, sk_d, sl_d, words, vwords
        )

    return (slots_d, lab_d), batch_fn


def shard_reads_db(mesh: Mesh, table, n_targets: int, k: int):
    """2-D composition: table rows sharded over the 'db' axis AND read rows
    sharded over the 'dp' axis of one mesh — capacity x throughput at once
    (each device holds 1/ndb of the table and processes 1/ndp of the reads;
    per-window labels psum over 'db' only, riding NVLink).  The reference has no
    analogue: its multi-GPU parts scheme reprocesses EVERY batch on every
    device (CuClarkDB.cu:842-928) and its cluster never shards the DB.

    Single-process meshes (jax.device_put global sharding); the multi-process
    capacity path is the 1-D ShardedRadixTable."""
    from ..ops import device_pipeline, radix_table, score

    axis_dp, axis_db = mesh.axis_names
    ndp, ndb = mesh.devices.shape
    c = table.slot_width
    m1, lb = table.m1, table.lb
    rows = table.slots.shape[0]
    rpd = -(-rows // ndb)
    slots_h = table.slots
    if ndb * rpd != rows:
        slots_h = np.concatenate([
            slots_h,
            np.full((ndb * rpd - rows, 2 * c), radix_table.EMPTY32, np.uint32),
        ])
    repl = NamedSharding(mesh, P())
    # host arrays straight to the mesh: each card receives only its rows
    slots_d = jax.device_put(slots_h, NamedSharding(mesh, P(axis_db, None)))
    sk_d = jax.device_put(table.stash_keys, repl)
    sl_d = jax.device_put(table.stash_labels, repl)
    rows_in = NamedSharding(mesh, P(axis_dp, None))

    jfns = {}

    def _jfn(extended, probe_cols):
        key = (extended, probe_cols)
        if key in jfns:
            return jfns[key]

        def f(slots_blk, sk, sl, words, vwords):
            canon, valid = device_pipeline.window_canonicals(
                words, vwords, k, probe_cols
            )
            q = jnp.where(valid, canon, radix_table.EMPTY).ravel()
            d = jax.lax.axis_index(axis_db)
            lab = radix_table.probe_chunk(
                slots_blk, jnp.zeros(0, jnp.uint32), sk, sl, q, d * rpd,
                m1=m1, lb=lb, c=c, use_stash=(d == 0),
            )
            lab = jnp.where(valid.ravel(), lab, 0)
            lab = jax.lax.psum(lab, axis_db)  # keys live on exactly one shard
            R, S = valid.shape
            if not extended:
                total, ib, b_, isb, sb = score.top2_from_labels(
                    lab.reshape(R, S)
                )
                return total, ib, b_, sb, jnp.zeros((R, 0), jnp.int32)
            if extended == "sorted":
                # extended columns as the sorted per-window label grid
                # (u16 runs): same O(windows) device cost as non-extended
                # on ANY mesh, vs the dense [R, T+1] psum/fetch
                s = jax.lax.sort(lab.reshape(R, S), dimension=1)
                total, ib, b_, isb, sb = score.top2_from_sorted(s)
                return total, ib, b_, sb, s.astype(jnp.uint16)
            rid = jnp.repeat(jnp.arange(R, dtype=jnp.int32), S)
            counts = score.counts_from_hits(lab, rid, R, n_targets)
            total, ib, b_, isb, sb = score.read_results(counts)
            return total, ib, b_, sb, counts

        jfns[key] = jax.jit(
            shard_map(
                f,
                mesh,
                in_specs=(P(axis_db, None), P(), P(),
                          P(axis_dp, None), P(axis_dp, None)),
                out_specs=(P(axis_dp), P(axis_dp), P(axis_dp), P(axis_dp),
                           P(axis_dp, None)),
            )
        )
        return jfns[key]

    def batch_fn(words, vwords, extended=True, probe_cols=None):
        r = (-words.shape[0]) % ndp
        if r:
            words = jnp.concatenate(
                [words, jnp.zeros((r, words.shape[1]), jnp.uint64)]
            )
            vwords = jnp.concatenate(
                [vwords, jnp.zeros((r, vwords.shape[1]), jnp.uint64)]
            )
        words = jax.device_put(words, rows_in)
        vwords = jax.device_put(vwords, rows_in)
        return _jfn(extended, probe_cols)(slots_d, sk_d, sl_d, words, vwords)

    return (slots_d,), batch_fn


def make_mesh2d(dp: int, db: int) -> Mesh:
    """[dp, db] mesh over the first dp*db global devices, column-major:
    column j holds dp consecutive devices (one process's devices when
    dp == devices-per-process), so the 'db' axis crosses process/network
    boundaries and 'dp' stays within a process."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    if dp * db > len(devs):
        raise ValueError(
            f"mesh {dp}x{db} needs {dp * db} devices, have {len(devs)}"
        )
    return Mesh(
        np.array(devs[: dp * db]).reshape(db, dp).T, ("dp", "db")
    )


def make_mesh(n_devices: int | None = None, axis: str = "db") -> Mesh:
    """One-axis mesh over the global device set, ordered so each process's
    devices are contiguous (required by ShardedRadixTable's per-process row
    ownership)."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_index(mesh: Mesh, keys, labels1, n_targets: int, plan):
    """Place the index sharded over the mesh; returns (keys, labels1, query_fn)
    with query_fn(keys, labels1, q, qread) -> (total, ibest, best, sbest, counts).
    """
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    keys, labels1 = lookup.pad_index(keys, labels1, ndev)
    kshard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    keys_d = jax.device_put(np.asarray(keys), kshard)
    labels_d = jax.device_put(np.asarray(labels1), kshard)

    max_reads = plan.max_reads

    def local_fn(keys_blk, labels_blk, q, qread):
        lab = lookup.lookup_labels(keys_blk, labels_blk, q)
        lab = jax.lax.psum(lab, axis)  # at most one shard hits per query
        counts = score.counts_from_hits(lab, qread, max_reads, n_targets)
        total, ib, b, isb, sb = score.read_results(counts)
        return total, ib, b, sb, counts

    fn = shard_map(
        local_fn,
        mesh,
        in_specs=(P(axis), P(axis), P(), P()),
        out_specs=(P(), P(), P(), P(), P()),
    )
    jfn = jax.jit(fn)

    def query_fn(keys_a, labels_a, q, qread):
        q = jax.device_put(q, repl)
        qread = jax.device_put(qread, repl)
        return jfn(keys_a, labels_a, q, qread)

    return keys_d, labels_d, query_fn
