"""Classification engine: file -> batched device queries -> CSV.

Replaces the reference's CuCLARK engine hot path (CuCLARK_hh.hh:1335-1783
getObjectsDataComputeFullGPU + printExtendedResultsSynced:1946-2122):

  host (numpy): mmap + vectorized read scan, 2-bit/validity packing into
                fixed-stride [R, S] rows (ops/pack.py);
  device (jit): window extraction + canonicalization (elementwise) +
                radix-table probe (one wide row gather) + per-read count/
                top-2 reductions (ops/device_pipeline.py), optionally sharded
                over a `Mesh` axis (reads for throughput, DB rows + psum for
                capacity);
  host:         Gamma/Confidence in doubles and C-printf `%g` CSV formatting,
                byte-identical to the reference
                (Gamma = sum / (len - k + 1), Confidence = best/(best+s_best),
                 CuCLARK_hh.hh:2042-2051, 2110-2118).

A slower flat-query path (sorted-array binary search, ops/lookup.py) is kept
for cross-checking (`packed=False`).
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import itertools
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from .io import dbformat
from .io.fasta import (
    ReadSet,
    iter_merged_slabs,
    iter_record_slabs,
    parse_reads,
    window_starts,
)
from .io.targets import TargetsDef, parse_targets
from .kmer import canonical_u64, window_values_le
from .ops import device_pipeline, lookup, pack, radix_table, score
from .params import NBN, Profile
from .utils.fetch import hedged_device_get
from .utils.profiling import maybe_phase


@dataclasses.dataclass
class BatchPlan:
    """Fixed device shapes; the same jitted executables serve every batch."""

    max_queries: int = 1 << 20  # flat path: query slots per batch
    max_reads: int = 1 << 16  # reads per batch
    window_budget: int = 1 << 23  # packed path: R*stride char slots per batch
    pipeline_depth: int = 6  # batches in flight
    # (these batch constants were tuned on earlier hardware with a high
    # per-call latency; ROADMAP S5 sweeps them on the H100)
    scan_chunk_bytes: int = 8 << 20  # streamed-scan granularity (native path):
    # the record scan runs in a background thread in chunks of this size, so
    # the first batch dispatches after ~one chunk's scan (~20 ms) instead of
    # after the whole input's (~120 ms per 300k reads) and the rest of the
    # scan hides behind device compute
    cycle_strategy: str = "auto"  # out-of-core accumulation: "counts" keeps
    # dense [R, T+1] per batch on the host (tiny for few targets, O(T)
    # per read at RefSeq scale: ~40 KB/read at 10k targets); "labels" keeps
    # per-window matched labels [R, S] per cycle (O(windows) per read,
    # target-count independent) and runs one final device top-2 over the
    # concatenated cycles.  "auto" picks labels when it is smaller.  Both
    # strategies compose with the sharded mesh (labels psum across shards —
    # a key lives on exactly one shard).
    sort_batches: bool = True  # length-bucketed batch planning: group the
    # reads of a planning window by stride tier (stable within tier) so
    # mixed-length inputs pack into dense same-stride batches instead of
    # padding every read to the window's longest tier (the reference
    # tolerates interleaved lengths via its variable-length
    # container stream, CuCLARK_hh.hh:1610-1726).  Results are scattered
    # back and formatted in original order — CSVs are byte-identical to the
    # file-order planner (property-tested).
    sort_window_batches: int = 8  # planning-window size in batches: larger
    # windows amortize per-tier partial batches (at most one per tier per
    # window) against full ones; the window is also the result-reorder
    # granularity (a window's scalars are ~20B/read host-side, so even
    # 64-batch windows would be cheap — 8 keeps first-output latency low)
    fetch_group: int = 16  # batches per device_get in the non-extended
    # native path: one fetch of G batches' (tiny, ~1 MB/batch) result rows
    # instead of G.  Extended mode always fetches per batch — its run grids
    # are ~8 MB/batch and grouping would hold G of them on device and host.


def _stride_tiers(lengths: np.ndarray) -> np.ndarray:
    """Vectorized pack.quantized_stride over a length array (exact parity:
    multiples of 64 up to 1024, powers of two from 2048 above)."""
    ln = np.maximum(np.asarray(lengths, dtype=np.int64), 1)
    small = np.maximum((ln + 63) // 64 * 64, 64)
    big = np.full_like(ln, 2048)
    mask = big < ln
    while mask.any():
        big[mask] *= 2
        mask = big < ln
    return np.where(ln <= 1024, small, big)


def _pad_rows(nb: int, r_cap: int) -> int:
    """Row padding for a partial batch: powers of two up to 8192, multiples
    of 8192 above, capped at the tier's full row count — each tier
    contributes a bounded set of jit shapes (~10) while pad waste stays
    <= max(nb, 12.5%) instead of the up-to-2x a pure power-of-two ladder
    costs at large partial batches (measured 7.7% of config-2's probed
    slots in one 38k-read partial)."""
    if nb <= 8192:
        p = 2048
        while p < nb:
            p *= 2
        return min(p, r_cap)
    return min(-(-nb // 8192) * 8192, r_cap)


def _pad_batch(words, vwords, r_pad: int):
    """Zero-pad a packed batch's rows up to the planner's padded row count
    (zero rows have no valid windows, so they score as empty and the
    scatter-back ignores them)."""
    nb = len(words)
    if nb < r_pad:
        words = np.concatenate(
            [words, np.zeros((r_pad - nb, words.shape[1]), np.uint64)]
        )
        vwords = np.concatenate(
            [vwords, np.zeros((r_pad - nb, vwords.shape[1]), np.uint64)]
        )
    return words, vwords


class _ScanStream:
    """Record scan of an in-memory FASTA/FASTQ buffer, streamed from a
    background thread in record-aligned chunks (native scanner per chunk,
    offsets fixed up to be absolute) so batch planning/dispatch starts after
    the FIRST chunk instead of after the whole input.  Produces byte-for-byte
    the same per-read arrays as one whole-buffer `native.scan_reads`."""

    def __init__(self, data: bytes, chunk_bytes: int = 8 << 20):
        from .io.fasta import iter_record_cuts
        from .utils import native as _native

        self._parts: list[tuple] = []  # (ns, ne, ss, se, ln) per chunk
        self._cum: list[int] = [0]  # cumulative read counts
        self._done = False
        self._err: BaseException | None = None
        self._cond = threading.Condition()

        def run():
            try:
                buf = np.frombuffer(data, np.uint8)
                if data[0:1] not in (b">", b"@"):
                    raise ValueError(
                        "failed to recognize the format of the file"
                    )
                is_fq = data[0:1] == b"@"
                for s, e in iter_record_cuts(buf, is_fq, chunk_bytes):
                    with maybe_phase("scan"):
                        part = _native.scan_reads(
                            data, s, e, is_fasta=not is_fq
                        )[1:]
                    with self._cond:
                        self._parts.append(part)
                        self._cum.append(self._cum[-1] + len(part[4]))
                        self._cond.notify_all()
            except BaseException as e:  # re-raised by readers
                self._err = e
            finally:
                with self._cond:
                    self._done = True
                    self._cond.notify_all()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def ensure(self, n: int) -> int:
        """Block until ≥n reads are scanned (or the scan finished); return
        the scanned count so far (≥n unless the input is exhausted)."""
        with self._cond:
            while self._cum[-1] < n and not self._done:
                self._cond.wait()
            if self._err is not None:
                raise self._err
            return self._cum[-1]

    def total(self) -> int:
        with self._cond:
            while not self._done:
                self._cond.wait()
            if self._err is not None:
                raise self._err
            return self._cum[-1]

    def arrays(self, r0: int, r1: int):
        """(ns, ne, ss, se, ln) for reads [r0, r1) — caller must have
        ensure()d r1 first."""
        with self._cond:
            lo = bisect.bisect_right(self._cum, r0) - 1
            hi = bisect.bisect_left(self._cum, r1, lo=lo)
            pieces = self._parts[lo:hi]
            starts = self._cum[lo : hi + 1]
        if len(pieces) == 1:
            a, b = r0 - starts[0], r1 - starts[0]
            return tuple(p[a:b] for p in pieces[0])
        out = []
        for f in range(5):
            segs = []
            for pi, p in enumerate(pieces):
                a = max(r0 - starts[pi], 0)
                b = min(r1, starts[pi + 1]) - starts[pi]
                segs.append(p[f][a:b])
            out.append(np.concatenate(segs))
        return tuple(out)


class HitStats:
    """Distinct-targets-hit-per-read accumulator (extended runs only),
    mirroring the reference's nonzero_count MIN/MAX/AVG stderr report
    (CuCLARK_hh.hh:1979-1980, 2053-2067)."""

    def __init__(self, n_targets: int):
        self.min = n_targets  # m_targetsName.size()-1 initial value
        self.max = 0
        self.sum = 0
        self.n = 0

    def update_counts(self, counts: np.ndarray):
        """Dense [R, T+1] count rows -> per-read distinct target counts."""
        d = np.count_nonzero(counts[:, 1:], axis=1)
        self._update(d)

    def update_runs(self, runs: np.ndarray):
        """Sorted per-window label rows [R, W] (zeros-first) -> distinct
        label count per row."""
        if runs.shape[1] == 0:
            self._update(np.zeros(runs.shape[0], np.int64))
            return
        d = ((runs[:, 1:] != runs[:, :-1]) & (runs[:, 1:] > 0)).sum(axis=1)
        d = d + (runs[:, 0] > 0)
        self._update(d)

    def _update(self, d: np.ndarray):
        if len(d):
            self.min = min(self.min, int(d.min()))
            self.max = max(self.max, int(d.max()))
            self.sum += int(d.sum())
        self.n += len(d)

    def report(self) -> str:
        """The reference's exact stderr line: AVG in float32 like
        `(float)nonzero_sum / m_nbObjects` (CuCLARK_hh.hh:2064-2067)."""
        with np.errstate(invalid="ignore"):
            avg = np.float32(self.sum) / np.float32(self.n)
        return (
            f"MIN targets: {self.min}, MAX targets: {self.max}, "
            f"AVG targets: {'%g' % avg}"
        )


class Classifier:
    """Single- or multi-device CLARK classifier over a loaded database."""

    dense_table = None  # set when the dense two-choice residency engages

    def __init__(
        self,
        profile: Profile,
        k: int,
        target_names: list[str],
        canonical: np.ndarray,
        labels: np.ndarray,
        plan: BatchPlan | None = None,
        mesh: jax.sharding.Mesh | None = None,
        packed: bool = True,
        use_native: bool = True,
        db_cycles: int | str = "auto",
        index_cache: str | None = None,
        index_sig=None,
        mesh_mode: str = "dp",
        prebuilt_table=None,
    ):
        self.profile = profile
        self.k = k
        self.target_names = target_names
        self.n_targets = len(target_names) - 1  # names include NA at 0
        self.plan = plan or BatchPlan()
        self.mesh = mesh
        self.packed = packed
        self.use_native = use_native
        auto_cycles = db_cycles in ("auto", 0, None)
        self.db_cycles = db_cycles = 1 if auto_cycles else int(db_cycles)

        if packed:
            if mesh is not None and mesh_mode == "db":
                # DB sharded over the mesh axis (multi-process capable),
                # composable with out-of-core cycling
                from .parallel.mesh import ShardedRadixTable

                self.sharded = ShardedRadixTable(
                    mesh,
                    np.asarray(canonical, dtype=np.uint64),
                    np.asarray(labels, dtype=np.int32) + 1,
                    self.n_targets,
                    k,
                    db_cycles="auto" if auto_cycles else db_cycles,
                    window_budget=self.plan.window_budget,
                )
                self.table_meta = self.sharded.meta
                self.db_cycles = db_cycles = self.sharded.n_cycles
                if db_cycles == 1:
                    self.batch_fn = self.sharded.classify
                return
            table = prebuilt_table
            if table is None and index_cache is not None and os.path.exists(
                index_cache
            ):
                table = radix_table.load_cache(index_cache, signature=index_sig)
            if table is None:
                table = radix_table.build(
                    np.asarray(canonical, dtype=np.uint64),
                    np.asarray(labels, dtype=np.int32) + 1,
                    k=k,
                )
                if index_cache is not None:
                    try:
                        radix_table.save_cache(
                            index_cache, table, signature=index_sig
                        )
                    except OSError:
                        pass
            self.table_meta = table.meta
            if auto_cycles:
                # reference behavior: parts x cycles derived from free device
                # memory minus RESERVED (CuClarkDB.cu:526-565); here a table
                # bigger than the per-device budget auto-cycles with no flags
                from .utils import memory

                # a 2-axis (dp x db) mesh shards table rows over the 'db'
                # axis; a 1-axis dp mesh replicates the table per device
                n_shards = 1
                if mesh is not None and len(mesh.axis_names) == 2:
                    n_shards = mesh.shape[mesh.axis_names[-1]]
                db_cycles, budget = memory.auto_db_cycles(
                    table.nbytes, self.plan.window_budget, n_shards=n_shards,
                )
                if db_cycles > 1 and mesh is not None:
                    per_dev = table.nbytes // n_shards
                    raise RuntimeError(
                        f"database needs {per_dev >> 20} MB per device but "
                        f"the device budget is {budget >> 20} MB, and "
                        "out-of-core cycling does not compose with this "
                        "mesh mode. Use --shard-db (DB rows sharded over "
                        "the mesh, composes with cycling) or drop the mesh "
                        "and let --db-cycles auto stream the table."
                    )
                self.db_cycles = db_cycles
                if db_cycles > 1:
                    import sys

                    print(
                        f"Database ({table.nbytes >> 20} MB) exceeds the "
                        f"device budget ({budget >> 20} MB): loading in "
                        f"{db_cycles} cycles.",
                        file=sys.stderr,
                    )
            # dense two-choice residency: a DB between
            # 1x and ~2x the budget stays RESIDENT in the load-0.9 dense
            # layout (two gathers/probe, radix_table block comment) instead
            # of cycling (re-streaming the table every pass).  CLARK_TPU_DENSE:
            # auto (default) / 0 (never) / force (even when standard fits).
            dense_env = os.environ.get("CLARK_TPU_DENSE", "auto")
            want_dense = dense_env == "force" or (
                dense_env not in ("0", "off")
                and auto_cycles
                and db_cycles > 1
                and mesh is None
            )
            if want_dense and mesh is None:
                dense = self._try_dense(
                    canonical, labels, table, index_cache, index_sig,
                    budget if auto_cycles else None,
                    forced=dense_env == "force",
                )
                if dense is not None:
                    self.db_cycles = db_cycles = 1
                    return  # batch_fn installed by _try_dense
            if db_cycles > 1:
                # out-of-core: keep chunks host-side, stream per cycle
                if mesh is not None:
                    raise NotImplementedError(
                        "db_cycles with a dp mesh is not supported; use "
                        "mesh_mode='db' (sharded rows compose with cycling)"
                    )
                self.table_chunks = radix_table.chunk_table(table, db_cycles)
                self.stash = (table.stash_keys, table.stash_labels)
                return
            if mesh is not None:
                if len(mesh.axis_names) == 2:
                    # dp x db composition: reads AND table sharded at once
                    from .parallel.mesh import shard_reads_db

                    (self.slots,), self.batch_fn = shard_reads_db(
                        mesh, table, self.n_targets, self.k
                    )
                else:
                    from .parallel.mesh import shard_reads

                    (self.slots, self.lab_flat), self.batch_fn = shard_reads(
                        mesh, table, self.n_targets, self.k
                    )
            else:
                self.slots = slots = jax.device_put(table.slots)
                self.lab_flat = lab_flat = jax.device_put(table.labels)
                self.stash_k = stash_k = jax.device_put(table.stash_keys)
                self.stash_l = stash_l = jax.device_put(table.stash_labels)
                meta = self.table_meta
                n_targets = self.n_targets

                # the closure holds the arrays, not self: a reference
                # cycle would keep the table on the device after the
                # Classifier is dropped, until the garbage collector runs
                def batch_fn(words, vwords, extended=True, probe_cols=None):
                    return device_pipeline.classify_batch(
                        slots,
                        lab_flat,
                        stash_k,
                        stash_l,
                        words,
                        vwords,
                        k=k,
                        n_targets=n_targets,
                        extended=extended,
                        probe_cols=probe_cols,
                        **meta,
                    )

                self.batch_fn = batch_fn
        else:
            keys, labels1 = lookup.prepare_index(canonical, labels)
            if mesh is not None:
                from .parallel.mesh import shard_index

                self.keys, self.labels1, self.query_fn = shard_index(
                    mesh, keys, labels1, self.n_targets, self.plan
                )
            else:
                self.keys = jnp.asarray(keys)
                self.labels1 = jnp.asarray(labels1)
                self.query_fn = functools.partial(
                    _query_single,
                    n_targets=self.n_targets,
                    max_reads=self.plan.max_reads,
                )

    def _try_dense(
        self, canonical, labels, table, index_cache, index_sig, budget,
        forced=False,
    ):
        """Attempt the dense two-choice residency (see __init__): returns
        the DenseTable and installs batch_fn, or None when it would not
        fit the budget either (fall back to cycling)."""
        import sys

        from .ops.radix_table import (
            EMPTY,
            build_dense,
            dense_nbytes,
            load_dense_cache,
            recover_keys,
            save_dense_cache,
        )

        n_keys = len(canonical)
        if n_keys == 0:
            # table came from the .idx cache: load() passes empty key
            # arrays then; the exact count is the table's occupancy
            from .ops.radix_table import occupied_count

            n_keys = occupied_count(
                table.slots, table.slot_width
            ) + int((table.stash_keys != EMPTY).sum())
        if budget is not None:
            # the second plane's probe: one more step's transients
            from .utils.memory import probe_transient_bytes

            extra = probe_transient_bytes(self.plan.window_budget)
            predicted = dense_nbytes(
                n_keys, self.n_targets, c=table.slot_width
            )
            if predicted + extra > budget:
                return None
        dense_cache = index_cache + ".dense" if index_cache else None
        dense = None
        if dense_cache is not None and os.path.exists(dense_cache):
            dense = load_dense_cache(dense_cache, signature=index_sig)
        if dense is None:
            if len(canonical):
                keys = np.asarray(canonical, dtype=np.uint64)
                labs1 = np.asarray(labels, dtype=np.int32) + 1
            else:
                # recover the exact key/label set from the standard table
                # (bijective slot layout — radix_table.recover_keys)
                keys, labs1 = recover_keys(table)
            dense = build_dense(keys, labs1, c=table.slot_width)
            if dense_cache is not None:
                try:
                    save_dense_cache(dense_cache, dense,
                                     signature=index_sig)
                except OSError:
                    pass
        if budget is not None and dense.nbytes + extra > budget:
            return None  # prediction was off; cycle instead
        if not forced:
            print(
                f"Database ({table.nbytes >> 20} MB standard) fits "
                f"resident in the dense two-choice layout "
                f"({dense.nbytes >> 20} MB): probing dense instead of "
                f"cycling.",
                file=sys.stderr,
            )
        self.table_meta = dense.meta
        slots1 = jax.device_put(dense.slots1)
        slots2 = jax.device_put(dense.slots2)
        stash_k = jax.device_put(dense.stash_keys)
        stash_l = jax.device_put(dense.stash_labels)
        meta = self.table_meta
        k, n_targets = self.k, self.n_targets

        def batch_fn(words, vwords, extended=True, probe_cols=None):
            return device_pipeline.classify_batch_dense(
                slots1, slots2, stash_k, stash_l, words, vwords,
                k=k, n_targets=n_targets, extended=extended,
                probe_cols=probe_cols, **meta,
            )

        self.batch_fn = batch_fn
        self.dense_table = dense
        return dense

    # ------------------------------------------------------------------ load
    @classmethod
    def load(
        cls,
        folder: str,
        targets: TargetsDef | str,
        profile: Profile,
        k: int | None = None,
        min_count_target: int = 0,
        sampling_factor: int = 1,
        gap: int | None = None,
        plan: BatchPlan | None = None,
        mesh: jax.sharding.Mesh | None = None,
        packed: bool = True,
        use_native: bool = True,
        db_cycles: int | str = "auto",
        mesh_mode: str = "dp",
    ) -> "Classifier":
        if isinstance(targets, str):
            targets = parse_targets(targets)
        k = profile.default_k if k is None else k
        g = profile.default_gap if gap is None else gap
        stem = os.path.join(
            folder, profile.db_stem(k, targets.n_targets, min_count_target, g)
        )
        cache = stem + ".idx.npz"
        if not dbformat.db_exists(stem):
            # recover from per-target .ht files if present
            # (CuCLARK_hh.hh:633-684)
            from .db.recovery import recover_central_db

            if recover_central_db(
                folder, targets, profile, k, min_count_target, gap=g
            ):
                import sys

                print(
                    "The database was recovered from saved targets-specific "
                    "data.",
                    file=sys.stderr,
                )
        # device-index cache: keyed on a content signature of the DB files
        # (size + head/tail crc — mtime alone misses same-second rebuilds and
        # `cp -p` copies); valid only for unsampled loads (sampling changes
        # the key set)
        use_cache = (
            packed
            and sampling_factor == 1
            # the mesh-sharded path plans/fills from the raw key set
            and not (mesh is not None and mesh_mode == "db")
        )
        table = None
        sig = radix_table.db_signature(stem) if use_cache else None
        if use_cache and os.path.exists(cache):
            table = radix_table.load_cache(cache, signature=sig)
            if table is None:
                try:
                    os.remove(cache)
                except OSError:
                    pass
        if table is not None:
            canonical = np.zeros(0, np.uint64)
            labels = np.zeros(0, np.uint16)
        else:
            canonical, labels = dbformat.read_db(stem, profile, k, sampling_factor)
        return cls(
            profile,
            k,
            targets.target_names,
            canonical,
            labels,
            plan=plan,
            mesh=mesh,
            packed=packed,
            use_native=use_native,
            db_cycles=db_cycles,
            index_cache=cache if use_cache else None,
            index_sig=sig,
            mesh_mode=mesh_mode,
            prebuilt_table=table,
        )

    # -------------------------------------------------------------- classify
    def classify_bytes(
        self,
        data: bytes,
        paired: bool = False,
        extended: bool = False,
        hit_stats: HitStats | None = None,
    ):
        """Classify one in-memory FASTA/FASTQ file; returns (rows, n_reads).

        rows is a generator of formatted CSV body chunks (bytes, one or more
        whole lines per chunk).  `hit_stats` (extended runs only)
        accumulates the reference's MIN/MAX/AVG distinct-targets-hit
        report (CuCLARK_hh.hh:2053-2067).
        """
        from .utils import native as _native

        if self.packed and self.use_native and _native.available():
            if self.db_cycles > 1:
                with maybe_phase("scan"):
                    is_fa, ns, ne, ss, se, ln = _native.scan_reads(data)
                gen = self._classify_cycled_native(
                    data, ns, ne, ss, se, ln, paired=paired,
                    extended=extended, hit_stats=hit_stats,
                )
                return gen, len(ln)
            # n_reads from an exact substring-count (parity-tested against
            # the scanner) so the record scan itself can stream in the
            # background and overlap batch dispatch/compute
            n_reads = _native.quick_count(data)
            scan = _ScanStream(data, self.plan.scan_chunk_bytes)
            gen = self._classify_native(
                data, scan, paired=paired, extended=extended,
                hit_stats=hit_stats,
            )
            return gen, n_reads
        rs = parse_reads(data)
        return (
            self._classify_readset(
                rs, paired=paired, extended=extended, hit_stats=hit_stats
            ),
            rs.n_reads,
        )

    def classify_file(
        self,
        objects_path: str,
        result_path: str,
        paired_path: str | None = None,
        extended: bool = False,
        verbose: bool = False,
        slab_bytes: int = 1 << 28,
    ) -> dict:
        """Classify a file (or paired files) to `<result_path>.csv`.

        The input is memory-mapped and streamed in record-aligned slabs of
        ~slab_bytes, so inputs far larger than host RAM classify with a flat
        memory profile (the reference mmaps too, CuCLARK_hh.hh:522-539, but
        materializes all batches); paired FASTQ merges through the native
        chunked merger (file.cc:205-268).  Returns speed stats
        (reads, seconds, reads_per_min), mirroring printSpeedStats
        (CuCLARK_hh.hh:1932-1939).
        """
        paired = paired_path is not None
        if paired:
            slabs = iter_merged_slabs(objects_path, paired_path, slab_bytes)
        else:
            slabs = iter_record_slabs(objects_path, slab_bytes)

        t0 = time.time()
        n_reads = 0
        out = result_path + ".csv"
        # pull the first slab BEFORE touching the output so a missing/
        # malformed input raises without destroying an existing results file
        first = next(slabs, None)
        if first is not None:
            slabs = itertools.chain([first], slabs)

        from .utils import native as _native

        use_native = self.packed and self.use_native and _native.available()
        if use_native and first is not None and self.db_cycles > 1:
            # cycled path wants whole-slab arrays: prefetch + scan slab i+1
            # in a worker thread while slab i classifies
            def scan_stage(slab):
                with maybe_phase("scan"):
                    return slab, _native.scan_reads(slab)

            scanned = self._pipelined(slabs, scan_stage, depth=1)
        elif use_native and first is not None:
            # slab i+1 materializes (mmap page-in / paired merge) in a worker
            # thread while slab i classifies; the record scan itself streams
            # inside _classify_native
            scanned = self._pipelined(slabs, lambda s: (s, None), depth=1)
        else:
            scanned = ((s, None) for s in slabs) if first is not None else iter(())
        hs = HitStats(self.n_targets) if extended else None
        with open(out, "wb") as f:
            f.write(self._header(extended))
            for slab, scn in scanned:
                if scn is not None:
                    is_fa, ns, ne, ss, se, ln = scn
                    gen = self._classify_cycled_native(
                        slab, ns, ne, ss, se, ln,
                        paired=paired, extended=extended, hit_stats=hs,
                    )
                    nr = len(ln)
                elif use_native:
                    scan = _ScanStream(slab, self.plan.scan_chunk_bytes)
                    gen = self._classify_native(
                        slab, scan, paired=paired, extended=extended,
                        hit_stats=hs,
                    )
                    nr = None
                else:
                    gen, nr = self.classify_bytes(
                        slab, paired=paired, extended=extended, hit_stats=hs
                    )
                for chunk in gen:
                    f.write(chunk)
                n_reads += scan.total() if nr is None else nr
        dt = time.time() - t0
        stats = {
            "reads": n_reads,
            "seconds": dt,
            "reads_per_min": int(n_reads / dt * 60.0) if dt > 0 else 0,
            "result": out,
        }
        if extended:
            stats["hit_stats"] = hs
        if extended and verbose:
            # per-run distinct-targets-hit distribution, as the reference
            # prints after its extended writer (CuCLARK_hh.hh:2064-2067)
            import sys

            print(hs.report(), file=sys.stderr)
        if verbose:
            print(
                f"Done in {dt:.1f}s ({stats['reads_per_min']} reads/min, "
                f"{n_reads} reads)"
            )
        return stats

    def classify_files(
        self,
        items: list[tuple],
        jobs: int = 2,
        extended: bool = False,
    ) -> list[dict]:
        """Classify several independent inputs, `jobs` at a time, through
        the shared device pipeline.

        Items are (objects_path, paired_path_or_None, result_path).  Small
        samples are single-batch, so one file's host→device→host chain has
        nothing to overlap with; classifying files concurrently fills each
        other's dispatch/fetch gaps (the reference runs list-mode files
        strictly sequentially, CuCLARK_hh.hh:384-507).  Outputs are
        per-file and independent; returned stats follow the input order."""
        if self.use_native:
            from .utils import native as _native

            if _native.available():
                self._names_buffer()  # init once before threads share it
        if self.db_cycles > 1 and len(items) > 1 and self.packed:
            # cycle-outer multi-sample scheduling: upload each table chunk
            # ONCE and run EVERY sample's batches through it before
            # advancing — N samples cost one table streaming instead of N
            # (threads can't compose with cycling: concurrent runs would
            # each hold every chunk on the device).  It holds every
            # sample's raw bytes + packed batches in host RAM for the run,
            # so huge multi-sample inputs fall back to the serial
            # slab-streamed path instead of exhausting memory.
            total_bytes = sum(
                os.path.getsize(p)
                for o, pp, _ in items
                for p in (o, pp)
                if p is not None
            )
            cap = int(
                os.environ.get("CLARK_TPU_CYCLE_OUTER_MAX_BYTES", 4 << 30)
            )
            if total_bytes <= cap:
                return self._classify_files_cycled(items, extended=extended)
            import sys

            print(
                f"cycle-outer scheduling skipped: inputs total "
                f"{total_bytes >> 20} MB > {cap >> 20} MB cap "
                "(CLARK_TPU_CYCLE_OUTER_MAX_BYTES); running samples "
                "serially with slab streaming.",
                file=sys.stderr,
            )
        if self.db_cycles > 1:
            # out-of-core runs share mutable per-cycle state (the sharded
            # table's current-cycle upload) and each concurrent run would
            # hold its own copy of every table chunk on the device —
            # defeating the reason cycling exists
            jobs = 1
        if jobs <= 1 or len(items) <= 1:
            return [
                self.classify_file(o, r, paired_path=p, extended=extended)
                for o, p, r in items
            ]
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=jobs) as ex:
            futs = [
                ex.submit(
                    self.classify_file, o, r, paired_path=p, extended=extended
                )
                for o, p, r in items
            ]
            return [f.result() for f in futs]

    def _classify_files_cycled(self, items, extended: bool) -> list[dict]:
        """Cycle-outer / sample-inner out-of-core batch: table chunk j is
        uploaded once, then EVERY sample's batches probe it; per-sample
        accumulators finish independently.  The serial alternative streams
        the whole table once PER SAMPLE.

        All samples' packed batches live in host RAM for the run
        (2.25 bits/char) — the multi-sample batch use case (kent -m style,
        BASELINE config 4) is many small samples, where that is cheap."""
        from .utils import native as _native

        t0 = time.time()
        use_native = self.use_native and _native.available()
        samples = []
        for objects_path, paired_path, result_path in items:
            with open(objects_path, "rb") as f:
                data = f.read()
            paired = paired_path is not None
            if paired:
                from .io.fasta import merge_paired

                with open(paired_path, "rb") as f:
                    data = merge_paired(data, f.read())
            if use_native:
                with maybe_phase("scan"):
                    is_fa, ns, ne, ss, se, ln = _native.scan_reads(data)

                def packer(idx, stride, data=data, ss=ss, se=se):
                    return _native.pack_batch(data, ss[idx], se[idx], stride)

                def formatter(
                    r0, r1, total, ib, b, sb, norm, counts,
                    data=data, ns=ns, ne=ne,
                ):
                    return _native.format_rows(
                        data, ns[r0:r1], ne[r0:r1], total, ib, b, sb, norm,
                        self.k, self._names_buffer(), counts=counts,
                        n_targets=self.n_targets if counts is not None else 0,
                    )

                lengths = ln
            else:
                rs = parse_reads(data)
                lengths = rs.read_lengths
                names = [rs.name(i) for i in range(rs.n_reads)]

                def packer(idx, stride, rs=rs):
                    return pack.pack_batch_idx(rs, idx, stride)

                def formatter(
                    r0, r1, total, ib, b, sb, norm, counts, names=names
                ):
                    return b"".join(
                        _format_row(
                            names[r0 + i], int(total[i]), int(ib[i]),
                            int(b[i]), int(sb[i]), int(norm[i]), self.k,
                            self.target_names,
                            counts[i] if counts is not None else None,
                        )
                        for i in range(r1 - r0)
                    )

            specs, packed, pcs = self._cycled_prepare(lengths, packer)
            samples.append(
                dict(
                    result=result_path, paired=paired, lengths=lengths,
                    specs=specs, packed=packed, acc=[None] * len(specs),
                    formatter=formatter, pcs=pcs,
                )
            )
        strategy = self._cycled_strategy([s["packed"] for s in samples])
        n_passes, begin_pass, end_pass = self._cycle_passes(strategy)
        for j in range(n_passes):
            pass_fn = begin_pass(j)
            for s in samples:
                self._cycled_accumulate(
                    pass_fn, s["packed"], s["acc"], strategy, s["pcs"]
                )
            end_pass()
        outs = []
        for s in samples:
            out = s["result"] + ".csv"
            with open(out, "wb") as f:
                f.write(self._header(extended))
                for chunk in self._cycled_finish(
                    s["specs"], s["acc"], strategy, s["lengths"],
                    s["paired"], extended, s["formatter"],
                ):
                    f.write(chunk)
            outs.append(out)
        # samples interleave inside each table-chunk pass, so per-sample
        # wall time is NOT separable; report the shared run wall and the
        # aggregate rate on every sample, flagged as aggregate (prorated
        # per-sample "seconds" would present an estimate as a measurement)
        dt = time.time() - t0
        n_total = sum(len(s["lengths"]) for s in samples) or 1
        stats = []
        for s, out in zip(samples, outs):
            stats.append(
                {
                    "reads": len(s["lengths"]),
                    "seconds": dt,
                    "reads_per_min": (
                        int(n_total / dt * 60.0) if dt > 0 else 0
                    ),
                    "result": out,
                    "aggregate": True,  # seconds/rate are the whole batch's
                }
            )
        return stats

    def _probe_cols(self, max_len, stride: int) -> int:
        """Static probed-window count for a batch whose longest read is
        max_len at the given stride tier: always-invalid pad columns
        beyond (max_len - k + 1) are trimmed before the probe (stride
        quantization pads 150 bp reads at stride 192 to 162 probed slots
        of which only 120 can be valid — pure probe waste).  Rounded up
        to a multiple of 32 so each tier contributes a handful of jit
        shapes; capped at the tier's full width."""
        w_full = max(stride - self.k + 1, 1)
        w = max(int(max_len) - self.k + 1, 1)
        w = -(-w // 32) * 32
        return min(w, w_full)

    def _header(self, extended: bool) -> bytes:
        cols = ["Object_ID"]
        if extended:
            cols += self.target_names[1:]
        cols += ["Gamma", "Assignment", "Score", "Confidence"]
        return (",".join(cols) + "\n").encode()

    def _classify_readset(
        self, rs: ReadSet, paired: bool, extended: bool, hit_stats=None
    ):
        if self.packed and self.db_cycles > 1:
            yield from self._classify_cycled_rs(
                rs, paired, extended, hit_stats=hit_stats
            )
        elif self.packed:
            yield from self._classify_packed(
                rs, paired, extended, hit_stats=hit_stats
            )
        else:
            yield from self._classify_flat(
                rs, paired, extended, hit_stats=hit_stats
            )

    # --------------------------------------------------- out-of-core cycling
    def _classify_cycled_rs(
        self, rs: ReadSet, paired: bool, extended: bool, hit_stats=None
    ):
        lengths = rs.read_lengths
        names = [rs.name(i) for i in range(rs.n_reads)]

        def packer(idx, stride):
            return pack.pack_batch_idx(rs, idx, stride)

        def formatter(r0, r1, total, ib, b, sb, norm, counts):
            out = []
            for i in range(r1 - r0):
                out.append(
                    _format_row(
                        names[r0 + i], int(total[i]), int(ib[i]), int(b[i]),
                        int(sb[i]), int(norm[i]), self.k, self.target_names,
                        counts[i] if extended else None,
                    )
                )
            return b"".join(out)

        yield from self._cycled_core(
            lengths, paired, extended, packer, formatter, hit_stats=hit_stats
        )

    def _cycled_prepare(self, lengths, packer):
        """Plan + pack one input's batches for out-of-core passes; returns
        (specs, packed_batches, probe_cols) with length-bucketed
        (idx, stride, r_pad) specs (file-order contiguous specs when
        sort_batches=False)."""
        if self.plan.sort_batches:
            specs = self._window_specs(_stride_tiers(lengths))
        else:
            specs = [
                (np.arange(r0, r1, dtype=np.int64), stride, r_cap)
                for r0, r1, stride, r_cap in self._plan_batches(lengths)
            ]
        packed_batches = []
        pcs = []
        lengths = np.asarray(lengths)
        for idx, stride, r_pad in specs:
            words, vwords = packer(idx, stride)
            packed_batches.append(_pad_batch(words, vwords, r_pad))
            pcs.append(
                self._probe_cols(lengths[idx].max(initial=1), stride)
            )
        return specs, packed_batches, pcs

    def _cycled_strategy(self, packed_lists) -> str:
        """Resolve the cycle accumulation strategy over all inputs of a run.

        labels cost 2-4 B per WINDOW per cycle; dense counts cost 4*(T+1) B
        per read regardless of cycles — labels win once the target count
        passes the per-read window count (RefSeq-scale DBs: thousands of
        targets vs ~100-200 windows/read)."""
        strategy = self.plan.cycle_strategy
        if strategy != "auto":
            return strategy
        k = self.k
        sharded = getattr(self, "sharded", None)
        max_windows = max(
            (
                (w.shape[1] - 1) * 32 - (k - 1)
                for packed in packed_lists
                for w, _ in packed
            ),
            default=0,
        )
        n_chunks = (
            sharded.n_cycles if sharded is not None
            else len(self.table_chunks)
        )
        lab_bytes = (2 if self.n_targets < 65535 else 4) * n_chunks
        return (
            "labels" if max_windows * lab_bytes < 4 * (self.n_targets + 1)
            else "counts"
        )

    def _cycled_core(
        self, lengths, paired, extended, packer, formatter, hit_stats=None
    ):
        """Cycle-outer / batch-inner out-of-core classification: each table
        chunk/cycle is uploaded once per file, every batch is probed against
        it, per-read counts accumulate host-side (the reference's
        swapDbParts/host-row merge, CuCLARK_hh.hh:1765-1772).  Chunks come
        from either the single-device host chunking (table_chunks) or the
        mesh-sharded table's cycles (ShardedRadixTable).

        Batches are length-bucketed over the whole input (idx, stride,
        r_pad); scoring scatters per-read results back to file order before
        formatting."""
        specs, packed_batches, pcs = self._cycled_prepare(lengths, packer)
        acc = [None] * len(specs)
        strategy = self._cycled_strategy([packed_batches])
        n_passes, begin_pass, end_pass = self._cycle_passes(strategy)
        for j in range(n_passes):
            pass_fn = begin_pass(j)
            self._cycled_accumulate(
                pass_fn, packed_batches, acc, strategy, pcs
            )
            end_pass()
        yield from self._cycled_finish(
            specs, acc, strategy, lengths, paired, extended, formatter,
            hit_stats=hit_stats,
        )

    def _cycle_passes(self, strategy):
        """(n_passes, begin_pass(j) -> batch_fn, end_pass) over the table's
        cycles, from either the mesh-sharded table or host chunking.

        Chunk j+1's host->device upload starts in a worker thread while
        chunk j's batches probe (the reference's swapDbParts overlaps its
        uploads with the host-row merge the same way,
        CuClarkDB.cu:776-815) — at the cost of two resident chunks, which
        auto_db_cycles budgets for.  CLARK_TPU_PREFETCH_CHUNKS=0 disables
        (A/B hook)."""
        sharded = getattr(self, "sharded", None)
        if sharded is not None:
            n_passes = sharded.n_cycles

            def begin_pass(j):
                return sharded.begin_cycle(j, kind=strategy)

            return n_passes, begin_pass, sharded.end_cycle
        from .ops.device_pipeline import (
            classify_batch_counts_chunk,
            classify_batch_labels_chunk,
        )

        k = self.k
        sk = jnp.asarray(self.stash[0])
        sl = jnp.asarray(self.stash[1])
        n_passes = len(self.table_chunks)
        narrow = self.n_targets < 65535

        def upload(j):
            chunk = self.table_chunks[j]
            slots = jnp.asarray(chunk["slots"])
            lab = jnp.asarray(chunk["labels"])
            jax.block_until_ready(slots)
            return (
                slots, lab, jnp.int32(chunk["start_row"]),
                jnp.bool_(chunk["use_stash"]),
            )

        prefetch = (
            n_passes > 1
            and os.environ.get("CLARK_TPU_PREFETCH_CHUNKS", "1") != "0"
        )
        pre: dict = {"j": None, "thread": None, "out": None}
        # the current pass's device arrays live in this cell, NOT in the
        # returned closure: end_pass clears it so chunk j's HBM is released
        # before begin_pass(j+1) starts the j+2 upload — otherwise the
        # prior pass's closure (still bound by the caller) would pin a
        # third chunk and the transient peak would be ~1.5x the two-chunk
        # budget auto_db_cycles plans for
        cur: dict = {"arrs": None}

        def begin_pass(j):
            if pre["thread"] is not None and pre["j"] == j:
                pre["thread"].join()
                status, arrs = pre["out"]
                pre["thread"] = None
                pre["out"] = None
                if status == "err":
                    raise arrs
            else:
                with maybe_phase("chunk_upload"):
                    arrs = upload(j)
            if prefetch and j + 1 < n_passes:
                def work(nj=j + 1):
                    try:
                        pre["out"] = ("ok", upload(nj))
                    except BaseException as e:  # re-raised at next join
                        pre["out"] = ("err", e)

                pre["j"] = j + 1
                pre["thread"] = threading.Thread(target=work, daemon=True)
                pre["thread"].start()
            cur["arrs"] = arrs

            if strategy == "labels":
                def fn(words, vwords, probe_cols=None):
                    slots, lab, start, use_stash = cur["arrs"]
                    return classify_batch_labels_chunk(
                        slots, lab, sk, sl, words, vwords, start,
                        use_stash, k=k, narrow=narrow,
                        probe_cols=probe_cols, **self.table_meta,
                    )
            else:
                def fn(words, vwords, probe_cols=None):
                    slots, lab, start, use_stash = cur["arrs"]
                    return classify_batch_counts_chunk(
                        slots, lab, sk, sl, words, vwords, start,
                        use_stash, k=k, n_targets=self.n_targets,
                        probe_cols=probe_cols, **self.table_meta,
                    )

            return fn

        def end_pass():
            cur["arrs"] = None

        return n_passes, begin_pass, end_pass

    def _cycled_accumulate(
        self, pass_fn, packed_batches, acc, strategy, pcs=None
    ):
        """Run one pass's batch_fn over every packed batch, accumulating
        host-side (labels concatenate across cycles, counts add).

        Dispatch runs in a worker thread and result fetches issue
        concurrently, so a slow fetch of one cycle's label grids does not
        serialize the others."""

        def dispatch(item):
            bi, (words, vwords) = item
            pc = pcs[bi] if pcs is not None else None
            with maybe_phase("dispatch"):
                return bi, pass_fn(
                    jnp.asarray(words), jnp.asarray(vwords), probe_cols=pc
                )

        def fetch(item):
            bi, out = item
            with maybe_phase("device_wait"):
                return bi, np.asarray(hedged_device_get(out))

        fw = int(os.environ.get("CLARK_TPU_FETCH_WORKERS", "2"))
        entries = self._pipelined(enumerate(packed_batches), dispatch)
        for bi, c in self._pipelined_pool(
            entries, fetch, workers=fw, depth=2
        ):
            if strategy == "labels":
                if acc[bi] is None:
                    acc[bi] = [c]
                else:
                    acc[bi].append(c)
            elif acc[bi] is None:
                acc[bi] = c.copy()
            else:
                acc[bi] += c

    def _cycled_finish(
        self, specs, acc, strategy, lengths, paired, extended, formatter,
        hit_stats=None,
    ):
        """Score accumulated per-batch results, scatter to file order, and
        yield formatted CSV chunks."""
        n_reads = len(lengths)
        norm_all = lengths - (NBN if paired else 0)
        tot_g = np.zeros(n_reads, np.int64)
        ib_g = np.zeros(n_reads, np.int64)
        b_g = np.zeros(n_reads, np.int64)
        sb_g = np.zeros(n_reads, np.int64)
        cnt_g = (
            np.zeros((n_reads, self.n_targets + 1), np.int32)
            if extended
            else None
        )
        if strategy == "labels":
            from .ops.device_pipeline import score_from_labels

            for (idx, stride, r_pad), parts in zip(specs, acc):
                nb = len(idx)
                lab_all = parts[0] if len(parts) == 1 else np.concatenate(
                    parts, axis=1
                )
                total, ib1, best, sb, counts = hedged_device_get(
                    score_from_labels(
                        jnp.asarray(lab_all),
                        n_targets=self.n_targets, extended=extended,
                    )
                )
                tot_g[idx] = total[:nb]
                ib_g[idx] = ib1[:nb]
                b_g[idx] = best[:nb]
                sb_g[idx] = sb[:nb]
                if extended:
                    cnt_g[idx] = counts[:nb]
        else:
            for (idx, stride, r_pad), counts in zip(specs, acc):
                nb = len(idx)
                t = counts[:nb, 1:]
                total = t.sum(axis=1, dtype=np.int64)
                best = t.max(axis=1) if t.shape[1] else np.zeros(nb, np.int32)
                ib = t.argmax(axis=1) if t.shape[1] else np.zeros(nb, np.int64)
                masked = t.copy()
                if t.shape[1]:
                    masked[np.arange(nb), ib] = -1
                sb = np.maximum(masked.max(axis=1, initial=0), 0)
                tot_g[idx] = total
                ib_g[idx] = np.where(best > 0, ib + 1, 0)
                b_g[idx] = best
                sb_g[idx] = sb
                if extended:
                    cnt_g[idx] = counts[:nb]
        if hit_stats is not None and extended:
            hit_stats.update_counts(cnt_g)
        CH = 1 << 16
        for r0 in range(0, n_reads, CH):
            r1 = min(r0 + CH, n_reads)
            yield formatter(
                r0, r1, tot_g[r0:r1], ib_g[r0:r1], b_g[r0:r1], sb_g[r0:r1],
                norm_all[r0:r1], cnt_g[r0:r1] if extended else None,
            )

    # ---------------------------------------------------- native host path
    def _classify_native(
        self, data, scan: _ScanStream, paired, extended, hit_stats=None
    ):
        """Host side fully in C++ (scan/pack/format); device step unchanged.

        Length-bucketed: reads of each planning window are grouped by stride
        tier into dense batches; per-read result scalars scatter back into
        window order and each window formats with ONE native call, so the
        CSV is byte-identical to file-order planning."""
        from .utils import native as _native

        if not self.plan.sort_batches:
            yield from self._classify_native_fileorder(
                data, scan, paired, extended, hit_stats=hit_stats
            )
            return

        k = self.k
        nbn = NBN if paired else 0
        names_buf = self._names_buffer()
        wb = 1 if extended else self.plan.sort_window_batches
        # extended columns from the device's sorted label grid instead of a
        # dense count matrix: O(windows) device cost regardless of target
        # count and ~20x smaller fetches, on single devices and every mesh
        # mode (the mesh batch_fns psum per-window labels over 'db' and
        # sort per shard-local rows; label+1 must fit u16)
        ext_runs = (
            bool(extended)
            and self.n_targets < 65535
            and _native.available()
        )
        ext_mode = "sorted" if ext_runs else extended

        def flat_batches():
            wid = 0
            for item in self._plan_hybrid_stream(scan, wb):
                if item[0] == "direct":
                    _, r0, r1, stride, r_cap = item
                    yield ("d", r0, r1, stride, r_cap)
                    continue
                _, w0, arrs, specs = item
                lens = arrs[4]
                pcs = [
                    self._probe_cols(lens[idx].max(initial=1), stride)
                    for idx, stride, _ in specs
                ]
                max_w = max(pcs)
                for (idx, stride, r_pad), pc in zip(specs, pcs):
                    yield ("w", wid, arrs, len(specs), idx, stride, r_pad,
                           max_w, pc)
                wid += 1

        def dispatch(item):
            if item[0] == "d":
                _, r0, r1, stride, r_cap = item
                ns, ne, ss, se, ln = scan.arrays(r0, r1)
                pc = self._probe_cols(ln.max(initial=1), stride)
                with maybe_phase("pack"):
                    words, vwords = _native.pack_batch(data, ss, se, stride)
                    words, vwords = _pad_batch(
                        words, vwords, _pad_rows(r1 - r0, r_cap)
                    )
                with maybe_phase("dispatch"):
                    return ("d", (ns, ne, ln), r1 - r0), self.batch_fn(
                        jnp.asarray(words), jnp.asarray(vwords),
                        extended=ext_mode, probe_cols=pc,
                    )
            _, wid, arrs, n_specs, idx, stride, r_pad, max_w, pc = item
            ss, se = arrs[2], arrs[3]
            with maybe_phase("pack"):
                words, vwords = _native.pack_batch(
                    data, ss[idx], se[idx], stride
                )
                words, vwords = _pad_batch(words, vwords, r_pad)
            with maybe_phase("dispatch"):
                return ("w", wid, arrs, n_specs, idx, max_w), self.batch_fn(
                    jnp.asarray(words), jnp.asarray(vwords),
                    extended=ext_mode, probe_cols=pc,
                )

        def fetch_group(group):
            # ONE device_get for the whole group (BatchPlan.fetch_group)
            with maybe_phase("device_wait"):
                fetched = hedged_device_get(
                    [
                        (total, ib, b, sb) + ((counts,) if extended else ())
                        for _, (total, ib, b, sb, counts) in group
                    ]
                )
            out = []
            for (meta, _), arrs_f in zip(group, fetched):
                nb = meta[2] if meta[0] == "d" else len(meta[4])
                out.append((meta, tuple(a[:nb] for a in arrs_f)))
            return out

        def fmt_window(arrs, st):
            ns, ne, ss, se, ln = arrs
            with maybe_phase("format"):
                return _native.format_rows(
                    data, ns, ne, st["total"], st["ib"], st["b"], st["sb"],
                    ln - nbn, k, names_buf,
                    counts=st["counts"],
                    sorted_runs=st["runs"],
                    n_targets=self.n_targets if extended else 0,
                )

        acc: dict[int, dict] = {}
        g = 1 if extended else max(self.plan.fetch_group, 1)
        fw = int(os.environ.get("CLARK_TPU_FETCH_WORKERS", "2"))
        entries = self._pipelined(flat_batches(), dispatch)
        groups = itertools.batched(entries, g)
        for got_group in self._pipelined_pool(
            groups, fetch_group, workers=fw, depth=2
        ):
            for meta, arrs_f in got_group:
                if meta[0] == "d":
                    _, (ns, ne, ln), nb = meta
                    if hit_stats is not None and extended:
                        if ext_runs:
                            hit_stats.update_runs(arrs_f[4])
                        else:
                            hit_stats.update_counts(arrs_f[4])
                    with maybe_phase("format"):
                        yield _native.format_rows(
                            data, ns, ne, arrs_f[0], arrs_f[1], arrs_f[2],
                            arrs_f[3], ln - nbn, k, names_buf,
                            counts=(
                                arrs_f[4]
                                if extended and not ext_runs
                                else None
                            ),
                            sorted_runs=arrs_f[4] if ext_runs else None,
                            n_targets=self.n_targets if extended else 0,
                        )
                    continue
                _, wid, arrs, n_specs, idx, max_w = meta
                st = acc.get(wid)
                if st is None:
                    n_win = len(arrs[4])
                    st = acc[wid] = dict(
                        remaining=n_specs,
                        total=np.zeros(n_win, np.int32),
                        ib=np.zeros(n_win, np.int32),
                        b=np.zeros(n_win, np.int32),
                        sb=np.zeros(n_win, np.int32),
                        counts=(
                            np.zeros((n_win, self.n_targets + 1), np.int32)
                            if extended and not ext_runs
                            else None
                        ),
                        runs=(
                            np.zeros((n_win, max_w), np.uint16)
                            if ext_runs
                            else None
                        ),
                    )
                st["total"][idx] = arrs_f[0]
                st["ib"][idx] = arrs_f[1]
                st["b"][idx] = arrs_f[2]
                st["sb"][idx] = arrs_f[3]
                if ext_runs:
                    # right-align narrower tiers: the pad zeros land BEFORE
                    # the row's own (ascending, zeros-first) labels, keeping
                    # every row globally ascending for the run expander
                    wt = arrs_f[4].shape[1]
                    st["runs"][idx, max_w - wt :] = arrs_f[4]
                elif extended:
                    st["counts"][idx] = arrs_f[4]
                st["remaining"] -= 1
                if st["remaining"] == 0:
                    del acc[wid]
                    if hit_stats is not None and extended:
                        if ext_runs:
                            hit_stats.update_runs(st["runs"])
                        else:
                            hit_stats.update_counts(st["counts"])
                    yield fmt_window(arrs, st)

    def _classify_native_fileorder(
        self, data, scan: _ScanStream, paired, extended, hit_stats=None
    ):
        """File-order planner (sort_batches=False): kept for A/B measurement
        and as the reference for the byte-identity property tests.

        The record scan streams from `scan`'s background thread; the batch
        planner blocks (inside the dispatch worker thread) only until the
        reads of the batch it is about to emit are scanned."""
        from .utils import native as _native

        k = self.k
        nbn = NBN if paired else 0
        names_buf = self._names_buffer()

        def dispatch(spec):
            r0, r1, stride, r_cap = spec
            ns, ne, ss, se, ln = scan.arrays(r0, r1)
            pc = self._probe_cols(ln.max(initial=1), stride)
            with maybe_phase("pack"):
                words, vwords = _native.pack_batch(data, ss, se, stride)
                if r1 - r0 < r_cap:
                    words = np.concatenate(
                        [words, np.zeros((r_cap - (r1 - r0), words.shape[1]), np.uint64)]
                    )
                    vwords = np.concatenate(
                        [vwords, np.zeros((r_cap - (r1 - r0), vwords.shape[1]), np.uint64)]
                    )
            with maybe_phase("dispatch"):
                return ((r0, r1), (ns, ne, ln)), self.batch_fn(
                    jnp.asarray(words), jnp.asarray(vwords),
                    extended=extended, probe_cols=pc,
                )

        def fetch_group(group):
            # ONE device_get for the whole group (BatchPlan.fetch_group)
            with maybe_phase("device_wait"):
                fetched = hedged_device_get(
                    [
                        (total, ib, b, sb) + ((counts,) if extended else ())
                        for _, (total, ib, b, sb, counts) in group
                    ]
                )
            out = []
            for (meta, _), arrs in zip(group, fetched):
                (r0, r1), _ = meta
                nb = r1 - r0
                total, ib, b, sb = (a[:nb] for a in arrs[:4])
                counts_h = arrs[4][:nb] if extended else None
                out.append((meta, total, ib, b, sb, counts_h))
            return out

        def fmt(got):
            ((r0, r1), (ns, ne, ln)), total, ib, b, sb, counts_h = got
            if hit_stats is not None and extended:
                hit_stats.update_counts(counts_h)
            with maybe_phase("format"):
                return _native.format_rows(
                    data, ns, ne, total, ib, b, sb, ln - nbn,
                    k, names_buf,
                    counts=counts_h,
                    n_targets=self.n_targets if extended else 0,
                )

        # 3-stage pipeline: pack+dispatch thread -> fetch pool -> format
        # here; each stage overlaps the others' blocked waits
        g = 1 if extended else max(self.plan.fetch_group, 1)
        fw = int(os.environ.get("CLARK_TPU_FETCH_WORKERS", "2"))
        entries = self._pipelined(self._plan_batches_stream(scan), dispatch)
        groups = itertools.batched(entries, g)
        for got_group in self._pipelined_pool(
            groups, fetch_group, workers=fw, depth=2
        ):
            for got in got_group:
                yield fmt(got)

    def _classify_cycled_native(
        self, data, ns, ne, ss, se, lengths, paired, extended, hit_stats=None
    ):
        from .utils import native as _native

        names_buf = self._names_buffer()

        def packer(idx, stride):
            return _native.pack_batch(data, ss[idx], se[idx], stride)

        def formatter(r0, r1, total, ib, b, sb, norm, counts):
            return _native.format_rows(
                data, ns[r0:r1], ne[r0:r1], total, ib, b, sb, norm, self.k,
                names_buf,
                counts=counts,
                n_targets=self.n_targets if counts is not None else 0,
            )

        yield from self._cycled_core(
            lengths, paired, extended, packer, formatter, hit_stats=hit_stats
        )

    def _names_buffer(self):
        from .utils import native as _native

        if not hasattr(self, "_names_buf"):
            self._names_buf = _native.NamesBuffer(self.target_names)
        return self._names_buf

    # --------------------------------------------------- threaded pipelining
    def _pipelined_pool(self, items, fn, workers: int, depth: int):
        """Ordered map with `workers` concurrent fn calls, up to `depth`
        submitted ahead.  Used for the result-fetch stage: issuing fetches
        concurrently overlaps their waits.  Falls back to the single-thread
        pipeline when workers <= 1."""
        if workers <= 1:
            yield from self._pipelined(items, fn, depth=depth)
            return
        import collections
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            pending: collections.deque = collections.deque()
            it = iter(items)
            try:
                while True:
                    while it is not None and len(pending) < max(depth, workers):
                        try:
                            item = next(it)
                        except StopIteration:
                            it = None
                            break
                        pending.append(ex.submit(fn, item))
                    if not pending:
                        break
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()

    def _pipelined(self, items, fn, depth: int | None = None):
        """Yield fn(item) in order, with fn running in a worker thread.

        A blocked `device_get` does not overlap host work issued from the
        same thread; moving a stage into its own thread hides it behind the
        downstream stage's waits (the native scan/pack/format calls and jax
        waits are GIL-released ctypes/C calls).  Calls CHAIN: wrapping one `_pipelined` around another builds
        a multi-stage pipeline (pack+dispatch / fetch / format+yield) with
        one thread and one bounded queue per stage; the queue bound is the
        stage's depth (default BatchPlan.pipeline_depth)."""
        import queue as _queue
        import threading

        if depth is None:
            depth = self.plan.pipeline_depth
        q: _queue.Queue = _queue.Queue(maxsize=max(depth, 1))
        stop = threading.Event()
        err: list[BaseException] = []
        _SENTINEL = object()

        def worker():
            try:
                for item in items:
                    if stop.is_set():
                        return
                    entry = fn(item)
                    while not stop.is_set():
                        try:
                            q.put(entry, timeout=0.1)
                            break
                        except _queue.Full:
                            pass
            except BaseException as e:  # re-raised by the consumer
                err.append(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(_SENTINEL, timeout=0.1)
                        break
                    except _queue.Full:
                        pass

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                entry = q.get()
                if entry is _SENTINEL:
                    break
                yield entry
            if err:
                raise err[0]
        finally:
            stop.set()
            t.join()

    # ------------------------------------------------------- packed pipeline
    def _plan_batches(self, lengths: np.ndarray):
        """Order-preserving batch boundaries with SHAPE-STABLE (R, stride):
        stride is quantized and R is always window_budget//stride (padded),
        so each stride tier compiles exactly once."""
        budget = self.plan.window_budget
        n_reads = len(lengths)
        r0 = 0
        while r0 < n_reads:
            stride = pack.quantized_stride(max(int(lengths[r0]), 1))
            if stride > budget:
                raise RuntimeError(
                    f"read of length {lengths[r0]} exceeds window budget {budget}"
                )
            r_cap = max(min(self.plan.max_reads, budget // stride), 1)
            # widen stride to cover the longest read in the candidate chunk
            while True:
                r1 = min(r0 + r_cap, n_reads)
                s2 = pack.quantized_stride(int(lengths[r0:r1].max()))
                if s2 <= stride:
                    break
                stride = s2
                r_cap = max(min(self.plan.max_reads, budget // stride), 1)
            yield r0, r1, stride, r_cap
            r0 = r1

    def _plan_batches_stream(self, scan: _ScanStream):
        """_plan_batches over a streaming scan: identical decisions (the
        lookahead is exactly the candidate batch), blocking only until the
        batch about to be emitted has been scanned."""
        budget = self.plan.window_budget
        r0 = 0
        while True:
            if scan.ensure(r0 + 1) <= r0:
                return  # input exhausted
            (first_len,) = scan.arrays(r0, r0 + 1)[4]
            stride = pack.quantized_stride(max(int(first_len), 1))
            if stride > budget:
                raise RuntimeError(
                    f"read of length {first_len} exceeds window budget {budget}"
                )
            r_cap = max(min(self.plan.max_reads, budget // stride), 1)
            while True:
                avail = scan.ensure(r0 + r_cap)
                r1 = min(r0 + r_cap, avail)
                s2 = pack.quantized_stride(int(scan.arrays(r0, r1)[4].max()))
                if s2 <= stride:
                    break
                stride = s2
                r_cap = max(min(self.plan.max_reads, budget // stride), 1)
            yield r0, r1, stride, r_cap
            r0 = r1

    # ----------------------------------------------- length-bucketed planning
    def _window_specs(self, tiers: np.ndarray):
        """Window-relative batch specs [(idx, stride, r_pad)]: reads grouped
        by stride tier (np.unique ascending; original order preserved within
        each tier, so scattered results reproduce file order exactly)."""
        budget = self.plan.window_budget
        specs = []
        for t in np.unique(tiers):
            t = int(t)
            if t > budget:
                raise RuntimeError(
                    f"read of length ~{t} exceeds window budget {budget}"
                )
            idx = np.nonzero(tiers == t)[0]
            r_cap = max(min(self.plan.max_reads, budget // t), 1)
            for i in range(0, len(idx), r_cap):
                chunk = idx[i : i + r_cap]
                specs.append((chunk, t, _pad_rows(len(chunk), r_cap)))
        return specs

    def _plan_hybrid_stream(self, scan: _ScanStream, window_batches: int):
        """Adaptive streaming planner.  While the stream is single-tier it
        yields ("direct", r0, r1, stride, r_cap) file-order contiguous
        batches, so dispatch stays paced by the record scan.  When a
        candidate batch mixes tiers it yields ("window", w0, arrs, specs)
        length-bucketed windows of ~window_batches' worth of padded chars,
        whose dense same-stride batches are the round-3 mixed-length win."""
        budget = self.plan.window_budget
        wbudget = budget * max(window_batches, 1)
        CH = 1 << 14
        r0 = 0
        while True:
            if scan.ensure(r0 + 1) <= r0:
                return
            (first_len,) = scan.arrays(r0, r0 + 1)[4]
            t0 = int(_stride_tiers(np.array([first_len]))[0])
            if t0 > budget:
                raise RuntimeError(
                    f"read of length ~{first_len} exceeds window budget "
                    f"{budget}"
                )
            r_cap = max(min(self.plan.max_reads, budget // t0), 1)
            avail = scan.ensure(r0 + r_cap)
            r1 = min(r0 + r_cap, avail)
            tiers = _stride_tiers(scan.arrays(r0, r1)[4])
            if np.all(tiers == t0):
                yield "direct", r0, r1, t0, r_cap
                r0 = r1
                continue
            w1, cost, parts = r0, 0, []
            while cost < wbudget:
                avail = scan.ensure(w1 + CH)
                take = min(avail, w1 + CH)
                if take == w1:
                    break
                t = _stride_tiers(scan.arrays(w1, take)[4])
                cum = np.cumsum(t, dtype=np.int64) + cost
                if cum[-1] >= wbudget:
                    cut = int(np.searchsorted(cum, wbudget, side="left")) + 1
                    cut = min(cut, len(t))
                    parts.append(t[:cut])
                    w1 += cut
                    break
                parts.append(t)
                cost = int(cum[-1])
                w1 = take
            tiers = np.concatenate(parts)
            yield "window", r0, scan.arrays(r0, w1), self._window_specs(tiers)
            r0 = w1

    def _plan_windows_arr(self, lengths: np.ndarray, window_batches: int):
        """Length-bucketed window planning for fully-materialized lengths
        (packed fallback path); yields
        (w0, w1, specs)."""
        budget = self.plan.window_budget * max(window_batches, 1)
        tiers = _stride_tiers(lengths)
        cum = np.cumsum(tiers, dtype=np.int64)
        n = len(lengths)
        w0 = 0
        while w0 < n:
            base = int(cum[w0 - 1]) if w0 else 0
            w1 = int(np.searchsorted(cum, base + budget, side="left")) + 1
            w1 = min(max(w1, w0 + 1), n)
            yield w0, w1, self._window_specs(tiers[w0:w1])
            w0 = w1

    def _classify_packed(
        self, rs: ReadSet, paired: bool, extended: bool, hit_stats=None
    ):
        if not self.plan.sort_batches:
            yield from self._classify_packed_fileorder(
                rs, paired, extended, hit_stats=hit_stats
            )
            return
        k = self.k
        lengths = rs.read_lengths
        norm = lengths - (NBN if paired else 0)
        names = [rs.name(i) for i in range(rs.n_reads)]
        wb = 1 if extended else self.plan.sort_window_batches

        def flat_batches():
            for wid, (w0, w1, specs) in enumerate(
                self._plan_windows_arr(lengths, wb)
            ):
                for idx, stride, r_pad in specs:
                    yield (wid, w0, w1, len(specs), idx + w0, stride, r_pad)

        def dispatch(item):
            wid, w0, w1, n_specs, idx, stride, r_pad = item
            pc = self._probe_cols(lengths[idx].max(initial=1), stride)
            words, vwords = pack.pack_batch_idx(rs, idx, stride)
            words, vwords = _pad_batch(words, vwords, r_pad)
            return (wid, w0, w1, n_specs, idx), self.batch_fn(
                jnp.asarray(words), jnp.asarray(vwords), extended=extended,
                probe_cols=pc,
            )

        def fetch(entry):
            meta, (total, ib, b, sb, counts) = entry
            fetched = hedged_device_get(
                (total, ib, b, sb) + ((counts,) if extended else ())
            )
            nb = len(meta[4])
            return meta, tuple(a[:nb] for a in fetched)

        acc: dict[int, dict] = {}
        entries = self._pipelined(flat_batches(), dispatch)
        for meta, arrs_f in self._pipelined(entries, fetch, depth=2):
            wid, w0, w1, n_specs, idx = meta
            st = acc.get(wid)
            if st is None:
                n_win = w1 - w0
                st = acc[wid] = dict(
                    remaining=n_specs,
                    total=np.zeros(n_win, np.int64),
                    ib=np.zeros(n_win, np.int64),
                    b=np.zeros(n_win, np.int64),
                    sb=np.zeros(n_win, np.int64),
                    counts=(
                        np.zeros((n_win, self.n_targets + 1), np.int32)
                        if extended
                        else None
                    ),
                )
            rel = idx - w0
            st["total"][rel] = arrs_f[0]
            st["ib"][rel] = arrs_f[1]
            st["b"][rel] = arrs_f[2]
            st["sb"][rel] = arrs_f[3]
            if extended:
                st["counts"][rel] = arrs_f[4]
            st["remaining"] -= 1
            if st["remaining"] == 0:
                del acc[wid]
                if hit_stats is not None and extended:
                    hit_stats.update_counts(st["counts"])
                for i in range(w1 - w0):
                    g = w0 + i
                    yield _format_row(
                        names[g],
                        int(st["total"][i]),
                        int(st["ib"][i]),
                        int(st["b"][i]),
                        int(st["sb"][i]),
                        int(norm[g]),
                        k,
                        self.target_names,
                        st["counts"][i] if extended else None,
                    )

    def _classify_packed_fileorder(
        self, rs: ReadSet, paired: bool, extended: bool, hit_stats=None
    ):
        k = self.k
        lengths = rs.read_lengths
        norm = lengths - (NBN if paired else 0)
        n_reads = rs.n_reads
        names = [rs.name(i) for i in range(n_reads)]

        def dispatch(spec):
            r0, r1, stride, r_cap = spec
            pc = self._probe_cols(lengths[r0:r1].max(initial=1), stride)
            words, vwords = pack.pack_batch(rs, r0, r1, stride)
            if r1 - r0 < r_cap:  # pad rows to the tier's fixed shape
                padw = np.zeros((r_cap - (r1 - r0), words.shape[1]), np.uint64)
                words = np.concatenate([words, padw])
                vwords = np.concatenate(
                    [vwords, np.zeros((r_cap - (r1 - r0), vwords.shape[1]), np.uint64)]
                )
            return (r0, r1), self.batch_fn(
                jnp.asarray(words), jnp.asarray(vwords), extended=extended,
                probe_cols=pc,
            )

        def fetch(entry):
            (r0, r1), (total, ib, b, sb, counts) = entry
            # one device_get for the batch's result arrays
            fetched = hedged_device_get(
                (total, ib, b, sb) + ((counts,) if extended else ())
            )
            counts_h = fetched[4] if extended else None
            return (r0, r1), fetched[:4], counts_h

        entries = self._pipelined(self._plan_batches(lengths), dispatch)
        for (r0, r1), (total, ib, b, sb), counts_h in self._pipelined(
            entries, fetch, depth=2
        ):
            if hit_stats is not None and extended:
                # slice off pad rows (r1-r0 < r_cap tiers / dp mesh padding):
                # a zero-hit pad row would count as a read and drag MIN to 0
                hit_stats.update_counts(counts_h[: r1 - r0])
            for i in range(r1 - r0):
                g = r0 + i
                yield _format_row(
                    names[g],
                    int(total[i]),
                    int(ib[i]),
                    int(b[i]),
                    int(sb[i]),
                    int(norm[g]),
                    k,
                    self.target_names,
                    counts_h[i] if extended else None,
                )

    # --------------------------------------------------------- flat pipeline
    def _classify_flat(
        self, rs: ReadSet, paired: bool, extended: bool, hit_stats=None
    ):
        k = self.k
        starts, rid = window_starts(rs, k)
        codes = np.where(rs.codes >= 0, rs.codes, 0).astype(np.int8)
        qvals = canonical_u64(window_values_le(codes, k, starts), k)

        lengths = rs.read_lengths
        norm = lengths - (NBN if paired else 0)
        names = [rs.name(i) for i in range(rs.n_reads)]

        QCAP, RCAP = self.plan.max_queries, self.plan.max_reads
        n_reads = rs.n_reads
        wcount = np.bincount(rid, minlength=n_reads)
        woff = np.concatenate([[0], np.cumsum(wcount)])

        r0 = 0
        while r0 < n_reads:
            r1 = min(r0 + RCAP, n_reads)
            if woff[r1] - woff[r0] > QCAP:
                r1 = int(np.searchsorted(woff, woff[r0] + QCAP, side="right")) - 1
                r1 = min(max(r1, r0 + 1), n_reads)
            nq = int(woff[r1] - woff[r0])
            if nq > QCAP:
                raise RuntimeError(
                    f"single read exceeds query budget ({nq} > {QCAP}); "
                    "increase BatchPlan.max_queries"
                )
            q = np.full(QCAP, lookup.PAD_QUERY, dtype=np.uint64)
            qr = np.zeros(QCAP, dtype=np.int32)
            q[:nq] = qvals[woff[r0] : woff[r1]]
            qr[:nq] = (rid[woff[r0] : woff[r1]] - r0).astype(np.int32)

            total, ib, b, sb, counts = self.query_fn(
                self.keys, self.labels1, jnp.asarray(q), jnp.asarray(qr)
            )
            nb = r1 - r0
            fetched = hedged_device_get(
                (total, ib, b, sb) + ((counts,) if extended else ())
            )
            total, ib, b, sb = (a[:nb] for a in fetched[:4])
            counts_h = fetched[4][:nb] if extended else None
            if hit_stats is not None and extended:
                hit_stats.update_counts(counts_h)

            for i in range(nb):
                g = r0 + i
                yield _format_row(
                    names[g],
                    int(total[i]),
                    int(ib[i]),
                    int(b[i]),
                    int(sb[i]),
                    int(norm[g]),
                    k,
                    self.target_names,
                    counts_h[i] if extended else None,
                )
            r0 = r1


def _format_row(
    name: bytes,
    total: int,
    index_best: int,
    best: int,
    s_best: int,
    norm: int,
    k: int,
    target_names: list[str],
    counts_row: np.ndarray | None,
) -> bytes:
    # Gamma/Confidence exactly as CuCLARK_hh.hh:2042-2051 (double math, %g)
    denom = float(norm) - k + 1.0
    if denom == 0.0:
        # C prints 0.0/0.0 as "-nan" (glibc); match it byte-for-byte
        return _format_row_nan(name, best, target_names, counts_row)
    gamma = float(total) / denom
    delta = float(best + s_best)
    conf = 0.0 if delta < 0.001 else float(best) / delta
    ext = b""
    if counts_row is not None:
        # columns 1..T of the dense count matrix
        ext = b"".join(b",%d" % int(c) for c in counts_row[1:])
    return b"%s%s,%s,%s,%u,%s\n" % (
        name,
        ext,
        _g(gamma),
        target_names[index_best].encode(),
        best,
        _g(conf),
    )


def _format_row_nan(name, best, target_names, counts_row) -> bytes:
    ext = b""
    if counts_row is not None:
        ext = b"".join(b",%d" % int(c) for c in counts_row[1:])
    return b"%s%s,-nan,%s,%u,0\n" % (name, ext, target_names[0].encode(), best)


def _g(x: float) -> bytes:
    """C printf %g formatting (Python's %g matches)."""
    return b"%g" % x


# ------------------------------------------------------------------ device fn
@functools.partial(jax.jit, static_argnames=("n_targets", "max_reads"))
def _query_single(keys, labels1, q, qread, *, n_targets: int, max_reads: int):
    lab = lookup.lookup_labels(keys, labels1, q)
    counts = score.counts_from_hits(lab, qread, max_reads, n_targets)
    total, ib, b, isb, sb = score.read_results(counts)
    return total, ib, b, sb, counts
