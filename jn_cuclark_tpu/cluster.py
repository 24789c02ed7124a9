"""Multi-node coordinator — the kent-mpi replacement.

The reference (app/kent_mpi.cpp) statically assigns one FASTQ per hostname in
an INI config, launches itself under `mpirun` over SSH, runs `kent -c` +
`kent -a` per rank, sends pipe-delimited NodeResult strings to rank 0, and
merges abundances into results/cluster_report.txt.

This redesign keeps the same config format and report but replaces
MPI/SSH with JAX process semantics:

  * single-process mode (default): every node entry whose reads are readable
    from this machine is processed here, sequentially — this covers the
    reference's practical use (multi-sample batch) on one GPU host, and is
    how `kent-mpi`-style runs are tested without a cluster.
  * multi-process mode ([cluster] backend = jax_distributed): each host runs
    the same command; `jax.distributed.initialize` joins the processes, each
    process classifies the reads assigned to ITS hostname, per-node results
    are all-gathered over the network with
    `jax.experimental.multihost_utils`, and process 0 merges + writes the
    report.

Result merging is abundance-level (CSV sums), exactly like the reference —
the heavy data (DB, reads) never crosses hosts.
"""

from __future__ import annotations

import configparser
import dataclasses
import datetime
import json
import os
import socket
import time

from .utils.logging import ClusterLogger


@dataclasses.dataclass
class NodeSpec:
    hostname: str
    reads: list[str]  # 1 (single-end) or 2 (paired) paths


@dataclasses.dataclass
class ClusterConfig:
    master: str
    workers: list[str]
    cuclark_dir: str
    database: str
    results_dir: str
    nodes: list[NodeSpec]
    batch_size: int = 32
    kmer_size: int | None = None
    min_freq_target: int = 0
    num_devices: int | None = None
    gap_iteration: int | None = None
    sampling_factor: int = 1
    extended: bool = False
    gzipped: bool = False
    shard_db: bool = False  # jax_distributed: shard the DB across ALL hosts
    db_cycles: int = 1  # out-of-core cycles per device (composes with shard_db)
    dp: int = 1  # with shard_db: data-parallel width of a 2-D dp x db mesh
    # (reads sharded over each host's dp devices, table rows over db = hosts)
    master_processes_reads: bool = True
    keep_local_results: bool = True
    log_level: str = "info"
    log_file: str = "cluster_run.log"
    backend: str = "local"  # "local" | "jax_distributed"
    coordinator_address: str | None = None
    ssh_command: str = "ssh -o BatchMode=yes"  # launcher transport; tests
    # and odd clusters override (env CLARK_TPU_SSH wins over the config)
    launch_command: str = "clark-tpu"  # remote CLI entry point; set to e.g.
    # "python -m jn_cuclark_tpu.cli" when the entry point is not on PATH
    report_port: int | None = None  # master's result-gather TCP port
    # (default: coordinator port + 1); the gather is a plain socket, NOT a
    # collective, so a dead worker cannot hang the master (kent_mpi.cpp:
    # 518-521 master-recv parity with containment 712-727)
    report_timeout: float = 900.0  # seconds the master waits per gather
    # before reporting missing workers as FAILED (env
    # CLARK_TPU_REPORT_TIMEOUT overrides)

    @classmethod
    def load(cls, path: str) -> "ClusterConfig":
        ini = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
        ini.optionxform = str  # hostnames are case-sensitive keys
        with open(path) as f:
            ini.read_file(f)
        cl = ini["cluster"] if "cluster" in ini else {}
        paths = ini["paths"] if "paths" in ini else {}
        reads = ini["reads"] if "reads" in ini else {}
        classif = ini["classification"] if "classification" in ini else {}
        options = ini["options"] if "options" in ini else {}
        logging_ = ini["logging"] if "logging" in ini else {}
        workers = [
            w.strip() for w in cl.get("workers", "").split(",") if w.strip()
        ]
        nodes = []
        for host, spec in reads.items():
            files = [p.strip() for p in spec.split(",") if p.strip()]
            if files:
                nodes.append(NodeSpec(hostname=host, reads=files))

        def b(section, key, default):
            v = section.get(key, None)
            if v is None:
                return default
            return str(v).strip().lower() in ("1", "true", "yes", "on")

        return cls(
            master=cl.get("master", socket.gethostname()),
            workers=workers,
            cuclark_dir=paths.get("cuclark_dir", "."),
            database=paths.get("database", ""),
            results_dir=paths.get("results_dir", "results"),
            nodes=nodes,
            batch_size=int(classif.get("batch_size", 32)),
            kmer_size=int(classif["kmer_size"]) if classif.get("kmer_size") else None,
            min_freq_target=int(classif.get("min_freq_target", 0)),
            num_devices=int(classif["num_devices"]) if classif.get("num_devices") else None,
            gap_iteration=int(classif["gap_iteration"]) if classif.get("gap_iteration") else None,
            sampling_factor=int(float(classif.get("sampling_factor", 1)) or 1),
            extended=b(classif, "extended", False),
            gzipped=b(classif, "gzipped", False),
            shard_db=b(classif, "shard_db", False),
            db_cycles=int(classif.get("db_cycles", 1)),
            dp=int(classif.get("dp", 1)),
            master_processes_reads=b(options, "master_processes_reads", True),
            keep_local_results=b(options, "keep_local_results", True),
            log_level=logging_.get("level", "info"),
            log_file=logging_.get("file", "cluster_run.log"),
            backend=cl.get("backend", "local"),
            coordinator_address=cl.get("coordinator_address", None),
            ssh_command=cl.get("ssh_command", "ssh -o BatchMode=yes"),
            launch_command=cl.get("launch_command", "clark-tpu"),
            report_port=(
                int(cl["report_port"]) if cl.get("report_port") else None
            ),
            report_timeout=float(cl.get("report_timeout", 900.0)),
        )

    def validate(self) -> list[str]:
        problems = []
        if not self.database:
            problems.append("[paths] database is required")
        elif not os.path.isdir(self.database):
            problems.append(f"database directory not found: {self.database}")
        if not self.nodes:
            problems.append("[reads] section has no node entries")
        for n in self.nodes:
            if len(n.reads) > 2:
                problems.append(f"{n.hostname}: more than 2 read files")
        known = {self.master, *self.workers}
        for n in self.nodes:
            if n.hostname not in known:
                problems.append(
                    f"[reads] host '{n.hostname}' not in master/workers list"
                )
        if not self.master_processes_reads:
            for n in self.nodes:
                if n.hostname == self.master:
                    problems.append(
                        "master has reads but master_processes_reads = false"
                    )
        return problems


@dataclasses.dataclass
class NodeResult:
    hostname: str
    success: bool
    elapsed_seconds: float = 0.0
    reads: int = 0
    result_file: str = ""
    abundance_file: str = ""
    error_message: str = ""


def _result_paths(cfg: ClusterConfig, host: str, reads_path: str):
    base = os.path.splitext(os.path.basename(reads_path))[0]
    rdir = cfg.results_dir
    if not os.path.isabs(rdir):
        rdir = os.path.join(cfg.cuclark_dir, rdir)
    os.makedirs(rdir, exist_ok=True)
    return (
        os.path.join(rdir, f"{host}_{base}"),
        os.path.join(rdir, f"{host}_abundance.csv"),
        rdir,
    )


def run_node(cfg: ClusterConfig, node: NodeSpec, log: ClusterLogger) -> NodeResult:
    """Classify + abundance for one node's reads (run_classification_local,
    kent_mpi.cpp:508-631)."""
    from . import abundance, database
    from .engine import Classifier

    t0 = time.time()
    try:
        dbcfg = database.DBConfig.load(cfg.database)
        prof = dbcfg.profile
        mesh = None
        if cfg.num_devices and cfg.num_devices > 1:
            from .parallel.mesh import make_mesh

            mesh = make_mesh(cfg.num_devices)
        clf = Classifier.load(
            dbcfg.subdb,
            dbcfg.targets,
            prof,
            k=cfg.kmer_size or dbcfg.k,
            min_count_target=cfg.min_freq_target or dbcfg.min_count_target,
            sampling_factor=cfg.sampling_factor,
            gap=cfg.gap_iteration or dbcfg.gap,
            mesh=mesh,
        )
        reads0 = node.reads[0]
        result_base, abundance_file, rdir = _result_paths(cfg, node.hostname, reads0)
        log.info(f"[{node.hostname}] classifying {reads0}")
        stats = clf.classify_file(
            reads0,
            result_base,
            paired_path=node.reads[1] if len(node.reads) > 1 else None,
            extended=cfg.extended,
        )
        res = abundance.estimate([stats["result"]], db_dir=cfg.database)
        with open(abundance_file, "w") as f:
            f.write(res.text())
        log.info(
            f"[{node.hostname}] done: {stats['reads']} reads in "
            f"{stats['seconds']:.1f}s"
        )
        return NodeResult(
            hostname=node.hostname,
            success=True,
            elapsed_seconds=time.time() - t0,
            reads=stats["reads"],
            result_file=stats["result"],
            abundance_file=abundance_file,
        )
    except Exception as e:  # noqa: BLE001 — contained per-node failure
        log.error(f"[{node.hostname}] FAILED: {e}")
        return NodeResult(
            hostname=node.hostname,
            success=False,
            elapsed_seconds=time.time() - t0,
            error_message=str(e),
        )


def run_sharded(cfg: ClusterConfig, log: ClusterLogger) -> list[NodeResult]:
    """DB-sharded multi-host classification — the mode the reference never
    had (kent-mpi gives each node a full DB copy, kent_mpi.cpp:508-631;
    BASELINE config 5 asks for the DB sharded across hosts instead).

    Every process holds 1/P of the hash table on its devices (1/(P*cycles)
    in HBM with db_cycles); every sample in [reads] is classified JOINTLY by
    all processes — each packs the same read batches (inputs must be
    readable on every host), probes its shard, and per-read counts merge
    with a psum over the network.  Process 0 writes the CSVs/abundance; the
    others drain the same collective program."""
    import jax

    from . import abundance, database
    from .engine import Classifier
    from .io.fasta import merge_paired
    from .parallel.mesh import make_mesh, make_mesh2d

    pid = jax.process_index()
    dbcfg = database.DBConfig.load(cfg.database)
    if cfg.dp > 1:
        # 2-D: table rows over db = hosts (network), reads over each host's
        # dp devices (NVLink) — each device probes 1/dp of the batch against
        # 1/db of the table
        total = cfg.num_devices or len(jax.devices())
        if total % cfg.dp:
            raise ValueError(f"dp={cfg.dp} must divide device count {total}")
        mesh = make_mesh2d(cfg.dp, total // cfg.dp)
    else:
        mesh = make_mesh(cfg.num_devices)  # all global devices by default
    log.info(
        f"shard_db: {mesh.devices.size} devices across "
        f"{jax.process_count()} processes, db_cycles={cfg.db_cycles}, "
        f"dp={cfg.dp}"
    )
    clf = Classifier.load(
        dbcfg.subdb,
        dbcfg.targets,
        dbcfg.profile,
        k=cfg.kmer_size or dbcfg.k,
        min_count_target=cfg.min_freq_target or dbcfg.min_count_target,
        sampling_factor=cfg.sampling_factor,
        gap=cfg.gap_iteration or dbcfg.gap,
        mesh=mesh,
        mesh_mode="db",
        db_cycles=cfg.db_cycles,
    )
    results: list[NodeResult] = []
    for node in cfg.nodes:
        t0 = time.time()
        reads0 = node.reads[0]
        result_base, abundance_file, rdir = _result_paths(
            cfg, node.hostname, reads0
        )
        try:
            with open(reads0, "rb") as f:
                data = f.read()
            paired = len(node.reads) > 1
            if paired:
                with open(node.reads[1], "rb") as f:
                    data = merge_paired(data, f.read())
            log.info(f"[{node.hostname}] sharded classify {reads0}")
            gen, n_reads = clf.classify_bytes(
                data, paired=paired, extended=cfg.extended
            )
            if pid == 0:
                out = result_base + ".csv"
                with open(out, "wb") as f:
                    f.write(clf._header(cfg.extended))
                    for chunk in gen:
                        f.write(chunk)
                res = abundance.estimate([out], db_dir=cfg.database)
                with open(abundance_file, "w") as f:
                    f.write(res.text())
            else:
                for _ in gen:  # drive the same collectives, discard bytes
                    pass
                out, abundance_file = "", ""
            results.append(
                NodeResult(
                    hostname=node.hostname,
                    success=True,
                    elapsed_seconds=time.time() - t0,
                    reads=n_reads,
                    result_file=out,
                    abundance_file=abundance_file,
                )
            )
        except Exception as e:  # noqa: BLE001 — deterministic across procs
            log.error(f"[{node.hostname}] FAILED: {e}")
            results.append(
                NodeResult(
                    hostname=node.hostname,
                    success=False,
                    elapsed_seconds=time.time() - t0,
                    error_message=str(e),
                )
            )
    return results


def generate_report(
    cfg: ClusterConfig, results: list[NodeResult], merged_path: str, out_path: str
):
    """cluster_report.txt, format-compatible with kent_mpi.cpp:679-747."""
    with open(out_path, "w") as report:
        w = report.write
        w("========================================\n")
        w("  CuCLARK Cluster Classification Report\n")
        w(f"  Generated: {datetime.datetime.now().strftime('%Y-%m-%d %H:%M:%S')}\n")
        w("========================================\n\n")
        w("CLUSTER CONFIGURATION\n")
        w(f"  Master: {cfg.master}\n")
        w("  Workers: " + ", ".join(cfg.workers) + "\n")
        w(f"  Database: {cfg.database}\n")
        w(f"  K-mer size: {cfg.kmer_size or 'db default'}\n")
        w(f"  Batch size: {cfg.batch_size}\n")
        w(f"  Processes: {len(results)}\n\n")
        w("NODE RESULTS\n")
        w("-" * 60 + "\n")
        total_success = 0
        total_time = 0.0
        max_time = 0.0
        for r in results:
            w(f"  {r.hostname}:\n")
            w(f"    Status: {'SUCCESS' if r.success else 'FAILED'}\n")
            if r.success:
                w(f"    Elapsed: {r.elapsed_seconds:.1f} seconds\n")
                w(f"    Result: {r.result_file}\n")
                if r.abundance_file:
                    w(f"    Abundance: {r.abundance_file}\n")
                total_success += 1
                total_time += r.elapsed_seconds
                max_time = max(max_time, r.elapsed_seconds)
            else:
                w(f"    Error: {r.error_message}\n")
            w("\n")
        if merged_path:
            w("MERGED ABUNDANCE\n")
            w("-" * 60 + "\n")
            w(f"  {merged_path}\n\n")
        w("SUMMARY\n")
        w("-" * 60 + "\n")
        w(f"  Nodes processed: {total_success}/{len(results)}\n")
        w(f"  Total CPU time: {total_time:.1f} seconds\n")
        w(f"  Wall clock time: {max_time:.1f} seconds (parallel)\n")
        speedup = total_time / max_time if max_time > 0 else 0
        w(f"  Speedup: {speedup:.2f}x\n\n")


def preflight(cfg: ClusterConfig, log: ClusterLogger) -> bool:
    """kent-mpi -p: config + per-node input checks (no SSH — reachability is
    JAX-distributed's job in multi-process mode)."""
    problems = cfg.validate()
    for p in problems:
        log.error(p)
    for n in cfg.nodes:
        for path in n.reads:
            if os.path.exists(path):
                log.info(f"[{n.hostname}] reads OK: {path}")
            elif cfg.shard_db:
                # sharded mode: every process packs every sample, so inputs
                # must be readable on every host
                log.error(
                    f"[{n.hostname}] shard_db requires reads readable on "
                    f"every host: {path}"
                )
                problems.append(f"unreadable reads for shard_db: {path}")
            else:
                log.warn(
                    f"[{n.hostname}] reads not readable from this host: {path}"
                    " (fine if they live on that node)"
                )
    if cfg.backend == "jax_distributed" and not cfg.coordinator_address:
        log.warn(
            "coordinator_address not set: `cluster --launch` will default "
            f"to {cfg.master}:12357; hand-started workers must set it (or "
            "CLARK_TPU_COORDINATOR)"
        )
    # lint: a master/worker host with no [reads] entry idles in
    # sample-parallel multi-process mode
    if cfg.backend == "jax_distributed" and not cfg.shard_db:
        with_reads = {n.hostname for n in cfg.nodes}
        for h in [cfg.master, *cfg.workers]:
            if h not in with_reads:
                log.warn(f"host {h} has no [reads] entry and will idle")
    log.info("Preflight " + ("PASSED" if not problems else "FAILED"))
    return not problems


def run(cfg: ClusterConfig, log: ClusterLogger) -> int:
    from . import abundance

    problems = cfg.validate()
    if problems:
        for p in problems:
            log.error(p)
        return 1

    # CLARK_TPU_NODE_NAME lets tests (and containers whose hostname differs
    # from the config) pick their [reads] entry explicitly
    my_host = os.environ.get("CLARK_TPU_NODE_NAME") or socket.gethostname()
    multiproc = cfg.backend == "jax_distributed"
    if multiproc:
        import jax

        kw = {}
        if os.environ.get("CLARK_TPU_NUM_PROCESSES"):
            kw["num_processes"] = int(os.environ["CLARK_TPU_NUM_PROCESSES"])
            kw["process_id"] = int(os.environ.get("CLARK_TPU_PROCESS_ID", "0"))
        coord = cfg.coordinator_address or os.environ.get(
            "CLARK_TPU_COORDINATOR"  # preset by `cluster --launch`
        )
        jax.distributed.initialize(coordinator_address=coord, **kw)
        pid = jax.process_index()
        nproc = jax.process_count()
        mine = [
            n for n in cfg.nodes if n.hostname == my_host
        ]
        log.info(f"jax.distributed: process {pid}/{nproc} on {my_host}")
        if not mine and not cfg.shard_db:
            # config-lint (a typo'd hostname silently idles a worker)
            log.warn(
                f"no [reads] entry matches this host ({my_host}); this "
                "process will idle — check the [reads] hostnames or set "
                "CLARK_TPU_NODE_NAME"
            )
    else:
        pid, nproc = 0, 1
        mine = [
            n
            for n in cfg.nodes
            if all(os.path.exists(p) for p in n.reads)
        ]
        skipped = [n.hostname for n in cfg.nodes if n not in mine]
        if skipped:
            log.warn(f"skipping nodes without locally readable reads: {skipped}")

    if multiproc and cfg.shard_db:
        # joint DB-sharded classification: every process computes every
        # sample; no result gather needed (outputs are replicated).  A peer
        # dying MID-COLLECTIVE cannot be contained (the psum needs every
        # shard's rows) — fail FAST with a clear report instead of a hung
        # process or a raw distributed-runtime stack trace.
        try:
            results = run_sharded(cfg, log)
        except BaseException as e:  # noqa: BLE001 — report, then fail
            log.error(
                f"shard-db run aborted: {e} — in shard-db mode every "
                "process holds 1/P of the table, so a dead worker is "
                "unrecoverable; restart the cluster (sample-parallel mode "
                "contains dead workers instead)"
            )
            results = [
                NodeResult(
                    hostname=n.hostname, success=False,
                    elapsed_seconds=0.0,
                    error_message=f"shard-db collective aborted: {e}",
                )
                for n in cfg.nodes
            ]
            if pid == 0:
                _write_failure_report(cfg, results, log)
            return 1
        if pid != 0:
            return 0
    else:
        results = [run_node(cfg, n, log) for n in mine]
        if multiproc:
            if os.environ.get("CLARK_TPU_FAULT_DIE_BEFORE_REPORT") and (
                pid != 0
            ):
                os._exit(3)  # fault injection (containment tests)
            if pid != 0:
                # plain-socket report to the master: a collective gather
                # would hang every process on one dead worker
                _send_results_worker(cfg, results, pid, log)
                return 0
            results = _gather_results_master(cfg, results, nproc, log)

    # master: merge + report (kent_mpi.cpp:637-747)
    rdir = cfg.results_dir
    if not os.path.isabs(rdir):
        rdir = os.path.join(cfg.cuclark_dir, rdir)
    os.makedirs(rdir, exist_ok=True)
    ab_files = [r.abundance_file for r in results if r.success and r.abundance_file]
    merged_path = ""
    if len(ab_files) >= 2:
        merged_path = os.path.join(rdir, "cluster_abundance.csv")
        abundance.merge(ab_files, merged_path)
        log.info(f"merged abundance -> {merged_path}")
    elif len(ab_files) == 1:
        merged_path = ab_files[0]
    report_path = os.path.join(rdir, "cluster_report.txt")
    generate_report(cfg, results, merged_path, report_path)
    log.info(f"report written to {report_path}")
    return 0 if all(r.success for r in results) and results else 1


def _write_failure_report(cfg: ClusterConfig, results, log) -> None:
    """Best-effort cluster_report.txt for an aborted shard-db run."""
    rdir = cfg.results_dir
    if not os.path.isabs(rdir):
        rdir = os.path.join(cfg.cuclark_dir, rdir)
    try:
        os.makedirs(rdir, exist_ok=True)
        path = os.path.join(rdir, "cluster_report.txt")
        generate_report(cfg, results, "", path)
        log.info(f"failure report written to {path}")
    except OSError as e:
        log.error(f"could not write failure report: {e}")


def _report_endpoint(cfg: ClusterConfig) -> tuple[str, int]:
    """(master_host, port) of the result-gather socket."""
    host, port = cfg.master, 12358
    if cfg.coordinator_address and ":" in cfg.coordinator_address:
        host, cport = cfg.coordinator_address.rsplit(":", 1)
        port = int(cport) + 1
    if cfg.report_port:
        port = cfg.report_port
    return host, port


def _gather_results_master(
    cfg: ClusterConfig, own: list[NodeResult], nproc: int, log
) -> list[NodeResult]:
    """Master side of the result gather: accept one JSON payload per worker
    over a plain TCP socket with a deadline.  A worker that died mid-run
    simply never reports — its node entries are synthesized as FAILED and
    the run completes with a report, like the reference master's per-worker
    MPI_Recv + failure rows (kent_mpi.cpp:518-521, 712-727).  A collective
    gather (the cross-host allgather) would instead hang every surviving
    process on the dead one."""
    import struct

    timeout = float(
        os.environ.get("CLARK_TPU_REPORT_TIMEOUT", cfg.report_timeout)
    )
    _, port = _report_endpoint(cfg)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("", port))
    srv.listen(nproc)
    deadline = time.time() + timeout
    got: dict[int, list[NodeResult]] = {}
    while len(got) < nproc - 1:
        remain = deadline - time.time()
        if remain <= 0:
            break
        srv.settimeout(min(remain, 5.0))
        try:
            conn, _addr = srv.accept()
        except socket.timeout:
            continue
        try:
            conn.settimeout(30.0)
            hdr = b""
            while len(hdr) < 8:
                b_ = conn.recv(8 - len(hdr))
                if not b_:
                    break
                hdr += b_
            if len(hdr) < 8:
                continue
            pid, ln = struct.unpack("!ii", hdr)
            buf = b""
            while len(buf) < ln:
                b_ = conn.recv(min(ln - len(buf), 1 << 20))
                if not b_:
                    break
                buf += b_
            if len(buf) == ln:
                got[pid] = [
                    NodeResult(**d) for d in json.loads(buf.decode())
                ]
                log.info(f"results received from process {pid}")
        except (OSError, ValueError) as e:
            log.warn(f"bad result report: {e}")
        finally:
            conn.close()
    srv.close()
    out = list(own)
    hosts = [cfg.master, *cfg.workers]
    for pid in range(1, nproc):
        if pid in got:
            out.extend(got[pid])
            continue
        host = hosts[pid] if pid < len(hosts) else f"process-{pid}"
        log.error(
            f"no results from process {pid} ({host}) within {timeout:.0f}s "
            "— worker died or is unreachable; reporting its nodes FAILED"
        )
        owned = [
            n.hostname for n in cfg.nodes
            if n.hostname == host and not any(
                r.hostname == n.hostname for r in out
            )
        ] or [host]
        for h in owned:
            out.append(
                NodeResult(
                    hostname=h,
                    success=False,
                    elapsed_seconds=0.0,
                    error_message=(
                        f"no report from process {pid} (worker died or "
                        "unreachable)"
                    ),
                )
            )
    return out


def _send_results_worker(
    cfg: ClusterConfig, results: list[NodeResult], pid: int, log
) -> None:
    """Worker side: push this process's NodeResults to the master's gather
    socket (bounded retries — the master may still be classifying)."""
    import struct

    host, port = _report_endpoint(cfg)
    payload = json.dumps([dataclasses.asdict(r) for r in results]).encode()
    err = None
    for attempt in range(30):
        try:
            with socket.create_connection((host, port), timeout=10.0) as s:
                s.sendall(struct.pack("!ii", pid, len(payload)) + payload)
            return
        except OSError as e:
            err = e
            time.sleep(min(2.0 * (attempt + 1), 10.0))
    log.error(f"could not deliver results to master {host}:{port}: {err}")


def _allgather_results(results: list[NodeResult]) -> list[NodeResult]:
    """Gather per-process NodeResults to every process over the network
    (replaces the reference's MPI_Send/Recv of pipe-delimited strings).

    Payloads are arbitrary-size: a first all-gather agrees on the max byte
    length, then each process pads its JSON to that common size — no silent
    truncation (round-1 capped at 64 KiB and could corrupt the master's
    json.loads)."""
    import numpy as np

    payload = json.dumps([dataclasses.asdict(r) for r in results]).encode()
    rows = allgather_bytes(payload)
    out: list[NodeResult] = []
    for b in rows:
        if b:
            out.extend(NodeResult(**d) for d in json.loads(b.decode()))
    return out


def allgather_bytes(payload: bytes) -> list[bytes]:
    """All-gather one variable-length byte string per process; returns the
    list of every process's payload, in process order."""
    import numpy as np
    from jax.experimental import multihost_utils

    n = np.asarray(
        multihost_utils.process_allgather(
            np.array(len(payload), dtype=np.int64), tiled=False
        )
    )
    cap = max(int(n.max()), 1)
    arr = np.zeros(cap, dtype=np.uint8)
    arr[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    gathered = np.asarray(
        multihost_utils.process_allgather(arr, tiled=False)
    ).reshape(-1, cap)
    return [bytes(gathered[i, : int(n.flat[i])]) for i in range(gathered.shape[0])]


def card_per_process(hosts: list[str], local_names: set[str]) -> list[str | None]:
    """CUDA_VISIBLE_DEVICES for each launched process, or None to leave it
    unset.  Process 0 runs on this machine, as does every worker named
    like it; when several processes share a machine each gets its own card
    (the k-th process there sees card k), because a JAX process reserves
    most of every card it can see and a second one would run out of
    memory.  A process alone on its machine sees all of its cards."""
    local = local_names | {"localhost", "127.0.0.1", "::1"}
    machine = ["" if i == 0 or h in local else h for i, h in enumerate(hosts)]
    return [
        str(machine[:i].count(m)) if machine.count(m) > 1 else None
        for i, m in enumerate(machine)
    ]


def launch(cfg: ClusterConfig, log: ClusterLogger, conf_path: str) -> int:
    """Launcher mode (kent_mpi.cpp:753-915 parity): ONE command starts the
    whole cluster run.  Process ids derive from the master+workers list (the
    reference's generated hostfile, :753-776); each worker host is
    SSH-preflighted (:827-864) then spawned as `<launch_command> cluster -c
    <conf>` with CLARK_TPU_NUM_PROCESSES / CLARK_TPU_PROCESS_ID /
    CLARK_TPU_NODE_NAME preset (replacing the reference's self-invoked
    `mpirun --hostfile ...`, :884-907); the master runs as process 0
    locally.  Remote output streams through the cluster log, prefixed per
    host."""
    import shlex
    import subprocess
    import threading

    conf_path = os.path.abspath(conf_path)
    workers = [w for w in cfg.workers if w != cfg.master]
    if len(set(workers)) != len(workers):
        dups = sorted({w for w in workers if workers.count(w) > 1})
        log.error(
            f"[cluster] workers lists duplicate host(s): {', '.join(dups)} "
            "— each worker host must appear once (process ids derive from "
            "the master+workers order)"
        )
        return 1
    hosts = [cfg.master] + workers
    n = len(hosts)
    if n > 1 and cfg.backend != "jax_distributed":
        log.error(
            "launcher mode with workers requires [cluster] backend = "
            "jax_distributed (local backend has no cross-host merge)"
        )
        return 1
    coord = cfg.coordinator_address or f"{cfg.master}:12357"
    local_names = {socket.gethostname(), socket.gethostname().split(".")[0]}
    if n > 1 and cfg.master not in local_names and not cfg.coordinator_address:
        # process 0 (and the jax.distributed coordinator) runs HERE, but the
        # workers will dial <master>:12357 — only correct when this host IS
        # the configured master or coordinator_address points back here
        log.warn(
            f"launching from {socket.gethostname()!r} but [cluster] master "
            f"= {cfg.master!r}: workers will connect to {coord}, which must "
            "reach THIS process. Launch from the master host or set "
            "[cluster] coordinator_address explicitly."
        )
    ssh = shlex.split(os.environ.get("CLARK_TPU_SSH") or cfg.ssh_command)
    launch_cmd = cfg.launch_command

    # preflight every remote host before spawning anything (reference
    # behavior: abort the whole launch on an unreachable worker)
    for host in hosts[1:]:
        try:
            r = subprocess.run(
                ssh + [host, "true"], capture_output=True, text=True,
                timeout=60,
            )
        except subprocess.TimeoutExpired:
            log.error(f"[{host}] SSH preflight timed out after 60s")
            return 1
        if r.returncode != 0:
            log.error(
                f"[{host}] SSH preflight failed (rc={r.returncode}): "
                f"{(r.stderr or r.stdout).strip()[:200]}"
            )
            return 1
        log.info(f"[{host}] SSH preflight OK")

    procs: list[tuple[str, subprocess.Popen]] = []
    threads = []

    def stream(host, proc):
        for line in proc.stdout:
            log.info(f"[{host}] {line.rstrip()}")

    cards = card_per_process(hosts, local_names)

    def env_for(i, host):
        env = {
            "CLARK_TPU_NUM_PROCESSES": str(n),
            "CLARK_TPU_PROCESS_ID": str(i),
            "CLARK_TPU_NODE_NAME": host,
            "CLARK_TPU_COORDINATOR": coord,
        }
        if cards[i] is not None:
            env["CUDA_VISIBLE_DEVICES"] = cards[i]
        return env

    try:
        for i, host in enumerate(hosts):
            worker_cmd = f"{launch_cmd} cluster -c {shlex.quote(conf_path)}"
            if i == 0:
                env = dict(os.environ, **env_for(i, host))
                argv = shlex.split(launch_cmd) + ["cluster", "-c", conf_path]
                p = subprocess.Popen(
                    argv, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True,
                )
            else:
                exports = " ".join(
                    f"{k}={shlex.quote(v)}" for k, v in env_for(i, host).items()
                )
                p = subprocess.Popen(
                    ssh + [host, f"env {exports} {worker_cmd}"],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
            procs.append((host, p))
            t = threading.Thread(target=stream, args=(host, p), daemon=True)
            t.start()
            threads.append(t)
            log.info(f"[{host}] spawned as process {i}/{n}")
        rcs = [(host, p.wait()) for host, p in procs]
        for t in threads:
            t.join(timeout=5)
        for i, (host, rc) in enumerate(rcs):
            (log.info if rc == 0 else log.error)(
                f"[{host}] process {i} exited rc={rc}"
            )
        return rcs[0][1] if all(rc == 0 for _, rc in rcs) else 1
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.terminate()


def main(args) -> int:
    cfg = ClusterConfig.load(args.config)
    logfile = cfg.log_file
    if not os.path.isabs(logfile):
        logfile = os.path.join(cfg.cuclark_dir, "logs", logfile)
    log = ClusterLogger(level=cfg.log_level, logfile=logfile)
    try:
        if args.preflight:
            return 0 if preflight(cfg, log) else 1
        if getattr(args, "launch", False):
            problems = cfg.validate()
            if problems:
                for p in problems:
                    log.error(p)
                return 1
            return launch(cfg, log, args.config)
        return run(cfg, log)
    finally:
        log.close()
