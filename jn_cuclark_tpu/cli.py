"""clark-tpu — single CLI replacing the reference's kent + shell scripts +
cuCLARK binaries.

Subcommands (reference equivalents):
    db set-targets   kent -d / set_targets.sh + make_metadata.sh
    db build         cuCLARK first-run DB construction (makeSpecificTargetSets)
    classify         kent -c / classify_metagenome.sh / cuCLARK[-l]
    abundance        kent -a / estimate_abundance.sh / getAbundance
    merge            kent -m
    report           kent -r
    verify           kent --verify
    cluster          kent-mpi (multi-host / multi-sample coordinator)

Run `python -m jn_cuclark_tpu.cli <cmd> --help` for flags.
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys
import time


def _profile_from_args(args, cfg=None):
    from .params import FULL, LIGHT, Profile

    if getattr(args, "light", False):
        prof = LIGHT
    elif getattr(args, "full", False):
        prof = FULL
    elif cfg is not None:
        prof = cfg.profile
    else:
        prof = LIGHT
    if getattr(args, "htsize", None):
        prof = Profile(
            name=f"custom{args.htsize}",
            htsize=args.htsize,
            light=prof.light,
            default_k=args.k or prof.default_k,
            default_gap=getattr(args, "gap", None) or prof.default_gap,
        )
    return prof


def cmd_db_set_targets(args):
    from . import database

    prof = _profile_from_args(args)
    cfg = database.set_targets(args.db, rank=args.rank, profile=prof)
    n = sum(1 for _ in open(cfg.targets))
    print(f"Targets definition written: {cfg.targets} ({n} targets)")
    print(f"Database sub-directory: {cfg.subdb}")
    return 0


def cmd_db_build(args):
    from . import database

    cfg = database.DBConfig.load(args.db)
    prof = _profile_from_args(args, cfg)
    t0 = time.time()
    db = database.build(
        cfg,
        profile=prof,
        k=args.k,
        gap=args.gap,
        min_count_target=args.min_freq_target,
        tsk=args.tsk,
        device=getattr(args, "device", False),
    )
    print(
        f"Database built: {len(db.canonical)} discriminative k-mers "
        f"({db.n_mother} distinct) in {time.time() - t0:.1f}s"
    )
    return 0


_TAXONOMY_FILES = [
    "citations.dmp", "delnodes.dmp", "division.dmp", "gc.prt",
    "gencode.dmp", "images.dmp", "merged.dmp", "names.dmp",
    "nodes.dmp", "nucl_accss",
]


def cmd_db_update_taxonomy(args):
    """scripts/updateTaxonomy.sh equivalent, minus the wget: with --from,
    install taxonomy data from an already-downloaded directory or
    taxdump.tar.gz (extract *.dmp, concatenate nucl_gb + nucl_wgs
    accession2taxid into nucl_accss, touch <db>/.taxondata); without
    --from, print what to fetch and validate what is present.  The fetch
    itself is `clark-tpu db download-taxonomy` where egress exists."""
    from . import download

    tax = os.path.join(args.db, "taxonomy")
    if args.src is not None:
        try:
            download.install_taxonomy(args.src, tax)
        except download.DownloadError as e:
            print(e)
            return 1
    else:
        print(
            "No --from given.  With network egress, run:"
            "\n  clark-tpu db download-taxonomy " + args.db +
            "\nor fetch from ftp://ftp.ncbi.nih.gov/pub/taxonomy/:"
            "\n  taxdump.tar.gz"
            "\n  accession2taxid/nucl_gb.accession2taxid.gz"
            "\n  accession2taxid/nucl_wgs.accession2taxid.gz"
            "\nthen: clark-tpu db update-taxonomy " + args.db
            + " --from <download-dir>"
        )
    missing = [
        f for f in _TAXONOMY_FILES if not os.path.exists(os.path.join(tax, f))
    ]
    if missing:
        print("\nCurrently missing: " + ", ".join(missing))
        return 1
    # the reference marks completion with <db>/.taxondata
    # (updateTaxonomy.sh: `touch ../.taxondata`; checked by kent.cpp:178-265)
    open(os.path.join(args.db, ".taxondata"), "a").close()
    print("\nAll taxonomy files present.")
    return 0


def cmd_db_download_taxonomy(args):
    """scripts/updateTaxonomy.sh + download/download_taxondata.sh: fetch
    the NCBI taxonomy payload into <db>/taxonomy and install it."""
    from . import download

    try:
        download.download_taxonomy(
            os.path.join(args.db, "taxonomy"), base_url=args.base_url
        )
    except download.DownloadError as e:
        print(e)
        return 1
    missing = [
        f for f in _TAXONOMY_FILES
        if not os.path.exists(os.path.join(args.db, "taxonomy", f))
    ]
    if missing:
        print("Missing after download: " + ", ".join(missing))
        return 1
    print("All taxonomy files present.")
    return 0


def cmd_db_download_genomes(args):
    """The reference's three genome-download flows
    (scripts/download/download_data{_newest,_release,}.sh), selected by
    --flow: newest (assembly_summary latest Complete Genome, the default),
    release (dated RefSeq release volumes split per sequence), archive
    (legacy old_refseq tarballs / per-chromosome human)."""
    from . import download

    try:
        if args.flow == "release":
            base = args.base_url or download.NCBI_RELEASE_BASE
            manifest = download.download_genomes_release(
                args.dir, args.group, base_url=base, limit=args.limit
            )
        elif args.flow == "archive":
            base = args.base_url or download.NCBI_GENOMES_BASE
            manifest = download.download_genomes_archive(
                args.dir, args.group, base_url=base
            )
        else:
            base = args.base_url or download.NCBI_REFSEQ_BASE
            manifest = download.download_genomes(
                args.dir, args.group, base_url=base, limit=args.limit
            )
    except download.DownloadError as e:
        print(f"Error: {e}")
        return 1
    n = sum(1 for ln in open(manifest) if not ln.startswith("#"))
    print(f"Manifest: {manifest} ({n} sequences)")
    return 0


def cmd_db_clean(args):
    """Reset DB products: targets.txt, custom_* sub-DBs, metadata dotfiles
    (scripts/clean.sh --reset semantics; Custom/ and taxonomy/ are kept)."""
    import glob
    import shutil

    db = args.db
    if not os.path.isdir(db):
        print(f"database directory not found: {db}", file=sys.stderr)
        return 1
    victims = (
        [os.path.join(db, "targets.txt"), os.path.join(db, "files_excluded.txt"),
         os.path.join(db, "config.json")]
        + glob.glob(os.path.join(db, ".custom*"))
        + glob.glob(os.path.join(db, "custom_*"))
    )
    victims = [v for v in victims if os.path.exists(v)]
    if not victims:
        print("nothing to clean")
        return 0
    if not args.yes:
        print("Will remove:")
        for v in victims:
            print(f"  {v}")
        ans = input("Are you sure you want to reset the database? (yes/no) ")
        if ans.strip().lower() not in ("y", "yes"):
            print("Aborting database reset.")
            return 1
    for v in victims:
        if os.path.isdir(v):
            shutil.rmtree(v)
        else:
            os.remove(v)
    print("Database reset complete.")
    return 0


def _load_classifier(args):
    from . import database
    from .engine import BatchPlan, Classifier

    try:
        cfg = database.DBConfig.load(args.db)
    except FileNotFoundError:
        raise SystemExit(
            f"{args.db}: not a clark-tpu database directory (no config.json"
            " — run `clark-tpu db setup`/`db build` first)"
        )
    prof = _profile_from_args(args, cfg)
    mesh = None
    mesh_mode = "db" if getattr(args, "shard_db", False) else "dp"
    dp = getattr(args, "dp", None)
    if dp and not getattr(args, "shard_db", False):
        raise SystemExit(
            "--dp selects the data-parallel width of a 2-D dp x db mesh and "
            "requires --shard-db (for pure read sharding use -d N)"
        )
    if dp and dp > 1 and getattr(args, "shard_db", False):
        # 2-D composition: reads over 'dp' x table over 'db'
        from .parallel.mesh import make_mesh2d

        import jax

        total = args.devices or len(jax.devices())
        if total % dp:
            raise SystemExit(f"--dp {dp} must divide the device count {total}")
        mesh = make_mesh2d(dp, total // dp)
        mesh_mode = "dp"  # engine dispatches on the mesh's 2 axes
    elif args.devices and args.devices > 1:
        from .parallel.mesh import make_mesh

        mesh = make_mesh(args.devices)
    return Classifier.load(
        cfg.subdb,
        getattr(args, "targets", None) or cfg.targets,
        prof,
        k=args.k if args.k is not None else cfg.k,
        min_count_target=(
            args.min_freq_target
            if args.min_freq_target is not None
            else cfg.min_count_target
        ),
        sampling_factor=args.sampling_factor,
        gap=args.gap if args.gap is not None else cfg.gap,
        mesh=mesh,
        db_cycles=_parse_cycles(getattr(args, "db_cycles", "auto")),
        mesh_mode=mesh_mode,
    )


def _parse_cycles(v) -> int | str:
    if isinstance(v, str) and v != "auto":
        try:
            return int(v)
        except ValueError:
            raise SystemExit(f"--db-cycles must be an integer or 'auto', got {v!r}")
    return v


def _maybe_gunzip(path: str, tmpdir: str) -> str:
    if not path.endswith(".gz"):
        return path
    out = os.path.join(tmpdir, os.path.basename(path)[:-3])
    with gzip.open(path, "rb") as f, open(out, "wb") as g:
        g.write(f.read())
    return out


def cmd_classify(args):
    try:
        return _cmd_classify(args)
    except Exception as e:  # actionable OOM guidance (CUMEMERR parity:
        # the reference prints "increase -b" advice, CuClarkDB.cu:45-73)
        msg = str(e)
        if "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower():
            raise SystemExit(
                "Device out of memory during classification.\n"
                f"  {msg.splitlines()[0][:200]}\n"
                "Try: --db-cycles N (stream the DB in N chunks) or "
                "--shard-db (split the DB index over devices).  "
                "--db-cycles auto (the default) budgets the DB "
                "automatically; if the device limit was misdetected, set "
                "CLARK_TPU_DEVICE_MEM_BYTES."
            ) from e
        raise


def _cmd_classify(args):
    import tempfile

    if getattr(args, "threads", None):
        os.environ["OMP_NUM_THREADS"] = str(args.threads)
    clf = _load_classifier(args)

    objects = args.objects
    results = args.results
    paired = args.paired

    with tempfile.TemporaryDirectory() as td:
        if args.gzipped:
            if objects:
                objects = _maybe_gunzip(objects, td)
            if paired:
                paired = [_maybe_gunzip(p, td) for p in paired]

        # multi-file list mode: objects file whose first line is not a record
        # start is a list of input files, paired with a list of result names
        # (CuCLARK_hh.hh:384-429)
        pairs = []
        if paired:
            with open(paired[0], "rb") as f:
                first = f.read(1)
            if first == b"@":
                pairs.append((paired[0], paired[1], results))
            else:
                # list-of-pairs mode (CuCLARK_hh.hh:483-502): R1 list, R2
                # list, results list, line-aligned
                with open(paired[0]) as f1, open(paired[1]) as f2, open(
                    results
                ) as fr:
                    for l1, l2, lr in zip(f1, f2, fr):
                        l1, l2, lr = l1.strip(), l2.strip(), lr.strip()
                        if l1 and l2 and lr:
                            pairs.append((l1, l2, lr))
        else:
            with open(objects, "rb") as f:
                first = f.read(1)
            if first in (b">", b"@"):
                pairs.append((objects, None, results))
            else:
                with open(objects) as fo, open(results) as fr:
                    for oline, rline in zip(fo, fr):
                        oline, rline = oline.strip(), rline.strip()
                        if oline and rline:
                            pairs.append((oline, None, rline))

        from .utils import profiling

        total_reads = 0
        jobs = getattr(args, "jobs", 1) or 1
        if jobs > 1 and len(pairs) > 1 and not getattr(args, "profile", False):
            # concurrent list mode: small samples are single-batch, so
            # running `jobs` files at once fills each other's device gaps
            with profiling.trace(getattr(args, "trace_dir", None)):
                stats_list = clf.classify_files(
                    [(o, m, r) for o, m, r in pairs],
                    jobs=jobs,
                    extended=args.extended,
                )
            for (obj, _m, _r), stats in zip(pairs, stats_list):
                total_reads += stats["reads"]
                # cycle-outer batches interleave samples inside each table
                # pass: seconds/rate are the whole batch's, flagged as such
                agg = " [whole batch]" if stats.get("aggregate") else ""
                print(
                    f"{obj}: done in {stats['seconds']:.1f}s{agg} "
                    f"({stats['reads_per_min']} reads/min, "
                    f"{stats['reads']} reads) -> {stats['result']}",
                    file=sys.stderr,
                )
            return 0
        with profiling.trace(getattr(args, "trace_dir", None)):
            for obj, mate, res in pairs:
                print(f"Classifying: {obj}", file=sys.stderr)
                if getattr(args, "profile", False):
                    ctx = profiling.collect()
                else:
                    import contextlib

                    ctx = contextlib.nullcontext()
                with ctx as phases:
                    stats = clf.classify_file(
                        obj, res, paired_path=mate, extended=args.extended
                    )
                if args.verbose and stats.get("hit_stats") is not None:
                    # distinct-targets-hit distribution, as the reference
                    # prints after its extended writer
                    # (CuCLARK_hh.hh:2064-2067)
                    print(stats["hit_stats"].report(), file=sys.stderr)
                total_reads += stats["reads"]
                print(
                    f"Done in {stats['seconds']:.1f}s "
                    f"({stats['reads_per_min']} reads/min, {stats['reads']} reads)",
                    file=sys.stderr,
                )
                print(f"Results: {stats['result']}", file=sys.stderr)
                if phases is not None:
                    print(phases.summary(), file=sys.stderr)
    return 0


def cmd_abundance(args):
    from . import abundance

    res = abundance.estimate(
        args.files,
        db_dir=args.db,
        min_confidence=args.min_confidence,
        min_gamma=args.min_gamma,
        min_abundance=args.min_abundance,
        high_confidence=args.highconfidence,
        krona_path="results.krn" if args.krona else None,
        mpa_path="results.mpa" if args.mpa else None,
    )
    out = sys.stdout
    if args.output:
        out = open(args.output, "w")
    out.write(res.text())
    if args.output:
        out.close()
        print(f"Abundance written to {args.output}", file=sys.stderr)
    return 0


def cmd_merge(args):
    from . import abundance

    stats = abundance.merge(args.files, args.output)
    print(
        f"Merged {stats['files']} abundance files ({stats['total']} total "
        f"reads) -> {stats['output']}"
    )
    return 0


def cmd_report(args):
    from . import abundance

    stats = abundance.report(args.file, args.output)
    print(f"Report written to {stats['output']}")
    return 0


def cmd_verify(args):
    """Installation + database health check (kent --verify)."""
    ok = True

    def check(name, fn):
        nonlocal ok
        try:
            detail = fn()
            print(f"  [OK]   {name}" + (f" ({detail})" if detail else ""))
        except Exception as e:  # noqa: BLE001
            print(f"  [FAIL] {name}: {e}")
            ok = False

    print("clark-tpu installation check:")
    check("python package", lambda: __import__("jn_cuclark_tpu").__version__)
    check("jax devices", _describe_devices)
    # the native runtime is OPTIONAL (numpy fallbacks exist) — warn, not fail
    from .utils import native as _nat

    if _nat.available():
        print(f"  [OK]   native runtime ({os.path.basename(_nat.build())})")
    else:
        print(
            "  [WARN] native runtime: no C++ compiler to build "
            "native/clark_native.cpp; using the slower numpy fallback"
        )
    check("device pipeline", _check_pipeline)
    if args.db:
        from . import database

        problems = database.check_layout(args.db)
        for p in problems:
            print(f"  [FAIL] db layout: {p}")
        ok = ok and not problems
        if not problems:
            print(f"  [OK]   db layout: {args.db}")
        try:
            cfg = database.DBConfig.load(args.db)
            stem = os.path.join(
                cfg.subdb,
                cfg.profile.db_stem(cfg.k, _count_targets(cfg), cfg.min_count_target, cfg.gap),
            )
            from .io import dbformat

            if dbformat.db_exists(stem):
                print(f"  [OK]   database files: {stem}.(sz|ky|lb)")
            else:
                print(f"  [WARN] database not built yet (expected {stem}.*)")
        except FileNotFoundError:
            print(f"  [WARN] no config.json in {args.db} (run db set-targets)")
    print("STATUS: " + ("READY" if ok else "INCOMPLETE"))
    return 0 if ok else 1


def _describe_devices():
    import jax

    devs = jax.devices()
    return (f"platform {devs[0].platform}, {devs[0].device_kind} "
            f"x {len(devs)}")


def _check_pipeline():
    import numpy as np

    from __graft_entry__ import entry  # noqa: PLC0415

    import jax

    fn, fargs = entry()
    out = jax.jit(fn)(*fargs)
    np.asarray(out[0])
    return "jit ok"


def _count_targets(cfg):
    from .io.targets import parse_targets

    return parse_targets(cfg.targets).n_targets


def cmd_cluster(args):
    from . import cluster

    return cluster.main(args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="clark-tpu",
        description="GPU-accelerated CLARK metagenomic classifier",
    )
    from . import __version__

    p.add_argument("--version", action="version", version=f"clark-tpu {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_profile_flags(sp, build=False):
        sp.add_argument("-k", type=int, default=None, help="k-mer length")
        sp.add_argument("--light", action="store_true", help="light profile (cuCLARK-l)")
        sp.add_argument("--full", action="store_true", help="full profile (cuCLARK)")
        sp.add_argument("--htsize", type=int, default=None, help="custom hash-table size")
        sp.add_argument("-g", "--gap", type=int, default=None, help="light-mode k-mer gap")
        sp.add_argument(
            "-t", "--min-freq-target", type=int, default=None,
            help="minimum k-mer frequency in targets",
        )

    pd = sub.add_parser("db", help="database workflows")
    dsub = pd.add_subparsers(dest="dbcmd", required=True)
    pst = dsub.add_parser("set-targets", help="build targets.txt from Custom/ + taxonomy/")
    pst.add_argument("db", help="database directory")
    pst.add_argument(
        "--rank", default="species",
        choices=list(__import__("jn_cuclark_tpu.database", fromlist=["RANK_NAMES"]).RANK_NAMES),
        help="taxonomy rank for target labels",
    )
    add_profile_flags(pst)
    pst.set_defaults(fn=cmd_db_set_targets)

    pb = dsub.add_parser("build", help="build the discriminative k-mer database")
    pb.add_argument("db", help="database directory")
    add_profile_flags(pb, build=True)
    pb.add_argument("--tsk", action="store_true", help="write per-target .ht files")
    pb.add_argument("--device", action="store_true",
                    help="aggregate k-mers on the accelerator (sort + segment "
                    "reductions)")
    pb.set_defaults(fn=cmd_db_build)

    put = dsub.add_parser(
        "update-taxonomy",
        help="install/validate NCBI taxonomy data from a local download "
        "(scripts/updateTaxonomy.sh equivalent; the fetch itself is manual "
        "in this zero-egress environment)",
    )
    put.add_argument("db", help="database directory")
    put.add_argument(
        "--from", dest="src", default=None, metavar="DIR_OR_TGZ",
        help="directory (or taxdump.tar.gz) holding the downloaded "
        "taxdump + nucl_*.accession2taxid[.gz] files",
    )
    put.set_defaults(fn=cmd_db_update_taxonomy)

    from .download import NCBI_TAXONOMY_BASE

    pdt = dsub.add_parser(
        "download-taxonomy",
        help="fetch + install NCBI taxonomy data into <db>/taxonomy "
        "(scripts/updateTaxonomy.sh; needs network egress)",
    )
    pdt.add_argument("db", help="database directory")
    pdt.add_argument(
        "--base-url", default=NCBI_TAXONOMY_BASE,
        help="taxonomy mirror root (default: NCBI)",
    )
    pdt.set_defaults(fn=cmd_db_download_taxonomy)

    pdg = dsub.add_parser(
        "download-genomes",
        help="fetch latest RefSeq Complete Genome assemblies for a group "
        "(scripts/download/download_data_newest.sh; needs network egress)",
    )
    pdg.add_argument("dir", help="destination directory for the sequences")
    pdg.add_argument("group", help="RefSeq group: bacteria, viruses, archaea, fungi, ...")
    pdg.add_argument(
        "--flow", choices=("newest", "release", "archive"), default="newest",
        help="newest = latest assemblies (download_data_newest.sh); "
        "release = dated RefSeq release volumes (download_data_release.sh); "
        "archive = legacy old_refseq tarballs (download_data.sh)",
    )
    pdg.add_argument(
        "--base-url", default=None,
        help="mirror root (default: the NCBI root for the chosen flow)",
    )
    pdg.add_argument("--limit", type=int, default=None,
                     help="cap the number of assemblies/volumes (smoke tests)")
    pdg.set_defaults(fn=cmd_db_download_genomes)

    pcln = dsub.add_parser("clean", help="remove built DB artifacts (scripts/clean.sh --reset)")
    pcln.add_argument("db", help="database directory")
    pcln.add_argument("--yes", action="store_true", help="skip confirmation")
    pcln.set_defaults(fn=cmd_db_clean)

    pc = sub.add_parser("classify", help="classify reads against a database")
    pc.add_argument("-D", "--db", required=True, help="database directory")
    pc.add_argument("-O", "--objects", help="reads file (or list of files)")
    pc.add_argument("-T", "--targets", default=None,
                    help="targets definition file (default: the one recorded "
                    "by db set-targets in config.json)")
    pc.add_argument(
        "-P", "--paired", nargs=2, metavar=("R1", "R2"), help="paired-end FASTQ files"
    )
    pc.add_argument("-R", "--results", required=True, help="results path (.csv appended)")
    add_profile_flags(pc)
    pc.add_argument("-s", "--sampling-factor", type=int, default=1)
    pc.add_argument("-n", "--threads", type=int, default=None,
                    help="host threads for the native packer (default: all)")
    pc.add_argument("--jobs", type=int, default=1,
                    help="list mode: classify this many input files "
                    "concurrently through the shared device pipeline "
                    "(small samples overlap each other's host/device gaps)")
    pc.add_argument("-b", "--batches", type=int, default=None,
                    help="accepted for cuCLARK compatibility; batching is automatic")
    pc.add_argument("--extended", action="store_true", help="per-target score columns")
    pc.add_argument("--verbose", action="store_true",
                    help="accepted for cuCLARK command-line compatibility "
                    "(main.cc --verbose); per-file speed stats are always "
                    "printed")
    pc.add_argument("--gzipped", action="store_true", help="inputs are gzipped")
    pc.add_argument("-d", "--devices", type=int, default=None, help="devices to shard the DB over")
    pc.add_argument("--dp", type=int, default=None,
                    help="with --shard-db: data-parallel width of a 2-D "
                    "dp x db mesh (reads sharded over dp, table rows over "
                    "db = devices/dp)")
    pc.add_argument("--shard-db", action="store_true",
                    help="shard the DB index over devices (for DBs larger "
                         "than one device's memory) instead of sharding reads")
    pc.add_argument("--db-cycles", default="auto",
                    help="stream the DB index in N chunks (out-of-core); "
                         "default 'auto' derives N from free device memory "
                         "(CuClarkDB.cu:526-565 behavior)")
    pc.add_argument("--profile", action="store_true", help="print phase timing summary")
    pc.add_argument("--trace-dir", default=None, help="capture a jax.profiler trace")
    pc.set_defaults(fn=cmd_classify)

    pa = sub.add_parser("abundance", help="abundance estimation from result CSVs")
    pa.add_argument("-D", "--db", default=None, help="database directory (for taxonomy)")
    pa.add_argument("-F", "--files", nargs="+", required=True, help="classification CSVs")
    pa.add_argument("-c", "--min-confidence", type=float, default=0.5)
    pa.add_argument("-g", "--min-gamma", type=float, default=0.0)
    pa.add_argument("-a", "--min-abundance", type=float, default=0.0)
    pa.add_argument("--highconfidence", "--hc", action="store_true")
    pa.add_argument("--krona", action="store_true", help="write results.krn")
    pa.add_argument("--mpa", action="store_true", help="write results.mpa")
    pa.add_argument("-o", "--output", default=None)
    pa.set_defaults(fn=cmd_abundance)

    pm = sub.add_parser("merge", help="merge abundance CSVs by taxid")
    pm.add_argument("files", nargs="+")
    pm.add_argument("-o", "--output", required=True)
    pm.set_defaults(fn=cmd_merge)

    pr = sub.add_parser("report", help="human-readable pathogen report")
    pr.add_argument("file", help="abundance CSV")
    pr.add_argument("-o", "--output", default="results/report.txt")
    pr.set_defaults(fn=cmd_report)

    pv = sub.add_parser("verify", help="installation / database health check")
    pv.add_argument("--db", default=None, help="database directory to check")
    pv.set_defaults(fn=cmd_verify)

    pcl = sub.add_parser("cluster", help="multi-host / multi-sample coordinator")
    pcl.add_argument("-c", "--config", required=True, help="cluster config (INI)")
    pcl.add_argument("-p", "--preflight", action="store_true", help="check config and hosts only")
    pcl.add_argument("--launch", action="store_true",
                     help="self-launch the whole cluster: SSH-spawn one "
                          "worker per host with process ids preset "
                          "(kent-mpi launcher mode)")
    pcl.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    pcl.set_defaults(fn=cmd_cluster)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "classify" and not args.objects and not args.paired:
        print("classify: provide -O <reads> or -P <r1> <r2>", file=sys.stderr)
        return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
