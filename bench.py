"""Benchmark suite over the BASELINE.md configurations.

Prints ONE json line:
  {"metric", "value", "unit", "extra": {...}}

Headline metric (value) = config-1-scaled end-to-end classification
throughput: toy bacterial DB (3 synthetic 2 Mbp genomes), full profile,
simulated 150 bp reads drawn from the DB genomes (every window hits — the
slowest counting path), steady-state best-of-3 after a warmup/compile
pass.  The reference publishes no numbers (BASELINE.md).  `extra.device`
names the platform, device kind and count, and the card's name and power
limit.

`extra` carries the other BASELINE.md metrics and configs:
  kmer_lookups_per_sec — valid k-mer windows probed per second during the
                         headline run (sum of len-k+1 over reads / wall)
  db_build_seconds     — measured wall of the headline DB build (persisted in
                         the workload cache at first build)
  config2 — full-profile realism: 16 synthetic genomes x 3 Mbp, k=31 (u32
            keys, ~46M distinct k-mers, ~1.9 GB on disk), 60k reads of mixed
            100-250 bp, HALF drawn from the genomes and HALF random junk
            (~50% read-level miss rate), plus a paired-end subset
  config3 — end-to-end classify -> abundance pipeline (estimate_abundance
            with an NCBI-format toy taxonomy, Krona + mpa exports) on the
            config-2 DB
  config4 — 8-sample batch: classify + per-sample abundance + kent -m merge

Config 5 (opt-in, BENCH_CONFIGS=...,5) is the RefSeq-shape scale run of
benchmarks/refseq_scale.py, run in this process (one JAX process per card).

Env knobs: BENCH_CONFIGS="1,2,3,4" (default; "1" = headline only),
BENCH_READS, BENCH_GENOME_LEN, BENCH_PROFILE, BENCH_CACHE_DIR.
Workloads/DBs are cached under bench_cache/ in the checkout (gitignored);
the first run builds them, later runs are warm.
"""

import json
import os
import time

import numpy as np

CACHE_ROOT = os.environ.get(
    "BENCH_CACHE_ROOT",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_cache"),
)


def _rand_genome(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def _write_genomes(tmpdir, rng, n_genomes, genome_len):
    genomes = []
    with open(os.path.join(tmpdir, "targets.txt"), "w") as tf:
        for i in range(n_genomes):
            p = os.path.join(tmpdir, f"g{i}.fa")
            if os.path.exists(p):
                with open(p) as f:
                    seq = "".join(
                        ln.strip() for ln in f if not ln.startswith(">")
                    )
            else:
                seq = _rand_genome(rng, genome_len)
                with open(p, "w") as f:
                    f.write(f">g{i}\n")
                    for j in range(0, len(seq), 70):
                        f.write(seq[j : j + 70] + "\n")
            genomes.append(seq)
            tf.write(f"{p} {1000 + i}\n")
    return genomes


def _timed_build(tmpdir, targets, prof, k):
    """Build the DB if missing; persist + return the measured build wall."""
    from jn_cuclark_tpu.db import builder
    from jn_cuclark_tpu.io import dbformat

    stem = os.path.join(
        tmpdir, prof.db_stem(k, targets.n_targets, 0, prof.default_gap)
    )
    meta = os.path.join(tmpdir, "build_meta.json")
    if not dbformat.db_exists(stem):
        t0 = time.time()
        builder.build_database(targets, tmpdir, prof, k)
        dt = time.time() - t0
        with open(meta, "w") as f:
            json.dump({"db_build_seconds": round(dt, 2)}, f)
    try:
        return json.load(open(meta))["db_build_seconds"]
    except (OSError, KeyError, ValueError):
        return None


def _sim_reads(rng, genomes, n_reads, lens, junk_frac=0.0, prefix="r"):
    """FASTA of n_reads; a junk_frac fraction are random (miss) reads.

    Callers pass a DEDICATED rng (not the genome-writing one): genome draws
    are skipped on warm cache hits, so sharing one stream would make the
    benchmarked read set differ between cold and warm runs."""
    out = []
    for i in range(n_reads):
        ln = int(lens[i]) if np.ndim(lens) else int(lens)
        if junk_frac and rng.random() < junk_frac:
            seq, tag = _rand_genome(rng, ln), "junk"
        else:
            g = genomes[i % len(genomes)]
            pos = int(rng.integers(0, len(g) - ln))
            seq, tag = g[pos : pos + ln], f"g{i % len(genomes)}"
        out.append(f">{prefix}{i}_{tag}\n{seq}\n")
    return "".join(out).encode()


def _rate(clf, fa, k, reps=3, paired=False):
    """Best-of-reps steady-state (reads/s, valid_windows/s, diagnostics).

    Diagnostics carry every rep's rate (the cross-rep spread) and the best
    rep's per-phase host/device breakdown from
    utils/profiling, so a regressed recorded number shows WHERE the time
    went (scan/pack/dispatch/device_wait/format)."""
    from jn_cuclark_tpu.utils import profiling

    # warmup/compile on a quarter
    for _ in clf.classify_bytes(fa[: max(len(fa) // 4, 1)], paired=paired)[0]:
        pass
    best = 0.0
    n = 0
    rep_rates = []
    best_phases = {}
    for _ in range(reps):
        with profiling.collect() as ph:
            t0 = time.time()
            n = 0
            gen, n_reads = clf.classify_bytes(fa, paired=paired)
            for chunk in gen:
                n += chunk.count(b"\n")
            dt = time.time() - t0
        rate = n / dt
        rep_rates.append(round(rate, 1))
        if rate > best:
            best = rate
            best_phases = {
                name: round(tot, 3) for name, tot in ph.totals.items()
            }
            best_phases["wall"] = round(dt, 3)
    from jn_cuclark_tpu.io.fasta import parse_reads

    lens = parse_reads(fa).read_lengths
    windows = int(np.maximum(lens - k + 1, 0).sum())
    diag = {"rep_reads_per_sec": rep_rates, "best_rep_phases": best_phases}
    return best, best * windows / max(n, 1), diag


# ----------------------------------------------------------------- config 1
def _c1_load():
    from jn_cuclark_tpu import params
    from jn_cuclark_tpu.engine import BatchPlan, Classifier
    from jn_cuclark_tpu.io.targets import parse_targets

    # 1M reads: pipeline fill/drain and the serial prologue amortize
    n_reads = int(os.environ.get("BENCH_READS", "1000000"))
    genome_len = int(os.environ.get("BENCH_GENOME_LEN", "2000000"))
    profname = os.environ.get("BENCH_PROFILE", "full")
    prof = params.LIGHT if profname == "light" else params.FULL
    k = prof.default_k
    td = os.environ.get(
        "BENCH_CACHE_DIR",
        os.path.join(CACHE_ROOT, f"bench_{profname}_{genome_len}_{n_reads}"),
    )
    os.makedirs(td, exist_ok=True)
    rng = np.random.default_rng(0)
    genomes = _write_genomes(td, rng, 3, genome_len)
    targets = parse_targets(os.path.join(td, "targets.txt"))
    build_s = _timed_build(td, targets, prof, k)
    fa = _sim_reads(np.random.default_rng(100), genomes, n_reads, 150)
    clf = Classifier.load(
        td, targets, prof, k,
        plan=BatchPlan(max_reads=1 << 16, window_budget=1 << 23,
                       pipeline_depth=6),
    )
    workload = (
        f"3x{genome_len}bp genomes, {n_reads} x 150bp reads, "
        f"0% junk (all windows hit), k={k}"
    )
    return clf, fa, k, build_s, workload


def config1(state):
    clf, fa, k, build_s, workload = state
    rps, lps, diag = _rate(clf, fa, k)
    return dict(
        reads_per_sec=round(rps, 2),
        kmer_lookups_per_sec=round(lps, 2),
        db_build_seconds=build_s,
        workload=workload,
        **diag,
    )


# ----------------------------------------------------------------- config 2
def _c2_load():
    from jn_cuclark_tpu import params
    from jn_cuclark_tpu.engine import BatchPlan, Classifier
    from jn_cuclark_tpu.io.targets import parse_targets

    n_genomes = int(os.environ.get("BENCH_C2_GENOMES", "16"))
    glen = int(os.environ.get("BENCH_C2_GLEN", "3000000"))
    td = os.path.join(CACHE_ROOT, f"bench_c2_{n_genomes}x{glen}")
    os.makedirs(td, exist_ok=True)
    genomes = _write_genomes(td, np.random.default_rng(2), n_genomes, glen)
    rng = np.random.default_rng(200)  # reads rng, independent of genome caching
    targets = parse_targets(os.path.join(td, "targets.txt"))
    prof = params.FULL
    k = prof.default_k  # 31: u32 on-disk keys, the real full-profile width
    build_s = _timed_build(td, targets, prof, k)
    clf = Classifier.load(
        td, targets, prof, k,
        plan=BatchPlan(max_reads=1 << 16, window_budget=1 << 23,
                       pipeline_depth=6),
    )
    return td, rng, genomes, targets, prof, k, build_s, clf


def config2(state):
    td, rng, genomes, targets, prof, k, build_s, clf = state
    # 400k reads: ~12 batches per rep so pipeline fill/drain amortizes
    n_reads = int(os.environ.get("BENCH_C2_READS", "400000"))
    lens = rng.integers(100, 251, size=n_reads)
    fa = _sim_reads(rng, genomes, n_reads, lens, junk_frac=0.5)
    rps, lps, diag = _rate(clf, fa, k)

    # paired subset: mates drawn 200bp apart, merged with the native merger
    n_pairs = int(os.environ.get("BENCH_C2_PAIRS", "100000"))
    g = genomes[0]
    fq1, fq2 = [], []
    for i in range(n_pairs):
        pos = int(rng.integers(0, len(g) - 500))
        fq1.append(f"@p{i}/1\n{g[pos:pos+125]}\n+\n{'I'*125}\n")
        fq2.append(f"@p{i}/2\n{g[pos+200:pos+325]}\n+\n{'I'*125}\n")
    from jn_cuclark_tpu.io.fasta import merge_paired

    b1, b2 = "".join(fq1).encode(), "".join(fq2).encode()
    # warm the merged-stride jit tier so the rate is merge+classify steady state
    nw = max(n_pairs // 4, 1)
    for _ in clf.classify_bytes(
        merge_paired("".join(fq1[:nw]).encode(), "".join(fq2[:nw]).encode()),
        paired=True,
    )[0]:
        pass
    # best-of-2 including the merge
    paired_rps = 0.0
    for _ in range(2):
        t0 = time.time()
        merged = merge_paired(b1, b2)
        n_out = 0
        for chunk in clf.classify_bytes(merged, paired=True)[0]:
            n_out += chunk.count(b"\n")
        paired_rps = max(paired_rps, n_out / (time.time() - t0))

    return dict(
        reads_per_sec=round(rps, 2),
        kmer_lookups_per_sec=round(lps, 2),
        paired_reads_per_sec=round(paired_rps, 2),
        db_build_seconds=build_s,
        workload=f"{len(genomes)}x{len(genomes[0])}bp genomes k={k}, "
                 f"{n_reads} reads of 100-250bp, 50% random junk "
                 f"(~50% read-level miss rate), + {n_pairs} merged pairs",
        **diag,
    )


# ----------------------------------------------------------------- config 3
def _write_toy_taxonomy(td, n_species):
    """NCBI-format nodes.dmp/names.dmp covering taxids 1000..1000+n-1."""
    tax = os.path.join(td, "taxonomy")
    os.makedirs(tax, exist_ok=True)
    nodes = [
        (1, 1, "no rank"), (2, 1, "superkingdom"), (100, 2, "phylum"),
        (110, 100, "class"), (120, 110, "order"), (130, 120, "family"),
    ]
    names = [
        (1, "root"), (2, "Bacteria"), (100, "Synthphyla"),
        (110, "Synthclassia"), (120, "Synthorder"), (130, "Synthaceae"),
    ]
    for i in range(n_species):
        genus = 200 + i // 4
        nodes.append((genus, 130, "genus"))
        names.append((genus, f"Synthgenus{i // 4}"))
    for i in range(n_species):
        nodes.append((1000 + i, 200 + i // 4, "species"))
        names.append((1000 + i, f"Synthspecies {i}"))
    with open(os.path.join(tax, "nodes.dmp"), "w") as f:
        for tid, parent, rank in dict.fromkeys(nodes):
            f.write(f"{tid}\t|\t{parent}\t|\t{rank}\t|\tXX\t|\n")
    with open(os.path.join(tax, "names.dmp"), "w") as f:
        for tid, nm in dict.fromkeys(names):
            f.write(f"{tid}\t|\t{nm}\t|\t\t|\tscientific name\t|\n")


def config3(state):
    from jn_cuclark_tpu import abundance

    td, rng, genomes, targets, prof, k, build_s, clf = state
    _write_toy_taxonomy(td, len(genomes))
    n_reads = int(os.environ.get("BENCH_C3_READS", "20000"))
    fa = _sim_reads(rng, genomes, n_reads, 150, junk_frac=0.3, prefix="a")
    obj = os.path.join(td, "c3_reads.fa")
    with open(obj, "wb") as f:
        f.write(fa)
    # warm the jit tiers so the pipeline time reflects steady state
    for _ in clf.classify_bytes(fa[: len(fa) // 4])[0]:
        pass
    t0 = time.time()
    clf.classify_file(obj, os.path.join(td, "c3_res"))
    res = abundance.estimate(
        [os.path.join(td, "c3_res.csv")],
        db_dir=td,
        krona_path=os.path.join(td, "c3.krn"),
        mpa_path=os.path.join(td, "c3.mpa"),
    )
    dt = time.time() - t0
    return dict(
        pipeline_seconds=round(dt, 2),
        reads=n_reads,
        abundance_rows=len(res.rows),
        workload=f"classify {n_reads} reads (30% junk) -> abundance "
                 "estimate (8-rank lineages, Krona + mpa exports)",
    )


# ----------------------------------------------------------------- config 4
def config4(state):
    from jn_cuclark_tpu import abundance

    td, rng, genomes, targets, prof, k, build_s, clf = state
    n_samples = 8
    n_reads = int(os.environ.get("BENCH_C4_READS", "8000"))
    samples = []
    for s in range(n_samples):
        fa = _sim_reads(rng, genomes, n_reads, 150, junk_frac=0.2,
                        prefix=f"s{s}_")
        p = os.path.join(td, f"c4_s{s}.fa")
        with open(p, "wb") as f:
            f.write(fa)
        samples.append(p)
    for _ in clf.classify_bytes(open(samples[0], "rb").read())[0]:
        pass  # warm
    t0 = time.time()
    items = [
        (p, None, os.path.join(td, f"c4_res{s}"))
        for s, p in enumerate(samples)
    ]
    clf.classify_files(items, jobs=4)  # small samples overlap device gaps
    ab_files = []
    for s in range(n_samples):
        ab = abundance.estimate([os.path.join(td, f"c4_res{s}.csv")])
        abf = os.path.join(td, f"c4_ab{s}.csv")
        with open(abf, "w") as f:
            f.write(ab.text())
        ab_files.append(abf)
    abundance.merge(ab_files, os.path.join(td, "c4_merged.csv"))
    dt = time.time() - t0
    return dict(
        batch_seconds=round(dt, 2),
        samples=n_samples,
        reads_per_sec_aggregate=round(n_samples * n_reads / dt, 2),
        workload=f"{n_samples} samples x {n_reads} reads: classify "
                 "(4 concurrent) + abundance each + kent -m merge",
    )


def device_info() -> dict:
    """Platform, device kind and count as JAX reports them, plus the card's
    name and power limit from nvidia-smi (a card below its maximum power
    runs slower under load)."""
    import subprocess

    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if devs[0].platform == "gpu":
        info["cards"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    return info


def main():
    import jn_cuclark_tpu  # noqa: F401

    configs = os.environ.get("BENCH_CONFIGS", "1,2,3,4").split(",")
    extra = {"device": device_info()}

    c1 = config1(_c1_load())
    extra["config1"] = c1
    extra["kmer_lookups_per_sec"] = c1["kmer_lookups_per_sec"]
    extra["db_build_seconds"] = c1["db_build_seconds"]

    state = None
    if {"2", "3", "4"} & set(configs):
        state = _c2_load()
    if "2" in configs:
        extra["config2"] = config2(state)
    if "3" in configs:
        extra["config3"] = config3(state)
    if "4" in configs:
        extra["config4"] = config4(state)
    if "5" in configs:
        # RefSeq-shape scale run: 5000 targets x 50 kbp, ~246M
        # discriminative 31-mers; in this process, as a second JAX process
        # could not get the card's memory
        import sys

        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "benchmarks"))
        import refseq_scale

        extra["config5"] = refseq_scale.run()

    print(
        json.dumps(
            {
                "metric": "classification_reads_per_sec_per_chip",
                "value": c1["reads_per_sec"],
                "unit": "reads/s",
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
