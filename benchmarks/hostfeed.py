"""Host-feed ceiling measurement: how fast can ONE
host scan + pack reads, versus one chip's demand at the recorded headline?

The dp-scaling claim ("~linear, host-feed-bound") needs a number for where
the host feed saturates.  This measures the native scan (record
boundaries) and pack (2-bit + validity rows) stages in isolation on this
host's cores, then derives reads/s of host feed and the chip count at
which one host's feed saturates, given a per-chip device rate.

Run:  PYTHONPATH=. python benchmarks/hostfeed.py
Env:  HF_READS (2000000), HF_LEN (150), HF_THREADS (default: 1 and all)
Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_fasta(n_reads: int, ln: int) -> bytes:
    rng = np.random.default_rng(0)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    rows = []
    seq = ACGT[rng.integers(0, 4, size=(n_reads, ln), dtype=np.uint8)]
    for i in range(n_reads):
        rows.append(b">r%d\n%s\n" % (i, seq[i].tobytes()))
    return b"".join(rows)


def bench_stage(fn, reps=3):
    best = 1e30
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    from jn_cuclark_tpu.utils import native

    n_reads = int(os.environ.get("HF_READS", "2000000"))
    ln = int(os.environ.get("HF_LEN", "150"))
    data = make_fasta(n_reads, ln)
    nbytes = len(data)
    out = {"reads": n_reads, "read_len": ln, "input_mb": nbytes >> 20,
           "cores": os.cpu_count()}

    threads_list = os.environ.get("HF_THREADS")
    if threads_list:
        threads_list = [int(t) for t in threads_list.split(",")]
    else:
        threads_list = sorted({1, os.cpu_count() or 1})

    import ctypes

    try:  # env vars are read once at OpenMP init; set live instead
        gomp = ctypes.CDLL("libgomp.so.1")
    except OSError:
        gomp = None

    for nt in threads_list:
        if gomp is not None:
            gomp.omp_set_num_threads(nt)
        # scan: record boundaries + per-read arrays
        t_scan = bench_stage(lambda: native.scan_reads(data))
        is_fa, ns, ne, ss, se, lnarr = native.scan_reads(data)
        # pack: 2-bit + validity rows at the quantized stride, in engine-
        # sized batches (max_reads 65536 default)
        from jn_cuclark_tpu.ops.pack import quantized_stride

        stride = quantized_stride(ln)
        bs = 1 << 16

        def pack_all():
            for r0 in range(0, n_reads, bs):
                r1 = min(r0 + bs, n_reads)
                native.pack_batch(data, ss[r0:r1], se[r0:r1], stride)

        t_pack = bench_stage(pack_all)
        feed_rps = n_reads / (t_scan + t_pack)
        out[f"t{nt}"] = {
            "scan_mb_s": round(nbytes / t_scan / 2**20, 1),
            "pack_mb_s": round(nbytes / t_pack / 2**20, 1),
            "scan_reads_s": round(n_reads / t_scan, 0),
            "pack_reads_s": round(n_reads / t_pack, 0),
            "feed_reads_s": round(feed_rps, 0),
        }

    # saturation math against a per-card device rate, when one is given
    # (HF_CHIP_READS_S; no H100 rate is measured yet)
    if os.environ.get("HF_CHIP_READS_S"):
        chip_rps = float(os.environ["HF_CHIP_READS_S"])
        full = out[f"t{threads_list[-1]}"]["feed_reads_s"]
        out["chip_reads_s_assumed"] = chip_rps
        out["chips_per_host_at_saturation"] = round(full / chip_rps, 2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
