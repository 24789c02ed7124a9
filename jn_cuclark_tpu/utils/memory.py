"""Automatic device-memory budgeting for DB residency.

The reference sizes DB parts x cycles from measured free device memory
minus a RESERVED headroom, and refuses to run below a 200 MB floor
(/root/reference/src/CuClarkDB.cu:526-565, 178-181;
 parameters.hh:45 RESERVED).  Here the batch step's transient device need
is computed from the batch plan, subtracted together with a RESERVED
headroom from the device's memory limit, and the table's cycle count is
derived so each resident chunk fits.  An oversized DB then auto-cycles
instead of dying with a raw XLA OOM.
"""

from __future__ import annotations

import os

RESERVED = 768 << 20  # headroom: extended-mode count matrices, scoring
# temporaries, runtime overhead (reference: 200 MB on Jetson-class devices)
HARD_FLOOR = 200 << 20  # reference parity: refuse to run below this


def device_memory_limit(device=None) -> int | None:
    """Per-device accelerator memory in bytes, or None on the CPU platform
    (host RAM is the OS's business: no auto-cycling).

    CLARK_TPU_DEVICE_MEM_BYTES overrides (also the test hook); otherwise
    the device's own memory_stats()["bytes_limit"].  An accelerator that
    reports no limit is an error, not a guess."""
    env = os.environ.get("CLARK_TPU_DEVICE_MEM_BYTES")
    if env:
        return int(env)
    import jax

    dev = device if device is not None else jax.local_devices()[0]
    if dev.platform == "cpu":
        return None
    stats = dev.memory_stats() or {}
    if not stats.get("bytes_limit"):
        raise RuntimeError(
            f"device {dev.device_kind!r} ({dev.platform}) reports no memory "
            "limit; set CLARK_TPU_DEVICE_MEM_BYTES to its usable bytes"
        )
    return int(stats["bytes_limit"])


#: device bytes beside the table per window slot of the batch plan.
#: Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phases 3
#: and 5): a resident classify of 1M 150 bp reads at the default plan
#: (window_budget 2^23, batches in flight included) peaked 141,917,952 B
#: above its 4,294,967,296 B table, 16.9 B per slot; the compiled step's
#: own temporaries are 117,440,040 B.  XLA fuses the probe's row gather
#: into the compare/max, so the [Q, 2C] gathered block never exists.
TRANSIENT_BYTES_PER_WINDOW = 17


def probe_transient_bytes(window_budget: int) -> int:
    """Peak transient device memory of one batch step (window grids, probe
    and scoring temporaries), independent of the table's row width."""
    return window_budget * TRANSIENT_BYTES_PER_WINDOW


def auto_db_cycles(
    table_bytes: int,
    window_budget: int,
    *,
    n_shards: int = 1,
    device=None,
) -> tuple[int, int | None]:
    """(db_cycles, per_device_budget_bytes) so each resident table chunk
    fits the device: cycles = ceil(per-shard table bytes / budget).

    Returns (1, None) when the device memory is unknowable (CPU).  Raises
    with actionable guidance when even maximal cycling cannot fit (budget
    below the reference's 200 MB floor)."""
    limit = device_memory_limit(device)
    if limit is None:
        return 1, None
    budget = limit - RESERVED - probe_transient_bytes(window_budget)
    if budget < HARD_FLOOR:
        raise RuntimeError(
            f"device memory budget for the database is "
            f"{max(budget, 0) >> 20} MB (< {HARD_FLOOR >> 20} MB floor): "
            f"device limit {limit >> 20} MB minus reserved "
            f"{RESERVED >> 20} MB minus batch transients "
            f"{probe_transient_bytes(window_budget) >> 20} MB. "
            "Shard the DB over more devices (--shard-db / -d), lower "
            "BatchPlan.window_budget (config.json: plan.window_budget), "
            "or set CLARK_TPU_DEVICE_MEM_BYTES if the device limit was "
            "misdetected."
        )
    per_shard = -(-table_bytes // max(n_shards, 1))
    cycles = max(-(-per_shard // budget), 1)
    if cycles > 1 and os.environ.get("CLARK_TPU_PREFETCH_CHUNKS", "1") != "0":
        # double-buffered chunk uploads (engine._cycle_passes /
        # ShardedRadixTable.begin_cycle) keep TWO chunks resident at the
        # overlap peak, so each chunk must fit half the budget
        cycles = max(-(-per_shard // (budget // 2)), 2)
    return cycles, budget
