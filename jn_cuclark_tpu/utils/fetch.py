"""Hedged device->host result fetches.

This was written for the earlier remote setup, where a `jax.device_get`
was a network round trip that could stall for minutes while the device
arrays stayed alive; a SECOND `device_get` of the same arrays then
succeeded at once.  These helpers issue that hedge.  On a directly
attached GPU a fetch is a local copy; ROADMAP D1 measures whether the
hedge still does anything and deletes it if not.

`hedged_device_get(tree)` blocks like `jax.device_get`, but if no result
arrives within an adaptive timeout it re-issues the fetch in a fresh
daemon thread (bounded number of hedges, doubling wait each round) and
returns whichever attempt completes first.  Abandoned attempts park on
daemon threads; their results are discarded.

The timeout adapts to the observed fetch regime: an EWMA of successful
fetch walls sets the hedge trigger at ``HEDGE_FACTOR x ewma`` clamped to
[HEDGE_MIN_S, HEDGE_MAX_S], so fast fetches hedge after ~10 s while
slow-but-working ones are not spammed with duplicate fetches.

Env knobs:
  CLARK_TPU_FETCH_HEDGE_S    base/min hedge timeout seconds (default 10;
                             0 disables hedging entirely)
  CLARK_TPU_FETCH_HEDGE_MAX  max extra attempts per fetch (default 3)

The reference has no equivalent (single-process CUDA).
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time

HEDGE_FACTOR = 8.0
HEDGE_MIN_S = float(os.environ.get("CLARK_TPU_FETCH_HEDGE_S", "10"))
HEDGE_MAX_S = 120.0
MAX_HEDGES = int(os.environ.get("CLARK_TPU_FETCH_HEDGE_MAX", "3"))

# injectable for tests (stall injection) and to avoid importing jax at
# module import time
def _default_get(tree):
    import jax

    return jax.device_get(tree)


_get_fn = _default_get

# observed-successful-fetch EWMA (seconds) + counters, read by benchmark
# diagnostics; guarded by _lock
stats = {"fetches": 0, "hedges": 0, "hedge_wins": 0, "ewma_s": 0.0}
_lock = threading.Lock()


def _current_timeout() -> float:
    with _lock:
        ewma = stats["ewma_s"]
    t = max(HEDGE_MIN_S, HEDGE_FACTOR * ewma)
    return min(t, HEDGE_MAX_S)


def _record(wall: float, attempt: int) -> None:
    with _lock:
        stats["fetches"] += 1
        if attempt > 0:
            stats["hedge_wins"] += 1
        e = stats["ewma_s"]
        stats["ewma_s"] = wall if e == 0.0 else 0.8 * e + 0.2 * wall


def hedged_device_get(tree, timeout_s: float | None = None):
    """`jax.device_get(tree)` with stall hedging (see module docstring)."""
    base = _current_timeout() if timeout_s is None else timeout_s
    if base <= 0 or HEDGE_MIN_S <= 0:
        return _get_fn(tree)
    q: queue.SimpleQueue = queue.SimpleQueue()
    t0 = time.perf_counter()

    def attempt(i):
        try:
            q.put(("ok", i, _get_fn(tree)))
        except BaseException as e:  # reported to the waiter below
            q.put(("err", i, e))

    launched = 1
    threading.Thread(
        target=attempt, args=(0,), daemon=True,
        name="clark-fetch-0",
    ).start()
    wait = base
    errors = []
    reported = 0
    while True:
        try:
            kind, i, val = q.get(timeout=wait)
        except queue.Empty:
            if launched <= MAX_HEDGES:
                with _lock:
                    stats["hedges"] += 1
                print(
                    f"[clark-tpu] result fetch stalled >{wait:.0f}s; "
                    f"re-issuing (attempt {launched + 1})",
                    file=sys.stderr, flush=True,
                )
                threading.Thread(
                    target=attempt, args=(launched,), daemon=True,
                    name=f"clark-fetch-{launched}",
                ).start()
                launched += 1
                wait *= 2
            else:
                # out of hedges: block on the attempts already in flight
                wait = HEDGE_MAX_S
            continue
        reported += 1
        if kind == "ok":
            _record(time.perf_counter() - t0, i)
            return val
        errors.append(val)
        if reported >= launched:
            raise errors[-1]
