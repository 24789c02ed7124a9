"""Hedged result fetch (utils/fetch.py): a stalled device_get must not
block the caller once a re-issued fetch can succeed."""

import threading
import time

import numpy as np
import pytest

from jn_cuclark_tpu.utils import fetch


@pytest.fixture
def patched(monkeypatch):
    calls = {"n": 0}
    release = threading.Event()

    def fake_get(tree):
        i = calls["n"]
        calls["n"] += 1
        if i == 0:
            # first attempt stalls until the test releases it
            release.wait(timeout=30)
            return ("stalled", tree)
        return ("ok", tree)

    monkeypatch.setattr(fetch, "_get_fn", fake_get)
    yield calls, release
    release.set()


def test_hedge_rescues_stalled_fetch(patched):
    calls, release = patched
    t0 = time.perf_counter()
    kind, val = fetch.hedged_device_get([1, 2, 3], timeout_s=0.2)
    dt = time.perf_counter() - t0
    assert kind == "ok"
    assert val == [1, 2, 3]
    assert calls["n"] == 2  # hedge was issued
    assert dt < 5  # did not wait out the stall
    release.set()


def test_no_hedge_on_fast_fetch(monkeypatch):
    calls = {"n": 0}

    def fake_get(tree):
        calls["n"] += 1
        return np.asarray(tree) * 2

    monkeypatch.setattr(fetch, "_get_fn", fake_get)
    out = fetch.hedged_device_get([1, 2], timeout_s=5.0)
    np.testing.assert_array_equal(out, [2, 4])
    assert calls["n"] == 1


def test_error_propagates_when_all_attempts_fail(monkeypatch):
    def fake_get(tree):
        raise RuntimeError("boom")

    monkeypatch.setattr(fetch, "_get_fn", fake_get)
    with pytest.raises(RuntimeError, match="boom"):
        fetch.hedged_device_get([1], timeout_s=1.0)


def test_stall_then_error_then_success(monkeypatch):
    """err on a hedge must not abort while the stalled attempt can finish."""
    calls = {"n": 0}
    release = threading.Event()

    def fake_get(tree):
        i = calls["n"]
        calls["n"] += 1
        if i == 0:
            release.wait(timeout=30)
            return "late-ok"
        release.set()  # free the first attempt, then fail this one
        raise RuntimeError("hedge failed")

    monkeypatch.setattr(fetch, "_get_fn", fake_get)
    assert fetch.hedged_device_get([1], timeout_s=0.2) == "late-ok"


def test_adaptive_timeout_tracks_ewma(monkeypatch):
    monkeypatch.setitem(fetch.stats, "ewma_s", 5.0)
    assert fetch._current_timeout() == pytest.approx(40.0)
    monkeypatch.setitem(fetch.stats, "ewma_s", 0.01)
    assert fetch._current_timeout() == pytest.approx(fetch.HEDGE_MIN_S)
    monkeypatch.setitem(fetch.stats, "ewma_s", 100.0)
    assert fetch._current_timeout() == pytest.approx(fetch.HEDGE_MAX_S)
