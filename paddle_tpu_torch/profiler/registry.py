"""Process-wide counters, gauges and timings (counterpart of
paddle_tpu/profiler/registry.py, the subset the serving slice uses).

Hot-path contract, as in the reference: ``scoped_counters(scope)`` hands the
producer a plain dict it bumps directly (``d["x"] += 1``). The registry
keeps that dict object forever and ``reset()`` zeroes it in place, so
module-level aliases stay valid across resets.
"""
from __future__ import annotations

import random
import threading
import time

_lock = threading.Lock()
_counter_scopes: dict = {}
_timing_scopes: dict = {}
_gauges: dict = {}

# per-timing reservoir: a uniform sample of the raw observations, so
# percentiles stay available over unbounded runs
RESERVOIR_CAP = 128


def scoped_counters(scope, initial=None):
    """The counter table (a plain dict) for ``scope``, created on first
    use. ``initial`` pre-seeds keys (existing values win)."""
    d = _counter_scopes.get(scope)
    if d is None:
        with _lock:
            d = _counter_scopes.setdefault(scope, {})
    if initial:
        for k, v in initial.items():
            d.setdefault(k, v)
    return d


def gauge_set(name, value):
    _gauges[name] = value


def gauge_drop(name):
    _gauges.pop(name, None)


def timing(name, seconds, scope="timings"):
    """Accumulate one duration: ``[count, total_seconds, reservoir]``."""
    s = _timing_scopes.get(scope)
    if s is None:
        with _lock:
            s = _timing_scopes.setdefault(scope, {})
    rec = s.get(name)
    if rec is None:
        s[name] = [1, float(seconds), [float(seconds)]]
        return
    rec[0] += 1
    rec[1] += seconds
    res = rec[2]
    if len(res) < RESERVOIR_CAP:
        res.append(seconds)
    else:
        j = int(random.random() * rec[0])
        if j < RESERVOIR_CAP:
            res[j] = seconds


class time_block:
    """``with time_block("phase", scope=...):`` records one timing."""

    __slots__ = ("_name", "_scope", "_t0")

    def __init__(self, name, scope="timings"):
        self._name = name
        self._scope = scope

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        timing(self._name, time.perf_counter() - self._t0, self._scope)
        return False


def counters(scope=None):
    """Flat snapshot ``{"<scope>.<name>": value}``, or one scope's dict."""
    if scope is not None:
        return dict(_counter_scopes.get(scope, ()))
    return {f"{sc}.{k}": v for sc, d in list(_counter_scopes.items())
            for k, v in list(d.items())}


def timings(scope=None):
    """``{"<scope>.<name>": {count, total_s, mean_ms, p50_ms, p99_ms}}``;
    the percentiles come from the reservoir."""
    scopes = [scope] if scope is not None else list(_timing_scopes)
    out = {}
    for sc in scopes:
        for k, (cnt, tot, res) in list(_timing_scopes.get(sc, {}).items()):
            srt = sorted(res)
            out[f"{sc}.{k}"] = {
                "count": cnt, "total_s": tot,
                "mean_ms": tot / cnt * 1e3,
                "p50_ms": srt[len(srt) // 2] * 1e3,
                "p99_ms": srt[min(len(srt) - 1, int(len(srt) * 0.99))] * 1e3}
    return out


def gauges():
    return dict(_gauges)


def reset(scope=None):
    """Zero counters and drop timings (one scope, or everything plus the
    gauges). Counter keys survive with value 0."""
    with _lock:
        for sc, d in list(_counter_scopes.items()):
            if scope is None or sc == scope:
                for k in list(d):
                    d[k] = 0
        for sc, s in list(_timing_scopes.items()):
            if scope is None or sc == scope:
                s.clear()
        if scope is None:
            _gauges.clear()
