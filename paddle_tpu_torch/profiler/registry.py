"""Process-wide counters, gauges, timings and latency histograms
(counterpart of paddle_tpu/profiler/registry.py, the subset the serving
slice uses).

Hot-path contract, as in the reference: ``scoped_counters(scope)`` hands the
producer a plain dict it bumps directly (``d["x"] += 1``). The registry
keeps that dict object forever and ``reset()`` zeroes it in place, so
module-level aliases stay valid across resets. Histograms are zeroed in
place the same way.
"""
from __future__ import annotations

import math
import random
import threading
import time

_lock = threading.Lock()
_counter_scopes: dict = {}
_timing_scopes: dict = {}
_hist_scopes: dict = {}
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


def inc(name, n=1, scope="misc"):
    """Add ``n`` to one counter of ``scope`` (created at 0)."""
    d = _counter_scopes.get(scope)
    if d is None:
        d = scoped_counters(scope)
    d[name] = d.get(name, 0) + n


def tally(scope, name, *tensors):
    """Bump ``<name>.calls`` and ``<name>.bytes`` in ``scope`` (the bytes
    of ``tensors``): the collective and mp traffic counters."""
    d = _counter_scopes.get(scope)
    if d is None:
        d = scoped_counters(scope)
    d[name + ".calls"] = d.get(name + ".calls", 0) + 1
    d[name + ".bytes"] = d.get(name + ".bytes", 0) + sum(
        t.numel() * t.element_size() for t in tensors)


def gauge_set(name, value):
    _gauges[name] = value


def gauge(name, default=None):
    return _gauges.get(name, default)


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


# Log2-bucket latency histograms, with the reference's geometry, so the same
# observations give the same buckets and quantiles in both packages: bucket
# i holds (2**(EMIN+i-1), 2**(EMIN+i)] seconds, ``frexp(v)[1] - EMIN`` is
# the index, and values past either end clamp into the edge buckets (44
# buckets span ~0.95 us to 2**23 s). Snapshots merge by summing buckets.
HIST_EMIN = -20
HIST_NBUCKETS = 44


def hist_record(name, seconds, scope="serving"):
    """Record one duration observation into a log2 histogram."""
    s = _hist_scopes.get(scope)
    if s is None:
        with _lock:
            s = _hist_scopes.setdefault(scope, {})
    rec = s.get(name)
    if rec is None:
        rec = s[name] = [0, 0.0, [0] * HIST_NBUCKETS]
    rec[0] += 1
    rec[1] += seconds
    i = 0
    if seconds > 0.0:
        i = min(max(math.frexp(seconds)[1] - HIST_EMIN, 0),
                HIST_NBUCKETS - 1)
    rec[2][i] += 1


def hist_bucket_upper_ms(i):
    """Upper edge of bucket ``i`` in milliseconds."""
    return 2.0 ** (HIST_EMIN + int(i)) * 1e3


def hist_quantile_ms(snap, q):
    """Quantile of a histogram snapshot: the upper edge of the bucket where
    the cumulative count reaches ``q`` of the total (at most 2x above the
    true value, by the log2 geometry)."""
    cnt = snap.get("count", 0)
    if not cnt:
        return 0.0
    buckets = snap.get("buckets") or {}
    target = q * cnt
    acc = last = 0
    for i in sorted(int(b) for b in buckets):
        acc += buckets[str(i)]
        last = i
        if acc >= target:
            break
    return hist_bucket_upper_ms(last)


def hist_merge(dst, src):
    """Merge snapshot ``src`` into dict ``dst`` in place: counts and totals
    summed bucket by bucket, the mean and quantiles refreshed."""
    dst["count"] = dst.get("count", 0) + src.get("count", 0)
    dst["total_s"] = dst.get("total_s", 0.0) + src.get("total_s", 0.0)
    db = dst.setdefault("buckets", {})
    for b, n in (src.get("buckets") or {}).items():
        db[b] = db.get(b, 0) + n
    cnt = dst["count"]
    dst["mean_ms"] = dst["total_s"] / cnt * 1e3 if cnt else 0.0
    dst["p50_ms"] = hist_quantile_ms(dst, 0.5)
    dst["p99_ms"] = hist_quantile_ms(dst, 0.99)
    return dst


def histograms(scope=None):
    """``{"<scope>.<name>": {count, total_s, mean_ms, p50_ms, p99_ms,
    buckets}}`` of every histogram with an observation since the last
    reset; ``buckets`` is sparse, ``{str(index): count}`` (JSON-safe)."""
    scopes = [scope] if scope is not None else list(_hist_scopes)
    out = {}
    for sc in scopes:
        for k, (cnt, tot, b) in list(_hist_scopes.get(sc, {}).items()):
            if not cnt:
                continue
            snap = {"count": cnt, "total_s": tot, "mean_ms": tot / cnt * 1e3,
                    "buckets": {str(i): n for i, n in enumerate(b) if n}}
            snap["p50_ms"] = hist_quantile_ms(snap, 0.5)
            snap["p99_ms"] = hist_quantile_ms(snap, 0.99)
            out[f"{sc}.{k}"] = snap
    return out


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


def snapshot():
    return {"counters": counters(), "gauges": gauges(),
            "timings": timings(), "hists": histograms()}


def reset(scope=None):
    """Zero counters and histograms in place and drop timings (one scope,
    or everything plus the gauges). Counter keys survive with value 0."""
    with _lock:
        for sc, d in list(_counter_scopes.items()):
            if scope is None or sc == scope:
                for k in list(d):
                    d[k] = 0
        for sc, s in list(_timing_scopes.items()):
            if scope is None or sc == scope:
                s.clear()
        for sc, h in list(_hist_scopes.items()):
            if scope is None or sc == scope:
                for rec in list(h.values()):
                    rec[0], rec[1] = 0, 0.0
                    rec[2][:] = [0] * HIST_NBUCKETS
        if scope is None:
            _gauges.clear()
