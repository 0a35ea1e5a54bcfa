"""Host span buffer and its chrome-trace export (counterpart of
paddle_tpu/profiler/timeline.py).

While a recording window is open (:func:`start` .. :func:`stop`),
:func:`add_span` appends ``(name, tid, t0, t1)`` spans in
``time.perf_counter`` seconds; outside a window it is one boolean check.
:func:`to_chrome_trace` renders spans as chrome-trace "X" events.
"""
from __future__ import annotations

import json
import os
import threading

_lock = threading.Lock()
_active = False
_spans: list = []


def active():
    return _active


def start():
    global _active
    with _lock:
        _spans.clear()
        _active = True


def stop():
    """Close the window and return its spans."""
    global _active
    with _lock:
        _active = False
        out = list(_spans)
        _spans.clear()
    return out


def add_span(name, t0, t1, tid=None):
    if not _active:
        return
    _spans.append((name, tid if tid is not None else threading.get_ident(),
                   t0, t1))


def to_chrome_trace(spans, meta=None):
    """Chrome-trace document (a dict) of a span list; ``meta`` rides under
    the "paddle_tpu" key, which chrome://tracing ignores."""
    pid = os.getpid()
    evs = [{"name": n, "ph": "X", "cat": "host",
            "ts": round(t0 * 1e6, 3), "dur": round((t1 - t0) * 1e6, 3),
            "pid": pid, "tid": tid}
           for n, tid, t0, t1 in spans]
    doc = {"traceEvents": evs, "displayTimeUnit": "ms"}
    if meta:
        doc["paddle_tpu"] = meta
    return doc


def write_chrome_trace(path, spans, meta=None):
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans, meta), f)
    return path
