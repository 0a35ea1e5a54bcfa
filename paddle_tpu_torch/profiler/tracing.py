"""Request traces and the flight recorder (counterpart of
paddle_tpu/profiler/tracing.py; the same ids, spans and file formats, so a
trace or a flight dump written by either package reads in the other).

* **Trace context.** A request's trace id is a splitmix64 hash of its
  pinned sampling seed, so a replay of the request (same seed) lands in
  the same trace, and a handoff carries the id in its payload. Spans are
  ``(trace_id, name, tid, t0, t1[, meta])`` in local ``clock()`` seconds,
  appended to a bounded ring only while tracing is enabled (env
  ``PADDLE_TPU_TRACE=1`` or :func:`enable`); a disabled process pays one
  global load per span site.
* **Clock alignment.** The span clock is ``time.monotonic``, the clock the
  scheduler stamps request lifecycles with. :func:`clock_anchor` maps it
  to wall time for processes on one host; :func:`offset_from_exchange`
  estimates the offset of another process's clock from one request/reply
  exchange (error at most half the round trip).
* **Flight recorder.** An always-on bounded ring
  (``PADDLE_TPU_FLIGHT_RING`` events, default 256) of request lifecycle
  events (submit, admit, handoff, swap, finish, fatal);
  :func:`dump_flight_recorder` writes it as JSON when a process is about
  to lose its engine.

:class:`FleetTraceCollector` merges span buffers of several processes into
one chrome-trace document with one trace id per request.
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time

clock = time.monotonic

_lock = threading.Lock()
_MASK = (1 << 64) - 1

FLIGHT_SCHEMA = "paddle_tpu.flight/1"


# ------------------------------------------------------------ trace ids --
def trace_id_for_seed(seed):
    """Deterministic 16-hex trace id of a request's pinned sampling seed
    (the splitmix64 finalizer)."""
    x = (int(seed) + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    x ^= x >> 31
    return f"{x:016x}"


# ------------------------------------------------------------ span ring --
_enabled = os.environ.get("PADDLE_TPU_TRACE", "") not in ("", "0")
_span_cap = int(os.environ.get("PADDLE_TPU_TRACE_RING", "8192"))
_spans: list = []
_spans_dropped = 0


def enabled():
    return _enabled


def enable(capacity=None):
    """Start recording spans (idempotent). ``capacity`` bounds the ring:
    spans past it are dropped and counted, never grown."""
    global _enabled, _span_cap
    if capacity is not None:
        _span_cap = int(capacity)
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def add_span(trace_id, name, t0, t1, tid=None, meta=None):
    """Record one closed span; a no-op while tracing is disabled. ``meta``
    (a JSON-able dict, e.g. the bytes a handoff moved) rides as a sixth
    element; spans without it keep the 5-tuple shape."""
    global _spans_dropped
    if not _enabled:
        return
    if len(_spans) >= _span_cap:
        _spans_dropped += 1
        return
    tid = tid if tid is not None else threading.get_ident()
    if meta:
        _spans.append((trace_id or "", name, tid, t0, t1, dict(meta)))
    else:
        _spans.append((trace_id or "", name, tid, t0, t1))


class span:
    """``with span(trace_id, "prefill"):`` records one span on exit; with
    tracing disabled the body runs with no bookkeeping."""

    __slots__ = ("_trace", "_name", "_t0")

    def __init__(self, trace_id, name):
        self._trace = trace_id
        self._name = name

    def __enter__(self):
        self._t0 = clock() if _enabled else 0.0
        return self

    def __exit__(self, *exc):
        if self._t0:
            add_span(self._trace, self._name, self._t0, clock())
        return False


def drain_spans():
    """Return and clear the span ring as lists ``[trace_id, name, tid, t0,
    t1(, meta)]`` in local clock seconds."""
    global _spans_dropped
    with _lock:
        out = [list(s) for s in _spans]
        _spans.clear()
        _spans_dropped = 0
    return out


def spans_dropped():
    return _spans_dropped


def pending_spans():
    return len(_spans)


# ------------------------------------------------------ clock alignment --
def clock_anchor():
    """Wall-clock epoch of the span clock: ``clock() + clock_anchor()`` is
    wall time."""
    return time.time() - clock()


def offset_from_exchange(t_send, t_recv, remote_now):
    """Offset to add to a remote process's timestamps to land on the local
    clock, from one exchange: the remote read its clock (``remote_now``)
    between our ``t_send`` and ``t_recv``, so the midpoint estimate is off
    by at most half the round trip."""
    return (t_send + t_recv) / 2.0 - remote_now


# ------------------------------------------------------ fleet collector --
class FleetTraceCollector:
    """Merge per-process span buffers into one chrome-trace document.

    Each process registers under a label ("router", "pod0", ...) with the
    offset that maps its span clock onto the collector's; ``add_spans`` is
    cumulative."""

    def __init__(self):
        self._procs: dict = {}  # label -> {"pid", "offset", "spans"}

    def set_process(self, label, pid=None, offset=0.0):
        p = self._procs.get(label)
        if p is None:
            p = self._procs[label] = {"pid": pid, "offset": float(offset),
                                      "spans": []}
        else:
            if pid is not None:
                p["pid"] = pid
            p["offset"] = float(offset)
        return p

    def add_spans(self, label, spans, pid=None, offset=None):
        p = self._procs.get(label)
        if p is None:
            p = self.set_process(label, pid=pid,
                                 offset=0.0 if offset is None else offset)
        else:
            if pid is not None:
                p["pid"] = pid
            if offset is not None:
                p["offset"] = float(offset)
        p["spans"].extend(spans)

    def span_count(self):
        return sum(len(p["spans"]) for p in self._procs.values())

    @staticmethod
    def _pid(label, p):
        return p["pid"] if p["pid"] is not None else abs(hash(label)) % 10**6

    def _aligned(self):
        """``(label, pid, trace_id, name, tid, t0, t1, meta)`` with t0/t1 on
        the collector's clock."""
        for label, p in sorted(self._procs.items()):
            off, pid = p["offset"], self._pid(label, p)
            for s in p["spans"]:
                trace_id, name, tid, t0, t1 = s[:5]
                meta = s[5] if len(s) > 5 else None
                yield (label, pid, trace_id, name, tid, t0 + off,
                       t1 + off, meta)

    def traces(self):
        """``{trace_id: [span dicts sorted by aligned start]}``; spans with
        no trace id group under ``""``."""
        out: dict = {}
        for label, pid, trace_id, name, tid, t0, t1, meta in \
                self._aligned():
            rec = {"name": name, "proc": label, "pid": pid, "tid": tid,
                   "t0": t0, "t1": t1}
            if meta:
                rec["meta"] = meta
            out.setdefault(trace_id, []).append(rec)
        for spans in out.values():
            spans.sort(key=lambda s: (s["t0"], s["t1"]))
        return out

    def to_chrome_trace(self, meta=None):
        """One chrome-trace document: an "X" event per span, its trace id
        in ``args``, and a ``process_name`` row per process."""
        evs = [{"name": "process_name", "ph": "M",
                "pid": self._pid(label, p), "args": {"name": label}}
               for label, p in sorted(self._procs.items())]
        for label, pid, trace_id, name, tid, t0, t1, m in self._aligned():
            ev = {"name": name, "ph": "X", "cat": "trace",
                  "ts": round(t0 * 1e6, 3),
                  "dur": round((t1 - t0) * 1e6, 3),
                  "pid": pid, "tid": tid}
            args = dict(m) if m else {}
            if trace_id:
                args["trace_id"] = trace_id
            if args:
                ev["args"] = args
            evs.append(ev)
        full_meta = {"clock_offsets": {label: p["offset"]
                                       for label, p in self._procs.items()}}
        if meta:
            full_meta.update(meta)
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "paddle_tpu": full_meta}

    def write(self, path, meta=None):
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(meta), f)
        return path


# ------------------------------------------------------ flight recorder --
_FLIGHT_CAP = int(os.environ.get("PADDLE_TPU_FLIGHT_RING", "256"))
_flight: collections.deque = collections.deque(maxlen=_FLIGHT_CAP)


def flight(event, rid=None, trace_id=None, **detail):
    """Record one request-lifecycle event in the always-on ring: one tuple
    and one deque append, at per-request frequency."""
    _flight.append((time.time(), event, rid, trace_id, detail or None))


def flight_events():
    """The ring as dicts, oldest first (the tail is what ran last)."""
    out = []
    for t, event, rid, trace_id, detail in list(_flight):
        rec = {"t": t, "event": event}
        if rid is not None:
            rec["rid"] = rid
        if trace_id:
            rec["trace_id"] = trace_id
        if detail:
            rec["detail"] = detail
        out.append(rec)
    return out


def flight_clear():
    _flight.clear()


def flight_dump_path():
    """``$PADDLE_TPU_FLIGHT_DIR/flight_<tag>_<pid>.json``, the tag from
    ``PADDLE_TPU_FLIGHT_TAG``; None without the directory variable."""
    d = os.environ.get("PADDLE_TPU_FLIGHT_DIR")
    if not d:
        return None
    tag = os.environ.get("PADDLE_TPU_FLIGHT_TAG") or f"pid{os.getpid()}"
    return os.path.join(d, f"flight_{tag}_{os.getpid()}.json")


def dump_flight_recorder(reason="", path=None, extra=None):
    """Write the ring to ``path`` (default :func:`flight_dump_path`, else
    the temporary directory). Runs on paths that are already failing, so
    an I/O error returns None instead of masking the original failure.
    Returns the path written."""
    if path is None:
        path = flight_dump_path()
    if path is None:
        path = os.path.join(tempfile.gettempdir(),
                            f"paddle_flight_pid{os.getpid()}.json")
    doc = {"schema": FLIGHT_SCHEMA, "reason": reason, "pid": os.getpid(),
           "wall_time": time.time(), "clock_anchor": clock_anchor(),
           "events": flight_events()}
    if extra:
        doc["extra"] = extra
    try:
        with open(path, "w") as f:
            json.dump(doc, f)
    except OSError:
        return None
    return path


def load_flight_dump(path):
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != FLIGHT_SCHEMA:
        raise ValueError(f"{path}: not a flight-recorder dump")
    return doc
