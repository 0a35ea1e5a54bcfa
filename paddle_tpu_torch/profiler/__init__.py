"""Observability for the port: the counter/timing/histogram registry, the
cause ring, request traces with the flight recorder, the host span
timeline (counterparts of paddle_tpu/profiler/{registry,explainer,tracing,
timeline}.py), and ``RecordEvent``."""
import time

import torch

from . import explainer, registry, timeline, tracing

__all__ = ["explainer", "registry", "timeline", "tracing", "RecordEvent"]


class RecordEvent:
    """A named host span (counterpart of paddle_tpu/profiler's
    ``RecordEvent``): ``with RecordEvent("forward"): ...`` or
    ``begin()`` / ``end()``.

    begin/end form a stack: each ``begin`` opens a span and ``end`` closes
    the innermost; an ``end`` without a ``begin`` does nothing. Each span
    enters ``torch.profiler.record_function`` (so a torch.profiler trace
    shows it, device work nested under it) and, while a ``timeline``
    window records, adds a host span to it."""

    __slots__ = ("name", "_stack")

    def __init__(self, name, event_type=None):
        self.name = name
        self._stack = []

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def begin(self):
        ctx = torch.profiler.record_function(self.name)
        ctx.__enter__()
        self._stack.append(
            (ctx, time.perf_counter() if timeline.active() else None))

    def end(self):
        if not self._stack:
            return
        ctx, t0 = self._stack.pop()
        ctx.__exit__(None, None, None)
        if t0 is not None:
            timeline.add_span(self.name, t0, time.perf_counter())
