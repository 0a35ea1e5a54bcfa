"""Observability for the port: the counter/timing/histogram registry, the
cause ring, request traces with the flight recorder, and the host span
timeline (counterparts of paddle_tpu/profiler/{registry,explainer,tracing,
timeline}.py)."""
from . import explainer, registry, timeline, tracing

__all__ = ["explainer", "registry", "timeline", "tracing"]
