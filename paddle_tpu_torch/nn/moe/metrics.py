"""Expert-load observability: routing stats into the metrics registry
(counterpart of paddle_tpu/nn/moe/metrics.py).

Every MoE forward leaves fixed-``[E]`` routing stats on its layer
(``MoEMLP.last_stats``); reading them waits for the device, so publishing
is an explicit audit call, never part of a step:

    y = model(batch)           # an eager forward
    moe.metrics.publish(model) # reads the [E] stats, fills the registry

Registry layout, as in the reference:

    counters scope "moe":  expert_tokens.e<i>  kept tokens per expert
                           tokens_assigned / tokens_kept / tokens_dropped
    gauge:                 moe.drop_fraction   latest drop fraction
    histogram scope "moe": expert_load_frac    each expert's share of the
                           kept tokens per observation, in the log2
                           buckets of the latency histograms (a share,
                           not a time: uniform load piles into the 1/E
                           bucket)

A served model's layers keep the stats of their last eager forward: a
forward under CUDA-graph capture does not set them (``MoEMLP``), so
``collect`` never reads a graph's memory.
"""
from __future__ import annotations

import numpy as np

from ...profiler import registry as _registry

__all__ = ["publish", "collect", "snapshot"]


def _moe_layers(model):
    from .layer import MoEMLP

    return [m for m in model.modules() if isinstance(m, MoEMLP)]


def collect(model):
    """The latest routing stats of every ``MoEMLP`` in ``model``, summed,
    on the host: ``{expert_tokens [E], expert_assigned [E], dropped,
    total, drop_fraction}``, or None when no MoE layer has run a forward
    yet."""
    tokens = assigned = None
    dropped = total = 0.0
    seen = False
    for lyr in _moe_layers(model):
        st = lyr.last_stats
        if st is None:
            continue
        seen = True
        t = st["expert_tokens"].detach().cpu().double().numpy()
        a = st["expert_assigned"].detach().cpu().double().numpy()
        tokens = t if tokens is None else tokens + t
        assigned = a if assigned is None else assigned + a
        dropped += float(st["dropped"])
        total += float(st["total"])
    if not seen:
        return None
    return {"expert_tokens": tokens, "expert_assigned": assigned,
            "dropped": dropped, "total": total,
            "drop_fraction": dropped / total if total else 0.0}


def publish(model):
    """``collect`` and write the result into the registry (audit calls
    only). Returns the collected dict, or None when nothing ran."""
    snap = collect(model)
    if snap is None:
        return None
    tokens = snap["expert_tokens"]
    kept_sum = float(tokens.sum())
    for i, n in enumerate(tokens):
        _registry.inc(f"expert_tokens.e{i}", int(n), scope="moe")
        if kept_sum > 0.0:
            _registry.hist_record("expert_load_frac", float(n) / kept_sum,
                                  scope="moe")
    _registry.inc("tokens_assigned", int(snap["total"]), scope="moe")
    _registry.inc("tokens_kept", int(kept_sum), scope="moe")
    _registry.inc("tokens_dropped", int(snap["dropped"]), scope="moe")
    _registry.gauge_set("moe.drop_fraction", snap["drop_fraction"])
    return snap


def snapshot():
    """The registry's view of expert load, ``{"counters", "hists",
    "drop_fraction"}``, or None before anything was published."""
    counters = _registry.counters("moe")
    hists = _registry.histograms("moe")
    if not counters and not hists:
        return None
    return {"counters": counters, "hists": hists,
            "drop_fraction": _registry.gauge("moe.drop_fraction", 0.0)}
