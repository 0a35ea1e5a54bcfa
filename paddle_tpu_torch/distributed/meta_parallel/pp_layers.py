"""Pipeline layer descriptions (counterpart of
paddle_tpu/distributed/meta_parallel/pp_layers.py).

``LayerDesc`` / ``SharedLayerDesc`` describe the layers of a
``PipelineLayer``, which builds every one of them (a shared description's
layer once, under its key) into ``run_sequence`` and runs them in order.
``segment_for_pipeline(pp)`` splits the sequence as the reference does:
the longest run of structurally uniform plain layers (same class, same
state names and shapes), trimmed to a multiple of ``pp``, is the trunk the
pipeline cuts into ``pp`` equal stages; the entries before it run on the
first stage and those after it (leftover blocks, a norm, a head) on the
last. The port's pipeline ranks each run their stage's trunk slice and
keep every non-trunk layer, so a ``SharedLayerDesc`` used on the first
and the last stage is one parameter on each rank whose gradient is summed
over the pipeline group (``pp_spmd``, ``fleet.hybrid_engine``).

Every refusal raises :class:`PipelineStageError` and records an
``spmd_pp_refused`` explainer event with the reference's ``reason``.
"""
from __future__ import annotations

from torch import nn

from ...profiler import explainer as _explain

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineStageError", "refuse"]


class PipelineStageError(ValueError):
    """A model and topology the pipeline paths cannot cut into stages (a
    layer count the degree does not divide, no uniform trunk, an
    indivisible batch); every raise is paired with an ``spmd_pp_refused``
    explainer event naming the reason."""


def refuse(op, reason, why, **detail):
    """Record the ``spmd_pp_refused`` event and return the error."""
    _explain.record("spmd_pp_refused", op=op, reason=reason, why=why,
                    **detail)
    return PipelineStageError(why)


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, *args, forward_func=None,
                 shared_weight_attr="weight", **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(nn.Module):
    """``layers``: LayerDescs, SharedLayerDescs, modules or plain
    callables, run in order by ``forward``. ``run_sequence`` holds
    ``(kind, item, forward_func)`` per entry: ``("layer", module, fn)``,
    ``("shared", key, fn)`` for a later use of a shared layer, or
    ``("fn", callable, None)``."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._num_stages = num_stages or 1
        self._seg_method = seg_method
        self._recompute_interval = recompute_interval
        self._shared = {}
        built = []
        for d in layers:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name in self._shared:
                    built.append(("shared", d.layer_name, d.forward_func))
                    continue
                layer = d.build_layer()
                self._shared[d.layer_name] = layer
                built.append(("layer", layer, d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append(("layer", d.build_layer(), None))
            elif callable(d) and not isinstance(d, nn.Module):
                built.append(("fn", d, None))
            else:
                built.append(("layer", d, None))
        self.run_sequence = built
        self.layers = nn.ModuleList(
            [b[1] for b in built if b[0] == "layer"])

    def get_stage_from_index(self, idx):
        n = len(self.run_sequence)
        per = (n + self._num_stages - 1) // self._num_stages
        return idx // per

    def _apply(self, entry, x):
        """Run one ``run_sequence`` entry on ``x``. (``nn.Module._apply``
        takes a function and no entry: the two never meet, since torch
        calls it with one argument.)"""
        if not isinstance(entry, tuple):  # torch's .to() / .float() path
            return super()._apply(entry, x)
        kind, item, ffn = entry
        if kind == "shared":
            layer = self._shared[item]
            return ffn(layer, x) if ffn is not None else layer(x)
        if kind == "fn":
            return item(x)
        return ffn(item, x) if ffn is not None else item(x)

    def segment_for_pipeline(self, pp):
        """``(pre_entries, trunk_layers, post_entries)``: see the module's
        docstring. ``seg_method="layer:Name"`` keeps only trunk candidates
        whose class name starts with ``Name``."""
        entries = list(self.run_sequence)
        want_cls = None
        if isinstance(self._seg_method, str) and \
                self._seg_method.startswith("layer:"):
            want_cls = self._seg_method[len("layer:"):]

        def sig(entry):
            kind, item, ffn = entry
            if kind != "layer" or ffn is not None:
                return None
            cls = type(item).__name__
            if want_cls is not None and not cls.startswith(want_cls):
                return None
            sd = item.state_dict()
            return (cls, tuple(sd.keys()),
                    tuple(tuple(t.shape) for t in sd.values()))

        sigs = [sig(e) for e in entries]
        start, length = 0, 0
        i = 0
        while i < len(entries):
            if sigs[i] is None:
                i += 1
                continue
            j = i
            while j < len(entries) and sigs[j] == sigs[i]:
                j += 1
            if j - i > length:
                start, length = i, j - i
            i = j
        usable = (length // pp) * pp
        if usable < pp:
            err = refuse(
                "PipelineLayer.segment_for_pipeline", "no_uniform_trunk",
                f"PipelineLayer: found no structurally-uniform run of at "
                f"least pp={pp} layers to shard over the pipe axis "
                f"(longest run: {length}); give the pipeline a uniform "
                "trunk (embedding + N identical blocks + head)",
                pp=pp, longest_run=length)
            raise err
        pre = entries[:start]
        trunk = [e[1] for e in entries[start:start + usable]]
        post = entries[start + usable:]
        return pre, trunk, post

    def forward(self, x):
        for entry in self.run_sequence:
            x = self._apply(entry, x)
        return x
