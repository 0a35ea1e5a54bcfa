"""The MoE FFN layer over dense dispatch/combine einsums (counterpart of
paddle_tpu/nn/moe/layer.py).

Expert banks are stacked, ``w1 [E, H, F]``, ``b1 [E, F]``, ``w2 [E, F, H]``
and ``b2 [E, H]``, under the reference's names and in its layout (they are
not Linear weights, so ``convert`` carries them by name with no
transpose). The data path is the reference's four einsums:

    dispatch   'gsec,gsh->egch'   each expert gathers its C token slots
    expert FFN 'egch,ehf->egcf'   bank matmuls, tanh-GELU between
               'egcf,efh->egch'
    combine    'gsec,egch->gsh'   expert outputs back to their tokens,
                                  scaled by the gate weights

The reference computes them under XLA, outside any Pallas kernel, and so
does the port, with ``torch.einsum``. One card holds every expert: the
reference's expert-parallel exchange (``ep > 1``) is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .gate import TopKGate, validate_moe_config

__all__ = ["MoEMLP"]


def _capturing(x):
    """Whether a CUDA graph is capturing the stream that computes ``x``."""
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


class MoEMLP(nn.Module):
    """Drop-in MLP replacement routing each token to ``top_k`` of
    ``num_experts`` expert FFNs; ``forward(x [G, S, H]) -> [G, S, H]``,
    each of the ``G`` rows of ``x`` one routing group.

    The forward's load-balancing loss lands on ``aux_loss`` and its
    routing stats on ``last_stats`` (read them in the same step; see
    ``nn.moe.metrics``). An inference forward (no autograd) that a CUDA
    graph is capturing leaves both as they were: the graph's outputs live
    in its memory pool, which other graphs' replays overwrite. A training
    forward under capture (``jit.TrainStep``) sets them, since the step
    adds ``aux_loss`` to its loss: they are then the graph's tensors, which
    each replay rewrites with that step's values. Built alone, the banks
    are drawn from torch's default generator (Normal ``init_std`` for ``w1``,
    ``out_init_std`` for ``w2``, zero biases); ``GPTModel`` draws them
    from its own generator."""

    def __init__(self, d_model, d_ff, num_experts, top_k=2,
                 capacity_factor=1.25, dropout=0.0, init_std=0.02,
                 out_init_std=None, ep=1):
        super().__init__()
        validate_moe_config(num_experts, top_k, capacity_factor, ep=ep,
                            op="MoEMLP")
        if int(ep) > 1:
            raise NotImplementedError(
                f"ep={ep}: expert parallelism (the expert all-to-all over "
                "an 'ep' mesh axis) is not ported; ROADMAP.md queue 1 "
                "item 7 holds it. One card holds every expert at ep=1")
        E = self.num_experts = int(num_experts)
        self.init_std = float(init_std)
        self.out_init_std = float(out_init_std or init_std)
        self.gate = TopKGate(d_model, E, top_k=top_k,
                             capacity_factor=capacity_factor,
                             init_std=init_std)

        def bank(*shape):
            return nn.Parameter(torch.empty(*shape))

        # registration order is the reference's parameter order (its
        # optimizer slots are numbered by it): w1, b1, w2, b2, gate.weight
        self.w1 = bank(E, d_model, d_ff)
        self.b1 = bank(E, d_ff)
        self.w2 = bank(E, d_ff, d_model)
        self.b2 = bank(E, d_model)
        self.dropout = nn.Dropout(dropout) if dropout else None
        if self.w1.device.type != "meta":  # GPTModel draws them itself
            self.reset_parameters()
        self.aux_loss = None
        self.last_stats = None

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Normal(0, init_std) ``w1`` and gate weight, Normal(0,
        out_init_std) ``w2``, zero biases, drawn from ``generator``."""
        self.gate.reset_parameters(generator)
        self.w1.normal_(0.0, self.init_std, generator=generator)
        self.w2.normal_(0.0, self.out_init_std, generator=generator)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, x):
        dispatch, combine, aux_loss, stats = self.gate(x)
        if torch.is_grad_enabled() or not _capturing(x):
            self.aux_loss, self.last_stats = aux_loss, stats
        dispatch = dispatch.to(x.dtype)
        combine = combine.to(x.dtype)
        h = torch.einsum("gsec,gsh->egch", dispatch, x)
        h = torch.einsum("egch,ehf->egcf", h, self.w1) \
            + self.b1[:, None, None]
        h = F.gelu(h, approximate="tanh")
        h = torch.einsum("egcf,efh->egch", h, self.w2) \
            + self.b2[:, None, None]
        y = torch.einsum("gsec,egch->gsh", combine, h)
        if self.dropout is not None:
            y = self.dropout(y)
        return y
