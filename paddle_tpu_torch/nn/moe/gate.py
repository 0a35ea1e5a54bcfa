"""Top-k gating with capacity-factor token dropping, at fixed shapes
(counterpart of paddle_tpu/nn/moe/gate.py).

The gate never builds ragged per-expert token lists. For a batch of
groups ``x [G, S, H]`` it builds dense masks

    dispatch [G, S, E, C]   1 where token s of group g holds slot c of
                            expert e (0 when the token was dropped)
    combine  [G, S, E, C]   dispatch scaled by the normalised gate weight

so the shapes depend only on ``(G, S)``, never on the routing: a decode
step stays one CUDA graph whatever the router decides. Tokens past an
expert's capacity ``C = ceil(S * capacity_factor * top_k / E)`` are
dropped deterministically, k-major then position-major, as in the
reference. Nothing here waits for the device: no ``.item()``, no
``nonzero``, no boolean-mask indexing; one-hots are comparisons against
an ``arange``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...profiler import explainer as _explain

__all__ = ["MoEConfigError", "validate_moe_config", "TopKGate",
           "moe_capacity"]


class MoEConfigError(ValueError):
    """A MoE hyperparameter combination that cannot route correctly,
    refused at construction with a named reason."""


def validate_moe_config(num_experts, top_k, capacity_factor, ep=1,
                        op="moe"):
    """Check ``(num_experts, top_k, capacity_factor, ep)``; on the first
    violation record a ``moe_config_refused`` explainer event and raise
    :class:`MoEConfigError`. The reasons are the reference's."""

    def refuse(reason, why):
        _explain.record("moe_config_refused", op=op, reason=reason,
                        why=why, num_experts=int(num_experts),
                        top_k=int(top_k),
                        capacity_factor=float(capacity_factor), ep=int(ep))
        raise MoEConfigError(f"{why} (reason={reason})")

    if int(num_experts) < 1:
        refuse("no_experts", f"num_experts={num_experts} must be >= 1")
    if not 1 <= int(top_k) <= int(num_experts):
        refuse("top_k_exceeds_experts",
               f"top_k={top_k} must satisfy 1 <= top_k <= "
               f"num_experts={num_experts}: each token needs top_k "
               "DISTINCT experts to route to")
    if float(capacity_factor) < 1.0:
        refuse("capacity_factor_too_small",
               f"capacity_factor={capacity_factor} must be >= 1.0: below "
               "1.0 even a perfectly balanced router is forced to drop "
               "tokens")
    if int(ep) < 1 or int(num_experts) % int(ep) != 0:
        refuse("experts_indivisible_by_ep",
               f"num_experts={num_experts} is not divisible by expert-"
               f"parallel degree ep={ep}: each ep rank must own an equal "
               "[E/ep] slice of every expert bank")


def moe_capacity(seq_len, num_experts, top_k, capacity_factor):
    """Per-expert slot count ``C = ceil(S * cf * k / E)``, at least 1."""
    return max(1, int(math.ceil(float(seq_len) * float(capacity_factor)
                                * int(top_k) / int(num_experts))))


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward sums the gradient too: the
    loss built on it is the same on every rank, and the gradients are
    then averaged over the ranks, which gives each rank's inputs the
    whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        from ...distributed import collective

        ctx.group = group
        out = x.clone()
        collective.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        from ...distributed import collective

        g = g.clone()
        collective.all_reduce(g, group=ctx.group)
        return g, None


def _batch_sum(x, group):
    """``x`` summed over ``group`` (itself without one)."""
    if group is None or group.nranks <= 1:
        return x
    return _AllReduceSum.apply(x, group)


def _one_hot(idx, n):
    """float32 one-hot of an integer tensor over ``n`` classes, by
    comparison (no range check, so no wait for the device)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).float()


class TopKGate(nn.Module):
    """Dense top-k router. ``forward(x [G, S, H])`` returns ``(dispatch,
    combine, aux_loss, stats)``: float32 ``[G, S, E, C]`` masks for the
    caller to cast, the Switch-Transformer load-balancing loss
    ``E * sum_e(f_e * P_e)`` (top-1 assignment share before drops times
    mean router probability; 1.0 at uniform load, differentiable through
    ``P_e`` only), and the routing stats (``[E]`` tensors of kept and
    assigned tokens, the dropped count, and ``total`` / ``capacity`` as
    Python numbers).

    ``weight`` is ``[H, E]``, as in the reference, and is made float32;
    a model cast to bf16 casts it too (the reference's model cast does),
    and the gate then computes in float32 from the bf16 values. The
    model draws its values (``GPTModel``); built alone it is
    Normal(0, ``init_std``) from torch's default generator.

    ``batch_group`` (set at expert parallelism): the ranks that split the
    batch; the ``[E]`` sums behind the loss and the stats are all-reduced
    over it (the probability sum with a backward that all-reduces too), so
    both are the whole batch's, as in the reference."""

    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=1.25,
                 init_std=0.02):
        super().__init__()
        validate_moe_config(num_experts, top_k, capacity_factor,
                            op="TopKGate")
        self.num_experts = int(num_experts)
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.init_std = float(init_std)
        self.weight = nn.Parameter(torch.empty(d_model, self.num_experts,
                                               dtype=torch.float32))
        self.batch_group = None
        if self.weight.device.type != "meta":
            self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Normal(0, init_std) from ``generator``."""
        self.weight.normal_(0.0, self.init_std, generator=generator)

    def forward(self, x):
        G, S, _ = x.shape
        E, K = self.num_experts, self.top_k
        C = moe_capacity(S, E, K, self.capacity_factor)

        logits = torch.einsum("gsh,he->gse", x.float(), self.weight.float())
        probs = torch.softmax(logits, dim=-1)  # [G, S, E] float32

        # k argmax rounds over progressively masked probabilities (first
        # index on ties, as jnp.argmax); no gradient through the choice
        masked = probs.detach()
        top_masks, top_gates = [], []
        for k in range(K):
            mask = _one_hot(masked.argmax(dim=-1), E)         # [G, S, E]
            top_masks.append(mask)
            top_gates.append((probs * mask).sum(dim=-1))      # [G, S]
            if k + 1 < K:
                masked = masked * (1.0 - mask)

        # capacity slots, k-major then position-major: a token's k=0
        # choice outranks every k=1 choice, and within one round earlier
        # positions win; ``base`` carries each expert's earlier counts
        base = None
        keeps, positions = [], []
        for k, mask in enumerate(top_masks):
            pos = torch.cumsum(mask, dim=1) - mask            # [G, S, E]
            if base is not None:
                pos = pos + base
            if k + 1 < K:
                counts = mask.sum(dim=1, keepdim=True)
                base = counts if base is None else base + counts
            keeps.append(mask * (pos < float(C)).float())
            positions.append(pos)

        # each kept assignment's router probability, normalised over the
        # token's kept assignments; only a token whose every choice was
        # dropped gets the guard (its combine row is zero anyway), so the
        # common path is not perturbed
        denom = None
        for g, keep in zip(top_gates, keeps):
            term = g * keep.sum(dim=-1)
            denom = term if denom is None else denom + term
        denom = denom + (denom < 1e-12).float()

        dispatch = combine = None
        for g, keep, pos in zip(top_gates, keeps, positions):
            slot = _one_hot(pos.clamp(0.0, float(C - 1)).long(), C)
            d = keep.unsqueeze(-1) * slot                     # [G, S, E, C]
            w = (g / denom).unsqueeze(-1).unsqueeze(-1)
            dispatch = d if dispatch is None else dispatch + d
            combine = w * d if combine is None else combine + w * d

        group = self.batch_group
        n = 1 if group is None else group.nranks
        f_e = _batch_sum(top_masks[0].sum(dim=(0, 1)), group) / (G * S * n)
        p_e = _batch_sum(probs.sum(dim=(0, 1)), group) / (G * S * n)
        aux_loss = (f_e * p_e).sum() * float(E)

        kept_total = _batch_sum(dispatch.detach().sum(dim=(0, 1, 3)), group)
        assigned = None
        for m in top_masks:
            s = m.sum(dim=(0, 1))
            assigned = s if assigned is None else assigned + s
        assigned = _batch_sum(assigned, group)
        stats = {"expert_tokens": kept_total, "expert_assigned": assigned,
                 "dropped": (assigned - kept_total).sum(),
                 "total": float(G * S * K * n), "capacity": C}
        return dispatch, combine, aux_loss, stats
