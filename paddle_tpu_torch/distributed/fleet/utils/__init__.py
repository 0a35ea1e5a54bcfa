"""Activation recomputation with the reference's named policies
(counterpart of paddle_tpu/distributed/fleet/utils/__init__.py).

:func:`recompute` runs ``function`` under ``torch.utils.checkpoint``
(``use_reentrant=False``): its activations are dropped after the forward
and recomputed in the backward, except the outputs the policy keeps,
which the recomputation takes from memory instead of running their
operators again (``create_selective_checkpoint_contexts``):

* ``None``: keep nothing (full recompute, the reference's plain
  ``jax.checkpoint``);
* ``"dots"``: keep every matrix product's output (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``: the Linear layers and einsums), as
  ``dots_saveable`` keeps ``dot_general``'s;
* ``"attn"``: keep the attention operator's ``(out, lse)``
  (``ops.flash_attention.attention_op``, both of its routes), the
  reference's ``save_only_these_names("attn_out")``: the attention's
  forward kernel K1 is not launched again;
* ``"dots_attn"``: both;
* a callable ``policy(op, *args, **kwargs)`` over the ATen (or custom)
  operator about to run and its arguments, returning True to keep its
  output (or a ``torch.utils.checkpoint.CheckpointPolicy``).

The attention kernel is no matrix product to a policy (the reference's
Pallas call is no ``dot_general`` either), so ``"dots"`` recomputes it.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ....amp.auto_cast import restored as _amp_restored
from ....amp.auto_cast import snapshot as _amp_snapshot
from ....ops import flash_attention  # noqa: F401  (registers the op)

__all__ = ["recompute", "recompute_policy_fn", "POLICIES"]

POLICIES = (None, "dots", "attn", "dots_attn")

_aten = torch.ops.aten
_MATMULS = frozenset({_aten.mm.default, _aten.addmm.default,
                      _aten.bmm.default, _aten.baddbmm.default})


# the attention operator as a policy sees it
_ATTENTION = torch.ops.paddle_tpu_torch.flash_attention.default


def _is_attention(op):
    return op is _ATTENTION


def recompute_policy_fn(policy):
    """The selective-checkpoint policy function for ``policy`` (None for
    full recompute). Raises ``ValueError`` for an unknown name."""
    if policy is None:
        return None
    if policy == "dots":
        def keep(op, *args, **kwargs):
            return op in _MATMULS
    elif policy == "attn":
        def keep(op, *args, **kwargs):
            return _is_attention(op)
    elif policy == "dots_attn":
        def keep(op, *args, **kwargs):
            return op in _MATMULS or _is_attention(op)
    elif callable(policy):
        keep = policy
    else:
        raise ValueError(f"unknown recompute policy {policy!r} (expected "
                         f"one of {POLICIES} or a callable)")

    def fn(ctx, op, *args, **kwargs):
        got = keep(op, *args, **kwargs)
        if isinstance(got, CheckpointPolicy):
            return got
        return CheckpointPolicy.MUST_SAVE if got \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return fn


def recompute(function, *args, layer=None, use_reentrant=True, policy=None,
              **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward under ``policy`` (see the module's docstring). ``layer`` and
    ``use_reentrant`` are accepted for the reference's signature: torch's
    autograd finds the parameters itself, and the checkpoint is always the
    non-reentrant one, which selective policies need.

    torch's default generators are saved and replayed by the checkpoint,
    except while a CUDA graph captures the step: their state cannot be read
    then, so under capture a recomputed ``function`` must draw no random
    numbers from them (a ``GPTBlock`` draws its dropout masks from a
    counter-based hash instead). Under ``amp.auto_cast`` the recomputation
    casts as the forward did."""
    fn = recompute_policy_fn(policy)
    amp = _amp_snapshot()
    if amp is not None:
        # the recomputation runs in the backward, outside the forward's
        # auto_cast: it casts as the forward did
        inner = function

        def function(*a, **k):
            with _amp_restored(amp):
                return inner(*a, **k)
    capturing = torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()
    opts = dict(use_reentrant=False, preserve_rng_state=not capturing)
    if fn is not None:
        opts["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, fn)
    return checkpoint(function, *args, **opts, **kwargs)
