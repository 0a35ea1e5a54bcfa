"""Flash attention: the CUDA kernels' wrappers, their plain PyTorch versions,
the autograd Function that joins them, and the dispatcher (counterpart of
the flash section of ``paddle_tpu/ops/pallas_ops.py``).

Layout ``[B, T, N, H]`` (batch, sequence, heads, head_dim) throughout, as in
the reference's public ``flash_attention``; ``lse`` and ``delta`` are
float32 ``[B, N, T]``. The reference's kernels see the same data flattened
to ``[B * N, T, H]``.

* :func:`flash_fwd` (K1), :func:`flash_bwd_dq` (K2) and
  :func:`flash_bwd_dkv` (K3) are the kernels' wrappers. On CUDA tensors
  each launches ``csrc/flash_attention.cu`` or raises; on CPU tensors, and
  only there, it computes its plain version.
* :func:`flash_fwd_ref`, :func:`flash_bwd_dq_ref` and
  :func:`flash_bwd_dkv_ref` are the plain versions, written from the
  kernels' formulas in float32.
* :func:`attention_op` (``torch.ops.paddle_tpu_torch.flash_attention``)
  is attention as one operator returning ``(out, lse)``, with its autograd:
  K1 forward and K2 + K3 backward (the kernel route), or plain attention,
  the reference's XLA path (the plain route). A recompute policy sees it
  as one op and can keep its outputs. :class:`FlashAttentionFunction` is
  its kernel route, :func:`flash_attention_ref` its plain route.
* :func:`flash_attention` applies the reference's eligibility rule and
  routes an eligible call on the "cuda" route to the kernels; everything
  else takes the plain route.
* :func:`select_flash_kernel` resolves a model's route once.

Launch counts live in the ``kernels`` registry scope: ``flash_fwd``,
``flash_bwd_dq`` and ``flash_bwd_dkv`` count kernel launches (a call made
while a CUDA graph captures counts nothing; the card's tally,
:func:`device_launches`, counts every launch, replays too), the ``_ref``
names calls of the plain versions, and ``flash_attention_ref`` forwards of
the plain attention route. A call the "cuda" route cannot take records
its reason as a ``kernel_fallback`` event in the explainer ring.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..profiler import explainer as _explain
from ..profiler import registry as _registry
from . import _build
from .attention import attention, attention_logits

HEAD_DIMS = (64, 96, 128, 256)
SEQ_MULTIPLE = 128

# per-dtype (atol, rtol) between each kernel and its plain version on the
# same inputs. float32: the kernels multiply in exact float32 and differ
# only in summation order over up to 2048 keys. bf16: the kernels round the
# probabilities P and the score gradients dS to bf16 before the tensor-core
# products (the plain versions keep them in float32), on top of rounding
# every output to bf16 (a relative step of 2**-8).
FLASH_PARITY_TOL = {torch.float32: (1e-4, 1e-4),
                    torch.bfloat16: (2e-2, 2e-2)}
# per-dtype bound on flash_rel_err, held beside FLASH_PARITY_TOL. The
# absolute bound is loose where outputs are small (at T = 2048 a typical
# |out| is 0.02-0.07, against 2e-2); this one scales with the plain
# version's values block by block. bf16: rounding P or dS (relative 2**-9 per term,
# random in sign) and the output moves a block by about 2e-3 of its norm,
# while dropping one tile of 64 keys from a row that sees 2048 moves it by
# about sqrt(64 / 2048) = 18%. float32: summation order only.
FLASH_PARITY_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
REL_BLOCK = 128


def flash_rel_err(got, want):
    """``max ||got - want|| / ||want||`` over blocks of ``REL_BLOCK`` rows
    of one (batch, head) of two ``[B, T, N, H]`` tensors (``T`` a multiple
    of ``REL_BLOCK``), in float32. 0 where both blocks are 0."""
    B, T, N, H = want.shape
    d = (got.float() - want.float()).reshape(B, T // REL_BLOCK, REL_BLOCK,
                                            N, H)
    w = want.float().reshape(B, T // REL_BLOCK, REL_BLOCK, N, H)
    num = d.pow(2).sum((2, 4))
    den = w.pow(2).sum((2, 4))
    ratio = torch.where(num == 0, torch.zeros_like(num), num / den)
    return float(ratio.max().sqrt())


_counters = _registry.scoped_counters("kernels", {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "flash_fwd_ref": 0, "flash_bwd_dq_ref": 0, "flash_bwd_dkv_ref": 0,
    "flash_attention_ref": 0})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(scale, H):
    return float(scale) if scale is not None else H ** -0.5


def _causal_keep(T, S, device):
    return torch.ones(T, S, dtype=torch.bool, device=device).tril()


# ---------------------------------------------------------- plain versions --
def flash_fwd_ref(q, k, v, causal=False, scale=None):
    """K1's plain version: ``(out [B, T, N, H] in q's dtype, lse [B, N, T]
    float32)``. As the kernel: q is scaled before the product, masked
    scores are -inf, ``l`` is floored at 1e-30."""
    _counters["flash_fwd_ref"] += 1
    T, H = q.shape[1], q.shape[-1]
    s = torch.einsum("btnh,bsnh->bnts", q.float() * _scale(scale, H),
                     k.float())
    if causal:
        s = s.masked_fill(~_causal_keep(T, k.shape[1], q.device),
                          float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bnts,bsnh->btnh", p, v.float()) / l.transpose(1, 2)
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, delta, causal, scale):
    """``p = exp(scale * q k^T - lse)`` (0 where masked) and
    ``ds = p * (do v^T - delta)``, both float32 ``[B, N, T, S]``."""
    T = q.shape[1]
    s = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(T, k.shape[1], q.device),
                          float("-inf"))
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.einsum("btnh,bsnh->bnts", do.float(), v.float())
    return p, p * (dp - delta.unsqueeze(-1))


def flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=False, scale=None):
    """K2's plain version: ``dq = scale * (p * (do v^T - delta)) k``."""
    _counters["flash_bwd_dq_ref"] += 1
    scale = _scale(scale, q.shape[-1])
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bnts,bsnh->btnh", ds, k.float()) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal=False, scale=None):
    """K3's plain version: ``(dk, dv) = (scale * ds^T q, p^T do)``."""
    _counters["flash_bwd_dkv_ref"] += 1
    scale = _scale(scale, q.shape[-1])
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    dk = torch.einsum("bnts,btnh->bsnh", ds, q.float()) * scale
    dv = torch.einsum("bnts,btnh->bsnh", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_ref(q, k, v, mask=None, causal=False, scale=None):
    """Plain attention, :func:`~.attention.attention` (the reference's
    ``_attention_xla``): the path every call takes that the kernels do
    not. It is :func:`attention_op`'s plain route, so a recompute policy
    sees it as one op."""
    return attention_op(q, k, v, mask, bool(causal),
                        _scale(scale, q.shape[-1]), False)[0]


# ---------------------------------------------------------------- kernels --
def _check_operand(name, t, like):
    if t.dim() != 4 or tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"flash_attention: {name} must be [B, T, N, H] = "
                         f"{tuple(like.shape)}, got {tuple(t.shape)}")
    if t.dtype != like.dtype:
        raise ValueError(f"flash_attention: {name} dtype {t.dtype} != q "
                         f"dtype {like.dtype}")
    if t.device != like.device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, q on "
                         f"{like.device}")
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name}'s head dimension is not "
                         "contiguous")
    es = t.element_size()
    if t.data_ptr() % 16 or any(t.stride(d) * es % 16 for d in range(3)):
        raise ValueError(f"flash_attention: {name} is not 16-byte aligned "
                         f"(pointer or strides {t.stride()})")


def check_flash_args(q, *others, rows=()):
    """Raise ``ValueError`` unless the kernels take these arguments: q and
    ``others`` (k, v[, do]) ``[B, T, N, H]`` of one dtype and CUDA device
    with a contiguous, 16-byte aligned head dimension; ``rows`` (lse,
    delta) contiguous float32 ``[B, N, T]``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: the CUDA kernels take CUDA "
                         f"tensors, q is on {q.device}")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B, T, N, H], got "
                         f"{tuple(q.shape)}")
    B, T, N, H = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         "(float32, bfloat16)")
    if H not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {H} not in {HEAD_DIMS}")
    if T % SEQ_MULTIPLE:
        raise ValueError(f"flash_attention: seq_len {T} is not a multiple of "
                         f"{SEQ_MULTIPLE}")
    for name, t in zip(("q", "k", "v", "do"), (q, *others)):
        _check_operand(name, t, q)
    for name, t in zip(("lse", "delta"), rows):
        if (tuple(t.shape) != (B, N, T) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"float32 [{B}, {N}, {T}] on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 6 + tail
        lib.flash_attention_bwd_dq.argtypes = [ctypes.c_void_p] * 8 + tail
        lib.flash_attention_bwd_dkv.argtypes = [ctypes.c_void_p] * 9 + tail
        for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd_dq,
                   lib.flash_attention_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.flash_attention_launch_tally.argtypes = [ctypes.c_void_p]
        lib.flash_attention_reset_tally.argtypes = []
        lib.flash_attention_tally_slots.argtypes = []
    return lib


def _launch(fn, name, q, ptrs, operands, causal, scale):
    B, T, N, H = q.shape
    strides = (ctypes.c_longlong * (3 * len(operands)))(
        *[t.stride(d) for t in operands for d in range(3)])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, ctypes.addressof(strides), B, N, T, H,
                 _DTYPE_CODE[q.dtype], scale, int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    if not torch.cuda.is_current_stream_capturing():
        # a capture records the launch; its replays are counted on the card
        _counters[name] += 1


def flash_fwd(q, k, v, causal=False, scale=None):
    """K1: ``(out, lse)`` through the CUDA kernel on CUDA tensors (raising
    on anything it does not take); the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal, scale)
    check_flash_args(q, k, v)
    B, T, N, H = q.shape
    out = torch.empty(B, T, N, H, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, N, T, dtype=torch.float32, device=q.device)
    _launch(_lib().flash_attention_fwd, "flash_fwd", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr()), (q, k, v), causal, _scale(scale, H))
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False, scale=None):
    """K2: ``dq`` through the CUDA kernel on CUDA tensors; the plain version
    on CPU tensors."""
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale)
    check_flash_args(q, k, v, do, rows=(lse, delta))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(_lib().flash_attention_bwd_dq, "flash_bwd_dq", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            (q, k, v, do), causal, _scale(scale, q.shape[-1]))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, scale=None):
    """K3: ``(dk, dv)`` through the CUDA kernel on CUDA tensors; the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale)
    check_flash_args(q, k, v, do, rows=(lse, delta))
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(_lib().flash_attention_bwd_dkv, "flash_bwd_dkv", q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            (q, k, v, do), causal, _scale(scale, q.shape[-1]))
    return dk, dv


def flash_delta(out, do):
    """``delta = rowsum(do * out)`` as float32 ``[B, N, T]``, from the
    output in its own dtype (the reference rounds it first, too)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _kernel_operand(t):
    """``t``, or a contiguous copy when its layout is one the kernels do not
    take (a gradient handed in by autograd may be any view)."""
    es = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any(t.stride(d) * es % 16 for d in range(3))):
        return t
    return t.contiguous()


@torch.library.custom_op("paddle_tpu_torch::flash_attention",
                         mutates_args=())
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], causal: bool, scale: float,
                 kernel: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention as one operator: ``(out, lse)``, ``lse`` the float32
    log-sum-exp of each row's scores ``[B, N, T]``.

    ``kernel=True`` is K1 (its wrapper: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors; ``mask`` must be None), and its autograd
    runs K2 + K3 from the saved ``(q, k, v, out, lse)``. ``kernel=False``
    is the plain route, counted as ``flash_attention_ref``:
    :func:`~.attention.attention`'s math (float32 scores, the
    probabilities rounded to q's dtype before the product with v, as the
    reference's ``_attention_xla``), any mask or key length; the op keeps
    no probabilities, so its backward runs that math again under torch
    autograd and returns autograd's gradients of it (the mask takes none).
    Being one operator, it is what a recompute policy sees and can keep
    (``distributed.fleet.utils.recompute``'s ``"attn"``, the reference's
    ``attn_out`` name on both of its routes): a kept output is never
    recomputed, so K1 is not launched again."""
    if kernel:
        return flash_fwd(q, k, v, causal, scale)
    _counters["flash_attention_ref"] += 1
    logits = attention_logits(q, k, mask, causal, scale)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return (torch.einsum("bnqk,bknh->bqnh", probs, v),
            torch.logsumexp(logits, dim=-1))


def _attention_setup(ctx, inputs, output):
    q, k, v, mask, causal, scale, kernel = inputs
    out, lse = output
    if kernel:
        ctx.save_for_backward(q, k, v, out, lse)
    else:
        ctx.save_for_backward(q, k, v, mask)
    ctx.causal, ctx.scale, ctx.kernel = causal, scale, kernel
    ctx.mark_non_differentiable(lse)


def _attention_backward(ctx, dout, _dlse):
    if not ctx.kernel:
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention(*ins, mask=mask, causal=ctx.causal,
                            scale=ctx.scale)
        return (*torch.autograd.grad(out, ins, dout), None, None, None,
                None)
    q, k, v, out, lse = ctx.saved_tensors
    dout = _kernel_operand(dout)
    delta = flash_delta(out, dout)
    args = (q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
    dq = flash_bwd_dq(*args)
    dk, dv = flash_bwd_dkv(*args)
    return dq, dk, dv, None, None, None, None


attention_op.register_autograd(_attention_backward,
                               setup_context=_attention_setup)


class FlashAttentionFunction:
    """Attention through K1 forward and K2 + K3 backward (the reference's
    ``custom_vjp`` ``_flash_flat``): the kernel route of
    :func:`attention_op`, returning the output."""

    @staticmethod
    def apply(q, k, v, causal, scale):
        return attention_op(q, k, v, None, bool(causal), float(scale),
                            True)[0]


# ------------------------------------------------------------- dispatcher --
def flash_ineligible(q, k, mask=None):
    """The reason the kernels cannot take this call, or None: the
    reference's rule (``pallas_ops.flash_attention``)."""
    B, T, N, H = q.shape
    if mask is not None:
        return "explicit attn_mask (flash kernel is mask-free)"
    if k.shape[1] != T:
        return f"cross-length kv (T={T}, S={k.shape[1]})"
    if T % SEQ_MULTIPLE:
        return f"seq_len {T} not a multiple of {SEQ_MULTIPLE}"
    if H not in HEAD_DIMS:
        return f"head_dim {H} not in {HEAD_DIMS}"
    if q.dtype not in _DTYPE_CODE:
        return f"dtype {q.dtype} not in (float32, bfloat16)"
    return None


def flash_attention(q, k, v, mask=None, causal=False, scale=None,
                    kernel=None):
    """``[B, T, N, H]`` attention.

    ``kernel``: "cuda", "torch" or None (auto: "cuda" for CUDA tensors,
    "torch" for CPU tensors). On the "cuda" route an eligible call runs
    :func:`attention_op` on the kernels, which launch or raise; an
    ineligible one takes the plain path and records why. "cuda" with CPU
    tensors raises. The plain path is :func:`flash_attention_ref`, the
    op's plain route (so a recompute policy sees it too)."""
    route = kernel or ("cuda" if q.device.type == "cuda" else "torch")
    if route not in ("cuda", "torch"):
        raise ValueError(f"flash_attention: kernel={kernel!r} (expected "
                         "cuda | torch | None)")
    scale = _scale(scale, q.shape[-1])
    if route == "cuda":
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention: kernel='cuda' needs CUDA "
                             f"tensors, q is on {q.device}")
        why = flash_ineligible(q, k, mask)
        if why is None:
            return attention_op(q, k, v, None, bool(causal), scale, True)[0]
        _explain.record("kernel_fallback", op="flash_attention", why=why,
                        shape=str(tuple(q.shape)))
    return flash_attention_ref(q, k, v, mask=mask, causal=causal,
                               scale=scale)


def select_flash_kernel(requested=None, *, device, head_dim, dtype):
    """Resolve a model's attention route once: "cuda" or "torch".

    ``requested``: None/"auto", "cuda" or "torch". Auto resolves to "cuda"
    on a CUDA device and "torch" on the CPU; "torch" is honoured anywhere.
    "cuda" on the CPU, or with a head_dim or dtype the kernels do not take,
    raises ``ValueError`` naming the reason: the choice is never demoted
    quietly. Per call, a shape the kernels cannot take (a sequence length
    off the multiple of 128) still takes the plain path and is recorded."""
    req = (requested or "auto").strip().lower()
    if req not in ("auto", "cuda", "torch"):
        raise ValueError(f"attn_kernel = {requested!r} (expected auto | "
                         "cuda | torch)")
    dev = torch.device(device)
    if req == "torch":
        return "torch"
    if dev.type != "cuda":
        if req == "cuda":
            raise ValueError(f"attn_kernel='cuda' needs a CUDA device, the "
                             f"model is on {dev}")
        return "torch"
    if req == "cuda":
        if head_dim not in HEAD_DIMS:
            raise ValueError(f"attn_kernel: the CUDA kernels take head_dim "
                             f"in {HEAD_DIMS}, the model has {head_dim}; "
                             "ask for attn_kernel='torch' explicitly")
        if dtype not in _DTYPE_CODE:
            raise ValueError(f"attn_kernel: the CUDA kernels take float32 "
                             f"or bfloat16, the model is {dtype}; ask for "
                             "attn_kernel='torch' explicitly")
    return "cuda"


def _tally_call(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"flash_attention launch tally: cudaError {err}")


def reset_device_launches():
    """Zero the kernels' launch tally on the card (after the card has
    finished what was queued). CUDA machines only."""
    _tally_call(_lib().flash_attention_reset_tally)


def device_launches():
    """Launches of K1, K2 and K3 since :func:`reset_device_launches`, as the
    card counted them: ``{"flash_fwd": n, "flash_bwd_dq": n,
    "flash_bwd_dkv": n}`` over both dtypes, and the same per dtype under
    ``"by_dtype"``. The first thread of each launch counts it on the card,
    so replays of a CUDA graph count too (the Python counters of
    :func:`launches` do not move under a replay). Waits for the card; CUDA
    machines only."""
    lib = _lib()
    buf = (ctypes.c_ulonglong * lib.flash_attention_tally_slots())()
    _tally_call(lib.flash_attention_launch_tally, buf)
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    out = {n: buf[2 * k] + buf[2 * k + 1] for k, n in enumerate(names)}
    out["by_dtype"] = {
        dt: {n: buf[2 * k + code] for k, n in enumerate(names)}
        for dt, code in (("float32", 0), ("bfloat16", 1))}
    return out


def launches():
    """The ``kernels`` counters of this module since the last
    ``registry.reset("kernels")``."""
    return {k: _counters[k] for k in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_ref",
        "flash_bwd_dq_ref", "flash_bwd_dkv_ref", "flash_attention_ref")}
