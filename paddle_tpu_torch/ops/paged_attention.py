"""Paged-KV attention: the CUDA kernel's wrapper, its plain PyTorch version,
and the per-engine kernel choice (counterpart of the paged section of
``paddle_tpu/ops/pallas_ops.py``).

The serving engine keeps every slot's K/V in one fixed-shape pool per layer,
``[num_blocks, block_size, H, Dh]``, addressed through per-slot int32 block
tables ``[B, M]``. Key position ``j`` is valid for span row ``t`` of slot
``b`` iff ``j <= q_offsets[b] + t`` and ``j < seq_lens[b]``; inactive lanes
(zeroed table row, seq_len 1, cursor 0) read the reserved garbage block 0
and produce finite garbage the host discards.

* :func:`paged_attention` is the kernel's wrapper. On CUDA tensors it
  launches ``csrc/paged_attention.cu`` or raises; on CPU tensors, and only
  there, it computes the plain version.
* :func:`paged_attention_ref` is the plain version: it materializes each
  slot's gathered ``[M * bs]`` view and runs masked attention over it
  (the reference's gather oracle ``paged_attention_xla``).
* :func:`paged_attention_split_ref` is the plain version of the kernel's
  split-KV arithmetic (partials over chunks of keys, merged in chunk
  order), for the tests; :func:`split_keys` is the kernel's own chunk.
* :func:`paged_attention_route` is the read the model calls: the kernel
  or its plain version, as the engine chose, and the site of the
  ``kernel_mismatch`` fault point. The two functions above, which parity
  checks use as the oracle, never perturb.
* :func:`select_paged_kernel` resolves the kernel once per engine, per
  shard on a tensor-parallel serving mesh (:func:`paged_sharded`).

Launch counts live in the ``kernels`` registry scope:
``paged_attention`` counts kernel launches, ``paged_attention_ref`` calls
of the plain version. The count is bumped in Python, so under CUDA-graph
capture it runs once and launches nothing; the serving engine's
``StepGraph`` takes what a capture added back out and adds it at each
replay. The kernel also counts its own launches on the card, per instance
(:func:`device_launches`), replays of a graph included: that count is
measured, the one in Python is derived. The wrapper is capturable: it reads nothing back to the host, its
output and the split-KV workspace come from ``torch.empty`` (the graph's
private pool under capture), and it launches on the current stream. The
library load and the workspace size (``_workspace_floats``) run at the
first call, so a graph's warm-up does them before capture.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..framework import static_leaf
from ..profiler import explainer as _explain
from ..profiler import registry as _registry
from ..testing import faults as _faults
from . import _build
from .attention import attention

# per-dtype (atol, rtol) between the kernel and the plain version: float32
# differs only by reduction order; bf16 also by where probabilities round
# (the plain version casts them to bf16 before the PV product, the kernel
# keeps them in fp32). The reference pins the same bounds for its kernel.
PAGED_PARITY_TOL = {torch.float32: (3e-5, 3e-5),
                    torch.bfloat16: (0.05, 0.05)}
# per-dtype bound on paged_rel_err(kernel, plain version computed in
# float32 on the same values), held beside PAGED_PARITY_TOL. The bf16
# elementwise bound is as large as a typical output (a softmax average of
# ~1000 random rows is ~0.03), so it cannot see a fault that moves every
# output by less. Against float32 arithmetic the kernel's only rounding is
# its bf16 output, at most bf16's unit roundoff 2**-8 = 3.9e-3 in norm; one
# key left out of a 2048-row slot moves a head's output by ~2e-2.
PAGED_PARITY_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}

# span rows the kernel takes: 1 for decode, up to 8 for a verify span
MAX_SPAN = 8
HEAD_DIMS = (64, 128)

_counters = _registry.scoped_counters(
    "kernels", {"paged_attention": 0, "paged_attention_ref": 0})
_serving_counters = _registry.scoped_counters(
    "serving", {"kernel.cuda": 0, "kernel.torch": 0})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def paged_view(pool, block_tables):
    """Each slot's logical ``[B, M * bs, H, Dh]`` view of ``pool``."""
    Nb, bs = pool.shape[0], pool.shape[1]
    B, M = block_tables.shape
    rows = (block_tables.long() * bs).unsqueeze(-1) + torch.arange(
        bs, device=pool.device)
    flat = pool.reshape(Nb * bs, *pool.shape[2:])
    return flat.index_select(0, rows.reshape(-1)).reshape(
        B, M * bs, *pool.shape[2:])


def position_mask(q_offsets, seq_lens, T, S):
    """``[B, 1, T, S]`` keep-mask: key ``j`` for row ``t`` iff
    ``j <= q_offsets + t`` and ``j < seq_lens``."""
    dev = q_offsets.device
    jpos = torch.arange(S, device=dev)
    qrow = q_offsets.long().unsqueeze(1) + torch.arange(T, device=dev)
    mask = ((jpos.view(1, 1, S) <= qrow.unsqueeze(-1))
            & (jpos.view(1, 1, S) < seq_lens.long().view(-1, 1, 1)))
    return mask.unsqueeze(1)


def paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens, q_offsets,
                        scale=None):
    """The plain version: gather each slot's view, then masked attention.
    ``q [B, T, H, Dh]`` -> ``[B, T, H, Dh]``. Any device."""
    _counters["paged_attention_ref"] += 1
    T, Dh = q.shape[1], q.shape[-1]
    scale = float(scale) if scale is not None else Dh ** -0.5
    k_view = paged_view(k_pool, block_tables)
    v_view = paged_view(v_pool, block_tables)
    mask = position_mask(q_offsets, seq_lens, T, k_view.shape[1])
    return attention(q, k_view, v_view, mask=mask, scale=scale)


def paged_rel_err(got, want):
    """``max ||got - want|| / ||want||`` over each (slot, head)'s ``[T, Dh]``
    output of two ``[B, T, H, Dh]`` tensors, in float32; 0 where the two
    are equal, NaN where ``got`` is not finite."""
    num = (got.float() - want.float()).pow(2).sum((1, 3))
    den = want.float().pow(2).sum((1, 3))
    ratio = torch.where(num == 0, torch.zeros_like(num), num / den)
    return float(ratio.max().sqrt())


def paged_attention_split_ref(q, k_pool, v_pool, block_tables, seq_lens,
                              q_offsets, chunk, scale=None):
    """The kernel's split-KV arithmetic in plain PyTorch, float32: for each
    chunk of ``chunk`` logical key positions a partial ``(m, l, acc)`` per
    (slot, head, row), ``m = -inf`` and ``l = 0`` where no key of the chunk
    serves the row; then the partials merged in chunk order, skipping
    ``m = -inf``, ``l`` floored at 1e-30. ``q [B, T, H, Dh]`` ->
    ``[B, T, H, Dh]`` in q's dtype. For tests; any device."""
    B, T, H, Dh = q.shape
    scale = float(scale) if scale is not None else Dh ** -0.5
    k_view = paged_view(k_pool, block_tables).float()
    v_view = paged_view(v_pool, block_tables).float()
    S = k_view.shape[1]
    n = -(-S // chunk)  # from shapes alone, as in the kernel
    s = torch.einsum("bthd,bjhd->bhtj", q.float() * scale, k_view)
    keep = position_mask(q_offsets, seq_lens, T, S)       # [B, 1, T, S]
    s = s.masked_fill(~keep, float("-inf"))
    ninf = torch.tensor(float("-inf"), device=q.device)
    parts = []
    for c in range(n):
        sc = s[..., c * chunk:(c + 1) * chunk]
        m = sc.amax(-1)                                   # [B, H, T]
        live = m != ninf
        p = torch.exp(sc - torch.where(live, m, 0.0).unsqueeze(-1))
        acc = torch.einsum("bhtj,bjhd->bhtd", p,
                           v_view[:, c * chunk:(c + 1) * chunk])
        parts.append((m, p.sum(-1), acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    den = torch.zeros_like(mx)
    num = torch.zeros(B, H, T, Dh, device=q.device)
    for m, l, acc in parts:  # in chunk order
        live = m != ninf
        w = torch.where(live, torch.exp(torch.where(live, m - mx, 0.0)), 0.0)
        den = den + w * l
        num = num + w.unsqueeze(-1) * acc
    out = num / den.clamp_min(1e-30).unsqueeze(-1)
    return out.transpose(1, 2).to(q.dtype)


def check_paged_args(q, k_pool, v_pool, block_tables, seq_lens, q_offsets):
    """Raise ``ValueError`` unless the kernel takes these arguments."""
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"paged_attention: q must be [B, T, H, Dh] and the "
                         f"pools [Nb, bs, H, Dh]; got {tuple(q.shape)} and "
                         f"{tuple(k_pool.shape)}")
    B, T, H, Dh = q.shape
    if k_pool.shape != v_pool.shape or tuple(k_pool.shape[2:]) != (H, Dh):
        raise ValueError(f"paged_attention: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q heads "
                         f"{(H, Dh)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"paged_attention: block_tables must be [{B}, M], "
                         f"got {tuple(block_tables.shape)}")
    for name, t in (("seq_lens", seq_lens), ("q_offsets", q_offsets)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"paged_attention: {name} must be [{B}], got "
                             f"{tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"paged_attention: dtype {q.dtype} not in "
                         "(float32, bfloat16)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_attention: pool dtype {k_pool.dtype} != q "
                         f"dtype {q.dtype}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {Dh} not in {HEAD_DIMS}")
    if not 1 <= T <= MAX_SPAN:
        raise ValueError(f"paged_attention: span of {T} rows (the kernel "
                         f"takes 1..{MAX_SPAN})")
    for name, t in (("block_tables", block_tables), ("seq_lens", seq_lens),
                    ("q_offsets", q_offsets)):
        if t.dtype != torch.int32:
            raise ValueError(f"paged_attention: {name} must be int32, got "
                             f"{t.dtype}")
    dev = q.device
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("seq_lens", seq_lens),
                    ("q_offsets", q_offsets)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} is on {t.device}, "
                             f"q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             "aligned")


def _lib():
    lib = _build.load("paged_attention")
    if lib.paged_attention_forward.argtypes is None:
        lib.paged_attention_forward.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
        lib.paged_attention_forward.restype = ctypes.c_int
        lib.paged_attention_workspace_floats.argtypes = [ctypes.c_int] * 6
        lib.paged_attention_workspace_floats.restype = ctypes.c_int64
        lib.paged_attention_split_keys.restype = ctypes.c_int
        lib.paged_attention_tally_index.argtypes = [ctypes.c_int] * 3
        lib.paged_attention_launch_tally.argtypes = [ctypes.c_void_p]
    return lib


def split_keys():
    """Keys of one split of the kernel (its chunk C): builds and loads the
    kernel's library, so CUDA machines only."""
    return _lib().paged_attention_split_keys()


@functools.lru_cache(maxsize=None)
def _workspace_floats(B, T, H, Dh, M, bs):
    """float32 values of the kernel's split-KV workspace, from the kernel's
    library (which alone knows the chunk and the layout)."""
    return _lib().paged_attention_workspace_floats(B, T, H, Dh, M, bs)


def _paged_meta(q, *args, **kwargs):
    return torch.empty_like(q)


@static_leaf(_paged_meta)
def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, q_offsets,
                    scale=None):
    """Paged attention through the CUDA kernel.

    ``q [B, T, H, Dh]`` over pools ``[Nb, bs, H, Dh]`` addressed by
    ``block_tables [B, M]``; ``seq_lens [B]`` counts each slot's valid rows
    including the span's own, ``q_offsets [B]`` is the position of span row
    0. On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel on the current stream, and raises on any argument the kernel
    does not take or any launch error. The kernel's split-KV workspace
    (float32, a size fixed by the shapes) comes from ``torch.empty`` on the
    current stream; nothing is read back to the host. A static Program
    records a call as one call (``framework.static_leaf``)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens,
                                   q_offsets, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    check_paged_args(q, k_pool, v_pool, block_tables, seq_lens, q_offsets)
    B, T, H, Dh = q.shape
    scale = float(scale) if scale is not None else Dh ** -0.5
    out = torch.empty_like(q)
    M, bs = block_tables.shape[1], k_pool.shape[1]
    ws = torch.empty(_workspace_floats(B, T, H, Dh, M, bs),
                     dtype=torch.float32, device=q.device)
    fn = _lib().paged_attention_forward
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), seq_lens.data_ptr(),
                 q_offsets.data_ptr(), out.data_ptr(), ws.data_ptr(), B, T,
                 H, Dh, bs, M, int(k_pool.shape[0]), _DTYPE_CODE[q.dtype],
                 scale, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    _counters["paged_attention"] += 1
    return out


def paged_attention_route(kernel, q, k_pool, v_pool, block_tables, seq_lens,
                          q_offsets, scale=None):
    """The decode and verify attention read of the model: ``kernel`` "cuda"
    launches the kernel (:func:`paged_attention`, on a contiguous copy of
    ``q`` where it is a view), "torch" computes its plain version.

    The ``kernel_mismatch`` fault point fires here where the route is
    traced, as the reference fires it when it traces its kernel: at a CUDA
    graph's capture on the card (warm-up and eager calls are not traces),
    and at every call on the CPU, where nothing is captured. When it fires
    one output element gets +1, and a graph captured then replays the
    perturbation."""
    if kernel == "cuda":
        out = paged_attention(q.contiguous(), k_pool, v_pool, block_tables,
                              seq_lens, q_offsets, scale=scale)
    elif kernel == "torch":
        out = paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens,
                                  q_offsets, scale=scale)
    else:
        raise ValueError(f"paged_attention_route: unknown kernel {kernel!r} "
                         "(expected cuda | torch)")
    if _faults.ACTIVE and (q.device.type != "cuda"
                           or torch.cuda.is_current_stream_capturing()) \
            and _faults.fire("kernel_mismatch"):
        out[(0,) * out.dim()] += 1
    return out


def _tally_call(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"paged_attention launch tally: cudaError {err}")


def reset_device_launches():
    """Zero the kernel's launch tally on the card (after the card has
    finished what was queued). CUDA machines only."""
    _tally_call(_lib().paged_attention_reset_tally)


def device_launches():
    """Launches of the kernel's split pass since
    :func:`reset_device_launches`, as the card counted them:
    ``{(dtype name, Dh, rows of the instance): n}`` for each instance with
    a launch; a span of 2 to 8 rows takes the 8-row instance. The first
    thread of each launch counts it on the card, so replays of a CUDA graph
    count too. Waits for the card; CUDA machines only."""
    lib = _lib()
    buf = (ctypes.c_ulonglong * lib.paged_attention_tally_slots())()
    _tally_call(lib.paged_attention_launch_tally, buf)
    out = {}
    for dtype, code in _DTYPE_CODE.items():
        for dh in HEAD_DIMS:
            for rows in (1, MAX_SPAN):
                n = buf[lib.paged_attention_tally_index(code, dh, rows)]
                if n:
                    out[(str(dtype).removeprefix("torch."), dh, rows)] = n
    return out


def launches():
    """``{"paged_attention": kernel launches, "paged_attention_ref": plain
    calls}`` since the last ``registry.reset("kernels")``."""
    return {k: _counters[k] for k in ("paged_attention",
                                      "paged_attention_ref")}


def _mesh_mp_degree(mesh):
    """Size of a mesh's ``"mp"`` axis (1 when absent or ``mesh`` is None):
    a ``distributed.spmd.ServingMesh``, a torch ``DeviceMesh``, a hybrid
    group or an ``{axis: degree}`` dict."""
    if mesh is None:
        return 1
    if hasattr(mesh, "get_model_parallel_world_size"):
        return int(mesh.get_model_parallel_world_size())
    axes = mesh if isinstance(mesh, dict) else dict(
        zip(mesh.mesh_dim_names, mesh.shape))
    return int(axes.get("mp", 1))


def paged_sharded(mesh, num_heads):
    """Whether a model of ``num_heads`` heads serves head-sharded on
    ``mesh``: its ``"mp"`` axis has more than one rank and divides the
    heads."""
    mp = _mesh_mp_degree(mesh)
    return mp > 1 and num_heads is not None and num_heads % mp == 0


def select_paged_kernel(requested=None, *, device, head_dim, dtype,
                        mesh=None, num_heads=None,
                        family="paged_attention"):
    """Resolve the decode attention path for one engine build.

    ``requested``: None/"auto", "cuda" or "torch". Auto resolves to "cuda"
    on a CUDA device and to "torch" (the plain version) on the CPU. "torch"
    is honoured anywhere; "cuda" on the CPU, or a head_dim/dtype the kernel
    does not take on CUDA, raises ``ValueError`` naming the reason — the
    choice is never demoted quietly. Returns ``(kind, reason)`` and bumps
    ``serving.kernel.<kind>``.

    A ``mesh`` whose ``"mp"`` axis has more than one rank resolves per
    shard. The kernel computes every head on its own (one grid row per
    head, a split chunk that does not depend on the head count), so where
    ``num_heads`` divides mp each rank runs the same kernel kind over its
    ``num_heads / mp`` heads and its output is the single-card kernel's on
    those heads, bit for bit. Where it does not, the engine keeps the
    model and the pools whole on every rank, each rank runs the
    single-card step over all heads, and a ``kernel_fallback`` explainer
    event (``family``) names both numbers; the kind stays."""
    req = (requested or "auto").strip().lower()
    if req not in ("auto", "cuda", "torch"):
        raise ValueError(f"paged_kernel = {requested!r} (expected auto | "
                         "cuda | torch)")
    dev = torch.device(device)
    if req == "torch":
        kind, reason = "torch", "requested"
    elif dev.type != "cuda":
        if req == "cuda":
            raise ValueError(f"paged_kernel='cuda' needs a CUDA device, the "
                             f"engine runs on {dev}")
        kind, reason = "torch", f"auto: device is {dev.type}"
    else:
        if head_dim not in HEAD_DIMS:
            raise ValueError(f"paged_kernel: the CUDA kernel takes head_dim "
                             f"in {HEAD_DIMS}, the model has {head_dim}; "
                             "ask for paged_kernel='torch' explicitly")
        if dtype not in _DTYPE_CODE:
            raise ValueError(f"paged_kernel: the CUDA kernel takes float32 "
                             f"or bfloat16, the model is {dtype}; ask for "
                             "paged_kernel='torch' explicitly")
        kind, reason = "cuda", f"{req}: cuda device"
    mp = _mesh_mp_degree(mesh)
    if mp > 1 and paged_sharded(mesh, num_heads):
        reason += (f"; per-shard over mesh mp={mp} "
                   f"(local heads {num_heads // mp})")
    elif mp > 1:
        why = (f"model has {num_heads} heads, not divisible by mesh axis "
               f"mp={mp}: no per-shard kernel; the model and its pools stay "
               "whole on every rank, each running the single-card step"
               if num_heads is not None else
               f"mesh-sharded decode (mp={mp}) needs num_heads to plan the "
               "per-shard kernel; the model and its pools stay whole on "
               "every rank")
        reason += f"; {why}"
        _explain.record("kernel_fallback", op=family, why=why,
                        num_heads=num_heads, mp=mp)
    _serving_counters[f"kernel.{kind}"] += 1
    return kind, reason
