"""auto_cast / decorate (counterpart of paddle_tpu/amp/auto_cast.py).

The reference casts at its op dispatcher: while ``auto_cast`` is active,
``dispatch.forward`` asks ``_cast_hook(op_name, arrays)`` for a dtype plan
(one target dtype or None per input) and casts before running the op. The
port applies the same plan from a ``torch.overrides.TorchFunctionMode``:
every torch call made inside the context reaches :class:`_AmpMode`, which
names it with the reference's op name (``F.linear`` is ``linear``,
``Tensor.__matmul__`` is ``matmul``, ``torch.log_softmax`` is
``log_softmax``, ...), asks :func:`cast_plan` and casts the call's
floating-point tensor inputs. Casts are ordinary differentiable ops, so
float32 parameters get float32 gradients, and inside a CUDA graph capture
they are captured like any other op.

The reference's lists are the specification. ``torch.autocast`` is not
used: its op lists differ between CPU and CUDA, it takes no custom lists,
and it does not know the port's attention op. That op, and any other
function of the port that is not a torch call, asks the plan itself
(:func:`cast_inputs`): ``ops.flash_attention.flash_attention`` casts its
q, k, v (and a float mask) under the name ``flash_attention``, which is in
the white list as in the reference (``paddle_tpu/ops/nn_ops.py:1099``).

O1: white-list ops run in the low dtype, black-list ops take their
low-dtype inputs up to float32, every other op runs in its inputs' dtype.
O2: black-list ops take low (and float16) inputs up to float32, every other
op takes float inputs down to the low dtype. Under O2 a call that mutates
its input (``add_``, ``__setitem__``), reads a tensor's metadata
(attributes, ``size``, ``data_ptr``) or converts dtype or device explicitly
(``to``, ``float``, ``cpu``) is left as it is: casting its input would
mutate or describe a copy.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["WHITE_LIST", "BLACK_LIST", "amp_state", "auto_cast",
           "amp_guard", "decorate", "cast_plan", "cast_inputs"]

# the reference's op lists (paddle_tpu/amp/auto_cast.py:12-25): matmul-class
# ops run in low precision; numerically sensitive ops stay float32
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "flash_attention", "addmm",
}
BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "std",
    "var", "cos_sim", "softmax", "log_softmax", "cross_entropy",
    "softmax_with_cross_entropy", "layer_norm", "batch_norm", "group_norm",
    "instance_norm", "rms_norm", "norm", "p_norm", "logsumexp", "erf",
    "erfinv", "pow", "cumsum", "cumprod", "nll_loss", "kl_div",
    "binary_cross_entropy", "bce_with_logits", "mse_loss", "l1_loss",
    "smooth_l1_loss", "sigmoid_focal_loss", "global_norm",
}

_T = torch.Tensor
# torch callables -> the reference's op names, for every listed name that
# has a torch counterpart (softmax_with_cross_entropy, sigmoid_focal_loss
# and global_norm have none)
_OP_NAMES = {
    torch.matmul: "matmul", _T.matmul: "matmul", _T.__matmul__: "matmul",
    _T.__rmatmul__: "matmul",
    torch.mm: "mm", _T.mm: "mm", torch.bmm: "bmm", _T.bmm: "bmm",
    torch.mv: "mv", _T.mv: "mv", F.linear: "linear",
    F.conv1d: "conv1d", F.conv2d: "conv2d", F.conv3d: "conv3d",
    F.conv_transpose1d: "conv1d_transpose",
    F.conv_transpose2d: "conv2d_transpose",
    F.conv_transpose3d: "conv3d_transpose",
    torch.einsum: "einsum", F.scaled_dot_product_attention: "flash_attention",
    torch.addmm: "addmm", _T.addmm: "addmm",
    F.cosine_similarity: "cos_sim",
    torch.softmax: "softmax", F.softmax: "softmax", _T.softmax: "softmax",
    torch.log_softmax: "log_softmax", F.log_softmax: "log_softmax",
    _T.log_softmax: "log_softmax",
    F.cross_entropy: "cross_entropy", F.layer_norm: "layer_norm",
    torch.layer_norm: "layer_norm", F.batch_norm: "batch_norm",
    F.group_norm: "group_norm", F.instance_norm: "instance_norm",
    torch.norm: "norm", _T.norm: "norm", torch.linalg.norm: "norm",
    torch.linalg.vector_norm: "p_norm",
    torch.pow: "pow", _T.pow: "pow", _T.__pow__: "pow", _T.__rpow__: "pow",
    F.nll_loss: "nll_loss", F.kl_div: "kl_div",
    F.binary_cross_entropy: "binary_cross_entropy",
    F.binary_cross_entropy_with_logits: "bce_with_logits",
    F.mse_loss: "mse_loss", F.l1_loss: "l1_loss",
    F.smooth_l1_loss: "smooth_l1_loss",
}
for _name in ("exp", "square", "log", "log2", "log10", "log1p", "mean", "sum",
              "std", "var", "logsumexp", "erf", "erfinv", "cumsum",
              "cumprod"):
    _OP_NAMES[getattr(torch, _name)] = _name
    _OP_NAMES[getattr(_T, _name)] = _name
if hasattr(F, "rms_norm"):
    _OP_NAMES[F.rms_norm] = "rms_norm"

# other torch names whose reference op is named otherwise (custom lists name
# ops by the reference's names)
_ALIASES = {"__add__": "add", "__radd__": "add", "sub": "subtract",
            "__sub__": "subtract", "__rsub__": "subtract", "mul": "multiply",
            "__mul__": "multiply", "__rmul__": "multiply", "div": "divide",
            "__truediv__": "divide", "__rtruediv__": "divide"}
# calls O2 leaves alone: casting their input would mutate, describe or
# convert a copy instead of the tensor itself
_NO_CAST = {
    "__get__", "__set__", "__delete__", "__setitem__", "__iadd__",
    "__isub__", "__imul__", "__itruediv__", "__ifloordiv__", "__imod__",
    "__ipow__", "__iand__", "__ior__", "__ixor__", "__imatmul__",
    "size", "dim", "ndimension", "numel", "nelement", "stride", "data_ptr",
    "storage_offset", "element_size", "is_contiguous", "is_floating_point",
    "is_complex", "is_pinned", "get_device", "untyped_storage", "item",
    "tolist", "numpy", "__len__", "__bool__", "__int__", "__float__",
    "__index__", "__repr__", "__format__", "__hash__", "__reduce_ex__",
    "__deepcopy__", "__getstate__", "__setstate__", "__array__",
    "register_hook", "backward", "retain_grad", "pin_memory",
    "record_stream", "to", "type", "cpu", "cuda", "float", "double",
    "half", "bfloat16", "detach", "requires_grad_",
}

_LOW = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class _AmpState(threading.local):
    """Per thread, as torch keeps the function-mode stack that applies it:
    the flag and the mode always belong to the same thread, so a thread
    outside auto_cast casts nothing, in ``cast_inputs`` either."""

    def __init__(self):
        self.enabled = False
        self.level = "O1"
        self.dtype = torch.bfloat16
        self.white = WHITE_LIST
        self.black = BLACK_LIST


_state = _AmpState()


def amp_state():
    """The calling thread's auto_cast state."""
    return _state


def _is_float(t):
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def cast_plan(name, tensors):
    """The reference's ``_cast_hook``: a list with the dtype each of
    ``tensors`` is cast to (None: left as it is), or None when nothing is
    cast or auto_cast is off."""
    if not _state.enabled:
        return None
    low = _state.dtype

    def plan(target, pred):
        return [target if pred(t) else None for t in tensors]

    if _state.level == "O2":
        if name in _state.black:
            return plan(torch.float32, lambda t: _is_float(t)
                        and t.dtype in (low, torch.float16))
        return plan(low, lambda t: _is_float(t) and t.dtype != low)
    if name in _state.white:
        return plan(low, lambda t: _is_float(t) and t.dtype != low)
    if name in _state.black:
        return plan(torch.float32, lambda t: _is_float(t) and t.dtype == low)
    return None


def cast_inputs(name, *tensors):
    """``tensors`` cast by :func:`cast_plan` for the op ``name``: how a
    function of the port that is not a torch call takes part in
    auto_cast. Returns the tuple unchanged when auto_cast is off."""
    plan = cast_plan(name, tensors)
    if not plan:
        return tensors
    return tuple(t if d is None else t.to(d) for t, d in zip(tensors, plan))


def op_name(func):
    """The reference's name for a torch callable, or None for a call that
    O2 leaves alone."""
    name = _OP_NAMES.get(func)
    if name is not None:
        return name
    name = getattr(func, "__name__", None)
    if name is None or name in _NO_CAST or (
            name.endswith("_") and not name.startswith("__")):
        return None
    return _ALIASES.get(name, name)


def _cast_call(name, args, kwargs):
    """``(args, kwargs)`` with their tensors cast by the plan for ``name``."""
    leaves, spec = tree_flatten((args, kwargs))
    plan = cast_plan(name, leaves)
    if not plan or not any(d is not None for d in plan):
        return args, kwargs
    return tree_unflatten([x if d is None else x.to(d)
                           for x, d in zip(leaves, plan)], spec)


class _AmpMode(TorchFunctionMode):
    """Applies :func:`cast_plan` to every torch call made under it. The
    mode is off while it handles a call, so what that call does inside is
    not seen again (the reference's dispatcher, too, sees an op once)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _state.enabled:
            name = op_name(func)
            if name is not None and (_state.level == "O2"
                                     or name in _state.white
                                     or name in _state.black):
                args, kwargs = _cast_call(name, args, kwargs)
        return func(*args, **kwargs)


@contextlib.contextmanager
def _applied(enabled, level, low, white, black):
    prev = (_state.enabled, _state.level, _state.dtype, _state.white,
            _state.black)
    (_state.enabled, _state.level, _state.dtype, _state.white,
     _state.black) = enabled, level, low, white, black
    try:
        if enabled and not prev[0]:
            with _AmpMode():
                yield
        else:
            yield
    finally:
        (_state.enabled, _state.level, _state.dtype, _state.white,
         _state.black) = prev


def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """``paddle.amp.auto_cast``: a context inside which torch calls run on
    the reference's dtype plan for ``level`` ("O2", else O1's rules) and
    ``dtype`` ("float16", else bfloat16). ``custom_white_list`` adds op
    names to the white list and takes them off the black list;
    ``custom_black_list`` adds names to the black list. ``enable=False``
    turns casting off inside, as in the reference."""
    white = WHITE_LIST | set(custom_white_list or ())
    black = (BLACK_LIST | set(custom_black_list or ())) - set(
        custom_white_list or ())
    return _applied(bool(enable), level,
                    _LOW["float16" if dtype == "float16" else "bfloat16"],
                    white, black)


amp_guard = auto_cast


def snapshot():
    """The active auto_cast state, or None when it is off."""
    if not _state.enabled:
        return None
    return (_state.level, _state.dtype, _state.white, _state.black)


def restored(snap):
    """Re-enter a state taken by :func:`snapshot` when casting is off now:
    a recomputation in the backward runs outside the forward's context and
    must cast as the forward did. A no-op context otherwise."""
    if snap is None or _state.enabled:
        return contextlib.nullcontext()
    return _applied(True, *snap)


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: under O2 every float32 parameter of
    ``models`` is cast to the low dtype in place (``p.data``), and the
    optimizers keep float32 master weights (``multi_precision``; a
    ``master_weight`` given overrides). Returns the models, with the
    optimizers when given, in the form they were passed."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        low = _LOW["float16" if dtype == "float16" else "bfloat16"]
        for m in model_list:
            for p in m.parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(low)
        if optimizers is not None:
            opts = optimizers if isinstance(optimizers, (list, tuple)) \
                else [optimizers]
            for o in opts:
                if hasattr(o, "_multi_precision"):
                    o._multi_precision = True if master_weight is None \
                        else master_weight
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers
