"""Static (declarative) mode: Program, Variable and the recorder
(counterpart of paddle_tpu/static/program.py).

The reference records through its dispatch layer, which every op of its
own ``Tensor`` passes. The port has no tensor type and no dispatch layer of
its own: it records torch calls. While static mode is on, a
``torch.overrides.TorchFunctionMode`` sees every torch call, and records
into the current Program each call that touches

- a :class:`Variable` (``static.data``'s symbols and what is computed from
  them) or a :class:`SymDim` (a dimension of a Variable that is decided at
  run time);
- with grad mode on, an ``nn.Parameter`` (promoted once, keyed by the
  object, to a program parameter: the counterpart of ``program.py:294-307``),
  unless the call updates that parameter in place (initialisers do);
- with grad mode on, a random draw (``torch.randint``, ...), so that it
  draws anew at every run;
- a tensor placed on a Variable's device.

Every other call runs at once and its result is a constant of the Program.

A Variable is a tensor subclass over a ``meta`` tensor: ``isinstance(v,
torch.Tensor)`` holds and its dtype and rank are real. Its shape and the
output of each recorded call come from running the call on meta tensors,
twice where a dimension is dynamic (``None``/-1 in ``static.data``): with
the placeholder 2 and with 3, as the reference does (``program.py:309-
322``). A dimension that differs between the two is dynamic, and reading it
(``x.shape[0]``) gives a :class:`SymDim`, a recorded call that reads the
size when the Program runs, so ``x.reshape(x.shape[0], ...)`` holds at
every batch. A Variable's device is :data:`DEVICE`, the placeholder
``meta:0``: a tensor a model makes on ``x.device`` is made when the Program
runs, on the Executor's device.

``bool(Variable)`` raises ``TypeError``: a Python branch on a value cannot
be recorded (``static.nn.cond`` / ``while_loop`` can). An in-place call on
a Variable (``v.add_(1)``, ``v += 1``, ``v[0] = ...``) records the call and
makes the Variable an alias of its result, so later calls and fetches see
the new value (``Variable._rebind``, ``program.py:117-131``).

A function that branches on device, dtype or exact shape (the attention
kernels' dispatchers, ``nn.functional.batch_norm``) is one call of the
Program (``framework.static_leaf``), as ``torch.nn.functional``'s are: its
route is chosen when the Program runs, on the real tensors.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import operator

import numpy as np
import torch
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from .. import framework

__all__ = ["Program", "Variable", "SymDim", "program_guard",
           "default_main_program", "default_startup_program", "data",
           "name_scope", "Scope", "global_scope", "scope_guard", "DEVICE",
           "in_static_mode"]

DEVICE = torch.device("meta", 0)
_PLACEHOLDERS = (2, 3)

_DTYPES = {"float32": torch.float32, "float": torch.float32,
           "float64": torch.float64, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int64": torch.int64,
           "int32": torch.int32, "int16": torch.int16, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}

_RANDOM = {torch.rand, torch.randn, torch.randint, torch.randperm,
           torch.bernoulli, torch.normal, torch.multinomial, torch.rand_like,
           torch.randn_like, torch.randint_like}

_INPLACE_DUNDERS = {"__iadd__", "__isub__", "__imul__", "__itruediv__",
                    "__ifloordiv__", "__imod__", "__ipow__", "__iand__",
                    "__ior__", "__ixor__", "__ilshift__", "__irshift__",
                    "__setitem__"}

_HOST_READS = {"item", "tolist", "__int__", "__float__", "__index__",
               "__complex__"}

_ids = itertools.count(1)


def convert_dtype(dtype):
    """A torch dtype from a torch or numpy dtype or a Paddle dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, np.dtype) or isinstance(dtype, type):
        return torch.from_numpy(np.zeros((), dtype)).dtype
    name = str(dtype).rsplit(".", 1)[-1]
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


class UncapturedValueError(TypeError):
    """A recorded Program was asked for a value on the host."""


_BRANCH = ("static recording: data-dependent Python control flow cannot "
           "be captured in a Program — use paddle_tpu_torch.static.nn.cond "
           "/ static.nn.while_loop instead of if/while on tensor values")


class Variable(torch.Tensor):
    """A symbolic tensor of a Program (reference framework.py Variable):
    a tensor subclass over a meta tensor, with the reference's ``name``,
    ``shape`` (-1 for a dynamic dimension in :attr:`static_shape`),
    ``is_param``, ``stop_gradient`` and ``persistable``."""

    @staticmethod
    def __new__(cls, meta_a, meta_b=None, name=None, program=None,
                is_param=False, trainable=True):
        v = torch.Tensor._make_subclass(cls, meta_a)
        v.__dict__.update(
            _ma=meta_a, _mb=meta_a if meta_b is None else meta_b,
            vid=next(_ids), is_param=is_param,
            stop_gradient=(not trainable) if is_param else True,
            persistable=is_param, program=program, _alias=None)
        v.__dict__["_name"] = name or f"var_{v.vid}"
        return v

    @property
    def name(self):
        return self.__dict__["_name"]

    @property
    def static_shape(self):
        """The shape with -1 for each dynamic dimension."""
        return [-1 if a != b else a
                for a, b in zip(self._ma.shape, self._mb.shape)]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if not framework._recording:
            raise RuntimeError(
                "a static Program's Variable was used outside static mode; "
                "run the Program with static.Executor().run(...)")
        return _on_call(func, args, kwargs or {})

    def __bool__(self):
        raise TypeError(f"Variable {self.name!r} used in a Python bool "
                        f"context: {_BRANCH}")

    def __hash__(self):
        return id(self)

    def __len__(self):
        n = self.static_shape[0] if self.static_shape else -1
        if n < 0:
            raise UncapturedValueError(
                f"len() of Variable {self.name!r}: its first dimension is "
                f"dynamic; {_BRANCH}")
        return n

    def __iter__(self):
        return iter([self[i] for i in range(len(self))])

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.static_shape}, "
                f"dtype={self._ma.dtype}, param={self.is_param})")

    __str__ = __repr__

    def __format__(self, spec):
        return repr(self)

    def __reduce_ex__(self, protocol):
        raise TypeError(f"Variable {self.name!r} cannot be pickled; "
                        "static.save writes the whole Program")

    def numpy(self):
        """The Variable's value in the global scope (a parameter after the
        startup program ran)."""
        with recording_suspended():
            return self._scope_value()

    def _scope_value(self):
        value = global_scope().find_var(self.name)
        if value is None:
            raise RuntimeError(f"Variable {self.name} has no value yet; run "
                               "the program first.")
        return value.detach().cpu().numpy()

    def _rebind(self, result):
        """Make this Variable an alias of ``result`` (an in-place call)."""
        resolve_alias(self).__dict__["_alias"] = result
        return self


def resolve_alias(v):
    """Follow in-place aliases to the live Variable."""
    while isinstance(v, Variable) and v.__dict__.get("_alias") is not None:
        v = v.__dict__["_alias"]
    return v


class SymDim:
    """A dimension decided when the Program runs: the output of a recorded
    call (``x.shape[0]``, ``B * T``). Arithmetic on it is recorded; asking
    for its value (``int``, ``bool``, a comparison) raises."""

    __slots__ = ("_a", "_b", "vid")

    def __init__(self, a, b):
        self._a, self._b, self.vid = a, b, next(_ids)

    def __repr__(self):
        return f"SymDim(vid={self.vid})"

    def __hash__(self):
        return id(self)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        # torch's argument parser takes an object with __torch_function__
        # where it wants an int and hands the call to the recorder
        return Variable.__torch_function__(func, types, args, kwargs)

    def _ask(self, *_):
        raise UncapturedValueError(
            f"the value of a dynamic dimension was asked for while "
            f"recording; {_BRANCH}")

    __index__ = __int__ = __bool__ = __float__ = _ask
    __eq__ = __ne__ = __lt__ = __le__ = __gt__ = __ge__ = _ask


def _binop(fn, reflected=False):
    if reflected:
        return lambda self, other: _record(fn, (other, self), {})
    return lambda self, other: _record(fn, (self, other), {})


for _name, _fn in (("add", operator.add), ("sub", operator.sub),
                   ("mul", operator.mul), ("floordiv", operator.floordiv),
                   ("truediv", operator.truediv), ("mod", operator.mod)):
    setattr(SymDim, f"__{_name}__", _binop(_fn))
    setattr(SymDim, f"__r{_name}__", _binop(_fn, reflected=True))
SymDim.__neg__ = lambda self: _record(operator.neg, (self,), {})


class OpRecord:
    """One recorded call (``kind`` "call") or control-flow construct
    ("cond", "while"). ``args`` and ``kwargs`` hold Variables, SymDims,
    constants and :data:`DEVICE`; ``out`` the flat outputs (Variables,
    SymDims, or values known at record time), in the order
    ``torch.utils._pytree`` flattens the call's result. An in-place call's
    one output is its first argument, changed. ``sub`` holds a construct's
    blocks."""

    __slots__ = ("kind", "fn", "args", "kwargs", "out", "inplace", "sub")

    def __init__(self, kind, fn, args, kwargs, out, inplace=False,
                 sub=None):
        self.kind, self.fn, self.args, self.kwargs = kind, fn, args, kwargs
        self.out, self.inplace, self.sub = out, inplace, sub


class Program:
    """Reference framework.py Program (single-block form): ``ops`` in
    record order, ``vars`` by name, ``params`` as ``(Variable, initial
    value)`` (for a promoted ``nn.Parameter`` the value is the parameter
    itself), ``feed_vars``, ``minimize_reqs`` as ``(optimizer, loss)``."""

    def __init__(self):
        self.ops: list[OpRecord] = []
        self.vars: dict[str, Variable] = {}
        self.params: list[tuple[Variable, torch.Tensor]] = []
        self.feed_vars: dict[str, Variable] = {}
        self.minimize_reqs: list = []
        self.backward_req = None
        self.random_seed = None
        self._version = 0
        self._param_of: dict[int, Variable] = {}
        self._targets = [self.ops]

    def global_block(self):
        return self

    def clone(self, for_test=False):
        p = Program()
        p.ops, p.vars = list(self.ops), dict(self.vars)
        p.params, p.feed_vars = list(self.params), dict(self.feed_vars)
        p._param_of = dict(self._param_of)
        p._targets = [p.ops]
        if not for_test:
            p.minimize_reqs = list(self.minimize_reqs)
            p.backward_req = self.backward_req
        return p

    def list_vars(self):
        return list(self.vars.values())

    def all_parameters(self):
        return [v for v, _ in self.params]

    def _add_var(self, v):
        self.vars[v.name] = v
        v.__dict__["program"] = self
        self._version += 1
        return v

    def _new_var(self, meta_a, meta_b, name=None):
        return self._add_var(Variable(meta_a, meta_b, name=name))

    def _add_param(self, name, value, trainable=True):
        meta = torch.empty_like(value, device="meta")
        v = self._add_var(Variable(meta, name=name, is_param=True,
                                   trainable=trainable))
        self.params.append((v, value))
        return v

    def _promote(self, p):
        v = self._param_of.get(id(p))
        if v is None:
            v = self._add_param(f"param_{next(_param_names)}", p,
                                trainable=p.requires_grad)
            self._param_of[id(p)] = v
        return v

    def _append(self, op):
        self._targets[-1].append(op)
        self._version += 1

    @contextlib.contextmanager
    def _recording_into(self, ops):
        """Record into ``ops`` (a control-flow branch) meanwhile."""
        self._targets.append(ops)
        try:
            yield ops
        finally:
            self._targets.pop()

    def __repr__(self):
        return (f"Program(ops={len(self.ops)}, params={len(self.params)}, "
                f"feeds={list(self.feed_vars)})")


_param_names = itertools.count()


_recorder = None  # on torch's mode stack while static mode is on
_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def in_static_mode():
    return framework._recording


class program_guard:
    """Record into ``main_program`` (and take ``startup_program`` as the
    default startup program) inside the block."""

    def __init__(self, main_program, startup_program=None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        global _main_program, _startup_program
        self._prev = (_main_program, _startup_program)
        _main_program = self.main
        if self.startup is not None:
            _startup_program = self.startup
        return self

    def __exit__(self, *exc):
        global _main_program, _startup_program
        _main_program, _startup_program = self._prev
        return False


class name_scope:
    def __init__(self, prefix=None):
        self.prefix = prefix

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# -- the recorder -------------------------------------------------------------

def _map(fn, tree):
    """``fn`` over the leaves of lists, tuples, dicts and slices."""
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, tuple):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, dict):
        return {k: _map(fn, x) for k, x in tree.items()}
    if isinstance(tree, slice):
        return slice(_map(fn, tree.start), _map(fn, tree.stop),
                     _map(fn, tree.step))
    return fn(tree)


def _leaves(tree, out=None):
    out = [] if out is None else out
    _map(out.append, tree)
    return out


def _is_param(x):
    return isinstance(x, nn.Parameter) and not isinstance(x, Variable) \
        and not x.is_meta


def _fn_name(func):
    return getattr(func, "__name__", "")


def _is_inplace(func):
    name = _fn_name(func)
    return name in _INPLACE_DUNDERS or (
        name.endswith("_") and not name.endswith("__"))


def _wants_record(func, args, kwargs):
    leaves = _leaves((args, kwargs))
    if any(isinstance(x, (Variable, SymDim)) or
           (isinstance(x, torch.device) and x == DEVICE) for x in leaves):
        return True
    if not torch.is_grad_enabled():
        return False
    if func in _RANDOM:
        return True
    if _is_inplace(func) and args and _is_param(args[0]):
        return False
    return any(_is_param(x) for x in leaves)


def _getattr(x, name):
    return getattr(x, name)


def _on_call(func, args, kwargs):
    name = _fn_name(func)
    if name == "__get__" and hasattr(func, "__self__"):
        # a Tensor property (shape, dtype, T, ...): recorded by name
        func, args = _getattr, (args[0], func.__self__.__name__)
    if name in _HOST_READS:
        raise UncapturedValueError(f"{name}() of a Variable: {_BRANCH}")
    return _record(func, args, kwargs)


def _meta_value(x, which, mutated):
    if isinstance(x, Variable):
        m = (x._ma, x._mb)[which].detach()
        mutated.append(m)
        return m
    if isinstance(x, SymDim):
        return (x._a, x._b)[which]
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, torch.device) and x == DEVICE:
        return torch.device("meta")
    return x


def _meta_eval(func, args, kwargs, which):
    mutated = []
    margs, mkwargs = _map(lambda x: _meta_value(x, which, mutated),
                          (args, kwargs))
    fn = getattr(func, "static_meta", func)
    try:
        out = fn(*margs, **mkwargs)
    except UncapturedValueError:
        raise
    except Exception as e:
        raise RuntimeError(
            f"static recording: {_fn_name(func) or func} could not be "
            f"recorded: its outputs could not be inferred on meta tensors "
            f"({type(e).__name__}: {e}). A call whose output shape depends "
            "on the data cannot be part of a Program") from e
    return out, (mutated[0] if mutated else None)


def _static_value(v):
    if isinstance(v, torch.device) and v.type == "meta":
        return DEVICE
    return v


def _record(func, args, kwargs):
    prog = _main_program
    target = args[0] if args else None
    rargs, rkwargs = _map(
        lambda x: resolve_alias(x) if isinstance(x, Variable) else x,
        (args, kwargs))
    leaves = _leaves((rargs, rkwargs))
    symbolic_in = any(isinstance(x, (Variable, SymDim)) for x in leaves)
    dynamic = any(isinstance(x, SymDim) or (
        isinstance(x, Variable) and -1 in x.static_shape) for x in leaves)
    out_a, mut_a = _meta_eval(func, rargs, rkwargs, 0)
    out_b, mut_b = _meta_eval(func, rargs, rkwargs, 1) if dynamic \
        else (out_a, mut_a)

    def promote(x):
        return prog._promote(x) if _is_param(x) else x

    if _is_inplace(func) and isinstance(rargs[0], Variable):
        rargs, rkwargs = _map(promote, (rargs, rkwargs))
        new = prog._new_var(mut_a, mut_b)
        prog._append(OpRecord("call", func, rargs, rkwargs, [new], True))
        target._rebind(new)
        return None if _fn_name(func) == "__setitem__" else target
    flat_a, spec = pytree.tree_flatten(out_a)
    flat_b = pytree.tree_flatten(out_b)[0]
    out, symbolic = [], False
    for a, b in zip(flat_a, flat_b):
        if isinstance(a, torch.Tensor):
            out.append(prog._new_var(a, b))
            symbolic = True
        elif isinstance(a, int) and not isinstance(a, bool) and a != b:
            out.append(SymDim(a, b))
            symbolic = True
        elif a != b:
            raise RuntimeError(
                f"static recording: {_fn_name(func)} gives a value that "
                "depends on a dynamic dimension and is not a tensor or an "
                "int")
        else:
            out.append(_static_value(a))
    if not symbolic:
        if not symbolic_in:
            # a read of a parameter's metadata: the real answer
            return func(*args, **kwargs)
        return pytree.tree_unflatten(out, spec)
    rargs, rkwargs = _map(promote, (rargs, rkwargs))
    prog._append(OpRecord("call", func, rargs, rkwargs, out))
    return pytree.tree_unflatten(out, spec)


class _Recorder(TorchFunctionMode):
    """The mode that static mode keeps on torch's function-mode stack."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _wants_record(func, args, kwargs):
            return func(*args, **kwargs)
        return _on_call(func, args, kwargs)


def _enable_static():
    global _recorder
    if framework._recording:
        return
    _recorder = _Recorder()
    _recorder.__enter__()
    framework._recording = True


def _disable_static():
    global _recorder
    if not framework._recording:
        return
    stack = torch._C._len_torch_function_stack()
    top = torch._C._get_function_stack_at(stack - 1) if stack else None
    if top is not _recorder:
        raise RuntimeError("disable_static: another torch function mode "
                           "was entered after enable_static and is still "
                           "open; leave it first")
    _recorder.__exit__(None, None, None)
    _recorder = None
    framework._recording = False


@contextlib.contextmanager
def recording_suspended():
    """Run torch calls as they are meanwhile (the Executor's runs, the
    export of a Program): the recorder leaves torch's mode stack."""
    if not framework._recording:
        yield
        return
    _disable_static()
    try:
        yield
    finally:
        _enable_static()


def unrecorded(fn):
    """``fn`` run with the recorder suspended (see
    :func:`recording_suspended`)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with recording_suspended():
            return fn(*args, **kwargs)

    return run


def data(name, shape, dtype="float32", lod_level=0):
    """``paddle.static.data``: a feed of the main Program; a ``None`` or -1
    dimension is dynamic."""
    dt = convert_dtype(dtype)
    metas = [torch.empty([ph if s in (None, -1) else int(s) for s in shape],
                         dtype=dt, device="meta") for ph in _PLACEHOLDERS]
    v = _main_program._add_var(Variable(*metas, name=name))
    _main_program.feed_vars[name] = v
    return v


# -- scope --------------------------------------------------------------------

class Scope:
    """Name -> tensor store (reference framework/scope.h): the parameters
    of the Programs an Executor ran, on its device."""

    def __init__(self):
        self.vars: dict[str, torch.Tensor] = {}

    def var(self, name):
        return self.vars.setdefault(name, None)

    def find_var(self, name):
        return self.vars.get(name)

    def set(self, name, value):
        self.vars[name] = value


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = prev
