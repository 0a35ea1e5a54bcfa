"""Helpers of the vision-path parity tests (``test_torch_vision_*.py``):
seeded float32 arrays, both packages' tensors from them, the reference's
models built with host-drawn weights, and the comparisons at the files'
stated tolerance (1e-4 absolute and relative)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import convert

TOL = dict(atol=1e-4, rtol=1e-4)


@contextlib.contextmanager
def _host_draws(seed):
    """``jax.random.uniform`` and ``normal`` drawn by numpy meanwhile. The
    reference's initializers call them once per parameter, and on the CPU
    each new shape compiles for ~0.7 s; the weights are carried into the
    port whatever they are, so where they come from does not matter."""
    rng = np.random.default_rng(seed)
    uniform, normal = jax.random.uniform, jax.random.normal

    def host_uniform(key, shape=(), dtype=jnp.float32, minval=0.0,
                     maxval=1.0):
        return jnp.asarray(rng.uniform(np.asarray(minval), np.asarray(maxval),
                                       shape), dtype)

    def host_normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape), dtype)

    jax.random.uniform, jax.random.normal = host_uniform, host_normal
    try:
        yield
    finally:
        jax.random.uniform, jax.random.normal = uniform, normal


def _seeded(fn, seed=0):
    """``fn()`` (which builds reference layers) from seed ``seed``, the
    reference's global generator put back after."""
    state = paddle.get_rng_state()
    try:
        paddle.seed(seed)
        with _host_draws(seed):
            return fn()
    finally:
        paddle.set_rng_state(state)


def _arr(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _j(a, grad=False):
    return paddle.to_tensor(a, stop_gradient=not grad)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=what)


def _fn_parity(jfn, tfn, arrays, grad=None):
    """``jfn`` and ``tfn`` on the same arrays: outputs and the gradients of
    ``sum(out * w)`` with respect to the arrays in ``grad`` (default:
    all)."""
    grad = range(len(arrays)) if grad is None else grad
    jin = [_j(a, i in grad) for i, a in enumerate(arrays)]
    tin = [_t(a, i in grad) for i, a in enumerate(arrays)]
    jout, tout = jfn(*jin), tfn(*tin)
    _close(tout, jout, "output")
    w = _arr(tuple(tout.shape), seed=9)
    if grad:
        (jout * _j(w)).sum().backward()
        (tout * _t(w)).sum().backward()
        for i in grad:
            _close(tin[i].grad, jin[i].grad, f"input {i} grad")
    return jout, tout


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _layer_pair(make_ref, make_port, seed=0):
    jm = _seeded(make_ref, seed)
    tm = make_port()
    convert.load_paddle_tpu_state(tm, _state(jm))
    return jm, tm


def _layer_parity(jm, tm, arrays, grad=(0,)):
    """Forward both layers, backward ``sum(out * w)``; outputs, input and
    parameter gradients."""
    jin = [_j(a, i in grad) for i, a in enumerate(arrays)]
    tin = [_t(a, i in grad) for i, a in enumerate(arrays)]
    jout, tout = jm(*jin), tm(*tin)
    _close(tout, jout, "output")
    w = _arr(tuple(tout.shape), seed=9)
    (jout * _j(w)).sum().backward()
    (tout * _t(w)).sum().backward()
    for i in grad:
        _close(tin[i].grad, jin[i].grad, f"input {i} grad")
    got = dict(tm.named_parameters())
    for name, p in jm.named_parameters():
        if p.grad is not None and got[name].requires_grad:
            _close(got[name].grad, p.grad, f"{name} grad")
    return jout, tout


def _probs(shape, seed):
    return 1 / (1 + np.exp(-_arr(shape, seed))).astype(np.float32)


def zoo_parity(make, shape, seed=0):
    """``make(models)`` of both packages, the reference's state (running
    statistics drawn at random) loaded into the port's, and the eval-mode
    forwards of one seeded input held to ``TOL``."""
    from paddle_tpu.vision import models as jmodels
    from paddle_tpu_torch.vision import models as tmodels

    jm = _seeded(lambda: make(jmodels), seed)
    state = _state(jm)
    rng = np.random.default_rng(seed + 1)
    for k in state:
        if k.endswith("_mean"):
            state[k] = rng.standard_normal(state[k].shape).astype(np.float32)
        elif k.endswith("_variance"):
            state[k] = rng.uniform(0.5, 2.0, state[k].shape).astype(
                np.float32)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    tm = make(_cpu(tmodels))
    convert.load_paddle_tpu_state(tm, state)
    jm.eval()
    tm.eval()
    x = _arr(shape, seed + 2)
    # one compiled program for the whole forward, not one per op
    with paddle.no_grad(), paddle.incubate.lazy_eval():
        want = jm(_j(x))
        want = [np.asarray(w.numpy()) for w in (
            want if isinstance(want, (tuple, list)) else [want])]
    with torch.no_grad():
        got = tm(_t(x))
    got = got if isinstance(got, (tuple, list)) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


class _cpu:
    """The port's model builders with ``device="cpu"``."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        fn = getattr(self._mod, name)
        return lambda *a, **kw: fn(*a, device="cpu", **kw)
