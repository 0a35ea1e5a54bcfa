"""Helpers of the functional parity tests (``test_torch_functional_*.py``):
seeded float32 arrays, both packages' tensors from them, the reference's
op traced by JAX and compiled as one program (it would otherwise compile
op by op), and the comparisons at the files' stated tolerance (1e-5
absolute and relative; attention 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor

TOL = dict(atol=1e-5, rtol=1e-5)
ATTN_TOL = dict(atol=1e-4, rtol=1e-4)


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


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol, err_msg=what)


def _equal(got, want, what=""):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


def _ref(fn, arrays, w=None):
    """``fn`` (reference tensors -> one tensor) on ``arrays`` traced by
    JAX and compiled once: its output, and with ``w`` the gradients of
    ``sum(out * w)`` with respect to every array."""
    def f(*a):
        with paddle.no_grad():
            return fn(*[Tensor(x) for x in a])._data

    ins = [jnp.asarray(a) for a in arrays]
    if w is None:
        return np.asarray(jax.jit(f)(*ins))

    def run(w, *a):
        out, vjp = jax.vjp(f, *a)
        return out, vjp(w.astype(out.dtype))

    out, grads = jax.jit(run)(jnp.asarray(w), *ins)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _parity(jfn, tfn, arrays, tol=TOL):
    """Port against reference: output, and the gradients of ``sum(out *
    w)`` for every array (``w`` seeded at the output's shape)."""
    ins = [_t(a, True) for a in arrays]
    out = tfn(*ins)
    w = _arr(tuple(out.shape), 9)
    (out * _t(w)).sum().backward()
    want, grads = _ref(jfn, arrays, w)
    _close(out, want, "output", tol)
    for i, (t, g) in enumerate(zip(ins, grads)):
        _close(t.grad, g, f"input {i} grad", tol)
    return out
