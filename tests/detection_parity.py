"""Helpers of the detection-operator parity tests
(``test_torch_vision_ops*.py``): seeded float32 arrays, both packages'
tensors from them, the reference's ops compiled by JAX as one program (and
differentiated by JAX: the reference's detection ops take their inputs'
arrays out of the package's tensors, so its tape records nothing through
them), and the comparisons at the files' stated tolerance (1e-5 absolute
and relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle

TOL = dict(atol=1e-5, rtol=1e-5)


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


def _equal(got, want, what=""):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


def _ref_vjp(fn, arrays, w):
    """The reference op ``fn`` on raw arrays, differentiated by JAX and
    compiled as one program: its output and the gradients of ``sum(out *
    w)`` for every array."""
    def run(w, *a):
        out, vjp = jax.vjp(lambda *b: fn(*b)._data, *a)
        return out, vjp(w.astype(out.dtype))

    return jax.jit(run)(jnp.asarray(w), *[jnp.asarray(a) for a in arrays])


def _ref(fn, *arrays):
    """The reference op ``fn`` on raw arrays, compiled as one program."""
    return jax.jit(lambda *a: _data(fn(*a)))(*map(jnp.asarray, arrays))


def _data(out):
    if isinstance(out, (tuple, list)):
        return type(out)(_data(o) for o in out)
    return out._data


def _port_vjp(fn, arrays, w=None):
    """The port's op on tensors of ``arrays``: its output and the
    gradients of ``sum(out * w)`` (``w`` None: seeded at the output's
    shape)."""
    ins = [_t(a, True) for a in arrays]
    out = fn(*ins)
    w = _arr(tuple(out.shape), 9) if w is None else w
    (out * _t(w)).sum().backward()
    return out, [i.grad for i in ins], w


def _vjp_parity(jfn, tfn, arrays, names):
    got, grads, w = _port_vjp(tfn, arrays)
    want, ref_grads = _ref_vjp(jfn, arrays, w)
    _close(got, want, "output")
    for name, g, r in zip(names, grads, ref_grads):
        _close(g, r, f"{name} grad")
    return got, want
