"""Helpers of the recurrent-layer parity tests (``test_torch_rnn*.py``):
seeded float32 arrays, reference layers built from seeded host draws with
their weights carried into the port by ``convert``, the reference's
forward compiled by JAX as one program and differentiated by JAX (its
eager tape compiles every scan on its own, seconds a layer), and the
comparisons at the files' stated tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import convert
from vision_parity import _seeded, _state

TOL = dict(atol=1e-5, rtol=1e-5)


def _arr(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=what)


def _flat(out):
    """The tensors of a layer's output, ``(out, h)`` or ``(out, (h,
    c))``, in order."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def pair(make_ref, make_port, seed=0):
    """The reference layer from seed ``seed`` and the port's with its
    weights."""
    jm = _seeded(make_ref, seed)
    tm = make_port()
    convert.load_paddle_tpu_state(tm, _state(jm))
    return jm, tm


def ref_vjp(jm, call, arrays, weights):
    """``call(jm, *tensors)`` on the reference with its parameters and the
    ``arrays`` traced by JAX, compiled once: the flat outputs and the
    gradients of ``sum_i sum(out_i * weights_i)`` with respect to every
    parameter (by name) and every array."""
    names = [n for n, _ in jm.named_parameters()]
    params = [p for _, p in jm.named_parameters()]

    def run(pv, *a):
        saved = [p._data for p in params]
        try:
            for p, v in zip(params, pv):
                p._data = v
            with paddle.no_grad():
                out = call(jm, *[Tensor(x) for x in a])
            return [o._data for o in _flat(out)]
        finally:
            for p, v in zip(params, saved):
                p._data = v

    def loss(pv, a):
        outs = run(pv, *a)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights)), outs

    grad = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))
    (gp, ga), outs = grad([p._data for p in params],
                          [jnp.asarray(a) for a in arrays])
    return outs, dict(zip(names, gp)), list(ga)


def port_vjp(tm, call, arrays, weights=None, seed=9):
    """The same on the port (``weights`` None: seeded at the outputs'
    shapes); returns the weights too."""
    ins = [torch.from_numpy(np.array(a)).requires_grad_(True)
           for a in arrays]
    outs = _flat(call(tm, *ins))
    if weights is None:
        weights = [_arr(tuple(o.shape), seed + i) for i, o in
                   enumerate(outs)]
    sum((o * torch.from_numpy(w)).sum() for o, w in
        zip(outs, weights)).backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    return outs, grads, [i.grad for i in ins], weights


def parity(jm, tm, call, arrays):
    """Outputs, final states, and the gradients of the inputs and of every
    weight, the port's against the reference's."""
    outs, grads, in_grads, w = port_vjp(tm, call, arrays)
    r_outs, r_grads, r_in = ref_vjp(jm, call, arrays, w)
    assert len(outs) == len(r_outs)
    for i, (o, r) in enumerate(zip(outs, r_outs)):
        _close(o, r, f"output {i}")
    assert set(grads) == set(r_grads)
    for name in grads:
        _close(grads[name], r_grads[name], f"{name} grad")
    for i, (g, r) in enumerate(zip(in_grads, r_in)):
        _close(g, r, f"input {i} grad")
    return outs
