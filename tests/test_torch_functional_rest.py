"""The rest of the port's ``nn.functional`` against the JAX package's:
``linear``, ``embedding``, ``sequence_mask``, ``rnnt_loss`` (values and
gradients in every reduction), ``margin_cross_entropy``, ``hsigmoid_loss``
(the default tree and a custom one) and ``class_center_sample``
(bitwise). The sampling grids, the shift and the pools with indices are in
``test_torch_functional_grids.py``; the attention entries in
``test_torch_functional_attention.py``.

Inputs: small float32 arrays from a seeded numpy generator; values and
gradients are held to 1e-5 absolute and relative (float32 in both
frameworks), masks and sampled classes are equal. The reference runs as
one compiled program (``functional_parity._ref``) where it would compile
op by op. The reference faults this file shows (ROADMAP queue 3) run both
packages.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu.nn.functional as jF  # noqa: E402
from functional_parity import (_arr, _close, _equal, _j, _parity,  # noqa: E402
                               _ref, _t)
from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from paddle_tpu_torch.profiler import explainer  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)


# --------------------------------------------- linear, embedding, mask --
@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    arrays = [_arr((2, 3, 4)), _arr((4, 5), 2)] + ([_arr((5,), 3)]
                                                   if bias else [])
    _parity(lambda *a: jF.linear(*a), lambda *a: tF.linear(*a), arrays)


@pytest.mark.parametrize("padding_idx,sparse", [(None, False), (2, False),
                                                (2, True)])
def test_embedding(padding_idx, sparse):
    ids = np.array([[0, 2, 5], [2, 1, 4]])
    w = _arr((6, 3))
    want = _ref(lambda t: jF.embedding(_j(ids), t, padding_idx), [w])
    tw = _t(w, True)
    out = tF.embedding(_t(ids), tw, padding_idx, sparse)
    _close(out, want)
    out.sum().backward()
    g = tw.grad.to_dense() if sparse else tw.grad
    assert g.is_sparse is False and (tw.grad.is_sparse == sparse)
    counts = np.bincount(ids.ravel(), minlength=6).astype(np.float32)
    if padding_idx is not None:
        counts[padding_idx] = 0
    _close(g, counts[:, None] * np.ones((1, 3), np.float32))


@pytest.mark.parametrize("maxlen,dtype", [(None, "int64"), (6, "float32"),
                                          (None, "bool")])
def test_sequence_mask(maxlen, dtype):
    lens = np.array([[1, 4], [0, 3]])
    got = tF.sequence_mask(_t(lens), maxlen, dtype)
    want = jF.sequence_mask(_j(lens), maxlen, dtype)
    assert str(got.dtype) == f"torch.{dtype}"
    _equal(got, want)


# ------------------------------------------------------------- rnnt -----
def _rnnt_inputs():
    B, T, U, V = 3, 6, 4, 5
    x = _arr((B, T, U + 1, V), 1)
    lab = np.random.default_rng(2).integers(1, V, (B, U))
    return x, lab, np.array([6, 4, 5]), np.array([4, 2, 0])


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_rnnt_loss(reduction):
    x, lab, il, ll = _rnnt_inputs()
    out = _parity(
        lambda a: jF.rnnt_loss(a, _j(lab), _j(il), _j(ll), blank=0,
                               reduction=reduction),
        lambda a: tF.rnnt_loss(a, _t(lab), _t(il), _t(ll), blank=0,
                               reduction=reduction), [x])
    assert out.shape == ((3,) if reduction == "none" else ())


def test_rnnt_loss_other_blank_matches_the_reference():
    x, lab, il, ll = _rnnt_inputs()
    lab = np.where(lab == 3, 1, lab)
    _parity(lambda a: jF.rnnt_loss(a, _j(lab), _j(il), _j(ll), blank=3),
            lambda a: tF.rnnt_loss(a, _t(lab), _t(il), _t(ll), blank=3), [x])


def test_reference_fault_rnnt_fastemit():
    """FastEmit regularisation (``fastemit_lambda``): the port refuses a
    non-zero value; the reference ignores it."""
    x, lab, il, ll = _rnnt_inputs()
    with pytest.raises(ValueError, match="fastemit_lambda"):
        tF.rnnt_loss(_t(x), _t(lab), _t(il), _t(ll), fastemit_lambda=0.01)
    plain = _ref(lambda a: jF.rnnt_loss(a, _j(lab), _j(il), _j(ll)), [x])
    _equal(_ref(lambda a: jF.rnnt_loss(a, _j(lab), _j(il), _j(ll),
                                       fastemit_lambda=0.01), [x]), plain)


# ----------------------------------------------------- margin and tree --
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_margin_cross_entropy(reduction):
    cos = np.tanh(_arr((4, 7), 1))
    lab = np.array([1, 0, 6, 3])
    kw = dict(margin1=1.0, margin2=0.4, margin3=0.1, scale=16.0,
              reduction=reduction)
    out = _parity(lambda c: jF.margin_cross_entropy(c, _j(lab), **kw),
                  lambda c: tF.margin_cross_entropy(c, _t(lab), **kw),
                  [cos])
    assert out.shape == ((4, 1) if reduction == "none" else ())
    _, jsm = jF.margin_cross_entropy(_j(cos), _j(lab), return_softmax=True,
                                     **kw)
    _, tsm = tF.margin_cross_entropy(_t(cos), _t(lab), return_softmax=True,
                                     **kw)
    _close(tsm, jsm)


def test_reference_fault_margin_and_sampling_group():
    """The class-parallel form (a ``group`` of several ranks): the port
    refuses it; the reference ignores the group and computes one rank's
    result."""
    class Group:
        nranks = 2

    cos, lab = np.tanh(_arr((4, 7), 1)), np.array([1, 0, 6, 3])
    with pytest.raises(ValueError, match="group"):
        tF.margin_cross_entropy(_t(cos), _t(lab), group=Group())
    with pytest.raises(ValueError, match="group"):
        tF.class_center_sample(_t(lab), 7, 5, group=Group())
    _equal(jF.margin_cross_entropy(_j(cos), _j(lab), group=Group()),
           jF.margin_cross_entropy(_j(cos), _j(lab)))


@pytest.mark.parametrize("num_classes", [6, 8])
@pytest.mark.parametrize("bias", [True, False])
def test_hsigmoid_loss_default_tree(num_classes, bias):
    x, lab = _arr((5, 4), 1), np.array([0, 3, 5, 1, 2])
    arrays = [x, _arr((num_classes - 1, 4), 2)] + (
        [_arr((num_classes - 1, 1), 3)] if bias else [])
    out = _parity(lambda *a: jF.hsigmoid_loss(a[0], _j(lab), num_classes,
                                              *a[1:]),
                  lambda *a: tF.hsigmoid_loss(a[0], _t(lab), num_classes,
                                              *a[1:]), arrays)
    assert out.shape == (5, 1)


def test_hsigmoid_loss_custom_tree():
    x, lab = _arr((4, 3), 1), np.array([0, 1, 2, 1])
    table = np.array([[0, 1, -1], [0, 1, 2], [0, 2, -1]])
    code = np.array([[1, 0, 0], [1, 1, 0], [0, 1, 0]])
    _parity(lambda a, w, b: jF.hsigmoid_loss(
                a, _j(lab), 3, w, b, path_table=_j(table),
                path_code=_j(code)),
            lambda a, w, b: tF.hsigmoid_loss(
                a, _t(lab), 3, w, b, path_table=_t(table),
                path_code=_t(code)),
            [x, _arr((3, 3), 2), _arr((3,), 3)])


@pytest.mark.parametrize("labels,num_samples", [
    ([3, 9, 3, 17, 0, 9], 8), ([1, 1, 1, 1], 6), ([5, 2, 7, 11], 4)])
def test_class_center_sample_bitwise(labels, num_samples):
    lab = np.array(labels)
    jr, js = jF.class_center_sample(_j(lab), 20, num_samples)
    tr, ts = tF.class_center_sample(_t(lab), 20, num_samples)
    assert tr.dtype == ts.dtype == torch.int64
    _equal(tr, jr)
    _equal(ts, js)


def test_class_center_sample_truncation_is_logged(caplog):
    """More positive classes than ``num_samples``: the lowest are kept
    and the others' labels become -1, as in the reference (which drops
    them silently); the port logs it and records an event."""
    lab = np.array([4, 8, 1, 6, 8])
    with caplog.at_level("WARNING"):
        tr, ts = tF.class_center_sample(_t(lab), 10, 3)
    jr, js = jF.class_center_sample(_j(lab), 10, 3)
    _equal(tr, jr)
    _equal(ts, js)
    _equal(tr, [1, -1, 0, 2, -1])
    assert "exceed num_samples" in caplog.text
    ev = explainer.events(kind="class_center_sample_truncated")[-1]
    assert "4 positive classes" in ev["why"]
