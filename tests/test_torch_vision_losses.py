"""The port's activations, losses, resizing, shuffles, patches and
padding (``paddle_tpu_torch.nn.functional``), and its layers without
parameters, against the JAX package's.

Inputs: small float32 arrays from a seeded numpy generator. Outputs and
the gradients of ``sum(out * w)`` (``w`` fixed and random) with respect
to the inputs and every parameter are held to 1e-4 absolute and relative
(float32 in both frameworks, summed in another order).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from vision_parity import (_arr, _close, _fn_parity, _j, _probs, _t)

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)


# -------------------------------------------------------- activations ----
ACTS = {
    "relu": {}, "relu6": {}, "gelu": {}, "sigmoid": {}, "silu": {},
    "swish": {}, "softmax": {"axis": 1}, "log_softmax": {}, "tanh": {},
    "leaky_relu": {"negative_slope": 0.2}, "elu": {"alpha": 0.7},
    "selu": {}, "celu": {"alpha": 1.3}, "softplus": {"beta": 2.0},
    "softsign": {}, "mish": {}, "hardshrink": {"threshold": 0.4},
    "hardsigmoid": {}, "hardswish": {}, "hardtanh": {"min": -0.5},
    "softshrink": {"threshold": 0.3}, "tanhshrink": {},
    "thresholded_relu": {"threshold": 0.2}, "log_sigmoid": {},
    "maxout": {"groups": 2}, "glu": {"axis": 1}, "swiglu": {},
}


@pytest.mark.parametrize("name", sorted(ACTS))
def test_activation(name):
    kw = ACTS[name]
    x = _arr((2, 4, 3, 6), scale=3.0)
    # keep away from the kinks, where a subgradient is a choice
    x = np.where(np.abs(x) < 0.05, 0.5, x)
    for k in ("threshold", "negative_slope", "min"):
        if k in kw:
            x = np.where(np.abs(np.abs(x) - abs(kw[k])) < 0.05, 0.7, x)
    x = np.where(np.abs(np.abs(x) - 3.0) < 0.05, 1.1, x).astype(np.float32)
    _fn_parity(lambda a: getattr(jF, name)(a, **kw),
               lambda a: getattr(tF, name)(a, **kw), [x])


def test_prelu_and_gelu_tanh():
    x, w = _arr((2, 3, 4)), np.array([0.1, 0.2, 0.3], np.float32)
    _fn_parity(jF.prelu, tF.prelu, [x, w])
    _fn_parity(lambda a: jF.gelu(a, True), lambda a: tF.gelu(a, True), [x])


def test_rrelu_inference_and_training_bounds():
    x = _arr((4, 50))
    _fn_parity(lambda a: jF.rrelu(a, training=False),
               lambda a: tF.rrelu(a, training=False), [x])
    out = tF.rrelu(_t(x), 0.1, 0.3, training=True).numpy()
    neg = x < 0
    slope = out[neg] / x[neg]
    assert (slope >= 0.1 - 1e-6).all() and (slope <= 0.3 + 1e-6).all()
    np.testing.assert_array_equal(out[~neg], x[~neg])


# ------------------------------------------------------------- losses ----
def _loss_cases():
    x, y = _arr((6, 5)), _arr((6, 5), 2)
    p, t = _probs((6, 5), 3), (np.random.default_rng(4).random((6, 5))
                               > 0.5).astype(np.float32)
    lab = np.random.default_rng(5).integers(0, 5, (6,)).astype(np.int64)
    sign = np.where(np.random.default_rng(6).random(6) > 0.5, 1.0,
                    -1.0).astype(np.float32)
    wcls = np.abs(_arr((5,), 7)) + 0.1
    lp = np.log(np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(
        np.float32)
    return {
        "mse": (lambda F, a, b: F.mse_loss(a, b), [x, y]),
        "l1_sum": (lambda F, a, b: F.l1_loss(a, b, "sum"), [x, y]),
        "smooth_l1": (lambda F, a, b: F.smooth_l1_loss(a, b, delta=0.7),
                      [x, y]),
        "bce": (lambda F, a, b: F.binary_cross_entropy(a, b), [p, t]),
        "bce_with_logits": (
            lambda F, a, b: F.binary_cross_entropy_with_logits(a, b),
            [x, t]),
        "kl_div_batchmean": (lambda F, a, b: F.kl_div(a, b, "batchmean"),
                             [lp, p / p.sum(1, keepdims=True)]),
        "margin_ranking": (lambda F, a, b, s: F.margin_ranking_loss(
            a, b, s, 0.3), [x[:, 0], y[:, 0], sign]),
        "hinge_embedding": (lambda F, a, s: F.hinge_embedding_loss(a, s),
                            [x[:, 0], sign]),
        "cosine_embedding": (lambda F, a, b, s: F.cosine_embedding_loss(
            a, b, s, 0.1), [x, y, sign]),
        "cosine_similarity": (lambda F, a, b: F.cosine_similarity(a, b),
                              [x, y]),
        "triplet_margin": (lambda F, a, b, c: F.triplet_margin_loss(
            a, b, c, swap=True), [x, y, _arr((6, 5), 8)]),
        "pairwise_distance": (lambda F, a, b: F.pairwise_distance(a, b),
                              [x, y]),
        "sigmoid_focal": (lambda F, a, b: F.sigmoid_focal_loss(a, b),
                          [x, t]),
        "log_loss": (lambda F, a, b: F.log_loss(a, b), [p, t]),
        "square_error_cost": (lambda F, a, b: F.square_error_cost(a, b),
                              [x, y]),
        "label_smooth": (lambda F, a: F.label_smooth(a, epsilon=0.2), [t]),
        "nll_weighted": (lambda F, a, w: F.nll_loss(
            a, (_j if F is jF else _t)(lab), w), [lp, wcls]),
        "cross_entropy_smoothing": (lambda F, a: F.cross_entropy(
            a, (_j if F is jF else _t)(lab), label_smoothing=0.1), [x]),
        "softmax_with_cross_entropy": (
            lambda F, a: F.softmax_with_cross_entropy(
                a, (_j if F is jF else _t)(lab[:, None])), [x]),
        "dice": (lambda F, a: F.dice_loss(
            a, (_j if F is jF else _t)(lab[:, None])), [p]),
        "npair": (lambda F, a, b: F.npair_loss(
            a, b, (_j if F is jF else _t)(lab.astype(np.float32))), [x, y]),
    }


LOSSES = _loss_cases()


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss(case):
    fn, arrays = LOSSES[case]
    grad = [i for i in range(len(arrays))
            if case not in ("hinge_embedding", "margin_ranking",
                            "cosine_embedding", "nll_weighted")
            or i < len(arrays) - 1]
    _fn_parity(lambda *a: fn(jF, *a), lambda *a: fn(tF, *a), arrays,
               grad=grad)


def test_ctc_loss_sum():
    T, B, C, L = 12, 2, 5, 4
    logits = _arr((T, B, C))
    lab = np.random.default_rng(3).integers(1, C, (B, L)).astype(np.int32)
    il, ll = np.array([12, 10], np.int64), np.array([4, 3], np.int64)
    _fn_parity(
        lambda a: jF.ctc_loss(a, _j(lab), _j(il), _j(ll), reduction="sum"),
        lambda a: tF.ctc_loss(a, _t(lab), _t(il), _t(ll), reduction="sum"),
        [logits])


# ------------------------------------------------------------- common ----
COMMON = {
    "interp_nearest_size": (lambda F, a: F.interpolate(a, size=(7, 9)),
                            (2, 3, 4, 5)),
    "interp_nearest_scale": (lambda F, a: F.interpolate(a, scale_factor=2),
                             (2, 3, 4, 5)),
    "interp_bilinear_up": (lambda F, a: F.interpolate(
        a, size=(8, 10), mode="bilinear"), (2, 3, 4, 5)),
    "pixel_shuffle": (lambda F, a: F.pixel_shuffle(a, 2), (2, 8, 3, 4)),
    "pixel_unshuffle": (lambda F, a: F.pixel_unshuffle(a, 2), (2, 2, 4, 6)),
    "channel_shuffle": (lambda F, a: F.channel_shuffle(a, 3), (2, 6, 3, 2)),
    "unfold": (lambda F, a: F.unfold(a, 3, 2, 1, 1), (2, 3, 7, 6)),
    "fold": (lambda F, a: F.fold(a, (5, 6), 2, 1, 0), (2, 12, 20)),
    "pad_full_form": (lambda F, a: F.pad(a, [0, 0, 1, 0, 2, 1, 0, 3]),
                      (2, 3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(COMMON))
def test_common_op(case):
    fn, shape = COMMON[case]
    _fn_parity(lambda a: fn(jF, a), lambda a: fn(tF, a), [_arr(shape)])


def test_one_hot():
    lab = np.array([[0, 3], [2, 1]])
    _close(tF.one_hot(_t(lab), 4), jF.one_hot(_j(lab), 4))


COMMON_LAYERS = {
    "Identity": (lambda m: m.Identity(3, foo=1), (2, 3)),
    "Flatten": (lambda m: m.Flatten(1, 2), (2, 3, 4, 5)),
    "Upsample": (lambda m: m.Upsample(scale_factor=2), (1, 2, 3, 4)),
    "UpsamplingNearest2D": (lambda m: m.UpsamplingNearest2D(size=(5, 7)),
                            (1, 2, 3, 4)),
    "PixelShuffle": (lambda m: m.PixelShuffle(2), (1, 8, 2, 3)),
    "PixelUnshuffle": (lambda m: m.PixelUnshuffle(2), (1, 2, 4, 6)),
    "ChannelShuffle": (lambda m: m.ChannelShuffle(2), (1, 6, 2, 3)),
    "Unfold": (lambda m: m.Unfold(2, 1, 1), (1, 2, 4, 4)),
    "Fold": (lambda m: m.Fold((4, 5), 2), (1, 8, 12)),
    "MaxPool2D": (lambda m: m.MaxPool2D(3, 2, 1), (2, 3, 7, 7)),
    "AvgPool2D": (lambda m: m.AvgPool2D(3, 2, 1), (2, 3, 7, 7)),
    "MaxPool1D": (lambda m: m.MaxPool1D(2), (2, 3, 8)),
    "AvgPool1D": (lambda m: m.AvgPool1D(2), (2, 3, 8)),
    "MaxPool3D": (lambda m: m.MaxPool3D(2), (1, 2, 4, 4, 4)),
    "AvgPool3D": (lambda m: m.AvgPool3D(2), (1, 2, 4, 4, 4)),
    "AdaptiveAvgPool1D": (lambda m: m.AdaptiveAvgPool1D(3), (2, 3, 8)),
    "AdaptiveAvgPool2D": (lambda m: m.AdaptiveAvgPool2D((1, 1)),
                          (2, 3, 5, 5)),
    "AdaptiveAvgPool3D": (lambda m: m.AdaptiveAvgPool3D(2),
                          (1, 2, 4, 4, 4)),
    "AdaptiveMaxPool2D": (lambda m: m.AdaptiveMaxPool2D(2), (2, 3, 5, 5)),
    "LocalResponseNorm": (lambda m: m.LocalResponseNorm(3), (2, 5, 3, 3)),
}


@pytest.mark.parametrize("name", sorted(COMMON_LAYERS))
def test_parameterless_layer(name):
    make, shape = COMMON_LAYERS[name]
    x = _arr(shape)
    _close(make(tnn)(_t(x)), make(jnn)(_j(x)))
