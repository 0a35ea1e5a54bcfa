"""The port's vision-path layers (conv, pooling, the norms, activations,
losses, the common layers and the containers) against the JAX package's,
with the reference's weights carried across by ``paddle_tpu_torch.convert``
and back by ``convert.state_to_paddle_tpu``. The functional ops are held
in ``test_torch_vision_functional.py`` and ``test_torch_vision_losses.py``.

Inputs: small float32 arrays from a seeded numpy generator. Outputs and
the gradients of ``sum(out * w)`` (``w`` fixed and random) with respect
to the inputs and every parameter are held to 1e-4 absolute and relative
(float32 in both frameworks, summed in another order), the running
statistics of the batch norms likewise. Dropout masks are random in both
packages and not reproduced across them: the port's are held to being a
function of the key.

Where the reference departs from Paddle the port follows Paddle; the
``test_reference_fault_*`` cases show both packages on such an input
(ROADMAP queue 3).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from vision_parity import (_arr, _close, _j, _layer_pair, _layer_parity, _np,
                           _probs, _state, _t)

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)


# ------------------------------------------------------------ exports ----
def test_nn_exports_every_reference_layer():
    from paddle_tpu.nn.layer import (activation, common, container, conv,
                                     loss, norm, pooling)

    for mod in (activation, common, container, conv, loss, norm, pooling):
        missing = [n for n in mod.__all__ if not hasattr(tnn, n)]
        assert not missing, (mod.__name__, missing)


def test_functional_exports_the_reference_ops_of_the_vision_path():
    from paddle_tpu.ops import activation

    want = list(activation.__all__) + [
        "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
        "conv3d_transpose", "max_pool1d", "max_pool2d", "max_pool3d",
        "avg_pool1d", "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
        "adaptive_avg_pool2d", "adaptive_avg_pool3d", "adaptive_max_pool2d",
        "batch_norm", "layer_norm", "instance_norm", "group_norm",
        "rms_norm", "local_response_norm", "normalize", "dropout",
        "dropout2d", "dropout3d", "alpha_dropout", "one_hot", "interpolate",
        "upsample", "pixel_shuffle", "pixel_unshuffle", "channel_shuffle",
        "unfold", "fold", "pad", "cross_entropy", "mse_loss", "l1_loss",
        "nll_loss", "binary_cross_entropy",
        "binary_cross_entropy_with_logits", "smooth_l1_loss", "kl_div",
        "margin_ranking_loss", "hinge_embedding_loss", "cosine_similarity",
        "cosine_embedding_loss", "triplet_margin_loss", "ctc_loss"]
    assert [n for n in want if not hasattr(tF, n)] == []


# ------------------------------------------------------------- layers ----
LAYERS = {
    "Conv1D": (lambda m: m.Conv1D(4, 6, 3, stride=2, padding=1, groups=2),
               (2, 4, 9)),
    "Conv2D": (lambda m: m.Conv2D(4, 6, (3, 2), padding="SAME", stride=2),
               (2, 4, 7, 6)),
    "Conv2D_nobias_nhwc": (lambda m: m.Conv2D(4, 6, 3, padding=1,
                                              bias_attr=False,
                                              data_format="NHWC"),
                           (2, 5, 5, 4)),
    "Conv3D": (lambda m: m.Conv3D(2, 4, 2, padding=1), (1, 2, 3, 4, 3)),
    "Conv1DTranspose": (lambda m: m.Conv1DTranspose(4, 6, 3, stride=2),
                        (2, 4, 5)),
    "Conv2DTranspose": (lambda m: m.Conv2DTranspose(
        4, 6, 3, stride=2, padding=1, output_padding=1, groups=2),
        (2, 4, 4, 5)),
    "Conv3DTranspose": (lambda m: m.Conv3DTranspose(2, 4, 2, stride=2),
                        (1, 2, 2, 3, 2)),
    "PReLU": (lambda m: m.PReLU(3, 0.1), (2, 3, 4)),
    "GroupNorm": (lambda m: m.GroupNorm(2, 4), (2, 4, 3, 3)),
    "InstanceNorm2D": (lambda m: m.InstanceNorm2D(4), (2, 4, 3, 3)),
    "InstanceNorm1D": (lambda m: m.InstanceNorm1D(4), (2, 4, 7)),
    "RMSNorm": (lambda m: m.RMSNorm(6), (2, 3, 6)),
    "LayerNorm": (lambda m: m.LayerNorm(6), (2, 3, 6)),
    "Bilinear": (lambda m: m.Bilinear(3, 4, 5), None),
    "BatchNorm2D_eval": (lambda m: m.BatchNorm2D(4), (3, 4, 3, 3)),
    "BatchNorm1D_eval": (lambda m: m.BatchNorm1D(4), (3, 4)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_with_parameters_and_convert_round_trip(case):
    make, shape = LAYERS[case]
    jm, tm = _layer_pair(lambda: make(jnn), lambda: make(tnn))
    if case.endswith("_eval"):
        jm.eval()
        tm.eval()
    if case == "Bilinear":
        _layer_parity(jm, tm, [_arr((4, 3)), _arr((4, 4), 2)], grad=(0, 1))
    else:
        _layer_parity(jm, tm, [_arr(shape)])
    back = convert.state_to_paddle_tpu(tm)
    want = _state(jm)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(_np(back[k]), v, err_msg=k)


ACT_LAYERS = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Silu", "Swish", "Softmax",
              "LogSoftmax", "Tanh", "LeakyReLU", "ELU", "SELU", "CELU",
              "Softplus", "Softsign", "Mish", "Hardshrink", "Hardsigmoid",
              "Hardswish", "Hardtanh", "Softshrink", "Tanhshrink",
              "ThresholdedReLU", "LogSigmoid", "GLU"]


@pytest.mark.parametrize("name", ACT_LAYERS)
def test_activation_layer(name):
    x = _arr((2, 4, 6), scale=2.0)
    x = np.where(np.abs(x) < 0.05, 0.5, x).astype(np.float32)
    _close(getattr(tnn, name)()(_t(x)), getattr(jnn, name)()(_j(x)))


def test_activation_layer_arguments():
    x = _arr((2, 4, 6), scale=2.0)
    for j, t in [(jnn.LeakyReLU(0.3), tnn.LeakyReLU(0.3)),
                 (jnn.Softmax(1), tnn.Softmax(axis=1)),
                 (jnn.Maxout(2), tnn.Maxout(2)),
                 (jnn.Hardtanh(-0.5, 0.5), tnn.Hardtanh(-0.5, 0.5)),
                 (jnn.GLU(1), tnn.GLU(1)),
                 (jnn.SELU(1.1, 1.5), tnn.SELU(1.1, 1.5))]:
        _close(t(_t(x)), j(_j(x)), type(t).__name__)


LOSS_LAYERS = {
    "CrossEntropyLoss": (lambda m: m.CrossEntropyLoss(), "logits_label"),
    "MSELoss": (lambda m: m.MSELoss(), "xy"),
    "L1Loss": (lambda m: m.L1Loss("sum"), "xy"),
    "NLLLoss": (lambda m: m.NLLLoss(), "logp_label"),
    "BCELoss": (lambda m: m.BCELoss(), "p_t"),
    "BCEWithLogitsLoss": (lambda m: m.BCEWithLogitsLoss(), "x_t"),
    "SmoothL1Loss": (lambda m: m.SmoothL1Loss(delta=0.5), "xy"),
    "KLDivLoss": (lambda m: m.KLDivLoss("sum"), "logp_p"),
    "MarginRankingLoss": (lambda m: m.MarginRankingLoss(0.2), "a_b_sign"),
    "HingeEmbeddingLoss": (lambda m: m.HingeEmbeddingLoss(0.5), "a_sign"),
    "CosineEmbeddingLoss": (lambda m: m.CosineEmbeddingLoss(0.1),
                            "x_y_sign"),
    "TripletMarginLoss": (lambda m: m.TripletMarginLoss(0.5), "xyz"),
}


@pytest.mark.parametrize("name", sorted(LOSS_LAYERS))
def test_loss_layer(name):
    make, kind = LOSS_LAYERS[name]
    x, y, z = _arr((6, 5)), _arr((6, 5), 2), _arr((6, 5), 3)
    lab = np.random.default_rng(5).integers(0, 5, (6,)).astype(np.int64)
    sign = np.where(np.random.default_rng(6).random(6) > 0.5, 1.0,
                    -1.0).astype(np.float32)
    p = _probs((6, 5), 4)
    t = (p > 0.5).astype(np.float32)
    lp = x - np.log(np.exp(x).sum(1, keepdims=True)).astype(np.float32)
    args = {"logits_label": [x, lab], "xy": [x, y], "logp_label": [lp, lab],
            "p_t": [p, t], "x_t": [x, t],
            "logp_p": [lp, p / p.sum(1, keepdims=True)],
            "a_b_sign": [x[:, 0], y[:, 0], sign], "a_sign": [x[:, 0], sign],
            "x_y_sign": [x, y, sign], "xyz": [x, y, z]}[kind]
    grad = tuple(i for i, a in enumerate(args) if a.dtype == np.float32
                 and a is not sign and a is not t and kind != "logp_p")
    _layer_parity(make(jnn), make(tnn), args, grad=grad or (0,))


def test_ctc_loss_layer():
    T, B, C = 10, 2, 4
    logp = torch.log_softmax(torch.from_numpy(_arr((T, B, C))), -1)
    lab = torch.tensor([[1, 2, 3], [2, 2, 0]])
    il, ll = torch.tensor([10, 8]), torch.tensor([3, 2])
    got = tnn.CTCLoss(reduction="none")(logp, lab, il, ll)
    want = jnn.CTCLoss(reduction="none")(_j(logp.numpy()), _j(lab.numpy()),
                                         _j(il.numpy()), _j(ll.numpy()))
    _close(got, want)


def test_cosine_similarity_layer_and_pads():
    x, y = _arr((3, 4, 2)), _arr((3, 4, 2), 2)
    _close(tnn.CosineSimilarity(2)(_t(x), _t(y)),
           jnn.CosineSimilarity(2)(_j(x), _j(y)))
    z = _arr((2, 3, 4, 5))
    # the full form (every dimension's pair) is the same in both packages
    _close(tnn.Pad2D([0, 0, 0, 0, 1, 2, 3, 0])(_t(z)),
           jnn.Pad2D([0, 0, 0, 0, 1, 2, 3, 0])(_j(z)))
    assert tnn.Pad1D(2)(_t(z[0])).shape == (3, 4, 9)
    assert tnn.Pad3D([1, 0, 0, 2, 1, 1])(_t(z)[None]).shape == (1, 2, 5, 6,
                                                               6)


def test_dropout_layers_follow_keys_and_eval():
    from paddle_tpu_torch.nn.layer.common import DropoutKeys

    seq = tnn.Sequential(tnn.Dropout2D(0.5), tnn.AlphaDropout(0.3),
                         tnn.Dropout3D(0.2))
    keys = DropoutKeys(torch.Generator().manual_seed(0))
    keys.attach(seq)
    assert [m.site for m in seq] == [0, 1, 2]
    x = torch.randn(4, 6, 3, 3)
    keys.draw("cpu")
    a = seq[0](x)
    assert torch.equal(a, seq[0](x))
    seq.eval()
    assert torch.equal(seq[0](x), x) and torch.equal(seq[1](x), x)


# --------------------------------------------------------- containers ----
def test_sequential_names_and_slices():
    from collections import OrderedDict

    a, b = tnn.ReLU(), tnn.Linear(2, 3)
    s = tnn.Sequential(a, b)
    assert list(dict(s.named_children())) == ["0", "1"]
    s2 = tnn.Sequential(("act", a), ("fc", b))
    assert list(dict(s2.named_children())) == ["act", "fc"]
    s3 = tnn.Sequential(OrderedDict([("x", a), ("y", b)]))
    assert list(dict(s3.named_children())) == ["x", "y"]
    sl = s2[1:]
    assert isinstance(sl, tnn.Sequential) and sl[0] is b
    assert list(dict(sl.named_children())) == ["0"]
    assert s2(torch.ones(1, 2)).shape == (1, 3)
    assert list(dict(s.state_dict())) == list(dict(
        jnn.Sequential(jnn.ReLU(), jnn.Linear(2, 3)).state_dict()))


def test_layer_dict_and_parameter_list():
    d = tnn.LayerDict({"a": tnn.ReLU()})
    d["b"] = tnn.Tanh()
    assert list(d.keys()) == ["a", "b"] and "a" in d and len(d) == 2
    d.update([("c", tnn.Sigmoid())])
    assert isinstance(d.pop("c"), tnn.Sigmoid)
    pl = tnn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    assert pl.append(torch.nn.Parameter(torch.zeros(3))) is pl
    assert len(pl) == 2 and [p.shape[0] for p in pl] == [2, 3]
    assert list(dict(pl.named_parameters())) == ["0", "1"]


# ------------------------------------------- the reference's departures --
def test_reference_fault_pool_ceil_mode():
    """The reference's pools drop ``ceil_mode``; the port's keep the last
    partial window, as Paddle does."""
    x = _arr((1, 1, 7, 7))
    ref = jF.max_pool2d(_j(x), 2, 2, ceil_mode=True)
    got = tF.max_pool2d(_t(x), 2, 2, ceil_mode=True)
    assert tuple(ref.shape) == (1, 1, 3, 3)
    assert tuple(got.shape) == (1, 1, 4, 4)
    _close(got[..., :3, :3], ref)


def test_reference_fault_pool_layers_drop_arguments():
    """The reference's pool layers drop ``exclusive``, ``data_format`` and
    ``divisor_override``; the port's pass them on."""
    x = _arr((1, 2, 5, 5))
    ref = jnn.AvgPool2D(3, 2, 1, exclusive=False)(_j(x))
    got = tnn.AvgPool2D(3, 2, 1, exclusive=False)(_t(x))
    want = tF.avg_pool2d(_t(x), 3, 2, 1, exclusive=False)
    _close(got, want)
    _close(ref, tF.avg_pool2d(_t(x), 3, 2, 1, exclusive=True))
    assert not np.allclose(_np(got), _np(ref))
    got = tnn.AvgPool2D(2, divisor_override=1)(_t(x))
    _close(got, tF.avg_pool2d(_t(x), 2) * 4)
    xh = x.transpose(0, 2, 3, 1)
    got = tnn.MaxPool2D(2, data_format="NHWC")(_t(xh))
    _close(got, tF.max_pool2d(_t(x), 2).permute(0, 2, 3, 1))


def test_reference_fault_adaptive_pool_layout_and_mask():
    """The reference's adaptive pools pool dimensions 2.. whatever
    ``data_format`` says, and ``adaptive_max_pool2d`` drops
    ``return_mask``."""
    x = _arr((2, 6, 4, 3))  # NHWC: 6 x 4 positions, 3 channels
    ref = jF.adaptive_avg_pool2d(_j(x), 2, data_format="NHWC")
    got = tF.adaptive_avg_pool2d(_t(x), 2, data_format="NHWC")
    assert tuple(ref.shape) == (2, 6, 2, 2)
    assert tuple(got.shape) == (2, 2, 2, 3)
    _close(got, tF.adaptive_avg_pool2d(_t(x).permute(0, 3, 1, 2), 2)
           .permute(0, 2, 3, 1))
    out, mask = tF.adaptive_max_pool2d(_t(x), 2, return_mask=True)
    assert mask.dtype == torch.int64 and mask.shape == out.shape
    assert not isinstance(jF.adaptive_max_pool2d(_j(x), 2, return_mask=True),
                          tuple)


def test_reference_fault_pad_short_form_order():
    """Paddle's short form pads the last dimension by the first pair
    (``[left, right, top, bottom]``); the reference pads the first
    spatial dimension by it."""
    x = _arr((1, 1, 2, 3))
    got = tF.pad(_t(x), [1, 0, 0, 2])
    ref = jF.pad(_j(x), [1, 0, 0, 2])
    assert tuple(got.shape) == (1, 1, 4, 4)
    assert tuple(ref.shape) == (1, 1, 3, 5)
    _close(got, torch.nn.functional.pad(_t(x), [1, 0, 0, 2]))


def test_reference_fault_interpolate():
    """The reference resizes the linear and cubic modes with
    ``jax.image.resize``, which antialiases when it shrinks, ignores
    ``align_corners`` and takes another cubic kernel; the port resizes as
    Paddle does."""
    x = _arr((1, 1, 8, 8))
    ref = jF.interpolate(_j(x), size=(3, 3), mode="bilinear")
    got = tF.interpolate(_t(x), size=(3, 3), mode="bilinear")
    want = torch.nn.functional.interpolate(_t(x), size=(3, 3),
                                           mode="bilinear")
    _close(got, want)
    assert not np.allclose(_np(got), _np(ref), atol=1e-3)
    up = tF.interpolate(_t(x[..., :3, :3]), size=(5, 5), mode="bilinear",
                        align_corners=True)
    _close(up[..., ::2, ::2], x[..., :3, :3])
    # bicubic: Paddle's and torch's kernel (a = -0.75); jax.image.resize's
    # is Keys' a = -0.5
    got = tF.upsample(_t(x), scale_factor=2, mode="bicubic")
    _close(got, torch.nn.functional.interpolate(_t(x), scale_factor=2,
                                                mode="bicubic"))
    ref = jF.upsample(_j(x), scale_factor=2, mode="bicubic")
    assert not np.allclose(_np(got), _np(ref), atol=1e-3)


def test_reference_fault_bce_with_logits_pos_weight():
    """Paddle weighs only the positive term by ``pos_weight``; the
    reference weighs the whole loss, which differs for a soft label."""
    z = _arr((4, 3))
    y = np.random.default_rng(2).random((4, 3)).astype(np.float32)
    pw = np.array([2.0, 0.5, 3.0], np.float32)
    got = tF.binary_cross_entropy_with_logits(_t(z), _t(y),
                                              pos_weight=_t(pw),
                                              reduction="none")
    sig = 1 / (1 + np.exp(-z))
    want = -(pw * y * np.log(sig) + (1 - y) * np.log(1 - sig))
    _close(got, want)
    ref = jF.binary_cross_entropy_with_logits(_j(z), _j(y),
                                              pos_weight=_j(pw),
                                              reduction="none")
    assert not np.allclose(_np(ref), want, atol=1e-3)


def test_reference_fault_ctc_mean_divides_by_label_length():
    """Paddle's ``"mean"`` divides each sequence's loss by its label
    length before the mean; the reference takes the plain mean."""
    T, B, C = 10, 2, 4
    logits = _arr((T, B, C))
    lab = np.array([[1, 2, 3], [2, 1, 0]], np.int32)
    il, ll = np.array([10, 8]), np.array([3, 2])
    per = tF.ctc_loss(_t(logits), _t(lab), _t(il), _t(ll),
                      reduction="none")
    got = tF.ctc_loss(_t(logits), _t(lab), _t(il), _t(ll))
    _close(got, (per / _t(ll).float()).mean())
    ref = jF.ctc_loss(_j(logits), _j(lab), _j(il), _j(ll))
    _close(ref, per.mean())


def test_reference_fault_conv_padding_mode():
    """The reference's conv layers drop ``padding_mode``; the port pads by
    it, as Paddle does."""
    jm, tm = _layer_pair(lambda: jnn.Conv2D(2, 3, 3, padding=1,
                                            padding_mode="reflect"),
                         lambda: tnn.Conv2D(2, 3, 3, padding=1,
                                            padding_mode="reflect"))
    x = _arr((1, 2, 5, 5))
    got = tm(_t(x))
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(_t(x), [1, 1, 1, 1], mode="reflect"),
        tm.weight, tm.bias)
    _close(got, want)
    assert not np.allclose(_np(jm(_j(x))), _np(got), atol=1e-3)


# ------------------------------------------------------------------ amp ----
def test_o1_casts_conv_to_bf16_and_keeps_batch_norm_in_float32():
    """The vision ops reach the torch calls ``auto_cast``'s lists name:
    under O1 a convolution (white list) runs in bf16 and a batch norm
    (black list) in float32, as the reference's plan has them."""
    from paddle_tpu_torch.amp import auto_cast

    conv, bn = tnn.Conv2D(3, 4, 3, padding=1), tnn.BatchNorm2D(4)
    fc = tnn.Linear(4, 2)
    x = torch.randn(2, 3, 5, 5)
    with auto_cast(level="O1"):
        h = conv(x)
        y = bn(h)
        p = tF.adaptive_avg_pool2d(tF.relu(y), 1).flatten(1)
        out = fc(p)
        loss = tF.cross_entropy(out, torch.tensor([0, 1]))
    assert h.dtype == torch.bfloat16
    assert y.dtype == torch.float32 and bn._mean.dtype == torch.float32
    assert out.dtype == torch.bfloat16 and loss.dtype == torch.float32
    loss.backward()
    assert conv.weight.grad.dtype == torch.float32
    assert bn._mean.abs().sum() > 0  # updated in place under the cast
