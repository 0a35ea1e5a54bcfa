"""The port's convolutions, pools and dropouts
(``paddle_tpu_torch.nn.functional``) against the JAX package's: every
padding form of ``normalize_conv_padding``, groups, dilation, channels-last
layouts, transposed convolutions and pools with padding.

Inputs: small float32 arrays from a seeded numpy generator. Outputs and
the gradients of ``sum(out * w)`` (``w`` fixed and random) with respect
to the inputs and every parameter are held to 1e-4 absolute and relative
(float32 in both frameworks, summed in another order). Dropout masks are
random in both packages and not reproduced across them: the port's are
held to their structure (whole channels, the scale, SELU's moments) and to
being a function of the key.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu.nn.functional as jF  # noqa: E402
from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from paddle_tpu_torch.ops.counter_rng import new_key  # noqa: E402
from vision_parity import _arr, _close, _fn_parity, _j, _np, _t  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)


# --------------------------------------------------------------- conv ----
CONV2D = {
    "int": dict(padding=1),
    "per_dim": dict(padding=[1, 2]),
    "lo_hi_flat": dict(padding=[1, 0, 2, 1]),
    "pairs": dict(padding=[(1, 0), (2, 1)]),
    "full_rank_pairs": dict(padding=[(0, 0), (0, 0), (1, 0), (2, 1)]),
    "same_stride1": dict(padding="SAME"),
    "same_stride2": dict(padding="SAME", stride=2),
    "same_stride3_odd": dict(padding="same", stride=3),
    "valid_stride2": dict(padding="VALID", stride=2),
    "asym_stride2": dict(padding=[0, 1, 1, 0], stride=2),
    "groups": dict(padding=1, groups=2),
    "dilation": dict(padding=2, dilation=2),
    "groups_dilation_stride": dict(padding=[2, 1], dilation=(2, 1),
                                   stride=(2, 1), groups=2),
}


@pytest.mark.parametrize("case", sorted(CONV2D))
def test_conv2d(case):
    kw = CONV2D[case]
    g = kw.get("groups", 1)
    x, w, b = _arr((2, 4, 9, 8)), _arr((6, 4 // g, 3, 3), 2), _arr((6,), 3)
    _fn_parity(lambda *a: jF.conv2d(*a, **kw), lambda *a: tF.conv2d(*a, **kw),
               [x, w, b])


@pytest.mark.parametrize("padding", [1, [(0, 0), (1, 0), (2, 1), (0, 0)],
                                     "SAME"])
def test_conv2d_nhwc(padding):
    x, w, b = _arr((2, 9, 8, 4)), _arr((6, 4, 3, 3), 2), _arr((6,), 3)
    kw = dict(padding=padding, stride=2, data_format="NHWC")
    _fn_parity(lambda *a: jF.conv2d(*a, **kw), lambda *a: tF.conv2d(*a, **kw),
               [x, w, b])


@pytest.mark.parametrize("n,fmt", [(1, "NCL"), (1, "NLC"), (3, "NCDHW"),
                                   (3, "NDHWC")])
def test_conv1d_conv3d(n, fmt):
    sp = (9,) if n == 1 else (5, 6, 4)
    x = _arr((2, *sp, 4) if fmt.endswith("C") else (2, 4, *sp))
    w, b = _arr((6, 2) + (3,) * n, 2), _arr((6,), 3)
    kw = dict(padding=1, stride=2, groups=2, data_format=fmt)
    jfn, tfn = (jF.conv1d, tF.conv1d) if n == 1 else (jF.conv3d, tF.conv3d)
    _fn_parity(lambda *a: jfn(*a, **kw), lambda *a: tfn(*a, **kw), [x, w, b])


CONVT = {
    "2d_stride2": (2, dict(stride=2, padding=1)),
    "2d_output_padding": (2, dict(stride=2, padding=1, output_padding=1)),
    "2d_groups_dilation": (2, dict(stride=1, padding=[1, 2], groups=2,
                                   dilation=2)),
    "1d": (1, dict(stride=3, padding=2, output_padding=1)),
    "3d": (3, dict(stride=2, padding=1, groups=2)),
    "2d_nhwc": (2, dict(stride=2, padding=1, data_format="NHWC")),
}


@pytest.mark.parametrize("case", sorted(CONVT))
def test_conv_transpose(case):
    n, kw = CONVT[case]
    g = kw.get("groups", 1)
    sp = {1: (7,), 2: (5, 6), 3: (3, 4, 3)}[n]
    x = _arr((2, *sp, 4) if kw.get("data_format") == "NHWC"
             else (2, 4, *sp))
    w, b = _arr((4, 6 // g) + (3,) * n, 2), _arr((6,), 3)
    jfn = getattr(jF, f"conv{n}d_transpose")
    tfn = getattr(tF, f"conv{n}d_transpose")
    _fn_parity(lambda *a: jfn(*a, **kw), lambda *a: tfn(*a, **kw), [x, w, b])


def test_reference_fault_conv_transpose_output_size():
    """Paddle's ``output_size`` sets the output padding that reaches it;
    the reference drops it."""
    x, w = _arr((1, 4, 5, 5)), _arr((4, 3, 3, 3), 2)
    t = tF.conv2d_transpose(_t(x), _t(w), stride=2, padding=1,
                            output_size=[10, 10])
    ref = tF.conv2d_transpose(_t(x), _t(w), stride=2, padding=1,
                              output_padding=1)
    assert t.shape == (1, 3, 10, 10)
    _close(t, ref)
    j = jF.conv2d_transpose(_j(x), _j(w), stride=2, padding=1,
                            output_size=[10, 10])
    assert tuple(j.shape) == (1, 3, 9, 9)


# ------------------------------------------------------------ pooling ----
POOLS = {
    "max_pad1_stride2": (jF.max_pool2d, tF.max_pool2d,
                         dict(kernel_size=3, stride=2, padding=1)),
    "max_same": (jF.max_pool2d, tF.max_pool2d,
                 dict(kernel_size=3, stride=2, padding="SAME")),
    "max_pad_wider_than_half": (jF.max_pool2d, tF.max_pool2d,
                                dict(kernel_size=2, stride=1, padding=2)),
    "max_nhwc": (jF.max_pool2d, tF.max_pool2d,
                 dict(kernel_size=2, stride=2, data_format="NHWC")),
    "avg_exclusive_pad": (jF.avg_pool2d, tF.avg_pool2d,
                          dict(kernel_size=3, stride=2, padding=1)),
    "avg_inclusive_pad": (jF.avg_pool2d, tF.avg_pool2d,
                          dict(kernel_size=3, stride=2, padding=1,
                               exclusive=False)),
    "avg_valid": (jF.avg_pool2d, tF.avg_pool2d,
                  dict(kernel_size=2, stride=2, padding="VALID")),
    "avg_nhwc": (jF.avg_pool2d, tF.avg_pool2d,
                 dict(kernel_size=2, data_format="NHWC")),
    "max1d": (jF.max_pool1d, tF.max_pool1d,
              dict(kernel_size=3, stride=2, padding=1)),
    "avg1d": (jF.avg_pool1d, tF.avg_pool1d,
              dict(kernel_size=3, stride=2, padding=1)),
    "max3d": (jF.max_pool3d, tF.max_pool3d,
              dict(kernel_size=2, stride=2, padding=1)),
    "avg3d": (jF.avg_pool3d, tF.avg_pool3d,
              dict(kernel_size=2, stride=1, padding=1)),
    "adaptive_avg_divisible": (jF.adaptive_avg_pool2d,
                               tF.adaptive_avg_pool2d,
                               dict(output_size=(4, 2))),
    "adaptive_avg_uneven": (jF.adaptive_avg_pool2d, tF.adaptive_avg_pool2d,
                            dict(output_size=3)),
    "adaptive_max_uneven": (jF.adaptive_max_pool2d, tF.adaptive_max_pool2d,
                            dict(output_size=(3, 5))),
    "adaptive_avg1d": (jF.adaptive_avg_pool1d, tF.adaptive_avg_pool1d,
                       dict(output_size=3)),
    "adaptive_avg3d": (jF.adaptive_avg_pool3d, tF.adaptive_avg_pool3d,
                       dict(output_size=2)),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_pool(case):
    jfn, tfn, kw = POOLS[case]
    shape = (2, 3, 8, 8)
    if "1d" in case:
        shape = (2, 3, 9)
    elif "3d" in case:
        shape = (1, 2, 5, 4, 6)
    elif kw.get("data_format") == "NHWC":
        shape = (2, 8, 8, 3)
    _fn_parity(lambda x: jfn(x, **kw), lambda x: tfn(x, **kw), [_arr(shape)])


def test_max_pool_return_mask():
    x = _arr((2, 3, 7, 7))
    jo, jm = jF.max_pool2d(_j(x), 3, 2, 1, return_mask=True)
    to, tm = tF.max_pool2d(_t(x), 3, 2, 1, return_mask=True)
    _close(to, jo)
    np.testing.assert_array_equal(_np(tm), _np(jm))


def test_dropout2d_drops_whole_channels_and_scales():
    x = torch.from_numpy(np.abs(_arr((8, 16, 3, 3))) + 0.1)
    key = new_key("cpu", torch.Generator().manual_seed(0))
    out = tF.dropout2d(x, 0.5, key=key)
    per_ch = (out == 0).flatten(2)
    assert (per_ch.all(-1) | (~per_ch).all(-1)).all()
    kept = per_ch[..., 0] == 0
    assert 0.3 < kept.float().mean() < 0.7
    torch.testing.assert_close(out[kept], (x * 2)[kept])
    torch.testing.assert_close(tF.dropout2d(x, 0.5, key=key), out)
    assert torch.equal(tF.dropout2d(x, 0.5, training=False), x)
    out3 = tF.dropout3d(x[..., None], 0.5, key=key)
    assert ((out3 == 0).flatten(2).all(-1)
            | (out3 != 0).flatten(2).all(-1)).all()


def test_alpha_dropout_keeps_moments():
    x = torch.randn(200, 500, generator=torch.Generator().manual_seed(0))
    key = new_key("cpu", torch.Generator().manual_seed(1))
    out = tF.alpha_dropout(tF.selu(x), 0.2, key=key)
    ref = tF.selu(x)
    assert abs(out.mean() - ref.mean()) < 0.02
    assert abs(out.std() - ref.std()) < 0.02
    assert torch.equal(out, tF.alpha_dropout(tF.selu(x), 0.2, key=key))
