"""The port's sampling grids, temporal shift, max pools with indices and
max unpools (``paddle_tpu_torch.nn.functional``) against the JAX
package's: ``affine_grid`` and ``grid_sample`` (both corner conventions),
``temporal_shift`` (and its channels-last form), ``max_pool2d/3d_with_
index`` (the flat indices equal) and ``max_unpool1d/2d/3d``.

Inputs: small float32 arrays from a seeded numpy generator; values and
gradients are held to 1e-5 absolute and relative, indices are equal. The
reference fault of ``grid_sample``'s modes (ROADMAP queue 3) runs both
packages.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu.nn.functional as jF  # noqa: E402
from functional_parity import (_arr, _close, _equal, _j, _np,  # noqa: E402
                               _parity, _t)
from paddle_tpu_torch.nn import functional as tF  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)


# ------------------------------------------------------ sampling grids --
@pytest.mark.parametrize("align_corners", [True, False])
def test_affine_grid_and_grid_sample(align_corners):
    theta = np.array([[[0.9, 0.2, 0.1], [-0.1, 1.1, -0.2]],
                      [[1.2, 0.0, 0.3], [0.3, 0.8, 0.0]]], np.float32)
    grid = _parity(
        lambda t: jF.affine_grid(t, [2, 3, 5, 7], align_corners),
        lambda t: tF.affine_grid(t, [2, 3, 5, 7], align_corners), [theta])
    _parity(lambda x, g: jF.grid_sample(x, g, align_corners=align_corners),
            lambda x, g: tF.grid_sample(x, g, align_corners=align_corners),
            [_arr((2, 3, 6, 8)), _np(grid) * 1.2])


def test_reference_fault_grid_sample_modes():
    """Paddle's ``mode="nearest"`` and ``padding_mode="border"``: the
    reference samples bilinearly with zero padding whatever they say."""
    x = _arr((1, 2, 5, 6))
    grid = np.random.default_rng(3).uniform(-1.4, 1.4, (1, 4, 4, 2)) \
        .astype(np.float32)
    plain = tF.grid_sample(_t(x), _t(grid))
    near = tF.grid_sample(_t(x), _t(grid), mode="nearest")
    # nearest: every output is one of the input's values
    assert np.isin(_np(near)[_np(near) != 0], x).all()
    border = tF.grid_sample(_t(x), _t(grid), padding_mode="border")
    outside = (np.abs(grid) > 1).any(-1)[0]
    assert (_np(border)[0][:, outside] != _np(plain)[0][:, outside]).any()
    ref = jF.grid_sample(_j(x), _j(grid))
    _close(ref, plain)
    for kw in (dict(mode="nearest"), dict(padding_mode="border")):
        _equal(jF.grid_sample(_j(x), _j(grid), **kw), ref)
    with pytest.raises(ValueError, match="mode"):
        tF.grid_sample(_t(x), _t(grid), mode="bicubic_typo")


@pytest.mark.parametrize("ratio", [0.25, 0.125])
def test_temporal_shift(ratio):
    x = _arr((6, 8, 3, 2))
    out = _parity(lambda a: jF.temporal_shift(a, 3, ratio),
                  lambda a: tF.temporal_shift(a, 3, ratio), [x])
    nhwc = tF.temporal_shift(_t(x.transpose(0, 2, 3, 1)), 3, ratio,
                             data_format="NHWC")
    _equal(nhwc, _np(out).transpose(0, 2, 3, 1))


# ------------------------------------------------ pools with indices ----
@pytest.mark.parametrize("n,kw", [
    (2, dict(kernel_size=3, stride=2, padding=1)),
    (2, dict(kernel_size=2)),
    (3, dict(kernel_size=2, stride=2, padding=1))])
def test_max_pool_with_index_and_unpool(n, kw):
    x = _arr((2, 3) + ((7, 6) if n == 2 else (4, 5, 4)))
    jpool = getattr(jF, f"max_pool{n}d_with_index")
    tpool = getattr(tF, f"max_pool{n}d_with_index")
    jo, ji = jpool(_j(x), **kw)
    tx = _t(x, True)
    to, ti = tpool(tx, **kw)
    _close(to, jo)
    assert ti.dtype == torch.int32
    _equal(ti, ji)
    to.sum().backward()
    assert float(tx.grad.sum()) == to.numel()
    unpool_kw = dict(kernel_size=kw["kernel_size"], stride=kw.get("stride"),
                     padding=kw.get("padding", 0))
    ju = getattr(jF, f"max_unpool{n}d")(jo, ji, **unpool_kw)
    tu = getattr(tF, f"max_unpool{n}d")(to, ti, **unpool_kw)
    _close(tu, ju)


def test_max_unpool1d():
    x = _arr((2, 3, 5))
    idx = np.array([[[0, 3, 4, 6, 9]] * 3] * 2, np.int32)
    for out_size in (None, [2, 3, 10]):
        kw = dict(kernel_size=2, output_size=out_size)
        _close(tF.max_unpool1d(_t(x), _t(idx), **kw),
               jF.max_unpool1d(_j(x), _j(idx), **kw))
    with pytest.raises(ValueError, match="data_format"):
        tF.max_unpool1d(_t(x), _t(idx), 2, data_format="NLC")
