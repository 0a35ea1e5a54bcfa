"""The port's normalisations against the JAX package's: the functional
batch, instance, group, layer, RMS and local-response norms and
``normalize``; the batch-norm layers' running statistics after two
updates in every layout, ``use_global_stats``, one value per channel,
``convert_sync_batchnorm`` and ``SpectralNorm``.

Inputs: small float32 arrays from a seeded numpy generator. Outputs, the
running statistics and the gradients of ``sum(out * w)`` (``w`` fixed and
random) with respect to the inputs and every parameter are held to 1e-4
absolute and relative (float32 in both frameworks, summed in another
order); bf16 statistics against float32's to 0.02 (bf16's rounding of the
output).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from vision_parity import (_arr, _close, _fn_parity, _j,  # noqa: E402
                           _layer_pair, _layer_parity, _t)

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)


# -------------------------------------------------------------- norms ----
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_train_two_updates_then_eval(fmt):
    C = 4
    x1, x2 = _arr((3, C, 5, 4)), _arr((3, C, 5, 4), 5, 2.0)
    if fmt == "NHWC":
        x1, x2 = x1.transpose(0, 2, 3, 1), x2.transpose(0, 2, 3, 1)
    w, b = _arr((C,), 2), _arr((C,), 3)
    jrm, jrv = _j(np.zeros(C, np.float32)), _j(np.ones(C, np.float32))
    trm, trv = torch.zeros(C), torch.ones(C)
    for x in (x1, x2):
        _fn_parity(
            lambda a, ww, bb: jF.batch_norm(a, jrm, jrv, ww, bb, True,
                                            data_format=fmt),
            lambda a, ww, bb: tF.batch_norm(a, trm, trv, ww, bb, True,
                                            data_format=fmt),
            [x, w, b])
    _close(trm, jrm, "running mean")
    _close(trv, jrv, "running variance")
    _fn_parity(lambda a, ww, bb: jF.batch_norm(a, jrm, jrv, ww, bb, False,
                                               data_format=fmt),
               lambda a, ww, bb: tF.batch_norm(a, trm, trv, ww, bb, False,
                                               data_format=fmt),
               [x1, w, b])


def test_batch_norm_use_global_stats():
    C = 3
    rm, rv = _arr((C,), 4), np.abs(_arr((C,), 5)) + 0.5
    x, w, b = _arr((4, C, 3, 3)), _arr((C,), 2), _arr((C,), 3)
    trm, trv = _t(rm), _t(rv)
    _fn_parity(lambda a: jF.batch_norm(a, _j(rm), _j(rv), _j(w), _j(b), True,
                                       use_global_stats=True),
               lambda a: tF.batch_norm(a, trm, trv, _t(w), _t(b), True,
                                       use_global_stats=True), [x])
    _close(trm, rm, "running mean untouched")


def test_batch_norm_one_value_per_channel():
    C = 3
    x, w, b = _arr((1, C, 1, 1)), _arr((C,), 2), _arr((C,), 3)
    jrm, jrv = _j(np.zeros(C, np.float32)), _j(np.ones(C, np.float32))
    trm, trv = torch.zeros(C), torch.ones(C)
    _fn_parity(lambda a, ww, bb: jF.batch_norm(a, jrm, jrv, ww, bb, True),
               lambda a, ww, bb: tF.batch_norm(a, trm, trv, ww, bb, True),
               [x, w, b])
    _close(trm, jrm)
    _close(trv, jrv)


NORMS = {
    "instance_norm": (lambda a, w, b: jF.instance_norm(a, weight=w, bias=b),
                      lambda a, w, b: tF.instance_norm(a, weight=w, bias=b)),
    "group_norm": (lambda a, w, b: jF.group_norm(a, 2, 1e-5, w, b),
                   lambda a, w, b: tF.group_norm(a, 2, 1e-5, w, b)),
    "layer_norm": (lambda a, w, b: jF.layer_norm(a, [4, 5], w, b),
                   lambda a, w, b: tF.layer_norm(a, [4, 5], w, b)),
    "rms_norm": (lambda a, w, b: jF.rms_norm(a, w),
                 lambda a, w, b: tF.rms_norm(a, w)),
    "local_response_norm": (lambda a, w, b: jF.local_response_norm(a, 3),
                            lambda a, w, b: tF.local_response_norm(a, 3)),
    "normalize": (lambda a, w, b: jF.normalize(a, 2, 1),
                  lambda a, w, b: tF.normalize(a, 2, 1)),
}


@pytest.mark.parametrize("case", sorted(NORMS))
def test_norm(case):
    jfn, tfn = NORMS[case]
    C = 4
    x = _arr((2, C, 4, 5))
    if case in ("layer_norm", "rms_norm"):
        w, b = _arr((4, 5) if case == "layer_norm" else (5,), 2), \
            _arr((4, 5), 3)
        grad = (0, 1) if case == "rms_norm" else (0, 1, 2)
    else:
        w, b = _arr((C,), 2), _arr((C,), 3)
        grad = (0,) if case in ("local_response_norm", "normalize") \
            else (0, 1, 2)
    _fn_parity(jfn, tfn, [x, w, b], grad=grad)


def test_norm_stats_in_float32_for_bf16():
    x = torch.from_numpy(_arr((2, 3, 4, 4), scale=300.0)).bfloat16()
    rm, rv = torch.zeros(3), torch.ones(3)
    out = tF.batch_norm(x, rm, rv, None, None, True)
    want = tF.batch_norm(x.float(), torch.zeros(3), torch.ones(3), None,
                         None, True)
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), want, atol=0.02, rtol=0.02)



@pytest.mark.parametrize("cls,fmt", [("BatchNorm2D", "NCHW"),
                                     ("BatchNorm2D", "NHWC"),
                                     ("BatchNorm1D", "NCL"),
                                     ("BatchNorm3D", "NCDHW"),
                                     ("BatchNorm", "NCHW"),
                                     ("SyncBatchNorm", "NCHW")])
def test_batch_norm_layer_train_updates_running_stats(cls, fmt):
    C = 4
    shape = {"NCHW": (3, C, 4, 3), "NHWC": (3, 4, 3, C), "NCL": (5, C, 3),
             "NCDHW": (2, C, 3, 2, 3)}[fmt]
    kw = {} if cls == "BatchNorm" else {"data_format": fmt}
    jm, tm = _layer_pair(lambda: getattr(jnn, cls)(C, momentum=0.8, **kw),
                         lambda: getattr(tnn, cls)(C, momentum=0.8, **kw))
    assert sorted(dict(tm.state_dict())) == ["_mean", "_variance", "bias",
                                             "weight"]
    for seed in (1, 2):
        _layer_parity(jm, tm, [_arr(shape, seed, 1.5)])
    _close(tm._mean, jm._mean, "_mean")
    _close(tm._variance, jm._variance, "_variance")
    jm.eval()
    tm.eval()
    _layer_parity(jm, tm, [_arr(shape, 3)])


def test_convert_sync_batchnorm_keeps_state():
    seq = tnn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4))
    seq(torch.randn(2, 3, 5, 5))
    before = {k: v.clone() for k, v in seq.state_dict().items()}
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(seq)
    assert isinstance(out[1], tnn.SyncBatchNorm)
    for k, v in out.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_spectral_norm():
    jm, tm = _layer_pair(lambda: jnn.SpectralNorm([6, 4, 3], dim=1,
                                                  power_iters=3),
                         lambda: tnn.SpectralNorm([6, 4, 3], dim=1,
                                                  power_iters=3))
    w = _arr((6, 4, 3))
    _close(tm(_t(w)), jm(_j(w)))
    assert not tm.weight_u.requires_grad
