"""The port's YOLOv3 head operators and deformable convolution
(``paddle_tpu_torch.vision.ops``) against the JAX package's: ``yolo_box``
(IoU-aware, clipped or not), ``yolo_loss`` and ``deform_conv2d`` (v1 and
v2, groups and deformable groups 2), with gradients.

Inputs: small float32 arrays from a seeded numpy generator. Values are
held to 1e-5 absolute and relative (float32 in both frameworks); indices,
counts are equal. The reference's detection ops take
their inputs' arrays out of the package's tensors, so its tape records
nothing through them (ROADMAP queue 3): its gradients here are JAX's own
differentiation of the same functions (``_ref_vjp``). The reference faults
this file shows (ROADMAP queue 3) run both packages.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from paddle_tpu.vision import ops as jops  # noqa: E402
from paddle_tpu_torch.vision import ops as tops  # noqa: E402
from detection_parity import (_arr, _close, _equal, _np, _ref,  # noqa: E402
                              _t, _vjp_parity)

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

# ---------------------------------------------------------- yolo box ----
ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


@pytest.mark.parametrize("iou_aware,clip", [(False, True), (True, False),
                                            (True, True)])
def test_yolo_box(iou_aware, clip):
    na, C = 3, 4
    x = _arr((2, na * (5 + C) + (na if iou_aware else 0), 5, 6), 1)
    img = np.array([[160, 192], [150, 170]], np.int32)
    kw = dict(anchors=ANCHORS[:2 * na], class_num=C, conf_thresh=0.4,
              downsample_ratio=32, clip_bbox=clip, iou_aware=iou_aware,
              iou_aware_factor=0.4, scale_x_y=1.05)
    jb, js = _ref(lambda a, i: jops.yolo_box(a, i, **kw), x, img)
    tb, ts = tops.yolo_box(_t(x), _t(img), **kw)
    assert tb.shape == (2, na * 30, 4) and ts.shape == (2, na * 30, C)
    _close(tb, jb, "boxes")
    _close(ts, js, "scores")
    assert (_np(ts) == 0).any() and (_np(ts) > 0).any()


# ------------------------------------------------- deformable conv ------
DEFORM = {
    "v1_stride2_pad1_dilation2": dict(stride=2, padding=1, dilation=2),
    "v2_groups2_dg2": dict(mask=True, groups=2, deformable_groups=2),
}


@pytest.mark.parametrize("case", sorted(DEFORM))
def test_deform_conv2d(case):
    kw = dict(DEFORM[case])
    use_mask = kw.pop("mask", False)
    g, dg = kw.get("groups", 1), kw.get("deformable_groups", 1)
    st, pd, dl = kw.get("stride", 1), kw.get("padding", 1), \
        kw.get("dilation", 1)
    kw["padding"] = pd
    N, Cin, H, W, Cout = 2, 4, 7, 6, 6
    Ho = (H + 2 * pd - dl * 2 - 1) // st + 1
    Wo = (W + 2 * pd - dl * 2 - 1) // st + 1
    arrays = [_arr((N, Cin, H, W), 1), _arr((N, dg * 18, Ho, Wo), 2, 1.5),
              _arr((Cout, Cin // g, 3, 3), 3), _arr((Cout,), 4)]
    if use_mask:
        arrays.append(1 / (1 + np.exp(-_arr((N, dg * 9, Ho, Wo), 5))))

    def call(ops, *ins):
        mask = ins[4] if use_mask else None
        return ops.deform_conv2d(ins[0], ins[1], ins[2], ins[3], mask=mask,
                                 **kw)

    _vjp_parity(lambda *a: call(jops, *a), lambda *a: call(tops, *a),
                arrays, ("x", "offset", "weight", "bias", "mask"))


# -------------------------------------------------------- yolo loss -----
@pytest.mark.parametrize("smooth", [True, False])
def test_yolo_loss(smooth):
    na, C, H, W = 3, 4, 5, 6
    x = _arr((2, na * (5 + C), H, W), 1)
    rng = np.random.default_rng(2)
    gt = np.concatenate([rng.uniform(10, 180, (2, 6, 2)),
                         rng.uniform(8, 120, (2, 6, 2))], -1)
    gt[1, 4:] = 0  # padding rows
    gt = gt.astype(np.float32)
    lab = rng.integers(0, C, (2, 6)).astype(np.int32)
    kw = dict(anchors=ANCHORS, anchor_mask=[3, 4, 5], class_num=C,
              ignore_thresh=0.5, downsample_ratio=32,
              use_label_smooth=smooth)
    got, _ = _vjp_parity(lambda a: jops.yolo_loss(a, gt, lab, **kw),
                      lambda a: tops.yolo_loss(a, _t(gt), _t(lab), **kw),
                      [x], ["x"])
    assert got.shape == (2,)


def test_reference_fault_yolo_loss_gt_score():
    """``gt_score`` (mixup weights) and ``scale_x_y``: the port refuses
    them; the reference ignores both."""
    x = _arr((1, 3 * 9, 4, 4), 1)
    gt = np.array([[[40.0, 50.0, 30.0, 20.0]]], np.float32)
    lab = np.zeros((1, 1), np.int32)
    score = np.full((1, 1), 0.25, np.float32)
    kw = dict(anchors=ANCHORS, anchor_mask=[0, 1, 2], class_num=4,
              ignore_thresh=0.5, downsample_ratio=32)
    with pytest.raises(ValueError, match="gt_score"):
        tops.yolo_loss(_t(x), _t(gt), _t(lab), gt_score=_t(score), **kw)
    with pytest.raises(ValueError, match="scale_x_y"):
        tops.yolo_loss(_t(x), _t(gt), _t(lab), scale_x_y=1.1, **kw)
    plain = _ref(lambda a: jops.yolo_loss(a, gt, lab, **kw), x)
    _equal(_ref(lambda a: jops.yolo_loss(a, gt, lab, gt_score=score,
                                         scale_x_y=1.1, **kw), x), plain)
