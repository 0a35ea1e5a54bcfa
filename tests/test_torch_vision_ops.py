"""The port's detection operators (``paddle_tpu_torch.vision.ops``) against
the JAX package's: NMS (tied scores, categories, top_k), box coding both
ways on both axes, prior boxes, the RoI poolings (RoIs crossing the map's
edges) with their gradients, FPN levels and RPN proposals over two images.
The YOLOv3 head and deformable convolution are in
``test_torch_vision_ops_heads.py``.

Inputs: small float32 arrays from a seeded numpy generator. Values are
held to 1e-5 absolute and relative (float32 in both frameworks); indices,
counts and ``restore_index`` are equal. The reference's NMS scans all N
boxes once per pick, so N stays small. The reference's detection ops take
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
from detection_parity import (_arr, _close, _equal, _j, _np, _ref,  # noqa: E402
                              _t, _vjp_parity)

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

def _boxes(n, seed, size=20.0, lo=2.0, hi=9.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# --------------------------------------------------------------- nms ----
NMS = {
    "scores": dict(iou_threshold=0.3),
    "no_scores": dict(iou_threshold=0.4, scores=None),
    "tied_scores": dict(iou_threshold=0.2, tied=True),
    "categories": dict(iou_threshold=0.1, category_idxs=True),
    "top_k": dict(iou_threshold=0.3, top_k=4),
    "categories_ties_top_k": dict(iou_threshold=0.1, category_idxs=True,
                                  tied=True, top_k=5),
}


@pytest.mark.parametrize("case", sorted(NMS))
def test_nms(case):
    kw = dict(NMS[case])
    b = _boxes(14, 3)
    s = np.random.default_rng(4).uniform(0, 1, 14).astype(np.float32)
    if kw.pop("tied", False):
        s = np.round(s * 3) / 3  # only four distinct scores
    c = np.random.default_rng(5).integers(0, 3, 14)
    jkw, tkw = dict(iou_threshold=kw["iou_threshold"]), \
        dict(iou_threshold=kw["iou_threshold"])
    if "scores" not in kw:
        jkw["scores"], tkw["scores"] = _j(s), _t(s)
    if kw.get("category_idxs"):
        jkw["category_idxs"], tkw["category_idxs"] = _j(c), _t(c)
    if "top_k" in kw:
        jkw["top_k"] = tkw["top_k"] = kw["top_k"]
    want = _np(jops.nms(_j(b), **jkw))
    got = tops.nms(_t(b), **tkw)
    assert got.dtype == torch.int64
    _equal(got, want)
    assert len(want) > 1


def test_reference_fault_nms_categories():
    """Paddle's ``categories`` restricts NMS to those categories; the
    reference ignores it."""
    b, c = _boxes(14, 3), np.random.default_rng(5).integers(0, 3, 14)
    s = np.random.default_rng(4).uniform(0, 1, 14).astype(np.float32)
    got = tops.nms(_t(b), 0.1, _t(s), _t(c), categories=[0, 2])
    assert set(c[_np(got)]) <= {0, 2}
    full = _np(tops.nms(_t(b), 0.1, _t(s), _t(c)))
    _equal(got, full[np.isin(c[full], [0, 2])])
    ref = jops.nms(_j(b), 0.1, _j(s), _j(c), categories=[0, 2])
    _equal(ref, full)
    assert 1 in c[_np(ref)]


# --------------------------------------------------------- box coder ----
def test_box_coder_encode():
    pb, tb = _boxes(5, 1), _boxes(3, 2)
    var2 = np.abs(_arr((5, 4), 3)) + 0.1
    for var_j, var_t in ((var2, _t(var2)),
                         ([0.1, 0.1, 0.2, 0.2], [0.1, 0.1, 0.2, 0.2])):
        for norm in (True, False):
            _close(tops.box_coder(_t(pb), var_t, _t(tb),
                                  box_normalized=norm),
                   _ref(lambda p, t: jops.box_coder(
                       p, var_j, t, box_normalized=norm), pb, tb))


@pytest.mark.parametrize("axis", [0, 1])
def test_box_coder_decode(axis):
    pb = _boxes(5, 1)
    deltas = _arr((5, 5, 4), 2, 0.5)
    var2 = np.abs(_arr((5, 4), 3)) + 0.1
    for var_j, var_t in ((var2, _t(var2)),
                         ([0.1, 0.1, 0.2, 0.2], [0.1, 0.1, 0.2, 0.2])):
        kw = dict(code_type="decode_center_size", axis=axis)
        _close(tops.box_coder(_t(pb), var_t, _t(deltas), **kw),
               _ref(lambda p, d: jops.box_coder(p, var_j, d, **kw), pb,
                    deltas))


# --------------------------------------------------------- prior box ----
PRIOR = {
    "flip_clip_max": dict(min_sizes=[8.0, 16.0], max_sizes=[12.0, 24.0],
                          aspect_ratios=[2.0, 3.0], flip=True, clip=True),
    "order_steps": dict(min_sizes=[10.0], max_sizes=[20.0],
                        aspect_ratios=[2.0], flip=True,
                        min_max_aspect_ratios_order=True,
                        steps=(7.0, 9.0), offset=0.3),
    "plain": dict(min_sizes=[5.0]),
}


@pytest.mark.parametrize("case", sorted(PRIOR))
def test_prior_box(case):
    fm, img = _arr((1, 2, 4, 6)), _arr((1, 3, 40, 50))
    jb, jv = _ref(lambda f, i: jops.prior_box(f, i, **PRIOR[case]), fm,
                  img)
    tb, tv = tops.prior_box(_t(fm), _t(img), **PRIOR[case])
    _close(tb, jb, "boxes")
    _close(tv, jv, "variances")


# ---------------------------------------------------------- RoI ops -----
def _rois():
    """Five RoIs over two 16 x 20 images (3 + 2), two crossing the map's
    edges, in image pixels at scale 0.5."""
    return (np.array([[2.0, 3.0, 20.0, 18.0], [-6.0, -4.0, 12.0, 9.0],
                      [10.0, 4.0, 44.0, 40.0], [5.5, 7.25, 9.0, 8.0],
                      [30.0, 20.0, 37.0, 31.0]], np.float32),
            np.array([3, 2], np.int32))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling_ratio", [1, 2, 3])
def test_roi_align(aligned, sampling_ratio):
    rois, num = _rois()
    kw = dict(output_size=(3, 4), spatial_scale=0.5,
              sampling_ratio=sampling_ratio, aligned=aligned)
    _vjp_parity(lambda x: jops.roi_align(x, rois, num, **kw),
                lambda x: tops.roi_align(x, _t(rois), _t(num), **kw),
                [_arr((2, 3, 16, 20))], ["x"])


def test_reference_fault_detection_ops_cut_the_tape():
    """Paddle's RoI ops, deformable convolution and YOLOv3 loss have
    gradients; the reference's unwrap their inputs, so its tape gives the
    input none. The port's come from autograd."""
    rois, num = _rois()
    x = _arr((2, 3, 16, 20))
    jx, tx = _j(x, True), _t(x, True)
    jops.roi_align(jx, _j(rois), _j(num), 3, 0.5).sum().backward()
    tops.roi_align(tx, _t(rois), _t(num), 3, 0.5).sum().backward()
    assert jx.grad is None
    assert float(tx.grad.abs().sum()) > 0


def test_roi_align_chunked(monkeypatch):
    """A chunk of one RoI at a time gives the same output."""
    x = _arr((2, 3, 16, 20))
    rois, num = _rois()
    whole = tops.roi_align(_t(x), _t(rois), _t(num), 3, 0.5, 2)
    monkeypatch.setattr(tops, "CHUNK_BYTES", 1)
    _equal(tops.roi_align(_t(x), _t(rois), _t(num), 3, 0.5, 2), whole)
    _equal(tops.RoIAlign(3, 0.5)(_t(x), _t(rois), _t(num)),
           tops.roi_align(_t(x), _t(rois), _t(num), 3, 0.5, -1))


def test_reference_fault_roi_align_adaptive_sampling():
    """Paddle's ``sampling_ratio <= 0`` takes ``ceil(roi size / bins)``
    samples per bin in each direction; the reference takes 2. RoIs whose
    bins are all 2.x by 2.x pixels take 3 x 3 samples."""
    x = _arr((1, 2, 16, 20))
    rois = np.array([[1.0, 2.0, 7.6, 8.8], [3.0, 1.0, 9.9, 7.75]],
                    np.float32)
    num = np.array([2], np.int32)
    kw = dict(output_size=3, aligned=True)
    got = tops.roi_align(_t(x), _t(rois), _t(num), sampling_ratio=0, **kw)
    ref = {s: _ref(lambda a: jops.roi_align(a, rois, num, sampling_ratio=s,
                                            **kw), x) for s in (0, 2, 3)}
    _close(got, ref[3])
    _close(ref[0], ref[2])
    assert np.abs(_np(ref[0]) - _np(got)).max() > 1e-3


def test_roi_pool(monkeypatch):
    x = _arr((2, 3, 16, 20))
    rois, num = _rois()
    got, want = _vjp_parity(
        lambda a: jops.roi_pool(a, rois, num, (3, 2), 0.5),
        lambda a: tops.roi_pool(a, _t(rois), _t(num), (3, 2), 0.5), [x],
        ["x"])
    _equal(got, want)  # maxima: the same elements
    monkeypatch.setattr(tops, "CHUNK_BYTES", 1)
    _equal(tops.RoIPool((3, 2), 0.5)(_t(x), _t(rois), _t(num)), got)


def test_psroi_pool():
    rois, num = _rois()
    got, _ = _vjp_parity(lambda a: jops.psroi_pool(a, rois, num, 3, 0.5),
                      lambda a: tops.psroi_pool(a, _t(rois), _t(num), 3,
                                                0.5),
                      [_arr((2, 2 * 3 * 3, 16, 20))], ["x"])
    assert got.shape == (5, 2, 3, 3)


# ------------------------------------------------- FPN and proposals ----
@pytest.mark.parametrize("pixel_offset", [False, True])
def test_distribute_fpn_proposals(pixel_offset):
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 400, (40, 2))
    wh = np.exp(rng.uniform(np.log(8), np.log(700), (40, 2)))
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    kw = dict(min_level=2, max_level=5, refer_level=4, refer_scale=224,
              pixel_offset=pixel_offset)
    jo, jr, jn = jops.distribute_fpn_proposals(_j(rois), **kw)
    to, tr, tn = tops.distribute_fpn_proposals(_t(rois), **kw)
    assert len(to) == len(jo) == 4
    for g, w in zip(to, jo):
        _close(g, w)
    _equal(tr, jr)
    for g, w in zip(tn, jn):
        assert g.dtype == torch.int32
        _equal(g, w)
    assert sum(int(_np(n)[0]) > 0 for n in tn) >= 3


def test_reference_fault_distribute_fpn_rois_num():
    """Paddle's ``rois_num`` (RoIs per image) gives each level's count per
    image; the reference ignores it and counts per level."""
    rng = np.random.default_rng(8)
    xy = rng.uniform(0, 400, (30, 2))
    wh = np.exp(rng.uniform(np.log(8), np.log(700), (30, 2)))
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    per_img = np.array([12, 18], np.int32)
    kw = dict(min_level=2, max_level=5, refer_level=4, refer_scale=224)
    outs, restore, nums = tops.distribute_fpn_proposals(
        _t(rois), rois_num=_t(per_img), **kw)
    _, _, plain = tops.distribute_fpn_proposals(_t(rois), **kw)
    img = np.repeat([0, 1], per_img)
    lvl_of = np.repeat(np.arange(4), [len(o) for o in outs])[
        _np(restore)[:, 0]]
    for level, n in enumerate(nums):
        _equal(n, [(img[lvl_of == level] == i).sum() for i in (0, 1)])
        assert int(_np(n).sum()) == int(_np(plain[level])[0])
    _, _, ref = jops.distribute_fpn_proposals(_j(rois),
                                              rois_num=_j(per_img), **kw)
    assert all(_np(r).shape == (1,) for r in ref)


def _rpn_inputs(N=2, A=3, H=4, W=5, seed=11):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 1, (N, A, H, W)).astype(np.float32)
    deltas = (rng.standard_normal((N, 4 * A, H, W)) * 0.3).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H) * 16.0, np.arange(W) * 16.0,
                         indexing="ij")
    sizes = np.array([24.0, 40.0, 64.0])[:A]
    anchors = np.stack([
        np.stack([xs - s / 2, ys - s / 2, xs + s / 2, ys + s / 2], -1)
        for s in sizes], 2).astype(np.float32)                 # [H, W, A, 4]
    variances = np.ones_like(anchors) * np.array([0.1, 0.1, 0.2, 0.2],
                                                 np.float32)
    img = np.array([[64, 80], [60, 70]], np.float32)
    return scores, deltas, img, anchors, variances


@pytest.mark.parametrize("pixel_offset", [False, True])
def test_generate_proposals(pixel_offset):
    args = _rpn_inputs()
    kw = dict(pre_nms_top_n=40, post_nms_top_n=10, nms_thresh=0.5,
              min_size=4.0, pixel_offset=pixel_offset)
    jr, js, jn = jops.generate_proposals(*map(_j, args), **kw)
    tr, ts, tn = tops.generate_proposals(*map(_t, args), **kw)
    _equal(tn, jn)
    assert tn.dtype == torch.int32 and int(_np(tn).sum()) > 10
    _close(tr, jr, "rois")
    _close(ts, js, "scores")
    tr2, ts2 = tops.generate_proposals(*map(_t, args), **kw,
                                       return_rois_num=False)
    _equal(tr2, tr)


def test_reference_fault_generate_proposals_eta():
    """``eta < 1`` asks for adaptive NMS: the port refuses it; the
    reference ignores it and runs plain NMS."""
    args = _rpn_inputs()
    kw = dict(pre_nms_top_n=40, post_nms_top_n=10, nms_thresh=0.5)
    with pytest.raises(ValueError, match="eta"):
        tops.generate_proposals(*map(_t, args), eta=0.7, **kw)
    ref = jops.generate_proposals(*map(_j, args), eta=0.7, **kw)
    _equal(ref[0], jops.generate_proposals(*map(_j, args), **kw)[0])
