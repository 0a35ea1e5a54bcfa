"""Detection operators (counterpart of paddle_tpu/vision/ops.py): NMS, box
coding, the YOLOv3 head's decoding and loss, SSD's prior boxes, the RoI
poolings, FPN level assignment, RPN proposals and deformable convolution,
with the reference's signatures and results, on torch tensors.

Where the reference's dense formulation does not fit at a detector's size
the port computes the same values in bounded memory:

* ``nms``: the reference takes N fixed-trip argmax picks over the IoU
  matrix. The port sorts by score (stable, so ties keep the lower index
  first, as argmax does), builds "IoU > threshold" on the device, packs
  it into a bit mask, copies the mask to the host once and sweeps it there
  in order (the reference builds its result on the host too). Category
  awareness offsets the boxes by ``category * span`` exactly as the
  reference does, so the IoUs and the picks are the same.
* ``roi_align``: the four bilinear corners are gathered for a chunk of RoIs
  at a time (the reference gathers them for every RoI at once).
* ``roi_pool``: a bin's maximum is taken over columns, then over rows, for
  a chunk of RoIs at a time (the reference masks a ``[C, oh, ow, H, W]``
  block per RoI).
* ``psroi_pool``: each bin's mean is two contractions with the bins' row
  and column masks, one image at a time (the reference masks a ``[C, H,
  W]`` block per RoI).
* ``distribute_fpn_proposals`` and ``generate_proposals`` run on the
  device (the reference runs them in numpy); ``generate_proposals`` reads
  the device once per image, in its NMS.

Where the reference ignores an argument the port follows Paddle or refuses
it (ROADMAP queue 3): ``roi_align`` with ``sampling_ratio <= 0`` takes
``ceil(roi size / bins)`` samples per bin in each direction (the reference
takes 2; the largest count is read on the host, as it sets the sampling
grid's shape); ``nms``'s ``categories`` keeps only the boxes of those
categories; ``distribute_fpn_proposals``'s ``rois_num`` gives each level's
count per image; ``generate_proposals`` refuses ``eta < 1`` (adaptive NMS)
and ``yolo_loss`` refuses ``gt_score`` and ``scale_x_y != 1``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["yolo_box", "prior_box", "box_coder", "nms", "roi_align",
           "roi_pool", "psroi_pool", "distribute_fpn_proposals",
           "deform_conv2d", "generate_proposals", "yolo_loss", "RoIAlign",
           "RoIPool"]

# the most a chunked RoI op's temporaries take at once
CHUNK_BYTES = 512 << 20


def _float(t):
    """float32, as the reference computes; float64 stays float64."""
    return t if t.dtype == torch.float64 else t.float()


def _div(a, n):
    """``a / n`` rounded as one true division on any device. On the card
    PyTorch multiplies by the reciprocal of a Python-number divisor, which
    can land an ulp off; where the quotient feeds a floor, a ceil or a
    truncation (bin edges, sample counts, grid cells, FPN levels) that ulp
    moves an edge, so those quotients divide by a tensor."""
    return a / a.new_full((), n)


def _as_tensor(v, like=None, dtype=None):
    if isinstance(v, torch.Tensor):
        return v if dtype is None else v.to(dtype)
    device = like.device if like is not None else None
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)


# --------------------------------------------------------------- nms ----
def _iou_matrix(boxes):
    """Pairwise IoU of ``[N, 4]`` boxes (x1, y1, x2, y2), in the
    reference's order of operations."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp_min(0) * \
        (boxes[:, 3] - boxes[:, 1]).clamp_min(0)
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[:, None] + area[None, :] - inter
    return inter / union.clamp_min(1e-10)


_BIT_WEIGHTS = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8)


def _greedy_keep(boxes, scores, iou_threshold, top_k=None):
    """Indices of the boxes greedy NMS keeps, in pick order (score
    descending, ties by index), as an int64 tensor on the boxes' device.
    A box with score -inf is never kept. One read of the device: the
    ``[N, N / 8]`` suppression bit mask."""
    n = boxes.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=boxes.device)
    order = torch.sort(scores, descending=True, stable=True).indices
    b = boxes[order]
    sup = _iou_matrix(b) > iou_threshold
    sup = torch.cat([sup, sup.new_zeros(n, (-n) % 8)], 1)
    packed = (sup.view(n, -1, 8).to(torch.uint8)
              * _BIT_WEIGHTS.to(boxes.device)).sum(-1, dtype=torch.uint8)
    valid = scores[order] > float("-inf")
    host = torch.cat([packed, valid[:, None].to(torch.uint8)], 1).cpu()
    rows, alive = host[:, :-1].numpy(), host[:, -1].numpy().astype(bool)
    removed = np.zeros(rows.shape[1], np.uint8)
    picked = []
    limit = n if top_k is None else int(top_k)
    for i in range(n):
        if len(picked) >= limit:
            break
        if not alive[i] or (removed[i >> 3] >> (i & 7)) & 1:
            continue
        picked.append(i)
        removed |= rows[i]
    idx = torch.as_tensor(picked, dtype=torch.int64).to(boxes.device)
    return order[idx]


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy hard NMS (IoU strictly above ``iou_threshold`` suppresses),
    optionally per category; returns the kept indices, int64, by
    descending score (ties: lower index first). Without ``scores`` the
    boxes rank by index. With ``categories`` only boxes whose
    ``category_idxs`` is among them are considered, as in Paddle.

    The suppression mask is built on the boxes' device and swept once on
    the host (see the module's docstring)."""
    b = boxes
    s = scores if scores is not None else torch.arange(
        b.shape[0], 0, -1, device=b.device).to(b.dtype)
    if category_idxs is not None:
        c = _as_tensor(category_idxs, b)
        # the reference's offsets: cross-category boxes never overlap
        span = (b.max() - b.min()) + 1.0
        b = b + (c.to(b.dtype) * span)[:, None]
        if categories is not None:
            cats = _as_tensor(categories, b).to(c.dtype)
            keep = (c[:, None] == cats[None, :]).any(1)
            s = torch.where(keep, s, torch.full((), float("-inf"),
                                                dtype=s.dtype,
                                                device=s.device))
    return _greedy_keep(b, s, float(iou_threshold), top_k)


# --------------------------------------------------------- box coder ----
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode ``target_box [N, 4]`` against ``prior_box [M, 4]`` into
    ``[N, M, 4]`` offsets, or decode ``[N, M, 4]`` offsets (priors along
    dimension ``axis``) into boxes; ``prior_box_var`` is ``[M, 4]`` or 4
    numbers."""
    pb, tb = prior_box, target_box
    var = prior_box_var if isinstance(prior_box_var, torch.Tensor) else \
        torch.as_tensor(prior_box_var, dtype=pb.dtype, device=pb.device)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw * 0.5
    pcy = pb[:, 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw * 0.5
        tcy = tb[:, 1] + th * 0.5
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        ow = torch.log(tw[:, None] / pw[None, :])
        oh = torch.log(th[:, None] / ph[None, :])
        out = torch.stack([ox, oy, ow, oh], -1)
        return out / (var[None, :, :] if var.dim() == 2 else
                      var.reshape(1, 1, 4))
    if code_type != "decode_center_size":
        raise ValueError(f"box_coder code_type {code_type!r} (expected "
                         "encode_center_size | decode_center_size)")
    if var.dim() == 3:
        v = var
    elif var.dim() == 2:
        v = var[None, :, :] if axis == 0 else var[:, None, :]
    else:
        v = var.reshape(1, 1, 4)
    if axis == 0:
        w, h, cx, cy = pw[None, :], ph[None, :], pcx[None, :], pcy[None, :]
    else:
        w, h, cx, cy = pw[:, None], ph[:, None], pcx[:, None], pcy[:, None]
    dcx = v[..., 0] * tb[..., 0] * w + cx
    dcy = v[..., 1] * tb[..., 1] * h + cy
    dw = torch.exp(v[..., 2] * tb[..., 2]) * w
    dh = torch.exp(v[..., 3] * tb[..., 3]) * h
    return torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                        dcx + dw * 0.5 - norm, dcy + dh * 0.5 - norm], -1)


# ---------------------------------------------------------- yolo box ----
def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio=32, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLO head ``x [N, na * (5 + class_num) (+ na), H, W]``:
    ``(boxes [N, na * H * W, 4], scores [N, na * H * W, class_num])`` in
    image pixels (``img_size [N, 2]`` as (h, w)), ordered by anchor, then
    row, then column; scores are 0 where the objectness is below
    ``conf_thresh``."""
    xv = _float(x)
    img = img_size.to(xv.dtype)
    na = len(anchors) // 2
    N, _, H, W = xv.shape
    anc = torch.as_tensor(np.asarray(anchors, np.float32).reshape(na, 2),
                          device=xv.device).to(xv.dtype)
    feat = xv.reshape(N, na, 5 + class_num + (1 if iou_aware else 0), H, W)
    if iou_aware:
        ioup, feat = feat[:, :, :1], feat[:, :, 1:]
    gx = torch.arange(W, dtype=xv.dtype, device=xv.device)
    gy = torch.arange(H, dtype=xv.dtype, device=xv.device)
    bx = (torch.sigmoid(feat[:, :, 0]) * scale_x_y
          - 0.5 * (scale_x_y - 1.0) + gx[None, None, None, :]) / W
    by = (torch.sigmoid(feat[:, :, 1]) * scale_x_y
          - 0.5 * (scale_x_y - 1.0) + gy[None, None, :, None]) / H
    in_w, in_h = downsample_ratio * W, downsample_ratio * H
    bw = torch.exp(feat[:, :, 2]) * anc[None, :, 0, None, None] / in_w
    bh = torch.exp(feat[:, :, 3]) * anc[None, :, 1, None, None] / in_h
    conf = torch.sigmoid(feat[:, :, 4])
    if iou_aware:
        conf = conf ** (1 - iou_aware_factor) * \
            torch.sigmoid(ioup[:, :, 0]) ** iou_aware_factor
    cls = torch.sigmoid(feat[:, :, 5:]) * conf[:, :, None]
    cls = torch.where(conf[:, :, None] >= conf_thresh, cls,
                      torch.zeros_like(cls))
    imw = img[:, 1].reshape(N, 1, 1, 1)
    imh = img[:, 0].reshape(N, 1, 1, 1)
    x1 = (bx - bw * 0.5) * imw
    y1 = (by - bh * 0.5) * imh
    x2 = (bx + bw * 0.5) * imw
    y2 = (by + bh * 0.5) * imh
    if clip_bbox:
        zero = torch.zeros((), dtype=xv.dtype, device=xv.device)
        x1 = torch.clamp(x1, zero, imw - 1)
        y1 = torch.clamp(y1, zero, imh - 1)
        x2 = torch.clamp(x2, zero, imw - 1)
        y2 = torch.clamp(y2, zero, imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1).reshape(N, -1, 4)
    scores = cls.permute(0, 1, 3, 4, 2).reshape(N, -1, class_num)
    return boxes, scores


# --------------------------------------------------------- prior box ----
def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD's prior boxes over ``input``'s ``H x W`` map for an ``image`` of
    ``IH x IW``: ``(boxes [H, W, P, 4], variances [H, W, P, 4])``,
    normalised to the image."""
    H, W = input.shape[-2:]
    IH, IW = image.shape[-2:]
    step_w = steps[0] or IW / W
    step_h = steps[1] or IH / H
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    whs = []
    for ms in min_sizes:
        mx = max_sizes[min_sizes.index(ms)] if max_sizes else None
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if mx is not None:
                whs.append((float(np.sqrt(ms * mx)),) * 2)
            whs += [(ms * np.sqrt(ar), ms / np.sqrt(ar)) for ar in ars
                    if abs(ar - 1.0) >= 1e-6]
        else:
            whs += [(ms * np.sqrt(ar), ms / np.sqrt(ar)) for ar in ars]
            if mx is not None:
                whs.append((float(np.sqrt(ms * mx)),) * 2)
    dev = input.device
    whs = torch.as_tensor(np.asarray(whs, np.float32), device=dev)
    P = whs.shape[0]
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offset) * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    out = torch.stack([
        (cxg[..., None] - whs[None, None, :, 0] / 2) / IW,
        (cyg[..., None] - whs[None, None, :, 1] / 2) / IH,
        (cxg[..., None] + whs[None, None, :, 0] / 2) / IW,
        (cyg[..., None] + whs[None, None, :, 1] / 2) / IH], -1)
    if clip:
        out = out.clamp(0.0, 1.0)
    var = torch.as_tensor(variance, dtype=torch.float32,
                          device=dev).expand(H, W, P, 4).contiguous()
    return out, var


# ---------------------------------------------------------- RoI ops -----
def _roi_batch(boxes_num, num_rois, device):
    """The image index of each RoI from the per-image counts (no read of
    the device: the total is ``num_rois``)."""
    bn = _as_tensor(boxes_num, dtype=torch.int64).to(device)
    return torch.repeat_interleave(torch.arange(bn.shape[0], device=device),
                                   bn, output_size=num_rois)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _chunks(n, per_item_bytes):
    step = max(1, CHUNK_BYTES // max(int(per_item_bytes), 1))
    return [(i, min(n, i + step)) for i in range(0, n, step)]


def _bilinear_taps(coords, size):
    """The reference's clamped bilinear taps along one axis: lower and
    upper indices and the upper weight."""
    lo = coords.floor().clamp(0, size - 1)
    hi = (lo + 1).clamp(0, size - 1)
    w = coords.clamp(0, size - 1) - lo
    return lo.long(), hi.long(), w


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign: each of ``oh x ow`` bins of every RoI (``boxes [R, 4]``
    in image pixels, scaled by ``spatial_scale``; ``boxes_num`` RoIs per
    image) is the mean of ``s x s`` bilinear samples of ``x [N, C, H,
    W]``, ``s = sampling_ratio``, or ``ceil(roi size / bins)`` per
    direction when it is not positive (the RoIs are grouped by those
    counts on the card; the groups' counts and sizes are read on the host
    once). Returns ``[R, C, oh, ow]``."""
    oh, ow = _pair(output_size)
    N, C, H, W = x.shape
    R = boxes.shape[0]
    dev = x.device
    bx = boxes * spatial_scale
    bidx = _roi_batch(boxes_num, R, dev)
    off = 0.5 if aligned else 0.0
    x1, y1 = bx[:, 0] - off, bx[:, 1] - off
    x2, y2 = bx[:, 2] - off, bx[:, 3] - off
    if not aligned:
        x2 = torch.maximum(x2, x1 + 1.0)
        y2 = torch.maximum(y2, y1 + 1.0)
    bin_w = _div(x2 - x1, ow)
    bin_h = _div(y2 - y1, oh)
    out = x.new_empty(R, C, oh, ow)
    if R == 0:
        return out
    if sampling_ratio > 0:
        order = torch.arange(R, device=dev)
        groups = [(int(sampling_ratio), int(sampling_ratio), R)]
    else:
        sh = torch.ceil(bin_h).long().clamp_min(1)
        sw = torch.ceil(bin_w).long().clamp_min(1)
        # RoIs of like counts together: the one read of the device is the
        # groups' counts and sizes
        counts, group, sizes = torch.unique(
            torch.stack([sh, sw], 1), dim=0, return_inverse=True,
            return_counts=True)
        order = torch.argsort(group, stable=True)
        groups = torch.cat([counts, sizes[:, None]], 1).tolist()
    start = 0
    for s_h, s_w, n in groups:
        # each chunk's gathered rows and corner products within CHUNK_BYTES
        per_roi = x.element_size() * C * oh * s_h * (2 * W + 10 * ow * s_w)
        for a, b in _chunks(n, per_roi):
            i = order[start + a:start + b]
            out[i] = _roi_align_chunk(x, bidx[i], x1[i], y1[i], bin_w[i],
                                      bin_h[i], s_h, s_w, oh, ow)
        start += n
    return out


def _sample_coords(start, bin_size, s, bins):
    """``[r, bins * s]`` sample positions: sample k of bin i sits at
    ``start + ((i * s + k) + 0.5) / s * bin_size``."""
    m = torch.arange(bins * s, device=start.device).to(start.dtype)
    return start[:, None] + (m + 0.5) / s * bin_size[:, None]


def _roi_align_chunk(x, bidx, x1, y1, bin_w, bin_h, sh, sw, oh, ow):
    """RoIAlign of RoIs that all take ``sh x sw`` samples a bin."""
    H, W = x.shape[-2:]
    r, C = bidx.shape[0], x.shape[1]
    ys = _sample_coords(y1, bin_h, sh, oh)                  # [r, oh * sh]
    xs = _sample_coords(x1, bin_w, sw, ow)
    y0i, y1i, wy = _bilinear_taps(ys, H)
    x0i, x1i, wx = _bilinear_taps(xs, W)
    # rows of each RoI's image: [r, Sy, C, W]
    b = bidx[:, None]
    rows0 = x[b, :, y0i]
    rows1 = x[b, :, y1i]
    Sx = xs.shape[1]

    def cols(rows, xi):
        return rows.gather(3, xi[:, None, None, :].expand(
            r, rows.shape[1], C, Sx))

    wy_, wx_ = wy[:, :, None, None], wx[:, None, None, :]
    samp = (cols(rows0, x0i) * ((1 - wy_) * (1 - wx_))
            + cols(rows0, x1i) * ((1 - wy_) * wx_)
            + cols(rows1, x0i) * (wy_ * (1 - wx_))
            + cols(rows1, x1i) * (wy_ * wx_))                 # [r, Sy, C, Sx]
    samp = samp.reshape(r, oh, sh, C, ow, sw)
    return samp.sum((2, 5)).permute(0, 2, 1, 3) / (sh * sw)


def _bin_edges(start, bin_size, bins):
    """``[r, bins]`` lower (floor) and upper (ceil) grid edges of each
    bin."""
    i = torch.arange(bins, dtype=start.dtype, device=start.device)
    lo = torch.floor(start[:, None] + i[None, :] * bin_size[:, None])
    hi = torch.ceil(start[:, None] + (i[None, :] + 1) * bin_size[:, None])
    return lo, hi


def _bin_masks(lo, hi, size):
    """``[r, bins, size]`` membership of each grid cell in each bin."""
    g = torch.arange(size, dtype=lo.dtype, device=lo.device)
    return (g >= lo[..., None]) & (g < hi[..., None])


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """RoIPool: the maximum of each bin of every RoI (rounded to the grid;
    an empty bin gives 0). Returns ``[R, C, oh, ow]``."""
    oh, ow = _pair(output_size)
    N, C, H, W = x.shape
    R = boxes.shape[0]
    bx = boxes * spatial_scale
    bidx = _roi_batch(boxes_num, R, x.device)
    x1, y1 = torch.round(bx[:, 0]), torch.round(bx[:, 1])
    x2 = torch.maximum(torch.round(bx[:, 2]), x1 + 1)
    y2 = torch.maximum(torch.round(bx[:, 3]), y1 + 1)
    my = _bin_masks(*_bin_edges(y1, _div(y2 - y1, oh), oh), H)  # [R, oh, H]
    mx = _bin_masks(*_bin_edges(x1, _div(x2 - x1, ow), ow), W)  # [R, ow, W]
    out = x.new_empty(R, C, oh, ow)
    ninf = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    for a, b in _chunks(R, 2 * x.element_size() * C * H * ow * W):
        img = x[bidx[a:b]]                                    # [r, C, H, W]
        # over each column bin's columns, then each row bin's rows
        colmax = torch.where(mx[a:b, None, None], img[:, :, :, None, :],
                             ninf).amax(-1)                   # [r, C, H, ow]
        m = torch.where(my[a:b, None, :, :, None], colmax[:, :, None],
                        ninf).amax(3)                         # [r, C, oh, ow]
        out[a:b] = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return out


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI average pool: ``x`` has ``C = out_c * oh *
    ow`` channels and bin (i, j) of output channel c averages channel ``c
    * oh * ow + i * ow + j`` over the bin's grid cells (0 for an empty
    bin). Returns ``[R, out_c, oh, ow]``."""
    oh, ow = _pair(output_size)
    N, C, H, W = x.shape
    R = boxes.shape[0]
    out_c = C // (oh * ow)
    bx = boxes * spatial_scale
    bidx = _roi_batch(boxes_num, R, x.device)
    my = _bin_masks(*_bin_edges(bx[:, 1], _div(bx[:, 3] - bx[:, 1], oh), oh),
                    H).to(x.dtype)                            # [R, oh, H]
    mx = _bin_masks(*_bin_edges(bx[:, 0], _div(bx[:, 2] - bx[:, 0], ow), ow),
                    W).to(x.dtype)                            # [R, ow, W]
    count = (my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :]).clamp_min(1)
    out = x.new_zeros(R, out_c, oh, ow)
    for n in range(N):
        mine = (bidx == n).to(x.dtype)
        feat = x[n].reshape(out_c, oh, ow, H, W)
        rows = torch.einsum("rjw,cijhw->rcijh", mx * mine[:, None, None],
                            feat)
        out = out + torch.einsum("rih,rcijh->rcij", my, rows)
    return out / count[:, None]


class RoIAlign(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size, self.spatial_scale = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale, aligned=aligned)


class RoIPool(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size, self.spatial_scale = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


# ------------------------------------------------- FPN and proposals ----
def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """Assign RoIs to FPN levels by scale, ``floor(log2(sqrt(w h) /
    refer_scale)) + refer_level`` clipped to the levels. Returns (per-level
    RoIs in input order, ``restore_index [R, 1]`` putting the concatenated
    levels back in input order, per-level counts): ``[1]`` int32 each, or
    with ``rois_num`` (RoIs per image) each level's count per image,
    ``[N]`` int32. One read of the device: the counts, for the outputs'
    shapes."""
    rois = fpn_rois
    off = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + off
    h = rois[:, 3] - rois[:, 1] + off
    scale = torch.sqrt((w * h).clamp_min(0))
    lvl = torch.floor(torch.log2(_div(scale, refer_scale) + 1e-8)) \
        + refer_level
    lvl = lvl.clamp(min_level, max_level).long() - min_level
    L = max_level - min_level + 1
    order = torch.sort(lvl, stable=True).indices
    restore = torch.empty_like(order)
    restore[order] = torch.arange(order.shape[0], device=order.device)
    if rois_num is None:
        counts = torch.bincount(lvl, minlength=L)
        sizes = counts.tolist()
        nums = [c.reshape(1).to(torch.int32) for c in counts]
    else:
        img = _roi_batch(rois_num, rois.shape[0], rois.device)
        n_img = _as_tensor(rois_num).shape[0]
        per = torch.bincount(lvl * n_img + img, minlength=L * n_img)
        per = per.reshape(L, n_img)
        sizes = per.sum(1).tolist()
        nums = [p.to(torch.int32) for p in per]
    outs = list(torch.split(rois[order], sizes))
    return outs, restore[:, None], nums


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=True, name=None):
    """RPN proposals per image: the ``pre_nms_top_n`` best anchors
    (``scores [N, A, H, W]``), decoded with ``bbox_deltas [N, 4A, H, W]``
    and ``variances``, clipped to ``img_size [N, 2]`` (h, w), boxes
    smaller than ``min_size`` dropped, NMS at ``nms_thresh``, then the
    ``post_nms_top_n`` best. Returns ``(rois [R, 4], scores [R, 1][,
    rois_num [N] int32])``. Decoding, clipping, filtering and top-k run on
    the device; the one read of it per image is NMS's."""
    if eta < 1.0:
        raise ValueError(f"generate_proposals: eta={eta} (adaptive NMS) is "
                         "not supported; eta >= 1 is plain NMS")
    N, A = scores.shape[:2]
    off = 1.0 if pixel_offset else 0.0
    anc = anchors.reshape(-1, 4)
    var = variances.reshape(-1, 4)
    ims = img_size.to(scores.dtype)
    all_rois, all_scores, nums = [], [], []
    for n in range(N):
        s = scores[n].permute(1, 2, 0).reshape(-1)
        d = bbox_deltas[n].reshape(A, 4, *bbox_deltas.shape[2:]) \
            .permute(2, 3, 0, 1).reshape(-1, 4)
        order = torch.sort(s, descending=True, stable=True).indices
        order = order[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], anc[order], var[order]
        aw = a[:, 2] - a[:, 0] + off
        ah = a[:, 3] - a[:, 1] + off
        acx = a[:, 0] + aw * 0.5
        acy = a[:, 1] + ah * 0.5
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        wd = torch.exp(torch.clamp(v[:, 2] * d[:, 2], max=10.0)) * aw
        ht = torch.exp(torch.clamp(v[:, 3] * d[:, 3], max=10.0)) * ah
        zero = torch.zeros((), dtype=s.dtype, device=s.device)
        iw, ih = ims[n, 1] - off, ims[n, 0] - off
        x1 = torch.clamp(cx - wd / 2, zero, iw)
        y1 = torch.clamp(cy - ht / 2, zero, ih)
        x2 = torch.clamp(cx + wd / 2 - off, zero, iw)
        y2 = torch.clamp(cy + ht / 2 - off, zero, ih)
        boxes = torch.stack([x1, y1, x2, y2], 1)
        big = ((x2 - x1 + off >= min_size) & (y2 - y1 + off >= min_size))
        # a dropped box ranks last and is never kept, so it suppresses none
        ranked = torch.where(big, s, torch.full_like(s, float("-inf")))
        kept = _greedy_keep(boxes, ranked, float(nms_thresh),
                            post_nms_top_n)
        all_rois.append(boxes[kept])
        all_scores.append(s[kept][:, None])
        nums.append(kept.shape[0])
    rois = torch.cat(all_rois) if all_rois else scores.new_zeros(0, 4)
    rscores = torch.cat(all_scores) if all_scores else \
        scores.new_zeros(0, 1)
    if return_rois_num:
        return rois, rscores, torch.tensor(nums, dtype=torch.int32,
                                           device=scores.device)
    return rois, rscores


# ------------------------------------------------- deformable conv ------
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 (v2 with ``mask``): kernel tap k of output
    (i, j) samples ``x`` bilinearly at its grid position plus ``offset``'s
    (dy, dx) for its deformable group (corners outside the map read 0),
    scaled by ``mask``; the taps then contract with ``weight [Cout,
    Cin / groups, kh, kw]`` as one grouped ``torch.matmul``."""
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    N, Cin, H, W = x.shape
    Cout, Cg, kh, kw = weight.shape
    Ho = (H + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    Wo = (W + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    K, dg, P = kh * kw, deformable_groups, Ho * Wo
    cg = Cin // dg
    dev = x.device
    off = offset.reshape(N, dg, K, 2, P)
    msk = mask.reshape(N, dg, K, P) if mask is not None else None
    base_y = (torch.arange(Ho, device=dev) * stride[0] - padding[0])
    base_x = (torch.arange(Wo, device=dev) * stride[1] - padding[1])
    base_y = base_y[:, None].expand(Ho, Wo).reshape(P).to(x.dtype)
    base_x = base_x[None, :].expand(Ho, Wo).reshape(P).to(x.dtype)
    ky = (torch.arange(kh, device=dev) * dilation[0]).repeat_interleave(kw)
    kx = (torch.arange(kw, device=dev) * dilation[1]).repeat(kh)
    img = x.reshape(N, dg, cg, H * W)
    taps = []
    for k in range(K):
        ys = base_y + ky[k] + off[:, :, k, 0]                    # [N, dg, P]
        xs = base_x + kx[k] + off[:, :, k, 1]
        y0, x0 = torch.floor(ys), torch.floor(xs)
        wy, wx = ys - y0, xs - x0
        res = 0.0
        for dy, fy in ((0, 1 - wy), (1, wy)):
            for dx, fx in ((0, 1 - wx), (1, wx)):
                yy, xx = y0 + dy, x0 + dx
                inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                flat = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
                g = img.gather(3, flat[:, :, None, :].expand(N, dg, cg, P))
                res = res + g * (fy * fx * inb)[:, :, None]
        if msk is not None:
            res = res * msk[:, :, k][:, :, None]
        taps.append(res.reshape(N, Cin, P))
    samp = torch.stack(taps, 2)                                # [N, Cin, K, P]
    sg = samp.reshape(N, groups, Cg * K, P)
    wg = weight.reshape(groups, Cout // groups, Cg * K)
    out = torch.matmul(wg[None], sg).reshape(N, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# -------------------------------------------------------- yolo loss -----
def _bce_logits(p, t):
    return p.clamp_min(0) - p * t + torch.log1p(torch.exp(-p.abs()))


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """The reference's YOLOv3 loss per image, ``[N]``: each ground truth
    (``gt_box [N, G, 4]`` cx, cy, w, h in image pixels, ``gt_label [N,
    G]``; w or h 0 marks padding) is matched to its best anchor by
    wh-IoU over all ``anchors``, and trains the cell it falls in when that
    anchor is in ``anchor_mask``: squared errors of the box terms weighted
    by ``2 - w h``, class BCE (label-smoothed), objectness BCE; a
    prediction whose IoU with some ground truth reaches ``ignore_thresh``
    takes no negative objectness term."""
    if gt_score is not None:
        raise ValueError("yolo_loss: gt_score (mixup weights) is not "
                         "supported; pass None")
    if scale_x_y != 1.0:
        raise ValueError(f"yolo_loss: scale_x_y={scale_x_y} is not "
                         "supported; only 1.0")
    xv = _float(x)
    gb = gt_box.to(xv.dtype)
    dev, dt = xv.device, xv.dtype
    na = len(anchor_mask)
    N, _, H, W = xv.shape
    in_w, in_h = downsample_ratio * W, downsample_ratio * H
    anc_all = np.asarray(anchors, np.float32).reshape(-1, 2)
    anc = torch.as_tensor(anc_all[np.asarray(anchor_mask)],
                          device=dev).to(dt)
    feat = xv.reshape(N, na, 5 + class_num, H, W)
    tx, ty, tw, th, tobj = (feat[:, :, i] for i in range(5))
    tcls = feat[:, :, 5:]                                   # [N, na, C, H, W]
    gx, gy = _div(gb[..., 0], in_w), _div(gb[..., 1], in_h)
    gw, gh = _div(gb[..., 2], in_w), _div(gb[..., 3], in_h)
    valid = (gw > 0) & (gh > 0)                             # [N, G]
    aw = _div(torch.as_tensor(anc_all[:, 0], device=dev).to(dt), in_w)
    ah = _div(torch.as_tensor(anc_all[:, 1], device=dev).to(dt), in_h)
    inter = torch.minimum(gw[..., None], aw) * torch.minimum(gh[..., None],
                                                             ah)
    union = gw[..., None] * gh[..., None] + aw * ah - inter
    best = torch.argmax(inter / union.clamp_min(1e-10), -1)  # [N, G]
    mask_ids = torch.as_tensor(np.asarray(anchor_mask), device=dev)
    matched = best[..., None] == mask_ids                   # [N, G, na]
    gi = (gx * W).to(torch.int32).clamp(0, W - 1).long()
    gj = (gy * H).to(torch.int32).clamp(0, H - 1).long()
    a_idx = torch.argmax(matched.to(torch.uint8), -1)       # [N, G]
    sel = valid & matched.any(-1)
    b = torch.arange(N, device=dev)[:, None]
    flat = (a_idx * H + gj) * W + gi
    obj_target = torch.zeros(N, na * H * W, dtype=dt,
                             device=dev).scatter_reduce(
        1, flat, sel.to(dt), reduce="amax").reshape(N, na, H, W)
    px = torch.sigmoid(tx[b, a_idx, gj, gi])
    py = torch.sigmoid(ty[b, a_idx, gj, gi])
    pw, ph = tw[b, a_idx, gj, gi], th[b, a_idx, gj, gi]
    tx_t, ty_t = gx * W - gi, gy * H - gj
    tw_t = torch.log((gw * in_w / anc[a_idx, 0]).clamp_min(1e-9))
    th_t = torch.log((gh * in_h / anc[a_idx, 1]).clamp_min(1e-9))
    box_scale = 2.0 - gw * gh
    zero = torch.zeros((), dtype=dt, device=dev)
    box_loss = torch.where(sel, box_scale * (
        (px - tx_t) ** 2 + (py - ty_t) ** 2 + (pw - tw_t) ** 2
        + (ph - th_t) ** 2), zero).sum(1)
    smooth = 1.0 / max(class_num, 1) if use_label_smooth else 0.0
    cls_pred = tcls[b, a_idx, :, gj, gi]                    # [N, G, C]
    onehot = torch.nn.functional.one_hot(
        gt_label.long().clamp(0, class_num - 1), class_num).to(dt)
    cls_t = onehot * (1 - smooth) + smooth * (1 - onehot) \
        if use_label_smooth else onehot
    cls_loss = torch.where(sel[..., None], _bce_logits(cls_pred, cls_t),
                           zero).sum((1, 2))
    # objectness: every prediction's best IoU with the image's ground truth
    bx = (torch.sigmoid(tx) + torch.arange(W, device=dev)) / W
    by = (torch.sigmoid(ty) + torch.arange(H, device=dev)[:, None]) / H
    bw = torch.exp(tw.clamp(-10, 10)) * anc[None, :, 0, None, None] / in_w
    bh = torch.exp(th.clamp(-10, 10)) * anc[None, :, 1, None, None] / in_h
    px1, px2 = (bx - bw / 2)[:, None], (bx + bw / 2)[:, None]
    py1, py2 = (by - bh / 2)[:, None], (by + bh / 2)[:, None]
    e = (slice(None), slice(None), None, None, None)
    gx1, gx2 = (gx - gw / 2)[e], (gx + gw / 2)[e]
    gy1, gy2 = (gy - gh / 2)[e], (gy + gh / 2)[e]
    iw = (torch.minimum(px2, gx2) - torch.maximum(px1, gx1)).clamp_min(0)
    ih = (torch.minimum(py2, gy2) - torch.maximum(py1, gy1)).clamp_min(0)
    inter_ = iw * ih
    uni = (bw * bh)[:, None] + (gw * gh)[e] - inter_
    iou = torch.where(valid[e], inter_ / uni.clamp_min(1e-10), zero)
    best_iou = iou.amax(1) if iou.shape[1] else torch.zeros_like(bx)
    noobj = (best_iou < ignore_thresh) & (obj_target < 0.5)
    obj_loss = torch.where((obj_target > 0.5) | noobj,
                           _bce_logits(tobj, obj_target), zero).sum((1, 2, 3))
    return box_loss + cls_loss + obj_loss
