"""Contrib operators (counterpart of ``mxnet_tpu/ops/contrib.py``): the SSD
multibox trio, ``box_nms``, ``ROIAlign``, ``SyncBatchNorm``, the deformable
convolutions, the interleaved attention matmuls, ``BilinearResize2D``,
``AdaptiveAvgPooling2D`` and the small ops (``arange_like``,
``div_sqrt_dim``, ``quadratic``, ``gradientmultiplier``, ``getnnz``,
``dynamic_reshape``). ``boolean_mask``, ``index_copy`` and ``allclose``
live in ``indexing.py``.

Shapes stay static, as the reference's: NMS keeps every row and writes -1
over the suppressed ones. Its order is the reference's stable descending
sort (equal scores keep their index order). Rows past ``topk`` and invalid
rows (sorted last) are never kept and never suppress, so the IoU matrix
and the greedy suppression cover the first ``topk`` sorted rows only; the
result is the reference's full scan, bitwise. On the CPU the suppression
is the per-row loop, the counterpart of the reference's ``lax.scan``; on a
CUDA tensor it is a fixed-point iteration over the strictly
lower-triangular suppression matrix, ``keep = valid & ~any(S & keep)``,
whose fixed point is unique (row i depends on rows before it only) and
therefore the loop's result. No op here reads a device value on the host
except that iteration's convergence test.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register

__all__ = ["nms_keep_loop", "nms_keep_fixed_point", "box_nms_plain",
           "multibox_decode"]


def _dev(v, like):
    """``v`` as a tensor of ``like``'s dtype on its device (a CUDA division
    by a host scalar would multiply by its reciprocal)."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# multibox_prior: anchor generation
# ---------------------------------------------------------------------------

@register("_contrib_MultiBoxPrior", aliases=["MultiBoxPrior",
                                             "multibox_prior"],
          ndarray_inputs=["data"])
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """data (B, C, H, W) -> anchors (1, H*W*(S+R-1), 4) in ltrb [0,1]."""
    h, w = data.shape[-2], data.shape[-1]
    sizes, ratios = tuple(sizes), tuple(ratios)
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    f32 = dict(dtype=torch.float32, device=data.device)
    cy = (torch.arange(h, **f32) + offsets[0]) * step_y
    cx = (torch.arange(w, **f32) + offsets[1]) * step_x
    cys, cxs = torch.meshgrid(cy, cx, indexing="ij")
    centers = torch.stack([cxs.reshape(-1), cys.reshape(-1)], dim=-1)
    # the reference's order: (s_i, r_0) for all sizes, then (s_0, r_j)
    wh = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0])) for s in sizes]
    wh += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
           for r in ratios[1:]]
    wh = torch.tensor(np.asarray(wh, np.float32), device=data.device)
    k = wh.shape[0]
    cxy = centers[:, None, :].expand(-1, k, -1)
    half = wh[None, :, :] / 2.0
    ltrb = torch.cat([cxy - half, cxy + half], dim=-1).reshape(1, -1, 4)
    if clip:
        ltrb = torch.clamp(ltrb, 0.0, 1.0)
    return ltrb.to(data.dtype)


# ---------------------------------------------------------------------------
# IoU
# ---------------------------------------------------------------------------

def _iou(a, b):
    """a (..., N, 4), b (..., M, 4) ltrb -> (..., N, M) IoU."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


# ---------------------------------------------------------------------------
# multibox_target: anchor matching and location targets
# ---------------------------------------------------------------------------

@register("_contrib_MultiBoxTarget", aliases=["MultiBoxTarget",
                                              "multibox_target"],
          num_outputs=3, ndarray_inputs=["anchor", "label", "cls_pred"])
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """anchor (1, N, 4); label (B, M, 5) [cls, l, t, r, b] (cls < 0 pads);
    cls_pred (B, C, N). Returns (loc_target (B, N*4), loc_mask (B, N*4),
    cls_target (B, N))."""
    anchors = anchor.reshape(-1, 4)
    n = anchors.shape[0]
    b = label.shape[0]
    v = _dev(variances, anchors)
    valid = label[:, :, 0] >= 0                              # (B, M)
    gt = label[:, :, 1:5]
    iou = _iou(anchors.expand(b, n, 4), gt)                  # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, _dev(-1.0, iou))
    best_gt = torch.argmax(iou, dim=2)                       # (B, N)
    best_iou = torch.gather(iou, 2, best_gt[..., None])[..., 0]
    # each gt's best anchor is matched whatever its IoU: a scatter-max,
    # as padded gts all argmax to anchor 0
    best_anchor = torch.argmax(iou, dim=1)                   # (B, M)
    forced = torch.zeros((b, n), dtype=torch.uint8, device=anchors.device)
    forced = forced.scatter_reduce(1, best_anchor, valid.to(torch.uint8),
                                   "amax") > 0
    matched = forced | (best_iou >= overlap_threshold)
    gt_ltrb = torch.gather(gt, 1, best_gt[..., None].expand(b, n, 4))
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    gw = torch.clamp(gt_ltrb[..., 2] - gt_ltrb[..., 0], min=1e-8)
    gh = torch.clamp(gt_ltrb[..., 3] - gt_ltrb[..., 1], min=1e-8)
    gcx = (gt_ltrb[..., 0] + gt_ltrb[..., 2]) / 2
    gcy = (gt_ltrb[..., 1] + gt_ltrb[..., 3]) / 2
    aw8, ah8 = torch.clamp(aw, min=1e-8), torch.clamp(ah, min=1e-8)
    tx = (gcx - acx) / aw8 / v[0]
    ty = (gcy - acy) / ah8 / v[1]
    tw = torch.log(gw / aw8) / v[2]
    th = torch.log(gh / ah8) / v[3]
    loc_t = torch.stack([tx, ty, tw, th], dim=-1)
    loc_t = torch.where(matched[..., None], loc_t,
                        torch.zeros_like(loc_t)).reshape(b, -1)
    loc_m = matched[..., None].expand(b, n, 4).to(anchors.dtype) \
        .reshape(b, -1)
    cls = torch.gather(label[:, :, 0], 1, best_gt) + 1.0
    cls_t = torch.where(matched, cls, torch.zeros_like(cls))
    dt = cls_pred.dtype
    return loc_t.to(dt), loc_m.to(dt), cls_t.to(dt)


# ---------------------------------------------------------------------------
# NMS: greedy suppression over score-sorted boxes
# ---------------------------------------------------------------------------

def nms_keep_loop(sup, valid):
    """The plain route: the reference's scan, one sorted row at a time.
    ``sup`` (B, T, T) bool, row i's suppressors among the rows before it
    (the strictly lower triangle of IoU > threshold); ``valid`` (B, T).
    Returns the keep mask (B, T)."""
    keep = torch.zeros_like(valid)
    for i in range(valid.shape[1]):
        hit = torch.any(sup[:, i, :i] & keep[:, :i], dim=1)
        keep[:, i] = valid[:, i] & ~hit
    return keep


_CHECK_EVERY = 4  # fixed-point iterations between two convergence tests


def nms_keep_fixed_point(sup, valid):
    """The CUDA route: ``keep = valid & ~any(sup & keep)`` iterated from
    ``keep = valid`` until it stops changing (tested every _CHECK_EVERY
    iterations, one host read each). Row i depends on rows before it
    only, so row i is final after i iterations, the fixed point is unique
    and it is :func:`nms_keep_loop`'s result. T rows need up to T - 1
    iterations, so the test that compares iteration 4j with 4j - 4 must
    reach 4j - 4 >= T - 1: ceil((T - 1) / 4) + 1 rounds. An equal pair
    before then is already the fixed point, as the sequence is eventually
    constant. Counts its iterations and host reads in
    ``nms_keep_fixed_point.iterations`` and ``.syncs``."""
    keep = valid
    for _ in range((valid.shape[1] + _CHECK_EVERY - 2) // _CHECK_EVERY + 1):
        prev = keep
        for _ in range(_CHECK_EVERY):
            keep = valid & ~torch.any(sup & keep[:, None, :], dim=2)
        nms_keep_fixed_point.iterations += _CHECK_EVERY
        nms_keep_fixed_point.syncs += 1
        if torch.equal(keep, prev):
            return keep
    raise RuntimeError("NMS fixed point did not converge")


nms_keep_fixed_point.iterations = 0
nms_keep_fixed_point.syncs = 0


def _box_nms_rows(flat, overlap_thresh, valid_thresh, topk, coord_start,
                  score_index, id_index, background_id, force_suppress,
                  in_format, plain=False):
    """(B, N, K) rows -> (sorted rows (B, N, K), keep (B, N)); ``plain``
    takes the per-row loop on any device."""
    bsz, n, _ = flat.shape
    scores = flat[:, :, score_index]
    boxes = flat[:, :, coord_start:coord_start + 4]
    if in_format == "center":
        cx, cy, w, h = boxes.unbind(-1)
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                             cy + h / 2], dim=-1)
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid &= flat[:, :, id_index] != background_id
    key = torch.where(valid, scores, _dev(float("-inf"), scores))
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    t = n if topk <= 0 else min(int(topk), n)
    top = order[:, :t]
    sboxes = torch.gather(boxes, 1, top[..., None].expand(bsz, t, 4))
    svalid = torch.gather(valid, 1, top)
    iou = _iou(sboxes, sboxes)
    if id_index >= 0 and not force_suppress:
        # suppress within a class only
        ids = torch.gather(flat[:, :, id_index], 1, top)
        iou = torch.where(ids[:, :, None] == ids[:, None, :], iou,
                          torch.zeros_like(iou))
    lower = torch.ones((t, t), dtype=torch.bool,
                       device=flat.device).tril(-1)
    sup = (iou > overlap_thresh) & lower
    if flat.is_cuda and not plain:
        keep_top = nms_keep_fixed_point(sup, svalid)
    else:
        keep_top = nms_keep_loop(sup, svalid)
    keep = torch.zeros((bsz, n), dtype=torch.bool, device=flat.device)
    keep[:, :t] = keep_top
    rows = torch.gather(flat, 1, order[..., None].expand_as(flat))
    return rows, keep


def _nms(data, overlap_thresh, valid_thresh, topk, coord_start, score_index,
         id_index, background_id, force_suppress, in_format, plain):
    if data.device.type == "meta":  # a shape query
        return torch.empty_like(data)
    shape = data.shape
    flat = data.reshape(-1, shape[-2], shape[-1])
    rows, keep = _box_nms_rows(flat, overlap_thresh, valid_thresh, topk,
                               coord_start, score_index, id_index,
                               background_id, force_suppress, in_format,
                               plain)
    out = torch.where(keep[..., None], rows, _dev(-1.0, rows))
    return out.to(data.dtype).reshape(shape)


@register("_contrib_box_nms", aliases=["box_nms",
                                       "_contrib_box_non_maximum_suppression"],
          ndarray_inputs=["data"])
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1, background_id=-1,
             force_suppress=False, in_format="corner", out_format="corner"):
    """data (..., N, K), rows [id?, score, l, t, r, b, ...]; the rows come
    back sorted by score, every field of a suppressed row -1."""
    return _nms(data, overlap_thresh, valid_thresh, topk, coord_start,
                score_index, id_index, background_id, force_suppress,
                in_format, plain=False)


def box_nms_plain(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
                  coord_start=2, score_index=1, id_index=-1,
                  background_id=-1, force_suppress=False,
                  in_format="corner"):
    """``box_nms`` through the plain per-row loop on any device: the oracle
    of the card's fixed-point route."""
    return _nms(data, overlap_thresh, valid_thresh, topk, coord_start,
                score_index, id_index, background_id, force_suppress,
                in_format, plain=True)


# ---------------------------------------------------------------------------
# multibox_detection: decode + NMS
# ---------------------------------------------------------------------------

def multibox_decode(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                    background_id=0, variances=(0.1, 0.1, 0.2, 0.2)):
    """The rows MultiBoxDetection hands to NMS: (B, N, 6) [cls_id, score,
    l, t, r, b], -1 where the best foreground score is not above
    ``threshold``."""
    b, c, n = cls_prob.shape
    anchors = anchor.reshape(-1, 4)
    v = _dev(variances, cls_prob)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    loc = loc_pred.reshape(b, n, 4)
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    w = torch.exp(torch.clamp(loc[..., 2] * v[2], -10, 10)) * aw
    h = torch.exp(torch.clamp(loc[..., 3] * v[3], -10, 10)) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    if 0 <= background_id < c:
        fg = torch.cat([cls_prob[:, :background_id],
                        cls_prob[:, background_id + 1:]], dim=1)
    else:
        fg = cls_prob
    score, cls_id = torch.max(fg, dim=1)
    # torch.max's index is the first maximum, as jnp.argmax's
    rows = torch.cat([cls_id.to(cls_prob.dtype)[..., None],
                      score[..., None], boxes], dim=-1)
    return torch.where((score > threshold)[..., None], rows,
                       _dev(-1.0, rows))


@register("_contrib_MultiBoxDetection", aliases=["MultiBoxDetection",
                                                 "multibox_detection"],
          ndarray_inputs=["cls_prob", "loc_pred", "anchor"])
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                        background_id=0, nms_threshold=0.5,
                        force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """cls_prob (B, C, N), loc_pred (B, N*4), anchor (1, N, 4) ->
    (B, N, 6) rows [cls_id, score, l, t, r, b]; cls_id -1 = suppressed."""
    b, _, n = cls_prob.shape
    if cls_prob.device.type == "meta":
        return torch.empty((b, n, 6), dtype=cls_prob.dtype,
                           device=cls_prob.device)
    decoded = multibox_decode(cls_prob, loc_pred, anchor, clip, threshold,
                              background_id, variances)
    return _box_nms(decoded, overlap_thresh=nms_threshold,
                    valid_thresh=threshold, topk=nms_topk, coord_start=2,
                    score_index=1, id_index=0, background_id=-1,
                    force_suppress=force_suppress)


# ---------------------------------------------------------------------------
# ROIAlign
# ---------------------------------------------------------------------------

def _gather_hw(img, yi, xi):
    """img (R, C, H, W); yi, xi (R, P) int64 -> (R, C, P)."""
    r, c, h, w = img.shape
    idx = (yi * w + xi)[:, None, :].expand(r, c, -1)
    return torch.gather(img.reshape(r, c, h * w), 2, idx)


@register("_contrib_ROIAlign", aliases=["ROIAlign", "roi_align"],
          ndarray_inputs=["data", "rois"])
def _roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
               sample_ratio=2, position_sensitive=False, aligned=False):
    """data (B, C, H, W); rois (R, 5) [batch_idx, x1, y1, x2, y2] ->
    (R, C, ph, pw)."""
    b, c, h, w = data.shape
    ph, pw = pooled_size
    sr = max(int(sample_ratio), 1)
    off = 0.5 if aligned else 0.0
    r = rois.shape[0]
    bi = torch.clamp(rois[:, 0].to(torch.int32), 0, b - 1).long()
    img = torch.index_select(data, 0, bi)
    x1, y1, x2, y2 = (rois[:, k] * spatial_scale - off for k in (1, 2, 3, 4))
    floor_ = 1.0 if not aligned else 1e-8
    rw = torch.clamp(x2 - x1, min=floor_)
    rh = torch.clamp(y2 - y1, min=floor_)
    bin_h, bin_w = rh / ph, rw / pw
    f32 = dict(dtype=rois.dtype, device=rois.device)
    ar_ph = torch.arange(ph, **f32)[None, :, None, None, None]
    ar_pw = torch.arange(pw, **f32)[None, None, :, None, None]
    ar_sy = torch.arange(sr, **f32)[None, None, None, :, None]
    ar_sx = torch.arange(sr, **f32)[None, None, None, None, :]
    e = (slice(None),) + (None,) * 4
    iy = ar_ph * bin_h[e] + y1[e] + (ar_sy + 0.5) * bin_h[e] / sr
    ix = ar_pw * bin_w[e] + x1[e] + (ar_sx + 0.5) * bin_w[e] / sr
    ys = iy.expand(r, ph, pw, sr, sr).reshape(r, -1)
    xs = ix.expand(r, ph, pw, sr, sr).reshape(r, -1)
    y0 = torch.clamp(torch.floor(ys).to(torch.int32), 0, h - 1).long()
    x0 = torch.clamp(torch.floor(xs).to(torch.int32), 0, w - 1).long()
    y1i = torch.clamp(y0 + 1, 0, h - 1)
    x1i = torch.clamp(x0 + 1, 0, w - 1)
    wy = (torch.clamp(ys, 0, h - 1) - y0)[:, None]
    wx = (torch.clamp(xs, 0, w - 1) - x0)[:, None]
    vals = (_gather_hw(img, y0, x0) * (1 - wy) * (1 - wx)
            + _gather_hw(img, y0, x1i) * (1 - wy) * wx
            + _gather_hw(img, y1i, x0) * wy * (1 - wx)
            + _gather_hw(img, y1i, x1i) * wy * wx)
    return vals.reshape(r, c, ph, pw, sr * sr).mean(dim=-1).to(data.dtype)


# ---------------------------------------------------------------------------
# the small ops
# ---------------------------------------------------------------------------

@register("_contrib_arange_like", differentiable=False,
          ndarray_inputs=["data"])
def _arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    if axis is None:
        out = start + step * torch.arange(data.numel(), dtype=torch.float32,
                                          device=data.device)
        return out.reshape(data.shape)
    n = data.shape[int(axis)]
    return start + step * torch.arange(n, dtype=torch.float32,
                                       device=data.device)


@register("_contrib_div_sqrt_dim", ndarray_inputs=["data"])
def _div_sqrt_dim(data):
    return data / torch.sqrt(_dev(float(data.shape[-1]), data))


# ---------------------------------------------------------------------------
# SyncBatchNorm: BatchNorm with E[x^2] - E[x]^2 statistics of the global
# batch. On a mesh of several ranks the data is a DTensor sharded over dp
# (parallel.ShardedTrainer), and the means below reduce over every rank's
# rows (an all-reduce of the partial sums), forward and backward: the
# reference's pmean over "dp". On one device they are the device's.
# ---------------------------------------------------------------------------

def _sync_bn_n_out(kwargs):
    return 3 if kwargs.get("output_mean_var", False) else 1


@register("_contrib_SyncBatchNorm", aliases=["SyncBatchNorm",
                                             "sync_batch_norm"],
          num_outputs=_sync_bn_n_out,
          ndarray_inputs=["data", "gamma", "beta", "moving_mean",
                          "moving_var"])
def _sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                     momentum=0.9, fix_gamma=True, use_global_stats=False,
                     output_mean_var=False, axis=1, ndev=1, key=None,
                     axis_name="dp", _train=None):
    from .nn import _is_training

    ax = int(axis) % data.ndim
    red = tuple(i for i in range(data.ndim) if i != ax)
    train = _is_training() if _train is None else _train
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    bshape = tuple(data.shape[i] if i == ax else 1 for i in range(data.ndim))
    if train and not use_global_stats:
        xf = data.to(torch.promote_types(data.dtype, torch.float32))
        mean = torch.mean(xf, dim=red)
        sq = torch.mean(torch.square(xf), dim=red)
        var = sq - torch.square(mean)
    else:
        mean, var = moving_mean, moving_var
    dt = data.dtype
    inv = torch.rsqrt(var + eps).to(dt)
    out = (data - mean.to(dt).reshape(bshape)) * inv.reshape(bshape) \
        * gamma.to(dt).reshape(bshape) + beta.to(dt).reshape(bshape)
    if output_mean_var:
        return out, mean, var
    return out


# ---------------------------------------------------------------------------
# DeformableConvolution: bilinear samples at p0 + pn + dp (zero outside
# the input), then one product of the columns with the weights
# ---------------------------------------------------------------------------

def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _deform_cols(data, offset, kernel, stride, dilate, pad,
                 num_deformable_group):
    """data (B, C, H, W), offset (B, 2*dg*kh*kw, Ho, Wo), per group and
    tap (dy, dx) pairs -> columns (B, C, Ho, Wo, kh, kw)."""
    kh, kw = kernel
    sh, sw = _pair(stride)
    dh, dw = _pair(dilate)
    ph, pw = _pair(pad)
    b, c, h, w = data.shape
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = int(num_deformable_group)
    cpg = c // dg
    f32 = dict(dtype=offset.dtype, device=data.device)
    oy = torch.arange(ho, **f32) * sh - ph
    ox = torch.arange(wo, **f32) * sw - pw
    ky = torch.arange(kh, **f32) * dh
    kx = torch.arange(kw, **f32) * dw
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]) \
        .expand(ho, wo, kh, kw)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]) \
        .expand(ho, wo, kh, kw)
    off = offset.reshape(b, dg, kh, kw, 2, ho, wo)
    # (B, dg, Ho, Wo, kh, kw)
    dy = torch.movedim(off[:, :, :, :, 0], (2, 3), (4, 5))
    dx = torch.movedim(off[:, :, :, :, 1], (2, 3), (4, 5))
    cols = []
    for gi in range(dg):
        img = data[:, gi * cpg:(gi + 1) * cpg].reshape(b, cpg, h * w)
        y = base_y + dy[:, gi]
        x = base_x + dx[:, gi]
        y0, x0 = torch.floor(y), torch.floor(x)
        wy, wx = y - y0, x - x0
        out = 0.0
        for ddy, sy in ((0, 1 - wy), (1, wy)):
            for ddx, sx in ((0, 1 - wx), (1, wx)):
                yy, xx = y0 + ddy, x0 + ddx
                valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                yc = torch.clamp(yy, 0, h - 1).to(torch.int32).long()
                xc = torch.clamp(xx, 0, w - 1).to(torch.int32).long()
                idx = (yc * w + xc).reshape(b, 1, -1).expand(b, cpg, -1)
                v = torch.gather(img, 2, idx).reshape(
                    (b, cpg) + tuple(yy.shape[1:]))
                out = out + v * (sy * sx * valid)[:, None]
        cols.append(out)
    return torch.cat(cols, dim=1)


def _cols_matmul(cols, weight, bias, no_bias, num_filter, num_group, dtype):
    """(B, C, Ho, Wo, kh, kw) columns x (F, C/g, kh, kw) weights ->
    (B, F, Ho, Wo), accumulated in f32."""
    b, c, ho, wo, kh, kw = cols.shape
    g, f = int(num_group), int(num_filter)
    cols = torch.movedim(cols, 1, 3).reshape(b, ho, wo, g, (c // g) * kh * kw)
    wmat = weight.reshape(g, f // g, (c // g) * kh * kw)
    acc = torch.float32 if cols.dtype in (torch.float16, torch.bfloat16) \
        else cols.dtype
    out = torch.einsum("bhwgk,gfk->bgfhw", cols.to(acc), wmat.to(acc))
    out = out.reshape(b, f, ho, wo).to(dtype)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, f, 1, 1).to(out.dtype)
    return out


@register("_contrib_DeformableConvolution",
          aliases=["DeformableConvolution", "deformable_convolution"],
          ndarray_inputs=["data", "offset", "weight", "bias"])
def _deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                            stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                            num_filter=1, num_group=1, num_deformable_group=1,
                            no_bias=False, layout="NCHW", workspace=1024):
    """data (B, C, H, W), offset (B, 2*dg*kh*kw, Ho, Wo), weight
    (F, C/g, kh, kw) -> (B, F, Ho, Wo)."""
    cols = _deform_cols(data, offset, kernel, stride, dilate, pad,
                        num_deformable_group)
    return _cols_matmul(cols, weight, bias, no_bias, num_filter, num_group,
                        data.dtype)


@register("_contrib_ModulatedDeformableConvolution",
          aliases=["ModulatedDeformableConvolution"],
          ndarray_inputs=["data", "offset", "mask", "weight", "bias"])
def _modulated_deformable_convolution(data, offset, mask, weight, bias=None,
                                      kernel=(3, 3), stride=(1, 1),
                                      dilate=(1, 1), pad=(0, 0), num_filter=1,
                                      num_group=1, num_deformable_group=1,
                                      no_bias=False, layout="NCHW",
                                      workspace=1024):
    """DCNv2: each sampled column scaled by the modulation mask
    (B, dg*kh*kw, Ho, Wo) before the product."""
    dg = int(num_deformable_group)
    cols = _deform_cols(data, offset, kernel, stride, dilate, pad, dg)
    b, c, ho, wo, kh, kw = cols.shape
    m = torch.movedim(mask.reshape(b, dg, kh, kw, ho, wo), (2, 3), (4, 5))
    m = m.repeat_interleave(c // dg, dim=1)
    return _cols_matmul(cols * m.to(cols.dtype), weight, bias, no_bias,
                        num_filter, num_group, data.dtype)


# ---------------------------------------------------------------------------
# Interleaved attention matmuls: GluonNLP BERT's fused projections on
# (S, B, heads*3*head_dim) tensors with per-head interleaved [q|k|v]
# ---------------------------------------------------------------------------

def _bh(t, heads):
    s, b, _, hd = t.shape
    return t.permute(1, 2, 0, 3).reshape(b * heads, s, hd)


def _f32(*ts):
    """Operands of a product accumulated in f32 (the reference's
    ``preferred_element_type``): 16-bit inputs go up to f32, where their
    products are exact."""
    return [t.float() if t.dtype in (torch.float16, torch.bfloat16) else t
            for t in ts]


def _split_selfatt(qkv, heads):
    s, b, e3 = qkv.shape
    x = qkv.reshape(s, b, heads, 3, e3 // (3 * heads))
    return _bh(x[:, :, :, 0], heads), _bh(x[:, :, :, 1], heads), \
        _bh(x[:, :, :, 2], heads)


def _split_kv(kv, heads):
    s, b, e2 = kv.shape
    x = kv.reshape(s, b, heads, 2, e2 // (2 * heads))
    return _bh(x[:, :, :, 0], heads), _bh(x[:, :, :, 1], heads)


def _merge_heads(out, heads):
    bh, s, hd = out.shape
    return torch.movedim(out.reshape(bh // heads, heads, s, hd), 2, 0) \
        .reshape(s, bh // heads, heads * hd)


@register("_contrib_interleaved_matmul_selfatt_qk",
          aliases=["interleaved_matmul_selfatt_qk"],
          ndarray_inputs=["queries_keys_values"])
def _interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """(S, B, H*3*hd) -> scaled q k^T (B*H, S, S)."""
    q, k, _ = _split_selfatt(queries_keys_values, int(heads))
    scale = 1.0 / np.sqrt(q.shape[-1])
    q, k = _f32(q, k)
    return (torch.matmul(q, k.transpose(1, 2)) * scale) \
        .to(queries_keys_values.dtype)


@register("_contrib_interleaved_matmul_selfatt_valatt",
          aliases=["interleaved_matmul_selfatt_valatt"],
          ndarray_inputs=["queries_keys_values", "attention"])
def _interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                       heads=1):
    """attention (B*H, S, S) x v -> (S, B, H*hd)."""
    _, _, v = _split_selfatt(queries_keys_values, int(heads))
    a, vv = _f32(attention.to(v.dtype), v)
    return _merge_heads(torch.matmul(a, vv).to(v.dtype), int(heads))


@register("_contrib_interleaved_matmul_encdec_qk",
          aliases=["interleaved_matmul_encdec_qk"],
          ndarray_inputs=["queries", "keys_values"])
def _interleaved_matmul_encdec_qk(queries, keys_values, heads=1):
    """queries (Sq, B, H*hd); keys_values (Sk, B, H*2*hd) ->
    (B*H, Sq, Sk)."""
    sq, b, e = queries.shape
    h = int(heads)
    hd = e // h
    q = _bh(queries.reshape(sq, b, h, hd), h)
    k, _ = _split_kv(keys_values, h)
    scale = 1.0 / np.sqrt(hd)
    q, k = _f32(q, k)
    return (torch.matmul(q, k.transpose(1, 2)) * scale).to(queries.dtype)


@register("_contrib_interleaved_matmul_encdec_valatt",
          aliases=["interleaved_matmul_encdec_valatt"],
          ndarray_inputs=["keys_values", "attention"])
def _interleaved_matmul_encdec_valatt(keys_values, attention, heads=1):
    _, v = _split_kv(keys_values, int(heads))
    a, vv = _f32(attention.to(v.dtype), v)
    return _merge_heads(torch.matmul(a, vv).to(v.dtype), int(heads))


# ---------------------------------------------------------------------------
# BilinearResize2D, AdaptiveAvgPooling2D
# ---------------------------------------------------------------------------

@register("_contrib_BilinearResize2D", aliases=["BilinearResize2D"],
          ndarray_inputs=["data"])
def _bilinear_resize_2d(data, like=None, height=0, width=0,
                        scale_height=None, scale_width=None, mode="size"):
    from .image_ops import astype, resize

    b, c, h, w = data.shape
    if like is not None and mode in ("like", "to_like_size"):
        height, width = like.shape[-2], like.shape[-1]
    if scale_height is not None:
        height = int(h * scale_height)
    if scale_width is not None:
        width = int(w * scale_width)
    height = int(height) or h
    width = int(width) or w
    return astype(resize(data, (b, c, height, width), "linear"), data.dtype)


@register("_contrib_AdaptiveAvgPooling2D", aliases=["AdaptiveAvgPooling2D"],
          ndarray_inputs=["data"])
def _adaptive_avg_pooling_2d(data, output_size=None):
    b, c, h, w = data.shape
    if output_size is None or output_size == ():
        oh = ow = 1
    elif isinstance(output_size, int):
        oh = ow = output_size
    else:
        oh, ow = (output_size if len(output_size) == 2
                  else (output_size[0], output_size[0]))
    if h % oh == 0 and w % ow == 0:  # every window the same size
        out = data.reshape(b, c, oh, h // oh, ow, w // ow).mean((3, 5))
    else:  # adaptive windows by summed-area tables
        ys = (torch.arange(oh + 1, device=data.device) * h) // oh
        xs = (torch.arange(ow + 1, device=data.device) * w) // ow
        csum = torch.cumsum(torch.cumsum(
            torch.nn.functional.pad(data, (1, 0, 1, 0)), dim=2), dim=3)
        y0, y1, x0, x1 = ys[:-1], ys[1:], xs[:-1], xs[1:]
        area = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).to(data.dtype)
        out = (csum[:, :, y1][:, :, :, x1] - csum[:, :, y0][:, :, :, x1]
               - csum[:, :, y1][:, :, :, x0] + csum[:, :, y0][:, :, :, x0])
        out = out / area
    return out.to(data.dtype)


@register("_contrib_quadratic", aliases=["quadratic"],
          ndarray_inputs=["data", "a", "b"])
def _quadratic(data, a=0.0, b=0.0, c=0.0):
    """The reference's tutorial op."""
    return a * torch.square(data) + b * data + c


class _GradientMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


@register("_contrib_gradientmultiplier", aliases=["gradientmultiplier"],
          ndarray_inputs=["data"])
def _gradientmultiplier(data, scalar=1.0):
    """Identity forward, the gradient scaled by ``scalar`` (a gradient
    reversal when negative)."""
    return _GradientMultiplier.apply(data, float(scalar))


@register("_contrib_getnnz", differentiable=False, ndarray_inputs=["data"])
def _getnnz(data, axis=None):
    # int32: the reference asks for int64 with 64-bit types off, and gets
    # int32
    nz = data != 0
    if axis is None:
        return torch.sum(nz).to(torch.int32)
    return torch.sum(nz, dim=int(axis)).to(torch.int32)


@register("_contrib_dynamic_reshape", ndarray_inputs=["data", "shape_like"])
def _dynamic_reshape(data, shape_like):
    return data.reshape(shape_like.shape)
