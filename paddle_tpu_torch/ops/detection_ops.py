"""Detection / vision ops: priors, box coding, matching, NMS, ROI pooling,
the SSD loss, RPN targets and proposals, in-graph detection mAP.

≙ paddle_tpu/ops/detection_ops.py (reference paddle/fluid/operators/
detection/: prior_box_op, density_prior_box_op, box_coder_op,
iou_similarity_op, bipartite_match_op, target_assign_op,
multiclass_nms_op, anchor_generator_op, rpn_target_assign_op,
generate_proposals_op, detection_map_op; roi_pool_op.cc). No TPU kernel
sits behind them: XLA chose the kernels in the JAX package, and here each
op is torch calls.

The shapes are static, as in the JAX package: ground truth is dense
[B, G, ...] with zero-area rows as padding, NMS output is padded with
label / score / box -1 and a count. The greedy loops (bipartite matching:
min(N, M) steps; NMS: min(nms_top_k, M) steps; mAP matching: K steps) are
Python loops of a fixed count with no early exit, each step one batch of
torch ops over every (image, class) at once, so nothing is read on the
host. NMS computes the IoU of each step's selected box against the boxes
it may suppress, the same row the JAX package reads from its [M, M]
matrix, so no [M, M] matrix is made (115.6 MB an image at SSD's 5376
priors).

Ties and order follow jax: argmax takes the first index, jnp.argsort and
lax.top_k keep the lower index among equal values (stable sorts).
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.registry import register_op
from .reduce_ops import top_k_lower_first
from .tensor_ops import take_along

_NEG = -1e9


def expand_aspect_ratios(aspect_ratios, flip):
    """The prior aspect ratios without duplicates, the implicit 1.0 first
    and each ratio's flip after it when `flip`; the layer and the op share
    it, so a declared prior count is the emitted one."""
    ars = [1.0]
    for ar in aspect_ratios or [1.0]:
        if any(abs(float(ar) - a) < 1e-6 for a in ars):
            continue
        ars.append(float(ar))
        if flip and not any(abs(1.0 / float(ar) - a) < 1e-6 for a in ars):
            ars.append(1.0 / float(ar))
    return ars


# ---------------------------------------------------------------------------
# similarity + coding
# ---------------------------------------------------------------------------

def _area(box):
    return torch.clamp_min(box[..., 2] - box[..., 0], 0) * \
        torch.clamp_min(box[..., 3] - box[..., 1], 0)


def _iou(x, y):
    """x [..., N, 4], y [..., M, 4] (xmin, ymin, xmax, ymax) -> [..., N, M]
    IoU (leading dims broadcast)."""
    lt = torch.maximum(x[..., :, None, :2], y[..., None, :, :2])
    rb = torch.minimum(x[..., :, None, 2:], y[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(x)[..., :, None] + _area(y)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-10), 0.0)


@register_op("iou_similarity")
def _iou_similarity(ctx, ins, attrs):
    """≙ iou_similarity_op: X [N, 4] or [B, N, 4] against Y [M, 4]."""
    return {"Out": [_iou(ins["X"][0], ins["Y"][0])]}


def _center_size(box):
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    return box[..., 0] + w / 2, box[..., 1] + h / 2, w, h


@register_op("box_coder")
def _box_coder(ctx, ins, attrs):
    """≙ box_coder_op.cc: boxes encoded against (or decoded from) priors
    with variances. PriorBox [M, 4], PriorBoxVar [M, 4] (optional);
    encode_center_size: TargetBox [N, 4] -> [N, M, 4] offsets;
    decode_center_size: TargetBox [N, M, 4] offsets -> [N, M, 4] boxes."""
    prior = ins["PriorBox"][0]
    target = ins["TargetBox"][0]
    pvar = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") else \
        torch.ones((prior.shape[0], 4), dtype=prior.dtype,
                   device=prior.device)
    norm = 0.0 if attrs.get("box_normalized", True) else 1.0
    pcx, pcy, pw, ph = _center_size(prior)
    pw, ph = pw + norm, ph + norm
    if attrs.get("code_type", "encode_center_size") == "encode_center_size":
        tcx, tcy, tw, th = _center_size(target)
        tw, th = tw + norm, th + norm
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(torch.clamp_min(tw[:, None] / pw[None, :], 1e-10))
        dh = torch.log(torch.clamp_min(th[:, None] / ph[None, :], 1e-10))
        out = torch.stack([dx, dy, dw, dh], dim=-1) / pvar[None, :, :]
    else:
        d = target * pvar[None, :, :]
        cx = d[..., 0] * pw[None, :] + pcx[None, :]
        cy = d[..., 1] * ph[None, :] + pcy[None, :]
        w = torch.exp(d[..., 2]) * pw[None, :]
        h = torch.exp(d[..., 3]) * ph[None, :]
        out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - norm,
                           cy + h / 2 - norm], dim=-1)
    return {"OutputBox": [out]}


# ---------------------------------------------------------------------------
# priors / anchors: functions of static shapes and attributes, built once
# per plan (LowerCtx.constant)
# ---------------------------------------------------------------------------

def _grid(fh, fw, step_w, step_h, offset, dtype, dev):
    cx = (torch.arange(fw, dtype=dtype, device=dev) + offset) * step_w
    cy = (torch.arange(fh, dtype=dtype, device=dev) + offset) * step_h
    return cx, cy


def _corners(cxg, cyg, pw, ph, iw, ih):
    return torch.stack([(cxg - pw / 2) / iw, (cyg - ph / 2) / ih,
                        (cxg + pw / 2) / iw, (cyg + ph / 2) / ih], dim=-1)


def _with_variances(boxes, attrs):
    var = torch.tensor(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                       dtype=boxes.dtype).to(boxes.device)
    return boxes, var.expand(boxes.shape)


@register_op("prior_box")
def _prior_box(ctx, ins, attrs):
    """≙ prior_box_op.cc (SSD priors). Input [N, C, H, W] (or NHWC) feature
    map and Image; Boxes and Variances [H, W, P, 4]: for each min_size
    every aspect ratio, then the sqrt(min * max) square."""
    feat, img = ins["Input"][0], ins["Image"][0]
    if attrs.get("data_format", "NCHW") == "NCHW":
        fh, fw, ih, iw = feat.shape[2], feat.shape[3], img.shape[2], \
            img.shape[3]
    else:
        fh, fw, ih, iw = feat.shape[1], feat.shape[2], img.shape[1], \
            img.shape[2]
    min_sizes = list(attrs["min_sizes"])
    max_sizes = list(attrs.get("max_sizes", []) or [])
    if max_sizes and len(max_sizes) != len(min_sizes):
        raise ValueError(
            f"prior_box: len(max_sizes)={len(max_sizes)} must equal "
            f"len(min_sizes)={len(min_sizes)}")
    ars = expand_aspect_ratios(attrs.get("aspect_ratios", [1.0]),
                               attrs.get("flip", True))
    widths, heights = [], []
    for i, ms in enumerate(min_sizes):
        for ar in ars:
            widths.append(ms * np.sqrt(ar))
            heights.append(ms / np.sqrt(ar))
        if max_sizes:
            widths.append(np.sqrt(ms * max_sizes[i]))
            heights.append(np.sqrt(ms * max_sizes[i]))

    def make():
        dt, dev = feat.dtype, feat.device
        pw = torch.tensor(widths, dtype=dt).to(dev)
        ph = torch.tensor(heights, dtype=dt).to(dev)
        cx, cy = _grid(fh, fw, attrs.get("step_w", 0.0) or iw / fw,
                       attrs.get("step_h", 0.0) or ih / fh,
                       attrs.get("offset", 0.5), dt, dev)
        p = pw.shape[0]
        boxes = _corners(cx[None, :, None].expand(fh, fw, p),
                         cy[:, None, None].expand(fh, fw, p), pw, ph, iw, ih)
        if attrs.get("clip", True):
            boxes = boxes.clamp(0.0, 1.0)
        return _with_variances(boxes, attrs)

    boxes, variances = ctx.constant(make)
    return {"Boxes": [boxes], "Variances": [variances]}


@register_op("density_prior_box")
def _density_prior_box(ctx, ins, attrs):
    """≙ density_prior_box_op.cc: a dense grid of priors in each cell, a
    density for each fixed size."""
    feat, img = ins["Input"][0], ins["Image"][0]
    fh, fw, ih, iw = feat.shape[2], feat.shape[3], img.shape[2], img.shape[3]
    fixed_sizes = list(attrs["fixed_sizes"])
    densities = list(attrs["densities"])
    if len(densities) != len(fixed_sizes):
        raise ValueError(
            f"density_prior_box: len(densities)={len(densities)} must "
            f"equal len(fixed_sizes)={len(fixed_sizes)}")
    step_w = attrs.get("step_w", 0.0) or iw / fw
    step_h = attrs.get("step_h", 0.0) or ih / fh
    ws, hs, sx, sy = [], [], [], []
    for size, dens in zip(fixed_sizes, densities):
        for ar in list(attrs.get("fixed_ratios", [1.0])):
            shift = 1.0 / dens
            for di in range(dens):
                for dj in range(dens):
                    ws.append(size * np.sqrt(ar))
                    hs.append(size / np.sqrt(ar))
                    sx.append((dj + 0.5) * shift - 0.5)  # cell-relative
                    sy.append((di + 0.5) * shift - 0.5)

    def make():
        dt, dev = feat.dtype, feat.device
        pw, ph, ox, oy = (torch.tensor(v, dtype=dt).to(dev)
                          for v in (ws, hs, sx, sy))
        ox, oy = ox * step_w, oy * step_h
        p = pw.shape[0]
        cx, cy = _grid(fh, fw, step_w, step_h, attrs.get("offset", 0.5), dt,
                       dev)
        cxg = (cx[None, :, None] + ox[None, None, :]).expand(fh, fw, p)
        cyg = (cy[:, None, None] + oy[None, None, :]).expand(fh, fw, p)
        boxes = _corners(cxg, cyg, pw, ph, iw, ih)
        if attrs.get("clip", True):
            boxes = boxes.clamp(0.0, 1.0)
        return _with_variances(boxes, attrs)

    boxes, variances = ctx.constant(make)
    return {"Boxes": [boxes], "Variances": [variances]}


@register_op("anchor_generator")
def _anchor_generator(ctx, ins, attrs):
    """≙ anchor_generator_op.cc (RPN anchors in absolute pixels)."""
    feat = ins["Input"][0]
    fh, fw = feat.shape[2], feat.shape[3]
    stride = list(attrs.get("stride", [16.0, 16.0]))
    ws, hs = [], []
    for r in list(attrs.get("aspect_ratios", [0.5, 1.0, 2.0])):
        for s in list(attrs.get("anchor_sizes", [64., 128., 256., 512.])):
            area = stride[0] * stride[1]
            base_w = np.round(np.sqrt(area / r))
            ws.append(s / np.sqrt(area) * base_w)
            hs.append(s / np.sqrt(area) * np.round(base_w * r))

    def make():
        dt, dev = feat.dtype, feat.device
        pw = torch.tensor(ws, dtype=dt).to(dev)
        ph = torch.tensor(hs, dtype=dt).to(dev)
        cx, cy = _grid(fh, fw, stride[0], stride[1],
                       attrs.get("offset", 0.5), dt, dev)
        p = pw.shape[0]
        cxg = cx[None, :, None].expand(fh, fw, p)
        cyg = cy[:, None, None].expand(fh, fw, p)
        anchors = torch.stack([cxg - pw / 2, cyg - ph / 2, cxg + pw / 2,
                               cyg + ph / 2], dim=-1)
        return _with_variances(anchors, attrs)

    anchors, variances = ctx.constant(make)
    return {"Anchors": [anchors], "Variances": [variances]}


# ---------------------------------------------------------------------------
# matching + target assignment
# ---------------------------------------------------------------------------

def bipartite_match(dist, match_type, overlap_threshold):
    """dist [B, N, M] (rows ground truth, columns priors) -> (match indices
    [B, M] int32, a row or -1; match distances [B, M]). Greedy: min(N, M)
    steps, each taking the largest entry left (the first in row-major
    order among equals) while it is above 0, for every image at once.
    `per_prediction` then matches each unmatched column to its best row
    where that clears `overlap_threshold`."""
    b, n, m = dist.shape
    dev = dist.device
    midx = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    mdist = torch.zeros((b, m), dtype=dist.dtype, device=dev)
    row_used = torch.zeros((b, n), dtype=torch.bool, device=dev)
    col_used = torch.zeros((b, m), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    for _ in range(min(n, m)):
        masked = torch.where(row_used[:, :, None] | col_used[:, None, :],
                             _NEG, dist).reshape(b, n * m)
        flat = masked.argmax(dim=1)
        best = masked.gather(1, flat[:, None])[:, 0]
        r, c = flat // m, flat % m
        take_c = (best > 0)[:, None] & (cols[None] == c[:, None])
        midx = torch.where(take_c, r[:, None].to(torch.int32), midx)
        mdist = torch.where(take_c, best[:, None], mdist)
        row_used = row_used | ((best > 0)[:, None] & (rows[None] == r[:, None]))
        col_used = col_used | take_c
    if match_type == "per_prediction":
        best_val, best_row = dist.max(dim=1)
        extra = (midx < 0) & (best_val > overlap_threshold)
        midx = torch.where(extra, best_row.to(torch.int32), midx)
        mdist = torch.where(extra, best_val, mdist)
    return midx, mdist


@register_op("bipartite_match")
def _bipartite_match(ctx, ins, attrs):
    """≙ bipartite_match_op.cc. DistMat [B, N, M] (or [N, M]);
    ColToRowMatchIndices [B, M] (-1 unmatched), ColToRowMatchDist."""
    dist = ins["DistMat"][0]
    squeeze = dist.dim() == 2
    midx, mdist = bipartite_match(dist[None] if squeeze else dist,
                                  attrs.get("match_type", "bipartite"),
                                  attrs.get("dist_threshold", 0.5))
    if squeeze:
        midx, mdist = midx[0], mdist[0]
    return {"ColToRowMatchIndices": [midx], "ColToRowMatchDist": [mdist]}


def _rows_of(x, index):
    """x [B, N, K] rows picked per image by index [B, M] (clamped into
    range, as jax's gather clamps) -> [B, M, K]."""
    index = index.to(torch.long).clamp(0, x.shape[1] - 1)
    return x.gather(1, index[..., None].expand(-1, -1, x.shape[2]))


@register_op("target_assign")
def _target_assign(ctx, ins, attrs):
    """≙ target_assign_op.cc: each matched prior takes its ground-truth
    row. X [B, N, K], MatchIndices [B, M]; Out [B, M, K] (mismatch_value
    where unmatched), OutWeight [B, M, 1]."""
    x, match = ins["X"][0], ins["MatchIndices"][0]
    matched = (match >= 0)[..., None]
    out = torch.where(matched, _rows_of(x, torch.clamp_min(match, 0)),
                      torch.full((), attrs.get("mismatch_value", 0),
                                 dtype=x.dtype, device=x.device))
    return {"Out": [out], "OutWeight": [matched.to(torch.float32)]}


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def nms(boxes, scores, iou_threshold, top_k):
    """Greedy NMS for every (image, class) at once. boxes [B, M, 4], scores
    [B, K, M] (entries at or below _NEG / 2 are out) -> keep mask
    [B, K, M]. min(top_k, M) steps (M when top_k <= 0), each selecting the
    highest live score (the first index among equals), keeping it when it
    is live and in, and suppressing the boxes whose IoU with it reaches
    the threshold."""
    b, k, m = scores.shape
    keep = torch.zeros((b, k, m), dtype=torch.bool, device=scores.device)
    alive = torch.ones_like(keep)
    cols = torch.arange(m, device=scores.device)
    for _ in range(min(top_k, m) if top_k > 0 else m):
        idx = torch.where(alive, scores, _NEG).argmax(dim=-1)   # [B, K]
        sel = cols == idx[..., None]                              # [B, K, M]
        ok = alive.gather(-1, idx[..., None])[..., 0] & \
            (scores.gather(-1, idx[..., None])[..., 0] > _NEG / 2)
        box = boxes.gather(1, idx[..., None].expand(b, k, 4))    # [B, K, 4]
        suppress = _iou(box[:, :, None, :], boxes[:, None, :, :])[:, :, 0] \
            >= iou_threshold
        keep = keep | (sel & ok[..., None])
        alive = torch.where(ok[..., None], alive & ~suppress, alive) & ~sel
    return keep


@register_op("multiclass_nms")
def _multiclass_nms(ctx, ins, attrs):
    """≙ multiclass_nms_op.cc. BBoxes [B, M, 4], Scores [B, C, M]. Out
    [B, keep_top_k, 6] rows (label, score, x1, y1, x2, y2), best first,
    padded with -1 rows; NmsRoisNum [B]. (The reference emits a LoD
    tensor; the padded form and a count is the static translation.) The
    background class is not suppressed at all: its scores are dropped,
    as the JAX package drops them after its NMS."""
    bboxes, scores = ins["BBoxes"][0], ins["Scores"][0]
    thr = attrs.get("score_threshold", 0.01)
    keep_top_k = attrs.get("keep_top_k", 200)
    bg = attrs.get("background_label", 0)
    b, c, m = scores.shape
    kk = keep_top_k if keep_top_k > 0 else c * m
    # the foreground classes by slicing (an index list would be copied
    # from the host each call)
    split = [(0, c)] if not 0 <= bg < c else [(0, bg), (bg + 1, c)]
    sc = torch.cat([scores[:, lo:hi] for lo, hi in split], 1)
    valid = sc > thr
    s = torch.where(valid, sc, _NEG)
    keep = nms(bboxes, s, attrs.get("nms_threshold", 0.3),
               attrs.get("nms_top_k", 400))
    fg = torch.where(keep & valid, sc, _NEG)
    kept = fg if len(split) == 1 else torch.cat(
        [fg[:, :bg], torch.full_like(scores[:, :1], _NEG), fg[:, bg:]], 1)
    k = min(kk, c * m)
    top, idx = top_k_lower_first(kept.reshape(b, c * m), k)
    valid = top > _NEG / 2
    box = bboxes.gather(1, (idx % m)[..., None].expand(b, k, 4))
    rows = torch.cat([torch.where(valid, (idx // m).to(torch.float32),
                                  -1.0)[..., None],
                      torch.where(valid, top, -1.0)[..., None],
                      torch.where(valid[..., None], box, -1.0)], dim=-1)
    if k < kk:
        rows = torch.cat([rows, rows.new_full((b, kk - k, 6), -1.0)], 1)
    return {"Out": [rows], "NmsRoisNum": [valid.to(torch.int32).sum(1)]}


# ---------------------------------------------------------------------------
# ROI pooling
# ---------------------------------------------------------------------------

@register_op("roi_pool")
def _roi_pool(ctx, ins, attrs):
    """≙ roi_pool_op.cc: quantized max-pool of each ROI's bins. X
    [N, C, H, W]; ROIs [R, 5] rows (batch index, x1, y1, x2, y2) in image
    coordinates; Out [R, C, ph, pw], 0 for an empty bin. The max over a
    bin's rectangle is taken along W, then along H (a rectangle's max is
    separable), so no [R, C, ph, pw, H, W] tensor is made."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph, pw = attrs["pooled_height"], attrs["pooled_width"]
    scale = attrs.get("spatial_scale", 1.0)
    n, c, h, w = x.shape
    dev, dt = x.device, x.dtype
    bidx = rois[:, 0].to(torch.long)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale) for i in range(1, 5))
    bin_h = torch.clamp_min(y2 - y1 + 1, 1.0) / ph
    bin_w = torch.clamp_min(x2 - x1 + 1, 1.0) / pw

    def bins(nbin, size, start, extent):
        i = torch.arange(nbin, dtype=dt, device=dev)[None]
        lo = (torch.floor(i * size[:, None]) + start[:, None]).clamp(0, extent)
        hi = (torch.ceil((i + 1) * size[:, None]) + start[:, None]).clamp(
            0, extent)
        pos = torch.arange(extent, dtype=dt, device=dev)
        return (pos >= lo[..., None]) & (pos < hi[..., None])  # [R, bins, E]

    hmask, wmask = bins(ph, bin_h, y1, h), bins(pw, bin_w, x1, w)
    feat = x[bidx]                                            # [R, C, H, W]
    along_w = torch.where(wmask[:, None, None], feat[:, :, :, None, :],
                          _NEG).amax(-1)                      # [R, C, H, pw]
    out = torch.where(hmask[:, None, :, :, None], along_w[:, :, None],
                      _NEG).amax(3)                           # [R, C, ph, pw]
    empty = ~(hmask.any(-1)[:, :, None] & wmask.any(-1)[:, None, :])
    return {"Out": [torch.where(empty[:, None], 0.0, out).to(dt)]}


# ---------------------------------------------------------------------------
# SSD multibox loss
# ---------------------------------------------------------------------------

def _smooth_l1(x):
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def ssd_match(gt_box, prior, overlap_threshold):
    """Each prior's ground-truth row or -1 [B, M]: bipartite matching, then
    per-prediction matching at `overlap_threshold`, padding rows (zero
    area) never matched."""
    iou = torch.where((_area(gt_box) > 0)[..., None],
                      _iou(gt_box, prior[None]), _NEG)
    return bipartite_match(iou, "per_prediction", overlap_threshold)[0]


def ssd_mine(ce, pos, neg_pos_ratio):
    """The hard negatives [B, M]: the neg_pos_ratio * positives unmatched
    priors of highest loss (stable order: the lower index among equal
    losses), at most all of them."""
    m = ce.shape[1]
    num_pos = pos.sum(1)
    num_neg = torch.minimum((neg_pos_ratio * num_pos).to(torch.int32),
                            m - num_pos)
    order = torch.argsort(-torch.where(pos, _NEG, ce), dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(m, device=ce.device).expand_as(order))
    return (~pos) & (rank < num_neg[:, None])


@register_op("ssd_loss")
def _ssd_loss(ctx, ins, attrs):
    """≙ the composite the reference builds in layers/detection.py
    ssd_loss (iou_similarity -> bipartite_match -> target_assign ->
    smooth L1 + softmax cross-entropy with hard negative mining) in one
    lowering, every image at once. Matching, the box targets and the
    mining are cut from the graph (detached); the loss flows through
    Location and Confidence."""
    loc = ins["Location"][0]            # [B, M, 4]
    conf = ins["Confidence"][0]         # [B, M, C]
    gt_box = ins["GTBox"][0]            # [B, G, 4], zero-area rows padding
    gt_label = ins["GTLabel"][0]        # [B, G]
    prior = ins["PriorBox"][0]          # [M, 4]
    # the default variances filled on the device (a tensor made from a
    # host list would be copied each step)
    pvar = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") else \
        torch.stack([torch.full((prior.shape[0],), v, dtype=loc.dtype,
                                device=loc.device)
                     for v in (0.1, 0.1, 0.2, 0.2)], 1)
    if gt_label.dim() == 3:
        gt_label = gt_label[..., 0]
    with torch.no_grad():
        match = ssd_match(gt_box.detach(), prior.detach(),
                          attrs.get("overlap_threshold", 0.5))
        pos = match >= 0
        pcx, pcy, pw, ph = _center_size(prior)
        gcx, gcy, gw, gh = _center_size(_rows_of(gt_box, torch.clamp_min(
            match, 0)))
        t = torch.stack([(gcx - pcx) / pw / pvar[:, 0],
                         (gcy - pcy) / ph / pvar[:, 1],
                         torch.log(torch.clamp_min(gw / pw, 1e-10))
                         / pvar[:, 2],
                         torch.log(torch.clamp_min(gh / ph, 1e-10))
                         / pvar[:, 3]], dim=-1)
        target = torch.where(pos, gt_label.to(torch.long).gather(
            1, torch.clamp_min(match, 0).to(torch.long)),
            attrs.get("background_label", 0))
    loc_l = _smooth_l1(loc - t).sum(-1) * pos
    logp = torch.log_softmax(conf, dim=-1)
    ce = -take_along(logp, target[..., None], -1)[..., 0]
    neg = ssd_mine(ce.detach(), pos, attrs.get("neg_pos_ratio", 3.0))
    conf_l = (ce * (pos | neg)).sum(1)
    denom = torch.clamp_min(pos.sum().to(loc.dtype), 1.0)
    total = (attrs.get("loc_loss_weight", 1.0) * loc_l.sum(1).sum()
             + attrs.get("conf_loss_weight", 1.0) * conf_l.sum()) / denom
    return {"Loss": [total]}


# ---------------------------------------------------------------------------
# RPN: anchor target assignment + proposal generation
# ---------------------------------------------------------------------------

def _rank_desc(score):
    """rank[..., i]: i's place when sorting score descending (0 the best;
    stable)."""
    order = torch.argsort(-score, dim=-1, stable=True)
    return torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=score.device)
        .expand_as(order))


@register_op("rpn_target_assign")
def _rpn_target_assign(ctx, ins, attrs):
    """≙ rpn_target_assign_op.cc, static-shape form: per-anchor Labels [N]
    (-1 ignore, 0 background, 1 foreground), BoxDeltas [N, 4] toward each
    anchor's best ground truth and BoxInsideWeight [N, 4] (1 for kept
    foreground). Foreground: IoU >= the positive overlap, or some ground
    truth's best anchor; the sets are capped at rpn_batch_size_per_im by
    IoU rank (use_random=False), hardest negatives first."""
    anchor, gt = ins["Anchor"][0], ins["GtBox"][0]
    batch = attrs.get("rpn_batch_size_per_im", 256)
    n = anchor.shape[0]
    valid_gt = _area(gt) > 0
    iou = torch.where(valid_gt[None, :], _iou(anchor, gt), -1.0)  # [N, G]
    max_iou, best_gt = iou.max(dim=1)
    # which anchors are some valid ground truth's best (jnp argmax: first)
    gt_best = torch.zeros(n + 1, dtype=torch.int32, device=anchor.device)
    gt_best = gt_best.index_put(
        (torch.where(valid_gt, iou.argmax(dim=0), n),),
        torch.ones_like(valid_gt, dtype=torch.int32),
        accumulate=True)[:n] > 0
    fg = (max_iou >= attrs.get("rpn_positive_overlap", 0.7)) | gt_best
    bg = (~fg) & (max_iou < attrs.get("rpn_negative_overlap", 0.3))
    fg_keep = fg & (_rank_desc(torch.where(fg, max_iou, _NEG))
                    < int(batch * attrs.get("rpn_fg_fraction", 0.5)))
    bg_keep = bg & (_rank_desc(torch.where(bg, max_iou, _NEG))
                    < batch - fg_keep.sum())
    labels = torch.where(fg_keep, 1, torch.where(bg_keep, 0, -1)).to(
        torch.int32)
    acx, acy, aw, ah = _center_size(anchor)
    gcx, gcy, gw, gh = _center_size(gt[best_gt.clamp(0, gt.shape[0] - 1)])
    aw_s, ah_s = torch.clamp_min(aw, 1e-8), torch.clamp_min(ah, 1e-8)
    deltas = torch.stack([(gcx - acx) / aw_s, (gcy - acy) / ah_s,
                          torch.log(torch.clamp_min(gw / aw_s, 1e-10)),
                          torch.log(torch.clamp_min(gh / ah_s, 1e-10))], -1)
    inside_w = fg_keep[:, None].expand(n, 4).to(anchor.dtype)
    return {"Labels": [labels], "BoxDeltas": [deltas * inside_w],
            "BoxInsideWeight": [inside_w]}


@register_op("generate_proposals")
def _generate_proposals(ctx, ins, attrs):
    """≙ generate_proposals_op.cc, every image at once. Scores [B, A],
    BboxDeltas [B, A, 4], Anchors [A, 4], ImInfo [B, 3] (h, w, scale):
    the top pre_nms_top_n by score, decoded, clipped to the image, boxes
    under min_size dropped, NMS; RpnRois [B, post, 4], RpnRoiProbs
    [B, post, 1], RpnRoisNum [B] (tail rows zero)."""
    scores, deltas = ins["Scores"][0], ins["BboxDeltas"][0]
    anchors, info = ins["Anchors"][0], ins["ImInfo"][0]
    pre_n = min(attrs.get("pre_nms_top_n", 6000), anchors.shape[0])
    post_n = attrs.get("post_nms_top_n", 1000)
    b = scores.shape[0]
    acx, acy, aw, ah = _center_size(anchors)
    top, idx = top_k_lower_first(scores, pre_n)             # [B, pre]
    d = deltas.gather(1, idx[..., None].expand(b, pre_n, 4))
    aw_i, ah_i = aw[idx], ah[idx]
    cx = d[..., 0] * aw_i + acx[idx]
    cy = d[..., 1] * ah_i + acy[idx]
    w = torch.exp(torch.clamp_max(d[..., 2], 10.0)) * aw_i
    h = torch.exp(torch.clamp_max(d[..., 3], 10.0)) * ah_i
    ih, iw = info[:, 0:1], info[:, 1:2]
    zero = torch.zeros((), dtype=cx.dtype, device=cx.device)
    boxes = torch.stack([torch.clamp(cx - w / 2, zero, iw - 1),
                         torch.clamp(cy - h / 2, zero, ih - 1),
                         torch.clamp(cx + w / 2, zero, iw - 1),
                         torch.clamp(cy + h / 2, zero, ih - 1)], -1)
    ms = attrs.get("min_size", 0.1) * info[:, 2:3]
    ok = (boxes[..., 2] - boxes[..., 0] >= ms) & \
        (boxes[..., 3] - boxes[..., 1] >= ms)
    sc = torch.where(ok, top, _NEG)
    keep = nms(boxes, sc[:, None], attrs.get("nms_thresh", 0.5), post_n)[:, 0]
    sel = torch.where(keep, sc, _NEG)
    if pre_n < post_n:
        # fewer candidates than the declared rows: pad to [post_n]
        pad = post_n - pre_n
        sel = torch.cat([sel, sel.new_full((b, pad), _NEG)], 1)
        boxes = torch.cat([boxes, boxes.new_zeros((b, pad, 4))], 1)
        top = torch.cat([top, top.new_zeros((b, pad))], 1)
    order = torch.argsort(-sel, dim=1, stable=True)[:, :post_n]
    valid = sel.gather(1, order) > _NEG / 2
    rois = boxes.gather(1, order[..., None].expand(b, post_n, 4)) * \
        valid[..., None]
    probs = (top.gather(1, order) * valid)[..., None]
    return {"RpnRois": [rois], "RpnRoiProbs": [probs],
            "RpnRoisNum": [valid.to(torch.int32).sum(1)]}


# ---------------------------------------------------------------------------
# in-graph evaluation: detection mAP + positive/negative pairs
# ---------------------------------------------------------------------------

@register_op("detection_map")
def _detection_map(ctx, ins, attrs):
    """≙ detection_map_op.cc in-graph. DetectRes [B, K, 6] rows (label,
    score, box), the multiclass_nms layout with label < 0 padding; Label
    [B, G, 5] rows (label, box), zero-area padding. Integral AP per class,
    averaged over the classes with ground truth; detections match greedily
    by score, one ground truth each, at overlap_threshold.

    The JAX package walks all B * K detections in one global score order;
    a detection's match depends only on the earlier ones of its own image,
    so here each image's detections are walked in their own (stable)
    score order, K steps for every image and class at once, and the hits
    are then read in the global order (stable, the flat index deciding
    ties, as there) for the precision / recall curve."""
    det, gt = ins["DetectRes"][0], ins["Label"][0]
    thr = attrs.get("overlap_threshold", 0.5)
    nc = attrs["class_num"]
    b, k, _ = det.shape
    g = gt.shape[1]
    dev = det.device
    cls = torch.arange(nc, device=dev)[:, None, None]
    gt_c = (_area(gt[..., 1:5]) > 0)[None] & (gt[None, ..., 0] == cls)
    score = torch.where(det[None, ..., 0] == cls, det[None, ..., 1], _NEG)
    iou = _iou(det[..., 2:6], gt[..., 1:5])                   # [B, K, G]
    order = torch.argsort(-score, dim=-1, stable=True)       # [nc, B, K]
    bidx = torch.arange(b, device=dev)[None, :]
    gcols = torch.arange(g, device=dev)
    kcols = torch.arange(k, device=dev)
    matched = torch.zeros_like(gt_c)
    tp = torch.zeros_like(score, dtype=torch.bool)
    fp = torch.zeros_like(tp)
    for i in range(k):
        di = order[..., i]                                    # [nc, B]
        live = score.gather(-1, di[..., None])[..., 0] > _NEG / 2
        row = torch.where(gt_c & ~matched, iou[bidx, di], -1.0)
        gi = row.argmax(-1)
        hit = (row.gather(-1, gi[..., None])[..., 0] >= thr) & live
        matched = matched | (hit[..., None] & (gcols == gi[..., None]))
        at = kcols == di[..., None]
        tp = tp | (at & hit[..., None])
        fp = fp | (at & (live & ~hit)[..., None])
    glob = torch.argsort(-score.reshape(nc, b * k), dim=1, stable=True)
    ctp = torch.cumsum(tp.reshape(nc, -1).gather(1, glob).float(), 1)
    cfp = torch.cumsum(fp.reshape(nc, -1).gather(1, glob).float(), 1)
    npos = gt_c.sum((1, 2))
    recall = ctp / torch.clamp_min(npos.float(), 1.0)[:, None]
    precision = ctp / torch.clamp_min(ctp + cfp, 1.0)
    rec_prev = torch.cat([torch.zeros_like(recall[:, :1]), recall[:, :-1]],
                         1)
    ap = ((recall - rec_prev) * precision).sum(1)
    has_gt = npos > 0
    m_ap = torch.where(has_gt, ap, 0.0).sum() / torch.clamp_min(
        has_gt.float().sum(), 1.0)
    return {"MAP": [m_ap]}


@register_op("positive_negative_pair")
def _positive_negative_pair(ctx, ins, attrs):
    """≙ positive_negative_pair_op.cc: within each query, the pairs Score
    orders as Label does (positive), against it (negative) or ties
    (neutral). Score / Label / QueryID [N, 1]."""
    s = ins["Score"][0].reshape(-1)
    lab = ins["Label"][0].reshape(-1)
    q = ins["QueryID"][0].reshape(-1)
    pair = (q[:, None] == q[None, :]) & (lab[:, None] > lab[None, :])
    ds = s[:, None] - s[None, :]
    pos = (pair & (ds > 0)).float().sum()
    neg = (pair & (ds < 0)).float().sum()
    neu = (pair & (ds == 0)).float().sum()
    if ins.get("AccumulatePositivePair"):
        pos = pos + ins["AccumulatePositivePair"][0].reshape(())
        neg = neg + ins["AccumulateNegativePair"][0].reshape(())
        neu = neu + ins["AccumulateNeutralPair"][0].reshape(())
    return {"PositivePair": [pos.reshape(1)],
            "NegativePair": [neg.reshape(1)],
            "NeutralPair": [neu.reshape(1)]}
