"""Detection layers: the SSD pipeline and the RPN / ROI building blocks.

≙ paddle_tpu/layers/detection.py (reference python/paddle/fluid/layers/
detection.py: prior_box, multi_box_head, bipartite_match, target_assign,
ssd_loss, detection_output, iou_similarity, box_coder, anchor_generator,
roi_pool). The reference's LoD ground-truth batches are dense [B, G, ...]
tensors whose zero-area rows are padding; matching and NMS are fixed-count
loops on the device (ops/detection_ops.py).
"""

from __future__ import annotations

from ..core.dtypes import dtype_name
from ..core.enforce import InvalidArgumentError, enforce
from ..layer_helper import LayerHelper
from . import nn as _nn
from .tensor import concat

__all__ = [
    "prior_box", "density_prior_box", "anchor_generator", "iou_similarity",
    "box_coder", "bipartite_match", "target_assign", "multiclass_nms",
    "detection_output", "ssd_loss", "roi_pool", "multi_box_head",
    "rpn_target_assign", "generate_proposals", "detection_map",
]


def _tmp(helper, dtype, shape):
    return helper.create_tmp_variable(dtype=dtype, shape=shape)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    """≙ reference layers/detection.py prior_box. Returns (boxes, variances)
    of shape [H, W, P, 4]."""
    from ..ops.detection_ops import expand_aspect_ratios
    helper = LayerHelper("prior_box", name=name)
    fh, fw = input.shape[2], input.shape[3]
    n_ar = len(expand_aspect_ratios(aspect_ratios, flip))
    P = len(min_sizes) * n_ar + (len(max_sizes) if max_sizes else 0)
    dtype = dtype_name(input.dtype)
    boxes = _tmp(helper, dtype, [fh, fw, P, 4])
    variances = _tmp(helper, dtype, [fh, fw, P, 4])
    helper.append_op(
        type="prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [variances]},
        attrs={"min_sizes": list(min_sizes),
               "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios),
               "variances": list(variance), "flip": flip, "clip": clip,
               "step_w": steps[0], "step_h": steps[1], "offset": offset})
    return boxes, variances


def density_prior_box(input, image, densities, fixed_sizes,
                      fixed_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5, name=None):
    """≙ reference layers/detection.py density_prior_box."""
    helper = LayerHelper("density_prior_box", name=name)
    fh, fw = input.shape[2], input.shape[3]
    P = sum(d * d * len(fixed_ratios) for d in densities)
    dtype = dtype_name(input.dtype)
    boxes = _tmp(helper, dtype, [fh, fw, P, 4])
    variances = _tmp(helper, dtype, [fh, fw, P, 4])
    helper.append_op(
        type="density_prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [variances]},
        attrs={"densities": list(densities),
               "fixed_sizes": list(fixed_sizes),
               "fixed_ratios": list(fixed_ratios),
               "variances": list(variance), "clip": clip,
               "step_w": steps[0], "step_h": steps[1], "offset": offset})
    return boxes, variances


def anchor_generator(input, anchor_sizes, aspect_ratios, stride,
                     variance=(0.1, 0.1, 0.2, 0.2), offset=0.5, name=None):
    """≙ reference layers/detection.py anchor_generator (RPN)."""
    helper = LayerHelper("anchor_generator", name=name)
    fh, fw = input.shape[2], input.shape[3]
    P = len(anchor_sizes) * len(aspect_ratios)
    dtype = dtype_name(input.dtype)
    anchors = _tmp(helper, dtype, [fh, fw, P, 4])
    variances = _tmp(helper, dtype, [fh, fw, P, 4])
    helper.append_op(
        type="anchor_generator", inputs={"Input": [input]},
        outputs={"Anchors": [anchors], "Variances": [variances]},
        attrs={"anchor_sizes": list(anchor_sizes),
               "aspect_ratios": list(aspect_ratios),
               "stride": list(stride), "variances": list(variance),
               "offset": offset})
    return anchors, variances


def iou_similarity(x, y, name=None):
    """≙ reference layers iou_similarity: [N,4]x[M,4] -> [N,M]."""
    helper = LayerHelper("iou_similarity", name=name)
    shape = list(x.shape[:-1]) + [y.shape[0]]
    out = _tmp(helper, dtype_name(x.dtype), shape)
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None):
    """≙ reference layers box_coder."""
    helper = LayerHelper("box_coder", name=name)
    m = prior_box.shape[0]
    if code_type == "encode_center_size":
        shape = [target_box.shape[0], m, 4]
    else:
        shape = list(target_box.shape)
    out = _tmp(helper, dtype_name(target_box.dtype), shape)
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(type="box_coder", inputs=inputs,
                     outputs={"OutputBox": [out]},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized})
    return out


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    """≙ reference layers bipartite_match. Returns
    (match_indices, match_distance)."""
    helper = LayerHelper("bipartite_match", name=name)
    shape = list(dist_matrix.shape[:-2]) + [dist_matrix.shape[-1]]
    idx = _tmp(helper, "int32", shape)
    dist = _tmp(helper, dtype_name(dist_matrix.dtype), shape)
    helper.append_op(type="bipartite_match",
                     inputs={"DistMat": [dist_matrix]},
                     outputs={"ColToRowMatchIndices": [idx],
                              "ColToRowMatchDist": [dist]},
                     attrs={"match_type": match_type,
                            "dist_threshold": dist_threshold})
    return idx, dist


def target_assign(input, matched_indices, mismatch_value=0, name=None):
    """≙ reference layers target_assign. Returns (out, out_weight)."""
    helper = LayerHelper("target_assign", name=name)
    b, m = matched_indices.shape[0], matched_indices.shape[1]
    k = input.shape[-1]
    out = _tmp(helper, dtype_name(input.dtype), [b, m, k])
    w = _tmp(helper, "float32", [b, m, 1])
    helper.append_op(type="target_assign",
                     inputs={"X": [input],
                             "MatchIndices": [matched_indices]},
                     outputs={"Out": [out], "OutWeight": [w]},
                     attrs={"mismatch_value": mismatch_value})
    return out, w


def multiclass_nms(bboxes, scores, score_threshold=0.01, nms_top_k=400,
                   keep_top_k=200, nms_threshold=0.3, background_label=0,
                   normalized=True, name=None):
    """≙ reference multiclass_nms. Returns (out [B,keep_top_k,6], rois_num
    [B]) — padded rows carry label -1 (static translation of the LoD out)."""
    helper = LayerHelper("multiclass_nms", name=name)
    b = scores.shape[0]
    out = _tmp(helper, "float32", [b, keep_top_k, 6])
    num = _tmp(helper, "int32", [b])
    helper.append_op(type="multiclass_nms",
                     inputs={"BBoxes": [bboxes], "Scores": [scores]},
                     outputs={"Out": [out], "NmsRoisNum": [num]},
                     attrs={"score_threshold": score_threshold,
                            "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                            "nms_threshold": nms_threshold,
                            "background_label": background_label})
    return out, num


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, name=None):
    """≙ reference detection_output: decode loc offsets against priors then
    multiclass NMS. loc [B,M,4] offsets, scores [B,C,M] (softmaxed or raw
    probabilities). Returns (out, rois_num)."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    return multiclass_nms(decoded, scores,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label, name=name)


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, name=None):
    """≙ reference layers roi_pool. rois [R,5] (batch_idx,x1,y1,x2,y2)."""
    helper = LayerHelper("roi_pool", name=name)
    r = rois.shape[0]
    c = input.shape[1]
    out = _tmp(helper, dtype_name(input.dtype),
               [r, c, pooled_height, pooled_width])
    helper.append_op(type="roi_pool",
                     inputs={"X": [input], "ROIs": [rois]},
                     outputs={"Out": [out]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def multi_box_head(inputs, image, num_classes, min_sizes, max_sizes=None,
                   aspect_ratios=None, steps=None, offset=0.5, flip=True,
                   clip=False, name=None):
    """≙ reference multi_box_head: per-feature-map conv heads emitting loc
    offsets + class scores over generated priors.

    inputs: list of feature maps [N,C,H,W]. Returns
    (mbox_locs [B,M,4], mbox_confs [B,M,C] raw logits — softmax +
    transpose to [B,C,M] before detection_output/multiclass_nms —,
    boxes [M,4], variances [M,4])."""
    enforce(len(inputs) == len(min_sizes), "one min_size per input",
            exc=InvalidArgumentError)
    enforce(max_sizes is None or len(max_sizes) == len(inputs),
            "one max_size per input", exc=InvalidArgumentError)
    enforce(steps is None or len(steps) == len(inputs),
            "one step per input", exc=InvalidArgumentError)
    aspect_ratios = aspect_ratios or [[1.0]] * len(inputs)
    enforce(len(aspect_ratios) == len(inputs),
            "one aspect_ratio list per input", exc=InvalidArgumentError)
    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        ms = min_sizes[i] if isinstance(min_sizes[i], (list, tuple)) \
            else [min_sizes[i]]
        mx = None
        if max_sizes:
            mx = max_sizes[i] if isinstance(max_sizes[i], (list, tuple)) \
                else [max_sizes[i]]
        step = steps[i] if steps else (0.0, 0.0)
        if not isinstance(step, (list, tuple)):
            step = (float(step), float(step))
        box, var = prior_box(feat, image, ms, mx, aspect_ratios[i],
                             flip=flip, clip=clip, steps=step, offset=offset)
        p = box.shape[2]
        m_i = box.shape[0] * box.shape[1] * p
        loc = _nn.conv2d(feat, num_filters=p * 4, filter_size=3, padding=1,
                         name=name and f"{name}_loc{i}")
        loc = _nn.transpose(loc, perm=[0, 2, 3, 1])
        loc = _nn.reshape(loc, shape=[-1, m_i, 4])
        conf = _nn.conv2d(feat, num_filters=p * num_classes, filter_size=3,
                          padding=1, name=name and f"{name}_conf{i}")
        conf = _nn.transpose(conf, perm=[0, 2, 3, 1])
        conf = _nn.reshape(conf, shape=[-1, m_i, num_classes])
        locs.append(loc)
        confs.append(conf)
        boxes_all.append(_nn.reshape(box, shape=[m_i, 4]))
        vars_all.append(_nn.reshape(var, shape=[m_i, 4]))
    mbox_locs = concat(locs, axis=1)                 # [B, M, 4]
    mbox_confs = concat(confs, axis=1)               # [B, M, C]
    boxes = concat(boxes_all, axis=0)                # [M, 4]
    variances = concat(vars_all, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, loc_loss_weight=1.0, conf_loss_weight=1.0,
             mismatch_value=0, name=None):
    """SSD multibox loss (≙ reference layers/detection.py ssd_loss):
    match priors to ground truth (bipartite + per-prediction), encode box
    targets, smooth-L1 localization loss on positives, softmax confidence
    loss with hard negative mining at neg_pos_ratio.

    location [B,M,4]; confidence [B,M,C] raw logits; gt_box [B,G,4]
    (zero-area rows = padding); gt_label [B,G] int; prior_box [M,4].
    Returns the scalar loss.
    """
    helper = LayerHelper("ssd_loss", name=name)
    dtype = dtype_name(location.dtype)
    loss = _tmp(helper, dtype, [])
    inputs = {"Location": [location], "Confidence": [confidence],
              "GTBox": [gt_box], "GTLabel": [gt_label],
              "PriorBox": [prior_box]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(type="ssd_loss", inputs=inputs,
                     outputs={"Loss": [loss]},
                     attrs={"background_label": background_label,
                            "overlap_threshold": overlap_threshold,
                            "neg_pos_ratio": neg_pos_ratio,
                            "loc_loss_weight": loc_loss_weight,
                            "conf_loss_weight": conf_loss_weight,
                            "mismatch_value": mismatch_value})
    return loss


def rpn_target_assign(anchor_box, gt_box, rpn_batch_size_per_im=256,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, name=None):
    """≙ reference layers/detection.py rpn_target_assign
    (rpn_target_assign_op.cc). Static-shape form: returns per-anchor
    (labels, box_deltas, box_inside_weight) — labels [N] in {-1 ignore,
    0 bg, 1 fg}, deltas/weights [N, 4] — instead of gathered index lists
    (shapes stay static)."""
    helper = LayerHelper("rpn_target_assign", name=name)
    n = anchor_box.shape[0]
    dtype = dtype_name(anchor_box.dtype)
    labels = _tmp(helper, "int32", [n])
    deltas = _tmp(helper, dtype, [n, 4])
    inside_w = _tmp(helper, dtype, [n, 4])
    helper.append_op(type="rpn_target_assign",
                     inputs={"Anchor": [anchor_box], "GtBox": [gt_box]},
                     outputs={"Labels": [labels], "BoxDeltas": [deltas],
                              "BoxInsideWeight": [inside_w]},
                     attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
                            "rpn_fg_fraction": rpn_fg_fraction,
                            "rpn_positive_overlap": rpn_positive_overlap,
                            "rpn_negative_overlap": rpn_negative_overlap})
    return labels, deltas, inside_w


def generate_proposals(scores, bbox_deltas, im_info, anchors,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, name=None):
    """≙ reference generate_proposals_op.cc. scores [B, A], bbox_deltas
    [B, A, 4], anchors [A, 4], im_info [B, 3] (h, w, scale). Returns
    (rpn_rois [B, post, 4], rpn_roi_probs [B, post, 1],
    rpn_rois_num [B])."""
    helper = LayerHelper("generate_proposals", name=name)
    b = scores.shape[0]
    dtype = dtype_name(scores.dtype)
    rois = _tmp(helper, dtype, [b, post_nms_top_n, 4])
    probs = _tmp(helper, dtype, [b, post_nms_top_n, 1])
    nums = _tmp(helper, "int32", [b])
    helper.append_op(type="generate_proposals",
                     inputs={"Scores": [scores],
                             "BboxDeltas": [bbox_deltas],
                             "ImInfo": [im_info], "Anchors": [anchors]},
                     outputs={"RpnRois": [rois], "RpnRoiProbs": [probs],
                              "RpnRoisNum": [nums]},
                     attrs={"pre_nms_top_n": pre_nms_top_n,
                            "post_nms_top_n": post_nms_top_n,
                            "nms_thresh": nms_thresh, "min_size": min_size})
    return rois, probs, nums


def detection_map(detect_res, label, class_num, overlap_threshold=0.5,
                  ap_version="integral", name=None):
    """≙ reference detection_map_op.cc, IN-graph (the host-side fallback
    lives in metrics.DetectionMAP). detect_res [B, K, 6] rows
    (label, score, box) — the multiclass_nms layout; label (gt) [B, G, 5]
    rows (label, box), zero-area padding. Returns the scalar mAP."""
    enforce(ap_version == "integral",
            "only integral AP is implemented (11point would silently be a "
            "different metric)", exc=InvalidArgumentError)
    helper = LayerHelper("detection_map", name=name)
    m_ap = _tmp(helper, "float32", [1])
    helper.append_op(type="detection_map",
                     inputs={"DetectRes": [detect_res], "Label": [label]},
                     outputs={"MAP": [m_ap]},
                     attrs={"class_num": class_num,
                            "overlap_threshold": overlap_threshold,
                            "ap_type": ap_version})
    return m_ap
