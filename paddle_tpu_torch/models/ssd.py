"""SSD object detector (≙ paddle_tpu/models/ssd.py; capability ≙ the
reference's SSD stack built from layers/detection.py: multi_box_head:211,
ssd_loss:264, detection_output). Prior generation, bipartite matching,
hard-negative mining, the smooth-L1 / softmax losses and decode + NMS all
keep static shapes: matching and NMS are fixed-count loops over every image
and class at once on the device (ops/detection_ops.py), so a step reads
nothing on the host.
"""

from __future__ import annotations

from .. import layers
from ..layers import detection as det


def _conv_block(x, ch, n, name):
    for i in range(n):
        x = layers.conv2d(x, num_filters=ch, filter_size=3, padding=1,
                          act="relu", name=f"{name}_{i}")
    return layers.pool2d(x, pool_size=2, pool_type="max", pool_stride=2)


def ssd_detector(img=None, gt_box=None, gt_label=None, num_classes=21,
                 image_shape=(3, 128, 128), num_gt=8, is_test=False):
    """Compact VGG-style SSD over 3 feature scales.

    Returns (loss_or_None, decode_fn_inputs) where decode_fn_inputs =
    (locs, confs, boxes, variances) feed detection_output for inference.
    With is_test=True no loss/gt vars are created.
    """
    if img is None:
        img = layers.data("img", shape=list(image_shape))
    if not is_test:
        if gt_box is None:
            gt_box = layers.data("gt_box", shape=[num_gt, 4])
        if gt_label is None:
            gt_label = layers.data("gt_label", shape=[num_gt],
                                   dtype="int64")

    # backbone: 128 -> 64 -> 32 (f1) -> 16 (f2) -> 8 (f3)
    x = _conv_block(img, 32, 2, "ssd_c1")
    x = _conv_block(x, 64, 2, "ssd_c2")
    f1 = x                                     # stride 4
    x = _conv_block(f1, 128, 2, "ssd_c3")
    f2 = x                                     # stride 8
    x = _conv_block(f2, 128, 2, "ssd_c4")
    f3 = x                                     # stride 16

    s = float(min(image_shape[1], image_shape[2]))
    locs, confs, boxes, variances = det.multi_box_head(
        [f1, f2, f3], img, num_classes=num_classes,
        min_sizes=[[s * 0.1], [s * 0.25], [s * 0.45]],
        max_sizes=[[s * 0.25], [s * 0.45], [s * 0.75]],
        aspect_ratios=[[1.0, 2.0]] * 3, name="ssd_mbh")

    loss = None
    if not is_test:
        loss = det.ssd_loss(locs, confs, gt_box, gt_label, boxes,
                            overlap_threshold=0.5)
    return loss, (locs, confs, boxes, variances)


def ssd_decode(locs, confs, boxes, variances, score_threshold=0.01,
               keep_top_k=100, nms_threshold=0.45):
    """Inference head: softmax scores + decode + class-wise NMS.
    Returns (out [B, keep_top_k, 6] as [label, score, x1, y1, x2, y2],
    num_detections [B])."""
    probs = layers.softmax(confs)
    scores = layers.transpose(probs, perm=[0, 2, 1])   # [B, C, M]
    return det.detection_output(locs, scores, boxes, variances,
                                score_threshold=score_threshold,
                                keep_top_k=keep_top_k,
                                nms_threshold=nms_threshold)
