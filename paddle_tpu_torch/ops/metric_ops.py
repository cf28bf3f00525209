"""Metric op lowerings.

≙ paddle_tpu/ops/metric_ops.py (reference operators/{accuracy,auc,
precision_recall,mean_iou}_op.cc): `accuracy` (the classifiers' training
metric), the streaming `auc`, `precision_recall` and `mean_iou`. Counts
are scatter-adds on the device; an index outside [0, n) adds nothing (and
one in [-n, 0) counts from the end), as jax's scatter drops it.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op


@register_op("accuracy")
def _accuracy(ctx, ins, attrs):
    """≙ accuracy_op.cc: the share of rows whose label is among their top-k
    indices."""
    indices = ins["Indices"][0]  # [N, k]
    label = ins["Label"][0]      # [N, 1]
    if label.dim() == 1:
        label = label[:, None]
    hit = (indices == label).any(dim=1)
    correct = hit.to(torch.float32).sum()
    # filled on the device: torch.tensor(value, device=cuda) would copy
    # from the host and wait for the stream, stalling the step
    total = torch.full((), float(indices.shape[0]), device=indices.device)
    return {"Accuracy": [correct / total],
            "Correct": [correct.to(torch.int32)],
            "Total": [total.to(torch.int32)]}


def _count(n, index, values):
    """≙ jnp.zeros(n).at[index].add(values): index wrapped from the end
    when in [-n, 0), dropped (adds 0) when otherwise out of range."""
    index = index.to(torch.long)
    index = torch.where(index < 0, index + n, index)
    keep = (index >= 0) & (index < n)
    return torch.zeros(n, dtype=values.dtype, device=values.device) \
        .index_add(0, index.clamp(0, n - 1), values * keep)


@register_op("auc")
def _auc(ctx, ins, attrs):
    """Streaming AUC over threshold buckets (≙ auc_op.cc): the batch's
    positives and negatives added to StatPos / StatNeg by bucket, then the
    trapezoid under the ROC points from the highest threshold down."""
    preds = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    nt = attrs.get("num_thresholds", 200)
    pos_prob = preds[:, 1] if preds.dim() == 2 else preds.reshape(-1)
    bucket = (pos_prob * nt).to(torch.int32).clamp(0, nt).to(torch.long)
    is_pos = (label > 0).to(stat_pos.dtype)
    stat_pos = stat_pos.index_add(0, bucket, is_pos)
    stat_neg = stat_neg.index_add(0, bucket, 1 - is_pos)
    tp = torch.flip(torch.cumsum(torch.flip(stat_pos, [0]), 0), [0])
    fp = torch.flip(torch.cumsum(torch.flip(stat_neg, [0]), 0), [0])
    tpr = tp / torch.clamp_min(tp[0], 1)
    fpr = fp / torch.clamp_min(fp[0], 1)
    return {"AUC": [-torch.trapezoid(tpr, fpr)], "StatPosOut": [stat_pos],
            "StatNegOut": [stat_neg]}


@register_op("precision_recall")
def _precision_recall(ctx, ins, attrs):
    """Per-class true / false positives and false negatives added to
    StatesInfo [C, 4] (tp, fp, tn unused, fn); macro and micro precision,
    recall and F1 of the accumulated states."""
    indices = ins["Indices"][0].reshape(-1)
    labels = ins["Labels"][0].reshape(-1)
    n = attrs["class_number"]
    dev = indices.device
    states = ins["StatesInfo"][0] if ins.get("StatesInfo") else \
        torch.zeros((n, 4), device=dev)
    hit = (indices == labels).to(torch.float32)
    miss = 1 - hit
    zero = torch.zeros(n, device=dev)
    states = states + torch.stack(
        [_count(n, labels, hit), _count(n, indices, miss), zero,
         _count(n, labels, miss)], dim=1)
    tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]
    precision = tp / torch.clamp_min(tp + fp, 1e-12)
    recall = tp / torch.clamp_min(tp + fn, 1e-12)
    f1 = 2 * precision * recall / torch.clamp_min(precision + recall, 1e-12)
    micro_p = tp.sum() / torch.clamp_min((tp + fp).sum(), 1e-12)
    micro_r = tp.sum() / torch.clamp_min((tp + fn).sum(), 1e-12)
    micro_f1 = 2 * micro_p * micro_r / torch.clamp_min(micro_p + micro_r,
                                                        1e-12)
    metrics = torch.stack([precision.mean(), recall.mean(), f1.mean(),
                           micro_p, micro_r, micro_f1])
    return {"BatchMetrics": [metrics], "AccumMetrics": [metrics],
            "AccumStatesInfo": [states]}


@register_op("mean_iou")
def _mean_iou(ctx, ins, attrs):
    """The confusion matrix of labels against predictions; mean IoU over
    the classes with a nonempty union; OutWrong counts a mismatch against
    both its predicted and its label class (≙ mean_iou_op.h:95-97)."""
    pred = ins["Predictions"][0].reshape(-1)
    label = ins["Labels"][0].reshape(-1)
    n = attrs["num_classes"]
    ones = torch.ones(pred.shape, dtype=torch.float32, device=pred.device)
    cm = _count(n * n, label.to(torch.long) * n + pred, ones).reshape(n, n)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp_min(union, 1e-12), 0.0)
    mean = iou.sum() / torch.clamp_min(valid.to(torch.float32).sum(), 1)
    return {"OutMeanIou": [mean], "OutWrong": [cm.sum(0) + cm.sum(1)
                                               - 2 * inter],
            "OutCorrect": [inter]}
