"""Host-side metric accumulators.

≙ paddle_tpu/metrics.py (reference python/paddle/fluid/metrics.py:
MetricBase, CompositeMetric, Precision, Recall, Accuracy, ChunkEvaluator,
EditDistance, Auc, DetectionMAP). A copy of the JAX package's numpy
classes: they accumulate on the host over fetched minibatch results, once
a batch (a fetch is a device-to-host copy; they lie on no step's path).
The in-graph counterparts are the ops of ops/metric_ops.py and
ops/detection_ops.py.
"""

from __future__ import annotations

import numpy as np

from .core.enforce import InvalidArgumentError, enforce


def _to_numpy(x):
    return np.asarray(x)


class MetricBase:
    """Base: states are attributes not starting with '_'; reset() zeroes them.

    ≙ metrics.py MetricBase (get_config/reset/update/eval contract).
    """

    def __init__(self, name=None):
        self._name = str(name) if name is not None else self.__class__.__name__

    def __str__(self):
        return "MetricBase: %s" % self._name

    def get_config(self):
        states = {a: v for a, v in self.__dict__.items()
                  if not a.startswith("_")}
        config = {"name": self._name, "states": states}
        return config

    def reset(self):
        for attr, value in self.__dict__.items():
            if attr.startswith("_"):
                continue
            if isinstance(value, (int, float)):
                setattr(self, attr, type(value)(0))
            elif isinstance(value, (np.ndarray,)):
                setattr(self, attr, np.zeros_like(value))
            elif isinstance(value, (tuple, list)):
                setattr(self, attr, type(value)())

    def update(self, preds, labels):
        raise NotImplementedError(
            "Should not use it directly, please extend it.")

    def eval(self):
        raise NotImplementedError(
            "Should not use it directly, please extend it.")


class CompositeMetric(MetricBase):
    """Evaluate several metrics over the same preds/labels."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        enforce(isinstance(metric, MetricBase),
                "metric should be an instance of MetricBase",
                exc=InvalidArgumentError)
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    """Binary-classification precision: tp / (tp + fp)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(_to_numpy(preds)).reshape(-1).astype("int64")
        labels = _to_numpy(labels).reshape(-1).astype("int64")
        enforce(preds.shape == labels.shape,
                "preds/labels shape mismatch", exc=InvalidArgumentError)
        pos = preds == 1
        self.tp += int(np.sum(pos & (labels == 1)))
        self.fp += int(np.sum(pos & (labels != 1)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap != 0 else 0.0


class Recall(MetricBase):
    """Binary-classification recall: tp / (tp + fn)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(_to_numpy(preds)).reshape(-1).astype("int64")
        labels = _to_numpy(labels).reshape(-1).astype("int64")
        enforce(preds.shape == labels.shape,
                "preds/labels shape mismatch", exc=InvalidArgumentError)
        truth = labels == 1
        self.tp += int(np.sum(truth & (preds == 1)))
        self.fn += int(np.sum(truth & (preds != 1)))

    def eval(self):
        recall = self.tp + self.fn
        return float(self.tp) / recall if recall != 0 else 0.0


class Accuracy(MetricBase):
    """Running weighted mean of minibatch accuracies (feed the value the
    in-graph `accuracy` op fetched, plus the minibatch weight)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = .0
        self.weight = .0

    def update(self, value, weight):
        enforce(np.isscalar(weight) or np.asarray(weight).size == 1,
                "weight must be a scalar", exc=InvalidArgumentError)
        weight = float(np.asarray(weight).reshape(()))
        enforce(weight >= 0, "weight must be non-negative",
                exc=InvalidArgumentError)
        self.value += float(np.asarray(value).reshape(())) * weight
        self.weight += weight

    def eval(self):
        enforce(self.weight != 0,
                "There is no data in Accuracy Metrics; call update first",
                exc=InvalidArgumentError)
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    """Accumulate counts from the chunk_eval op: precision/recall/F1 over
    chunks (IOB-style sequence labeling)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).reshape(()))
        self.num_label_chunks += int(np.asarray(num_label_chunks).reshape(()))
        self.num_correct_chunks += int(
            np.asarray(num_correct_chunks).reshape(()))

    def eval(self):
        precision = (float(self.num_correct_chunks) / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (float(self.num_correct_chunks) / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1_score = (2 * precision * recall / (precision + recall)
                    if self.num_correct_chunks else 0.0)
        return precision, recall, f1_score


class EditDistance(MetricBase):
    """Average edit distance + instance error rate, fed from the
    edit_distance op output (distances [N,1], seq_num)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = .0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = _to_numpy(distances).astype("float64").reshape(-1)
        seq_num = int(np.asarray(seq_num).reshape(()))
        self.total_distance += float(np.sum(distances))
        self.seq_num += seq_num
        self.instance_error += int(np.sum(distances > 0))

    def eval(self):
        enforce(self.seq_num != 0,
                "There is no data in EditDistance Metric; call update first",
                exc=InvalidArgumentError)
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / float(self.seq_num)
        return avg_distance, avg_instance_error


class Auc(MetricBase):
    """Host-side streaming AUC over threshold buckets (≙ metrics.py Auc;
    the in-graph `auc` op is the compiled counterpart)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        _num_pred_buckets = num_thresholds + 1
        self._stat_pos = np.zeros(_num_pred_buckets, dtype="int64")
        self._stat_neg = np.zeros(_num_pred_buckets, dtype="int64")

    def reset(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0

    def update(self, preds, labels):
        preds = _to_numpy(preds)
        labels = _to_numpy(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bucket = np.clip((pos_prob * self._num_thresholds).astype("int64"),
                         0, self._num_thresholds)
        pos_mask = labels > 0
        np.add.at(self._stat_pos, bucket[pos_mask], 1)
        np.add.at(self._stat_neg, bucket[~pos_mask], 1)

    @staticmethod
    def trapezoid_area(x1, x2, y1, y2):
        return abs(x1 - x2) * (y1 + y2) / 2.0

    def eval(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        idx = self._num_thresholds
        while idx >= 0:
            tot_pos_prev = tot_pos
            tot_neg_prev = tot_neg
            tot_pos += self._stat_pos[idx]
            tot_neg += self._stat_neg[idx]
            auc += self.trapezoid_area(tot_neg, tot_neg_prev, tot_pos,
                                       tot_pos_prev)
            idx -= 1
        return (auc / tot_pos / tot_neg
                if tot_pos > 0.0 and tot_neg > 0.0 else 0.0)


class DetectionMAP(MetricBase):
    """Mean average precision for detection, accumulated host-side from
    (detections, gt boxes) minibatch results.

    detections: [M, 6] rows (label, score, xmin, ymin, xmax, ymax) with a
    per-image row-count list; gts: [G, 5] rows (label, xmin, ymin, xmax, ymax)
    with per-image counts. ≙ metrics.py DetectionMAP (the reference wires an
    in-graph detection_map op; here evaluation is host-side numpy).
    """

    def __init__(self, name=None, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral"):
        super().__init__(name)
        enforce(ap_version in ("integral", "11point"),
                "ap_version must be 'integral' or '11point'",
                exc=InvalidArgumentError)
        self._overlap_threshold = overlap_threshold
        self._evaluate_difficult = evaluate_difficult
        self._ap_version = ap_version
        # per class: list of (score, is_tp); and total gt count
        self._score_tp = {}
        self._gt_counts = {}

    def reset(self):
        self._score_tp = {}
        self._gt_counts = {}

    @staticmethod
    def _iou(box, boxes):
        if boxes.size == 0:
            return np.zeros((0,), dtype="float64")
        ixmin = np.maximum(boxes[:, 0], box[0])
        iymin = np.maximum(boxes[:, 1], box[1])
        ixmax = np.minimum(boxes[:, 2], box[2])
        iymax = np.minimum(boxes[:, 3], box[3])
        iw = np.maximum(ixmax - ixmin, 0.0)
        ih = np.maximum(iymax - iymin, 0.0)
        inter = iw * ih
        area = ((box[2] - box[0]) * (box[3] - box[1]) +
                (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) -
                inter)
        return inter / np.maximum(area, 1e-10)

    def update(self, detections, det_counts, gts, gt_counts):
        detections = _to_numpy(detections).reshape(-1, 6)
        gts = _to_numpy(gts).reshape(-1, 5)
        d0 = g0 = 0
        for dc, gc in zip(det_counts, gt_counts):
            det_i = detections[d0:d0 + dc]
            gt_i = gts[g0:g0 + gc]
            d0 += dc
            g0 += gc
            for cls in np.unique(gt_i[:, 0]).astype("int64"):
                self._gt_counts[int(cls)] = (self._gt_counts.get(int(cls), 0) +
                                             int(np.sum(gt_i[:, 0] == cls)))
            for cls in np.unique(det_i[:, 0]).astype("int64"):
                cls = int(cls)
                dcls = det_i[det_i[:, 0] == cls]
                gcls = gt_i[gt_i[:, 0] == cls][:, 1:5]
                order = np.argsort(-dcls[:, 1])
                matched = np.zeros(len(gcls), dtype=bool)
                rec = self._score_tp.setdefault(cls, [])
                for row in dcls[order]:
                    ious = self._iou(row[2:6], gcls)
                    best = int(np.argmax(ious)) if ious.size else -1
                    if (best >= 0 and ious[best] >= self._overlap_threshold
                            and not matched[best]):
                        matched[best] = True
                        rec.append((float(row[1]), 1))
                    else:
                        rec.append((float(row[1]), 0))

    def eval(self):
        aps = []
        for cls, n_gt in self._gt_counts.items():
            rec = self._score_tp.get(cls, [])
            if n_gt == 0:
                continue
            if not rec:
                aps.append(0.0)
                continue
            arr = np.array(sorted(rec, key=lambda t: -t[0]), dtype="float64")
            tp = np.cumsum(arr[:, 1])
            fp = np.cumsum(1 - arr[:, 1])
            recall = tp / n_gt
            precision = tp / np.maximum(tp + fp, 1e-10)
            if self._ap_version == "11point":
                ap = 0.0
                for t in np.linspace(0, 1, 11):
                    p = precision[recall >= t]
                    ap += (np.max(p) if p.size else 0.0) / 11.0
            else:
                # integral/VOC-style: sum precision deltas over recall
                mrec = np.concatenate(([0.0], recall, [recall[-1]]))
                mpre = np.concatenate(([0.0], precision, [0.0]))
                for i in range(len(mpre) - 2, -1, -1):
                    mpre[i] = max(mpre[i], mpre[i + 1])
                idx = np.where(mrec[1:] != mrec[:-1])[0]
                ap = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
