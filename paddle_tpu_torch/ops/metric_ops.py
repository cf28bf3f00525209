"""Metric op lowerings.

≙ paddle_tpu/ops/metric_ops.py, trimmed to `accuracy` (the classifiers'
training metric).
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
