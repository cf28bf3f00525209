"""Sequence op lowerings.

≙ paddle_tpu/ops/sequence_ops.py, trimmed to `sequence_mask` (the padded
LM batch's loss mask). A padded sequence travels as a dense [B, T] tensor
with a companion `<name>@SEQLEN` length variable.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op


@register_op("sequence_mask")
def _sequence_mask(ctx, ins, attrs):
    seqlen = ins["X"][0].reshape(-1)
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError("sequence_mask requires a static maxlen")
    m = torch.arange(maxlen, device=seqlen.device)[None, :] < seqlen[:, None]
    return {"Y": [m.to(torch.float32)]}
