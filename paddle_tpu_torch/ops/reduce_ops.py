"""Reduction op lowerings.

≙ paddle_tpu/ops/reduce_ops.py, trimmed to `arg_max` (the decode tick's
greedy sample).
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op


@register_op("arg_max")
def _arg_max(ctx, ins, attrs):
    # ties resolve to the first maximal index, as jnp.argmax
    return {"Out": [torch.argmax(ins["X"][0], dim=attrs.get("axis", -1))
                    .to(torch.int64)]}
