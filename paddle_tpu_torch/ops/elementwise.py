"""Elementwise / scale / compare / activation op lowerings.

≙ paddle_tpu/ops/elementwise.py (reference operators/elementwise_*.cc,
scale_op.cc, compare_op.cc, activation_op.cc), trimmed to the serving and
training slices and the recurrent models: elementwise add/sub/mul/div,
less_than, greater_than, equal, scale, relu, sigmoid, tanh. Dtype promotion follows torch, which agrees with jnp on
the pairs the slices meet (bfloat16 + float32 → float32).
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op


def _broadcast_y(x, y, axis):
    """Reference elementwise broadcast semantics: align y's dims to x starting
    at `axis` (reference operators/elementwise_op_function.h)."""
    if y.dim() == x.dim():
        return y
    if axis is None or axis == -1:
        return y  # trailing-aligned: torch broadcasting handles it
    # leading-aligned at `axis`: pad y with trailing singleton dims
    pad = x.dim() - axis - y.dim()
    return y.reshape(tuple(y.shape) + (1,) * pad)


def _binary(fn):
    def lower(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        if attrs.get("use_bf16", False) and x.dtype != y.dtype and \
                x.dtype == torch.bfloat16:
            # bias/residual add on the bf16 activation path: cast the fp32
            # side down instead of letting promotion lift the whole
            # activation tensor back to fp32
            y = y.to(x.dtype)
        y = _broadcast_y(x, y, attrs.get("axis", -1))
        return {"Out": [fn(x, y)]}
    return lower


register_op("elementwise_add")(_binary(torch.add))
register_op("elementwise_sub")(_binary(torch.sub))
register_op("elementwise_mul")(_binary(torch.mul))
register_op("elementwise_div")(_binary(torch.div))
register_op("less_than")(_binary(torch.lt))
register_op("greater_than")(_binary(torch.gt))
register_op("equal")(_binary(torch.eq))


@register_op("scale")
def _scale(ctx, ins, attrs):
    # ≙ scale_op.cc: out = scale * x + bias, or scale * (x + bias)
    x = ins["X"][0]
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}


@register_op("relu")
def _relu(ctx, ins, attrs):
    return {"Out": [torch.relu(ins["X"][0])]}


@register_op("sigmoid")
def _sigmoid(ctx, ins, attrs):
    return {"Out": [torch.sigmoid(ins["X"][0])]}


@register_op("tanh")
def _tanh(ctx, ins, attrs):
    return {"Out": [torch.tanh(ins["X"][0])]}
