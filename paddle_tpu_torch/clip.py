"""Gradient clipping strategies.

≙ paddle_tpu/clip.py (reference python/paddle/fluid/clip.py:
ErrorClipByValue, GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm, set_gradient_clip), op for op: each strategy
appends `clip`, `clip_by_norm`, or the global norm's `squared_l2_norm` /
`sum` / `sqrt` / `elementwise_max` / `elementwise_div` / `elementwise_mul`
ops between the backward's `<param>@GRAD` and the optimizer's update.
"""

from __future__ import annotations

from .core.dtypes import dtype_name
from .layer_helper import LayerHelper
from .layers import nn as nn_layers
from .layers import tensor as tensor_layers


class BaseGradientClipAttr:
    def create_operators(self, param, grad):
        raise NotImplementedError

    def process_context(self, context, param, grad):
        pass


class NullGradientClipAttr(BaseGradientClipAttr):
    def create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def create_operators(self, param, grad):
        return param, nn_layers.clip(grad, self.min, self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def create_operators(self, param, grad):
        return param, nn_layers.clip_by_norm(grad, self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale all grads by clip_norm/max(global_norm, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def process_context(self, context, param, grad):
        norms = context.setdefault("global_norm_sq", [])
        helper = LayerHelper("global_norm")
        sq = helper.create_tmp_variable(dtype=dtype_name(grad.dtype),
                                        shape=[1], stop_gradient=True)
        grad.block.append_op("squared_l2_norm", inputs={"X": [grad]},
                             outputs={"Out": [sq]})
        norms.append(sq)

    def create_operators(self, param, grad):
        context = self._context
        # build the global-norm/scale subgraph ONCE and share it across all
        # parameters (the per-param version would be O(P^2) program ops)
        scale_var = context.get("global_norm_scale")
        if scale_var is None:
            helper = LayerHelper("global_norm_clip")
            total = tensor_layers.sums(context["global_norm_sq"])
            gn = helper.create_tmp_variable(dtype=dtype_name(grad.dtype),
                                            shape=[1], stop_gradient=True)
            grad.block.append_op("sqrt", inputs={"X": [total]},
                                 outputs={"Out": [gn]})
            denom = nn_layers.elementwise_max(
                gn, tensor_layers.fill_constant([1], dtype_name(grad.dtype),
                                                self.clip_norm))
            scale_var = nn_layers.elementwise_div(
                tensor_layers.fill_constant([1], dtype_name(grad.dtype),
                                            self.clip_norm), denom)
            context["global_norm_scale"] = scale_var
        return param, nn_layers.elementwise_mul(grad, scale_var)


class ErrorClipByValue:
    """≙ reference clip.py ErrorClipByValue — clip activations' gradients.

    With one autodiff region there is no per-op grad var to clip
    mid-chain; the class is kept for the API, and clips nothing."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min


def set_gradient_clip(clip, param_list=None, program=None):
    from .framework.program import default_main_program
    program = program or default_main_program()
    params = param_list or program.all_parameters()
    for p in params:
        if not hasattr(p, "gradient_clip") or p.gradient_clip is None:
            p.gradient_clip = clip


def append_gradient_clip_ops(params_grads):
    """≙ reference clip.py append_gradient_clip_ops."""
    context = {}
    clips = []
    for p, g in params_grads:
        clip = getattr(p, "gradient_clip", None) or NullGradientClipAttr()
        clip._context = context
        clip.process_context(context, p, g)
        clips.append(clip)
    out = []
    for (p, g), clip in zip(params_grads, clips):
        out.append(clip.create_operators(p, g))
    return out
