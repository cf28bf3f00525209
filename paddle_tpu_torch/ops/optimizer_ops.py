"""Optimizer update ops: sgd, momentum, adam (dense).

≙ paddle_tpu/ops/optimizer_ops.py:45-143 (reference operators/{sgd,
momentum,adam}_op.cc). Each op consumes Param/Grad/accumulators and emits
the updated values. Where an output variable is its input (the optimizer
appends `ParamOut = Param`, `Moment1Out = Moment1`, ...), the tensor is
updated in place (`LowerCtx.writes_input`), with the same arithmetic, in
the same order, as the JAX package's functional update; the JAX executor
gets the same effect from buffer donation.

Sparse (SelectedRows) gradients are not ported: ROADMAP.md port queue item
1b (sparse embedding gradients).
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op

_SPARSE = ("a SelectedRows (sparse) gradient reached an optimizer op; sparse "
           "embedding gradients are not ported: ROADMAP.md port queue item "
           "1b (sparse embedding gradients)")


def _grad(ins):
    g = ins["Grad"][0]
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(_SPARSE)
    return g


@register_op("sgd")
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], _grad(ins)
    step = ins["LearningRate"][0] * g.to(p.dtype)
    if ctx.writes_input("Param", "ParamOut"):
        return {"ParamOut": [p.sub_(step)]}
    return {"ParamOut": [p - step]}


@register_op("momentum")
def _momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], _grad(ins), ins["Velocity"][0]
    lr = ins["LearningRate"][0]
    mu = attrs["mu"]
    if ctx.writes_input("Velocity", "VelocityOut"):
        v_out = v.mul_(mu).add_(g)
    else:
        v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        step = (g + mu * v_out) * lr
    else:
        step = lr * v_out
    if ctx.writes_input("Param", "ParamOut"):
        return {"ParamOut": [p.sub_(step)], "VelocityOut": [v_out]}
    return {"ParamOut": [p - step], "VelocityOut": [v_out]}


@register_op("adam")
def _adam(ctx, ins, attrs):
    p, g = ins["Param"][0], _grad(ins)
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr = ins["LearningRate"][0]
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    inplace = ctx.writes_input
    m_out = (m.mul_(b1).add_((1 - b1) * g)
             if inplace("Moment1", "Moment1Out") else b1 * m + (1 - b1) * g)
    g2 = (1 - b2) * torch.square(g)
    v_out = (v.mul_(b2).add_(g2) if inplace("Moment2", "Moment2Out")
             else b2 * v + g2)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    step = lr_t * m_out / (torch.sqrt(v_out) + eps)
    p_out = p.sub_(step) if inplace("Param", "ParamOut") else p - step
    b1p_out = (b1p.mul_(b1) if inplace("Beta1Pow", "Beta1PowOut")
               else b1p * b1)
    b2p_out = (b2p.mul_(b2) if inplace("Beta2Pow", "Beta2PowOut")
               else b2p * b2)
    return {"ParamOut": [p_out], "Moment1Out": [m_out],
            "Moment2Out": [v_out], "Beta1PowOut": [b1p_out],
            "Beta2PowOut": [b2p_out]}
