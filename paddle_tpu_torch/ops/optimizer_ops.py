"""Optimizer update ops.

≙ paddle_tpu/ops/optimizer_ops.py (reference operators/{sgd,momentum,adam,
adamax,adagrad,decayed_adagrad,adadelta,rmsprop,ftrl,proximal_gd,
proximal_adagrad}_op.cc, and LAMB). Each op consumes Param/Grad/
accumulators and emits the updated values. Where an output variable is its
input (the optimizer appends `ParamOut = Param`, `Moment1Out = Moment1`,
...), the tensor is updated in place (`LowerCtx.writes_input`), with the
same arithmetic, in the same order, as the JAX package's functional update;
the JAX executor gets the same effect from buffer donation.

A `TracedSelectedRows` gradient (an `is_sparse` embedding table's, from
`run_vjp_region`) takes the sparse branch of `sgd`, `momentum` or `adam`:

- sgd scatter-adds the rows (linear, so duplicates need no merge);
- momentum is NOT lazy: velocity decays table-wide and only the gradient
  arrives sparse (≙ SparseMomentumFunctor);
- adam is lazy: only the looked-up rows of the parameter and both moments
  move; the beta powers advance globally (≙ SparseAdamFunctor). Tables up
  to the `sparse_dense_apply_max_bytes` flag take the dense-masked apply
  (a [height, width] scatter of the raw rows, then the update under a
  touched-row mask); larger ones the merged-rows path, which updates the
  distinct rows in place with index_copy_ and forms no [height, width]
  tensor. Duplicate ids sum before the nonlinear update on both.
"""

from __future__ import annotations

import torch

from ..core import flags
from ..framework.registry import register_op
from ..framework.selected_rows import TracedSelectedRows


def _state(ctx, t, in_slot, out_slot):
    """The tensor to update: `t` itself where the op's output names its
    input, else a copy, so one in-place expression serves both."""
    return t if ctx.writes_input(in_slot, out_slot) else t.clone()


@register_op("sgd")
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0]
    if isinstance(g, TracedSelectedRows):
        # linear update: a scatter-add takes duplicate rows as they come
        # (≙ sgd_op.h SelectedRows kernel)
        rows, value, _ = g.in_range()
        p = _state(ctx, p, "Param", "ParamOut")
        return {"ParamOut": [p.index_add_(0, rows,
                                          -(lr * value).to(p.dtype))]}
    step = lr * g.to(p.dtype)
    if ctx.writes_input("Param", "ParamOut"):
        return {"ParamOut": [p.sub_(step)]}
    return {"ParamOut": [p - step]}


@register_op("momentum")
def _momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = ins["LearningRate"][0]
    mu = attrs["mu"]
    if isinstance(g, TracedSelectedRows):
        # not lazy: the reference decays velocity for every row (absent
        # rows see g = 0); the merged rows are added once each
        rows, g_rows, _ = g.merged()
        v_out = _state(ctx, v, "Velocity", "VelocityOut").mul_(mu)
        v_out.index_add_(0, rows, g_rows.to(v.dtype))
        p_out = _state(ctx, p, "Param", "ParamOut")
        if attrs.get("use_nesterov", False):
            # the dense p - (g + mu * v_out) * lr with g zero off the rows
            p_out.sub_(lr * mu * v_out).index_add_(
                0, rows, -(lr * g_rows).to(p.dtype))
        else:
            p_out.sub_(lr * v_out)
        return {"ParamOut": [p_out], "VelocityOut": [v_out]}
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


def _beta_pows(ctx, ins, b1, b2):
    b1p = _state(ctx, ins["Beta1Pow"][0], "Beta1Pow", "Beta1PowOut")
    b2p = _state(ctx, ins["Beta2Pow"][0], "Beta2Pow", "Beta2PowOut")
    return {"Beta1PowOut": [b1p.mul_(b1)], "Beta2PowOut": [b2p.mul_(b2)]}


def _sparse_adam(ctx, ins, attrs, g):
    p, m, v = ins["Param"][0], ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr = ins["LearningRate"][0]
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = _state(ctx, p, "Param", "ParamOut")
    m_out = _state(ctx, m, "Moment1", "Moment1Out")
    v_out = _state(ctx, v, "Moment2", "Moment2Out")
    if p.numel() * p.element_size() <= flags.get_flag(
            "sparse_dense_apply_max_bytes"):
        # dense-masked: scatter-add the raw duplicate rows (no sort), then
        # update the whole table under the touched-row mask
        rows, value, valid = g.in_range()
        g_sum = torch.zeros(p.shape, dtype=value.dtype,
                            device=p.device).index_add_(0, rows, value)
        touched = torch.zeros(p.shape[0], dtype=value.dtype,
                              device=p.device).index_add_(
            0, rows, valid.to(value.dtype)).gt(0)[:, None]
        # b1 * m + (1 - b1) * g and b2 * v + (1 - b2) * g², the sums
        # written the other way round (addition commutes exactly) so the
        # table-sized temporaries are reused in place
        m_new = torch.mul(g_sum, 1 - b1).add_(torch.mul(m, b1))
        v_new = g_sum.square_().mul_(1 - b2).add_(torch.mul(v, b2))
        p_new = torch.sub(p, torch.mul(m_new, lr_t).div_(
            torch.sqrt(v_new).add_(eps)))
        torch.where(touched, p_new.to(p.dtype), p, out=p_out)
        torch.where(touched, m_new.to(m.dtype), m, out=m_out)
        torch.where(touched, v_new.to(v.dtype), v, out=v_out)
    else:
        # merged rows: gather, update and write back the distinct rows
        rows, g_rows, n_valid = g.merged()
        # positions past the distinct rows repeat the last one, value too
        src = torch.minimum(torch.arange(rows.shape[0], device=p.device),
                            (n_valid - 1).clamp_min(0))
        g_rows = g_rows.index_select(0, src)
        m_old, v_old, p_old = (t.index_select(0, rows) for t in (m, v, p))
        m_rows = b1 * m_old + (1 - b1) * g_rows
        v_rows = b2 * v_old + (1 - b2) * torch.square(g_rows)
        p_rows = p_old - lr_t * m_rows / (torch.sqrt(v_rows) + eps)
        some = (n_valid > 0).reshape(1, 1)     # else every write a no-op
        p_out.index_copy_(0, rows, torch.where(some, p_rows.to(p.dtype),
                                               p_old))
        m_out.index_copy_(0, rows, torch.where(some, m_rows.to(m.dtype),
                                               m_old))
        v_out.index_copy_(0, rows, torch.where(some, v_rows.to(v.dtype),
                                               v_old))
    return {"ParamOut": [p_out], "Moment1Out": [m_out],
            "Moment2Out": [v_out], **_beta_pows(ctx, ins, b1, b2)}


@register_op("adam")
def _adam(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    if isinstance(g, TracedSelectedRows):
        return _sparse_adam(ctx, ins, attrs, g)
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


# -- the rest of the family (≙ paddle_tpu/ops/optimizer_ops.py:146-290) ----
# Each is written as in-place updates of `_state` tensors; an in-place
# `a.mul_(x).add_(y)` rounds exactly as the functional `x * a + y`.

@register_op("adamax")
def _adamax(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr, b1p = ins["LearningRate"][0], ins["Beta1Pow"][0]
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    m = _state(ctx, ins["Moment"][0], "Moment", "MomentOut")
    m.mul_(b1).add_((1 - b1) * g)
    inf = _state(ctx, ins["InfNorm"][0], "InfNorm", "InfNormOut")
    torch.maximum(inf.mul_(b2), torch.abs(g), out=inf)
    step = (lr / (1 - b1p)) * (m / (inf + eps))
    p_out = _state(ctx, p, "Param", "ParamOut").sub_(step)
    b1p_out = _state(ctx, b1p, "Beta1Pow", "Beta1PowOut").mul_(b1)
    return {"ParamOut": [p_out], "MomentOut": [m], "InfNormOut": [inf],
            "Beta1PowOut": [b1p_out]}


@register_op("adagrad")
def _adagrad(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0]
    eps = attrs.get("epsilon", 1e-6)
    mom = _state(ctx, ins["Moment"][0], "Moment", "MomentOut")
    mom.add_(torch.square(g))
    p_out = _state(ctx, p, "Param", "ParamOut").sub_(
        lr * g / (torch.sqrt(mom) + eps))
    return {"ParamOut": [p_out], "MomentOut": [mom]}


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mom = _state(ctx, ins["Moment"][0], "Moment", "MomentOut")
    mom.mul_(decay).add_((1 - decay) * torch.square(g))
    p_out = _state(ctx, p, "Param", "ParamOut").sub_(
        lr * g / (torch.sqrt(mom) + eps))
    return {"ParamOut": [p_out], "MomentOut": [mom]}


@register_op("adadelta")
def _adadelta(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g2 = _state(ctx, ins["AvgSquaredGrad"][0], "AvgSquaredGrad",
                "AvgSquaredGradOut")
    g2.mul_(rho).add_((1 - rho) * torch.square(g))
    u2 = _state(ctx, ins["AvgSquaredUpdate"][0], "AvgSquaredUpdate",
                "AvgSquaredUpdateOut")
    update = -torch.sqrt((u2 + eps) / (g2 + eps)) * g      # the old u2
    u2.mul_(rho).add_((1 - rho) * torch.square(update))
    p_out = _state(ctx, p, "Param", "ParamOut").add_(update)
    return {"ParamOut": [p_out], "AvgSquaredGradOut": [g2],
            "AvgSquaredUpdateOut": [u2]}


@register_op("rmsprop")
def _rmsprop(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    centered = attrs.get("centered", False)
    ms = _state(ctx, ins["MeanSquare"][0], "MeanSquare", "MeanSquareOut")
    ms.mul_(rho).add_((1 - rho) * torch.square(g))
    out = {"MeanSquareOut": [ms]}
    if centered:
        mg = _state(ctx, ins["MeanGrad"][0], "MeanGrad", "MeanGradOut")
        mg.mul_(rho).add_((1 - rho) * g)
        denom = ms - torch.square(mg) + eps
        out["MeanGradOut"] = [mg]
    else:
        denom = ms + eps
    mom = _state(ctx, ins["Moment"][0], "Moment", "MomentOut")
    mom.mul_(mu).add_(lr * g / torch.sqrt(denom))
    out["MomentOut"] = [mom]
    out["ParamOut"] = [_state(ctx, p, "Param", "ParamOut").sub_(mom)]
    return out


@register_op("ftrl")
def _ftrl(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    sq = ins["SquaredAccumulator"][0]
    new_sq = _state(ctx, sq, "SquaredAccumulator", "SquaredAccumOut")
    if power == -0.5:
        root_old = torch.sqrt(sq)                    # read before the add
        root_new = torch.sqrt(new_sq.add_(torch.square(g)))
    else:
        root_old = torch.pow(sq, -power)
        root_new = torch.pow(new_sq.add_(torch.square(g)), -power)
    sigma = (root_new - root_old) / lr
    lin = _state(ctx, ins["LinearAccumulator"][0], "LinearAccumulator",
                 "LinearAccumOut")
    lin.add_(g).sub_(sigma * p)
    denom = root_new / lr + 2 * l2
    pre = torch.clamp(lin, -l1, l1) - lin
    p_out = _state(ctx, p, "Param", "ParamOut").copy_(pre / denom)
    return {"ParamOut": [p_out], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [lin]}


def _shrink(prox, lr, l1, l2):
    """sign(prox) · max(|prox| − lr·l1, 0) / (1 + lr·l2)."""
    return (torch.sign(prox) * torch.clamp_min(torch.abs(prox) - lr * l1,
                                               0.0)
            / (1.0 + lr * l2))


@register_op("proximal_gd")
def _proximal_gd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0]
    prox = p - lr * g
    p_out = _state(ctx, p, "Param", "ParamOut").copy_(
        _shrink(prox, lr, attrs.get("l1", 0.0), attrs.get("l2", 0.0)))
    return {"ParamOut": [p_out]}


@register_op("proximal_adagrad")
def _proximal_adagrad(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0]
    mom = _state(ctx, ins["Moment"][0], "Moment", "MomentOut")
    adapted_lr = lr / torch.sqrt(mom.add_(torch.square(g)))
    prox = p - adapted_lr * g
    p_out = _state(ctx, p, "Param", "ParamOut").copy_(
        _shrink(prox, adapted_lr, attrs.get("l1", 0.0),
                attrs.get("l2", 0.0)))
    return {"ParamOut": [p_out], "MomentOut": [mom]}


@register_op("lamb")
def _lamb(ctx, ins, attrs):
    """LAMB: Adam's moments, then the step scaled by the trust ratio
    ‖p‖ / ‖update‖ (1 where either norm is 0)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    lr = ins["LearningRate"][0]
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    wd = attrs.get("weight_decay", 0.0)
    m = _state(ctx, ins["Moment1"][0], "Moment1", "Moment1Out")
    m.mul_(b1).add_((1 - b1) * g)
    v = _state(ctx, ins["Moment2"][0], "Moment2", "Moment2Out")
    v.mul_(b2).add_((1 - b2) * torch.square(g))
    update = (m / (1 - b1p)) / (torch.sqrt(v / (1 - b2p)) + eps) + wd * p
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    u_norm = torch.sqrt(torch.sum(torch.square(update)))
    trust = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm, 1.0)
    p_out = _state(ctx, p, "Param", "ParamOut").sub_(lr * trust * update)
    return {"ParamOut": [p_out], "Moment1Out": [m], "Moment2Out": [v],
            **_beta_pows(ctx, ins, b1, b2)}
