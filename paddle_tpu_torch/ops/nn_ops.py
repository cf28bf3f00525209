"""NN op lowerings: mul/matmul, layer_norm, softmax, log_softmax,
softmax_with_cross_entropy.

≙ paddle_tpu/ops/nn_ops.py (reference operators/{mul,matmul,layer_norm,
softmax,softmax_with_cross_entropy}_op.*), trimmed to the serving and
training slices. The matrix products go to
torch.matmul (cuBLAS on the card), as the JAX package leaves them to XLA.

bf16 policy (≙ nn_ops.py:22-65, 89-102): a matmul whose layer asked for
`use_bf16` runs on bfloat16 inputs with float32 accumulation and a bfloat16
output while the flag `use_bf16_matmul` is on; otherwise it runs in the
promoted input dtype and returns X's dtype.
"""

from __future__ import annotations

import torch

from ..core import flags
from ..framework.registry import register_op
from .tensor_ops import index_in_range


def _prod(dims):
    out = 1
    for d in dims:
        out *= d
    return out


def _bf16_active(attrs) -> bool:
    return bool(attrs.get("use_bf16", False)) and bool(
        flags.get_flag("use_bf16_matmul"))


def _matmul(x, y, attrs, alpha=1.0):
    """x @ y under the bf16 policy, returned in the policy's output dtype
    (bfloat16 when active, else x's dtype)."""
    out_dtype = x.dtype
    if _bf16_active(attrs):
        if x.dtype == torch.float32:
            x = x.to(torch.bfloat16)
        if y.dtype == torch.float32:
            y = y.to(torch.bfloat16)
        out_dtype = torch.bfloat16
    ct = torch.promote_types(x.dtype, y.dtype)
    if alpha != 1.0 and ct in (torch.bfloat16, torch.float16):
        # scale the float32 product before the one rounding, as jax's
        # preferred_element_type=float32 product does
        ct = torch.float32
    out = torch.matmul(x.to(ct), y.to(ct))
    if alpha != 1.0:
        out = out * alpha
    return out.to(out_dtype)


@register_op("mul")
def _mul(ctx, ins, attrs):
    """≙ mul_op.cc — the fc matmul core: flattens x to 2-D by x_num_col_dims."""
    x, y = ins["X"][0], ins["Y"][0]
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(_prod(xs[:xd]), -1)
    y2 = y.reshape(_prod(ys[:yd]), -1)
    out = _matmul(x2, y2, attrs)
    return {"Out": [out.reshape(xs[:xd] + ys[yd:])]}


@register_op("matmul")
def _matmul_op(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    return {"Out": [_matmul(x, y, attrs, alpha=attrs.get("alpha", 1.0))]}


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """≙ layer_norm_op.cc: normalize over dims >= begin_norm_axis."""
    x = ins["X"][0]
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(begin, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    norm_shape = tuple(x.shape[begin:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(norm_shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(norm_shape)
    lead = tuple(x.shape[:begin])
    return {"Y": [y], "Mean": [mean.reshape(lead)],
            "Variance": [var.reshape(lead)]}


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=-1)]}


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": [torch.log_softmax(ins["X"][0],
                                      dim=attrs.get("axis", -1))]}


class _CEHard(torch.autograd.Function):
    """Hard-label softmax cross entropy with the closed-form backward of
    the JAX package's `_ce_hard` (nn_ops.py:439-481): it saves the logits
    as they are (bfloat16 on the LM's path) and a [rows] float32
    log-sum-exp, never a float32 [rows, vocab] log-softmax, and recomputes
    p = exp(logit - lse) in the backward. loss [..., 1] float32.

    Labels outside [0, V) follow jax's fill mode, as `_ce_hard` meets them:
    its forward reads the label's logit with `take_along_axis`, so a label
    in [-V, 0) wraps and any other gives a NaN loss; its backward subtracts
    an iota-compared one-hot, which no label outside [0, V) matches, so
    such a row's gradient is softmax(logits) alone. A clamp and a masked
    fill compute the same without a device->host sync."""

    @staticmethod
    def forward(ctx, logits, lbl, valid):
        l32 = logits.float()
        m = l32.amax(-1)
        lse = m + torch.log(torch.exp(l32 - m.unsqueeze(-1)).sum(-1))
        idx, filled = index_in_range(lbl, logits.shape[-1])
        logit_at = l32.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
        logit_at = logit_at.masked_fill(filled, float("nan"))
        loss = torch.where(valid, lse - logit_at,
                           torch.zeros((), device=lse.device)).unsqueeze(-1)
        ctx.save_for_backward(logits, lbl, valid, lse)
        return loss

    @staticmethod
    def backward(ctx, dl):
        logits, lbl, valid, lse = ctx.saved_tensors
        g = dl.squeeze(-1) * valid
        # (p - onehot) * g, built in one float32 buffer: subtracting 1 at
        # the label is the same arithmetic as subtracting the one-hot row;
        # a label outside [0, V) subtracts nothing
        d = logits.to(torch.float32, copy=True).sub_(
            lse.unsqueeze(-1)).exp_()
        v = logits.shape[-1]
        hit = (lbl >= 0) & (lbl < v)
        d.scatter_add_(-1, lbl.clamp(0, v - 1).unsqueeze(-1),
                       hit.to(torch.float32).neg().unsqueeze(-1))
        d.mul_(g.unsqueeze(-1))
        return d.to(logits.dtype), None, None


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, ins, attrs):
    """≙ softmax_with_cross_entropy_op.cc (fused, numerically stable).
    Labels equal to `ignore_index` (default -100) give zero loss and zero
    gradient; other labels outside [0, V) as `_CEHard` says. The Softmax
    output is computed only when something reads it."""
    logits = ins["Logits"][0]
    label = ins["Label"][0]
    sm_names = (ctx.op.outputs.get("Softmax", []) if ctx.op is not None
                else [])
    want_sm = not sm_names or ctx.needed(sm_names[0])
    if attrs.get("soft_label", False):
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -(label * logp).sum(-1, keepdim=True)
        return {"Loss": [loss], "Softmax": [logp.exp() if want_sm else None]}
    lbl = label
    if lbl.dim() == logits.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    valid = lbl != attrs.get("ignore_index", -100)
    safe = torch.where(valid, lbl, torch.zeros((), dtype=lbl.dtype,
                                               device=lbl.device))
    loss = _CEHard.apply(logits, safe.to(torch.long), valid)
    sm = torch.softmax(logits.float(), dim=-1) if want_sm else None
    return {"Loss": [loss], "Softmax": [sm]}
