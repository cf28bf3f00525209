"""NN op lowerings: mul/matmul, conv, conv_transpose, pool, batch_norm,
layer_norm, softmax, log_softmax, softmax_with_cross_entropy,
sigmoid_cross_entropy_with_logits, and the rest of the family: lrn,
l2_normalize, the losses over probabilities and pairs (cross_entropy,
huber, smooth_l1, log, hinge, rank, margin_rank, mse),
bilinear_tensor_product, bilinear_interp, im2sequence, grid_sampler and
spp.

≙ paddle_tpu/ops/nn_ops.py (reference operators/{mul,matmul,conv,
conv_transpose,pool,batch_norm,layer_norm,softmax,
softmax_with_cross_entropy,lrn,...}_op.*); nce and hierarchical_sigmoid
are in ops/loss_ops.py. The matrix products go to torch.matmul (cuBLAS on the
card) and the convolutions to torch's conv (cuDNN), as the JAX package
leaves both to XLA.

bf16 policy (≙ nn_ops.py:22-65, 89-102): a matmul or conv whose layer
asked for `use_bf16` runs on bfloat16 inputs with float32 accumulation and
a bfloat16 output while the flag `use_bf16_matmul` is on; otherwise it
runs in the promoted input dtype and returns X's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import flags
from ..core.enforce import InvalidArgumentError, enforce
from ..framework.registry import register_op
from .elementwise import floating as _floating
from .tensor_ops import index_in_range, take_along


def _prod(dims):
    out = 1
    for d in dims:
        out *= d
    return out


def _bf16_active(attrs) -> bool:
    return bool(attrs.get("use_bf16", False)) and bool(
        flags.get_flag("use_bf16_matmul"))


def _bf16_operands(x, y, attrs):
    """(x, y, output dtype) of a matmul or conv under the bf16 policy:
    float32 operands cast to bfloat16 and a bfloat16 output when it is
    active, else the operands as they are and x's dtype."""
    if not _bf16_active(attrs):
        return x, y, x.dtype
    if x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    if y.dtype == torch.float32:
        y = y.to(torch.bfloat16)
    return x, y, torch.bfloat16


def _matmul(x, y, attrs, alpha=1.0):
    """x @ y under the bf16 policy, returned in the policy's output dtype
    (bfloat16 when active, else x's dtype)."""
    x, y, out_dtype = _bf16_operands(x, y, attrs)
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


@register_op("qmatmul")
def _qmatmul(ctx, ins, attrs):
    """Weight-only quantized fc matmul (quantize_params_pass rewrite of
    `mul`, ≙ nn_ops.py:68): dequantizes the block-scaled int8/int4 payload
    to float32, then follows the `mul` path exactly (same bf16 policy,
    same accumulation), so quantized decode differs from float32 only by
    the quantization error. The product stays torch.matmul, as the JAX
    package leaves it to XLA; the dequantized weight is a temporary here
    (a weight-only GEMM that reads the payload is ROADMAP.md §2's
    follow-up)."""
    from ..parallel.collective import dequantize_blocks_2d
    x, qw, scales = ins["X"][0], ins["QW"][0], ins["Scales"][0]
    y = dequantize_blocks_2d(qw, scales, bits=attrs.get("bits", 8))
    xd = attrs.get("x_num_col_dims", 1)
    xs = tuple(x.shape)
    out = _matmul(x.reshape(_prod(xs[:xd]), -1), y, attrs)
    return {"Out": [out.reshape(xs[:xd] + tuple(y.shape[1:]))]}


@register_op("matmul")
def _matmul_op(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    return {"Out": [_matmul(x, y, attrs, alpha=attrs.get("alpha", 1.0))]}


_CHANNELS_LAST = ("NHWC", "NDHWC")
_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}
_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_SUM_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _channels_first(x, channels_last):
    """An N<spatial>C tensor as an NC<spatial>-shaped view: its strides are
    channels_last, so cuDNN runs its NHWC kernels on it, with no copy."""
    if not channels_last:
        return x
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _channels_last(y, channels_last):
    """Inverse of `_channels_first`: a channels_last-strided NC<spatial>
    result becomes a contiguous N<spatial>C tensor, with no copy."""
    if not channels_last:
        return y
    return y.permute(0, *range(2, y.dim()), 1)


@register_op("conv2d")
def _conv2d(ctx, ins, attrs):
    """≙ conv_op.cc / conv_cudnn_op.cu.cc (JAX: nn_ops.py:155-187); conv3d
    and depthwise_conv2d take the same lowering. The filter is OIHW (OIDHW)
    as both packages store it, passed as it is; groups > 1 is a grouped
    conv (depthwise: groups == C_in). An NHWC input runs as its NCHW view
    (`_channels_first`) and the output is permuted back. The JAX package's
    `conv1x1_mixed_vjp` probe, an XLA emitter choice off by default, is not
    ported: cuDNN picks its own dgrad."""
    x, w = ins["Input"][0], ins["Filter"][0]
    nd = x.dim() - 2
    cl = attrs.get("data_format", "NCHW") in _CHANNELS_LAST
    xc, w, out_dtype = _bf16_operands(_channels_first(x, cl), w, attrs)
    ct = torch.promote_types(xc.dtype, w.dtype)    # operands of two types
    out = _CONV[nd](xc.to(ct), w.to(ct), None, tuple(attrs.get("strides", [1] * nd)),
                    tuple(attrs.get("paddings", [0] * nd)),
                    tuple(attrs.get("dilations", [1] * nd)),
                    attrs.get("groups", 1) or 1)
    return {"Output": [_channels_last(out, cl).to(out_dtype)]}


register_op("conv3d")(_conv2d)


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    x = ins["Input"][0]
    cl = attrs.get("data_format", "NCHW") in _CHANNELS_LAST
    return _conv2d(ctx, ins, dict(attrs, groups=x.shape[-1 if cl else 1]))


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    """≙ conv_transpose_op.cc (JAX: nn_ops.py:204-231), NC<spatial> only;
    conv3d_transpose too. The filter is stored (C_in, C_out, *k), torch's
    own layout for conv_transpose. The JAX lowering pads the
    stride-dilated input by d·(k−1) − p on each side, which gives
    (i−1)·s − 2p + d·(k−1) + 1: torch's `padding=p` with no
    output_padding."""
    x, w = ins["Input"][0], ins["Filter"][0]
    nd = x.dim() - 2
    ct = torch.promote_types(x.dtype, w.dtype)
    out = _CONV_T[nd](x.to(ct), w.to(ct), None,
                      tuple(attrs.get("strides", [1] * nd)),
                      tuple(attrs.get("paddings", [0] * nd)), 0, 1,
                      tuple(attrs.get("dilations", [1] * nd)))
    return {"Output": [out]}


register_op("conv3d_transpose")(_conv2d_transpose)


@register_op("pool2d")
def _pool2d(ctx, ins, attrs):
    """≙ pool_op.cc (JAX: nn_ops.py:234-285): max / avg, global_pooling,
    ceil_mode, exclusive avg; pool3d too. The arithmetic of the JAX
    package's reduce_window: the input is padded explicitly (−inf for max,
    0 for avg), ceil_mode adding high padding until the last partial
    window fits, and pooled with no padding of torch's own (torch's
    max_pool refuses a pad above half the window, and its ceil_mode drops
    windows that start in the padding). The exclusive average divides by
    the count of in-bounds elements, pooled from ones."""
    x = ins["X"][0]
    nd = x.dim() - 2
    ksize = list(attrs.get("ksize", [2] * nd))
    strides = list(attrs.get("strides", ksize))
    pads = list(attrs.get("paddings", [0] * nd))
    cl = attrs.get("data_format", "NCHW") in _CHANNELS_LAST
    xc = _channels_first(x, cl)
    spatial = tuple(xc.shape[2:])
    if attrs.get("global_pooling", False):
        ksize, strides, pads = list(spatial), list(spatial), [0] * nd
    pairs = []
    for i in range(nd):
        hi = pads[i]
        if attrs.get("ceil_mode", False):
            rem = (spatial[i] + 2 * pads[i] - ksize[i]) % strides[i]
            if rem:
                hi += strides[i] - rem
        pairs.append((pads[i], hi))
    # a window wider than the padded input: the JAX package's
    # reduce_window returns an empty output there, the port refuses it
    # (ROADMAP.md §3, deliberate differences)
    enforce(all(spatial[i] + lo + hi >= ksize[i]
                for i, (lo, hi) in enumerate(pairs)),
            "pool: window %s is larger than the padded input %s (X %s, "
            "paddings %s)", ksize, [spatial[i] + lo + hi
                                    for i, (lo, hi) in enumerate(pairs)],
            list(x.shape), pads, exc=InvalidArgumentError)
    padded = any(lo or hi for lo, hi in pairs)
    fpad = [p for pair in reversed(pairs) for p in pair]   # last dim first
    if attrs.get("pooling_type", "max") == "max":
        if padded:
            xc = F.pad(xc, fpad, value=-math.inf)
        out = _MAX_POOL[nd](xc, ksize, strides)
    else:
        out = _SUM_POOL[nd](F.pad(xc, fpad) if padded else xc, ksize,
                            strides, divisor_override=1)
        if attrs.get("exclusive", True) and padded:
            ones = torch.ones((1, 1) + spatial, dtype=x.dtype,
                              device=x.device)
            out = out / _SUM_POOL[nd](F.pad(ones, fpad), ksize, strides,
                                      divisor_override=1)
        else:
            out = out / float(_prod(ksize))
    return {"Out": [_channels_last(out, cl)]}


register_op("pool3d")(_pool2d)


def _bn_stats(x, shift, axes, bshape):
    """≙ `_bn_stats` (nn_ops.py:288): shifted single-pass moments over
    `axes`, accumulated in float32 (x − shift promotes a bfloat16 x in
    the same pass); the shift, the running mean, keeps E[x²] − E[x]² from
    cancelling. Returns (mean, max(m2 − m1², 0))."""
    xs = x - shift.float().reshape(bshape)
    m1 = xs.mean(axes)
    m2 = xs.square_().mean(axes)
    return m1 + shift, torch.clamp_min(m2 - m1.square(), 0.0)


def _bn_affine(x, scale, bias, mean, inv, bshape):
    """y = x·a + b in x's dtype, one pass over x, with a = inv·scale and
    b = bias − mean·a computed in float32 on [C] (nn_ops.py:307-317)."""
    a32 = inv * scale
    b32 = bias - mean * a32
    return torch.addcmul(b32.to(x.dtype).reshape(bshape), x,
                         a32.to(x.dtype).reshape(bshape))


class _BNTrain(torch.autograd.Function):
    """Train-mode normalize + affine with the closed-form backward of the
    JAX package's `_bn_train_apply` (nn_ops.py:320-361). It saves x as it
    is (bfloat16 on ResNet's path) and the [C]-sized mean, 1/sqrt(var+eps)
    and scale, never a float32 copy of the activation (822 MB a layer at
    ResNet-50's batch 256), and recomputes x − mean in the backward. The
    batch statistics come out of the forward as non-differentiable outputs
    for the running update: computed from x under no grad, they are the
    JAX package's stop_gradient(x) statistics, and autograd keeps no
    second graph for them."""

    @staticmethod
    def forward(ctx, x, scale, bias, shift, axes, bshape, eps):
        mean, var = _bn_stats(x, shift, axes, bshape)
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, mean, inv, scale)
        ctx.axes, ctx.bshape = axes, bshape
        ctx.mark_non_differentiable(mean, var)
        return _bn_affine(x, scale, bias, mean, inv, bshape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, scale = ctx.saved_tensors
        axes, bshape = ctx.axes, ctx.bshape
        n = float(_prod(x.shape[a] for a in axes))
        xc = x - mean.reshape(bshape)                    # float32
        sum_dy = dy.sum(axes, dtype=torch.float32)
        sum_dy_xc = (dy * xc).sum(axes)
        # dx = scale·inv · (dy − mean(dy) − xhat·mean(dy·xhat))
        c0 = (scale * inv).reshape(bshape)
        c1 = (sum_dy / n).reshape(bshape)
        c2 = (inv * inv * sum_dy_xc / n).reshape(bshape)
        dx = (dy - c1).sub_(xc.mul_(c2)).mul_(c0)
        return (dx.to(x.dtype), (inv * sum_dy_xc).to(scale.dtype), sum_dy,
                None, None, None, None)


@register_op("batch_norm")
def _batch_norm(ctx, ins, attrs):
    """≙ batch_norm_op.cc (JAX: nn_ops.py:364-401). Train mode normalizes
    with the batch statistics and moves the running ones,
    momentum·old + (1 − momentum)·batch (the biased variance), in place
    where MeanOut / VarianceOut are Mean / Variance (what the layer
    appends). Test mode (`is_test`, or the run's) uses the running
    estimates. The reduction axes follow `data_layout`, so a 2-D [N, C]
    input under "NHWC" normalizes each column. SavedVariance is
    1/sqrt(var + eps), as in the JAX package."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != axis)
    bshape = tuple(x.shape[i] if i == axis else 1 for i in range(x.dim()))
    if attrs.get("is_test", False) or ctx.is_test:
        inv = torch.rsqrt(var + eps)
        y = _bn_affine(x, scale, bias, mean, inv, bshape)
        return {"Y": [y], "MeanOut": [mean], "VarianceOut": [var],
                "SavedMean": [mean], "SavedVariance": [inv]}
    y, batch_mean, batch_var = _BNTrain.apply(x, scale, bias, mean.detach(),
                                              axes, bshape, eps)
    inv = torch.rsqrt(batch_var + eps)
    rest = 1 - momentum
    # in place once a step, also under remat (LowerCtx.update_state)
    if ctx.writes_input("Mean", "MeanOut"):
        ctx.update_state(lambda: mean.mul_(momentum).add_(rest * batch_mean))
        mean_out = mean
    else:
        mean_out = momentum * mean + rest * batch_mean
    if ctx.writes_input("Variance", "VarianceOut"):
        ctx.update_state(lambda: var.mul_(momentum).add_(rest * batch_var))
        var_out = var
    else:
        var_out = momentum * var + rest * batch_var
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [batch_mean], "SavedVariance": [inv]}


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """≙ layer_norm_op.cc: normalize over dims >= begin_norm_axis."""
    x = _floating(ins["X"][0])
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
    return {"Out": [torch.softmax(_floating(ins["X"][0]), dim=-1)]}


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": [torch.log_softmax(_floating(ins["X"][0]),
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


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx, ins, attrs):
    """The stable form max(x, 0) − x·z + log(1 + exp(−|x|))."""
    x, label = ins["X"][0], ins["Label"][0]
    return {"Out": [torch.clamp_min(x, 0) - x * label
                    + torch.log1p(torch.exp(-torch.abs(x)))]}


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


# --- the loss family over probabilities and pairs, normalization, image
# resampling (≙ paddle_tpu/ops/nn_ops.py :512-726)


@register_op("cross_entropy")
def _cross_entropy(ctx, ins, attrs):
    """≙ cross_entropy_op.cc over probabilities (not logits): a hard label
    reads its probability as take_along_axis does (NaN outside range),
    `ignore_index` rows give 0."""
    x = ins["X"][0]
    label = ins["Label"][0]
    if attrs.get("soft_label", False):
        loss = -(label * torch.log(torch.clamp_min(x, 1e-20))).sum(
            -1, keepdim=True)
        return {"Y": [loss]}
    lbl = label
    if lbl.dim() == x.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    valid = lbl != attrs.get("ignore_index", -100)
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    p = take_along(x, safe[..., None].to(torch.long), -1)
    return {"Y": [torch.where(valid[..., None],
                              -torch.log(torch.clamp_min(p, 1e-20)), 0.0)]}


@register_op("lrn")
def _lrn(ctx, ins, attrs):
    # NCHW; the window of n channels centred on each
    x = ins["X"][0]
    n = attrs.get("n", 5)
    half = n // 2
    sq = F.pad(x.square(), (0, 0, 0, 0, half, half))
    acc = sum(sq[:, i:i + x.shape[1]] for i in range(n))
    mid = attrs.get("k", 2.0) + attrs.get("alpha", 1e-4) * acc
    return {"Out": [x / torch.pow(mid, attrs.get("beta", 0.75))],
            "MidOut": [mid]}


@register_op("l2_normalize")
def _l2_normalize(ctx, ins, attrs):
    x = ins["X"][0]
    norm = (x.square().sum(dim=attrs.get("axis", -1), keepdim=True)
            + attrs.get("epsilon", 1e-10)).sqrt()
    return {"Out": [x / norm], "Norm": [norm]}


@register_op("huber_loss")
def _huber_loss(ctx, ins, attrs):
    delta = attrs.get("delta", 1.0)
    r = ins["Y"][0] - ins["X"][0]
    a = r.abs()
    return {"Out": [torch.where(a <= delta, 0.5 * r.square(),
                                delta * (a - 0.5 * delta))],
            "Residual": [r]}


@register_op("smooth_l1_loss")
def _smooth_l1_loss(ctx, ins, attrs):
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    diff = ins["X"][0] - ins["Y"][0]
    if ins.get("InsideWeight"):
        diff = diff * ins["InsideWeight"][0]
    a = diff.abs()
    loss = torch.where(a < 1.0 / s2, 0.5 * s2 * diff.square(), a - 0.5 / s2)
    if ins.get("OutsideWeight"):
        loss = loss * ins["OutsideWeight"][0]
    return {"Out": [loss.sum(dim=tuple(range(1, loss.dim())))[..., None]],
            "Diff": [diff]}


@register_op("log_loss")
def _log_loss(ctx, ins, attrs):
    p, y = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-y * torch.log(p + eps)
                     - (1 - y) * torch.log(1 - p + eps)]}


@register_op("hinge_loss")
def _hinge_loss(ctx, ins, attrs):
    logits, labels = ins["Logits"][0], ins["Labels"][0]
    return {"Loss": [torch.clamp_min(1.0 - (2 * labels - 1) * logits, 0.0)]}


@register_op("rank_loss")
def _rank_loss(ctx, ins, attrs):
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": [torch.log1p(torch.exp(d)) - ins["Label"][0] * d]}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs):
    x1 = ins["X1"][0]
    out = torch.clamp_min(-ins["Label"][0] * (x1 - ins["X2"][0])
                          + attrs.get("margin", 0.0), 0.0)
    return {"Out": [out], "Activated": [(out > 0).to(x1.dtype)]}


@register_op("mse_loss")
def _mse_loss(ctx, ins, attrs):
    return {"Out": [(ins["X"][0] - ins["Y"][0]).square()]}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    # out[b, o] = x[b] W[o] y[b]^T, W [out, dx, dy]
    out = torch.einsum("bi,oij,bj->bo", ins["X"][0], ins["Weight"][0],
                       ins["Y"][0])
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    return {"Out": [out]}


def resize_weights(n_in, n_out):
    """[n_out, n_in] float64 weights of jax.image.resize's "bilinear"
    (jax/_src/image/scale.py `compute_weight_mat`: a triangle kernel,
    widened by the scale when shrinking, i.e. antialiased; each row
    normalized over the input samples it covers; rows whose sample point
    falls outside the input zero)."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(n_out) + 0.5) / scale - 0.5
    x = np.abs(sample[:, None] - np.arange(n_in)[None, :]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0)


@register_op("bilinear_interp")
def _bilinear_interp(ctx, ins, attrs):
    """≙ jax.image.resize(x, (N, C, out_h, out_w), "bilinear") on NCHW: one
    weight matrix a spatial axis, built once per plan, then two
    contractions (jax's resize contracts the same matrices)."""
    x = ins["X"][0]
    oh, ow = attrs["out_h"], attrs["out_w"]
    wh, ww = ctx.constant(lambda: tuple(
        torch.from_numpy(resize_weights(n, m)).to(torch.float32).to(
            x.device) for n, m in ((x.shape[2], oh), (x.shape[3], ow))))
    out = torch.einsum("nchw,ph,qw->ncpq", x.float(), wh, ww)
    return {"Out": [out.to(x.dtype)]}


@register_op("im2sequence")
def _im2sequence(ctx, ins, attrs):
    """≙ im2sequence_op: every kh x kw patch (VALID, at the strides) as a
    row, [N * OH * OW, C * kh * kw], channel-major within a row as
    conv_general_dilated_patches orders it."""
    x = ins["X"][0]
    kh, kw = attrs["kernels"]
    sh, sw = attrs.get("strides", [1, 1])
    cols = F.unfold(x, (kh, kw), stride=(sh, sw))     # [N, C*kh*kw, L]
    return {"Out": [cols.transpose(1, 2).reshape(-1, cols.shape[1])]}


@register_op("grid_sampler")
def _grid_sampler(ctx, ins, attrs):
    """Bilinear sampling of X [N, C, H, W] at Grid [N, H', W', 2] in
    [-1, 1] (corners aligned), neighbours outside clamped to the edge."""
    x, grid = ins["X"][0], ins["Grid"][0]
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1) * (w - 1) / 2
    gy = (grid[..., 1] + 1) * (h - 1) / 2
    x0 = torch.floor(gx).to(torch.int32)
    y0 = torch.floor(gy).to(torch.int32)
    x1, y1 = x0 + 1, y0 + 1
    wx, wy = gx - x0, gy - y0
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def sample(xi, yi):
        xi = xi.clamp(0, w - 1).to(torch.long)
        yi = yi.clamp(0, h - 1).to(torch.long)
        return x[bidx, :, yi, xi]                     # [N, H', W', C]

    val = (sample(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
           + sample(x1, y0) * (wx * (1 - wy))[..., None]
           + sample(x0, y1) * ((1 - wx) * wy)[..., None]
           + sample(x1, y1) * (wx * wy)[..., None])
    return {"Output": [val.permute(0, 3, 1, 2)]}


@register_op("spp")
def _spp(ctx, ins, attrs):
    """≙ spp_op.cc: max (or mean) pooling at 1x1, 2x2, ... 2^(L-1) grids,
    the bins flattened and concatenated, [N, C * sum(4^l)]. Bins are
    nearly even and never empty (they overlap where the extent is below
    the bin count), as the JAX package cuts them."""
    x = ins["X"][0]
    pool = attrs.get("pooling_type", "max")
    n, c, h, w = x.shape

    def bounds(extent, bins):
        out = []
        for i in range(bins):
            lo = min(extent - 1, extent * i // bins)
            hi = max(lo + 1, -(-extent * (i + 1) // bins))
            out.append((lo, min(hi, extent)))
        return out

    outs = []
    for lvl in range(attrs.get("pyramid_height", 3)):
        for h0, h1 in bounds(h, 2 ** lvl):
            for w0, w1 in bounds(w, 2 ** lvl):
                sl = x[:, :, h0:h1, w0:w1]
                outs.append(sl.amax(dim=(2, 3)) if pool == "max"
                            else sl.mean(dim=(2, 3)))
    return {"Out": [torch.cat(outs, dim=1)]}
