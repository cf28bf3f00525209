"""Elementwise / scale / compare / activation op lowerings.

≙ paddle_tpu/ops/elementwise.py (reference operators/elementwise_*.cc,
scale_op.cc, compare_op.cc, activation_op.cc): elementwise
add/sub/mul/div/max/min/pow/mod/floordiv, the six comparisons, logical
and/or/xor/not, scale, clip, clip_by_norm, sign, pow, isfinite and the
activations. Each follows the jax function the JAX package calls:
`elementwise_mod` is jnp.mod (the sign of the divisor: torch.remainder,
not fmod) and `elementwise_floordiv` jnp.floor_divide, both with XLA's
results for a zero divisor; `gelu` is jax.nn.gelu's default tanh
approximation, `leaky_relu`'s alpha defaults to 0.02. The float
activations, like jax's, take an integer X as float32.
Dtype promotion follows torch, which agrees with jnp on the pairs the
slices meet (bfloat16 + float32 → float32).
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


def floating(x):
    """An integer or bool tensor as float32 (jax's promotion for the float
    functions of an integer array); a float tensor as it is."""
    return x if x.is_floating_point() else x.float()


def _safe_divisor(y):
    """XLA divides integers without a trap: x / 0 is -1 (all bits set for
    an unsigned type) with remainder x, and INT_MIN / -1 is INT_MIN with
    remainder 0. Torch's truncating division and fmod trap on both on the
    CPU (SIGFPE) and leave them undefined on the card. The divisor with 0
    and -1 replaced by 1, whose quotient and remainder the callers then
    correct where they differ."""
    return torch.where((y == 0) | (y == -1), torch.ones_like(y), y)


def _floordiv(x, y):
    """≙ jnp.floor_divide, zero divisors included."""
    if x.is_floating_point() or y.is_floating_point():
        # jax's _float_divmod: the division of x minus its C remainder,
        # corrected towards -inf (x / 0 gives NaN there, not ±inf)
        mod = torch.fmod(x, y)
        div = (x - mod) / y
        ind = (mod != 0) & (torch.sign(y) != torch.sign(mod))
        return torch.round(torch.where(ind, div - 1, div))
    x, y = torch.broadcast_tensors(x, y)
    zero = y == 0
    if x.dtype == torch.uint8:
        q = torch.div(x, torch.where(zero, torch.ones_like(y), y),
                      rounding_mode="trunc")
        return torch.where(zero, torch.full_like(q, 255), q)
    safe = _safe_divisor(y)
    q = torch.div(x, safe, rounding_mode="trunc")
    # y == -1: the quotient is -x (wrapping at INT_MIN), the remainder 0
    q = torch.where(y == -1, q.neg(), q)
    q = torch.where(zero, torch.full_like(q, -1), q)
    rem = torch.where(zero, x, torch.fmod(x, safe))
    adjust = (torch.sign(x) != torch.sign(y)) & (rem != 0)
    return torch.where(adjust, q - 1, q)


def _mod(x, y):
    """≙ jnp.mod: an integer zero divisor counts as 1 (remainder 0), and
    so does -1, whose remainder is 0 too."""
    if x.is_floating_point() or y.is_floating_point():
        return torch.remainder(x, y)
    return torch.remainder(x, _safe_divisor(y))


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
register_op("elementwise_max")(_binary(torch.maximum))
register_op("elementwise_min")(_binary(torch.minimum))
register_op("elementwise_pow")(_binary(torch.pow))
register_op("elementwise_mod")(_binary(_mod))
register_op("elementwise_floordiv")(_binary(_floordiv))
register_op("less_than")(_binary(torch.lt))
register_op("less_equal")(_binary(torch.le))
register_op("greater_than")(_binary(torch.gt))
register_op("greater_equal")(_binary(torch.ge))
register_op("equal")(_binary(torch.eq))
register_op("not_equal")(_binary(torch.ne))
register_op("logical_and")(_binary(torch.logical_and))
register_op("logical_or")(_binary(torch.logical_or))
register_op("logical_xor")(_binary(torch.logical_xor))


@register_op("logical_not")
def _logical_not(ctx, ins, attrs):
    return {"Out": [torch.logical_not(ins["X"][0])]}


@register_op("scale")
def _scale(ctx, ins, attrs):
    # ≙ scale_op.cc: out = scale * x + bias, or scale * (x + bias)
    x = ins["X"][0]
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}


@register_op("clip")
def _clip(ctx, ins, attrs):
    return {"Out": [torch.clamp(ins["X"][0], attrs["min"], attrs["max"])]}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    # X scaled to L2 norm max_norm where its norm is larger
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = x.square().sum().sqrt()
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp_min(norm, 1e-12),
                        torch.ones((), dtype=norm.dtype, device=x.device))
    return {"Out": [x * scale]}


@register_op("pow")
def _pow(ctx, ins, attrs):
    return {"Out": [torch.pow(ins["X"][0], attrs.get("factor", 1.0))]}


@register_op("isfinite")
def _isfinite(ctx, ins, attrs):
    # ≙ isfinite_op: one bool over every element of every input
    out = torch.isfinite(ins["X"][0]).all()
    for x in ins["X"][1:]:
        out = out & torch.isfinite(x).all()
    return {"Out": [out]}


def _unary(fn):
    def lower(ctx, ins, attrs):
        return {"Out": [fn(ins["X"][0])]}
    return lower


def _unary_float(fn):
    def lower(ctx, ins, attrs):
        return {"Out": [fn(floating(ins["X"][0]))]}
    return lower


def softplus(x):
    # jax.nn.softplus = logaddexp(x, 0) (F.softplus turns linear past 20)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


for _name, _fn in (("relu", torch.relu), ("sigmoid", torch.sigmoid),
                   ("tanh", torch.tanh), ("exp", torch.exp),
                   ("sqrt", torch.sqrt), ("ceil", torch.ceil),
                   ("floor", torch.floor), ("cos", torch.cos),
                   ("reciprocal", torch.reciprocal),
                   ("tanh_shrink", lambda x: x - torch.tanh(x)),
                   ("rsqrt", torch.rsqrt), ("abs", torch.abs),
                   ("sin", torch.sin), ("round", torch.round),
                   ("log", torch.log), ("square", torch.square),
                   ("relu6", lambda x: x.clamp(0.0, 6.0)),
                   ("softsign", lambda x: x / (1 + x.abs())),
                   ("silu", torch.nn.functional.silu)):
    register_op(_name)(_unary(_fn))
for _name, _fn in (("logsigmoid", torch.nn.functional.logsigmoid),
                   ("softplus", softplus),
                   ("gelu", lambda x: torch.nn.functional.gelu(
                       x, approximate="tanh"))):
    register_op(_name)(_unary_float(_fn))


@register_op("sign")
def _sign(ctx, ins, attrs):
    # ≙ jnp.sign, which keeps NaN (torch.sign maps it to 0)
    x = ins["X"][0]
    return {"Out": [torch.where(torch.isnan(x), x, torch.sign(x))]}


@register_op("leaky_relu")
def _leaky_relu(ctx, ins, attrs):
    alpha = attrs.get("alpha", 0.02)
    x = ins["X"][0]
    return {"Out": [torch.where(x >= 0, x, alpha * x)]}


@register_op("elu")
def _elu(ctx, ins, attrs):
    x = ins["X"][0]
    alpha = attrs.get("alpha", 1.0)
    return {"Out": [torch.where(x > 0, x, alpha * torch.expm1(x))]}


@register_op("hard_sigmoid")
def _hard_sigmoid(ctx, ins, attrs):
    slope = attrs.get("slope", 0.2)
    offset = attrs.get("offset", 0.5)
    return {"Out": [(ins["X"][0] * slope + offset).clamp(0.0, 1.0)]}


@register_op("hard_shrink")
def _hard_shrink(ctx, ins, attrs):
    t = attrs.get("threshold", 0.5)
    x = ins["X"][0]
    return {"Out": [torch.where(x.abs() > t, x, 0.0)]}


@register_op("soft_shrink")
def _soft_shrink(ctx, ins, attrs):
    lam = attrs.get("lambda", 0.5)
    x = ins["X"][0]
    return {"Out": [torch.where(x > lam, x - lam,
                                torch.where(x < -lam, x + lam, 0.0))]}


@register_op("thresholded_relu")
def _thresholded_relu(ctx, ins, attrs):
    t = attrs.get("threshold", 1.0)
    x = ins["X"][0]
    return {"Out": [torch.where(x > t, x, 0.0)]}


@register_op("swish")
def _swish(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x * torch.sigmoid(attrs.get("beta", 1.0) * x)]}


@register_op("brelu")
def _brelu(ctx, ins, attrs):
    return {"Out": [ins["X"][0].clamp(attrs.get("t_min", 0.0),
                                      attrs.get("t_max", 24.0))]}


@register_op("prelu")
def _prelu(ctx, ins, attrs):
    x = ins["X"][0]
    alpha = ins["Alpha"][0]
    if attrs.get("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": [torch.where(x >= 0, x, alpha * x)]}


@register_op("maxout")
def _maxout(ctx, ins, attrs):
    # ≙ maxout_op: NCHW, the channels in groups of `groups`
    x = ins["X"][0]
    groups = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": [x.reshape(n, c // groups, groups, h, w).amax(dim=2)]}
