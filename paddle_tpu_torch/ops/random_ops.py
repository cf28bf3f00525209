"""Random op lowerings: the startup program's initializers, dropout and the
rest of the random family.

≙ paddle_tpu/ops/random_ops.py (uniform_random, gaussian_random,
truncated_gaussian_random, their *_batch_size_like forms, dropout,
sampling_id, random_crop).
Draws come from the run's torch.Generator (LowerCtx.generator, seeded per
run by the executor), or from a fresh one seeded with the op's own nonzero
`seed` attr. torch's Philox and jax's threefry give different numbers from
the same seed: the two packages agree in distribution, not in values.
"""

from __future__ import annotations

import math

import torch

from ..core.dtypes import convert_dtype
from ..framework.registry import register_effects, register_op


def _rng_effect(op):
    """Dataflow effect rule (framework/dataflow.py): the op draws from the
    per-step generator, unless a fixed `seed` attr pins the stream."""
    return {"rng": not op.attrs.get("seed")}


def _register_rng(op_type, rule=_rng_effect):
    register_effects(op_type)(rule)


@register_op("uniform_random")
def _uniform_random(ctx, ins, attrs):
    dtype = convert_dtype(attrs.get("dtype", "float32"))
    lo = attrs.get("min", -1.0)
    hi = attrs.get("max", 1.0)
    u = torch.rand(list(attrs["shape"]), dtype=torch.float32,
                   device=ctx.device,
                   generator=ctx.generator(attrs.get("seed", 0)))
    return {"Out": [(u * (hi - lo) + lo).to(dtype)]}


@register_op("gaussian_random")
def _gaussian_random(ctx, ins, attrs):
    dtype = convert_dtype(attrs.get("dtype", "float32"))
    mean = attrs.get("mean", 0.0)
    std = attrs.get("std", 1.0)
    n = torch.randn(list(attrs["shape"]), dtype=torch.float32,
                    device=ctx.device,
                    generator=ctx.generator(attrs.get("seed", 0)))
    return {"Out": [(mean + std * n).to(dtype)]}


@register_op("truncated_gaussian_random")
def _truncated_gaussian_random(ctx, ins, attrs):
    """mean + std * a standard normal truncated to [-2, 2] (≙
    jax.random.truncated_normal(-2, 2)), drawn by inverting the normal CDF
    over the uniform's image of [-2, 2]."""
    dtype = convert_dtype(attrs.get("dtype", "float32"))
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    u = torch.rand(list(attrs["shape"]), dtype=torch.float32,
                   device=ctx.device,
                   generator=ctx.generator(attrs.get("seed", 0)))
    n = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    n = n.clamp(-2.0, 2.0)
    return {"Out": [(attrs.get("mean", 0.0) + attrs.get("std", 1.0) * n)
                    .to(dtype)]}


def _bsl_shape(ins, attrs):
    """The shape of a *_batch_size_like op: `shape` with the batch dim
    copied from Input (≙ the reference's BatchSizeLikeOp base)."""
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ins["Input"][0].shape[attrs.get("input_dim_idx", 0)]
    return shape


@register_op("uniform_random_batch_size_like")
def _uniform_random_bsl(ctx, ins, attrs):
    return _uniform_random(ctx, ins, {**attrs, "shape": _bsl_shape(ins,
                                                                  attrs)})


@register_op("gaussian_random_batch_size_like")
def _gaussian_random_bsl(ctx, ins, attrs):
    return _gaussian_random(ctx, ins, {**attrs, "shape": _bsl_shape(ins,
                                                                   attrs)})


@register_op("sampling_id")
def _sampling_id(ctx, ins, attrs):
    """One class a row, drawn with probability X[row] (≙
    jax.random.categorical over log(X + 1e-20))."""
    x = ins["X"][0]
    ids = torch.multinomial(x.float() + 1e-20, 1,
                            generator=ctx.generator(attrs.get("seed", 0)))
    return {"Out": [ids[:, 0].to(torch.int64)]}


@register_op("random_crop")
def _random_crop(ctx, ins, attrs):
    """A window of `shape` over X's trailing dims at a random start per
    dim (one start for the whole batch, as the JAX package draws it). The
    start stays on the device: the window is an index_select of
    start + arange, so no value is read on the host."""
    x = ins["X"][0]
    shape = attrs["shape"]
    lead = x.dim() - len(shape)
    gen = ctx.generator(attrs.get("seed", 0))
    for i, s in enumerate(shape):
        dim = lead + i
        start = torch.randint(0, max(x.shape[dim] - s, 0) + 1, (1,),
                              generator=gen, device=x.device)
        x = x.index_select(dim, start + torch.arange(s, device=x.device))
    return {"Out": [x]}


@register_op("dropout")
def _dropout(ctx, ins, attrs):
    """≙ dropout_op.cc. `downgrade_in_infer` (the default): training gives
    Out = X * Mask with no 1/(1-p) upscale, inference X * (1-p);
    `upscale_in_train` the other way round. torch.nn.functional.dropout
    always upscales, so the mask is drawn here. Inference (the op's
    `is_test` attr, or a run with LowerCtx.is_test) draws nothing. Under a
    vjp_region the mask is drawn once, in the forward, and autograd's
    backward multiplies dOut by that same mask."""
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or ctx.is_test:
        # the mask of ones as a broadcast view: no memory, nothing drawn
        ones = torch.ones((), dtype=x.dtype, device=x.device).expand_as(x)
        if impl == "upscale_in_train":
            return {"Out": [x], "Mask": [ones]}
        return {"Out": [x * (1.0 - p)], "Mask": [ones]}
    u = torch.rand(x.shape, dtype=torch.float32, device=x.device,
                   generator=ctx.generator(attrs.get("seed", 0)))
    mask = (u >= p).to(x.dtype)        # kept with probability 1 - p
    out = x * mask
    if impl == "upscale_in_train":
        out = out / max(1.0 - p, 1e-8)
    return {"Out": [out], "Mask": [mask]}


for _t in ("uniform_random", "gaussian_random",
           "truncated_gaussian_random", "sampling_id", "random_crop",
           "uniform_random_batch_size_like",
           "gaussian_random_batch_size_like"):
    _register_rng(_t)

# dropout's inference path is deterministic (a scale): only the training
# path draws
_register_rng("dropout",
              lambda op: {"rng": not op.attrs.get("seed")
                          and not op.attrs.get("is_test")})
