"""Random op lowerings: the startup program's initializers and dropout.

≙ paddle_tpu/ops/random_ops.py (uniform_random, gaussian_random, dropout).
Draws come from the run's torch.Generator (LowerCtx.generator, seeded per
run by the executor), or from a fresh one seeded with the op's own nonzero
`seed` attr. torch's Philox and jax's threefry give different numbers from
the same seed: the two packages agree in distribution, not in values.
"""

from __future__ import annotations

import torch

from ..core.dtypes import convert_dtype
from ..framework.registry import register_op


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
