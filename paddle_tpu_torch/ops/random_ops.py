"""Random op lowerings for the startup program's initializers.

≙ paddle_tpu/ops/random_ops.py (uniform_random, gaussian_random). Draws come
from the run's torch.Generator (LowerCtx.generator), or from a fresh one
seeded with the op's own nonzero `seed` attr. torch's Philox and jax's
threefry give different numbers from the same seed: the two packages agree
in distribution, not in values.
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
