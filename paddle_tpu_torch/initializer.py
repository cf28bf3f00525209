"""Parameter initializers.

≙ paddle_tpu/initializer.py (reference python/paddle/fluid/initializer.py) —
each initializer appends an op to the *startup program* that fills the
parameter; running the startup program once initializes the scope. The
random ops draw from the executor's torch.Generator (ops/random_ops.py).
"""

from __future__ import annotations

import numpy as np

from .core.dtypes import dtype_name


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "value": self.value,
                               "dtype": dtype_name(var.dtype)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "min": self.low,
                               "max": self.high, "seed": self.seed,
                               "dtype": dtype_name(var.dtype)})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "mean": self.loc,
                               "std": self.scale, "seed": self.seed,
                               "dtype": dtype_name(var.dtype)})


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("truncated_gaussian_random",
                        outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "mean": self.loc,
                               "std": self.scale, "seed": self.seed,
                               "dtype": dtype_name(var.dtype)})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv filters OIHW: receptive field * channels
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


class XavierInitializer(Initializer):
    """≙ fluid.initializer.Xavier (Glorot)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fin, fout = _fan_in_out(var)
        fin = self.fan_in if self.fan_in is not None else fin
        fout = self.fan_out if self.fan_out is not None else fout
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fin + fout)))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / (fin + fout)))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """≙ fluid.initializer.MSRA (He)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fin, _ = _fan_in_out(var)
        fin = self.fan_in if self.fan_in is not None else fin
        if self.uniform:
            limit = float(np.sqrt(6.0 / fin))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / fin))
            NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """≙ fluid.initializer.Bilinear — upsampling deconv filter init."""

    def __call__(self, var, block):
        shape = var.shape
        f = np.ceil(shape[-1] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype=np.float32)
        for idx in np.ndindex(*shape):
            x, y = idx[-1], idx[-2]
            weight[idx] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        block.append_op("assign_value", outputs={"Out": [var.name]},
                        attrs={"shape": list(shape),
                               "dtype": dtype_name(var.dtype),
                               "values": weight.reshape(-1).tolist()})


class NumpyArrayInitializer(Initializer):
    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op("assign_value", outputs={"Out": [var.name]},
                        attrs={"shape": list(self.value.shape),
                               "dtype": dtype_name(var.dtype),
                               "values": self.value.reshape(-1).tolist()})


# fluid-style aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)
