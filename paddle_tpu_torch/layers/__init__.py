"""fluid.layers-equivalent namespace, trimmed to the serving slice."""

from . import control_flow, io, math_ops, nn, ops, tensor  # noqa: F401
from .control_flow import less_than  # noqa: F401
from .io import data  # noqa: F401
from .math_ops import scale  # noqa: F401
from .nn import (cache_write, elementwise_add, embedding, fc,  # noqa: F401
                 layer_norm, log_softmax, matmul, one_hot, reshape, softmax,
                 transpose, unsqueeze)
from .ops import relu  # noqa: F401
from .tensor import argmax, assign, cast, fill_constant  # noqa: F401
