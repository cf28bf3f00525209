"""fluid.layers-equivalent namespace, trimmed to the serving and training
slices."""

from . import (control_flow, io, math_ops, nn, ops, sequence,  # noqa: F401
               tensor)
from .control_flow import equal, greater_than, less_than  # noqa: F401
from .io import data  # noqa: F401
from .math_ops import scale  # noqa: F401
from .nn import (cache_write, elementwise_add, elementwise_div,  # noqa: F401
                 elementwise_mul, embedding, fc, fused_attention, gather,
                 layer_norm, log_softmax, matmul, mean, one_hot, reduce_sum,
                 reshape, slice, softmax, softmax_with_cross_entropy,
                 transpose, unsqueeze)
from .ops import relu  # noqa: F401
from .sequence import get_seqlen, sequence_mask  # noqa: F401
from .tensor import (argmax, assign, cast, concat,  # noqa: F401
                     fill_constant, fill_constant_batch_size_like)
