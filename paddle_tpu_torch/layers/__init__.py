"""fluid.layers-equivalent namespace, trimmed to the serving, training and
recurrent slices."""

from . import (control_flow, io, math_ops, nn, ops, sequence,  # noqa: F401
               tensor)
from .control_flow import (StaticRNN, equal, greater_than,  # noqa: F401
                           less_than)
from .io import data  # noqa: F401
from .math_ops import scale  # noqa: F401
from .nn import (accuracy, cache_write, elementwise_add,  # noqa: F401
                 elementwise_div, elementwise_mul, embedding, fc,
                 fused_attention, gather, layer_norm, log_softmax, matmul,
                 mean, one_hot, reduce_sum, reshape, slice, softmax,
                 softmax_with_cross_entropy, squeeze, topk, transpose,
                 unsqueeze)
from .ops import relu, sigmoid, tanh  # noqa: F401
from .sequence import (dynamic_gru, dynamic_lstm, get_seqlen,  # noqa: F401
                       sequence_last_step, sequence_mask, sequence_pool)
from .tensor import (argmax, assign, cast, concat,  # noqa: F401
                     fill_constant, fill_constant_batch_size_like)
