"""fluid.layers-equivalent namespace, trimmed to the serving, training,
recurrent, image and CTR slices."""

from . import (control_flow, io, learning_rate_scheduler,  # noqa: F401
               math_ops, nn, ops, sequence, tensor)
from .control_flow import (StaticRNN, equal, greater_than,  # noqa: F401
                           less_than)
from .io import data  # noqa: F401
from .learning_rate_scheduler import (autoincreased_step_counter,  # noqa: F401
                                      cosine_decay, exponential_decay,
                                      inverse_time_decay, natural_exp_decay,
                                      noam_decay, piecewise_decay,
                                      polynomial_decay)
from .math_ops import scale  # noqa: F401
from .nn import (accuracy, batch_norm, cache_write, clip,  # noqa: F401
                 clip_by_norm, conv2d, conv2d_transpose, conv3d,
                 conv3d_transpose, dropout, elementwise_add, elementwise_div,
                 elementwise_max, elementwise_min, elementwise_mul,
                 elementwise_pow, elementwise_sub, embedding, fc,
                 fused_attention, gather, layer_norm, log_softmax, matmul,
                 mean, one_hot, paged_cache_write, paged_cache_write_quant,
                 pool2d, pool3d, reduce_max, reduce_mean,
                 reduce_min, reduce_prod, reduce_sum, reshape,
                 sigmoid_cross_entropy_with_logits, slice, softmax,
                 softmax_with_cross_entropy, squeeze, topk, transpose,
                 unsqueeze)
from .ops import (ceil, cos, exp, floor, pow, reciprocal, relu,  # noqa: F401
                  sigmoid, sign, sqrt, tanh)
from .sequence import (dynamic_gru, dynamic_lstm, get_seqlen,  # noqa: F401
                       sequence_last_step, sequence_mask, sequence_pool)
from .tensor import (argmax, assign, cast, concat,  # noqa: F401
                     fill_constant, fill_constant_batch_size_like, sums)
