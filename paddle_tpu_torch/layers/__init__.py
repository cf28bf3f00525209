"""fluid.layers-equivalent namespace, trimmed to the serving, training,
recurrent (control flow and sequence labelling included), image and CTR
slices."""

from . import (control_flow, io, learning_rate_scheduler,  # noqa: F401
               math_ops, nn, ops, sequence, tensor)
from .control_flow import (DynamicRNN, IfElse, StaticRNN,  # noqa: F401
                           Switch, While, cond, equal, greater_equal,
                           greater_than, increment, less_equal, less_than,
                           not_equal)
from .io import data  # noqa: F401
from .learning_rate_scheduler import (autoincreased_step_counter,  # noqa: F401
                                      cosine_decay, exponential_decay,
                                      inverse_time_decay, natural_exp_decay,
                                      noam_decay, piecewise_decay,
                                      polynomial_decay)
from .math_ops import scale  # noqa: F401
from .nn import (accuracy, batch_norm, beam_search,  # noqa: F401
                 beam_search_decode, cache_write, clip, clip_by_norm, conv2d,
                 conv2d_transpose, conv3d, conv3d_transpose, dropout,
                 elementwise_add, elementwise_div, elementwise_max,
                 elementwise_min, elementwise_mul, elementwise_pow,
                 elementwise_sub, embedding, expand, fc, fused_attention,
                 gather, gather_tree, gru_unit, layer_norm, log_softmax,
                 lstm_unit, matmul, mean, one_hot, paged_cache_write,
                 paged_cache_write_quant, pool2d, pool3d, reduce_max,
                 reduce_mean, reduce_min, reduce_prod, reduce_sum, reshape,
                 row_conv, sigmoid_cross_entropy_with_logits, slice, softmax,
                 softmax_with_cross_entropy, squeeze, topk, transpose,
                 unsqueeze)
from .ops import (ceil, cos, exp, floor, pow, reciprocal, relu,  # noqa: F401
                  sigmoid, sign, sqrt, tanh)
from .sequence import (chunk_eval, crf_decoding,  # noqa: F401
                       dynamic_gru, dynamic_lstm, dynamic_lstmp, get_seqlen,
                       linear_chain_crf, sequence_concat, sequence_conv,
                       sequence_erase, sequence_expand, sequence_first_step,
                       sequence_last_step, sequence_mask, sequence_pad,
                       sequence_pool, sequence_reshape, sequence_reverse,
                       sequence_slice, sequence_softmax)
from .tensor import (argmax, assign, cast, concat,  # noqa: F401
                     create_tensor, fill_constant,
                     fill_constant_batch_size_like, sums)
