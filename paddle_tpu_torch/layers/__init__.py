"""fluid.layers-equivalent namespace (≙ paddle_tpu/layers, reference
python/paddle/fluid/layers/)."""

from . import (control_flow, detection, device, io,  # noqa: F401
               learning_rate_scheduler, math_ops, nn, ops, sequence, tensor)
from .control_flow import (DynamicRNN, IfElse, StaticRNN,  # noqa: F401
                           Switch, While, cond, equal, greater_equal,
                           greater_than, increment, less_equal, less_than,
                           not_equal)
from .device import get_places  # noqa: F401
from .io import batch_row_mask, data  # noqa: F401
from .learning_rate_scheduler import (autoincreased_step_counter,  # noqa: F401
                                      cosine_decay, exponential_decay,
                                      inverse_time_decay, natural_exp_decay,
                                      noam_decay, piecewise_decay,
                                      polynomial_decay)
from .math_ops import scale  # noqa: F401
from .nn import (accuracy, auc, batch_norm, beam_search,  # noqa: F401
                 beam_search_decode, bilinear_tensor_product, cache_write,
                 clip, clip_by_norm, conv2d, conv2d_transpose, conv3d,
                 conv3d_transpose, cos_sim, cross_entropy, dice_loss,
                 dropout, elementwise_add, elementwise_div, elementwise_max,
                 elementwise_min, elementwise_mul, elementwise_op_layer,
                 elementwise_pow, elementwise_sub, embedding, expand, fc,
                 flatten, fused_attention, gather, gather_tree, gru_unit,
                 hinge_loss, hsigmoid, huber_loss, image_resize,
                 image_resize_short, l2_normalize, label_smooth, layer_norm,
                 log_loss, log_softmax, lrn, lstm_unit, margin_rank_loss,
                 matmul, mean, nce, one_hot, pad, paged_cache_write,
                 paged_cache_write_quant, pool2d, pool3d,
                 positive_negative_pair, rank_loss, reduce_max, reduce_mean,
                 reduce_min, reduce_prod, reduce_sum, reshape,
                 resize_bilinear, row_conv, scatter,
                 sigmoid_cross_entropy_with_logits, slice, smooth_l1,
                 softmax, softmax_with_cross_entropy, split, spp,
                 square_error_cost, squared_l2_distance, squared_l2_norm,
                 squeeze, stack, topk, transpose, unsqueeze)
from .ops import (abs, brelu, ceil, cos, elu, exp,  # noqa: F401
                  floor, gelu, hard_shrink, hard_sigmoid, leaky_relu, log,
                  logsigmoid, maxout, pow, prelu, reciprocal, relu, relu6,
                  round, rsqrt, sigmoid, sign, silu, sin, soft_shrink,
                  softplus, softsign, sqrt, square, swish, tanh,
                  tanh_shrink, thresholded_relu)
from .sequence import (chunk_eval, crf_decoding,  # noqa: F401
                       ctc_greedy_decoder, dynamic_gru, dynamic_lstm,
                       dynamic_lstmp, get_seqlen, linear_chain_crf,
                       sequence_concat, sequence_conv, sequence_erase,
                       sequence_expand, sequence_first_step,
                       sequence_last_step, sequence_mask, sequence_pad,
                       sequence_pool, sequence_reshape, sequence_reverse,
                       sequence_slice, sequence_softmax, warpctc)
from .tensor import (argmax, argmin, argsort, assign, cast,  # noqa: F401
                     concat, create_tensor, fill_constant,
                     fill_constant_batch_size_like, ones, reverse, sums,
                     zeros, zeros_like)
# the names the JAX package's layers namespace re-exports from its modules
from ..framework.program import Variable  # noqa: F401,E402
from ..initializer import (ConstantInitializer,  # noqa: F401,E402
                           NormalInitializer)
from ..layer_helper import LayerHelper  # noqa: F401,E402
from ..param_attr import ParamAttr  # noqa: F401,E402
