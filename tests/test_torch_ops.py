"""Every op the port lowers, against the JAX package's lowering of it.

One numpy input dict (made from a seed) goes through both registries —
`paddle_tpu.framework.registry.lookup_op(t).lower` on jax arrays and
`paddle_tpu_torch.framework.registry.lookup_op(t).lower` on CPU torch
tensors — and every output slot is compared. Tolerances: float32 results
at 1e-5 (summation order); results the bf16 policy rounds to bfloat16 at
2e-2 relative (one or two bfloat16 steps: the two libraries accumulate the
float32 product in a different order before the one rounding); integer
and boolean results exactly. The random initializer ops are compared in
distribution (threefry and Philox give different draws).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.framework import registry as jreg
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.framework.executor import as_numpy

from tests.port_env import port_jax_compile_cache  # noqa: F401

R = np.random.RandomState(7)


def f32(*shape):
    return R.randn(*shape).astype("float32")


def _per_slot_cache_case():
    cache = f32(4, 1, 3, 8, 5)
    new = f32(4, 1, 3, 1, 5)
    pos = np.array([0, 3, 7, 5], "float32").reshape(4, 1, 1)
    return {"Cache": [cache], "New": [new], "Pos": [pos]}, \
        {"axis": 3, "batch_axis": 0}


_T = 12

# (id, op type, ins, attrs, {slot: "bf16"} for outputs rounded to bfloat16,
#  {slot: dtype} for inputs fed in another dtype than their numpy array)
CASES = [
    ("add_same", "elementwise_add", {"X": [f32(2, 3, 4)], "Y": [f32(2, 3, 4)]},
     {"axis": -1}, {}, {}),
    ("add_axis1", "elementwise_add", {"X": [f32(2, 3, 4)], "Y": [f32(3)]},
     {"axis": 1}, {}, {}),
    ("add_trailing", "elementwise_add",
     {"X": [f32(4, 1, _T)], "Y": [f32(1, 1, _T)]}, {"axis": -1}, {}, {}),
    ("add_bf16_bias", "elementwise_add", {"X": [f32(2, 1, 6)], "Y": [f32(6)]},
     {"axis": 2, "use_bf16": True}, {"Out": "bf16"}, {"X": "bfloat16"}),
    ("add_bf16_promotes", "elementwise_add",
     {"X": [f32(2, 1, 6)], "Y": [f32(2, 1, 6)]}, {"axis": -1}, {},
     {"X": "bfloat16"}),
    ("less_than", "less_than",
     {"X": [np.arange(_T, dtype="float32").reshape(1, 1, _T)],
      "Y": [np.array([1, 4, 12, 7], "float32").reshape(4, 1, 1)]},
     {}, {}, {}),
    ("scale_after", "scale", {"X": [f32(3, 5)]},
     {"scale": 1e9, "bias": -1e9, "bias_after_scale": True}, {}, {}),
    ("scale_before", "scale", {"X": [f32(3, 5)]},
     {"scale": 2.5, "bias": 0.5, "bias_after_scale": False}, {}, {}),
    ("relu", "relu", {"X": [f32(3, 7)]}, {}, {}, {}),
    ("mul_f32", "mul", {"X": [f32(4, 1, 8)], "Y": [f32(8, 6)]},
     {"x_num_col_dims": 2, "y_num_col_dims": 1, "use_bf16": False}, {}, {}),
    ("mul_bf16", "mul", {"X": [f32(4, 1, 16)], "Y": [f32(16, 6)]},
     {"x_num_col_dims": 2, "y_num_col_dims": 1, "use_bf16": True},
     {"Out": "bf16"}, {}),
    ("matmul_f32_alpha", "matmul",
     {"X": [f32(4, 1, 3, 1, 5)], "Y": [f32(4, 1, 3, _T, 5)]},
     {"transpose_Y": True, "alpha": 5 ** -0.5}, {}, {}),
    ("matmul_bf16q_f32k", "matmul",
     {"X": [f32(4, 1, 3, 1, 5)], "Y": [f32(4, 1, 3, _T, 5)]},
     {"transpose_Y": True, "alpha": 5 ** -0.5}, {"Out": "bf16"},
     {"X": "bfloat16"}),
    ("matmul_bf16", "matmul", {"X": [f32(2, 3, 8)], "Y": [f32(2, 8, 4)]},
     {"use_bf16": True}, {"Out": "bf16"}, {}),
    ("matmul_broadcast", "matmul", {"X": [f32(4, 1, _T)], "Y": [f32(_T, 6)]},
     {}, {}, {}),
    ("layer_norm", "layer_norm",
     {"X": [f32(4, 1, 8)], "Scale": [f32(8)], "Bias": [f32(8)]},
     {"begin_norm_axis": 2, "epsilon": 1e-5}, {}, {}),
    ("softmax", "softmax", {"X": [f32(4, 1, 3, 1, _T)]}, {"axis": -1}, {}, {}),
    ("log_softmax", "log_softmax", {"X": [f32(4, 1, 9)]}, {"axis": -1}, {},
     {}),
    ("reshape", "reshape", {"X": [f32(4, 1, 12)]},
     {"shape": [0, 1, 3, 1, 4]}, {}, {}),
    ("transpose", "transpose", {"X": [f32(2, 3, 4, 5)]},
     {"axis": [0, 2, 1, 3]}, {}, {}),
    ("unsqueeze_23", "unsqueeze", {"X": [f32(4, 1, _T)]}, {"axes": [2, 3]},
     {}, {}),
    ("unsqueeze_neg", "unsqueeze", {"X": [f32(4, 3)]}, {"axes": [-1]}, {},
     {}),
    ("cast_f2i", "cast",
     {"X": [np.array([0., 3., 7.9, 31.], "float32").reshape(4, 1, 1)]},
     {"out_dtype": "int64"}, {}, {}),
    ("cast_b2f", "cast", {"X": [f32(3, 4) > 0]}, {"out_dtype": "float32"},
     {}, {}),
    ("assign_value", "assign_value", {},
     {"shape": [2, 3], "dtype": "float32",
      "values": [0.5, 1.0, -2.0, 3.25, 0.0, 7.0]}, {}, {}),
    ("fill_constant", "fill_constant", {},
     {"shape": [2, 1, 3], "dtype": "float32", "value": 1.5}, {}, {}),
    ("one_hot", "one_hot",
     {"X": [np.array([0, 3, 11, 5], "int64").reshape(4, 1, 1)]},
     {"depth": _T}, {}, {}),
    ("lookup_table", "lookup_table",
     {"W": [f32(10, 6)], "Ids": [np.array([[[1]], [[9]], [[0]]], "int64")]},
     {"padding_idx": None}, {}, {}),
    ("lookup_table_pad", "lookup_table",
     {"W": [f32(10, 6)], "Ids": [np.array([[1], [9], [0]], "int64")]},
     {"padding_idx": -1}, {}, {}),
    ("cache_write_per_slot", "cache_write", *_per_slot_cache_case(), {}, {}),
    ("cache_write_uniform", "cache_write",
     {"Cache": [f32(2, 3, 8, 5)], "New": [f32(2, 3, 1, 5)],
      "Pos": [np.full((2, 1), 6, "float32")]}, {"axis": 2}, {}, {}),
    ("arg_max", "arg_max", {"X": [f32(4, 1, 9)]}, {"axis": 2}, {}, {}),
    ("fused_decode_attention", "fused_decode_attention",
     {"Q": [f32(4, 1, 3, 1, 5)], "K": [f32(4, 1, 3, _T, 5)],
      "V": [f32(4, 1, 3, _T, 5)],
      "Bias": [np.where(np.arange(_T)[None] < np.array([[1], [4], [12], [7]]),
                        0.0, -1e9).astype("float32").reshape(4, 1, 1, 1, _T)]},
     {"scale": 5 ** -0.5}, {}, {}),
    # training slice
    ("sub_axis1", "elementwise_sub", {"X": [f32(2, 3, 4)], "Y": [f32(3)]},
     {"axis": 1}, {}, {}),
    ("mul_trailing", "elementwise_mul",
     {"X": [f32(4, 6, 1)], "Y": [f32(4, 6, 1)]}, {"axis": -1}, {}, {}),
    ("div", "elementwise_div", {"X": [f32(3, 1)], "Y": [f32(1)]},
     {"axis": -1}, {}, {}),
    ("greater_than", "greater_than",
     {"X": [np.array([[0, 2, 1, 0]], "int32")],
      "Y": [np.array([0], "int32")]}, {}, {}, {}),
    ("equal", "equal",
     {"X": [np.array([[1, 1, 2, 0]], "int32")],
      "Y": [np.array([[1, 2, 2, 0]], "int32")]}, {}, {}, {}),
    ("reduce_sum_all", "reduce_sum", {"X": [f32(4, 6, 1)]},
     {"dim": None, "keep_dim": False, "reduce_all": True}, {}, {}),
    ("reduce_sum_dim_keep", "reduce_sum", {"X": [f32(4, 6, 3)]},
     {"dim": [1], "keep_dim": True, "reduce_all": False}, {}, {}),
    ("reduce_sum_int", "reduce_sum", {"X": [np.arange(12, dtype="int32")
                                           .reshape(3, 4)]},
     {"dim": 0, "keep_dim": False, "reduce_all": False}, {}, {}),
    ("mean", "mean", {"X": [f32(4, 6, 1)]}, {}, {}, {}),
    ("gather_2d_index", "gather",
     {"X": [f32(_T, 5)], "Index": [np.array([[0, 3], [11, 2]], "int32")]},
     {}, {}, {}),
    ("slice", "slice", {"X": [np.arange(24, dtype="int32").reshape(2, 12)]},
     {"axes": [1], "starts": [1], "ends": [_T]}, {}, {}),
    ("concat", "concat", {"X": [np.ones((2, 11), "int32"),
                                np.zeros((2, 1), "int32")]},
     {"axis": 1}, {}, {}),
    ("fill_constant_batch_size_like", "fill_constant_batch_size_like",
     {"Input": [np.zeros((3, _T), "int32")]},
     {"shape": [-1, 1], "dtype": "int32", "value": 0.0, "input_dim_idx": 0,
      "output_dim_idx": 0}, {}, {}),
    ("sequence_mask", "sequence_mask",
     {"X": [np.array([_T, 5, 0, 1], "int32")]}, {"maxlen": _T}, {}, {}),
    ("ce_hard", "softmax_with_cross_entropy",
     {"Logits": [f32(3, 4, 9)],
      "Label": [np.array([[0, 8, 3, 1]] * 3, "int64").reshape(3, 4, 1)]},
     {"soft_label": False, "ignore_index": -100}, {}, {}),
    ("ce_hard_bf16_ignore", "softmax_with_cross_entropy",
     {"Logits": [f32(3, 4, 9)],
      "Label": [np.array([[0, -1, 3, 8]] * 3, "int64").reshape(3, 4, 1)]},
     {"soft_label": False, "ignore_index": -1}, {}, {"Logits": "bfloat16"}),
    ("ce_soft", "softmax_with_cross_entropy",
     {"Logits": [f32(3, 9)],
      "Label": [np.full((3, 9), 1 / 9, "float32")]},
     {"soft_label": True}, {}, {}),
    ("sgd", "sgd", {"Param": [f32(4, 3)], "Grad": [f32(4, 3)],
                    "LearningRate": [np.array([0.1], "float32")]},
     {}, {}, {}),
    ("momentum", "momentum",
     {"Param": [f32(4, 3)], "Grad": [f32(4, 3)], "Velocity": [f32(4, 3)],
      "LearningRate": [np.array([0.1], "float32")]},
     {"mu": 0.9, "use_nesterov": False}, {}, {}),
    ("momentum_nesterov", "momentum",
     {"Param": [f32(4, 3)], "Grad": [f32(4, 3)], "Velocity": [f32(4, 3)],
      "LearningRate": [np.array([0.1], "float32")]},
     {"mu": 0.9, "use_nesterov": True}, {}, {}),
    ("adam", "adam",
     {"Param": [f32(4, 3)], "Grad": [f32(4, 3)], "Moment1": [f32(4, 3)],
      "Moment2": [np.abs(f32(4, 3))],
      "Beta1Pow": [np.array([0.81], "float32")],
      "Beta2Pow": [np.array([0.998], "float32")],
      "LearningRate": [np.array([1e-3], "float32")]},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, {}, {}),
    ("fused_attention_packed_causal", "fused_attention",
     {"Q": [f32(2, 2, 40, 8)], "K": [f32(2, 2, 40, 8)], "V": [f32(2, 2, 40, 8)],
      "QSeg": [np.repeat([[1] * 17 + [2] * 20 + [0] * 3], 2, 0)
               .astype("int32")],
      "KVSeg": [np.repeat([[1] * 17 + [2] * 20 + [0] * 3], 2, 0)
                .astype("int32")]},
     {"scale": None, "causal": True, "backend": "pallas_interpret"}, {}, {}),
    # recurrent slice
    ("sigmoid", "sigmoid", {"X": [f32(3, 7) * 4]}, {}, {}, {}),
    ("tanh", "tanh", {"X": [f32(3, 7) * 4]}, {}, {}, {}),
    ("squeeze_axis", "squeeze", {"X": [f32(4, 1, 6)]}, {"axes": [1]}, {},
     {}),
    ("squeeze_all", "squeeze", {"X": [f32(1, 4, 1)]}, {"axes": []}, {}, {}),
    ("sum_n", "sum", {"X": [f32(4, 3), f32(4, 3), f32(4, 3)]}, {}, {}, {}),
    ("top_k", "top_k", {"X": [f32(5, 9)]}, {"k": 3}, {}, {}),
    ("accuracy", "accuracy",
     {"Out": [f32(5, 1)],
      "Indices": [np.array([[0], [1], [1], [0], [1]], "int64")],
      "Label": [np.array([[0], [1], [0], [0], [0]], "int64")]}, {}, {}, {}),
    ("accuracy_top2", "accuracy",
     {"Out": [f32(3, 2)],
      "Indices": [np.array([[2, 0], [1, 3], [3, 2]], "int64")],
      "Label": [np.array([0, 2, 1], "int64")]}, {}, {}, {}),
    *[(f"sequence_pool_{p.lower()}", "sequence_pool",
       {"X": [f32(4, 6, 3)], "SeqLen": [np.array([6, 0, 1, 4], "int32")]},
       {"pooltype": p}, {}, {})
      for p in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST")],
    ("sequence_last_step", "sequence_last_step",
     {"X": [f32(4, 6, 3)], "SeqLen": [np.array([6, 2, 1, 4], "int64")]},
     {}, {}, {}),
    # ties: the lower index first, as jax.lax.top_k
    ("top_k_ties", "top_k",
     {"X": [np.array([[5, 5, 5, 5], [2, 7, 2, 7], [1, 3, 3, 1]], "float32")]},
     {"k": 2}, {}, {}),
    ("top_k_ties_k3", "top_k",
     {"X": [np.array([[5, 5, 5, 5], [2, 7, 2, 7], [1, 3, 3, 1]], "float32")]},
     {"k": 3}, {}, {}),
    # indices out of range: jax wraps [-n, 0) and fills the rest (NaN for
    # floats, the least int32 for int32)
    ("gather_out_of_range", "gather",
     {"X": [f32(6, 2)], "Index": [np.array([7, -1, -7, 5], "int32")]},
     {}, {}, {}),
    ("gather_out_of_range_int", "gather",
     {"X": [np.arange(12, dtype="int32").reshape(6, 2)],
      "Index": [np.array([[7, -1], [-7, 0]], "int64")]}, {}, {}, {}),
    ("lookup_table_out_of_range", "lookup_table",
     {"W": [f32(10, 6)], "Ids": [np.array([[12], [-1], [3], [-11]], "int64")]},
     {"padding_idx": None}, {}, {}),
    *[(f"lookup_table_out_of_range_pad{p}", "lookup_table",
       {"W": [f32(10, 6)],
        "Ids": [np.array([[12], [-1], [3], [-11], [9]], "int64")]},
       {"padding_idx": p}, {}, {}) for p in (3, -1)],
    ("sequence_last_step_past_t", "sequence_last_step",
     {"X": [f32(4, 6, 3)], "SeqLen": [np.array([6, 9, 0, 7], "int64")]},
     {}, {}, {}),
    ("sequence_pool_last_past_t", "sequence_pool",
     {"X": [f32(4, 6, 3)], "SeqLen": [np.array([7, 2, 0, 6], "int32")]},
     {"pooltype": "LAST"}, {}, {}),
    # hard labels outside [0, V), as jax's fill mode meets them: 5 of V = 5
    # gives NaN, -1 wraps to 4, -6 gives NaN, ignore_index gives 0
    ("ce_label_past_v", "softmax_with_cross_entropy",
     {"Logits": [f32(3, 5)], "Label": [np.array([[5], [0], [7]], "int64")]},
     {"soft_label": False, "ignore_index": -100}, {}, {}),
    ("ce_label_negative_wraps", "softmax_with_cross_entropy",
     {"Logits": [f32(4, 5)],
      "Label": [np.array([[-1], [-5], [-6], [2]], "int64")]},
     {"soft_label": False, "ignore_index": -100}, {}, {}),
    ("ce_label_ignore", "softmax_with_cross_entropy",
     {"Logits": [f32(2, 3, 5)],
      "Label": [np.array([[-1, 7, 1], [4, -1, 9]], "int64")[..., None]]},
     {"soft_label": False, "ignore_index": -1}, {}, {}),
    # float -> int saturates, NaN -> 0, as XLA's convert
    ("cast_f32_i32_saturates", "cast",
     {"X": [np.array([np.nan, np.inf, -np.inf, 1e10, -1e10, 300.7, -2.5],
                     "float32")]}, {"out_dtype": "int32"}, {}, {}),
    ("cast_f32_i8_saturates", "cast",
     {"X": [np.array([np.nan, np.inf, -np.inf, 1e10, -1e10, 300.7, -2.5],
                     "float32")]}, {"out_dtype": "int8"}, {}, {}),
    ("cast_f32_u8_saturates", "cast",
     {"X": [np.array([np.nan, np.inf, -np.inf, 1e10, -1e10, 300.7, -2.5],
                     "float32")]}, {"out_dtype": "uint8"}, {}, {}),
    ("cast_bf16_i32_saturates", "cast",
     {"X": [np.array([np.nan, 3e9, -3e9, 2.75, -7.5], "float32")]},
     {"out_dtype": "int32"}, {}, {"X": "bfloat16"}),
    # the ops of dropout, clipping, weight decay and the LR schedules
    ("dropout_is_test", "dropout", {"X": [f32(3, 7)]},
     {"dropout_prob": 0.1, "is_test": True}, {}, {}),
    ("dropout_is_test_upscale", "dropout", {"X": [f32(3, 7)]},
     {"dropout_prob": 0.3, "is_test": True,
      "dropout_implementation": "upscale_in_train"}, {}, {}),
    ("reduce_mean_dim_keep", "reduce_mean", {"X": [f32(2, 3, 9)]},
     {"dim": [2], "keep_dim": True, "reduce_all": False}, {}, {}),
    ("reduce_mean_all", "reduce_mean", {"X": [f32(4, 6)]},
     {"dim": None, "keep_dim": False, "reduce_all": True}, {}, {}),
    ("reduce_mean_bf16", "reduce_mean", {"X": [f32(2, 3, 9)]},
     {"dim": [2], "keep_dim": True, "reduce_all": False}, {"Out": "bf16"},
     {"X": "bfloat16"}),
    ("reduce_max", "reduce_max", {"X": [f32(4, 6, 3)]},
     {"dim": [0, 2], "keep_dim": False, "reduce_all": False}, {}, {}),
    ("reduce_min_keep_all", "reduce_min", {"X": [f32(4, 6)]},
     {"dim": None, "keep_dim": True, "reduce_all": True}, {}, {}),
    ("reduce_prod", "reduce_prod", {"X": [f32(3, 4, 2) * 0.5 + 1]},
     {"dim": [1, 2], "keep_dim": False, "reduce_all": False}, {}, {}),
    ("squared_l2_norm", "squared_l2_norm", {"X": [f32(5, 7)]}, {}, {}, {}),
    ("clip", "clip", {"X": [f32(4, 5)]}, {"min": -0.5, "max": 0.3}, {}, {}),
    ("clip_by_norm_scales", "clip_by_norm", {"X": [f32(4, 5)]},
     {"max_norm": 1.0}, {}, {}),
    ("clip_by_norm_keeps", "clip_by_norm", {"X": [f32(4, 5) * 0.01]},
     {"max_norm": 1.0}, {}, {}),
    ("sign", "sign", {"X": [np.array([-2.5, 0.0, 3.0, -0.0], "float32")]},
     {}, {}, {}),
    ("elementwise_max", "elementwise_max",
     {"X": [f32(3, 4)], "Y": [f32(4)]}, {"axis": -1}, {}, {}),
    ("elementwise_min", "elementwise_min",
     {"X": [f32(1)], "Y": [f32(1)]}, {"axis": -1}, {}, {}),
    ("elementwise_pow", "elementwise_pow",
     {"X": [np.array([0.5, 2.0, 0.9], "float32")],
      "Y": [np.array([3.0, -0.5, 1.25], "float32")]}, {"axis": -1}, {}, {}),
    ("pow", "pow", {"X": [np.array([1.0, 4.0, 10.0], "float32")]},
     {"factor": -0.5}, {}, {}),
    ("floor", "floor", {"X": [f32(3, 4) * 3]}, {}, {}, {}),
    ("ceil", "ceil", {"X": [f32(3, 4) * 3]}, {}, {}, {}),
    ("exp", "exp", {"X": [f32(3, 4)]}, {}, {}, {}),
    ("cos", "cos", {"X": [f32(3, 4) * 3]}, {}, {}, {}),
    ("sqrt", "sqrt", {"X": [np.abs(f32(3, 4))]}, {}, {}, {}),
    ("reciprocal", "reciprocal", {"X": [np.abs(f32(3, 4)) + 0.5]}, {}, {},
     {}),
    ("increment_int", "increment", {"X": [np.array([7], "int32")]},
     {"step": 1.0}, {}, {}),
    ("increment_float", "increment", {"X": [np.array([0.5], "float32")]},
     {"step": 2.0}, {}, {}),
    ("piecewise_decay_first", "piecewise_decay",
     {"Step": [np.array([3.0], "float32")]},
     {"boundaries": [10.0, 20.0], "values": [1.0, 0.5, 0.1]}, {}, {}),
    ("piecewise_decay_on_boundary", "piecewise_decay",
     {"Step": [np.array([10.0], "float32")]},
     {"boundaries": [10.0, 20.0], "values": [1.0, 0.5, 0.1]}, {}, {}),
    ("piecewise_decay_last", "piecewise_decay",
     {"Step": [np.array([25.0], "float32")]},
     {"boundaries": [10.0, 20.0], "values": [1.0, 0.5, 0.1]}, {}, {}),
    # torch.sign maps NaN to 0; jnp.sign keeps it
    ("sign_nan_inf", "sign",
     {"X": [np.array([np.nan, -np.inf, np.inf, 0.0], "float32")]}, {}, {},
     {}),
    # an integer X: the mean promotes to float32, the sum keeps the type
    ("reduce_mean_int", "reduce_mean",
     {"X": [np.arange(6, dtype="int32").reshape(2, 3)]}, {"dim": [1]}, {},
     {}),
    ("mean_int", "mean", {"X": [np.arange(5, dtype="int32")]}, {}, {}, {}),
    # the stable form, at logits far past where exp overflows float32
    ("sigmoid_ce", "sigmoid_cross_entropy_with_logits",
     {"X": [np.concatenate([np.array([-200.0, -30.0, 0.0, 30.0, 200.0],
                                     "float32"), f32(7)]).reshape(3, 4)],
      "Label": [(R.rand(3, 4) > 0.5).astype("float32")]}, {}, {}, {}),
] + [
    # the recurrent slice's rest: beam search, CRF, control flow, arrays
    # and the sequence library, with ties, NaN, boundary and empty inputs
    ("beam_search", "beam_search",
     {"PreIds": [np.array([[3, 1, 4], [0, 2, 2]], "int64")],
      "PreScores": [np.array([[-0.5, -0.7, -1e9], [0.0, -1e9, -1e9]],
                             "float32")],
      "Scores": [np.log(R.dirichlet(np.ones(6), (2, 3))).astype("float32")]},
     {"beam_size": 3, "end_id": 1}, {}, {}),
    ("beam_search_ties", "beam_search",
     {"PreIds": [np.array([[2, 2, 2], [1, 1, 1]], "int64")],
      "PreScores": [np.zeros((2, 3), "float32")],
      "Scores": [np.full((2, 3, 4), -1.25, "float32")]},
     {"beam_size": 3, "end_id": 1}, {}, {}),
    ("beam_search_nan", "beam_search",
     {"PreIds": [np.array([[0, 3]], "int64")],
      "PreScores": [np.array([[0.0, -1.0]], "float32")],
      "Scores": [np.array([[[-1.0, np.nan, -2.0], [-0.5, -np.inf, -3.0]]],
                          "float32")]},
     {"beam_size": 2, "end_id": 1}, {}, {}),
    ("beam_search_k1", "beam_search",
     {"PreIds": [np.array([[1], [0]], "int64")],
      "PreScores": [np.array([[-2.0], [-1.0]], "float32")],
      "Scores": [np.log(R.dirichlet(np.ones(5), (2, 1))).astype("float32")]},
     {"beam_size": 1, "end_id": 1}, {}, {}),
    ("gather_tree", "gather_tree",
     {"Ids": [np.array([[[2, 3, 4], [5, 6, 7], [8, 9, 10]]], "int64")],
      "Parents": [np.array([[[0, 0, 0], [2, 0, 1], [1, 2, 0]]], "int64")]},
     {}, {}, {}),
    ("gather_tree_out_of_range_parent", "gather_tree",
     {"Ids": [np.arange(12, dtype="int64").reshape(1, 4, 3)],
      "Parents": [np.array([[[0, 1, 2], [5, -1, 0], [2, 2, 1],
                             [-4, 0, 1]]], "int64")]}, {}, {}, {}),
    ("gather_tree_t1", "gather_tree",
     {"Ids": [np.array([[[4, 5]], [[6, 7]]], "int64")],
      "Parents": [np.zeros((2, 1, 2), "int64")]}, {}, {}, {}),
    ("expand", "expand", {"X": [f32(2, 3)]}, {"expand_times": [1, 2]}, {},
     {}),
    ("expand_beam", "expand", {"X": [f32(2, 1, 3)]},
     {"expand_times": [1, 4, 1]}, {}, {}),
    ("expand_ids", "expand", {"X": [np.array([[5], [7]], "int64")]},
     {"expand_times": [1, 3]}, {}, {}),
    ("assign", "assign", {"X": [f32(2, 3)]}, {}, {}, {}),
    ("array_write", "array_write",
     {"Array": [np.zeros((3, 2, 4), "float32")], "X": [f32(2, 4)],
      "I": [np.array(1, "int64")]}, {}, {}, {}),
    ("array_write_past_the_end", "array_write",
     {"Array": [f32(3, 2)], "X": [f32(2)], "I": [np.array([5], "int64")]},
     {}, {}, {}),
    ("array_write_negative", "array_write",
     {"Array": [f32(3, 2)], "X": [f32(2)], "I": [np.array(-1, "int64")]},
     {}, {}, {}),
    ("array_read", "array_read",
     {"Array": [f32(3, 2, 4)], "I": [np.array(2, "int64")]}, {}, {}, {}),
    ("array_read_clamped", "array_read",
     {"Array": [f32(3, 2)], "I": [np.array([-7], "int64")]}, {}, {}, {}),
    ("array_length", "array_length", {"X": [f32(5, 2)]}, {}, {}, {}),
    ("less_equal", "less_equal",
     {"X": [np.array([1.0, 2.0, np.nan, 4.0], "float32")],
      "Y": [np.array([2.0, 2.0, 1.0, np.nan], "float32")]}, {}, {}, {}),
    ("greater_equal_broadcast", "greater_equal",
     {"X": [np.arange(6, dtype="int64").reshape(2, 3)],
      "Y": [np.array([2], "int64")]}, {}, {}, {}),
    ("not_equal", "not_equal",
     {"X": [np.array([1.0, np.nan, 0.0, -0.0], "float32")],
      "Y": [np.array([1.0, np.nan, -0.0, 1.0], "float32")]}, {}, {}, {}),
    ("logical_and", "logical_and",
     {"X": [np.array([True, True, False, False])],
      "Y": [np.array([True, False, True, False])]}, {}, {}, {}),
    ("logical_or_int", "logical_or",
     {"X": [np.array([0, 2, 0, -1], "int32")],
      "Y": [np.array([0, 0, 3, 1], "int32")]}, {}, {}, {}),
    ("logical_xor", "logical_xor",
     {"X": [np.array([[True], [False]])],
      "Y": [np.array([True, False, True])]}, {}, {}, {}),
    ("logical_not", "logical_not",
     {"X": [np.array([0.0, 1.5, np.nan], "float32")]}, {}, {}, {}),
    ("where", "where",
     {"Condition": [np.array([[True], [False]])], "X": [f32(2, 3)],
      "Y": [f32(2, 3)]}, {}, {}, {}),
    ("is_empty_no", "is_empty", {"X": [f32(2, 3)]}, {}, {}, {}),
    ("is_empty_yes", "is_empty", {"X": [np.zeros((0, 3), "float32")]}, {},
     {}, {}),
    ("dynamic_lstmp_peepholes", "dynamic_lstmp",
     {"Input": [f32(3, 4, 8)], "Weight": [f32(3, 8) * 0.5],
      "ProjWeight": [f32(2, 3) * 0.5], "Bias": [f32(14) * 0.5],
      "SeqLen": [np.array([4, 2, 0], "int32")]},
     {"use_peepholes": True, "is_reverse": False,
      "gate_activation": "sigmoid", "cell_activation": "tanh",
      "candidate_activation": "tanh", "proj_activation": "tanh"}, {}, {}),
    ("dynamic_lstmp_reverse_h0", "dynamic_lstmp",
     {"Input": [f32(2, 3, 8)], "Weight": [f32(3, 8) * 0.5],
      "ProjWeight": [f32(2, 3) * 0.5], "Bias": [f32(8) * 0.5],
      "SeqLen": [np.array([3, 1], "int32")], "H0": [f32(2, 2)],
      "C0": [f32(2, 2)]},
     {"use_peepholes": False, "is_reverse": True,
      "proj_activation": "identity"}, {}, {}),
    ("lstm_unit", "lstm_unit", {"X": [f32(3, 8)], "C_prev": [f32(3, 2)]},
     {"forget_bias": 1.0}, {}, {}),
    ("gru_unit", "gru_unit",
     {"Input": [f32(3, 6)], "HiddenPrev": [f32(3, 2)], "Weight": [f32(2, 6)],
      "Bias": [f32(6)]}, {}, {}, {}),
    ("gru_unit_no_bias", "gru_unit",
     {"Input": [f32(3, 6)], "HiddenPrev": [f32(3, 2)],
      "Weight": [f32(2, 6)]}, {}, {}, {}),
    ("linear_chain_crf", "linear_chain_crf",
     {"Emission": [f32(4, 5, 3)], "Transition": [f32(5, 3)],
      "Label": [R.randint(0, 3, (4, 5)).astype("int64")],
      "Length": [np.array([5, 3, 1, 0], "int64")]}, {}, {}, {}),
    # a length past T reads jax's fill for the last label; [B, T, 1]
    # labels; a label outside [0, D) past the length
    ("linear_chain_crf_edges", "linear_chain_crf",
     {"Emission": [f32(2, 3, 4)], "Transition": [f32(6, 4)],
      "Label": [np.array([[[1], [3], [0]], [[2], [9], [-1]]], "int64")],
      "Length": [np.array([[4], [1]], "int64")]}, {}, {}, {}),
    ("crf_decoding", "crf_decoding",
     {"Emission": [f32(3, 6, 4)], "Transition": [f32(6, 4)],
      "Length": [np.array([6, 4, 1], "int64")]}, {}, {}, {}),
    ("crf_decoding_ties", "crf_decoding",
     {"Emission": [np.zeros((2, 4, 3), "float32")],
      "Transition": [np.zeros((5, 3), "float32")],
      "Length": [np.array([4, 0], "int64")]}, {}, {}, {}),
    ("crf_decoding_label", "crf_decoding",
     {"Emission": [f32(2, 5, 3)], "Transition": [f32(5, 3)],
      "Length": [np.array([5, 2], "int64")],
      "Label": [R.randint(0, 3, (2, 5, 1)).astype("int64")]}, {}, {}, {}),
] + [
    # tests/test_sequence_labeling.py's chunk_eval cases, as parity cases
    (f"chunk_eval_{cid}", "chunk_eval",
     {"Inference": [np.asarray(inf, "int64")],
      "Label": [np.asarray(lab, "int64")],
      "Length": [np.asarray(ln, "int64")]},
     {"chunk_scheme": scheme, "num_chunk_types": nct,
      "excluded_chunk_types": ex}, {}, {})
    for cid, inf, lab, ln, scheme, nct, ex in (
        ("iob_exact", [[0, 1, 4, 2, 3, 3]], [[0, 1, 4, 2, 3, 3]], [6],
         "IOB", 2, []),
        ("iob_partial", [[0, 1, 4, 2, 4, 4]], [[0, 1, 4, 4, 2, 3]], [6],
         "IOB", 2, []),
        ("boundary_mismatch", [[0, 1, 1, 4]], [[0, 1, 4, 4]], [4], "IOB", 1,
         []),
        ("plain", [[0, 0, 1, 3, 2]], [[0, 0, 1, 3, 1]], [5], "plain", 3,
         []),
        ("iobes_single", [[3, 4, 0, 1, 2]], [[3, 4, 0, 1, 2]], [5],
         "IOBES", 1, []),
        ("excluded", [[0, 1, 4, 2, 3, 3]], [[0, 1, 4, 2, 3, 3]], [6], "IOB",
         2, [1]),
        ("length_masks_tail", [[0, 1, 0, 1, 0, 1]], [[0, 1, 0, 1, 0, 1]],
         [2], "IOB", 1, []),
        ("ioe_batch", [[0, 1, 2, 3, 4], [1, 1, 0, 4, 3]],
         [[0, 1, 2, 2, 3], [1, 0, 0, 4, 3]], [5, 4], "IOE", 2, []),
        ("empty", [[0, 1]], [[0, 1]], [0], "IOB", 1, []),
        ("negative_tags", [[-1, 0, 1, 7]], [[0, 0, 1, -3]], [4], "IOBES", 1,
         []))
] + [
    ("sequence_softmax", "sequence_softmax",
     {"X": [f32(3, 5)], "SeqLen": [np.array([5, 2, 0], "int32")]}, {}, {},
     {}),
    ("sequence_first_step", "sequence_first_step",
     {"X": [f32(2, 3, 4)], "SeqLen": [np.array([3, 1], "int32")]}, {}, {},
     {}),
    ("sequence_reverse", "sequence_reverse",
     {"X": [f32(3, 4, 2)], "SeqLen": [np.array([4, 2, 0], "int32")]}, {},
     {}, {}),
    ("sequence_expand", "sequence_expand",
     {"X": [f32(2, 3)], "Y": [f32(2, 4, 5)]}, {}, {}, {}),
    ("sequence_concat", "sequence_concat",
     {"X": [f32(2, 3, 2), f32(2, 3, 4)]}, {}, {}, {}),
    ("sequence_slice", "sequence_slice",
     {"X": [f32(3, 5, 2)], "Offset": [np.array([[0], [2], [4]], "int64")]},
     {"length": 2}, {}, {}),
    ("sequence_pad", "sequence_pad",
     {"X": [f32(2, 3, 2)], "SeqLen": [np.array([3, 1], "int32")]}, {}, {},
     {}),
    ("sequence_erase", "sequence_erase",
     {"X": [np.array([[2, 5, 7, 5], [1, 2, 0, 9]], "int64")]},
     {"tokens": [5, 2]}, {}, {}),
    ("sequence_reshape", "sequence_reshape",
     {"X": [f32(2, 3, 4)], "SeqLen": [np.array([3, 1], "int32")]},
     {"new_dim": 2}, {}, {}),
    ("edit_distance", "edit_distance",
     {"Hyps": [np.array([[1, 2, 3, 4], [5, 5, 0, 0], [7, 8, 9, 1]],
                        "int64")],
      "Refs": [np.array([[1, 3, 4], [5, 6, 5], [1, 1, 1]], "int64")],
      "HypsLen": [np.array([4, 2, 0], "int64")],
      "RefsLen": [np.array([3, 3, 2], "int64")]},
     {"normalized": False}, {}, {}),
    ("edit_distance_normalized", "edit_distance",
     {"Hyps": [np.array([[3, 1, 4, 1, 5]], "int64")],
      "Refs": [np.array([[3, 4, 1, 5, 9, 2]], "int64")],
      "HypsLen": [np.array([5], "int64")],
      "RefsLen": [np.array([6], "int64")]},
     {"normalized": True}, {}, {}),
    ("sequence_conv", "sequence_conv",
     {"X": [f32(2, 5, 3)], "Filter": [f32(9, 4)],
      "SeqLen": [np.array([5, 2], "int32")]},
     {"contextLength": 3, "contextStart": -1, "contextStride": 1}, {}, {}),
    ("sequence_conv_ahead", "sequence_conv",
     {"X": [f32(2, 4, 2)], "Filter": [f32(4, 3)],
      "SeqLen": [np.array([4, 3], "int32")]},
     {"contextLength": 2, "contextStart": 0, "contextStride": 1}, {}, {}),
    ("row_conv", "row_conv", {"X": [f32(2, 5, 3)], "Filter": [f32(3, 3)]},
     {}, {}, {}),
] + [
    # dim [] with reduce_all off is axis=(): nothing is reduced
    (f"{t}_empty_dim_{dt}", t,
     {"X": [(np.arange(6).reshape(2, 3) + 1).astype(dt)]},
     {"dim": [], "keep_dim": False, "reduce_all": False}, {}, {})
    for t in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
              "reduce_prod")
    for dt in ("float32", "int32")
]


def u01(*shape, lo=0.05, hi=0.95):
    return R.uniform(lo, hi, shape).astype("float32")


def i64(*vals, shape=None):
    a = np.asarray(vals, "int64")
    return a.reshape(shape) if shape else a


# the rest of the op library: activations, tensor, reduce, loss, image,
# metric and fake-quantize ops, with ties, out-of-range indices, negative
# divisors and empty-ish edges beside random draws
_ACT_X = np.concatenate([f32(3, 7) * 3, np.float32(
    [[0.5, 1.5, 2.5, -0.5, -1.5, 0.0, 30.0]])], 0)
_INT_X = np.int32([[0, 1, -1, 7, -7, 3]])
CASES += [
    (f"act_{t}", t, {"X": [_ACT_X]}, {}, {}, {})
    for t in ("abs", "sin", "log", "square", "round", "rsqrt", "relu6",
              "softplus", "softsign", "gelu", "silu", "logsigmoid",
              "tanh_shrink", "leaky_relu", "elu", "hard_sigmoid",
              "hard_shrink", "soft_shrink", "thresholded_relu", "swish",
              "brelu")
] + [
    # an integer X computes in float32, as jax promotes it
    (f"int_x_{t}", t, {"X": [_INT_X]}, attrs, {}, {})
    for t, attrs in (("softmax", {}), ("log_softmax", {"axis": -1}),
                     ("gelu", {}), ("softplus", {}), ("logsigmoid", {}))
] + [
    ("int_x_layer_norm", "layer_norm", {"X": [_INT_X]},
     {"begin_norm_axis": 1, "epsilon": 1e-5}, {}, {}),
    ("elu_alpha", "elu", {"X": [_ACT_X]}, {"alpha": 0.7}, {}, {}),
    ("leaky_relu_alpha", "leaky_relu", {"X": [_ACT_X]}, {"alpha": 0.3},
     {}, {}),
    ("swish_beta", "swish", {"X": [_ACT_X]}, {"beta": 1.5}, {}, {}),
    ("brelu_range", "brelu", {"X": [_ACT_X]}, {"t_min": -0.5, "t_max": 0.8},
     {}, {}),
    ("soft_shrink_lambda", "soft_shrink", {"X": [_ACT_X]}, {"lambda": 1.2},
     {}, {}),
    ("prelu_all", "prelu", {"X": [f32(2, 3, 4)], "Alpha": [f32(1)]},
     {"mode": "all"}, {}, {}),
    ("prelu_channel", "prelu", {"X": [f32(2, 3, 4, 4)], "Alpha": [f32(3)]},
     {"mode": "channel"}, {}, {}),
    ("prelu_element", "prelu", {"X": [f32(2, 3, 4)], "Alpha": [f32(3, 4)]},
     {"mode": "element"}, {}, {}),
    ("maxout", "maxout", {"X": [f32(2, 4, 3, 3)]}, {"groups": 2}, {}, {}),
    ("mod_negative_f32", "elementwise_mod",
     {"X": [np.float32([[-7.5, 7.5, -3.0, 3.0, 0.0, 5.0]])],
      "Y": [np.float32([[2.0, -2.0, -2.0, 2.0, -3.0, 2.5]])]}, {}, {}, {}),
    ("mod_negative_int", "elementwise_mod",
     {"X": [np.int32([[-7, 7, -3, 3, 0, 6]])],
      "Y": [np.int32([[2, -2, -2, 2, -3, 3]])]}, {}, {}, {}),
    ("floordiv_f32", "elementwise_floordiv",
     {"X": [np.float32([[-7.5, 7.5, -3.0, 3.0, 1.0]])],
      "Y": [np.float32([[2.0, -2.0, -2.0, 2.0, 3.0]])]}, {}, {}, {}),
    ("floordiv_int", "elementwise_floordiv",
     {"X": [np.int32([[-7, 7, -3, 3, 1]])],
      "Y": [np.int32([[2, -2, -2, 2, 3]])]}, {}, {}, {}),
    # a zero divisor gives XLA's results, computed on the device: float32
    # floordiv NaN, int32 floordiv -1 adjusted towards -inf, int32 mod 0
    ("floordiv_by_zero_f32", "elementwise_floordiv",
     {"X": [np.float32([5, -5, 0])], "Y": [np.float32([0, 0, 0])]},
     {}, {}, {}),
    ("floordiv_by_zero_int", "elementwise_floordiv",
     {"X": [np.int32([5, -5, 0])], "Y": [np.int32([0, 0, 0])]}, {}, {}, {}),
    ("mod_by_zero_f32", "elementwise_mod",
     {"X": [np.float32([5, -5, 0])], "Y": [np.float32([0, 0, 0])]},
     {}, {}, {}),
    ("mod_by_zero_int", "elementwise_mod",
     {"X": [np.int32([5, -5, 0])], "Y": [np.int32([0, 0, 0])]}, {}, {}, {}),
    ("floordiv_int_min_by_minus_one", "elementwise_floordiv",
     {"X": [np.int32([-2 ** 31, 7, -7])], "Y": [np.int32([-1, -1, -1])]},
     {}, {}, {}),
    ("mod_int_min_by_minus_one", "elementwise_mod",
     {"X": [np.int32([-2 ** 31, 7, -7])], "Y": [np.int32([-1, -1, -1])]},
     {}, {}, {}),
    ("isfinite_all", "isfinite", {"X": [f32(3, 2), f32(4)]}, {}, {}, {}),
    ("isfinite_inf", "isfinite",
     {"X": [f32(3, 2), np.float32([1.0, np.inf])]}, {}, {}, {}),
    ("isfinite_nan", "isfinite", {"X": [np.float32([np.nan, 0.0])]}, {},
     {}, {}),
    ("split_num", "split", {"X": [f32(2, 6, 3)]}, {"num": 3, "axis": 1},
     {}, {}),
    ("split_sections", "split", {"X": [f32(2, 6, 3)]},
     {"num": 0, "sections": [2, 1, 3], "axis": 1}, {}, {}),
    ("split_sections_short", "split", {"X": [f32(6, 2)]},
     {"num": 0, "sections": [2, 3], "axis": 0}, {}, {}),
    ("scatter_set_out_of_range", "scatter",
     {"X": [f32(5, 3)], "Ids": [i64(3, -1, 0, 7)], "Updates": [f32(4, 3)]},
     {"overwrite": True}, {}, {}),
    ("scatter_add_repeats", "scatter",
     {"X": [f32(5, 3)], "Ids": [i64(1, 1, -5, 9)], "Updates": [f32(4, 3)]},
     {"overwrite": False}, {}, {}),
    ("stack_axis1", "stack", {"X": [f32(2, 3), f32(2, 3), f32(2, 3)]},
     {"axis": 1}, {}, {}),
    ("unstack_axis1", "unstack", {"X": [f32(2, 3, 4)]}, {"axis": 1}, {},
     {}),
    ("flatten_axis2", "flatten", {"X": [f32(2, 3, 4, 5)]}, {"axis": 2}, {},
     {}),
    ("flatten_axis0", "flatten", {"X": [f32(2, 3, 4)]}, {"axis": 0}, {},
     {}),
    ("expand_as", "expand_as", {"X": [f32(1, 3)], "Y": [f32(4, 3)]}, {},
     {}, {}),
    ("pad", "pad", {"X": [f32(2, 3)]},
     {"paddings": [1, 0, 0, 2], "pad_value": 0.5}, {}, {}),
    ("pad_constant_like", "pad_constant_like",
     {"X": [f32(4, 5)], "Y": [f32(2, 3)]}, {"pad_value": -1.0}, {}, {}),
    ("fill_zeros_like", "fill_zeros_like", {"X": [f32(2, 3)]}, {}, {}, {}),
    ("shape", "shape", {"Input": [f32(2, 3, 4)]}, {}, {}, {}),
    ("reverse", "reverse", {"X": [f32(2, 3, 4)]}, {"axis": [0, 2]}, {},
     {}),
    ("multiplex", "multiplex",
     {"X": [f32(4, 2), f32(4, 2), f32(4, 2)],
      "Ids": [np.int32([[2], [0], [-1], [5]])]}, {}, {}, {}),
    ("crop", "crop", {"X": [f32(4, 5)]},
     {"offsets": [1, 0], "shape": [2, 3]}, {}, {}),
    ("label_smooth", "label_smooth", {"X": [u01(3, 4)]}, {"epsilon": 0.1},
     {}, {}),
    ("label_smooth_prior", "label_smooth",
     {"X": [u01(3, 4)], "PriorDist": [u01(1, 4)]}, {"epsilon": 0.2}, {},
     {}),
    ("print", "print", {"In": [f32(2, 2)]}, {"message": "x"}, {}, {}),
    ("arange_int", "arange", {},
     {"start": 2, "end": 11, "step": 3, "dtype": "int64"}, {}, {}),
    ("arange_float", "arange", {},
     {"start": 0.5, "end": 3.0, "step": 0.5, "dtype": "float32"}, {}, {}),
    ("cumsum", "cumsum", {"X": [f32(3, 4)]}, {"axis": 1}, {}, {}),
    ("cumsum_exclusive_reverse", "cumsum", {"X": [f32(3, 4)]},
     {"axis": 0, "exclusive": True, "reverse": True}, {}, {}),
    ("cumsum_int", "cumsum", {"X": [np.int32([[1, 2, 3], [4, 5, 6]])]},
     {"axis": -1, "exclusive": True}, {}, {}),
    ("arg_min_ties", "arg_min",
     {"X": [np.float32([[1, 0, 0, 2], [3, 3, 3, 3], [5, -1, 4, -1]])]},
     {"axis": 1}, {}, {}),
    ("argsort_ties", "argsort",
     {"X": [np.float32([[2, 1, 2, 1, 0, 1], [0, 0, 0, 0, 0, 0]])]},
     {"axis": -1}, {}, {}),
    ("argsort_axis0", "argsort",
     {"X": [np.float32([[2, 1], [1, 1], [2, 0]])]}, {"axis": 0}, {}, {}),
    ("cos_sim_rows", "cos_sim", {"X": [f32(4, 5)], "Y": [f32(4, 5)]}, {},
     {}, {}),
    ("cos_sim_one_row", "cos_sim", {"X": [f32(4, 5)], "Y": [f32(1, 5)]},
     {}, {}, {}),
    ("squared_l2_distance", "squared_l2_distance",
     {"X": [f32(4, 5)], "Y": [f32(4, 5)]}, {}, {}, {}),
    ("norm", "norm", {"X": [f32(3, 4, 2)]}, {"axis": 1}, {}, {}),
    ("fake_quantize_abs_max", "fake_quantize_abs_max", {"X": [f32(4, 5)]},
     {"bit_length": 8}, {}, {}),
    ("fake_quantize_abs_max_4bit", "fake_quantize_abs_max",
     {"X": [f32(4, 5)]}, {"bit_length": 4}, {}, {}),
    ("fake_dequantize_max_abs", "fake_dequantize_max_abs",
     {"X": [np.float32([-127, -3, 0, 5, 127])],
      "Scale": [np.float32([0.25])]}, {"bit_length": 8}, {}, {}),
    ("fake_quantize_moving_average", "fake_quantize_moving_average_abs_max",
     {"X": [f32(4, 5)], "InScale": [np.float32([1.5])]},
     {"bit_length": 8, "moving_rate": 0.9}, {}, {}),
    ("cross_entropy_hard", "cross_entropy",
     {"X": [u01(5, 4)], "Label": [i64(0, 3, -100, 7, -1, shape=(5, 1))]},
     {"soft_label": False, "ignore_index": -100}, {}, {}),
    ("cross_entropy_soft", "cross_entropy",
     {"X": [u01(5, 4)], "Label": [u01(5, 4)]}, {"soft_label": True}, {},
     {}),
    ("lrn", "lrn", {"X": [f32(2, 6, 3, 3)]},
     {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75}, {}, {}),
    ("lrn_n3", "lrn", {"X": [f32(1, 2, 2, 3)]},
     {"n": 3, "k": 1.0, "alpha": 0.5, "beta": 0.5}, {}, {}),
    ("l2_normalize", "l2_normalize", {"X": [f32(3, 4)]},
     {"axis": 1, "epsilon": 1e-12}, {}, {}),
    ("huber_loss", "huber_loss", {"X": [f32(5, 1)], "Y": [f32(5, 1)]},
     {"delta": 0.8}, {}, {}),
    ("smooth_l1_loss", "smooth_l1_loss",
     {"X": [f32(3, 4)], "Y": [f32(3, 4)], "InsideWeight": [u01(3, 4)],
      "OutsideWeight": [u01(3, 4)]}, {"sigma": 2.0}, {}, {}),
    ("smooth_l1_loss_plain", "smooth_l1_loss",
     {"X": [f32(3, 2, 2)], "Y": [f32(3, 2, 2)]}, {}, {}, {}),
    ("log_loss", "log_loss", {"Predicted": [u01(4, 1)],
                              "Labels": [np.float32([[0], [1], [1], [0]])]},
     {"epsilon": 1e-4}, {}, {}),
    ("hinge_loss", "hinge_loss",
     {"Logits": [f32(4, 1)], "Labels": [np.float32([[0], [1], [1], [0]])]},
     {}, {}, {}),
    ("rank_loss", "rank_loss",
     {"Label": [np.float32([[0], [1], [1]])], "Left": [f32(3, 1)],
      "Right": [f32(3, 1)]}, {}, {}, {}),
    ("margin_rank_loss", "margin_rank_loss",
     {"Label": [np.float32([[1], [-1], [1]])], "X1": [f32(3, 1)],
      "X2": [f32(3, 1)]}, {"margin": 0.1}, {}, {}),
    ("mse_loss", "mse_loss", {"X": [f32(3, 2)], "Y": [f32(3, 2)]}, {}, {},
     {}),
    ("bilinear_tensor_product", "bilinear_tensor_product",
     {"X": [f32(3, 4)], "Y": [f32(3, 5)], "Weight": [f32(2, 4, 5)],
      "Bias": [f32(1, 2)]}, {}, {}, {}),
    ("bilinear_interp_up", "bilinear_interp", {"X": [f32(1, 2, 3, 4)]},
     {"out_h": 5, "out_w": 7}, {}, {}),
    ("bilinear_interp_down", "bilinear_interp", {"X": [f32(1, 2, 8, 9)]},
     {"out_h": 3, "out_w": 4}, {}, {}),
    ("bilinear_interp_same", "bilinear_interp", {"X": [f32(2, 1, 3, 3)]},
     {"out_h": 3, "out_w": 3}, {}, {}),
    ("im2sequence", "im2sequence", {"X": [f32(2, 3, 5, 6)]},
     {"kernels": [2, 3], "strides": [1, 2]}, {}, {}),
    ("grid_sampler", "grid_sampler",
     {"X": [f32(2, 3, 4, 5)],
      "Grid": [R.uniform(-1.2, 1.2, (2, 3, 3, 2)).astype("float32")]},
     {}, {}, {}),
    ("spp_max", "spp", {"X": [f32(2, 3, 5, 7)]},
     {"pyramid_height": 3, "pooling_type": "max"}, {}, {}),
    ("spp_avg_small_extent", "spp", {"X": [f32(1, 2, 3, 2)]},
     {"pyramid_height": 3, "pooling_type": "avg"}, {}, {}),
    ("hierarchical_sigmoid", "hierarchical_sigmoid",
     {"X": [f32(4, 5)], "Label": [i64(0, 5, 2, 3, shape=(4, 1))],
      "W": [f32(5, 5)], "Bias": [f32(5, 1)]}, {"num_classes": 6}, {}, {}),
    ("hierarchical_sigmoid_no_bias", "hierarchical_sigmoid",
     {"X": [f32(3, 4)], "Label": [i64(0, 7, 4, shape=(3, 1))],
      "W": [f32(7, 4)]}, {"num_classes": 8}, {}, {}),
    ("auc", "auc",
     {"Predict": [np.concatenate([1 - (p := u01(6, 1, lo=0, hi=1)), p], 1)],
      "Label": [i64(1, 0, 1, 1, 0, 0, shape=(6, 1))],
      "StatPos": [np.zeros(201, "float32")],
      "StatNeg": [np.zeros(201, "float32")]}, {"num_thresholds": 200}, {},
     {}),
    ("auc_accumulated", "auc",
     {"Predict": [np.float32([[0.3, 0.7], [0.9, 0.1], [0.0, 1.0]])],
      "Label": [i64(1, 0, 0, shape=(3, 1))],
      "StatPos": [np.float32(R.randint(0, 3, 11))],
      "StatNeg": [np.float32(R.randint(0, 3, 11))]},
     {"num_thresholds": 10}, {}, {}),
    ("precision_recall", "precision_recall",
     {"MaxProbs": [u01(6, 1)], "Indices": [i64(0, 1, 2, 3, 1, 1,
                                                shape=(6, 1))],
      "Labels": [i64(0, 2, 2, 3, 1, 0, shape=(6, 1))]},
     {"class_number": 4}, {}, {}),
    ("precision_recall_states", "precision_recall",
     {"MaxProbs": [u01(4, 1)], "Indices": [i64(0, 1, 1, 2, shape=(4, 1))],
      "Labels": [i64(0, 1, 2, 2, shape=(4, 1))],
      "StatesInfo": [np.float32(R.randint(0, 4, (3, 4)))]},
     {"class_number": 3}, {}, {}),
    ("mean_iou", "mean_iou",
     {"Predictions": [np.int32([0, 1, 2, 2, 1, 0, 2, 1])],
      "Labels": [np.int32([0, 1, 1, 2, 1, 2, 2, 0])]}, {"num_classes": 4},
     {}, {}),
]


def _to_jax(a, dtype):
    return jnp.asarray(a, dtype=getattr(jnp, dtype)) if dtype \
        else jnp.asarray(a)


def _to_torch(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(getattr(torch, dtype)) if dtype else t


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax_lowering(case):
    _, op_type, ins, attrs, rounded, in_dtypes = case
    jins = {s: [_to_jax(a, in_dtypes.get(s)) for a in v]
            for s, v in ins.items()}
    tins = {s: [_to_torch(a, in_dtypes.get(s)) for a in v]
            for s, v in ins.items()}
    jout = jreg.lookup_op(op_type).lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)), jins, dict(attrs))
    tout = treg.lookup_op(op_type).lower(treg.LowerCtx(), tins, dict(attrs))
    assert set(tout) == set(jout)
    for slot, jvals in jout.items():
        for jv, tv in zip(jvals, tout[slot]):
            # same dtype, but for jax's 32-bit ints (x64 mode is off)
            jdt, tdt = str(jv.dtype), str(tv.dtype).replace("torch.", "")
            assert tdt == jdt or (jdt, tdt) == ("int32", "int64"), (jdt, tdt)
            assert (tdt == "bfloat16") == (slot in rounded)
            jv = np.asarray(jv.astype(jnp.float32) if jv.dtype == jnp.bfloat16
                            else jv)
            tv = as_numpy(tv)
            assert tv.shape == jv.shape, (slot, tv.shape, jv.shape)
            if tv.dtype.kind in "biu":
                np.testing.assert_array_equal(tv, jv, err_msg=slot)
            elif slot in rounded:
                np.testing.assert_allclose(tv, jv, rtol=2e-2, atol=2e-2,
                                           equal_nan=True, err_msg=slot)
            else:
                np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5,
                                           equal_nan=True, err_msg=slot)


@pytest.mark.parametrize("op_type,attrs", [
    ("uniform_random", {"shape": [200, 50], "min": -0.5, "max": 0.25,
                        "seed": 0, "dtype": "float32"}),
    ("gaussian_random", {"shape": [200, 50], "mean": 0.3, "std": 0.02,
                         "seed": 0, "dtype": "float32"}),
])
def test_random_op_matches_jax_in_distribution(op_type, attrs):
    """Same shape, dtype, support and first two moments (10000 draws:
    the moment tolerances are several standard errors wide)."""
    jv = np.asarray(jreg.lookup_op(op_type).lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(3)), {}, dict(attrs))
        ["Out"][0])
    tv = as_numpy(treg.lookup_op(op_type).lower(
        treg.LowerCtx(seed=3), {}, dict(attrs))["Out"][0])
    assert tv.shape == jv.shape and tv.dtype == jv.dtype
    if op_type == "uniform_random":
        assert tv.min() >= attrs["min"] and tv.max() < attrs["max"]
        spread = attrs["max"] - attrs["min"]
    else:
        spread = attrs["std"]
    np.testing.assert_allclose(tv.mean(), jv.mean(), atol=0.05 * spread)
    np.testing.assert_allclose(tv.std(), jv.std(), rtol=0.05)


def test_cache_write_in_place_on_its_own_variable():
    """The tick's cache_write rebinds the cache variable it reads: the port
    writes the rows into that tensor (no copy); a write to a fresh output
    variable leaves the input untouched."""
    from paddle_tpu_torch.framework.program import Program
    from paddle_tpu_torch.framework.registry import LowerCtx
    ins, attrs = _per_slot_cache_case()
    block = Program().global_block()
    for name, aliased in (("inplace", True), ("fresh", False)):
        cache = torch.from_numpy(ins["Cache"][0].copy())
        before = cache.clone()
        op = block.append_op(
            "cache_write", inputs={"Cache": ["c"], "New": ["n"], "Pos": ["p"]},
            outputs={"Out": ["c" if aliased else "o"]}, attrs=attrs)
        ctx = LowerCtx(op=op)
        out = treg.lookup_op("cache_write").lower(
            ctx, {"Cache": [cache], "New": [torch.from_numpy(ins["New"][0])],
                  "Pos": [torch.from_numpy(ins["Pos"][0])]}, attrs)["Out"][0]
        assert (out is cache) == aliased, name
        if not aliased:
            assert torch.equal(cache, before)


def test_cache_write_out_of_range_raises():
    """jax's dynamic_update_slice would clamp this write into the last
    row; the port refuses it."""
    ins, attrs = _per_slot_cache_case()
    ins["Pos"] = [np.array([0, 3, 8, 5], "float32").reshape(4, 1, 1)]
    with pytest.raises(RuntimeError, match="outside"):
        treg.lookup_op("cache_write").lower(
            treg.LowerCtx(), {s: [torch.from_numpy(a) for a in v]
                              for s, v in ins.items()}, attrs)


@pytest.mark.parametrize("op_type,ins,attrs", [
    ("gather", {"X": f32(6, 2), "Index": np.array([7, -1, -7, 1], "int32")},
     {}),
    ("lookup_table",
     {"W": f32(10, 3), "Ids": np.array([[12], [-1], [3], [3]], "int64")},
     {"padding_idx": None}),
    ("sequence_last_step",
     {"X": f32(3, 4, 2), "SeqLen": np.array([4, 9, 2], "int64")}, {}),
])
def test_out_of_range_rows_match_jax_gradient(op_type, ins, attrs):
    """d(sum of the finite outputs)/d(table) through the port against
    jax.grad through the JAX lowering: a filled row passes no gradient, a
    wrapped index passes it to the row it wraps to, a repeated index adds
    up."""
    src = next(iter(ins))
    rest = {s: a for s, a in ins.items() if s != src}

    def jloss(table):
        out = jreg.lookup_op(op_type).lower(
            jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
            {src: [table], **{s: [jnp.asarray(a)] for s, a in rest.items()}},
            dict(attrs))["Out"][0]
        return jnp.sum(jnp.where(jnp.isnan(out), 0.0, out) * 1.5)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(ins[src])))
    table = torch.from_numpy(ins[src].copy()).requires_grad_()
    out = treg.lookup_op(op_type).lower(
        treg.LowerCtx(), {src: [table], **{s: [torch.from_numpy(a)]
                                          for s, a in rest.items()}},
        dict(attrs))["Out"][0]
    assert bool(out.isnan().any())
    (torch.where(out.isnan(), 0.0, out) * 1.5).sum().backward()
    np.testing.assert_allclose(as_numpy(table.grad), jg, rtol=1e-6, atol=0)


@pytest.mark.parametrize("logits_dtype,ignore", [
    ("float32", -100), ("float32", 2), ("bfloat16", -100)])
def test_softmax_with_cross_entropy_gradient_matches_jax(logits_dtype,
                                                         ignore):
    """d(sum(loss * w))/d(logits) through the port's closed-form backward
    against jax.grad through the JAX package's `_ce_hard` custom vjp.
    Labels equal to ignore_index give zero loss and zero gradient. float32
    at 1e-6; bfloat16 logits at one bfloat16 step (the gradient is rounded
    to the logits' dtype)."""
    logits = f32(2, 5, 11)
    label = np.array([[0, 2, 10, 2, 7], [2, 1, 1, 9, 3]], "int64")[..., None]
    w = f32(2, 5, 1)
    attrs = {"soft_label": False, "ignore_index": ignore}

    def jloss(lg):
        out = jreg.lookup_op("softmax_with_cross_entropy").lower(
            jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
            {"Logits": [lg], "Label": [jnp.asarray(label)]}, dict(attrs))
        return jnp.sum(out["Loss"][0] * jnp.asarray(w))

    jg = jax.grad(jloss)(_to_jax(logits, logits_dtype))
    tl = _to_torch(logits, logits_dtype).requires_grad_()
    out = treg.lookup_op("softmax_with_cross_entropy").lower(
        treg.LowerCtx(), {"Logits": [tl], "Label": [torch.from_numpy(label)]},
        dict(attrs))
    (out["Loss"][0] * torch.from_numpy(w)).sum().backward()
    tg = as_numpy(tl.grad)
    jg = np.asarray(jg.astype(jnp.float32))
    assert str(tl.grad.dtype) == f"torch.{logits_dtype}"
    if ignore != -100:
        assert (tg[label[..., 0] == ignore] == 0).all()
    if logits_dtype == "float32":
        np.testing.assert_allclose(tg, jg, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(tg, jg, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("logits_dtype", ["float32", "bfloat16"])
def test_ce_out_of_range_labels_gradient_matches_jax(logits_dtype):
    """d(sum(loss * w))/d(logits) with labels outside [0, V) against
    jax.grad through the JAX package's `_ce_hard`: a label in [-V, 0)
    wraps in the loss but no one-hot is subtracted in the gradient, any
    other out-of-range label gives a NaN loss and the row's gradient is
    softmax * w; ignore_index rows give 0. float32 at 1e-6, bfloat16 at one
    bfloat16 step."""
    logits = f32(2, 4, 7)
    label = np.array([[7, -1, 3, -100], [-7, -8, 0, 12]], "int64")[..., None]
    w = f32(2, 4, 1)
    attrs = {"soft_label": False, "ignore_index": -100}

    def jloss(lg):
        out = jreg.lookup_op("softmax_with_cross_entropy").lower(
            jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
            {"Logits": [lg], "Label": [jnp.asarray(label)]}, dict(attrs))
        return jnp.sum(out["Loss"][0] * jnp.asarray(w))

    jg = np.asarray(jax.grad(jloss)(_to_jax(logits, logits_dtype))
                    .astype(jnp.float32))
    tl = _to_torch(logits, logits_dtype).requires_grad_()
    out = treg.lookup_op("softmax_with_cross_entropy").lower(
        treg.LowerCtx(), {"Logits": [tl], "Label": [torch.from_numpy(label)]},
        dict(attrs))
    loss = out["Loss"][0]
    nan_rows = [(0, 0), (1, 1), (1, 3)]
    assert all(bool(loss[r].isnan().all()) for r in nan_rows)
    assert not bool(loss[0, 1].isnan())
    (loss * torch.from_numpy(w)).sum().backward()
    tg = as_numpy(tl.grad)
    assert np.isfinite(tg).all() and (tg[0, 3] == 0).all()
    if logits_dtype == "float32":
        np.testing.assert_allclose(tg, jg, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(tg, jg, rtol=2 ** -7, atol=1e-6)


def test_optimizer_ops_update_in_place_on_their_own_variables():
    """An optimizer op whose outputs name its inputs (what the optimizers
    append) updates those tensors in place; the values equal the
    out-of-place update."""
    from paddle_tpu_torch.framework.program import Program
    from paddle_tpu_torch.framework.registry import LowerCtx
    ins = {"Param": [f32(4, 3)], "Grad": [f32(4, 3)], "Moment1": [f32(4, 3)],
           "Moment2": [np.abs(f32(4, 3))],
           "Beta1Pow": [np.array([0.81], "float32")],
           "Beta2Pow": [np.array([0.998], "float32")],
           "LearningRate": [np.array([1e-3], "float32")]}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    slots = ("Param", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow")
    names = {s: s.lower() for s in ins}
    block = Program().global_block()
    op = block.append_op(
        "adam", inputs={s: [names[s]] for s in ins},
        outputs={s + "Out": [names[s]] for s in slots}, attrs=attrs)
    tins = {s: [torch.from_numpy(v[0].copy())] for s, v in ins.items()}
    fresh = treg.lookup_op("adam").lower(
        LowerCtx(), {s: [t[0].clone()] for s, t in tins.items()}, attrs)
    out = treg.lookup_op("adam").lower(LowerCtx(op=op), tins, attrs)
    for s in slots:
        assert out[s + "Out"][0] is tins[s][0], s
        assert torch.equal(out[s + "Out"][0], fresh[s + "Out"][0]), s


def test_squeeze_of_a_wide_axis_raises_as_jax():
    """jnp.squeeze refuses an axis whose size is not 1; so does the port
    (torch's squeeze would keep that dim and give [3, 4] where the layer
    declared [4])."""
    x = f32(3, 1, 4)
    attrs = {"axes": [0, 1]}
    with pytest.raises(ValueError):
        jreg.lookup_op("squeeze").lower(
            jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
            {"X": [jnp.asarray(x)]}, attrs)
    with pytest.raises(InvalidArgumentError, match="squeeze"):
        treg.lookup_op("squeeze").lower(
            treg.LowerCtx(), {"X": [torch.from_numpy(x)]}, attrs)


def test_piecewise_decay_builds_its_tables_once_per_plan():
    """The boundaries and values go to the device once per plan, through
    LowerCtx.constant (a torch.tensor from a list waits for the stream on
    a card, each run): two runs of one op with the plan's memo see the same
    tensors, and the same value as the JAX lowering."""
    from paddle_tpu_torch.framework.program import Program
    block = Program().global_block()
    attrs = {"boundaries": [10.0, 20.0], "values": [1.0, 0.5, 0.1]}
    op = block.append_op("piecewise_decay", inputs={"Step": ["step"]},
                         outputs={"Out": ["lr"]}, attrs=attrs)
    memo = {}
    made = []
    real = torch.tensor

    def counting_tensor(*a, **k):
        made.append(a)
        return real(*a, **k)

    outs = []
    torch.tensor = counting_tensor
    try:
        for step in (3.0, 15.0, 25.0):
            ctx = treg.LowerCtx(op=op, constants=memo)
            outs.append(float(treg.lookup_op("piecewise_decay").lower(
                ctx, {"Step": [real([step])]}, attrs)["Out"][0]))
    finally:
        torch.tensor = real
    assert len(made) == 2, made
    np.testing.assert_array_equal(outs, np.float32([1.0, 0.5, 0.1]))


def test_pool_window_wider_than_the_padded_input_raises():
    """A deliberate difference: the JAX package's reduce_window returns an
    empty [1, 1, 0, 0] here; the port raises naming the shapes."""
    x = torch.zeros(1, 1, 2, 2)
    with pytest.raises(InvalidArgumentError,
                       match=r"window \[3, 3\] is larger than the padded "
                             r"input \[2, 2\]"):
        treg.lookup_op("pool2d").lower(
            treg.LowerCtx(), {"X": [x]},
            {"ksize": [3, 3], "strides": [1, 1], "paddings": [0, 0],
             "pooling_type": "max"})


@pytest.mark.parametrize("op_type,ins,attrs", [
    ("truncated_gaussian_random", {},
     {"shape": [200, 50], "mean": 0.3, "std": 0.02, "seed": 0,
      "dtype": "float32"}),
    ("uniform_random_batch_size_like", {"Input": f32(7, 3)},
     {"shape": [-1, 2000], "min": -0.5, "max": 0.25, "dtype": "float32"}),
    ("gaussian_random_batch_size_like", {"Input": f32(3, 7)},
     {"shape": [4000, -1], "mean": 0.3, "std": 0.02, "input_dim_idx": 1,
      "output_dim_idx": 1, "dtype": "float32"}),
])
def test_rest_of_random_ops_match_jax_in_distribution(op_type, ins, attrs):
    """Shape, dtype, support and the first two moments against the JAX
    lowering's draws (threefry and Philox give different numbers); the
    truncated normal stays within two standard deviations, and its spread
    is the truncated one (0.88 std), as jax.random.truncated_normal's."""
    jv = np.asarray(jreg.lookup_op(op_type).lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(3)),
        {s: [jnp.asarray(a)] for s, a in ins.items()}, dict(attrs))
        ["Out"][0])
    tv = as_numpy(treg.lookup_op(op_type).lower(
        treg.LowerCtx(seed=3), {s: [torch.from_numpy(a)]
                                for s, a in ins.items()},
        dict(attrs))["Out"][0])
    assert tv.shape == jv.shape and tv.dtype == jv.dtype
    if "min" in attrs:
        assert tv.min() >= attrs["min"] and tv.max() < attrs["max"]
        spread = attrs["max"] - attrs["min"]
    else:
        spread = attrs["std"]
    if op_type == "truncated_gaussian_random":
        lo, hi = attrs["mean"] - 2 * spread, attrs["mean"] + 2 * spread
        assert tv.min() >= lo - 1e-6 and tv.max() <= hi + 1e-6
        np.testing.assert_allclose(tv.std(), 0.8796 * spread, rtol=0.05)
    np.testing.assert_allclose(tv.mean(), jv.mean(), atol=0.05 * spread)
    np.testing.assert_allclose(tv.std(), jv.std(), rtol=0.05)


def test_sampling_id_draws_by_probability():
    """Each row's class is drawn with the row's probability (4000 rows of
    one distribution; a zero-probability class never comes), int64 [N]."""
    p = np.float32([0.1, 0.0, 0.6, 0.3])
    x = torch.from_numpy(np.tile(p, (4000, 1)))
    out = treg.lookup_op("sampling_id").lower(
        treg.LowerCtx(seed=5), {"X": [x]}, {})["Out"][0]
    assert out.dtype == torch.int64 and out.shape == (4000,)
    freq = np.bincount(as_numpy(out), minlength=4) / 4000
    assert freq[1] == 0
    np.testing.assert_allclose(freq, p, atol=0.03)


def test_random_crop_takes_one_window_for_the_batch():
    """The output is X's window of `shape` over the trailing dims at one
    start for the whole batch, within range; different seeds move it."""
    x = torch.arange(2 * 6 * 7, dtype=torch.float32).reshape(2, 6, 7)
    starts = set()
    for seed in range(1, 9):
        out = treg.lookup_op("random_crop").lower(
            treg.LowerCtx(seed=seed), {"X": [x]}, {"shape": [3, 4]})["Out"][0]
        assert out.shape == (2, 3, 4)
        r0, c0 = divmod(int(out[0, 0, 0]), 7)
        assert 0 <= r0 <= 3 and 0 <= c0 <= 3
        assert torch.equal(out, x[:, r0:r0 + 3, c0:c0 + 4])
        starts.add((r0, c0))
    assert len(starts) > 1


def test_nce_cost_follows_its_formula_over_the_drawn_labels():
    """nce draws its negatives from the run's generator, so its cost is
    held to the formula of the JAX lowering (paddle_tpu/ops/loss_ops.py
    `_nce`) over the port's own SampleLabels: softplus(-(s_pos - c)) +
    sum softplus(s_neg - c), c = log(S / C), weighted by SampleWeight; the
    draws lie in [0, C) and the first column is the label. Gradients reach
    Input, Weight and Bias."""
    n, d, c, s = 6, 5, 20, 4
    x = torch.from_numpy(f32(n, d)).requires_grad_()
    w = torch.from_numpy(f32(c, d)).requires_grad_()
    b = torch.from_numpy(f32(c)).requires_grad_()
    label = torch.from_numpy(R.randint(0, c, (n, 1)).astype("int64"))
    sw = torch.from_numpy(u01(n, 1))
    out = treg.lookup_op("nce").lower(
        treg.LowerCtx(seed=11), {"Input": [x], "Label": [label],
                                 "Weight": [w], "Bias": [b],
                                 "SampleWeight": [sw]},
        {"num_total_classes": c, "num_neg_samples": s})
    lab = as_numpy(out["SampleLabels"][0])
    assert lab.shape == (n, s + 1) and (lab >= 0).all() and (lab < c).all()
    np.testing.assert_array_equal(lab[:, 0], as_numpy(label)[:, 0])
    xn, wn, bn = (as_numpy(t.detach()) for t in (x, w, b))
    logits = np.einsum("nd,nsd->ns", xn, wn[lab]) + bn[lab]
    np.testing.assert_allclose(as_numpy(out["SampleLogits"][0].detach()),
                               logits, rtol=1e-5, atol=1e-5)
    corr = np.log(s / c)
    cost = (np.logaddexp(0, -(logits[:, 0] - corr))
            + np.logaddexp(0, logits[:, 1:] - corr).sum(1))[:, None] \
        * as_numpy(sw)
    np.testing.assert_allclose(as_numpy(out["Cost"][0].detach()), cost,
                               rtol=1e-5, atol=1e-6)
    out["Cost"][0].sum().backward()
    assert all(bool(t.grad.abs().sum() > 0) for t in (x, w, b))


def test_split_into_unequal_pieces_raises_as_jax():
    """jnp.split refuses a num that does not divide the axis; so does the
    port (torch.chunk would give pieces of other sizes)."""
    x = f32(2, 5)
    with pytest.raises(ValueError):
        jreg.lookup_op("split").lower(
            jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
            {"X": [jnp.asarray(x)]}, {"num": 2, "axis": 1})
    with pytest.raises(InvalidArgumentError, match="split"):
        treg.lookup_op("split").lower(
            treg.LowerCtx(), {"X": [torch.from_numpy(x)]},
            {"num": 2, "axis": 1})


@pytest.mark.parametrize("op_type,ins,attrs,slot", [
    ("fake_quantize_abs_max", {"X": f32(3, 4)}, {"bit_length": 8}, "X"),
    ("fake_quantize_moving_average_abs_max",
     {"X": f32(3, 4), "InScale": np.float32([1.5])}, {}, "X"),
    ("lrn", {"X": f32(1, 4, 2, 2)}, {}, "X"),
    ("grid_sampler", {"X": f32(1, 2, 3, 3),
                      "Grid": R.uniform(-1, 1, (1, 2, 2, 2)).astype(
                          "float32")}, {}, "X"),
    ("bilinear_interp", {"X": f32(1, 1, 5, 4)}, {"out_h": 3, "out_w": 6},
     "X"),
    ("hierarchical_sigmoid", {"X": f32(3, 4), "Label": i64(0, 4, 2,
                                                          shape=(3, 1)),
                              "W": f32(4, 4), "Bias": f32(4, 1)},
     {"num_classes": 5}, "W"),
])
def test_rest_of_library_gradients_match_jax(op_type, ins, attrs, slot):
    """d(sum(out * w))/d(slot) of the first output through autograd
    against jax.grad through the JAX lowering, at 1e-5: fake quantization
    passes the gradient straight through, the rest differentiate their
    plain formulas."""
    first = {"fake_quantize_abs_max": "Out", "lrn": "Out",
             "grid_sampler": "Output", "bilinear_interp": "Out",
             "fake_quantize_moving_average_abs_max": "Out",
             "hierarchical_sigmoid": "Out"}[op_type]
    rest = {s: a for s, a in ins.items() if s != slot}

    def jloss(v):
        out = jreg.lookup_op(op_type).lower(
            jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
            {slot: [v], **{s: [jnp.asarray(a)] for s, a in rest.items()}},
            dict(attrs))[first][0]
        return jnp.sum(out * jnp.cos(jnp.arange(out.size).reshape(
            out.shape)))

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(ins[slot])))
    t = torch.from_numpy(ins[slot].copy()).requires_grad_()
    out = treg.lookup_op(op_type).lower(
        treg.LowerCtx(), {slot: [t], **{s: [torch.from_numpy(a)]
                                        for s, a in rest.items()}},
        dict(attrs))[first][0]
    (out * torch.cos(torch.arange(out.numel()).reshape(out.shape))).sum() \
        .backward()
    np.testing.assert_allclose(as_numpy(t.grad), jg, rtol=1e-5, atol=1e-5)
