"""Sequence layers.

≙ paddle_tpu/layers/sequence.py (reference layers/nn.py sequence_* +
dynamic_lstm:290 / dynamic_gru), trimmed to the layers the padded LM batch
and the recurrent models build. A padded sequence is a dense [B, T, ...]
variable with a companion length variable: `var.seqlen_var` (propagated by
`tag_sequence` through sequence layers) or the `<name>@SEQLEN` variable that
`layers.data(lod_level>0)` declares.
"""

from __future__ import annotations

from ..core.dtypes import dtype_name
from ..core.enforce import InvalidArgumentError, NotFoundError, enforce
from ..layer_helper import LayerHelper


def get_seqlen(var):
    """Resolve the companion sequence-length variable of a padded sequence."""
    sl = getattr(var, "seqlen_var", None)
    if sl is not None:
        return sl
    v = var.block.find_var_recursive(var.name + "@SEQLEN")
    enforce(v is not None,
            f"variable {var.name!r} has no sequence-length companion; "
            f"declare it with layers.data(..., lod_level=1) or propagate "
            f"seqlen_var", exc=NotFoundError)
    return v


def tag_sequence(out, seqlen):
    """Mark `out` as a sequence sharing `seqlen`. Returns out."""
    out.seqlen_var = seqlen
    return out


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """≙ reference layers/nn.py:290 (dynamic_lstm). `input` is the
    pre-projected [B, T, 4H] sequence (apply fc first, as the reference
    requires); size = 4 * hidden. Returns (hidden, cell), both [B, T, H]
    sequences. With use_peepholes the bias has 7H values, as in the JAX
    package, whose lowering adds only the first 4H to the gates (the other
    3H get a zero gradient); the port does the same."""
    enforce(size % 4 == 0, "dynamic_lstm size must be 4*hidden",
            exc=InvalidArgumentError)
    helper = LayerHelper("dynamic_lstm", name=name)
    hidden_size = size // 4
    seqlen = get_seqlen(input)
    weight = helper.create_parameter(param_attr,
                                     shape=[hidden_size, 4 * hidden_size],
                                     dtype=dtype)
    bias = helper.create_parameter(
        bias_attr, shape=[7 * hidden_size if use_peepholes
                          else 4 * hidden_size],
        dtype=dtype, is_bias=True)
    b, t = input.shape[0], input.shape[1]
    hidden = helper.create_tmp_variable(dtype=dtype,
                                        shape=[b, t, hidden_size])
    cell = helper.create_tmp_variable(dtype=dtype, shape=[b, t, hidden_size])
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias],
              "SeqLen": [seqlen]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(type="dynamic_lstm", inputs=inputs,
                     outputs={"Hidden": [hidden], "Cell": [cell]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    return tag_sequence(hidden, seqlen), tag_sequence(cell, seqlen)


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, name=None):
    """≙ reference layers/nn.py dynamic_gru. `input` is pre-projected
    [B, T, 3H]; size = hidden. Returns hidden sequence [B, T, H]."""
    helper = LayerHelper("dynamic_gru", name=name)
    seqlen = get_seqlen(input)
    dtype = dtype_name(input.dtype)
    weight = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                     dtype=dtype)
    bias = helper.create_parameter(bias_attr, shape=[3 * size], dtype=dtype,
                                   is_bias=True)
    b, t = input.shape[0], input.shape[1]
    hidden = helper.create_tmp_variable(dtype=dtype, shape=[b, t, size])
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias],
              "SeqLen": [seqlen]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(type="dynamic_gru", inputs=inputs,
                     outputs={"Hidden": [hidden]},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "activation": candidate_activation})
    return tag_sequence(hidden, seqlen)


def sequence_pool(input, pool_type="average", name=None):
    """≙ reference layers/nn.py sequence_pool. Pools [B, T, D] -> [B, D]
    over valid timesteps."""
    helper = LayerHelper("sequence_pool", name=name)
    seqlen = get_seqlen(input)
    dtype = dtype_name(input.dtype)
    out_shape = [input.shape[0]] + list(input.shape[2:])
    out = helper.create_tmp_variable(dtype=dtype, shape=out_shape)
    helper.append_op(type="sequence_pool",
                     inputs={"X": [input], "SeqLen": [seqlen]},
                     outputs={"Out": [out]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_last_step(input, name=None):
    helper = LayerHelper("sequence_last_step", name=name)
    seqlen = get_seqlen(input)
    out_shape = [input.shape[0]] + list(input.shape[2:])
    out = helper.create_tmp_variable(dtype=dtype_name(input.dtype),
                                     shape=out_shape)
    helper.append_op(type="sequence_last_step",
                     inputs={"X": [input], "SeqLen": [seqlen]},
                     outputs={"Out": [out]})
    return out


def sequence_mask(x, maxlen, dtype="float32", name=None):
    """[B] lengths -> [B, maxlen] 0/1 mask (≙ reference sequence_mask).
    maxlen is static."""
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_tmp_variable(dtype=dtype,
                                     shape=[x.shape[0], int(maxlen)])
    helper.append_op(type="sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]}, attrs={"maxlen": int(maxlen)})
    return out
