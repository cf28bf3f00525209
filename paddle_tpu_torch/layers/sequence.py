"""Sequence layers.

≙ paddle_tpu/layers/sequence.py (reference layers/nn.py sequence_* +
dynamic_lstm:290 / dynamic_gru / dynamic_lstmp, linear_chain_crf,
crf_decoding, chunk_eval, warpctc and ctc_greedy_decoder). A padded sequence is a dense [B, T, ...]
variable with a companion length variable: `var.seqlen_var` (propagated by
`tag_sequence` through sequence layers) or the `<name>@SEQLEN` variable that
`layers.data(lod_level>0)` declares.
"""

from __future__ import annotations

import copy

from ..core.dtypes import dtype_name
from ..core.enforce import InvalidArgumentError, NotFoundError, enforce
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


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


def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=True,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="identity", dtype="float32", name=None):
    """≙ reference layers/nn.py dynamic_lstmp (lstmp_op.cc): LSTM with a
    recurrent projection layer. `input` is the pre-projected [B, T, 4H]
    sequence; size = 4 * hidden; proj_size = P. Returns (projection, cell):
    [B, T, P] and [B, T, H]."""
    enforce(size % 4 == 0, "dynamic_lstmp size must be 4*hidden",
            exc=InvalidArgumentError)
    helper = LayerHelper("dynamic_lstmp", name=name)
    hidden_size = size // 4
    seqlen = get_seqlen(input)
    weight = helper.create_parameter(param_attr,
                                     shape=[proj_size, 4 * hidden_size],
                                     dtype=dtype)
    # the projection weight must NOT alias the recurrent weight when the
    # caller names param_attr (create_parameter returns the existing var for
    # a repeated name) — derive a distinct name, keeping every other attr
    # (trainable/regularizer/lr/clip/sharding)
    proj_attr = param_attr
    if isinstance(param_attr, ParamAttr) and param_attr.name:
        proj_attr = copy.copy(param_attr)
        proj_attr.name = param_attr.name + "_proj"
    proj_weight = helper.create_parameter(proj_attr,
                                          shape=[hidden_size, proj_size],
                                          dtype=dtype)
    bias = helper.create_parameter(
        bias_attr, shape=[7 * hidden_size if use_peepholes
                          else 4 * hidden_size],
        dtype=dtype, is_bias=True)
    b, t = input.shape[0], input.shape[1]
    proj = helper.create_tmp_variable(dtype=dtype, shape=[b, t, proj_size])
    cell = helper.create_tmp_variable(dtype=dtype,
                                      shape=[b, t, hidden_size])
    inputs = {"Input": [input], "Weight": [weight],
              "ProjWeight": [proj_weight], "Bias": [bias],
              "SeqLen": [seqlen]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(type="dynamic_lstmp",
                     inputs=inputs,
                     outputs={"Projection": [proj], "Cell": [cell]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation,
                            "proj_activation": proj_activation})
    return tag_sequence(proj, seqlen), tag_sequence(cell, seqlen)


def sequence_reshape(input, new_dim):
    """≙ reference layers/nn.py sequence_reshape (sequence_reshape_op.cc):
    change the feature width, scaling every sequence length by
    old_dim / new_dim."""
    helper = LayerHelper("sequence_reshape", name=None)
    seqlen = get_seqlen(input)
    b, t, d = input.shape
    out = helper.create_tmp_variable(dtype=dtype_name(input.dtype),
                                     shape=[b, (t * d) // new_dim, new_dim])
    new_len = helper.create_tmp_variable(dtype="int32", shape=[b])
    helper.append_op(type="sequence_reshape",
                     inputs={"X": [input], "SeqLen": [seqlen]},
                     outputs={"Out": [out], "SeqLenOut": [new_len]},
                     attrs={"new_dim": new_dim})
    return tag_sequence(out, new_len)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    """≙ reference layers/nn.py sequence_conv (context-window conv)."""
    helper = LayerHelper("sequence_conv", name=name, act=act,
                         bias_attr=bias_attr)
    seqlen = get_seqlen(input)
    dtype = dtype_name(input.dtype)
    d = input.shape[-1]
    filter_shape = [filter_size * d, num_filters]
    filter_param = helper.create_parameter(param_attr, shape=filter_shape,
                                           dtype=dtype)
    b, t = input.shape[0], input.shape[1]
    out = helper.create_tmp_variable(dtype=dtype, shape=[b, t, num_filters])
    helper.append_op(type="sequence_conv",
                     inputs={"X": [input], "Filter": [filter_param],
                             "SeqLen": [seqlen]},
                     outputs={"Out": [out]},
                     attrs={"contextLength": filter_size,
                            "contextStart": -(filter_size // 2),
                            "contextStride": filter_stride})
    out = helper.append_bias_op(out)
    return tag_sequence(helper.append_activation(out), seqlen)


def sequence_softmax(input, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    seqlen = get_seqlen(input)
    out = helper.create_tmp_variable(dtype=dtype_name(input.dtype),
                                     shape=input.shape)
    helper.append_op(type="sequence_softmax",
                     inputs={"X": [input], "SeqLen": [seqlen]},
                     outputs={"Out": [out]})
    return tag_sequence(out, seqlen)


def sequence_first_step(input, name=None):
    helper = LayerHelper("sequence_first_step", name=name)
    seqlen = get_seqlen(input)
    out_shape = [input.shape[0]] + list(input.shape[2:])
    out = helper.create_tmp_variable(dtype=dtype_name(input.dtype),
                                     shape=out_shape)
    helper.append_op(type="sequence_first_step",
                     inputs={"X": [input], "SeqLen": [seqlen]},
                     outputs={"Out": [out]})
    return out


def sequence_reverse(x, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    seqlen = get_seqlen(x)
    out = helper.create_tmp_variable(dtype=dtype_name(x.dtype), shape=x.shape)
    helper.append_op(type="sequence_reverse",
                     inputs={"X": [x], "SeqLen": [seqlen]},
                     outputs={"Y": [out]})
    return tag_sequence(out, seqlen)


def sequence_expand(x, y, name=None):
    """Broadcast per-sequence vector x [B, D] over y's time dim."""
    helper = LayerHelper("sequence_expand", name=name)
    seqlen = get_seqlen(y)
    out = helper.create_tmp_variable(
        dtype=dtype_name(x.dtype),
        shape=[x.shape[0], y.shape[1]] + list(x.shape[1:]))
    helper.append_op(type="sequence_expand",
                     inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]})
    return tag_sequence(out, seqlen)


def sequence_concat(input, name=None):
    """Concatenate sequences along the feature dim."""
    helper = LayerHelper("sequence_concat", name=name)
    xs = input if isinstance(input, (list, tuple)) else [input]
    seqlen = get_seqlen(xs[0])
    feat = sum(x.shape[-1] for x in xs)
    out = helper.create_tmp_variable(dtype=dtype_name(xs[0].dtype),
                                     shape=list(xs[0].shape[:-1]) + [feat])
    helper.append_op(type="sequence_concat", inputs={"X": list(xs)},
                     outputs={"Out": [out]})
    return tag_sequence(out, seqlen)


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    seqlen = get_seqlen(input)
    out = helper.create_tmp_variable(
        dtype=dtype_name(input.dtype),
        shape=[input.shape[0], int(length)] + list(input.shape[2:]))
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input], "Offset": [offset]},
                     outputs={"Out": [out]}, attrs={"length": int(length)})
    return tag_sequence(out, seqlen)


def sequence_pad(x, pad_value=None, maxlen=None, name=None):
    """Already-padded representation: identity + lengths (API parity with
    reference sequence_pad)."""
    helper = LayerHelper("sequence_pad", name=name)
    seqlen = get_seqlen(x)
    out = helper.create_tmp_variable(dtype=dtype_name(x.dtype), shape=x.shape)
    length = helper.create_tmp_variable(dtype="int32",
                                        shape=[x.shape[0]])
    helper.append_op(type="sequence_pad",
                     inputs={"X": [x], "SeqLen": [seqlen]},
                     outputs={"Out": [out], "Length": [length]})
    return out, length


def sequence_erase(input, tokens, name=None):
    helper = LayerHelper("sequence_erase", name=name)
    seqlen = get_seqlen(input)
    out = helper.create_tmp_variable(dtype=dtype_name(input.dtype),
                                     shape=input.shape)
    mask = helper.create_tmp_variable(dtype="int32", shape=input.shape)
    helper.append_op(type="sequence_erase",
                     inputs={"X": [input]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"tokens": list(tokens)})
    return tag_sequence(out, seqlen)


def linear_chain_crf(input, label, length, param_attr=None, name=None):
    """Linear-chain CRF negative log-likelihood
    (≙ reference layers/nn.py linear_chain_crf / linear_chain_crf_op.cc).

    input: [B, T, D] emissions; label: [B, T] int; length: [B].
    Creates the [D+2, D] transition parameter (row 0 start, row 1 end,
    rows 2.. transitions) and returns Loss [B, 1]."""
    helper = LayerHelper("linear_chain_crf", name=name,
                         param_attr=param_attr)
    ntags = input.shape[-1]
    transition = helper.create_parameter(attr=param_attr,
                                         shape=[ntags + 2, ntags],
                                         dtype=dtype_name(input.dtype))
    ll = helper.create_tmp_variable(dtype=dtype_name(input.dtype),
                                    shape=[input.shape[0], 1])
    alpha = helper.create_tmp_variable(dtype=dtype_name(input.dtype),
                                       shape=[input.shape[0], ntags])
    e_exp = helper.create_tmp_variable(dtype=dtype_name(input.dtype),
                                       shape=list(input.shape))
    t_exp = helper.create_tmp_variable(dtype=dtype_name(input.dtype),
                                       shape=[ntags + 2, ntags])
    helper.append_op(type="linear_chain_crf",
                     inputs={"Emission": [input], "Transition": [transition],
                             "Label": [label], "Length": [length]},
                     outputs={"LogLikelihood": [ll], "Alpha": [alpha],
                              "EmissionExps": [e_exp],
                              "TransitionExps": [t_exp]})
    return ll


def crf_decoding(input, length, param_attr=None, label=None, name=None):
    """Viterbi decode against a trained CRF transition parameter
    (≙ reference layers/nn.py crf_decoding / crf_decoding_op.cc). The
    transition param is resolved by name from param_attr (share it with the
    linear_chain_crf layer). With `label`, returns the 1/0 correctness mask
    the reference emits instead of the path."""
    helper = LayerHelper("crf_decoding", name=name, param_attr=param_attr)
    ntags = input.shape[-1]
    transition = helper.create_parameter(attr=param_attr,
                                         shape=[ntags + 2, ntags],
                                         dtype=dtype_name(input.dtype))
    path = helper.create_tmp_variable(dtype="int64",
                                      shape=list(input.shape[:2]))
    inputs = {"Emission": [input], "Transition": [transition],
              "Length": [length]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path]})
    return path


def chunk_eval(input, label, length, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, name=None):
    """Chunk-level precision/recall/F1 (≙ reference layers chunk_eval /
    chunk_eval_op.cc). Returns (precision, recall, f1, num_infer_chunks,
    num_label_chunks, num_correct_chunks)."""
    helper = LayerHelper("chunk_eval", name=name)
    mk = helper.create_tmp_variable
    precision = mk(dtype="float32", shape=[1])
    recall = mk(dtype="float32", shape=[1])
    f1 = mk(dtype="float32", shape=[1])
    n_inf = mk(dtype="int64", shape=[1])
    n_lab = mk(dtype="int64", shape=[1])
    n_cor = mk(dtype="int64", shape=[1])
    helper.append_op(type="chunk_eval",
                     inputs={"Inference": [input], "Label": [label],
                             "Length": [length]},
                     outputs={"Precision": [precision], "Recall": [recall],
                              "F1-Score": [f1], "NumInferChunks": [n_inf],
                              "NumLabelChunks": [n_lab],
                              "NumCorrectChunks": [n_cor]},
                     attrs={"chunk_scheme": chunk_scheme,
                            "num_chunk_types": int(num_chunk_types),
                            "excluded_chunk_types":
                                list(excluded_chunk_types or [])})
    return precision, recall, f1, n_inf, n_lab, n_cor


def _as_lengths_var(v, what):
    """Accept a tagged sequence (its lengths are extracted) or a rank-1
    integer lengths Variable; anything else is rejected loudly."""
    from ..framework.program import Variable
    enforce(isinstance(v, Variable),
            f"{what} must be a Variable (a tagged sequence or a [B] int "
            f"lengths vector); got {type(v).__name__} — note: this "
            f"framework's 'LoD' is per-sequence LENGTHS, not offset lists",
            exc=InvalidArgumentError)
    try:
        return get_seqlen(v)
    except NotFoundError:
        is_len_vec = (len(v.shape or ()) == 1 and
                      "int" in str(v.dtype))
        enforce(is_len_vec,
                f"{what} ({v.name!r}) is neither a tagged sequence nor a "
                f"rank-1 integer lengths vector (shape={v.shape}, "
                f"dtype={v.dtype})", exc=InvalidArgumentError)
        return v


def lod_reset(x, y=None, target_lod=None):
    """≙ reference lod_reset_op: re-tag a tensor with new sequence lengths.
    In the static-shape translation, "LoD" is the companion @SEQLEN length
    vector — resetting means tagging a COPY of `x` with `y`'s lengths (or
    an explicit lengths Variable via target_lod). `x` itself keeps its
    original tagging, matching the reference op's fresh output var."""
    enforce(y is not None or target_lod is not None,
            "lod_reset needs y (a tagged sequence or lengths var) or "
            "target_lod", exc=InvalidArgumentError)
    lengths = _as_lengths_var(y if y is not None else target_lod,
                              "lod_reset lengths source")
    helper = LayerHelper("lod_reset")
    out = helper.create_tmp_variable(dtype=dtype_name(x.dtype),
                                     shape=list(x.shape))
    helper.append_op(type="assign", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return tag_sequence(out, lengths)


def max_sequence_len(rank_table_or_seq):
    """≙ max_sequence_len_op (over a lod_rank_table in the reference): the
    longest sequence length in the batch. Accepts a tagged sequence or a
    rank-1 integer lengths vector."""
    from . import nn as _nn
    lengths = _as_lengths_var(rank_table_or_seq, "max_sequence_len input")
    return _nn.reduce_max(lengths)


# --- CTC (≙ reference layers/nn.py warpctc, layers ctc_greedy_decoder)


def warpctc(input, label, input_length, label_length, blank=0,
            norm_by_times=False, name=None):
    """CTC loss (≙ reference layers/nn.py warpctc / operators/warpctc_op.cc).

    input: [B, T, C] unnormalized logits; label: [B, L] int;
    input_length/label_length: [B]. Returns Loss [B, 1].
    """
    helper = LayerHelper("warpctc", name=name)
    loss = helper.create_tmp_variable(dtype=dtype_name(input.dtype),
                                      shape=[input.shape[0], 1])
    helper.append_op(type="warpctc",
                     inputs={"Logits": [input], "Label": [label],
                             "LogitsLength": [input_length],
                             "LabelLength": [label_length]},
                     outputs={"Loss": [loss]},
                     attrs={"blank": int(blank),
                            "norm_by_times": bool(norm_by_times)})
    return loss


def ctc_greedy_decoder(input, blank, input_length, name=None):
    """Greedy (best-path) CTC decode: per-step argmax then merge-repeats +
    drop-blanks (≙ reference ctc_greedy_decoder = top_k + ctc_align).

    input: [B, T, C] probabilities/logits. Returns (decoded [B, T],
    decoded_length [B, 1])."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    best = helper.create_tmp_variable(dtype="int64",
                                      shape=list(input.shape[:2]))
    helper.append_op(type="arg_max", inputs={"X": [input]},
                     outputs={"Out": [best]}, attrs={"axis": -1})
    out = helper.create_tmp_variable(dtype="int64",
                                     shape=list(input.shape[:2]))
    out_len = helper.create_tmp_variable(dtype="int64",
                                         shape=[input.shape[0], 1])
    helper.append_op(type="ctc_align",
                     inputs={"Input": [best],
                             "InputLength": [input_length]},
                     outputs={"Output": [out], "OutputLength": [out_len]},
                     attrs={"blank": int(blank), "padding_value": 0})
    return out, out_len
