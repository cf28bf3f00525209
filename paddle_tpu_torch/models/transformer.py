"""Transformer models: the encoder-decoder `transformer` (Transformer-base
NMT), the decoder-only LM's training step, generation through both, and
the LM's serving decode ticks.

≙ paddle_tpu/models/transformer.py, all of it: `transformer` (with
`encoder_layer`, `decoder_layer` and the decomposed label smoothing),
`transformer_lm` (the train graph, padded and packed), the two generators
`transformer_generate` and `transformer_lm_generate` (greedy or beam
search over per-layer KV caches in one StaticRNN),
`transformer_lm_decode_tick` (what the continuous-batching engine builds),
the speculative verify tick, the paged decode and verify ticks (what the
paged KV engine builds) and their helpers. Parameter names and build
order are the JAX package's, so weights carry across by name
(io.load_numpy_params).

Every dropout site is the JAX package's: the attention weights (training
with attention dropout takes the explicit softmax route; otherwise, and at
`is_test`, the fused `fused_attention` op, which is K1-K3 on the card),
`ffn`, `_add_norm`, the embeddings and `_gen_embed_step`'s inference
scaling, each a `dropout` op (ops/random_ops.py).
"""

from __future__ import annotations

import numpy as np

from .. import layers
from ..initializer import NormalInitializer
from ..param_attr import ParamAttr

def positional_encoding_table(max_len, d_model):
    pos = np.arange(max_len)[:, None].astype("float32")
    i = np.arange(d_model)[None, :].astype("float32")
    angle = pos / np.power(10000.0, 2 * (i // 2) / d_model)
    table = np.zeros((max_len, d_model), dtype="float32")
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def multi_head_attention(q_in, k_in, v_in, d_model, num_heads, dropout=0.0,
                         is_test=False, causal=False, segment_ids=None,
                         name=None):
    """Multi-head attention with explicit head split, on the fused path:
    the q/k/v projections, one `fused_attention` op (the flash kernels on
    the card) and the output projection.

    segment_ids ([B, T] int32 var): packed-batch masking — tokens attend
    only within their own segment. Attention-weight dropout in training
    needs the explicit weights tensor: that route builds the scores, the
    softmax and the dropout op itself (packed batches refuse it)."""
    b, t_q = q_in.shape[0], q_in.shape[1]
    t_k = k_in.shape[1]
    d_head = d_model // num_heads
    q = layers.fc(q_in, size=d_model, num_flatten_dims=2, bias_attr=False,
                  use_bf16=True, name=name and name + "_q")
    k = layers.fc(k_in, size=d_model, num_flatten_dims=2, bias_attr=False,
                  use_bf16=True, name=name and name + "_k")
    v = layers.fc(v_in, size=d_model, num_flatten_dims=2, bias_attr=False,
                  use_bf16=True, name=name and name + "_v")

    def split_heads(x, t):
        x = layers.reshape(x, shape=[b, t, num_heads, d_head])
        return layers.transpose(x, perm=[0, 2, 1, 3])

    q = split_heads(q, t_q)
    k = split_heads(k, t_k)
    v = split_heads(v, t_k)
    if segment_ids is not None and dropout and not is_test:
        raise NotImplementedError(
            "packed batches (segment_ids) require the fused attention "
            "path; set attention dropout to 0 (residual/ffn dropout is "
            "unaffected)")
    if not dropout or is_test:
        ctx = layers.fused_attention(q, k, v, scale=float(d_head) ** -0.5,
                                     causal=causal, segment_ids=segment_ids)
        if dropout and is_test:
            # downgrade_in_infer: training scaled attention weights by the
            # keep mask; inference scales by (1-p) to keep the expectation
            ctx = layers.scale(ctx, scale=1.0 - dropout)
    else:
        # attention-weight dropout needs the explicit weights tensor
        q = layers.scale(q, scale=float(d_head) ** -0.5)
        scores = layers.matmul(q, k, transpose_y=True, use_bf16=True)
        if causal:
            mask_np = np.triu(np.full((t_q, t_k), -1e9, dtype="float32"),
                              k=1)
            mask = layers.assign(mask_np.reshape(1, 1, t_q, t_k))
            scores = layers.elementwise_add(scores, mask)
        weights = layers.softmax(scores)
        weights = layers.dropout(weights, dropout_prob=dropout,
                                 is_test=is_test)
        ctx = layers.matmul(weights, v, use_bf16=True)
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = layers.reshape(ctx, shape=[b, t_q, d_model])
    return layers.fc(ctx, size=d_model, num_flatten_dims=2, bias_attr=False,
                     use_bf16=True, name=name and name + "_o")


def ffn(x, d_model, d_inner, dropout=0.0, is_test=False, name=None):
    h = layers.fc(x, size=d_inner, num_flatten_dims=2, act="relu",
                  use_bf16=True, name=name and name + "_fc1")
    if dropout:
        h = layers.dropout(h, dropout_prob=dropout, is_test=is_test)
    return layers.fc(h, size=d_model, num_flatten_dims=2, use_bf16=True,
                     name=name and name + "_fc2")


def _add_norm(x, residual, dropout=0.0, is_test=False, name=None):
    """name (when given) pins the LayerNorm parameter names so a decode
    graph built later in the same program shares the trained weights (the
    generation path rebuilds per-step computation from the same names)."""
    if dropout:
        x = layers.dropout(x, dropout_prob=dropout, is_test=is_test)
    kw = {}
    if name:
        kw = {"param_attr": ParamAttr(name=name + ".scale"),
              "bias_attr": ParamAttr(name=name + ".bias")}
    return layers.layer_norm(layers.elementwise_add(x, residual),
                             begin_norm_axis=2, **kw)


def _embed(tokens, vocab_size, d_model, max_len, name, positions=None):
    """positions ([B, T] int32 var): per-token positional-encoding index.
    Packed batches use position-within-segment so a sequence embeds the
    same wherever it lands in the pack; default is the row position."""
    emb = layers.embedding(
        input=tokens, size=[vocab_size, d_model],
        param_attr=ParamAttr(name=name + "_emb",
                             initializer=NormalInitializer(0., d_model ** -0.5)))
    emb = layers.scale(emb, scale=float(d_model) ** 0.5)
    table = positional_encoding_table(max_len, d_model)
    if positions is not None:
        pos = layers.gather(layers.assign(table), positions)
    else:
        pos = layers.assign(table[None, :, :])
    return layers.elementwise_add(emb, pos)


def encoder_layer(x, d_model, num_heads, d_inner, dropout, is_test, name):
    attn = multi_head_attention(x, x, x, d_model, num_heads, dropout,
                                is_test, name=name + "_attn")
    x = _add_norm(attn, x, dropout, is_test, name=name + "_ln1")
    f = ffn(x, d_model, d_inner, dropout, is_test, name=name + "_ffn")
    return _add_norm(f, x, dropout, is_test, name=name + "_ln2")


def decoder_layer(x, enc_out, d_model, num_heads, d_inner, dropout, is_test,
                  name):
    self_attn = multi_head_attention(x, x, x, d_model, num_heads, dropout,
                                     is_test, causal=True,
                                     name=name + "_self")
    x = _add_norm(self_attn, x, dropout, is_test, name=name + "_ln1")
    cross = multi_head_attention(x, enc_out, enc_out, d_model, num_heads,
                                 dropout, is_test, name=name + "_cross")
    x = _add_norm(cross, x, dropout, is_test, name=name + "_ln2")
    f = ffn(x, d_model, d_inner, dropout, is_test, name=name + "_ffn")
    return _add_norm(f, x, dropout, is_test, name=name + "_ln3")


def transformer(src=None, tgt=None, label=None, src_vocab=30000,
                tgt_vocab=30000, max_len=64, d_model=512, d_inner=2048,
                num_heads=8, num_layers=6, dropout=0.1, is_test=False,
                label_smooth=0.1):
    """Transformer-base encoder-decoder; returns (loss, logits).

    src/tgt: [B, T] int64 padded token ids (lod_level=1 data vars with
    companion lengths); label: [B, T] next-token targets. The loss is the
    mean over target positions within each row's length; with
    `label_smooth` eps it is the uniformly smoothed cross entropy,
    decomposed as (1-eps)*CE(hard) + eps*mean_V(-log_softmax) so that no
    [B, T, V] one-hot or smoothed target is built."""
    if src is None:
        src = layers.data(name="src", shape=[max_len], dtype="int64",
                          lod_level=1)
    if tgt is None:
        tgt = layers.data(name="tgt", shape=[max_len], dtype="int64",
                          lod_level=1)
    if label is None:
        label = layers.data(name="lbl", shape=[max_len], dtype="int64")
    tgt_len = layers.sequence.get_seqlen(tgt)

    enc = _embed(src, src_vocab, d_model, max_len, "src")
    if dropout:
        enc = layers.dropout(enc, dropout_prob=dropout, is_test=is_test)
    for i in range(num_layers):
        enc = encoder_layer(enc, d_model, num_heads, d_inner, dropout,
                            is_test, f"enc{i}")

    dec = _embed(tgt, tgt_vocab, d_model, max_len, "tgt")
    if dropout:
        dec = layers.dropout(dec, dropout_prob=dropout, is_test=is_test)
    for i in range(num_layers):
        dec = decoder_layer(dec, enc, d_model, num_heads, d_inner, dropout,
                            is_test, f"dec{i}")

    logits = layers.fc(dec, size=tgt_vocab, num_flatten_dims=2,
                       use_bf16=True, name="proj")
    label3 = layers.unsqueeze(label, axes=[2])
    if label_smooth:
        eps = float(label_smooth)
        ce_hard = layers.softmax_with_cross_entropy(logits, label3)
        lp = layers.log_softmax(logits)
        uniform = layers.scale(
            layers.reduce_mean(lp, dim=[2], keep_dim=True), scale=-1.0)
        token_loss = layers.elementwise_add(
            layers.scale(ce_hard, scale=1.0 - eps),
            layers.scale(uniform, scale=eps))
    else:
        token_loss = layers.softmax_with_cross_entropy(logits, label3)
    mask = layers.sequence_mask(tgt_len, maxlen=max_len)
    mask = layers.unsqueeze(mask, axes=[2])
    masked = layers.elementwise_mul(token_loss, mask)
    loss = layers.reduce_sum(masked) / layers.reduce_sum(mask)
    return loss, logits


def _attend_cached(q, k5, v5, bias, K, num_heads, d_head, dropout=0.0):
    """Per-head attention of a single-position query over a cached K/V:
    q [B,K,H] against k5 / v5 both laid out [B,*,nh,T*,dh] (the * dims
    broadcast over the beam axis; scores read k via transpose_y, so ONE
    cache layout serves both matmuls), additive bias masking invalid keys.
    fuse_decode_attention_pass rewrites the matmul → add → softmax →
    matmul chain built here into one fused_decode_attention op. When the train graph had attention-weight
    dropout, the context is scaled by (1-p) — the same downgrade_in_infer
    correction the fused multi_head_attention path applies at
    inference."""
    H = num_heads * d_head
    q5 = layers.reshape(q, shape=[0, K, num_heads, 1, d_head])
    scores = layers.matmul(q5, k5, transpose_y=True,
                           alpha=float(d_head) ** -0.5)
    weights = layers.softmax(layers.elementwise_add(scores, bias))
    ctx = layers.reshape(layers.matmul(weights, v5), shape=[0, K, H])
    if dropout:
        ctx = layers.scale(ctx, scale=1.0 - dropout)
    return ctx


def _cached_self_attention(x, states, new_states, cache_id, prefix, K, T,
                           num_heads, d_head, pos, bias, dropout=0.0,
                           slot_axis=None):
    """One cached self-attention block of a decode step: project q/k/v
    from x [B,K,H], write k/v into the head-major caches (k and v both
    [B,K,nh,T,dh]; scores read k via transpose_y) at position `pos` via
    `cache_write`, attend over the masked cache, output-project. The
    per-step memory cost is one row write + one cache read. Parameter
    names come from `prefix` (matching the train graph's
    multi_head_attention names).

    slot_axis (serving-engine mode): cache rows along this axis belong to
    INDEPENDENT requests at independent positions — `pos` is per-slot and
    the cache_write output is the persistable cache variable itself, so
    the write lands in the cache tensor in place."""
    H = num_heads * d_head
    q = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                  use_bf16=True, name=f"{prefix}_q")
    kn = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                   use_bf16=True, name=f"{prefix}_k")
    vn = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                   use_bf16=True, name=f"{prefix}_v")
    slot_kw = {}
    if slot_axis is not None:
        slot_kw = {"batch_axis": slot_axis}
    kc = layers.cache_write(
        states[f"k{cache_id}"],
        layers.reshape(kn, shape=[0, K, num_heads, 1, d_head]), pos, axis=3,
        out=states[f"k{cache_id}"] if slot_axis is not None else None,
        **slot_kw)
    vc = layers.cache_write(
        states[f"v{cache_id}"],
        layers.reshape(vn, shape=[0, K, num_heads, 1, d_head]), pos, axis=3,
        out=states[f"v{cache_id}"] if slot_axis is not None else None,
        **slot_kw)
    new_states[f"k{cache_id}"], new_states[f"v{cache_id}"] = kc, vc
    ctx = _attend_cached(q, kc, vc, bias, K, num_heads, d_head, dropout)
    return layers.fc(ctx, size=H, num_flatten_dims=2, bias_attr=False,
                     use_bf16=True, name=f"{prefix}_o")


def _gen_embed_step(ids_prev, pos, emb_name, vocab, d_model, pe_table,
                    dropout=0.0):
    """Embed the previous token + positional encoding at `pos` (one-hot
    row-select from the PE table), with the train graph's post-embedding
    dropout corrected to its (1-p) inference scaling."""
    T = pe_table.shape[0]
    onehot_t = layers.one_hot(layers.cast(pos, "int64"), depth=T)
    emb = layers.embedding(layers.unsqueeze(ids_prev, axes=[2]),
                           size=[vocab, d_model],
                           param_attr=ParamAttr(name=emb_name))
    x = layers.scale(emb, scale=float(d_model) ** 0.5)
    x = layers.elementwise_add(
        x, layers.matmul(onehot_t, layers.assign(pe_table)))
    if dropout:
        x = layers.dropout(x, dropout_prob=dropout, is_test=True)
    return x


def _mask_to_bias(mask, axes):
    """0/1 keep-mask -> additive attention bias (-1e9 on masked keys),
    unsqueezed to broadcast against [.., nh, 1, T] score tensors."""
    return layers.unsqueeze(layers.scale(mask, scale=1e9, bias=-1e9),
                            axes=axes)


def _next_pos(pos):
    return layers.elementwise_add(pos,
                                  layers.fill_constant([1], "float32", 1.0))


def _step_mask_bias(pos, arange):
    """Additive bias hiding cache positions beyond the current one."""
    valid = layers.cast(
        layers.less_than(layers.assign(arange), _next_pos(pos)), "float32")
    return _mask_to_bias(valid, axes=[2, 3])


def _init_gen_states(batch_ref, K, T, H, num_layers, num_heads):
    """The decode loop's initial carry: a position counter and zeroed
    per-layer head-major KV caches, k and v both [B,K,nh,T,dh]. One layout
    serves the score matmul (through transpose_y) and the context matmul,
    and it is K4's: each step's `cache_write` writes one [.., 1, dh] row
    on the T axis."""
    d_head = H // num_heads
    init = {"pos": layers.fill_constant_batch_size_like(
        batch_ref, shape=[-1, K, 1], dtype="float32", value=0.0)}
    for i in range(num_layers):
        for sname in ("k", "v"):
            init[f"{sname}{i}"] = layers.fill_constant_batch_size_like(
                batch_ref, shape=[-1, K, num_heads, T, d_head],
                dtype="float32", value=0.0)
    return init


def transformer_generate(src=None, src_vocab=30000, tgt_vocab=30000,
                         max_src_len=64, max_gen=32, d_model=512,
                         d_inner=2048, num_heads=8, num_layers=6,
                         bos_id=0, eos_id=1, beam_size=4, dropout=0.0):
    """Encoder-decoder generation: encode the source once (the is_test
    encoder, whose attention is `fused_attention`, K1 on the card), then
    decode with per-layer self-attention KV caches in the loop's carry.
    The cross-attention keys and values are projected once outside the
    loop as [B,1,nh,Ts,dh] and broadcast over the beam axis. Weights are
    shared by name with a transformer(...) train graph of the same dims
    (enc{i}_*, dec{i}_*, src/tgt_emb, proj): train, then build this in its
    own program and run it in the same scope. Pass the `dropout` the train
    graph used: each dropout site is corrected to its (1-p) inference
    scaling, as is_test=True does on the train graph.

    The executor's fuse_decode_attention_pass turns each layer's cached
    self-attention into one `fused_decode_attention` (K4); the
    cross-attention matches it only at beam 1, where its layout is the
    query's.

    Returns (sequences [B, max_gen, K], scores [B, K])."""
    from ..contrib.decoder import BeamSearchDecoder

    if src is None:
        src = layers.data(name="src", shape=[max_src_len], dtype="int64",
                          lod_level=1)
    src_len = layers.sequence.get_seqlen(src)
    K, T, H = beam_size, max_gen, d_model
    Ts = max_src_len
    d_head = d_model // num_heads

    enc = _embed(src, src_vocab, d_model, Ts, "src")
    if dropout:
        enc = layers.dropout(enc, dropout_prob=dropout, is_test=True)
    for i in range(num_layers):
        enc = encoder_layer(enc, d_model, num_heads, d_inner, dropout,
                            True, f"enc{i}")

    # cross K/V once per layer: [B, 1, nh, Ts, dh] views that broadcast
    # over the beam axis inside the loop
    cross_k, cross_v = [], []
    for i in range(num_layers):
        ck = layers.fc(enc, size=H, num_flatten_dims=2, bias_attr=False,
                       use_bf16=True, name=f"dec{i}_cross_k")
        cv = layers.fc(enc, size=H, num_flatten_dims=2, bias_attr=False,
                       use_bf16=True, name=f"dec{i}_cross_v")
        ck = layers.transpose(
            layers.reshape(ck, shape=[0, 1, Ts, num_heads, d_head]),
            perm=[0, 1, 3, 2, 4])
        cv = layers.transpose(
            layers.reshape(cv, shape=[0, 1, Ts, num_heads, d_head]),
            perm=[0, 1, 3, 2, 4])
        cross_k.append(ck)
        cross_v.append(cv)
    src_mask = layers.sequence_mask(src_len, maxlen=Ts)   # [B,Ts]
    src_bias = _mask_to_bias(src_mask, axes=[1, 2, 3])

    decoder = BeamSearchDecoder(beam_size=K, bos_id=bos_id, eos_id=eos_id,
                                max_len=T, name="nmt_gen")
    pe_table = positional_encoding_table(T, d_model).astype("float32")
    arange = np.arange(T, dtype="float32").reshape(1, 1, T)
    init = _init_gen_states(src, K, T, H, num_layers, num_heads)

    def step(states, ids_prev):
        pos = states["pos"]
        x = _gen_embed_step(ids_prev, pos, "tgt_emb", tgt_vocab,
                            d_model, pe_table, dropout)
        self_bias = _step_mask_bias(pos, arange)
        new_states = {"pos": _next_pos(pos)}

        for i in range(num_layers):
            # causal self-attention over the KV cache
            attn = _cached_self_attention(
                x, states, new_states, i, f"dec{i}_self", K, T, num_heads,
                d_head, pos, self_bias, dropout)
            x = _add_norm(attn, x, dropout, True, name=f"dec{i}_ln1")

            # cross-attention over the pre-projected encoder K/V
            cq = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                           use_bf16=True, name=f"dec{i}_cross_q")
            cctx = _attend_cached(cq, cross_k[i], cross_v[i], src_bias,
                                  K, num_heads, d_head, dropout)
            cattn = layers.fc(cctx, size=H, num_flatten_dims=2,
                              bias_attr=False, use_bf16=True,
                              name=f"dec{i}_cross_o")
            x = _add_norm(cattn, x, dropout, True, name=f"dec{i}_ln2")
            f = ffn(x, d_model, d_inner, dropout, True, name=f"dec{i}_ffn")
            x = _add_norm(f, x, dropout, True, name=f"dec{i}_ln3")

        logits = layers.fc(x, size=tgt_vocab, num_flatten_dims=2,
                           use_bf16=True, name="proj")
        return new_states, layers.log_softmax(logits)

    return decoder.decode(src, init, step)


def transformer_lm_generate(prompt=None, vocab=32000, max_gen=32,
                            d_model=512, d_inner=2048, num_heads=8,
                            num_layers=6, bos_id=0, eos_id=-1, beam_size=1,
                            dropout=0.0, packed=False):
    """Autoregressive generation with a per-layer KV cache: one StaticRNN
    over max_gen positions, the caches [B,K,nh,T,dh] in its carry, each
    step writing one row with `cache_write` and attending over the masked
    cache (one `fused_decode_attention`, K4, per layer once the executor's
    fusion pass has run). Weights are shared by name with a
    transformer_lm(...) of the same dims (l{i}_attn_{q,k,v,o},
    l{i}_ln{1,2}, l{i}_ffn_*, tok_emb, lm_head): train it, then build this
    graph and run it in the same scope, passing the `dropout` and `packed`
    flag the train graph used. Each dropout site is corrected to its
    (1-p) inference scaling; packed training had no attention dropout, so
    packed=True skips the attention context's (1-p) scaling.
    Generation starts from the fed `prompt` ([B, 1] int64): each row's
    token seeds the decode; `bos_id` is the start token only of a decoder
    a caller builds itself. beam_size=1 is greedy; above 1 it is beam
    search through the shared BeamSearchDecoder.

    Returns (sequences [B, max_gen, K], scores [B, K])."""
    from ..contrib.decoder import BeamSearchDecoder

    if prompt is None:
        prompt = layers.data(name="prompt", shape=[1], dtype="int64")
    K, T, H = beam_size, max_gen, d_model
    d_head = d_model // num_heads
    decoder = BeamSearchDecoder(beam_size=K, bos_id=bos_id, eos_id=eos_id,
                                max_len=T, name="lm_gen")

    pe_table = positional_encoding_table(T, d_model).astype("float32")
    arange = np.arange(T, dtype="float32").reshape(1, 1, T)
    init = _init_gen_states(prompt, K, T, H, num_layers, num_heads)
    attn_dropout = 0.0 if packed else dropout

    def step(states, ids_prev):
        pos = states["pos"]                                      # [B,K,1]
        x = _gen_embed_step(ids_prev, pos, "tok_emb", vocab,
                            d_model, pe_table, dropout)
        bias = _step_mask_bias(pos, arange)
        new_states = {"pos": _next_pos(pos)}
        for i in range(num_layers):
            attn = _cached_self_attention(
                x, states, new_states, i, f"l{i}_attn", K, T, num_heads,
                d_head, pos, bias, attn_dropout)
            x = _add_norm(attn, x, dropout, True, name=f"l{i}_ln1")
            f = ffn(x, d_model, d_inner, dropout, True, name=f"l{i}_ffn")
            x = _add_norm(f, x, dropout, True, name=f"l{i}_ln2")

        logits = layers.fc(x, size=vocab, num_flatten_dims=2, use_bf16=True,
                           name="lm_head")
        return new_states, layers.log_softmax(logits)

    return decoder.decode(prompt, init, step, init_ids=prompt)


def _slot_cache_var(name, shape, dtype="float32"):
    """Persistable zero-initialized cache variable (main + startup blocks,
    the optimizer-accumulator idiom): the serving engine's KV caches live
    in the Scope across ticks as read-write state — updated in place on
    the device, never re-staged."""
    from ..framework.program import (default_main_program,
                                     default_startup_program)
    mb = default_main_program().global_block()
    if name in mb.vars:
        return mb.vars[name]
    var = mb.create_var(name=name, shape=list(shape), dtype=dtype,
                        persistable=True)
    var.stop_gradient = True
    sb = default_startup_program().global_block()
    sv = sb.create_var(name=name, shape=list(shape), dtype=dtype,
                       persistable=True)
    sb.append_op("fill_constant", outputs={"Out": [sv.name]},
                 attrs={"shape": list(shape), "value": 0.0, "dtype": dtype})
    return var


def transformer_lm_decode_tick(n_slots, vocab=32000, max_len=64,
                               d_model=512, d_inner=2048, num_heads=8,
                               num_layers=6, dropout=0.0, packed=False,
                               cache_prefix="srv", param_prefix="",
                               emit_logp=False):
    """ONE decode tick over a slot-indexed KV cache — the continuous-
    batching serving engine's step (serving/engine.py).

    A single-step program whose state is per-slot: caches are persistable
    [S,1,nh,T,dh] variables updated in place as read-write state,
    `tick_pos` is PER-SLOT (each slot at its own
    position — one mid-prompt, one 30 tokens into generation), and
    `cache_write(batch_axis=0)` writes each slot's row at its own
    position. One program serves every mixture of request
    phases, which is what lets the scheduler admit a new request into the
    in-flight batch without recompiling or padding to a static batch.

    Inputs (all fed per tick): `tick_tok` [S,1] int64 (the token each
    slot consumes: next prompt token while prefilling, else the slot's
    previously sampled token), `tick_pos` [S,1,1] float32 (the position
    being written). Weights are shared BY NAME with transformer_lm
    (tok_emb, l{i}_attn_*, l{i}_ln*, l{i}_ffn_*, lm_head) — train first
    (or load), then build this in its own program and run it in the same
    scope. A nonzero dropout scales as the trained graph's inference
    would (1-p at each dropout site).

    Returns (next_ids [S,1] int64, cache_names list): argmax of the tick
    logits per slot, and the persistable cache variable names (the engine
    resets nothing on slot reuse — positions > a slot's own pos are
    masked, and prefill overwrites rows 0..P-1 before exposing them).

    param_prefix namespaces EVERY weight name (tok_emb, l{i}_*, lm_head)
    — the JAX package's speculative draft model is this builder at
    param_prefix="draft_". With emit_logp=True the tick also returns the
    full log-softmax logits [S,1,V].
    """
    S, T, H = n_slots, max_len, d_model
    d_head = d_model // num_heads
    # STATIC slot dim (no -1 batch): the slot count is the program's shape,
    # and the static form is what lets fuse_decode_attention_pass match the
    # per-tick attention chain against the fixed-shape slot caches
    tok = layers.data(name="tick_tok", shape=[S, 1], dtype="int64",
                      append_batch_size=False)
    pos = layers.data(name="tick_pos", shape=[S, 1, 1], dtype="float32",
                      append_batch_size=False)
    attn_dropout = 0.0 if packed else dropout

    states = {}
    for i in range(num_layers):
        for s in ("k", "v"):
            states[f"{s}{i}"] = _slot_cache_var(
                f"{cache_prefix}_{s}{i}", [S, 1, num_heads, T, d_head])

    pe_table = positional_encoding_table(T, d_model).astype("float32")
    arange = np.arange(T, dtype="float32").reshape(1, 1, T)
    x = _gen_embed_step(tok, pos, f"{param_prefix}tok_emb", vocab, d_model,
                        pe_table, dropout)
    bias = _step_mask_bias(pos, arange)       # per-slot: pos broadcasts
    new_states = {}
    for i in range(num_layers):
        attn = _cached_self_attention(
            x, states, new_states, i, f"{param_prefix}l{i}_attn", 1, T,
            num_heads, d_head, pos, bias, attn_dropout, slot_axis=0)
        x = _add_norm(attn, x, dropout, True, name=f"{param_prefix}l{i}_ln1")
        f = ffn(x, d_model, d_inner, dropout, True,
                name=f"{param_prefix}l{i}_ffn")
        x = _add_norm(f, x, dropout, True, name=f"{param_prefix}l{i}_ln2")
    logits = layers.fc(x, size=vocab, num_flatten_dims=2, use_bf16=True,
                       name=f"{param_prefix}lm_head")
    next_ids = layers.argmax(logits, axis=2)            # [S,1] int64
    cache_names = [v.name for v in states.values()]
    if emit_logp:
        return next_ids, cache_names, layers.log_softmax(logits)
    return next_ids, cache_names


def _attend_cached_multi(q, k5, v5, bias, G, num_heads, d_head, dropout=0.0):
    """`_attend_cached` widened to a G-position query window: q [S,G,H]
    becomes q5 [S,1,nh,G,dh], so the G verify positions ride the query-row
    axis of the SAME matmul→add→softmax→matmul chain —
    fuse_decode_attention_pass matches it for 1 <= G < T and the fused
    kernel (K4's G-row route) reads the cache ONCE for all G positions:
    one cache pass scores γ+1 draft tokens. Returns [S, G, H]."""
    H = num_heads * d_head
    q5 = layers.unsqueeze(
        layers.transpose(
            layers.reshape(q, shape=[0, G, num_heads, d_head]),
            perm=[0, 2, 1, 3]),
        axes=[1])                                     # [S,1,nh,G,dh]
    scores = layers.matmul(q5, k5, transpose_y=True,
                           alpha=float(d_head) ** -0.5)
    weights = layers.softmax(layers.elementwise_add(scores, bias))
    ctx5 = layers.matmul(weights, v5)                 # [S,1,nh,G,dh]
    ctx = layers.reshape(
        layers.transpose(ctx5, perm=[0, 1, 3, 2, 4]), shape=[0, G, H])
    if dropout:
        ctx = layers.scale(ctx, scale=1.0 - dropout)
    return ctx


def _spec_window_positions(pos, G):
    """Absolute positions of a verify window: base `pos` [S,1,1] + offsets
    0..G-1 → [S,G,1] (position of each fed token / written cache row)."""
    offs = np.arange(G, dtype="float32").reshape(1, G, 1)
    return layers.elementwise_add(pos, layers.assign(offs))


def _spec_mask_bias(posg, arange):
    """Causal bias for the verify window: query row g (absolute position
    posg[s,g]) attends cache positions t <= posg[s,g] — which includes
    every window row written earlier in the same forward, so the verify
    scores are EXACTLY the scores the plain tick would produce feeding the
    same tokens one at a time. [S,G,1] → [S,1,1,G,T]."""
    valid = layers.cast(
        layers.less_than(layers.assign(arange), _next_pos(posg)), "float32")
    return _mask_to_bias(valid, axes=[1, 2])


def _spec_window_write(cache, new, pos, G, num_heads, d_head):
    """Write a G-row window [S,G,H] into a slot cache [S,1,nh,T,dh] at each
    slot's base position: one `cache_write(batch_axis=0)` whose New spans G
    rows on the T axis. Callers gate rounds on pos+G <= T (the port's
    cache_write raises on an overhanging window; the JAX package's clamps
    it)."""
    row = layers.unsqueeze(
        layers.transpose(
            layers.reshape(new, shape=[0, G, num_heads, d_head]),
            perm=[0, 2, 1, 3]),
        axes=[1])                                     # [S,1,nh,G,dh]
    return layers.cache_write(cache, row, pos, axis=3, batch_axis=0,
                              out=cache)


def transformer_lm_spec_verify_tick(n_slots, gamma, vocab=32000, max_len=64,
                                    d_model=512, d_inner=2048, num_heads=8,
                                    num_layers=6, dropout=0.0, packed=False,
                                    cache_prefix="srv", param_prefix=""):
    """ONE speculative VERIFY forward over the slot-indexed KV cache: score
    G = γ+1 positions per slot — the slot's committed next token followed
    by the draft model's γ proposals (or teacher-forced prompt tokens
    mid-prefill) — through the same fused decode-attention path as
    `transformer_lm_decode_tick`, writing all G KV rows into the SAME
    per-slot caches (shared by `cache_prefix` name with the plain tick's
    program in one scope). The serving engine commits the accepted prefix
    by advancing `fed` and leaves the rejected tail rows stale — masked by
    every later forward's position bias until overwritten, exactly the
    slot-reuse garbage contract the plain tick already lives with.

    Inputs (fed per round): `spec_tok` [S,G] int64, `spec_pos` [S,1,1]
    float32 (base position; rows land at pos..pos+γ — the engine gates
    participation on pos+G <= max_len).

    Returns (ids [S,G] int64, logp [S,G,V], cache_names): per-position
    argmax (greedy acceptance + bonus token) and full log-probs (rejection
    sampling against the draft's distribution)."""
    S, T, H, G = n_slots, max_len, d_model, gamma + 1
    d_head = d_model // num_heads
    tok = layers.data(name="spec_tok", shape=[S, G], dtype="int64",
                      append_batch_size=False)
    pos = layers.data(name="spec_pos", shape=[S, 1, 1], dtype="float32",
                      append_batch_size=False)
    attn_dropout = 0.0 if packed else dropout

    states = {}
    for i in range(num_layers):
        for s in ("k", "v"):
            states[f"{s}{i}"] = _slot_cache_var(
                f"{cache_prefix}_{s}{i}", [S, 1, num_heads, T, d_head])

    pe_table = positional_encoding_table(T, d_model).astype("float32")
    arange = np.arange(T, dtype="float32").reshape(1, 1, T)
    posg = _spec_window_positions(pos, G)             # [S,G,1]
    x = _gen_embed_step(tok, posg, f"{param_prefix}tok_emb", vocab, d_model,
                        pe_table, dropout)
    bias = _spec_mask_bias(posg, arange)              # [S,1,1,G,T]
    for i in range(num_layers):
        prefix = f"{param_prefix}l{i}_attn"
        q = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                      use_bf16=True, name=f"{prefix}_q")
        kn = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                       use_bf16=True, name=f"{prefix}_k")
        vn = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                       use_bf16=True, name=f"{prefix}_v")
        kc = _spec_window_write(states[f"k{i}"], kn, pos, G, num_heads,
                                d_head)
        vc = _spec_window_write(states[f"v{i}"], vn, pos, G, num_heads,
                                d_head)
        ctx = _attend_cached_multi(q, kc, vc, bias, G, num_heads, d_head,
                                   attn_dropout)
        attn = layers.fc(ctx, size=H, num_flatten_dims=2, bias_attr=False,
                         use_bf16=True, name=f"{prefix}_o")
        x = _add_norm(attn, x, dropout, True, name=f"{param_prefix}l{i}_ln1")
        f = ffn(x, d_model, d_inner, dropout, True,
                name=f"{param_prefix}l{i}_ffn")
        x = _add_norm(f, x, dropout, True, name=f"{param_prefix}l{i}_ln2")
    logits = layers.fc(x, size=vocab, num_flatten_dims=2, use_bf16=True,
                       name=f"{param_prefix}lm_head")
    ids = layers.argmax(logits, axis=2)               # [S,G] int64
    logp = layers.log_softmax(logits)                 # [S,G,V]
    cache_names = [v.name for v in states.values()]
    return ids, logp, cache_names


def transformer_lm_paged_decode_tick(n_slots, n_blocks, block_size,
                                     blocks_per_req, vocab=32000,
                                     d_model=512, d_inner=2048, num_heads=8,
                                     num_layers=6, dropout=0.0, packed=False,
                                     cache_prefix="pgd", topk_k=0,
                                     kv_quant=False):
    """ONE decode tick over a PAGED KV cache — the block-table read/write
    variant of `transformer_lm_decode_tick` (serving/kv_pager.py).

    The slot tick owns a full [S,1,nh,max_len,dh] row per slot; here the
    KV state is one device-resident POOL per layer per k/v —
    [n_blocks, nh, block_size, dh] persistable variables — and each slot
    sees the cache through its BLOCK TABLE (`tick_btab` [S, NLB] int64,
    NLB = blocks_per_req): logical block j of slot s lives in physical
    block tick_btab[s, j]. The read path is gather(pool, btab) →
    transpose → reshape, reconstructing the exact [S,1,nh,T,dh] view the
    slot tick attends over (T = NLB*block_size), so the downstream
    q·K/softmax/·V chain is IDENTICAL and fuse_decode_attention_pass
    matches it unchanged. The write path is `paged_cache_write`: slot
    s's new k/v row lands at pool[tick_wblock[s], :, tick_woff[s], :] —
    block-granular, one in-place index_put_.

    Physical block 0 is the pool's reserved NULL block: idle slots are
    steered to write there (tok/pos zeroed, btab all-zero) so one
    fixed-shape compiled tick serves any live/idle mix; a live block
    table never maps block 0, and the positional mask hides every view
    position beyond a slot's own `tick_pos`, so null-block garbage is
    never attended. Prefix sharing needs no graph support at all: a
    shared prefix simply means two rows of `tick_btab` carry the SAME
    physical block id — the gather reads the same bytes twice.

    Weights are shared BY NAME with transformer_lm (tok_emb, l{i}_attn_*,
    l{i}_ln*, l{i}_ffn_*, lm_head) — same contract as the slot tick;
    pass the SAME dropout/packed the train graph used.

    Inputs (fed per tick): `tick_tok` [S,1] int64, `tick_pos` [S,1,1]
    float32 (the LOGICAL position being written), `tick_btab` [S,NLB]
    int64, `tick_wblock` [S] int64, `tick_woff` [S] int64.

    Returns (next_ids [S,1] int64, cache_names); with topk_k > 0 also
    the per-slot top-k of the tick's log-probs — (topk_logp [S,1,k],
    topk_ids [S,1,k]) — the host-side scoring surface `paged_beam_search`
    ranks hypotheses with.

    kv_quant=True stores the pools as int8 payloads plus per-row f32
    scale pools ([NB, nh, BS, 1], names `{cache_prefix}_{k,v}{i}_sc`):
    writes quantize on the way in (`paged_cache_write_quant`, symmetric
    amax/127 over each dh row) and the read gathers payload+scales and
    dequantizes with one cast+multiply into the float32 view the fused
    decode attention reads — so the resident pool bytes drop ~4x and the
    pager hands the freed bytes back as extra admitted blocks."""
    S, NB, BS, NLB = n_slots, n_blocks, block_size, blocks_per_req
    T = NLB * BS                      # the per-request logical span
    d_head = d_model // num_heads
    tok = layers.data(name="tick_tok", shape=[S, 1], dtype="int64",
                      append_batch_size=False)
    pos = layers.data(name="tick_pos", shape=[S, 1, 1], dtype="float32",
                      append_batch_size=False)
    btab = layers.data(name="tick_btab", shape=[S, NLB], dtype="int64",
                       append_batch_size=False)
    wblock = layers.data(name="tick_wblock", shape=[S], dtype="int64",
                         append_batch_size=False)
    woff = layers.data(name="tick_woff", shape=[S], dtype="int64",
                       append_batch_size=False)
    attn_dropout = 0.0 if packed else dropout

    pools, scale_pools = _paged_pool_vars(cache_prefix, NB, num_heads, BS,
                                          d_head, num_layers, kv_quant)

    pe_table = positional_encoding_table(T, d_model).astype("float32")
    arange = np.arange(T, dtype="float32").reshape(1, 1, T)
    x = _gen_embed_step(tok, pos, "tok_emb", vocab, d_model, pe_table,
                        dropout)
    bias = _step_mask_bias(pos, arange)       # per-slot: pos broadcasts
    H = d_model
    for i in range(num_layers):
        q = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                      use_bf16=True, name=f"l{i}_attn_q")
        kn = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                       use_bf16=True, name=f"l{i}_attn_k")
        vn = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                       use_bf16=True, name=f"l{i}_attn_v")
        views = []
        for sname, new in (("k", kn), ("v", vn)):
            # write this tick's row into each slot's current block (the
            # pool var is updated in place, as the slot tick's caches
            # are), THEN read the table view from the written pool
            # so the new row is attendable within the same tick
            new3 = layers.reshape(new, shape=[0, num_heads, d_head])
            views.append(_paged_pool_view(
                pools, scale_pools, f"{sname}{i}", new3, wblock, woff,
                btab, num_heads, T, d_head))
        ctx = _attend_cached(q, views[0], views[1], bias, 1, num_heads,
                             d_head, attn_dropout)
        attn = layers.fc(ctx, size=H, num_flatten_dims=2, bias_attr=False,
                         use_bf16=True, name=f"l{i}_attn_o")
        x = _add_norm(attn, x, dropout, True, name=f"l{i}_ln1")
        f = ffn(x, d_model, d_inner, dropout, True, name=f"l{i}_ffn")
        x = _add_norm(f, x, dropout, True, name=f"l{i}_ln2")
    logits = layers.fc(x, size=vocab, num_flatten_dims=2, use_bf16=True,
                       name="lm_head")
    next_ids = layers.argmax(logits, axis=2)            # [S,1] int64
    cache_names = ([v.name for v in pools.values()]
                   + [v.name for v in scale_pools.values()])
    if topk_k:
        logp = layers.log_softmax(logits)
        topk_vals, topk_ids = layers.topk(logp, k=topk_k)
        return next_ids, cache_names, topk_vals, topk_ids
    return next_ids, cache_names


def _paged_pool_vars(cache_prefix, n_blocks, num_heads, block_size, d_head,
                     num_layers, kv_quant):
    """Per-layer k/v pool variables for the paged ticks. kv_quant=False:
    f32 pools, empty scale dict. kv_quant=True: int8 payload pools plus
    f32 per-row scale pools (`{cache_prefix}_{s}{i}_sc`)."""
    pools, scale_pools = {}, {}
    for i in range(num_layers):
        for s in ("k", "v"):
            pools[f"{s}{i}"] = _slot_cache_var(
                f"{cache_prefix}_{s}{i}",
                [n_blocks, num_heads, block_size, d_head],
                dtype="int8" if kv_quant else "float32")
            if kv_quant:
                scale_pools[f"{s}{i}"] = _slot_cache_var(
                    f"{cache_prefix}_{s}{i}_sc",
                    [n_blocks, num_heads, block_size, 1])
    return pools, scale_pools


def _paged_pool_view(pools, scale_pools, key, new3, wblock, woff, btab,
                     num_heads, T, d_head):
    """Write `new3` rows into pool `key` then reconstruct the slot-tick
    cache view [S,1,nh,T,dh] through the block table — dequantizing
    against the gathered scale view when the pool is int8 (scale_pools
    non-empty). Shared by the paged decode tick (one row per slot) and
    the paged verify tick (G rows per slot: wblock/woff [S,G], new3
    [S*G,nh,dh] — `paged_cache_write` flattens the targets)."""
    pool = pools[key]
    if scale_pools:
        spool = scale_pools[key]
        written, wscales = layers.paged_cache_write_quant(
            pool, spool, new3, wblock, woff, out=pool, scales_out=spool)
        g = layers.cast(layers.gather(written, btab), "float32")
        gs = layers.gather(wscales, btab)        # [S,NLB,nh,BS,1]
        g = layers.elementwise_mul(g, gs)        # [S,NLB,nh,BS,dh] f32
    else:
        written = layers.paged_cache_write(pool, new3, wblock, woff,
                                           out=pool)
        g = layers.gather(written, btab)         # [S,NLB,nh,BS,dh]
    g = layers.transpose(g, perm=[0, 2, 1, 3, 4])
    g = layers.reshape(g, shape=[0, num_heads, T, d_head])
    return layers.unsqueeze(g, axes=[1])         # [S,1,nh,T,dh]


def transformer_lm_paged_spec_verify_tick(n_slots, gamma, n_blocks,
                                          block_size, blocks_per_req,
                                          vocab=32000, d_model=512,
                                          d_inner=2048, num_heads=8,
                                          num_layers=6, dropout=0.0,
                                          packed=False, cache_prefix="pgd",
                                          param_prefix="", kv_quant=False):
    """ONE speculative VERIFY forward over the PAGED KV pools — the
    block-table counterpart of `transformer_lm_spec_verify_tick`. Each
    slot scores G = γ+1 positions in one forward; the G new KV rows
    scatter into the slot's CURRENT blocks (`spec_wblock`/`spec_woff`
    [S,G]: per-position physical targets the engine derives from the
    block table at fed..fed+γ), then the table view is gathered back and
    attended with the per-position causal bias. Verify positions occupy
    the slot-tick layout the way beam forks do: rows of rejected
    positions stay in place, masked, until the pager's rollback detaches
    their fully-rejected blocks (`KVPager.rollback`) and later writes
    overwrite the partial boundary block. Idle slots steer every write to
    the reserved null block 0.

    Inputs (fed per round): `spec_tok` [S,G] int64, `spec_pos` [S,1,1]
    float32, `spec_btab` [S,NLB] int64, `spec_wblock` [S,G] int64,
    `spec_woff` [S,G] int64.

    Returns (ids [S,G] int64, logp [S,G,V], cache_names). kv_quant as in
    `transformer_lm_paged_decode_tick` (shares the SAME int8+scale pool
    variables by name)."""
    S, NB, BS, NLB = n_slots, n_blocks, block_size, blocks_per_req
    G = gamma + 1
    T = NLB * BS
    H = d_model
    d_head = d_model // num_heads
    tok = layers.data(name="spec_tok", shape=[S, G], dtype="int64",
                      append_batch_size=False)
    pos = layers.data(name="spec_pos", shape=[S, 1, 1], dtype="float32",
                      append_batch_size=False)
    btab = layers.data(name="spec_btab", shape=[S, NLB], dtype="int64",
                       append_batch_size=False)
    wblock = layers.data(name="spec_wblock", shape=[S, G], dtype="int64",
                         append_batch_size=False)
    woff = layers.data(name="spec_woff", shape=[S, G], dtype="int64",
                       append_batch_size=False)
    attn_dropout = 0.0 if packed else dropout

    pools, scale_pools = _paged_pool_vars(cache_prefix, NB, num_heads, BS,
                                          d_head, num_layers, kv_quant)

    pe_table = positional_encoding_table(T, d_model).astype("float32")
    arange = np.arange(T, dtype="float32").reshape(1, 1, T)
    posg = _spec_window_positions(pos, G)             # [S,G,1]
    x = _gen_embed_step(tok, posg, f"{param_prefix}tok_emb", vocab, d_model,
                        pe_table, dropout)
    bias = _spec_mask_bias(posg, arange)              # [S,1,1,G,T]
    for i in range(num_layers):
        prefix = f"{param_prefix}l{i}_attn"
        q = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                      use_bf16=True, name=f"{prefix}_q")
        kn = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                       use_bf16=True, name=f"{prefix}_k")
        vn = layers.fc(x, size=H, num_flatten_dims=2, bias_attr=False,
                       use_bf16=True, name=f"{prefix}_v")
        views = []
        for sname, new in (("k", kn), ("v", vn)):
            new3 = layers.reshape(new, shape=[S * G, num_heads, d_head])
            views.append(_paged_pool_view(
                pools, scale_pools, f"{sname}{i}", new3, wblock, woff,
                btab, num_heads, T, d_head))
        ctx = _attend_cached_multi(q, views[0], views[1], bias, G,
                                   num_heads, d_head, attn_dropout)
        attn = layers.fc(ctx, size=H, num_flatten_dims=2, bias_attr=False,
                         use_bf16=True, name=f"{prefix}_o")
        x = _add_norm(attn, x, dropout, True, name=f"{param_prefix}l{i}_ln1")
        f = ffn(x, d_model, d_inner, dropout, True,
                name=f"{param_prefix}l{i}_ffn")
        x = _add_norm(f, x, dropout, True, name=f"{param_prefix}l{i}_ln2")
    logits = layers.fc(x, size=vocab, num_flatten_dims=2, use_bf16=True,
                       name=f"{param_prefix}lm_head")
    ids = layers.argmax(logits, axis=2)               # [S,G] int64
    logp = layers.log_softmax(logits)                 # [S,G,V]
    cache_names = ([v.name for v in pools.values()]
                   + [v.name for v in scale_pools.values()])
    return ids, logp, cache_names


def transformer_lm(tokens=None, label=None, vocab=32000, max_len=128,
                   d_model=512, d_inner=2048, num_heads=8, num_layers=6,
                   dropout=0.0, is_test=False, packed=False,
                   mean_loss=False):
    """Decoder-only causal LM — the flagship config used by
    __graft_entry__ (simplest shape that exercises dp/tp/sp sharding).

    packed=True: each batch row holds MULTIPLE sequences back to back,
    described by a `segments` int32 input ([B, max_len]; 0 = padding,
    1..N = sequence index — see data.packing.pack_sequences). Attention is
    segment-masked through the flash kernel and the loss counts only
    non-pad tokens. This is the throughput idiom for ragged corpora: no
    compute wasted on padding (≙ the reference's LoD batches whose whole
    point is padding-free ragged training, lod_tensor.h:58)."""
    if tokens is None:
        tokens = layers.data(name="tokens", shape=[max_len], dtype="int64",
                             lod_level=0 if packed else 1)
    if label is None:
        label = layers.data(name="targets", shape=[max_len], dtype="int64")
    segments = positions = None
    if packed:
        segments = layers.data(name="segments", shape=[max_len],
                               dtype="int32")
        positions = layers.data(name="positions", shape=[max_len],
                                dtype="int32")
    else:
        seqlen = layers.sequence.get_seqlen(tokens)
    x = _embed(tokens, vocab, d_model, max_len, "tok", positions=positions)
    if dropout:
        x = layers.dropout(x, dropout_prob=dropout, is_test=is_test)
    for i in range(num_layers):
        attn = multi_head_attention(x, x, x, d_model, num_heads,
                                    0.0 if packed else dropout,
                                    is_test, causal=True,
                                    segment_ids=segments,
                                    name=f"l{i}_attn")
        x = _add_norm(attn, x, dropout, is_test, name=f"l{i}_ln1")
        f = ffn(x, d_model, d_inner, dropout, is_test, name=f"l{i}_ffn")
        x = _add_norm(f, x, dropout, is_test, name=f"l{i}_ln2")
    logits = layers.fc(x, size=vocab, num_flatten_dims=2, use_bf16=True,
                       name="lm_head")
    label3 = layers.unsqueeze(label, axes=[2])
    token_loss = layers.softmax_with_cross_entropy(logits, label3)
    if packed:
        # a token trains iff it is non-pad AND its successor belongs to
        # the same segment (the last token of each packed sequence has no
        # valid next-token target)
        seg_next = layers.concat([
            layers.slice(segments, axes=[1], starts=[1], ends=[max_len]),
            layers.fill_constant_batch_size_like(segments, [-1, 1],
                                                 "int32", 0)], axis=1)
        nonpad = layers.greater_than(
            segments, layers.fill_constant([1], "int32", 0))
        same = layers.equal(segments, seg_next)
        mask = layers.elementwise_mul(layers.cast(nonpad, "float32"),
                                      layers.cast(same, "float32"))
    else:
        mask = layers.sequence_mask(seqlen, maxlen=max_len)
    mask = layers.unsqueeze(mask, axes=[2])
    masked = layers.elementwise_mul(token_loss, mask)
    if mean_loss:
        # mean over ALL positions instead of the mask-weighted sum/sum
        # quotient — identical for full-length sequences, and the MEAN
        # reduction form the explicit dp gradient pipeline requires
        # (grad_comm averages per-shard gradients; that equals the global
        # gradient only for a batch-mean loss — docs/data_parallel.md)
        loss = layers.mean(masked)
    else:
        loss = layers.reduce_sum(masked) / layers.reduce_sum(mask)
    return loss, logits
