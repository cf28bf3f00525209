"""RNN encoder-decoder machine translation with attention and beam search.

≙ paddle_tpu/models/machine_translation.py (≙ reference
benchmark/fluid/models/machine_translation.py and
tests/book/test_machine_translation.py): a GRU encoder and a GRU decoder
with dot-product attention over the encoder's outputs, trained with
cross-entropy under teacher forcing (`train_net`) and decoded by beam
search (`infer_net`). The executor rewrites the encoder's `dynamic_gru`
into a `fused_gru` (one launch of the whole-sequence GRU kernel) and the
decoder step's attention chain into a `fused_decode_attention` (the
decode-attention kernel; under autograd in training, and over the K beams
of a row as its G = K query rows in decoding); the decoder is a StaticRNN
whose step block runs once per target position.
"""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr

def _gru_cell(x, h_prev, hidden_dim, name):
    """GRU cell from fc blocks (≙ the reference decoder's fc + gru_unit
    composition). x: [..., D], h_prev: [..., H] -> h: [..., H]."""
    nfd = len(x.shape) - 1
    gates = layers.elementwise_add(
        layers.fc(x, size=2 * hidden_dim, num_flatten_dims=nfd,
                  bias_attr=False, name=name + "_xg"),
        layers.fc(h_prev, size=2 * hidden_dim, num_flatten_dims=nfd,
                  name=name + "_hg"))
    gates = layers.sigmoid(gates)
    u = layers.slice(gates, axes=[nfd], starts=[0], ends=[hidden_dim])
    r = layers.slice(gates, axes=[nfd], starts=[hidden_dim],
                     ends=[2 * hidden_dim])
    cand = layers.tanh(layers.elementwise_add(
        layers.fc(x, size=hidden_dim, num_flatten_dims=nfd, bias_attr=False,
                  name=name + "_xc"),
        layers.fc(layers.elementwise_mul(r, h_prev), size=hidden_dim,
                  num_flatten_dims=nfd, name=name + "_hc")))
    one_minus_u = layers.scale(u, scale=-1.0, bias=1.0)
    return layers.elementwise_add(layers.elementwise_mul(u, h_prev),
                                  layers.elementwise_mul(one_minus_u, cand))


def _attention(state, enc_out, src_mask, name):
    """Dot-product attention of the decoder state over the encoder outputs
    (≙ the reference's simple_attention). state [B, H] (or [B, K, H]),
    enc_out [B, T, H], src_mask [B, T] 0/1 (padded source positions muted)
    -> context like state."""
    if len(state.shape) == 2:
        q = layers.unsqueeze(state, axes=[1])          # [B, 1, H]
    else:
        q = state                                      # [B, K, H]
    scores = layers.matmul(q, enc_out, transpose_y=True)  # [B, *, T]
    neg = layers.scale(src_mask, scale=1e9, bias=-1e9)    # 0 -> -1e9, 1 -> 0
    scores = layers.elementwise_add(scores, layers.unsqueeze(neg, axes=[1]))
    weights = layers.softmax(scores)
    ctx = layers.matmul(weights, enc_out)              # [B, *, H]
    if len(state.shape) == 2:
        ctx = layers.squeeze(ctx, axes=[1])
    return ctx


def encoder(src, src_lens, vocab_size, embed_dim, hidden_dim):
    from ..layers.sequence import tag_sequence
    emb = layers.embedding(src, size=[vocab_size, embed_dim],
                           param_attr=ParamAttr(name="src_emb"))
    proj = layers.fc(emb, size=3 * hidden_dim, num_flatten_dims=2,
                     bias_attr=False, name="enc_proj")
    proj = tag_sequence(proj, src_lens)
    enc = layers.dynamic_gru(proj, size=hidden_dim, name="enc_gru")
    return enc                                          # [B, T, H]


def train_net(src, src_lens, tgt_in, tgt_out, tgt_mask, dict_size=10000,
              embed_dim=64, hidden_dim=128):
    """Teacher-forced training graph. src [B, Ts], src_lens [B],
    tgt_in/tgt_out [B, Tt], tgt_mask [B, Tt] float 0/1. Returns
    (avg_loss, logits)."""
    enc_out = encoder(src, src_lens, dict_size, embed_dim, hidden_dim)
    src_mask = layers.sequence_mask(src_lens, maxlen=src.shape[1])
    dec_init = layers.fc(layers.sequence_last_step(enc_out),
                         size=hidden_dim, act="tanh", name="dec_init")

    tgt_emb = layers.embedding(tgt_in, size=[dict_size, embed_dim],
                               param_attr=ParamAttr(name="tgt_emb"))

    rnn = layers.StaticRNN(name="decoder")
    with rnn.step():
        w = rnn.step_input(tgt_emb)                    # [B, E]
        h_prev = rnn.memory(init=dec_init)             # [B, H]
        ctx = _attention(h_prev, enc_out, src_mask, "att")
        inp = layers.concat([w, ctx], axis=1)
        h = _gru_cell(inp, h_prev, hidden_dim, "dec_gru")
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    dec_hidden = rnn()                                 # [B, Tt, H]

    logits = layers.fc(dec_hidden, size=dict_size, num_flatten_dims=2,
                       name="readout")
    b, t = tgt_out.shape[0], tgt_out.shape[1]
    flat_logits = layers.reshape(logits, shape=[-1, dict_size])
    flat_label = layers.reshape(tgt_out, shape=[-1, 1])
    ce = layers.softmax_with_cross_entropy(flat_logits, flat_label)
    ce = layers.reshape(ce, shape=[b, t])
    masked = layers.elementwise_mul(ce, tgt_mask)
    loss = layers.reduce_sum(masked) / (layers.reduce_sum(tgt_mask) + 1e-6)
    return loss, logits


def infer_net(src, src_lens, dict_size=10000, embed_dim=64, hidden_dim=128,
              beam_size=4, max_len=16, bos_id=0, eos_id=1):
    """The beam-search decoding graph, reusing the trained parameters'
    names. Returns (sequences [B, max_len, K], scores [B, K]), the beams
    best first."""
    enc_out = encoder(src, src_lens, dict_size, embed_dim, hidden_dim)
    src_mask = layers.sequence_mask(src_lens, maxlen=src.shape[1])
    dec_init = layers.fc(layers.sequence_last_step(enc_out),
                         size=hidden_dim, act="tanh", name="dec_init")

    from ..contrib.decoder import BeamSearchDecoder

    decoder = BeamSearchDecoder(beam_size=beam_size, bos_id=bos_id,
                                eos_id=eos_id, max_len=max_len)

    def step(states, ids_prev):
        h_prev = states["h"]                                        # [B,K,H]
        # ids as [B, K, 1]: with beam_size=1 a bare [B, 1] would be read as
        # an index COLUMN by the embedding convention, squeezing the beam dim
        w = layers.embedding(layers.unsqueeze(ids_prev, axes=[2]),
                             size=[dict_size, embed_dim],
                             param_attr=ParamAttr(name="tgt_emb"))  # [B,K,E]
        ctx = _attention(h_prev, enc_out, src_mask, "att")          # [B,K,H]
        inp = layers.concat([w, ctx], axis=2)
        h = _gru_cell(inp, h_prev, hidden_dim, "dec_gru")           # [B,K,H]
        logits = layers.fc(h, size=dict_size, num_flatten_dims=2,
                           name="readout")
        return {"h": h}, layers.log_softmax(logits)     # [B, K, V]

    return decoder.decode(src, {"h": decoder.expand_to_beams(dec_init)},
                          step)                    # [B, K, ...]
