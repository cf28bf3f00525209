"""Stacked dynamic-LSTM text models.

≙ paddle_tpu/models/stacked_lstm.py (≙ reference
benchmark/fluid/models/stacked_dynamic_lstm.py). Sequence inputs are padded
[B, T] token ids with a companion length vector; each `dynamic_lstm` is
rewritten by the executor into a `fused_lstm`, one launch of the
whole-sequence LSTM kernel (fusion/recurrent.py).
"""

from __future__ import annotations

from .. import layers


def stacked_lstm_net(data=None, label=None, dict_dim=30000, emb_dim=512,
                     hid_dim=512, stacked_num=3, class_num=2, max_len=100):
    """Sentiment-style classifier: embedding -> [fc + lstm] x N ->
    max-pool(hidden, cell) -> fc softmax (mirrors the reference model).
    Returns (loss, accuracy, logits)."""
    if data is None:
        data = layers.data(name="words", shape=[max_len], dtype="int64",
                           lod_level=1, append_batch_size=True)
    if label is None:
        label = layers.data(name="label", shape=[1], dtype="int64")
    seqlen = layers.sequence.get_seqlen(data)

    emb = layers.embedding(input=data, size=[dict_dim, emb_dim])
    emb = layers.sequence.tag_sequence(emb, seqlen)

    fc1 = layers.fc(emb, size=hid_dim * 4, num_flatten_dims=2)
    fc1 = layers.sequence.tag_sequence(fc1, seqlen)
    lstm1, cell1 = layers.dynamic_lstm(input=fc1, size=hid_dim * 4)

    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        concat = layers.concat(inputs, axis=-1)
        concat = layers.sequence.tag_sequence(concat, seqlen)
        fc = layers.fc(concat, size=hid_dim * 4, num_flatten_dims=2)
        fc = layers.sequence.tag_sequence(fc, seqlen)
        lstm, cell = layers.dynamic_lstm(input=fc, size=hid_dim * 4)
        inputs = [fc, lstm]

    fc_last = layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type="max")
    logits = layers.fc([fc_last, lstm_last], size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits


def lstm_language_model(data=None, label=None, vocab_size=10000, emb_dim=200,
                        hid_dim=200, num_layers=2, max_len=35):
    """PTB-style LSTM LM: predict the next token at every position. The
    loss is the masked mean NLL over valid positions. Returns (loss,
    logits)."""
    if data is None:
        data = layers.data(name="tokens", shape=[max_len], dtype="int64",
                           lod_level=1)
    if label is None:
        label = layers.data(name="targets", shape=[max_len], dtype="int64")
    seqlen = layers.sequence.get_seqlen(data)
    emb = layers.embedding(input=data, size=[vocab_size, emb_dim])
    emb = layers.sequence.tag_sequence(emb, seqlen)
    h = emb
    for _ in range(num_layers):
        proj = layers.fc(h, size=hid_dim * 4, num_flatten_dims=2)
        proj = layers.sequence.tag_sequence(proj, seqlen)
        h, _ = layers.dynamic_lstm(input=proj, size=hid_dim * 4)
    logits = layers.fc(h, size=vocab_size, num_flatten_dims=2)
    label3 = layers.unsqueeze(label, axes=[2])
    token_loss = layers.softmax_with_cross_entropy(logits, label3)
    mask = layers.sequence_mask(seqlen, maxlen=max_len)
    mask = layers.unsqueeze(mask, axes=[2])
    masked = layers.elementwise_mul(token_loss, mask)
    loss = layers.reduce_sum(masked) / layers.reduce_sum(mask)
    return loss, logits
