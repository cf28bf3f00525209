"""DeepFM / Wide&Deep CTR models.

≙ paddle_tpu/models/deepfm.py (the capability slot of the reference's
sparse path: lookup_table_op.cc:21 with is_sparse). The same programs as
the JAX package's; with `is_sparse=True` the table's gradient ships as
rows and values (framework/selected_rows.py) and the optimizer touches
only the looked-up rows."""

from __future__ import annotations

from .. import layers


def deepfm(feat_ids=None, feat_vals=None, label=None, num_fields=39,
           vocab_size=100000, embed_dim=16, fc_sizes=(400, 400, 400),
           is_sparse=False, fuse_first_order=True, row_pad=None):
    """DeepFM: linear term + FM second-order term + DNN over concatenated
    field embeddings.

    feat_ids: [B, num_fields] int64; feat_vals: [B, num_fields] float32;
    label: [B, 1] float32 in {0, 1}.

    fuse_first_order (on by default): the first-order scalar weights live
    as column 0 of ONE [vocab, 1 + embed_dim] table instead of a separate
    [vocab, 1] table: the same model, half the lookups and row updates.

    row_pad (opt-in): pad the fused table's rows to a multiple of this
    width (e.g. 128) and slice the logical columns after the lookup. The
    pad columns take a zero gradient, and lazy (sparse) Adam leaves their
    moments at exactly 0. On the card a 128-float row is 512 contiguous
    bytes, so each gathered or updated row is whole cache lines. None
    keeps the logical table shape.
    """
    if feat_ids is None:
        feat_ids = layers.data(name="feat_ids", shape=[num_fields],
                               dtype="int64")
    if feat_vals is None:
        feat_vals = layers.data(name="feat_vals", shape=[num_fields])
    if label is None:
        label = layers.data(name="label", shape=[1])

    vals3 = layers.unsqueeze(feat_vals, axes=[2])                     # [B,F,1]
    if fuse_first_order:
        # one table, one lookup: [:, :, 0:1] is the linear weight, the
        # rest is the FM/DNN embedding
        width = 1 + embed_dim
        if row_pad:
            width = -(-width // row_pad) * row_pad
        fused = layers.embedding(input=feat_ids,
                                 size=[vocab_size, width],
                                 is_sparse=is_sparse)                 # [B,F,W]
        w1 = layers.slice(fused, axes=[2], starts=[0], ends=[1])
        emb = layers.slice(fused, axes=[2], starts=[1],
                           ends=[1 + embed_dim])
    else:
        if row_pad:
            raise NotImplementedError(
                "row_pad tile-aligns the FUSED table; with "
                "fuse_first_order=False pass row_pad=None (the unfused "
                "[vocab,1]/[vocab,E] tables keep their logical widths)")
        # first-order: per-feature scalar weight
        w1 = layers.embedding(input=feat_ids, size=[vocab_size, 1],
                              is_sparse=is_sparse)                    # [B,F,1]
        emb = layers.embedding(input=feat_ids,
                               size=[vocab_size, embed_dim],
                               is_sparse=is_sparse)
    first = layers.reduce_sum(layers.elementwise_mul(w1, vals3), dim=[1])

    # second-order FM: 0.5 * ((sum v)^2 - sum v^2)
    emb = layers.elementwise_mul(emb, vals3)                          # [B,F,E]
    sum_v = layers.reduce_sum(emb, dim=[1])                           # [B,E]
    sum_sq = layers.elementwise_mul(sum_v, sum_v)
    sq_sum = layers.reduce_sum(layers.elementwise_mul(emb, emb), dim=[1])
    fm = layers.scale(layers.reduce_sum(
        layers.elementwise_sub(sum_sq, sq_sum), dim=[1], keep_dim=True),
        scale=0.5)

    # deep part
    b, f = feat_ids.shape[0], num_fields
    deep = layers.reshape(emb, shape=[b, f * embed_dim])
    for size in fc_sizes:
        deep = layers.fc(deep, size=size, act="relu")
    deep_out = layers.fc(deep, size=1)

    logit = layers.elementwise_add(layers.elementwise_add(first, fm),
                                   deep_out)
    loss_vec = layers.sigmoid_cross_entropy_with_logits(logit, label)
    loss = layers.mean(loss_vec)
    pred = layers.sigmoid(logit)
    return loss, pred


def wide_and_deep(wide_ids=None, deep_ids=None, label=None, wide_fields=10,
                  deep_fields=26, wide_vocab=100000, deep_vocab=100000,
                  embed_dim=8, fc_sizes=(256, 128)):
    """Wide&Deep: linear wide part over sparse ids + DNN over embeddings."""
    if wide_ids is None:
        wide_ids = layers.data(name="wide_ids", shape=[wide_fields],
                               dtype="int64")
    if deep_ids is None:
        deep_ids = layers.data(name="deep_ids", shape=[deep_fields],
                               dtype="int64")
    if label is None:
        label = layers.data(name="label", shape=[1])
    wide_w = layers.embedding(input=wide_ids, size=[wide_vocab, 1])
    wide_out = layers.reduce_sum(wide_w, dim=[1])
    emb = layers.embedding(input=deep_ids, size=[deep_vocab, embed_dim])
    b = deep_ids.shape[0]
    deep = layers.reshape(emb, shape=[b, deep_fields * embed_dim])
    for size in fc_sizes:
        deep = layers.fc(deep, size=size, act="relu")
    deep_out = layers.fc(deep, size=1)
    logit = layers.elementwise_add(wide_out, deep_out)
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logit, label))
    pred = layers.sigmoid(logit)
    return loss, pred
