"""CRNN-CTC text recognizer (≙ paddle_tpu/models/ocr_crnn.py; capability
≙ the reference's OCR / CTC stack: layers warpctc + ctc_align over conv
features and recurrent layers — reference layers/nn.py warpctc,
operators/warpctc_op.cc, ctc_align_op.cc).

Image columns become the time axis by reshape / transpose (no LoD); the
BiGRU is two `dynamic_gru` calls (forward and is_reverse), which the
executor fuses into the whole-sequence GRU kernel (csrc/recurrent.cu,
K6) at any hidden size; the CTC loss and decoder are loops on the device
(ops/sequence_label_ops.py)."""

from __future__ import annotations

from .. import layers
from ..layers import sequence as seq


def crnn_ctc(img=None, label=None, num_classes=36, image_shape=(1, 32, 128),
             max_label_len=16, hidden=96, is_test=False):
    """conv stack (height -> 1 band) -> columns as sequence -> BiGRU ->
    per-column logits over num_classes+1 (blank last) -> CTC.

    Returns (loss_or_None, logits [B, W', C+1], seqlen [B]) — feed
    `ctc_greedy_decoder(logits, blank, seqlen)` for decoding.
    With is_test=True no loss/label vars are created."""
    if img is None:
        img = layers.data("img", shape=list(image_shape))
    if not is_test and label is None:
        label = layers.data("label", shape=[max_label_len], dtype="int64")

    def block(x, ch, pool_stride):
        x = layers.conv2d(x, num_filters=ch, filter_size=3, padding=1,
                          act="relu")
        return layers.pool2d(x, pool_size=pool_stride,
                             pool_stride=pool_stride)

    # H 32 -> 16 -> 8 -> 4 -> 2; W shrinks only twice (W/4 time steps)
    x = block(img, 32, (2, 2))
    x = block(x, 64, (2, 2))
    x = block(x, 96, (2, 1))
    x = block(x, 96, (2, 1))

    # [B, C, H, W] -> [B, W, C*H]: image columns are the time axis
    b_, c_, h_, w_ = x.shape
    x = layers.transpose(x, perm=[0, 3, 1, 2])
    feat = layers.reshape(x, shape=[-1, w_, c_ * h_])
    seqlen = layers.fill_constant_batch_size_like(
        feat, shape=[-1], dtype="int32", value=w_)
    feat = seq.tag_sequence(feat, seqlen)

    proj_f = seq.tag_sequence(
        layers.fc(feat, size=3 * hidden, num_flatten_dims=2), seqlen)
    proj_b = seq.tag_sequence(
        layers.fc(feat, size=3 * hidden, num_flatten_dims=2), seqlen)
    fwd = seq.dynamic_gru(proj_f, size=hidden)
    bwd = seq.dynamic_gru(proj_b, size=hidden, is_reverse=True)
    rnn = seq.tag_sequence(layers.concat([fwd, bwd], axis=2), seqlen)

    # +1 for the CTC blank, emitted as the LAST class
    logits = layers.fc(rnn, size=num_classes + 1, num_flatten_dims=2)
    logits = seq.tag_sequence(logits, seqlen)

    loss = None
    if not is_test:
        label_len = layers.fill_constant_batch_size_like(
            label, shape=[-1], dtype="int32", value=max_label_len)
        loss = layers.mean(seq.warpctc(logits, label, seqlen, label_len,
                                       blank=num_classes))
    return loss, logits, seqlen
