"""VGG (≙ paddle_tpu/models/vgg.py, reference
benchmark/fluid/models/vgg.py — the conv_block/img_conv_group
construction). NCHW, with batch_norm on the 2-D fc output under
data_layout="NHWC" (the channel axis is the last)."""

from __future__ import annotations

from .. import layers, nets

_CFG = {
    11: [1, 1, 2, 2, 2],
    13: [2, 2, 2, 2, 2],
    16: [2, 2, 3, 3, 3],
    19: [2, 2, 4, 4, 4],
}


def vgg(img=None, label=None, depth=16, class_num=1000, image_shape=None,
        with_batchnorm=True, is_test=False, fc_size=4096):
    """VGG-{11,13,16,19}. Reference uses img_conv_group stacks of 3x3 convs
    + BN + dropout, then two 4096 fc layers."""
    if img is None:
        img = layers.data(name="img", shape=image_shape or [3, 224, 224])
    if label is None:
        label = layers.data(name="label", shape=[1], dtype="int64")
    counts = _CFG[depth]
    chans = [64, 128, 256, 512, 512]
    tmp = img
    for n, ch in zip(counts, chans):
        tmp = nets.img_conv_group(
            input=tmp, conv_num_filter=[ch] * n, pool_size=2, pool_stride=2,
            conv_filter_size=3, conv_act="relu",
            conv_with_batchnorm=with_batchnorm,
            conv_batchnorm_drop_rate=0.0)
    drop = layers.dropout(tmp, dropout_prob=0.5, is_test=is_test)
    fc1 = layers.fc(drop, size=fc_size, act=None)
    bn = layers.batch_norm(fc1, act="relu", is_test=is_test,
                           data_layout="NHWC")
    drop2 = layers.dropout(bn, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(drop2, size=fc_size, act=None)
    logits = layers.fc(fc2, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits


def vgg16_cifar(img=None, label=None, class_num=10, is_test=False):
    return vgg(img=img, label=label, depth=16, class_num=class_num,
               image_shape=[3, 32, 32], is_test=is_test, fc_size=512)
