"""AlexNet (≙ paddle_tpu/models/alexnet.py; capability ≙ reference
benchmark/paddle/image/alexnet.py — the classic 5-conv + 3-fc ImageNet
net the reference benchmarks in benchmark/IntelOptimizedPaddle.md).

The JAX package's construction: NHWC, optional bf16 conv and fc inputs,
local response norm omitted (the conv/fc structure is the classic
5-conv + 3-fc net)."""

from __future__ import annotations

from .. import layers


def alexnet_imagenet(img=None, label=None, class_num=1000, is_test=False,
                     data_format="NHWC", use_bf16=False):
    if img is None:
        shape = [224, 224, 3] if data_format == "NHWC" else [3, 224, 224]
        img = layers.data(name="img", shape=shape)
    if label is None:
        label = layers.data(name="label", shape=[1], dtype="int64")

    def conv(x, ch, k, stride=1, pad=0):
        return layers.conv2d(x, num_filters=ch, filter_size=k, stride=stride,
                             padding=pad, act="relu",
                             data_format=data_format, use_bf16=use_bf16)

    def pool(x):
        return layers.pool2d(x, pool_size=3, pool_type="max", pool_stride=2,
                             data_format=data_format)

    t = pool(conv(img, 64, 11, stride=4, pad=2))
    t = pool(conv(t, 192, 5, pad=2))
    t = conv(t, 384, 3, pad=1)
    t = conv(t, 256, 3, pad=1)
    t = pool(conv(t, 256, 3, pad=1))

    t = layers.dropout(t, dropout_prob=0.5, is_test=is_test)
    t = layers.fc(t, size=4096, act="relu", use_bf16=use_bf16)
    t = layers.dropout(t, dropout_prob=0.5, is_test=is_test)
    t = layers.fc(t, size=4096, act="relu", use_bf16=use_bf16)
    logits = layers.fc(t, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits
