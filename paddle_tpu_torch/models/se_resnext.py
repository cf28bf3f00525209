"""SE-ResNeXt (≙ paddle_tpu/models/se_resnext.py, reference tests
dist_se_resnext.py / test_parallel_executor_seresnext.py model family).

NHWC by default; each block's grouped 3x3 conv is one conv op with
`groups` = cardinality (one cuDNN grouped conv on the card), and the
squeeze-excitation gate is two small fc layers on the globally pooled
features.
"""

from __future__ import annotations

from .. import layers
from .resnet import conv_bn_layer


def squeeze_excitation(input, num_channels, reduction_ratio=16,
                       data_format="NHWC", name=None):
    """Global-pool -> bottleneck MLP -> channel gate (the SE block)."""
    pool = layers.pool2d(input, pool_type="avg", global_pooling=True,
                         data_format=data_format)
    pool = layers.reshape(pool, shape=[-1, num_channels])
    squeeze = layers.fc(pool, size=max(num_channels // reduction_ratio, 4),
                        act="relu", name=name and name + "_sq")
    excite = layers.fc(squeeze, size=num_channels, act="sigmoid",
                       name=name and name + "_ex")
    shape = [-1, 1, 1, num_channels] if data_format == "NHWC" \
        else [-1, num_channels, 1, 1]
    gate = layers.reshape(excite, shape=shape)
    return layers.elementwise_mul(input, gate)


def bottleneck_block(input, num_filters, stride, cardinality=32,
                     reduction_ratio=16, is_test=False, data_format="NHWC",
                     use_bf16=False, name=None):
    ch_out = num_filters * 2
    conv1 = conv_bn_layer(input, num_filters, 1, 1, 0, is_test=is_test,
                          data_format=data_format, use_bf16=use_bf16)
    conv2 = layers.conv2d(conv1, num_filters=num_filters, filter_size=3,
                          stride=stride, padding=1, groups=cardinality,
                          act=None, bias_attr=False, data_format=data_format,
                          use_bf16=use_bf16)
    conv2 = layers.batch_norm(conv2, act="relu", is_test=is_test,
                              data_layout=data_format)
    conv3 = conv_bn_layer(conv2, ch_out, 1, 1, 0, act=None, is_test=is_test,
                          data_format=data_format, use_bf16=use_bf16)
    scaled = squeeze_excitation(conv3, ch_out,
                                reduction_ratio=reduction_ratio,
                                data_format=data_format, name=name)
    c_axis = 1 if data_format == "NCHW" else 3
    if input.shape[c_axis] != ch_out or stride != 1:
        short = conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                              is_test=is_test, data_format=data_format,
                              use_bf16=use_bf16)
    else:
        short = input
    return layers.relu(layers.elementwise_add(short, scaled))


_DEPTH = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def se_resnext_imagenet(img=None, label=None, depth=50, class_num=1000,
                        cardinality=32, reduction_ratio=16, is_test=False,
                        data_format="NHWC", use_bf16=False):
    """Returns (avg_loss, accuracy, logits); creates img/label data vars if
    not supplied (≙ dist_se_resnext.py SE_ResNeXt.net)."""
    if img is None:
        shape = [3, 224, 224] if data_format == "NCHW" else [224, 224, 3]
        img = layers.data("img", shape=shape)
    if label is None:
        label = layers.data("label", shape=[1], dtype="int64")

    depths = _DEPTH[depth]
    num_filters = [128, 256, 512, 1024]

    conv = conv_bn_layer(img, 64, 7, 2, 3, is_test=is_test,
                         data_format=data_format, use_bf16=use_bf16)
    conv = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max", data_format=data_format)
    for block, n in enumerate(depths):
        for i in range(n):
            conv = bottleneck_block(
                conv, num_filters[block],
                stride=2 if i == 0 and block != 0 else 1,
                cardinality=cardinality, reduction_ratio=reduction_ratio,
                is_test=is_test, data_format=data_format, use_bf16=use_bf16,
                name=f"se{block}_{i}")
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True,
                         data_format=data_format)
    pool = layers.reshape(pool, shape=[-1, num_filters[-1] * 2])
    drop = layers.dropout(pool, dropout_prob=0.2, is_test=is_test)
    logits = layers.fc(drop, size=class_num, use_bf16=use_bf16)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits
