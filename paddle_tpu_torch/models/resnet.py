"""ResNet (≙ paddle_tpu/models/resnet.py, reference
benchmark/fluid/models/resnet.py).

The same program as the JAX package's: NHWC by default (on the card an
NHWC conv runs as cuDNN's channels_last kernels, ops/nn_ops.py), bfloat16
conv inputs with float32 accumulation through the layers' use_bf16, and
batch_norm(is_test=True) for inference from the running statistics.
"""

from __future__ import annotations

from .. import layers


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False, data_format="NHWC", use_bf16=False):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False,
                         data_format=data_format, use_bf16=use_bf16)
    return layers.batch_norm(input=conv, act=act, is_test=is_test,
                             data_layout=data_format)


def _shortcut(input, ch_out, stride, is_test, data_format, use_bf16):
    c_axis = 1 if data_format == "NCHW" else 3
    ch_in = input.shape[c_axis]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test, data_format=data_format,
                             use_bf16=use_bf16)
    return input


def bottleneck_block(input, ch_out, stride, is_test=False,
                     data_format="NHWC", use_bf16=False):
    short = _shortcut(input, ch_out * 4, stride, is_test, data_format,
                      use_bf16)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test,
                          data_format=data_format, use_bf16=use_bf16)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test,
                          data_format=data_format, use_bf16=use_bf16)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test, data_format=data_format,
                          use_bf16=use_bf16)
    return layers.relu(layers.elementwise_add(short, conv3))


def basic_block(input, ch_out, stride, is_test=False, data_format="NHWC",
                use_bf16=False):
    short = _shortcut(input, ch_out, stride, is_test, data_format, use_bf16)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test,
                          data_format=data_format, use_bf16=use_bf16)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test,
                          data_format=data_format, use_bf16=use_bf16)
    return layers.relu(layers.elementwise_add(short, conv2))


_DEPTH = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def resnet_imagenet(img=None, label=None, depth=50, class_num=1000,
                    is_test=False, data_format="NHWC", use_bf16=True):
    """ResNet-{18,34,50,101,152} for 224x224 inputs; ResNet-50 is the JAX
    package's own benchmark model (bench.py)."""
    if img is None:
        shape = [3, 224, 224] if data_format == "NCHW" else [224, 224, 3]
        img = layers.data(name="img", shape=shape)
    if label is None:
        label = layers.data(name="label", shape=[1], dtype="int64")
    kind, counts = _DEPTH[depth]
    block = bottleneck_block if kind == "bottleneck" else basic_block

    conv1 = conv_bn_layer(img, 64, 7, 2, 3, is_test=is_test,
                          data_format=data_format, use_bf16=use_bf16)
    pool1 = layers.pool2d(conv1, pool_size=3, pool_stride=2, pool_padding=1,
                          pool_type="max", data_format=data_format)
    res = pool1
    for stage, n in enumerate(counts):
        ch = 64 * (2 ** stage)
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            res = block(res, ch, stride, is_test=is_test,
                        data_format=data_format, use_bf16=use_bf16)
    pool2 = layers.pool2d(res, pool_type="avg", global_pooling=True,
                          data_format=data_format)
    logits = layers.fc(pool2, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits


def resnet_cifar10(img=None, label=None, depth=32, class_num=10,
                   is_test=False, data_format="NHWC", use_bf16=False):
    """ResNet for 32x32 cifar inputs (≙ reference benchmark/fluid resnet
    cifar10 flavor; depth = 6n+2)."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    if img is None:
        shape = [3, 32, 32] if data_format == "NCHW" else [32, 32, 3]
        img = layers.data(name="img", shape=shape)
    if label is None:
        label = layers.data(name="label", shape=[1], dtype="int64")
    conv1 = conv_bn_layer(img, 16, 3, 1, 1, is_test=is_test,
                          data_format=data_format, use_bf16=use_bf16)
    res = conv1
    for stage, ch in enumerate([16, 32, 64]):
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            res = basic_block(res, ch, stride, is_test=is_test,
                              data_format=data_format, use_bf16=use_bf16)
    pool = layers.pool2d(res, pool_type="avg", global_pooling=True,
                         data_format=data_format)
    logits = layers.fc(pool, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits
