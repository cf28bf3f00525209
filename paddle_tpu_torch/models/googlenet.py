"""GoogLeNet / Inception-v1 (≙ paddle_tpu/models/googlenet.py,
reference benchmark legacy googlenet config, benchmark/README.md:45-52).

NHWC by default; each inception branch is one conv, the four branches
concatenated on the channel axis; optional bf16 conv inputs.
"""

from __future__ import annotations

from .. import layers


def _conv(input, ch, k, stride=1, padding=0, data_format="NHWC",
          use_bf16=False):
    return layers.conv2d(input, num_filters=ch, filter_size=k, stride=stride,
                         padding=padding, act="relu",
                         data_format=data_format, use_bf16=use_bf16)


def inception(input, c1, c3r, c3, c5r, c5, proj, data_format="NHWC",
              use_bf16=False):
    """One inception module: 1x1 | 1x1->3x3 | 1x1->5x5 | pool->1x1."""
    kw = dict(data_format=data_format, use_bf16=use_bf16)
    b1 = _conv(input, c1, 1, **kw)
    b2 = _conv(_conv(input, c3r, 1, **kw), c3, 3, padding=1, **kw)
    b3 = _conv(_conv(input, c5r, 1, **kw), c5, 5, padding=2, **kw)
    pool = layers.pool2d(input, pool_size=3, pool_stride=1, pool_padding=1,
                         pool_type="max", data_format=data_format)
    b4 = _conv(pool, proj, 1, **kw)
    c_axis = 1 if data_format == "NCHW" else 3
    return layers.concat([b1, b2, b3, b4], axis=c_axis)


_CFG = [
    # (c1, c3r, c3, c5r, c5, proj), with "pool" markers between stages
    (64, 96, 128, 16, 32, 32),     # 3a
    (128, 128, 192, 32, 96, 64),   # 3b
    "pool",
    (192, 96, 208, 16, 48, 64),    # 4a
    (160, 112, 224, 24, 64, 64),   # 4b
    (128, 128, 256, 24, 64, 64),   # 4c
    (112, 144, 288, 32, 64, 64),   # 4d
    (256, 160, 320, 32, 128, 128),  # 4e
    "pool",
    (256, 160, 320, 32, 128, 128),  # 5a
    (384, 192, 384, 48, 128, 128),  # 5b
]


def googlenet_imagenet(img=None, label=None, class_num=1000, is_test=False,
                       data_format="NHWC", use_bf16=False):
    """Returns (avg_loss, accuracy, logits). Aux classifier heads are
    omitted (modern practice; they only mattered for pre-BN optimization)."""
    if img is None:
        shape = [3, 224, 224] if data_format == "NCHW" else [224, 224, 3]
        img = layers.data("img", shape=shape)
    if label is None:
        label = layers.data("label", shape=[1], dtype="int64")

    kw = dict(data_format=data_format, use_bf16=use_bf16)
    x = _conv(img, 64, 7, stride=2, padding=3, **kw)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max", data_format=data_format)
    x = _conv(x, 64, 1, **kw)
    x = _conv(x, 192, 3, padding=1, **kw)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max", data_format=data_format)
    for cfg in _CFG:
        if cfg == "pool":
            x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                              pool_type="max", data_format=data_format)
        else:
            x = inception(x, *cfg, **kw)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True,
                      data_format=data_format)
    x = layers.reshape(x, shape=[-1, 1024])
    x = layers.dropout(x, dropout_prob=0.4, is_test=is_test)
    logits = layers.fc(x, size=class_num, use_bf16=use_bf16)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits
