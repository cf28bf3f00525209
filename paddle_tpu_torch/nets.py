"""Composite networks built from layers (≙ paddle_tpu/nets.py, reference
python/paddle/fluid/nets.py).

`simple_img_conv_pool`, `img_conv_group`, `sequence_conv_pool`, `glu` and
`scaled_dot_product_attention` append the same ops as the JAX package's.
"""

from __future__ import annotations

from . import layers

def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    """conv2d + pool2d (≙ reference nets.py simple_img_conv_pool)."""
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, stride=conv_stride,
                             padding=conv_padding, dilation=conv_dilation,
                             groups=conv_groups, param_attr=param_attr,
                             bias_attr=bias_attr, act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """Stack of convs (+ optional BN/dropout) followed by a pool — the VGG
    building block (≙ reference nets.py img_conv_group)."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _to_list(obj):
        if isinstance(obj, (list, tuple)):
            assert len(obj) == len(conv_num_filter)
            return list(obj)
        return [obj] * len(conv_num_filter)

    conv_padding = _to_list(conv_padding)
    conv_filter_size = _to_list(conv_filter_size)
    param_attr = _to_list(param_attr)
    conv_batchnorm_drop_rate = _to_list(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm:
            local_conv_act = None
        tmp = layers.conv2d(input=tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i], param_attr=param_attr[i],
                            act=local_conv_act)
        if conv_with_batchnorm:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """sequence_conv + sequence_pool (≙ reference nets.py sequence_conv_pool)."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: split in half along dim, a * sigmoid(b)
    (≙ reference nets.py glu)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0, is_test=False):
    """Multi-head scaled dot-product attention over [B, T, C] tensors
    (≙ reference nets.py:332). Returns [B, Tq, C_v].

    The composite form, as in the JAX package: scale, matmul, softmax,
    matmul (the fused flash-attention kernels serve fused_attention).
    """
    if queries.shape[-1] % num_heads != 0:
        raise ValueError("hidden size must divide num_heads")

    def _split_heads(x):
        if num_heads == 1:
            return x
        b, t, c = x.shape
        x = layers.reshape(x, shape=[b if b and b > 0 else -1, t, num_heads,
                                     c // num_heads])
        return layers.transpose(x, perm=[0, 2, 1, 3])

    def _merge_heads(x):
        if num_heads == 1:
            return x
        b, h, t, d = x.shape
        x = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(x, shape=[b if b and b > 0 else -1, t, h * d])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    key_dim = float(int(queries.shape[-1]) // num_heads)
    scaled_q = layers.scale(q, scale=key_dim ** -0.5)
    product = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=is_test)
    ctx = layers.matmul(weights, v)
    return _merge_heads(ctx)
