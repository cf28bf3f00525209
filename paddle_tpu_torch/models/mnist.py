"""MNIST models (≙ paddle_tpu/models/mnist.py, reference
benchmark/fluid/models/mnist.py + tests/book/test_recognize_digits.py)."""

from __future__ import annotations

from .. import layers, nets


def mlp(img=None, label=None, hidden_sizes=(128, 64), class_num=10):
    """Plain MLP."""
    if img is None:
        img = layers.data(name="img", shape=[784])
    if label is None:
        label = layers.data(name="label", shape=[1], dtype="int64")
    h = img
    for size in hidden_sizes:
        h = layers.fc(h, size=size, act="relu")
    logits = layers.fc(h, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits


def conv_net(img=None, label=None, class_num=10):
    """LeNet-style conv net (≙ reference benchmark/fluid/models/mnist.py
    cnn_model)."""
    if img is None:
        img = layers.data(name="img", shape=[1, 28, 28])
    if label is None:
        label = layers.data(name="label", shape=[1], dtype="int64")
    conv1 = nets.simple_img_conv_pool(input=img, filter_size=5,
                                      num_filters=20, pool_size=2,
                                      pool_stride=2, act="relu")
    conv2 = nets.simple_img_conv_pool(input=conv1, filter_size=5,
                                      num_filters=50, pool_size=2,
                                      pool_stride=2, act="relu")
    logits = layers.fc(conv2, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits
