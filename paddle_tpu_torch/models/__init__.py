"""Model builders (≙ paddle_tpu/models), trimmed to the ported slices:
the Transformer LM and encoder-decoder, the stacked LSTM, the
GRU-attention NMT model and the image models (ResNet, SE-ResNeXt, VGG,
the MNIST nets, AlexNet, GoogLeNet)."""

from . import (alexnet, googlenet, machine_translation,  # noqa: F401
               mnist, resnet, se_resnext, stacked_lstm, transformer, vgg)
