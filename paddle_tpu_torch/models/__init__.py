"""Model builders (≙ paddle_tpu/models), trimmed to the ported slices:
the Transformer LM and encoder-decoder, the stacked LSTM, the
GRU-attention NMT model, the image models (ResNet, SE-ResNeXt, VGG, the
MNIST nets, AlexNet, GoogLeNet) and the CTR models (DeepFM, Wide&Deep)."""

from . import (alexnet, deepfm, googlenet,  # noqa: F401
               machine_translation, mnist, resnet, se_resnext, stacked_lstm,
               transformer, vgg)
