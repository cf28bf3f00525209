"""Model builders (≙ paddle_tpu/models): the Transformer LM and
encoder-decoder, the stacked LSTM, the GRU-attention NMT model, the image
models (ResNet, SE-ResNeXt, VGG, the MNIST nets, AlexNet, GoogLeNet), the
CTR models (DeepFM, Wide&Deep), the SSD detector and the CRNN-CTC text
recognizer."""

from . import (alexnet, deepfm, googlenet,  # noqa: F401
               machine_translation, mnist, ocr_crnn, resnet, se_resnext, ssd,
               stacked_lstm, transformer, vgg)
