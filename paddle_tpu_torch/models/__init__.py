"""Model builders (≙ paddle_tpu/models), trimmed to the ported slices:
the Transformer LM, the stacked LSTM and the GRU-attention NMT model."""

from . import machine_translation, stacked_lstm, transformer  # noqa: F401
