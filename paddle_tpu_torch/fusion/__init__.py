"""Fused ops with hand-written kernels (≙ paddle_tpu/fusion)."""

from .decode_attention import (QUANT_KV_BLOCK_T,  # noqa: F401
                               decode_attention_cuda, decode_attention_plain,
                               dequantize_kv_time_blocks,
                               fused_decode_attention,
                               quantize_kv_time_blocks)
from .recurrent import (fused_gru_sequence,  # noqa: F401
                        fused_lstm_sequence)
