"""Fused ops with hand-written kernels (≙ paddle_tpu/fusion)."""

from .decode_attention import (decode_attention_cuda,  # noqa: F401
                               decode_attention_plain, fused_decode_attention)
