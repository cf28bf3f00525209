"""Input pipelines (≙ paddle_tpu/data), trimmed to batch packing."""

from .packing import pack_lm_batch, pack_sequences  # noqa: F401
