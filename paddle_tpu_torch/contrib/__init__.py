"""Contrib utilities (≙ paddle_tpu/contrib, reference
python/paddle/fluid/contrib/), trimmed to the beam-search decoder
(`memory_usage_calc` is not ported yet)."""

from .decoder import BeamSearchDecoder, gather_beams  # noqa: F401
