"""Contrib utilities (≙ paddle_tpu/contrib, reference
python/paddle/fluid/contrib/): the beam-search decoder and the static
memory estimate."""

from .decoder import BeamSearchDecoder, gather_beams  # noqa: F401
from .memory_usage_calc import memory_usage  # noqa: F401
