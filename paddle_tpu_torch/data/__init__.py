"""Input pipelines (≙ paddle_tpu/data), trimmed to the reader decorators,
the DataFeeder and batch packing."""

from .decorator import (batch, buffered, chain, compose, firstn,  # noqa: F401
                        map_readers, shuffle, xmap_readers)
from .feeder import DataFeeder  # noqa: F401
from .packing import pack_lm_batch, pack_sequences  # noqa: F401
