"""Serving (≙ paddle_tpu/serving), trimmed to the slot engine."""

from .engine import (ContinuousBatchingEngine, GenRequest,  # noqa: F401
                     SlotAllocator)
