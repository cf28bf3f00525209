"""Operational metrics (≙ paddle_tpu/observability), trimmed to the
metrics registry the trainer counts into."""

from . import metrics  # noqa: F401
