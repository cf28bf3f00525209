"""Model builders (≙ paddle_tpu/models), trimmed to the serving slice."""

from . import transformer  # noqa: F401
