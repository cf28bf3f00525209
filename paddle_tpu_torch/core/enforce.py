"""Typed error enforcement.

≙ paddle_tpu/core/enforce.py (the reference's PADDLE_ENFORCE family,
platform/enforce.h:253): structured error types with contextual messages.
"""

from __future__ import annotations


class EnforceError(RuntimeError):
    """Base error for framework invariant violations (≙ platform::EnforceNotMet)."""


class InvalidArgumentError(EnforceError):
    pass


class NotFoundError(EnforceError):
    pass


class OutOfRangeError(EnforceError):
    pass


class AlreadyExistsError(EnforceError):
    pass


class UnavailableError(EnforceError):
    pass


def enforce(cond, msg="enforce failed", *args, exc=EnforceError):
    """Assert `cond` and raise a typed framework error otherwise.

    ≙ PADDLE_ENFORCE(cond, fmt, ...) (reference platform/enforce.h:253).
    """
    if not cond:
        raise exc(msg % args if args else msg)
    return cond
