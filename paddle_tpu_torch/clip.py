"""Gradient clipping, as far as `Optimizer.minimize` calls it.

≙ paddle_tpu/clip.py `append_gradient_clip_ops`. No clip op is ported yet:
gradients pass through unchanged when no parameter carries a clip
attribute, and a clip attribute raises (ROADMAP.md port queue item 1b,
clip and regularizer ops).
"""

from __future__ import annotations

_NOT_PORTED = ("gradient clipping is not ported: ROADMAP.md port queue item "
               "1b (clip and regularizer ops)")


def append_gradient_clip_ops(params_grads):
    """≙ reference clip.py append_gradient_clip_ops."""
    for p, _ in params_grads:
        if getattr(p, "gradient_clip", None) is not None:
            raise NotImplementedError(
                f"parameter {p.name!r} has a gradient_clip attribute; "
                + _NOT_PORTED)
    return list(params_grads)
