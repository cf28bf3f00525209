"""Weight-decay regularization, as far as `Optimizer.minimize` calls it.

≙ paddle_tpu/regularizer.py `append_regularization_ops`. No regularizer op
is ported yet: gradients pass through unchanged when neither the optimizer
nor a parameter sets a regularizer, and a regularizer raises (ROADMAP.md
port queue item 1b, clip and regularizer ops).
"""

from __future__ import annotations

_NOT_PORTED = ("weight-decay regularization is not ported: ROADMAP.md port "
               "queue item 1b (clip and regularizer ops)")


def append_regularization_ops(params_grads, regularization=None):
    """≙ reference regularizer.py append_regularization_ops."""
    for param, _ in params_grads:
        if getattr(param, "regularizer", None) is not None \
                or regularization is not None:
            raise NotImplementedError(
                f"a regularizer is set for parameter {param.name!r}; "
                + _NOT_PORTED)
    return list(params_grads)
