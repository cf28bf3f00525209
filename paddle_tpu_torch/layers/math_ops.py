"""The scale layer, Variable arithmetic and the declared-shape broadcast
rule.

≙ paddle_tpu/layers/math_ops.py (reference python/paddle/fluid/layers/
math_op_patch.py: Variable's + - * / dispatch here), without the
comparison operators.
"""

from __future__ import annotations

import numbers

from ..core.dtypes import dtype_name
from ..layer_helper import LayerHelper


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_tmp_variable(dtype=dtype_name(x.dtype), shape=x.shape)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def _broadcast_shape(sa, sb):
    """Declared shape of a trailing-aligned elementwise result. The old
    rule ("higher-rank operand wins") under-declared broadcast dims of the
    equal-rank case — e.g. [1, 1, T] < [S, 1, 1] really yields [S, 1, T] —
    which the static analyzer (framework/analysis.py) flags as a
    declared-shape lie. -1 (batch) dims broadcast like any size but stay
    symbolic in the result."""
    if not sa or not sb:
        return sa if sa else sb
    ra, rb = len(sa), len(sb)
    out = []
    for i in range(max(ra, rb)):
        da = sa[ra - 1 - i] if i < ra else 1
        db = sb[rb - 1 - i] if i < rb else 1
        if da == db:
            out.append(da)
        elif da == 1:
            out.append(db)
        elif db == 1:
            out.append(da)
        elif -1 in (da, db):
            out.append(-1)
        else:
            out.append(da)    # incompatible: runtime raises; keep a's view
    out.reverse()
    return tuple(out)


def _fill_like_scalar(x, value):
    from . import tensor as tensor_layers
    return tensor_layers.fill_constant(shape=[1], dtype=dtype_name(x.dtype),
                                       value=float(value))


def elementwise_binary_dispatch(x, other, op_type, reverse=False):
    """Implements Variable.__add__ & co. A number operand folds into a
    `scale` op where it can, as in the JAX package."""
    if isinstance(other, numbers.Number):
        if not reverse:
            if op_type == "elementwise_add":
                return scale(x, 1.0, float(other))
            if op_type == "elementwise_sub":
                return scale(x, 1.0, -float(other))
            if op_type == "elementwise_mul":
                return scale(x, float(other))
            if op_type == "elementwise_div":
                return scale(x, 1.0 / float(other))
        elif op_type == "elementwise_sub":  # other - x
            return scale(x, -1.0, float(other))
        other = _fill_like_scalar(x, other)
    a, b = (other, x) if reverse else (x, other)
    helper = LayerHelper(op_type)
    out = helper.create_tmp_variable(dtype=dtype_name(a.dtype),
                                     shape=_broadcast_shape(a.shape, b.shape),
                                     stop_gradient=False)
    helper.append_op(type=op_type, inputs={"X": [a], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out
