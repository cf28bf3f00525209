"""Comparison layers.

≙ paddle_tpu/layers/control_flow.py, trimmed to the comparisons the
serving and training slices build: `less_than` (the decode tick's position
mask), `greater_than` and `equal` (the packed LM's loss mask).
"""

from __future__ import annotations

from ..layer_helper import LayerHelper


def _compare(op_type, x, y, cond=None):
    from .math_ops import _broadcast_shape
    helper = LayerHelper(op_type)
    if cond is None:
        # declared shape must be the broadcast of both operands (the old
        # x.shape under-declared broadcast dims — flagged by the static
        # analyzer, framework/analysis.py)
        cond = helper.create_tmp_variable(
            dtype="bool", shape=_broadcast_shape(x.shape, y.shape),
            stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, cond=None):
    return _compare("less_than", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)
