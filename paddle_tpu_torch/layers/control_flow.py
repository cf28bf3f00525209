"""Comparison layers.

≙ paddle_tpu/layers/control_flow.py, trimmed to `less_than`, the one
comparison the serving slice builds (the decode tick's position mask).
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

