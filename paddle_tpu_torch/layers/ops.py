"""Activation layers.

≙ paddle_tpu/layers/ops.py (generated unary wrappers), trimmed to `relu`,
the one activation the serving slice builds (the LM's ffn).
"""

from __future__ import annotations

from ..core.dtypes import dtype_name
from ..layer_helper import LayerHelper


def relu(x, name=None):
    """Elementwise relu (≙ activation_op.cc kernel)."""
    helper = LayerHelper("relu", name=name)
    out = helper.create_tmp_variable(dtype=dtype_name(x.dtype),
                                     shape=x.shape)
    helper.append_op(type="relu", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out
