"""Activation layers.

≙ paddle_tpu/layers/ops.py (generated unary wrappers), trimmed to the
activations the ported models build: `relu` (the LM's ffn), `sigmoid` and
`tanh` (the NMT decoder's GRU cell).
"""

from __future__ import annotations

from ..core.dtypes import dtype_name
from ..layer_helper import LayerHelper


def _make_unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(dtype=dtype_name(x.dtype),
                                         shape=x.shape)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"Elementwise {op_type} (≙ activation_op.cc kernel)."
    return layer


relu = _make_unary("relu")
sigmoid = _make_unary("sigmoid")
tanh = _make_unary("tanh")
