"""Activation layers.

≙ paddle_tpu/layers/ops.py (generated unary wrappers), trimmed to the
activations the ported models build: `relu` (the LM's ffn), `sigmoid` and
`tanh` (the NMT decoder's GRU cell), and the unary ops of the
learning-rate schedules and the regularizers: `exp`, `sqrt`, `ceil`,
`floor`, `cos`, `reciprocal`, `sign` and `pow` (with its `factor`).
"""

from __future__ import annotations

from ..core.dtypes import dtype_name
from ..layer_helper import LayerHelper


def _make_unary(op_type, **defaults):
    def layer(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(dtype=dtype_name(x.dtype),
                                         shape=x.shape)
        attrs = {**defaults, **kwargs}
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"Elementwise {op_type} (≙ activation_op.cc kernel)."
    return layer


relu = _make_unary("relu")
sigmoid = _make_unary("sigmoid")
tanh = _make_unary("tanh")
exp = _make_unary("exp")
sqrt = _make_unary("sqrt")
ceil = _make_unary("ceil")
floor = _make_unary("floor")
cos = _make_unary("cos")
reciprocal = _make_unary("reciprocal")
sign = _make_unary("sign")
pow = _make_unary("pow", factor=1.0)
