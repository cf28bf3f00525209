"""Activation layers.

≙ paddle_tpu/layers/ops.py (generated unary wrappers): every activation
and unary op of the JAX package's layers, with the same attribute
defaults (`leaky_relu`'s alpha 0.02, `brelu`'s [0, 24]), `maxout` and
`prelu` (its alpha a parameter, 0.25 at start).
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
logsigmoid = _make_unary("logsigmoid")
tanh_shrink = _make_unary("tanh_shrink")
rsqrt = _make_unary("rsqrt")
abs = _make_unary("abs")
sin = _make_unary("sin")
round = _make_unary("round")
log = _make_unary("log")
square = _make_unary("square")
relu6 = _make_unary("relu6")
softplus = _make_unary("softplus")
softsign = _make_unary("softsign")
gelu = _make_unary("gelu")
silu = _make_unary("silu")
leaky_relu = _make_unary("leaky_relu", alpha=0.02)
elu = _make_unary("elu", alpha=1.0)
hard_sigmoid = _make_unary("hard_sigmoid", slope=0.2, offset=0.5)
swish = _make_unary("swish", beta=1.0)
brelu = _make_unary("brelu", t_min=0.0, t_max=24.0)
soft_shrink = _make_unary("soft_shrink", **{"lambda": 0.5})
hard_shrink = _make_unary("hard_shrink", threshold=0.5)
thresholded_relu = _make_unary("thresholded_relu", threshold=1.0)


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    n, c, h, w = x.shape
    out = helper.create_tmp_variable(dtype=dtype_name(x.dtype),
                                     shape=[n, c // groups, h, w])
    helper.append_op(type="maxout", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"groups": groups})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    from ..initializer import ConstantInitializer
    helper = LayerHelper("prelu", name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        param_attr, shape=alpha_shape, dtype=dtype_name(x.dtype),
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_tmp_variable(dtype=dtype_name(x.dtype), shape=x.shape)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out
