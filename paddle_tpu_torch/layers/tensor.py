"""Tensor-creation/manipulation layers.

≙ paddle_tpu/layers/tensor.py (reference python/paddle/fluid/layers/tensor.py),
trimmed to the serving slice: cast, assign, fill_constant, argmax.
"""

from __future__ import annotations

import numpy as np

from ..core.dtypes import convert_dtype, dtype_name
from ..layer_helper import LayerHelper


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = dtype_name(convert_dtype(dtype))
    out = helper.create_tmp_variable(dtype=dtype, shape=x.shape)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": dtype})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_tmp_variable(
                dtype=dtype_name(input.dtype), shape=list(input.shape))
        helper.append_op(type="assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(input.shape),
                                "dtype": dtype_name(input.dtype),
                                "values": input.reshape(-1).tolist()})
        return output
    if output is None:
        output = helper.create_tmp_variable(dtype=dtype_name(input.dtype),
                                            shape=input.shape)
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    dtype = dtype_name(convert_dtype(dtype))
    if out is None:
        out = helper.create_tmp_variable(dtype=dtype, shape=list(shape),
                                         stop_gradient=True)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    out.stop_gradient = True
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    shape = list(x.shape)
    shape.pop(axis if axis >= 0 else len(shape) + axis)
    out = helper.create_tmp_variable(dtype="int64", shape=shape,
                                     stop_gradient=True)
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out

