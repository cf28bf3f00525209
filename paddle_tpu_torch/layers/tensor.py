"""Tensor-creation/manipulation layers.

≙ paddle_tpu/layers/tensor.py (reference python/paddle/fluid/layers/tensor.py),
every layer of the JAX package's tensor.py: create_tensor, cast, assign,
concat, sums, fill_constant, fill_constant_batch_size_like, ones, zeros,
zeros_like, reverse, argmax, argmin, argsort.
"""

from __future__ import annotations

import numpy as np

from ..core.dtypes import convert_dtype, dtype_name
from ..layer_helper import LayerHelper


def create_tensor(dtype="float32", name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = dtype_name(convert_dtype(dtype))
    out = helper.create_tmp_variable(dtype=dtype, shape=x.shape)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": dtype})
    return out


def sums(input, out=None):
    """The n-ary add of `input`'s variables (one `sum` op)."""
    helper = LayerHelper("sums")
    if out is None:
        out = helper.create_tmp_variable(dtype=dtype_name(input[0].dtype),
                                         shape=input[0].shape)
    helper.append_op(type="sum", inputs={"X": list(input)},
                     outputs={"Out": [out]})
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


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    shapes = [v.shape for v in input]
    out_shape = list(shapes[0])
    if all(s is not None for s in shapes):
        ax = axis if axis >= 0 else len(out_shape) + axis
        if all(s[ax] != -1 for s in shapes):
            out_shape[ax] = sum(s[ax] for s in shapes)
        else:
            out_shape[ax] = -1
    out = helper.create_tmp_variable(dtype=dtype_name(input[0].dtype),
                                     shape=out_shape)
    helper.append_op(type="concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    dtype = dtype_name(convert_dtype(dtype))
    out_shape = list(shape)
    out_shape[output_dim_idx] = -1
    out = helper.create_tmp_variable(dtype=dtype, shape=out_shape,
                                     stop_gradient=True)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
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



def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_tmp_variable(dtype=dtype_name(x.dtype),
                                         shape=x.shape, stop_gradient=True)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_tmp_variable(dtype=dtype_name(x.dtype), shape=x.shape)
    axis = [axis] if isinstance(axis, int) else list(axis)
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    shape = list(x.shape)
    shape.pop(axis if axis >= 0 else len(shape) + axis)
    out = helper.create_tmp_variable(dtype="int64", shape=shape,
                                     stop_gradient=True)
    helper.append_op(type="arg_min", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argsort(x, axis=-1):
    helper = LayerHelper("argsort")
    out = helper.create_tmp_variable(dtype=dtype_name(x.dtype), shape=x.shape,
                                     stop_gradient=True)
    ids = helper.create_tmp_variable(dtype="int64", shape=x.shape,
                                     stop_gradient=True)
    helper.append_op(type="argsort", inputs={"X": [x]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis})
    return out, ids
