"""LayerHelper — shared plumbing for layer functions.

≙ paddle_tpu/layer_helper.py (reference python/paddle/fluid/layer_helper.py): creates parameters in BOTH
the main program (as Parameter vars) and the startup program (var + init op),
creates temporaries, appends ops, and applies bias/activation.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .core import unique_name
from .core.dtypes import dtype_name
from .core.enforce import InvalidArgumentError, enforce
from .framework.program import (Parameter, Variable, default_main_program,
                                default_startup_program)
from .initializer import (_global_bias_initializer,
                          _global_weight_initializer)
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
        self.name = kwargs.get("name") or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    # -- parameters -------------------------------------------------------
    def create_parameter(self, attr, shape: Sequence[int], dtype="float32",
                         is_bias: bool = False,
                         default_initializer=None) -> Parameter:
        attr = ParamAttr._to_attr(attr)
        enforce(attr is not None, "parameter attr must not be False here",
                exc=InvalidArgumentError)
        name = attr.name or unique_name.generate(f"{self.name}.w")
        init = attr.initializer or default_initializer or (
            _global_bias_initializer() if is_bias
            else _global_weight_initializer())
        main_block = self.main_program.global_block()
        if name in main_block.vars:
            # shared parameter (attr.name reused) — return existing
            return main_block.vars[name]
        p = main_block.create_parameter(
            name=name, shape=list(shape), dtype=dtype,
            trainable=attr.trainable, regularizer=attr.regularizer,
            gradient_clip=attr.gradient_clip)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        if attr.sharding_spec is not None:
            p.sharding_spec = tuple(attr.sharding_spec)
        # mirror into startup program with its initializer op
        sb = self.startup_program.global_block()
        if name not in sb.vars:
            sv = sb.create_parameter(name=name, shape=list(shape),
                                     dtype=dtype, trainable=attr.trainable)
            init(sv, sb)
        return p

    # -- temporaries ------------------------------------------------------
    def create_tmp_variable(self, dtype="float32", shape=None,
                            stop_gradient: bool = False) -> Variable:
        return self.block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            shape=shape, dtype=dtype, stop_gradient=stop_gradient)

    def create_variable(self, name=None, persistable=False, dtype="float32",
                        shape=None) -> Variable:
        return self.block.create_var(name=name, shape=shape, dtype=dtype,
                                     persistable=persistable)

    def create_global_variable(self, name=None, persistable=True,
                               dtype="float32", shape=None,
                               stop_gradient=True) -> Variable:
        return self.main_program.global_block().create_var(
            name=name or unique_name.generate(f"{self.name}.global"),
            shape=shape, dtype=dtype, persistable=persistable,
            stop_gradient=stop_gradient)

    def append_op(self, **kwargs):
        return self.block.append_op(
            kwargs["type"], kwargs.get("inputs"), kwargs.get("outputs"),
            kwargs.get("attrs"))

    # -- bias / activation (≙ LayerHelper.append_bias_op/append_activation) --
    def append_bias_op(self, input_var: Variable, dim_start: int = 1,
                       dim_end: Optional[int] = None,
                       use_bf16: bool = False) -> Variable:
        bias_attr = ParamAttr._to_attr(self.kwargs.get("bias_attr"))
        if bias_attr is None:
            return input_var
        size = input_var.shape[dim_start:dim_end]
        b = self.create_parameter(bias_attr, shape=list(size),
                                  dtype=dtype_name(input_var.dtype),
                                  is_bias=True)
        out = self.create_tmp_variable(dtype=dtype_name(input_var.dtype),
                                       shape=input_var.shape)
        # use_bf16: the add casts the fp32 bias down to the activation dtype
        # instead of promoting the whole tensor back to fp32
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [out]},
                       attrs={"axis": dim_start, "use_bf16": use_bf16})
        return out

    def append_activation(self, input_var: Variable) -> Variable:
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        out = self.create_tmp_variable(dtype=dtype_name(input_var.dtype),
                                       shape=input_var.shape)
        self.append_op(type=act, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs={})
        return out
