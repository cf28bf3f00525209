"""Quantization-aware-training transpiler.

≙ paddle_tpu/transpiler/quantize_transpiler.py (reference
fake_quantize_op.cc / fake_dequantize_op.cc with the transpilers'
program-rewrite pattern): fake-quant ops (quantize → dequantize with a
straight-through gradient) go on the activation and weight inputs of
matmul-bearing ops, so training sees int8 rounding while gradients flow;
`freeze_program` bakes each weight's rounding and scale into the stored
weights for inference (the train → freeze flow). The rewritten programs
are the JAX package's, op for op, but for one flag: a quantized var is
differentiable where its source is, so training reaches every weight
(ROADMAP.md §3, not copied).

The freeze rounds in float64 on the host, as the JAX package does (one
read of each weight), and writes each frozen weight back as a float32
tensor on the device of the value it replaces, its scale beside it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..framework.program import Program
from ..framework.scope import Scope, global_scope

_QUANTIZABLE = ("conv2d", "depthwise_conv2d", "mul", "matmul")
# slot holding the weight operand per op type
_WEIGHT_SLOT = {"conv2d": "Filter", "depthwise_conv2d": "Filter",
                "mul": "Y", "matmul": "Y"}
_ACT_SLOT = {"conv2d": "Input", "depthwise_conv2d": "Input",
             "mul": "X", "matmul": "X"}


class QuantizeTranspiler:
    """Insert fake-quant ops for QAT; freeze for inference.

    ≙ the reference's fake_quantize/fake_dequantize op pair wired by a
    program rewrite.
    """

    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 activation_quantize_type: str = "abs_max",
                 weight_quantize_type: str = "abs_max",
                 moving_rate: float = 0.9):
        if activation_quantize_type not in ("abs_max",
                                            "moving_average_abs_max"):
            raise ValueError(
                f"unsupported activation_quantize_type "
                f"{activation_quantize_type!r}")
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.activation_quantize_type = activation_quantize_type
        self.weight_quantize_type = weight_quantize_type
        self.moving_rate = moving_rate

    # -- QAT rewrite -------------------------------------------------------

    def training_transpile(self, program: Optional[Program] = None,
                           startup_program: Optional[Program] = None):
        """Rewrite `program` in place: every quantizable op's activation and
        weight inputs go through a fake_quantize op first."""
        from ..framework.program import default_main_program
        program = program or default_main_program()
        if any(op.type == "vjp_region"
               for b in program.blocks for op in b.ops):
            raise RuntimeError(
                "training_transpile must run BEFORE optimizer.minimize()/"
                "append_backward — inserting quant ops after autodiff would "
                "invalidate the recorded forward segment")
        return self._rewrite_clean(program, startup_program)

    def _rewrite_clean(self, program: Program,
                       startup_program: Optional[Program] = None) -> Program:
        from ..framework.program import Operator
        block = program.global_block()
        new_ops = []
        quantized: dict = {}
        for op in block.ops:
            if op.type in _QUANTIZABLE and not op.attrs.get("skip_quant") \
                    and not op.attrs.get("quantized"):
                for slot, bits, kind in (
                        (_ACT_SLOT[op.type], self.activation_bits,
                         self.activation_quantize_type),
                        (_WEIGHT_SLOT[op.type], self.weight_bits,
                         self.weight_quantize_type)):
                    name = op.inputs[slot][0]
                    key = (name, bits, kind)
                    if key not in quantized:
                        src = block.vars.get(name)
                        qname = name + ".quantized"
                        sname = name + ".quant_scale"
                        if not block.has_var(qname):
                            # differentiable where its source is: the
                            # straight-through gradient reaches the weight
                            # and the layers below (the JAX package keeps
                            # the Variable default, stop_gradient=True,
                            # and autodiff stops at every fake-quant op)
                            block.create_var(
                                name=qname,
                                shape=None if src is None else src.shape,
                                dtype="float32" if src is None else src.dtype,
                                stop_gradient=True if src is None
                                else src.stop_gradient)
                        if not block.has_var(sname):
                            block.create_var(name=sname, shape=[],
                                             dtype="float32",
                                             stop_gradient=True)
                        qtype = ("fake_quantize_abs_max"
                                 if kind == "abs_max" else
                                 "fake_quantize_moving_average_abs_max")
                        if qtype == "fake_quantize_moving_average_abs_max":
                            # the scale var doubles as the moving-average
                            # state: same persistable var in and out, so the
                            # executor's state write-back advances it (same
                            # pattern as batch-norm moving stats)
                            block.vars[sname].persistable = True
                            qop = Operator(
                                block, qtype,
                                inputs={"X": [name], "InScale": [sname]},
                                outputs={"Out": [qname], "OutScale": [sname]},
                                attrs={"bit_length": bits,
                                       "moving_rate": self.moving_rate,
                                       "op_role": op.attrs.get("op_role")})
                            from ..framework.program import \
                                default_startup_program
                            sp = startup_program or default_startup_program()
                            spb = sp.global_block()
                            if not spb.has_var(sname):
                                spb.create_var(name=sname, shape=[],
                                               dtype="float32",
                                               persistable=True)
                                spb.append_op(
                                    type="fill_constant", inputs={},
                                    outputs={"Out": [sname]},
                                    attrs={"shape": [], "dtype": "float32",
                                           "value": 0.0})
                        else:
                            qop = Operator(
                                block, qtype,
                                inputs={"X": [name]},
                                outputs={"Out": [qname],
                                         "OutScale": [sname]},
                                attrs={"bit_length": bits,
                                       "op_role": op.attrs.get("op_role")})
                        new_ops.append(qop)
                        quantized[key] = qname
                    op.inputs[slot] = [quantized[key]]
                op.attrs["quantized"] = True
            new_ops.append(op)
        block.ops[:] = new_ops
        program._bump()
        return program

    # -- freeze ------------------------------------------------------------

    def freeze_program(self, program: Program, place=None,
                       scope: Scope = None) -> Program:
        """Bake weight quantization into stored weights for inference
        (≙ the reference freeze flow: weights become their rounded values,
        activation fake-quant stays as calibrated scale ops)."""
        scope = scope or global_scope()
        block = program.global_block()
        bnt = (1 << (self.weight_bits - 1)) - 1
        for op in block.ops:
            if op.type != "fake_quantize_abs_max":
                continue
            name = op.inputs["X"][0]
            if not scope.has_var(name):
                continue  # activation, not a stored weight
            ref = scope.get(name)
            w = ref.detach().cpu().double().numpy()
            s = np.abs(w).max()
            inv = bnt / max(s, 1e-12)
            scope.set_var(name, torch.from_numpy(
                (np.round(w * inv) / inv).astype(np.float32)).to(ref.device))
            scope.set_var(op.outputs["OutScale"][0], torch.from_numpy(
                np.asarray(s, dtype=np.float32)).to(ref.device))
        program._bump()
        return program
