"""Inference transpiler: fold batch-norm into the preceding conv/fc.

≙ paddle_tpu/transpiler/inference_transpiler.py (reference python/paddle/
fluid/transpiler/inference_transpiler.py:24), which rewrites an inference
program so that `conv2d → batch_norm` (optionally with a bias
elementwise_add in between) becomes a single conv with adjusted weights:

    W' = W * (scale / sqrt(var + eps))          (per output channel)
    b' = (b - mean) * scale / sqrt(var + eps) + offset

The rewrite mutates the Program in place and the Scope's values. The
arithmetic is the JAX package's, dtype for dtype, in numpy on the host
(one read of each value at transpile time): the factor in the BN
parameters' dtype, the weight in float64 times it, cast back to the
weight's dtype. Each folded value is written back as a tensor on the
device, and in the dtype, of the value it replaces; the `_bump` at the
end makes the executor plan the smaller program anew.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import dtype_name
from ..core.enforce import InvalidArgumentError, enforce
from ..framework.program import Program
from ..framework.scope import Scope, global_scope


def _as_np(t: torch.Tensor) -> np.ndarray:
    """A scope value on the host as numpy (bfloat16 widened to float32,
    which numpy lacks)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _like(value: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    """`value` as a tensor on the device, and in the dtype, of `ref`."""
    return torch.from_numpy(np.ascontiguousarray(value)).to(
        device=ref.device, dtype=ref.dtype)


class InferenceTranspiler:
    """≙ reference InferenceTranspiler (inference_transpiler.py:24)."""

    def transpile(self, program: Program, place=None, scope: Scope = None):
        """Fuse batch_norm into conv2d/depthwise_conv2d/mul producers, in
        place. The folded values go where the scope's values are; `place`
        is accepted for API parity."""
        enforce(isinstance(program, Program),
                "program must be a Program", exc=InvalidArgumentError)
        scope = scope or global_scope()
        block = program.global_block()
        self._fuse_batch_norms(block, scope)
        program._bump()
        return program

    # -- internals ---------------------------------------------------------

    def _producer(self, block, name, upto):
        """Last op before index `upto` writing `name`."""
        for j in range(upto - 1, -1, -1):
            if name in block.ops[j].output_names():
                return j
        return None

    def _n_readers(self, block, name):
        return sum(name in op.input_names() for op in block.ops)

    def _fuse_batch_norms(self, block, scope):
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            if op.type != "batch_norm" or not op.attrs.get("is_test"):
                i += 1
                continue
            x_name = op.inputs["X"][0]
            prod_idx = self._producer(block, x_name, i)
            if prod_idx is None:
                i += 1
                continue

            # walk back through a bias elementwise_add to the conv; a
            # residual add (Y not a stored 1-D bias) is not foldable
            add_idx = None
            conv_idx = prod_idx
            if block.ops[prod_idx].type == "elementwise_add":
                y_name = block.ops[prod_idx].inputs["Y"][0]
                y_val = scope.find_var(y_name)
                if y_val is None or y_val.dim() != 1:
                    i += 1
                    continue
                add_idx = prod_idx
                conv_in = block.ops[add_idx].inputs["X"][0]
                conv_idx = self._producer(block, conv_in, add_idx)
                if conv_idx is None:
                    i += 1
                    continue
            conv = block.ops[conv_idx]
            if conv.type not in ("conv2d", "depthwise_conv2d", "mul"):
                i += 1
                continue
            # neither the BN input nor the conv output may feed anything
            # else — folding rescales the filter all consumers would see
            conv_out = conv.output_names()[0]
            if self._n_readers(block, x_name) != 1 or \
                    self._n_readers(block, conv_out) != 1:
                i += 1
                continue

            scale = _as_np(scope.get(op.inputs["Scale"][0]))
            offset = _as_np(scope.get(op.inputs["Bias"][0]))
            mean = _as_np(scope.get(op.inputs["Mean"][0]))
            var = _as_np(scope.get(op.inputs["Variance"][0]))
            eps = op.attrs.get("epsilon", 1e-5)
            factor = scale / np.sqrt(var + eps)  # [C_out]

            # fold into the producer's weights
            w_name = conv.inputs["Y" if conv.type == "mul" else "Filter"][0]
            w_ref = scope.get(w_name)
            w_host = _as_np(w_ref)
            orig_dtype = w_host.dtype
            w = w_host.astype(np.float64)
            if conv.type == "mul":
                w = w * factor[None, :]
            else:
                # filters are OIHW in both layouts: out-channel axis 0
                w = w * factor[:, None, None, None]
            scope.set_var(w_name, _like(w.astype(orig_dtype), w_ref))

            # fold into (possibly existing) bias
            if add_idx is not None:
                b_name = block.ops[add_idx].inputs["Y"][0]
                b_ref = scope.get(b_name)
                b = _as_np(b_ref).astype(np.float64)
                b_new = (b - mean) * factor + offset
                scope.set_var(b_name, _like(b_new.astype(orig_dtype), b_ref))
                # batch_norm becomes identity: retarget the add's output name
                bn_out = op.outputs["Y"][0]
                block.ops[add_idx].outputs["Out"] = [bn_out]
                del block.ops[i]
            else:
                # no existing bias: turn the batch_norm op itself into the
                # bias add (keeps op count/positions stable)
                b_new = (offset - mean * factor).astype(orig_dtype)
                b_name = op.inputs["Bias"][0] + ".fused"
                if not block.has_var(b_name):
                    block.create_var(name=b_name, shape=list(b_new.shape),
                                     dtype=dtype_name(w_ref.dtype),
                                     persistable=True)
                scope.set_var(b_name, _like(b_new, w_ref))
                # axis of the channel dim in the BN input
                bn_layout = op.attrs.get("data_layout", "NCHW")
                x_var = block.vars.get(x_name)
                ndim = len(x_var.shape) if x_var is not None else 4
                axis = 1 if bn_layout == "NCHW" and ndim == 4 else ndim - 1
                bn_out = op.outputs["Y"][0]
                op.type = "elementwise_add"
                op.inputs = {"X": [x_name], "Y": [b_name]}
                op.outputs = {"Out": [bn_out]}
                op.attrs = {"axis": axis, "op_role": op.attrs.get("op_role")}
                i += 1
                continue
            # do not advance: current index now holds the next op
        return block
