"""Autodiff: append_backward / calc_gradient.

≙ paddle_tpu/framework/backward.py (reference python/paddle/fluid/
backward.py:469 append_backward, :685 calc_gradient). Instead of one grad op
per forward op, a single `vjp_region` op records (forward op set, loss,
diff targets); the executor runs that segment on torch.autograd
(lowering.py `run_vjp_region`). The program is the JAX package's, op for
op: gradient variables named `<var>@GRAD` appear exactly as in the
reference, so clip/regularizer/optimizer ops compose unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple, Union

from ..core.enforce import InvalidArgumentError, enforce
from .lowering import _ancestor_op_indices, grad_var_name
from .program import Variable


def _resolve_targets(block, seg_indices, parameter_list, no_grad_set):
    read: Set[str] = set()
    for i in seg_indices:
        read |= set(block.ops[i].input_names())
    no_grad = {v.name if isinstance(v, Variable) else v
               for v in (no_grad_set or ())}
    if parameter_list is not None:
        names = [p.name if isinstance(p, Variable) else p
                 for p in parameter_list]
    else:
        names = [p.name for p in block.program.all_parameters()
                 if p.trainable and p.name in read]
    return [n for n in names if n not in no_grad]


def _make_grad_vars(block, names: Sequence[str]) -> List[Variable]:
    out = []
    for n in names:
        gname = grad_var_name(n)
        if gname not in block.vars:
            src = block.var(n)
            block.create_var(name=gname, shape=src.shape, dtype=src.dtype,
                             stop_gradient=True)
        out.append(block.vars[gname])
    return out


def append_backward(loss: Variable,
                    parameter_list: Optional[Sequence] = None,
                    no_grad_set: Optional[Set] = None,
                    callbacks=None) -> List[Tuple[Variable, Variable]]:
    """Append gradient computation for `loss` wrt trainable parameters.

    ≙ reference python/paddle/fluid/backward.py:469. Returns
    [(param, param@GRAD), ...] like the reference.
    """
    block = loss.block
    enforce(loss.shape is None or int(__import__("numpy").prod(
        [d for d in loss.shape if d != -1] or [1])) >= 1,
        "loss must be a tensor", exc=InvalidArgumentError)
    upto = len(block.ops)
    seg = _ancestor_op_indices(block, upto, {loss.name})
    enforce(len(seg) > 0, f"no ops produce loss var {loss.name!r}",
            exc=InvalidArgumentError)
    target_names = _resolve_targets(block, seg, parameter_list, no_grad_set)
    enforce(len(target_names) > 0,
            "no trainable parameters found on the path to the loss",
            exc=InvalidArgumentError)

    grad_vars = _make_grad_vars(block, target_names)
    loss_grad = _make_grad_vars(block, [loss.name])[0]
    block.append_op(
        type="vjp_region",
        inputs={"Fwd": [loss.name]},
        outputs={"Grads": [g.name for g in grad_vars],
                 "LossGrad": [loss_grad.name]},
        attrs={"fwd_ops": seg, "targets": target_names, "loss": loss.name})
    params_and_grads = [(block.var(n), block.var(grad_var_name(n)))
                        for n in target_names]
    return params_and_grads


def calc_gradient(targets: Union[Variable, Sequence[Variable]],
                  inputs: Union[Variable, Sequence[Variable]],
                  target_gradients=None,
                  no_grad_set: Optional[Set] = None) -> List[Variable]:
    """Gradients of `targets` (summed; cotangent seeded with ones) wrt
    `inputs`. ≙ reference backward.py:685 calc_gradient."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    enforce(len(targets) == 1,
            "calc_gradient currently supports a single target",
            exc=InvalidArgumentError)
    target = targets[0]
    block = target.block
    upto = len(block.ops)
    seg = _ancestor_op_indices(block, upto, {target.name})
    no_grad = {v.name if isinstance(v, Variable) else v
               for v in (no_grad_set or ())}
    input_names = [v.name if isinstance(v, Variable) else v for v in inputs]
    input_names = [n for n in input_names if n not in no_grad]
    grad_vars = _make_grad_vars(block, input_names)
    tgrad = _make_grad_vars(block, [target.name])[0]
    block.append_op(
        type="vjp_region",
        inputs={"Fwd": [target.name]},
        outputs={"Grads": [g.name for g in grad_vars],
                 "LossGrad": [tgrad.name]},
        attrs={"fwd_ops": seg, "targets": input_names, "loss": target.name})
    return grad_vars
