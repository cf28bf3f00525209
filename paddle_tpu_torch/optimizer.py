"""Optimizers: SGD, Momentum and Adam.

≙ paddle_tpu/optimizer.py (reference python/paddle/fluid/optimizer.py:
Optimizer base :38, _create_optimization_pass :196, minimize :253), trimmed
to the training slice. Each optimizer appends accumulator vars (persistable,
zero- or beta-filled by the startup program) and one update op per
parameter; the executor updates parameters and accumulators in place.
The program is the JAX package's, op for op.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .clip import append_gradient_clip_ops
from .core import unique_name
from .core.dtypes import dtype_name
from .framework.backward import append_backward
from .framework.program import (Parameter, Program, Variable,
                                default_main_program,
                                default_startup_program)
from .regularizer import append_regularization_ops


class Optimizer:
    """Base optimizer (≙ reference optimizer.py:38)."""

    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_var: Optional[Variable] = None
        self._accumulators: Dict[str, Dict[str, Variable]] = {}

    # -- learning rate ----------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            return
        if self._learning_rate_var is not None:
            return
        main_block = default_main_program().global_block()
        name = unique_name.generate("learning_rate")
        self._learning_rate_var = main_block.create_var(
            name=name, shape=[1], dtype="float32", persistable=True)
        self._learning_rate_var.stop_gradient = True
        sb = default_startup_program().global_block()
        sv = sb.create_var(name=name, shape=[1], dtype="float32",
                           persistable=True)
        sb.append_op("fill_constant", outputs={"Out": [sv.name]},
                     attrs={"shape": [1], "value": float(self._learning_rate),
                            "dtype": "float32"})

    def _global_learning_rate(self) -> Variable:
        return self._learning_rate_var

    # -- accumulators (≙ optimizer.py _add_accumulator) -------------------
    def _add_accumulator(self, name: str, param: Parameter,
                         fill_value: float = 0.0, shape=None, dtype=None):
        acc_map = self._accumulators.setdefault(name, {})
        if param.name in acc_map:
            return acc_map[param.name]
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or dtype_name(param.dtype)
        var_name = unique_name.generate(f"{param.name}_{name}_acc")
        main_block = default_main_program().global_block()
        var = main_block.create_var(name=var_name, shape=shape, dtype=dtype,
                                    persistable=True)
        var.stop_gradient = True
        # markers the program's JSON carries (the JAX package's parallel
        # executors read them): this is optimizer state, whose parameter it
        # is, and a same-shaped accumulator takes its parameter's sharding
        var.is_optimizer_state = True
        var.accumulator_of = param.name
        pspec = getattr(param, "sharding_spec", None)
        if pspec is not None and list(shape) == list(param.shape):
            var.sharding_spec = pspec
        sb = default_startup_program().global_block()
        sv = sb.create_var(name=var_name, shape=shape, dtype=dtype,
                           persistable=True)
        sb.append_op("fill_constant", outputs={"Out": [sv.name]},
                     attrs={"shape": shape, "value": float(fill_value),
                            "dtype": dtype})
        acc_map[param.name] = var
        return var

    def _get_accumulator(self, name: str, param: Parameter) -> Variable:
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, params_grads):
        pass

    # -- the pass (≙ optimizer.py:196) ------------------------------------
    def _create_optimization_pass(self, params_grads, loss,
                                  startup_program=None):
        block = loss.block
        start = len(block.ops)
        self._create_global_learning_rate()
        self._create_accumulators(block, [p for p, _ in params_grads])
        for pg in params_grads:
            self._append_optimize_op(block, pg)
        self._finish_update(block, params_grads)
        # role marker (≙ OpRole::kOptimize, reference op_proto_maker.h:25-31):
        # lets clone(for_test)/prune strip the update ops for inference.
        for op in block.ops[start:]:
            op.attrs.setdefault("op_role", "optimize")
        return []

    def minimize(self, loss: Variable, startup_program: Optional[Program] = None,
                 parameter_list: Optional[Sequence] = None,
                 no_grad_set=None) -> Tuple[list, List[Tuple[Variable, Variable]]]:
        """≙ reference optimizer.py:253 — append_backward + clip +
        regularization + optimize ops, all into the loss's program."""
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        opt_ops = self._create_optimization_pass(params_grads, loss,
                                                 startup_program)
        return opt_ops, params_grads


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        block.append_op("sgd",
                        inputs={"Param": [p], "Grad": [g],
                                "LearningRate": [self._global_learning_rate()]},
                        outputs={"ParamOut": [p]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        block.append_op("momentum",
                        inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                                "LearningRate": [self._global_learning_rate()]},
                        outputs={"ParamOut": [p], "VelocityOut": [v]},
                        attrs={"mu": self._momentum,
                               "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow", p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        block.append_op(
            "adam",
            inputs={"Param": [p], "Grad": [g],
                    "Moment1": [self._get_accumulator("moment1", p)],
                    "Moment2": [self._get_accumulator("moment2", p)],
                    "Beta1Pow": [self._get_accumulator("beta1_pow", p)],
                    "Beta2Pow": [self._get_accumulator("beta2_pow", p)],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p],
                     "Moment1Out": [self._get_accumulator("moment1", p)],
                     "Moment2Out": [self._get_accumulator("moment2", p)],
                     "Beta1PowOut": [self._get_accumulator("beta1_pow", p)],
                     "Beta2PowOut": [self._get_accumulator("beta2_pow", p)]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})



# fluid-style aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
