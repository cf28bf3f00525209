"""Optimizers: SGD, Momentum, Adagrad, Adam, Adamax, DecayedAdagrad,
Adadelta, RMSProp, Ftrl, Lamb, and ModelAverage.

≙ paddle_tpu/optimizer.py (reference python/paddle/fluid/optimizer.py:
Optimizer base :38, _create_optimization_pass :196, minimize :253, the
family :279-1119). Each optimizer appends accumulator vars (persistable,
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


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        block.append_op("adagrad",
                        inputs={"Param": [p], "Grad": [g], "Moment": [m],
                                "LearningRate": [self._global_learning_rate()]},
                        outputs={"ParamOut": [p], "MomentOut": [m]},
                        attrs={"epsilon": self._epsilon})


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


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        block.append_op(
            "adamax",
            inputs={"Param": [p], "Grad": [g],
                    "Moment": [self._get_accumulator("moment", p)],
                    "InfNorm": [self._get_accumulator("inf_norm", p)],
                    "Beta1Pow": [self._get_accumulator("beta1_pow", p)],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p],
                     "MomentOut": [self._get_accumulator("moment", p)],
                     "InfNormOut": [self._get_accumulator("inf_norm", p)],
                     "Beta1PowOut": [self._get_accumulator("beta1_pow", p)]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        block.append_op("decayed_adagrad",
                        inputs={"Param": [p], "Grad": [g], "Moment": [m],
                                "LearningRate": [self._global_learning_rate()]},
                        outputs={"ParamOut": [p], "MomentOut": [m]},
                        attrs={"decay": self._decay,
                               "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        block.append_op(
            "adadelta",
            inputs={"Param": [p], "Grad": [g],
                    "AvgSquaredGrad":
                        [self._get_accumulator("avg_squared_grad", p)],
                    "AvgSquaredUpdate":
                        [self._get_accumulator("avg_squared_update", p)]},
            outputs={"ParamOut": [p],
                     "AvgSquaredGradOut":
                         [self._get_accumulator("avg_squared_grad", p)],
                     "AvgSquaredUpdateOut":
                         [self._get_accumulator("avg_squared_update", p)]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("momentum", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        inputs = {"Param": [p], "Grad": [g],
                  "MeanSquare": [self._get_accumulator("mean_square", p)],
                  "Moment": [self._get_accumulator("momentum", p)],
                  "LearningRate": [self._global_learning_rate()]}
        outputs = {"ParamOut": [p],
                   "MeanSquareOut": [self._get_accumulator("mean_square", p)],
                   "MomentOut": [self._get_accumulator("momentum", p)]}
        if self._centered:
            inputs["MeanGrad"] = [self._get_accumulator("mean_grad", p)]
            outputs["MeanGradOut"] = [self._get_accumulator("mean_grad", p)]
        block.append_op("rmsprop", inputs=inputs, outputs=outputs,
                        attrs={"decay": self._rho, "epsilon": self._epsilon,
                               "momentum": self._momentum,
                               "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        block.append_op(
            "ftrl",
            inputs={"Param": [p], "Grad": [g],
                    "SquaredAccumulator": [self._get_accumulator("squared", p)],
                    "LinearAccumulator": [self._get_accumulator("linear", p)],
                    "LearningRate": [self._global_learning_rate()]},
            outputs={"ParamOut": [p],
                     "SquaredAccumOut": [self._get_accumulator("squared", p)],
                     "LinearAccumOut": [self._get_accumulator("linear", p)]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class LambOptimizer(Optimizer):
    """Large-batch LAMB (TPU-era addition; see optimizer_ops.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon, self._weight_decay = epsilon, weight_decay

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
            "lamb",
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
                   "epsilon": self._epsilon,
                   "weight_decay": self._weight_decay})


class ModelAverage(Optimizer):
    """≙ reference optimizer.py ModelAverage — maintains an EMA of parameters
    (`build` appends its update to the main program); apply()/restore() swap
    the averaged values in and out of the scope around evaluation. apply
    swaps in a copy of each average, so a step that updates the parameter
    in place never writes into the average."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(0.0, **kw)
        self._rate = average_window_rate
        self._params: List[Parameter] = []

    def build(self, params: Sequence[Parameter]):
        self._params = list(params)
        for p in params:
            self._add_accumulator("ema", p)
        block = default_main_program().global_block()
        for p in params:
            ema = self._get_accumulator("ema", p)
            tmp = block.create_var(
                name=unique_name.generate(f"{p.name}_ema_new"),
                shape=p.shape, dtype=dtype_name(p.dtype))
            block.append_op("scale", inputs={"X": [ema]},
                            outputs={"Out": [tmp]},
                            attrs={"scale": 1 - self._rate})
            tmp2 = block.create_var(
                name=unique_name.generate(f"{p.name}_ema_p"),
                shape=p.shape, dtype=dtype_name(p.dtype))
            block.append_op("scale", inputs={"X": [p]},
                            outputs={"Out": [tmp2]},
                            attrs={"scale": self._rate})
            block.append_op("sum", inputs={"X": [tmp, tmp2]},
                            outputs={"Out": [ema]})

    def apply(self, scope=None):
        """Swap EMA values into the parameters (backup originals)."""
        from .framework.scope import global_scope
        scope = scope or global_scope()
        for p in self._params:
            ema = self._get_accumulator("ema", p)
            scope.set_var(p.name + "@MODEL_AVG_BACKUP", scope.get(p.name))
            scope.set_var(p.name, scope.get(ema.name).clone())

    def restore(self, scope=None):
        """Restore the live parameter values saved by apply()."""
        from .framework.scope import global_scope
        scope = scope or global_scope()
        for p in self._params:
            backup = scope.find_var(p.name + "@MODEL_AVG_BACKUP")
            if backup is not None:
                scope.set_var(p.name, backup)
                scope.erase(p.name + "@MODEL_AVG_BACKUP")


# fluid-style aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
