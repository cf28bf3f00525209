"""In-graph learning-rate decay schedules.

≙ paddle_tpu/layers/learning_rate_scheduler.py (reference
python/paddle/fluid/layers/learning_rate_scheduler.py: noam_decay,
exponential_decay, natural_exp_decay, inverse_time_decay, polynomial_decay,
piecewise_decay, cosine_decay), op for op. Each schedule is ops inside the
main program over an auto-incremented step counter: a persistable [1]
int64 variable that the `increment` op updates in place on the device once
a run, so the optimizer reads the schedule's learning rate as a tensor
every step and no value crosses to the host. Being persistable, the
counter is saved and restored with the parameters (io.save_persistables,
trainer checkpoints).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core import unique_name
from ..framework.program import (Variable, default_main_program,
                                 default_startup_program)
from ..layer_helper import LayerHelper
from . import ops as unary_ops
from .math_ops import scale
from .nn import elementwise_max, elementwise_min
from .tensor import fill_constant

__all__ = [
    "autoincreased_step_counter", "noam_decay", "exponential_decay",
    "natural_exp_decay", "inverse_time_decay", "polynomial_decay",
    "piecewise_decay", "cosine_decay",
]


def autoincreased_step_counter(counter_name: Optional[str] = None,
                               begin: int = 1, step: int = 1) -> Variable:
    """Global step counter, incremented in place once per executed step
    (≙ reference layers/nn.py autoincreased_step_counter). int64 so long
    runs never hit the float32 2^24 increment plateau."""
    name = counter_name or unique_name.generate("@STEP_COUNTER@")
    main_block = default_main_program().global_block()
    if name in main_block.vars:
        existing = main_block.vars[name]
        prev = getattr(existing, "_counter_begin_step", None)
        if prev is not None and prev != (begin, step):
            raise ValueError(
                f"step counter {name!r} already created with "
                f"(begin, step)={prev}, requested {(begin, step)}; use a "
                f"distinct counter_name per schedule")
        return existing
    counter = main_block.create_var(name=name, shape=[1], dtype="int64",
                                    persistable=True)
    counter.stop_gradient = True
    counter._counter_begin_step = (begin, step)
    sb = default_startup_program().global_block()
    sv = sb.create_var(name=name, shape=[1], dtype="int64",
                       persistable=True)
    sb.append_op("fill_constant", outputs={"Out": [sv.name]},
                 attrs={"shape": [1], "value": float(begin - step),
                        "dtype": "int64"})
    main_block.append_op("increment", inputs={"X": [counter.name]},
                         outputs={"Out": [counter.name]},
                         attrs={"step": float(step)})
    return counter


def _decay_step_counter(begin: int = 0) -> Variable:
    from .tensor import cast
    counter = autoincreased_step_counter(
        counter_name=f"@LR_DECAY_COUNTER@{begin}@", begin=begin, step=1)
    step = cast(counter, "float32")
    step.stop_gradient = True
    return step


def noam_decay(d_model: float, warmup_steps: float) -> Variable:
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup_steps^-1.5)
    (≙ reference learning_rate_scheduler.py noam_decay)."""
    step = _decay_step_counter(begin=1)
    a = unary_ops.pow(step, factor=-0.5)
    b = scale(step, float(warmup_steps) ** -1.5)
    lr = scale(elementwise_min(a, b), float(d_model) ** -0.5)
    lr.stop_gradient = True
    return lr


def exponential_decay(learning_rate: float, decay_steps: int,
                      decay_rate: float, staircase: bool = False) -> Variable:
    """lr * decay_rate^(step/decay_steps) (floored when staircase)."""
    step = _decay_step_counter()
    ratio = scale(step, 1.0 / float(decay_steps))
    if staircase:
        ratio = unary_ops.floor(ratio)
    rate = fill_constant(shape=[1], dtype="float32", value=float(decay_rate))
    lr = scale(rate ** ratio, float(learning_rate))
    lr.stop_gradient = True
    return lr


def natural_exp_decay(learning_rate: float, decay_steps: int,
                      decay_rate: float, staircase: bool = False) -> Variable:
    """lr * exp(-decay_rate * step/decay_steps)."""
    step = _decay_step_counter()
    ratio = scale(step, 1.0 / float(decay_steps))
    if staircase:
        ratio = unary_ops.floor(ratio)
    lr = scale(unary_ops.exp(scale(ratio, -float(decay_rate))),
               float(learning_rate))
    lr.stop_gradient = True
    return lr


def inverse_time_decay(learning_rate: float, decay_steps: int,
                       decay_rate: float, staircase: bool = False) -> Variable:
    """lr / (1 + decay_rate * step/decay_steps)."""
    step = _decay_step_counter()
    ratio = scale(step, 1.0 / float(decay_steps))
    if staircase:
        ratio = unary_ops.floor(ratio)
    denom = scale(ratio, float(decay_rate), 1.0)
    lr = scale(unary_ops.reciprocal(denom), float(learning_rate))
    lr.stop_gradient = True
    return lr


def polynomial_decay(learning_rate: float, decay_steps: int,
                     end_learning_rate: float = 0.0001, power: float = 1.0,
                     cycle: bool = False) -> Variable:
    """(lr - end_lr) * (1 - step/decay_steps)^power + end_lr
    (≙ reference learning_rate_scheduler.py polynomial_decay, incl. the
    cycle mode that stretches decay_steps to the next multiple)."""
    step = _decay_step_counter()
    if cycle:
        div = unary_ops.ceil(scale(step, 1.0 / float(decay_steps)))
        # at step 0 the reference forces div=1 so lr starts at learning_rate
        one = fill_constant(shape=[1], dtype="float32", value=1.0)
        div = elementwise_max(div, one)
        decay_steps_var = scale(div, float(decay_steps))
        ratio = step / decay_steps_var
    else:
        limit = fill_constant(shape=[1], dtype="float32",
                              value=float(decay_steps))
        step = elementwise_min(step, limit)
        ratio = scale(step, 1.0 / float(decay_steps))
    base = scale(ratio, -1.0, 1.0)  # 1 - step/decay_steps
    lr = scale(unary_ops.pow(base, factor=float(power)),
               float(learning_rate) - float(end_learning_rate),
               float(end_learning_rate))
    lr.stop_gradient = True
    return lr


def piecewise_decay(boundaries: Sequence[int],
                    values: Sequence[float]) -> Variable:
    """Piecewise-constant schedule (≙ reference piecewise_decay, which builds
    a Switch; here a single searchsorted-style op, branch-free)."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    step = _decay_step_counter()
    helper = LayerHelper("piecewise_decay")
    lr = helper.create_tmp_variable(dtype="float32", shape=[1],
                                    stop_gradient=True)
    helper.append_op(type="piecewise_decay", inputs={"Step": [step]},
                     outputs={"Out": [lr]},
                     attrs={"boundaries": [float(b) for b in boundaries],
                            "values": [float(v) for v in values]})
    lr.stop_gradient = True
    return lr


def cosine_decay(learning_rate: float, step_each_epoch: int,
                 epochs: int) -> Variable:
    """lr * 0.5 * (cos(pi * epoch / epochs) + 1) — cosine annealing over
    whole epochs (staircase per epoch, as in later reference versions)."""
    import math
    step = _decay_step_counter()
    epoch = unary_ops.floor(scale(step, 1.0 / float(step_each_epoch)))
    inner = scale(epoch, math.pi / float(epochs))
    lr = scale(unary_ops.cos(inner), 0.5 * float(learning_rate),
               0.5 * float(learning_rate))
    lr.stop_gradient = True
    return lr
