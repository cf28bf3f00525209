"""Structured control flow over sub-blocks, the `where` / `is_empty` ops
and the fake-quantize ops of quantization-aware training.

≙ paddle_tpu/ops/control_ops.py (reference while_op.cc:36,
conditional_block_op.cc, recurrent_op.cc:222, fake_quantize_op.cc). A sub-block is a real program block (≙ the BLOCK attr type of the
reference proto, framework.proto:35); each op runs the block's plan
eagerly where the JAX package traces it into a lax primitive, so
torch.autograd differentiates every op here but `while` when it sits in a
`vjp_region`.

Where each op reads a value on the host, and where it runs every branch:

- `static_rnn` (StaticRNN, DynamicRNN): a Python loop over the static T
  of its step inputs. Reads nothing on the host; lengths mask on the
  device.
- `while`: reads its condition on the host once an iteration (one
  device->host sync each), since eager PyTorch must decide in Python
  whether to run the body again; the JAX package's lax.while_loop decides
  on the device. Forward-only, as there: inside a `vjp_region` with an
  input that needs a gradient it raises.
- `lazy_cond` (`layers.cond`): reads its scalar predicate on the host
  once a call and runs only that branch, as lax.cond does.
- `cond_block` (IfElse) and `switch_case` (Switch): run EVERY branch on
  the full batch and merge with `torch.where` on the device, as the JAX
  package does. No host read.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op


def sub_block_plan(ctx, attrs, key="sub_block"):
    """(block, plan) of the sub-block `attrs[key]` names, taken from the
    program the executor planned (`ctx.extras["program"]`: the fused clone,
    so the step block runs the fused ops the passes counted)."""
    from ..framework.lowering import build_plan
    program = ctx.extras.get("program")
    if program is None:
        raise RuntimeError(
            "control-flow op needs LowerCtx.extras['program'] (set by the "
            "executor); direct op invocation cannot resolve sub-blocks")
    block = program.blocks[attrs[key]]
    return block, build_plan(block)


def _run_block(ctx, attrs, key, env):
    from ..framework.lowering import run_plan
    _, plan = sub_block_plan(ctx, attrs, key)
    return run_plan(plan, env, ctx)


@register_op("where")
def _where(ctx, ins, attrs):
    return {"Out": [torch.where(ins["Condition"][0], ins["X"][0],
                                ins["Y"][0])]}


def _quant_dequant(x, s, bit_length):
    """x rounded to the grid of 2^(bit_length-1) - 1 steps over [-s, s],
    with the straight-through gradient (d out / d x = 1)."""
    bnt = (1 << (bit_length - 1)) - 1
    inv_s = bnt / torch.clamp_min(s, 1e-12)
    q = torch.round(x * inv_s) / inv_s
    return x + (q - x).detach()


@register_op("fake_quantize_abs_max")
def _fake_quantize_abs_max(ctx, ins, attrs):
    x = ins["X"][0]
    s = x.abs().amax()
    return {"Out": [_quant_dequant(x, s, attrs.get("bit_length", 8))],
            "OutScale": [s]}


@register_op("fake_dequantize_max_abs")
def _fake_dequantize_max_abs(ctx, ins, attrs):
    bnt = (1 << (attrs.get("bit_length", 8) - 1)) - 1
    return {"Out": [ins["X"][0].float() * ins["Scale"][0] / bnt]}


@register_op("fake_quantize_moving_average_abs_max")
def _fake_quantize_moving_avg(ctx, ins, attrs):
    # the scale a moving average of the batch's abs max
    x = ins["X"][0]
    rate = attrs.get("moving_rate", 0.9)
    s = rate * ins["InScale"][0] + (1 - rate) * x.abs().amax()
    return {"Out": [_quant_dequant(x, s, attrs.get("bit_length", 8))],
            "OutScale": [s]}


@register_op("is_empty")
def _is_empty(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.full((), x.numel() == 0, dtype=torch.bool,
                               device=x.device)]}


@register_op("static_rnn")
def _static_rnn(ctx, ins, attrs):
    """≙ recurrent_op.cc:222 (StaticRNN): the step block once per time
    step over the [B, T, ...] step inputs, memories carried from step to
    step. With `SeqLens` (DynamicRNN), memories freeze and outputs are
    zeroed past each row's length (≙ shrink_rnn_memory); `is_reverse`
    walks time backwards and returns the outputs in forward order."""
    from ..framework.lowering import run_plan
    _, plan = sub_block_plan(ctx, attrs)
    step_in_names = list(attrs["step_input_names"])
    pre_names = list(attrs["pre_mem_names"])
    new_names = list(attrs["new_mem_names"])
    out_names = list(attrs["step_output_names"])
    captures = dict(zip(attrs["capture_names"], ins.get("Captures", [])))
    reverse = attrs.get("is_reverse", False)
    carry = tuple(ins.get("InitMems", []))
    step_inputs = ins["StepInputs"]
    t = step_inputs[0].shape[1]
    seq_lens = ins.get("SeqLens", [None])[0]
    ys = [[] for _ in out_names]
    for it in range(t):
        tpos = t - 1 - it if reverse else it
        env = dict(captures)
        env.update(zip(pre_names, carry))
        env.update(zip(step_in_names, (x[:, tpos] for x in step_inputs)))
        run_plan(plan, env, ctx)
        new_carry = tuple(env[n] for n in new_names)
        outs = [env[n] for n in out_names]
        if seq_lens is not None:
            valid = tpos < seq_lens                       # [B]

            def rows(v):
                return valid.reshape((-1,) + (1,) * (v.dim() - 1))
            new_carry = tuple(torch.where(rows(n), n, o)
                              for n, o in zip(new_carry, carry))
            outs = [o * rows(o).to(o.dtype) for o in outs]
        carry = new_carry
        for y, o in zip(ys, outs):
            y.append(o)
    if reverse:
        ys = [y[::-1] for y in ys]
    return {"Out": [torch.stack(y, 1) for y in ys],
            "FinalMems": list(carry)}


@register_op("while")
def _while(ctx, ins, attrs):
    """≙ while_op.cc:36: the body block while the carried condition holds.
    The condition is read on the host once an iteration (a device->host
    sync each). Forward-only, as the JAX package's lax.while_loop: when an
    input needs a gradient (a `while` inside a `vjp_region` on the
    differentiated path) it raises."""
    carry_names = list(attrs["carry_names"])
    captures = dict(zip(attrs["capture_names"], ins.get("Captures", [])))
    carry = list(ins["Carry"])
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in carry + list(captures.values())):
        raise NotImplementedError(
            "while is forward-only (as lax.while_loop in the JAX package): "
            "use StaticRNN / DynamicRNN for a differentiable recurrence")
    cond_idx = carry_names.index(attrs["cond_name"])
    while bool(carry[cond_idx].reshape(())):
        env = dict(captures)
        env.update(zip(carry_names, carry))
        _run_block(ctx, attrs, "sub_block", env)
        carry = [env[n] for n in carry_names]
    return {"Out": carry}


def _cond_rows(c, v):
    """The [B, ...] condition shaped to broadcast per row against v."""
    if c.dim() < v.dim():
        return c.reshape(tuple(c.shape) + (1,) * (v.dim() - c.dim()))
    # [B, 1] cond against a rank-1 [B] output: drop trailing singleton
    # dims so the merge is per row, not [B, B]
    while c.dim() > v.dim() and c.shape[-1] == 1:
        c = c.reshape(c.shape[:-1])
    return c


@register_op("cond_block")
def _cond_block(ctx, ins, attrs):
    """Batched IfElse (≙ conditional_block_op.cc + layers IfElse:1412):
    both branches run on the full batch and their outputs merge by the
    [B, 1] condition with torch.where, as in the JAX package (the
    reference gathers each branch's rows instead). No host read;
    differentiable."""
    cond = ins["Cond"][0]
    captures = dict(zip(attrs["capture_names"], ins.get("Captures", [])))
    env_t = _run_block(ctx, attrs, "true_block", dict(captures))
    env_f = _run_block(ctx, attrs, "false_block", dict(captures))
    outs = []
    for tn, fn in zip(attrs["true_out_names"], attrs["false_out_names"]):
        tv, fv = env_t[tn], env_f[fn]
        outs.append(torch.where(_cond_rows(cond, tv), tv, fv))
    return {"Out": outs}


@register_op("lazy_cond")
def _lazy_cond(ctx, ins, attrs):
    """Scalar-predicate conditional (≙ the functional `layers.cond`, the
    JAX package's lax.cond): only the branch the predicate picks runs.
    The predicate is read on the host once a call (a device->host sync).
    Differentiable through the branch that ran."""
    pred = bool(ins["Cond"][0].reshape(()))
    env = dict(zip(attrs["capture_names"], ins.get("Captures", [])))
    key, names = (("true_block", attrs["true_out_names"]) if pred else
                  ("false_block", attrs["false_out_names"]))
    env = _run_block(ctx, attrs, key, env)
    return {"Out": [env[n] for n in names]}


@register_op("switch_case")
def _switch_case(ctx, ins, attrs):
    """≙ layers.Switch (reference control_flow.py:1286): the first case
    whose scalar condition holds wins; the default block otherwise. Every
    case block runs (they are small: learning-rate schedules) and the pick
    is a chain of torch.where on the device, as in the JAX package."""
    conds = ins["Conds"]
    captures = dict(zip(attrs["capture_names"], ins.get("Captures", [])))
    vals = []
    for bidx, out_name in zip(attrs["case_blocks"], attrs["case_out_names"]):
        env = _run_block(ctx, {"sub_block": bidx}, "sub_block",
                         dict(captures))
        vals.append(env[out_name])
    # the default is the last block when there is one more block than
    # conditions; without a default the target keeps its value before the
    # switch (the reference leaves the assigned variable untouched)
    if len(vals) > len(conds):
        result = vals[-1]
    elif ins.get("Prev"):
        result = ins["Prev"][0]
    else:
        result = torch.zeros_like(vals[0])
    for c, v in zip(reversed(conds), reversed(vals[:len(conds)])):
        result = torch.where(c.reshape(()).to(torch.bool), v, result)
    return {"Out": [result]}

