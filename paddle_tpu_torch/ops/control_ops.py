"""Structured control flow over sub-blocks.

≙ paddle_tpu/ops/control_ops.py, trimmed to `static_rnn`, the op a
`layers.StaticRNN` appends (the NMT decoder). A sub-block is a real
program block (≙ the BLOCK attr type of the reference proto,
framework.proto:35); its lowering runs the block's plan inside a Python
loop over time where the JAX package runs it inside `lax.scan`, so
torch.autograd differentiates the loop when the op sits in a
`vjp_region`.
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
