"""Program inspection: pretty printing, graphviz dumps and the traced graph.

≙ paddle_tpu/debugger.py (reference python/paddle/fluid/debugger.py:
pprint_program_codes :275, draw_block_graphviz; net_drawer.py and the ir
graph_viz_pass). `pprint_block_codes`, `pprint_program_codes` and
`draw_block_graphviz` give the JAX package's text for the same program.
`dump_hlo` keeps its name and signature; where the JAX package lowers
the global block to StableHLO text, the port returns the text of the
`torch.export` graph of the op plan the executor runs (the ATen ops the
lowerings dispatch, the kernels' `ptpu::` ops on a CUDA place).
"""

from __future__ import annotations

import os
from typing import Optional

from .core.dtypes import dtype_name
from .framework.program import Block, Program


def _var_brief(block: Block, name: str) -> str:
    if block.has_var(name):
        v = block.var(name)
        shape = list(v.shape) if v.shape is not None else "?"
        tag = "P" if getattr(v, "is_parameter", False) or \
            v.__class__.__name__ == "Parameter" else \
            ("s" if v.persistable else "t")
        return f"{name}[{tag}:{dtype_name(v.dtype)}:{shape}]"
    return name


def pprint_block_codes(block: Block, show_backward: bool = True) -> str:
    """Render a block as pseudo-code, one op per line."""
    lines = []
    for i, op in enumerate(block.ops):
        outs = ", ".join(_var_brief(block, n) for n in op.output_names())
        ins = ", ".join(_var_brief(block, n) for n in op.input_names())
        attrs = {k: v for k, v in op.attrs.items()
                 if not k.startswith("_") and not callable(v)}
        attr_s = ""
        if attrs:
            short = ", ".join(f"{k}={v!r}" for k, v in sorted(attrs.items())
                              if not hasattr(v, "ops"))[:120]
            if short:
                attr_s = f"  # {short}"
        lines.append(f"  {i:>4}: {outs} = {op.type}({ins}){attr_s}")
    return "\n".join(lines)


def pprint_program_codes(program: Program) -> str:
    """≙ debugger.pprint_program_codes — dump every block."""
    parts = []
    for bi, block in enumerate(program.blocks):
        parts.append(f"block {bi} {{")
        parts.append(pprint_block_codes(block))
        parts.append("}")
    return "\n".join(parts)


def draw_block_graphviz(block: Block, path: str,
                        highlights: Optional[set] = None) -> str:
    """Write a graphviz .dot file of the block's op/var dataflow
    (≙ debugger.draw_block_graphviz / graph_viz_pass)."""
    highlights = highlights or set()
    lines = ["digraph G {", '  rankdir="TB";',
             '  node [fontsize=10];']
    seen_vars = set()

    def var_node(name):
        nid = f"var_{name}".replace(".", "_").replace("@", "_")
        if name not in seen_vars:
            seen_vars.add(name)
            color = ', style=filled, fillcolor="#ffcccc"' \
                if name in highlights else ""
            shape = "ellipse"
            if block.has_var(name) and block.var(name).persistable:
                shape = "box3d"
            lines.append(
                f'  {nid} [label="{_var_brief(block, name)}", '
                f'shape={shape}{color}];')
        return nid

    for i, op in enumerate(block.ops):
        onid = f"op_{i}"
        lines.append(f'  {onid} [label="{op.type}", shape=box, '
                     f'style=filled, fillcolor="#ccccff"];')
        for n in op.input_names():
            lines.append(f"  {var_node(n)} -> {onid};")
        for n in op.output_names():
            lines.append(f"  {onid} -> {var_node(n)};")
    lines.append("}")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def dump_hlo(program: Program, feed_shapes: dict, path: Optional[str] = None,
             fetch_list=None, place=None) -> str:
    """The text of the `torch.export` graph of the global block's op plan
    (the JAX package's StableHLO dump, on the port's mechanism): the plan
    `Executor.run` builds, fusion passes included, over zero feeds of
    `feed_shapes` (name -> shape, or (shape, dtype); float32 by default)
    and zero-filled values for every declared var the block reads but
    neither feeds nor writes (parameters etc.). `fetch_list` defaults to
    the last var the block writes. Runs on `place` (CUDAPlace(0) by
    default, as every entry point). Writes the text to `path` if given."""
    import torch

    from .core.dtypes import convert_dtype
    from .core.places import CUDAPlace, resolve_device
    from .framework.executor import Executor
    from .framework.scope import Scope
    from .io import _plan_fn, _Traced

    place = place if place is not None else CUDAPlace(0)
    device = resolve_device(place)
    block = program.global_block()
    fetch_names = [getattr(f, "name", f) for f in (fetch_list or [])]
    if not fetch_names:
        produced = [n for op in block.ops for n in op.output_names()]
        fetch_names = produced[-1:]
    feed_names = sorted(feed_shapes)

    read, produced = set(), set()
    for op in block.ops:
        read |= set(op.input_names())
        produced |= set(op.output_names())
    implicit = sorted(n for n in read - produced - set(feed_names)
                      if block.has_var(n) and block.var(n).shape is not None
                      and -1 not in block.var(n).shape)

    def zeros(shape, dtype):
        return torch.zeros(tuple(shape), dtype=convert_dtype(dtype),
                           device=device)

    feeds = []
    for n in feed_names:
        s = feed_shapes[n]
        if isinstance(s, tuple) and len(s) == 2 and isinstance(s[1], str):
            feeds.append(zeros(s[0], s[1]))
        else:
            feeds.append(zeros(s, "float32"))
    feeds += [zeros(block.var(n).shape, block.var(n).dtype)
              for n in implicit]
    plan = Executor(place)._build_plan(program, Scope(),
                                       feed_names + implicit, fetch_names)
    with torch.no_grad():
        ep = torch.export.export(
            _Traced(_plan_fn(plan, device, fetch_names, False), []),
            tuple(feeds), strict=False)
    text = str(ep)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text
