"""Automatic TP/EP sharding annotation for transformer-family programs.

≙ paddle_tpu/parallel/auto_shard.py, a copy: the Megatron recipe by
parameter-name pattern over a built program. Attention qkv and MLP up-proj
weights are column-parallel (last dim over `tp`), attention out-proj and
MLP down-proj are row-parallel (first matmul dim over `tp`), embedding
tables are vocab-row-sharded (the distributed-lookup-table / EP analogue,
reference distribute_transpiler.py:212). ParallelExecutor reads the
resulting ``sharding_spec`` attributes and runs framework/sharding.py's
tp_shard_pass, which splices the collectives.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

from ..framework.program import Program
from .mesh import MODEL_AXIS

# (regex over parameter name) -> spec builder taking ndim
_COLUMN = lambda nd: tuple([None] * (nd - 1) + [MODEL_AXIS])     # noqa: E731
_ROW = lambda nd: tuple([None] * (nd - 2) + [MODEL_AXIS, None])  # noqa: E731
_VOCAB = lambda nd: tuple([MODEL_AXIS] + [None] * (nd - 1))      # noqa: E731

DEFAULT_RULES: Sequence[Tuple[str, object]] = (
    (r"(_q|_k|_v|_qkv|_fc1|_up|_gate)(\.w|\.b)?(_\d+)?$", _COLUMN),
    (r"(_o|_out|_fc2|_down)(\.w)(_\d+)?$", _ROW),
    (r"(_emb|_embedding|emb\.w|lm_head\.w)(_\d+)?$", _VOCAB),
)


def annotate_tp(program: Optional[Program] = None,
                rules: Sequence[Tuple[str, object]] = DEFAULT_RULES,
                verbose: bool = False) -> Dict[str, tuple]:
    """Set ``sharding_spec`` on matching parameters of `program`.
    Returns {param_name: spec} for what was annotated."""
    from ..framework.program import default_main_program
    program = program or default_main_program()
    annotated = {}
    for block in program.blocks:
        for v in block.vars.values():
            if not getattr(v, "trainable", False) or v.shape is None:
                continue
            for pat, builder in rules:
                if re.search(pat, v.name):
                    if builder in (_ROW, _VOCAB) and len(v.shape) < 2:
                        # biases of row-parallel/vocab-sharded layers
                        # replicate (a [V] lm-head bias adds to logits the
                        # row-parallel psum already made replicated)
                        continue
                    spec = builder(len(v.shape))
                    v.sharding_spec = spec
                    annotated[v.name] = spec
                    break
    return annotated
