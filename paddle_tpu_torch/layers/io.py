"""IO layers: data declaration.

≙ paddle_tpu/layers/io.py (`data`), without the byte-lean staging option.
"""

from __future__ import annotations

from ..framework.program import default_main_program


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare an input variable (≙ fluid.layers.data, reference
    layers/io.py:38). append_batch_size prepends -1."""
    full_shape = list(shape)
    if append_batch_size:
        full_shape = [-1] + full_shape
    block = default_main_program().current_block()
    if name in block.vars:
        return block.vars[name]
    var = block.create_var(name=name, shape=full_shape, dtype=dtype,
                           lod_level=lod_level, is_data=True,
                           stop_gradient=stop_gradient)
    if lod_level > 0:
        # companion sequence-length variable (static-shape LoD translation)
        block.create_var(name=name + "@SEQLEN", shape=[-1], dtype="int32",
                         is_data=True, stop_gradient=True)
    return var
