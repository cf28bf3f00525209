"""IO layers: data declaration.

≙ paddle_tpu/layers/io.py (`data`), without the reader-op stack; the
input pipeline is paddle_tpu_torch.data (reader decorators, DataFeeder,
DevicePrefetcher).
"""

from __future__ import annotations

import torch

from ..core.dtypes import convert_dtype
from ..framework.program import default_main_program


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, staging_dtype=None, staging_scale=None):
    """Declare an input variable (≙ fluid.layers.data, reference
    layers/io.py:38). append_batch_size prepends -1.

    staging_dtype declares a byte-lean wire dtype: the host may feed this
    var as `staging_dtype` (uint8 images: a quarter of float32's bytes
    over PCIe) and the executor casts it to `dtype` and multiplies by
    `staging_scale` (default 1/255 for uint8) on the device. Feeding
    `dtype` itself stays valid."""
    full_shape = list(shape)
    if append_batch_size:
        full_shape = [-1] + full_shape
    block = default_main_program().current_block()
    if name in block.vars:
        return block.vars[name]
    var = block.create_var(name=name, shape=full_shape, dtype=dtype,
                           lod_level=lod_level, is_data=True,
                           stop_gradient=stop_gradient)
    if staging_dtype is not None:
        wire = convert_dtype(staging_dtype)
        if staging_scale is None and wire == torch.uint8:
            staging_scale = 1.0 / 255.0
        var.staging = (wire, staging_scale)
    if lod_level > 0:
        # companion sequence-length variable (static-shape LoD translation)
        block.create_var(name=name + "@SEQLEN", shape=[-1], dtype="int32",
                         is_data=True, stop_gradient=True)
    return var
