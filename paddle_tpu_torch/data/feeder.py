"""DataFeeder: minibatch list-of-samples → feed dict of dense arrays.

≙ paddle_tpu/data/feeder.py (reference python/paddle/fluid/data_feeder.py:
DataFeeder converting numpy/lists to LoDTensors per feed var), with the
host half of byte-lean staging (`staging_specs`, `stage_array`,
`stage_batch`). Sequence (lod_level>0) slots are padded to the batch max
length and a companion `<name>@SEQLEN` int32 vector is emitted — the
static-shape translation of LoD. The arrays stay on the host: the
executor (or a DevicePrefetcher) copies each feed to the device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..core.dtypes import dtype_name
from ..framework.program import Program, Variable, default_main_program


def staging_specs(program: Program = None) -> Dict[str, tuple]:
    """{var name: (wire dtype, device scale)} for every data var declared
    with a staging dtype (layers.data(staging_dtype=...))."""
    program = program or default_main_program()
    return {v.name: v.staging for b in program.blocks
            for v in b.vars.values() if v.staging is not None}


def stage_array(arr: np.ndarray, spec: tuple) -> np.ndarray:
    """One host array in its wire dtype. The executor inverts this on the
    device: for a float var staged uint8 with scale s the host stores
    clip(round(x / s)), so the device's uint8 · s is x to within s / 2.
    An array already in the wire dtype is not quantized again."""
    wire, scale = spec
    wire = np.dtype(dtype_name(wire))
    arr = np.asarray(arr)
    if arr.dtype == wire:
        return arr
    if scale is None:
        return arr.astype(wire)
    x = np.rint(np.asarray(arr, np.float32) / scale)
    if np.issubdtype(wire, np.integer):
        info = np.iinfo(wire)
        x = np.clip(x, info.min, info.max)
    return x.astype(wire)


def stage_batch(feed: Dict[str, np.ndarray],
                specs: Dict[str, tuple]) -> Dict[str, np.ndarray]:
    """stage_array on every feed entry that has a staging spec."""
    if not specs:
        return feed
    return {k: stage_array(v, specs[k]) if k in specs else v
            for k, v in feed.items()}


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None,
                 program: Program = None):
        program = program or default_main_program()
        self.feed_vars: List[Variable] = [
            program.global_block().var(v) if isinstance(v, str) else v
            for v in feed_list]
        self.place = place

    def feed(self, minibatch: Sequence[Sequence]) -> Dict[str, np.ndarray]:
        """minibatch: list of samples, each a tuple aligned with feed_list."""
        out: Dict[str, np.ndarray] = {}
        for i, var in enumerate(self.feed_vars):
            col = [sample[i] for sample in minibatch]
            dtype = np.dtype(dtype_name(var.dtype))
            if var.lod_level > 0:
                seqs = [np.asarray(s, dtype=dtype) for s in col]
                maxlen = max(s.shape[0] for s in seqs)
                trailing = seqs[0].shape[1:]
                padded = np.zeros((len(seqs), maxlen) + trailing, dtype=dtype)
                lengths = np.zeros(len(seqs), dtype=np.int32)
                for j, s in enumerate(seqs):
                    padded[j, :s.shape[0]] = s
                    lengths[j] = s.shape[0]
                out[var.name] = padded
                out[var.name + "@SEQLEN"] = lengths
            else:
                arr = np.asarray(col, dtype=dtype)
                # match declared trailing shape, e.g. labels [N] -> [N, 1]
                want = [d for d in (var.shape or []) if d != -1]
                if want and list(arr.shape[1:]) != want and \
                        int(np.prod(arr.shape[1:])) == int(np.prod(want)):
                    arr = arr.reshape([arr.shape[0]] + want)
                out[var.name] = arr
        return out
