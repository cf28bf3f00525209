"""Tensor (model) parallelism: the explicit tp collective ops.

≙ paddle_tpu/parallel/tensor_parallel.py. framework/sharding.py's
tp_shard_pass splices these ops into a tp-annotated program; each rank of
the tp group then runs the program on its local weight blocks and the ops
exchange what the Megatron recipe needs over the tp axis group.

Every op carries "count-once" differentiation: every tp rank computes the
(identical) loss and seeds its backward with 1, so the plain collective
transposes (all_reduce -> all_reduce of cotangents) would multiply
gradients by tp. The autograd Functions below are the Megatron f/g pair
and its two reshard cousins, exactly the JAX package's custom VJPs:

  tp_allreduce  fwd all_reduce  bwd identity    (g: row-parallel psum)
  tp_ident      fwd identity    bwd all_reduce  (f: column-parallel in)
  tp_split      fwd local slice bwd all_gather  (lm-head row entry)
  tp_allgather  fwd all_gather  bwd local slice (tp<->dp reshard)
  tp_vocab_lookup  masked local lookup + tp_allreduce (vocab-sharded emb)

The JAX module's sharding-constraint helpers (`shard`,
`column_parallel_matmul`, ...) annotate activations for XLA's SPMD
partitioner, which the port does not have; they are not ported.
"""

from __future__ import annotations

import torch

from ..core.enforce import InvalidArgumentError, enforce
from ..framework.registry import (register_effects, register_infer_spec,
                                  register_op, register_shard_spec)
from . import collective as C
from .mesh import current_mesh

_CURRENT_TP_INDEX: list = []


class tp_index_scope:
    """Context manager binding the tp shard index the op lowerings read
    (≙ the JAX package's; the executor binds this rank's coordinate)."""

    def __init__(self, idx):
        self.idx = idx

    def __enter__(self):
        _CURRENT_TP_INDEX.append(self.idx)

    def __exit__(self, *a):
        _CURRENT_TP_INDEX.pop()


def current_tp_index(axis_name: str) -> int:
    if _CURRENT_TP_INDEX:
        return _CURRENT_TP_INDEX[-1]
    return current_mesh().axis_index(axis_name)


class _PsumOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        return C._ar(x, C._group(axis_name))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IdentPsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.group = C._group(axis_name)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C._ar(g, ctx.group), None


class _SplitOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim, parts, idx):
        ctx.args = (C._group(axis_name), dim, parts)
        chunk = x.shape[dim] // parts
        return x.narrow(dim, idx * chunk, chunk).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, dim, parts = ctx.args
        return (C._ag(g.contiguous(), group, parts, dim), None, None, None,
                None)


class _GatherOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim, parts, idx):
        ctx.args = (dim, idx, x.shape[dim])
        return C._ag(x, C._group(axis_name), parts, dim)

    @staticmethod
    def backward(ctx, g):
        dim, idx, chunk = ctx.args
        return (g.narrow(dim, idx * chunk, chunk).contiguous(), None, None,
                None, None)


def _joined(axis_name):
    return C._group(axis_name) is not None


def psum_once(x, axis_name: str):
    """All-reduce whose backward is the identity: the value becomes
    replicated, and the (replicated, identical) downstream cotangent passes
    through unscaled — Megatron's g operator."""
    return _PsumOnce.apply(x, axis_name) if _joined(axis_name) else x


def ident_psum_grad(x, axis_name: str):
    """Identity whose backward all-reduces the cotangent: wraps a
    replicated activation entering tp-sharded compute, so the partial
    cotangents the sharded branches produce are reduced — Megatron's f."""
    return _IdentPsumGrad.apply(x, axis_name) if _joined(axis_name) else x


def split_once(x, axis_name: str, dim: int, parts: int, idx):
    """Local slice of a replicated value along `dim`; backward all-gathers
    the per-rank cotangent slices into the full cotangent."""
    dim = dim if dim >= 0 else dim + x.dim()
    if not _joined(axis_name):
        chunk = x.shape[dim] // parts
        return x.narrow(dim, idx * chunk, chunk)
    return _SplitOnce.apply(x, axis_name, dim, parts, int(idx))


def gather_once(x, axis_name: str, dim: int, idx, parts=None):
    """All-gather a sharded value back to replicated; backward slices the
    (replicated) cotangent back to the local chunk."""
    dim = dim if dim >= 0 else dim + x.dim()
    if not _joined(axis_name):
        return x
    parts = parts or C.axis_size(axis_name)
    return _GatherOnce.apply(x, axis_name, dim, parts, int(idx))


@register_op("tp_allreduce")
def _tp_allreduce(ctx, ins, attrs):
    return {"Out": [psum_once(ins["X"][0], attrs["axis"])]}


@register_op("tp_ident")
def _tp_ident(ctx, ins, attrs):
    return {"Out": [ident_psum_grad(ins["X"][0], attrs["axis"])]}


@register_op("tp_split")
def _tp_split(ctx, ins, attrs):
    axis = attrs["axis"]
    return {"Out": [split_once(ins["X"][0], axis, int(attrs["dim"]),
                               int(attrs["parts"]),
                               current_tp_index(axis))]}


@register_op("tp_allgather")
def _tp_allgather(ctx, ins, attrs):
    axis = attrs["axis"]
    return {"Out": [gather_once(ins["X"][0], axis, int(attrs["dim"]),
                                current_tp_index(axis),
                                int(attrs["parts"]))]}


@register_op("tp_vocab_lookup")
def _tp_vocab_lookup(ctx, ins, attrs):
    """Embedding lookup over a vocab-row-sharded table (the distributed
    lookup table / EP analogue, reference distribute_transpiler.py:212):
    ids are global, each rank holds rows [i*V/p, (i+1)*V/p); out-of-range
    rows contribute zero and the all-reduce assembles the full lookup. The
    table gradient stays local (a scatter-add into the rank's rows)."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    axis = attrs["axis"]
    idx = current_tp_index(axis)
    vshard = w.shape[0]
    local = ids - idx * vshard
    ok = (local >= 0) & (local < vshard)
    padding_idx = attrs.get("padding_idx", None)
    if padding_idx is not None:
        pad = padding_idx if padding_idx >= 0 \
            else padding_idx + int(attrs["vocab"])
        ok = ok & (ids != pad)
    out = w[local.clamp(0, vshard - 1).long()]
    out = out * ok.unsqueeze(-1).to(out.dtype)
    return {"Out": [psum_once(out, axis)]}


# -- static-analysis infer specs + sharding rules ---------------------------


@register_infer_spec("tp_allreduce")
def _infer_tp_allreduce(ictx, in_shapes, in_dtypes, attrs):
    return {"Out": [(in_shapes["X"][0], in_dtypes["X"][0])]}


@register_infer_spec("tp_ident")
def _infer_tp_ident(ictx, in_shapes, in_dtypes, attrs):
    return {"Out": [(in_shapes["X"][0], in_dtypes["X"][0])]}


@register_infer_spec("tp_split")
def _infer_tp_split(ictx, in_shapes, in_dtypes, attrs):
    shape = list(in_shapes["X"][0])
    dim = int(attrs["dim"])
    parts = int(attrs["parts"])
    enforce(shape[dim] % parts == 0,
            f"tp_split dim {dim} of size {shape[dim]} not divisible by "
            f"parts={parts}", exc=InvalidArgumentError)
    shape[dim] //= parts
    return {"Out": [(tuple(shape), in_dtypes["X"][0])]}


@register_infer_spec("tp_allgather")
def _infer_tp_allgather(ictx, in_shapes, in_dtypes, attrs):
    shape = list(in_shapes["X"][0])
    shape[int(attrs["dim"])] *= int(attrs["parts"])
    return {"Out": [(tuple(shape), in_dtypes["X"][0])]}


@register_infer_spec("tp_vocab_lookup")
def _infer_tp_vocab_lookup(ictx, in_shapes, in_dtypes, attrs):
    ids = list(in_shapes["Ids"][0])
    if len(ids) >= 2 and ids[-1] == 1:
        ids = ids[:-1]
    w = in_shapes["W"][0]
    return {"Out": [(tuple(ids) + tuple(w[1:]), in_dtypes["W"][0])]}


@register_shard_spec("tp_allreduce")
def _shardrule_tp_allreduce(sctx, in_specs, attrs):
    xs = in_specs["X"][0]
    return {"Out": [None if xs is None else (None,) * len(xs)]}


@register_shard_spec("tp_ident")
def _shardrule_tp_ident(sctx, in_specs, attrs):
    return {"Out": [in_specs["X"][0]]}


@register_shard_spec("tp_split")
def _shardrule_tp_split(sctx, in_specs, attrs):
    xs = in_specs["X"][0]
    if xs is None:
        return {}
    out = list(xs)
    out[int(attrs["dim"])] = sctx.axis
    return {"Out": [tuple(out)]}


@register_shard_spec("tp_allgather")
def _shardrule_tp_allgather(sctx, in_specs, attrs):
    xs = in_specs["X"][0]
    if xs is None:
        return {}
    out = list(xs)
    out[int(attrs["dim"])] = None
    return {"Out": [tuple(out)]}


@register_shard_spec("tp_vocab_lookup")
def _shardrule_tp_vocab_lookup(sctx, in_specs, attrs):
    ids_shape = sctx.in_shape("Ids")
    rank = len(ids_shape) if ids_shape else 2
    if ids_shape and len(ids_shape) >= 2 and ids_shape[-1] == 1:
        rank -= 1
    ws = in_specs["W"][0]
    return {"Out": [(None,) * (rank + (len(ws) - 1 if ws else 1))]}


# -- dataflow effect sets (framework/dataflow.py): which mesh axis each op
# communicates over, and what its output's consistency over that axis is.
# The backward halves count too (tp_ident / tp_split communicate in their
# backward).


@register_effects("tp_allreduce")
def _eff_tp_allreduce(op):
    a = op.attrs.get("axis")
    return {"collective_axes": (a,), "resolves_axes": (a,)}


@register_effects("tp_ident")
def _eff_tp_ident(op):
    return {"collective_axes": (op.attrs.get("axis"),)}


@register_effects("tp_split")
def _eff_tp_split(op):
    a = op.attrs.get("axis")
    return {"collective_axes": (a,), "shards_axes": (a,)}


@register_effects("tp_allgather")
def _eff_tp_allgather(op):
    a = op.attrs.get("axis")
    return {"collective_axes": (a,), "resolves_axes": (a,)}


@register_effects("tp_vocab_lookup")
def _eff_tp_vocab_lookup(op):
    a = op.attrs.get("axis")
    return {"collective_axes": (a,), "resolves_axes": (a,)}
