"""Tensor-manipulation op lowerings.

≙ paddle_tpu/ops/tensor_ops.py (reference operators/{reshape,transpose,
unsqueeze,concat,slice,gather,cast,fill_constant,assign,one_hot,
lookup_table,increment,split,scatter,stack,flatten,pad,shape,reverse,
multiplex,crop,label_smooth,print,cumsum}_op.cc), plus the KV-cache
write `cache_write`, the learning-rate schedules' `piecewise_decay`, the
sparse-table helpers `split_ids` / `merge_ids` / `lookup_sparse_table`,
the beam decoder's `expand`, and `assign` with the tensor arrays of the
control-flow builders.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import convert_dtype
from ..core.enforce import InvalidArgumentError, enforce
from ..framework.registry import register_op


# --- indices out of range ------------------------------------------------
# jnp.take and jnp.take_along_axis (the reference's gather, lookup_table and
# sequence_last_step) run in jax's "fill" mode: an index in [-n, 0) counts
# from the end, and any other index outside [0, n) yields a filled row
# whose gradient is zero. The port computes the same with a clamp and a
# masked fill, so no index is checked on the host (no device->host sync)
# and no out-of-range index reaches torch's indexing.


def fill_value(dtype):
    """The value jax fills an out-of-range row with: NaN for floating
    types, the least value of a signed integer type, the greatest of an
    unsigned one, True for booleans."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def index_in_range(index, n):
    """(index, filled): `index` with [-n, 0) wrapped to [0, n) and the rest
    clamped into it, and the mask of the entries jax fills instead."""
    index = index.to(torch.long)
    index = torch.where(index < 0, index + n, index)
    filled = (index < 0) | (index >= n)
    return index.clamp(0, n - 1), filled


def take_rows(x, index):
    """≙ jnp.take(x, index, axis=0): rows of x picked by an index of any
    shape, out-of-range rows filled as jax fills them."""
    index, filled = index_in_range(index, x.shape[0])
    filled = filled.reshape(filled.shape + (1,) * (x.dim() - 1))
    return x[index].masked_fill(filled, fill_value(x.dtype))


def take_along(x, index, dim):
    """≙ jnp.take_along_axis(x, index, dim): entries of x picked along
    `dim`, out-of-range ones filled as jax fills them."""
    index, filled = index_in_range(index, x.shape[dim])
    return x.gather(dim, index).masked_fill(filled, fill_value(x.dtype))


@register_op("reshape")
def _reshape(ctx, ins, attrs):
    x = ins["X"][0]
    shape = list(attrs["shape"])
    # reference reshape semantics: 0 means copy dim from input, -1 inferred
    for i, d in enumerate(shape):
        if d == 0:
            shape[i] = x.shape[i]
    return {"Out": [x.reshape(shape)]}


@register_op("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(*attrs["axis"])]}


@register_op("concat")
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("slice")
def _slice(ctx, ins, attrs):
    x = ins["X"][0]
    idx = [slice(None)] * x.dim()
    for ax, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[ax] = slice(s, e)
    return {"Out": [x[tuple(idx)]]}


@register_op("gather")
def _gather(ctx, ins, attrs):
    # ≙ jnp.take(x, index, axis=0): rows of x picked by an index of any shape
    return {"Out": [take_rows(ins["X"][0], ins["Index"][0])]}


@register_op("squeeze")
def _squeeze(ctx, ins, attrs):
    # ≙ jnp.squeeze: the listed axes (all size-1 dims when none are
    # listed); a listed axis whose size is not 1 raises, as there (torch
    # would keep it silently)
    x = ins["X"][0]
    axes = attrs.get("axes") or None
    if not axes:
        return {"Out": [x.squeeze()]}
    wide = [a for a in axes if x.shape[a] != 1]
    enforce(not wide, "squeeze: axes %s of X %s are not of size 1", wide,
            list(x.shape), exc=InvalidArgumentError)
    return {"Out": [x.squeeze(tuple(axes))]}


@register_op("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    axes = attrs["axes"]
    # ≙ jnp.expand_dims: axes index the OUTPUT's dims
    out_ndim = x.dim() + len(axes)
    for ax in sorted(a % out_ndim for a in axes):
        x = x.unsqueeze(ax)
    return {"Out": [x]}


def _check(cond: torch.Tensor, msg: str):
    """Raise `msg` unless `cond` holds. On a CPU tensor it raises here. On
    a CUDA tensor the check runs on the device without a host round trip:
    a failing check is a device-side assert, which raises at the next sync
    and leaves the CUDA context unusable (every later CUDA call in the
    process fails), so a CUDA caller must keep its positions in range.
    The serving engine does: it retires a slot before its row is full."""
    torch._assert_async(cond, msg)


@register_op("cache_write")
def _cache_write(ctx, ins, attrs):
    """Write `New` into `Cache` at position `Pos` along `axis` — the KV-cache
    decode idiom (≙ tensor_ops.py:162-213, a dynamic_update_slice there).

    When the op's output variable is its Cache input (the serving tick's
    persistable caches), the rows are written into the cache tensor in
    place; otherwise into a copy.

    - batch_axis None (default): `Pos` must be UNIFORM — one position for
      the whole batch (every element equal).
    - batch_axis set: `Pos` holds ONE position PER ROW of `Cache` along
      `batch_axis` and each row is written at its own position — the
      slot-indexed cache of the continuous-batching engine.

    A position whose rows would overhang the cache raises; jax's
    dynamic_update_slice would clamp it and silently move the write."""
    cache = ins["Cache"][0]
    new = ins["New"][0].to(cache.dtype)
    pos_flat = ins["Pos"][0].reshape(-1)
    nd = cache.dim()
    axis = attrs["axis"] % nd
    batch_axis = attrs.get("batch_axis", None)
    out = cache if ctx.writes_input("Cache", "Out") else cache.clone()
    t, width = cache.shape[axis], new.shape[axis]
    pos = pos_flat.to(torch.long)
    if batch_axis is None:
        _check((pos == pos[0]).all(),
               "cache_write requires a uniform position across rows "
               "(contract: Pos is one scalar broadcast to the batch); pass "
               "batch_axis for per-row positions")
        pos = pos[:1]
        c = out.movedim(axis, 0).unsqueeze(0)     # views of `out`
        n = new.movedim(axis, 0).unsqueeze(0)
    else:
        ba = batch_axis % nd
        if ba == axis:
            raise ValueError("cache_write: batch_axis must differ from axis")
        if pos.shape[0] != cache.shape[ba]:
            raise ValueError(
                f"cache_write: per-slot Pos has {pos.shape[0]} entries "
                f"but Cache dim {ba} is {cache.shape[ba]}")
        c = out.movedim((ba, axis), (0, 1))
        n = new.movedim((ba, axis), (0, 1))
    _check(((pos >= 0) & (pos + width <= t)).all(),
           f"cache_write: a position lies outside [0, {t - width}] along "
           f"cache axis {axis} (length {t}, rows written {width})")
    rows = torch.arange(c.shape[0], device=pos.device).unsqueeze(1)
    cols = pos.unsqueeze(1) + torch.arange(width, device=pos.device)
    c[rows, cols] = n
    return {"Out": [out]}


def _paged_targets(name, pool, new, ins):
    """(blocks, offsets) of a paged write as long tensors, after the shape
    checks both paged writes make."""
    blocks = ins["BlockIds"][0].reshape(-1).to(torch.long)
    offs = ins["Offsets"][0].reshape(-1).to(torch.long)
    if new.dim() != pool.dim() - 1:
        raise ValueError(
            f"{name}: New must drop exactly the pool's block-size axis "
            f"(pool {tuple(pool.shape)}, New {tuple(new.shape)})")
    if blocks.shape != offs.shape:
        raise ValueError(
            f"{name}: BlockIds {tuple(blocks.shape)} and Offsets "
            f"{tuple(offs.shape)} must agree")
    return blocks, offs


@register_op("paged_cache_write")
def _paged_cache_write(ctx, ins, attrs):
    """Block-granular KV write for the paged cache (≙ tensor_ops.py:216):
    one new token row per slot into a block POOL [n_blocks, nh,
    block_size, dh] instead of a per-slot cache row. `New` is [S, nh, dh]
    (or [S*G, nh, dh] for a verify window), `BlockIds`/`Offsets` are [S]
    (or [S, G]) — row i lands at pool[BlockIds[i], :, Offsets[i], :].
    Idle slots are steered at the reserved null block 0 (never mapped by a
    live block table), so one fixed-shape tick serves any mix of live and
    idle slots; duplicate targets are only ever the null block, where any
    write order will do. When the op's output is its Cache input (the
    tick's persistable pool) the rows land in the pool tensor in place
    (index_put_, no host sync); otherwise in a copy."""
    pool = ins["Cache"][0]
    new = ins["New"][0].to(pool.dtype)
    blocks, offs = _paged_targets("paged_cache_write", pool, new, ins)
    out = pool if ctx.writes_input("Cache", "Out") else pool.clone()
    out[blocks, :, offs, :] = new
    return {"Out": [out]}


@register_op("paged_cache_write_quant")
def _paged_cache_write_quant(ctx, ins, attrs):
    """int8 variant of `paged_cache_write` (≙ tensor_ops.py:245): the pool
    holds int8 payloads and `Scales` [n_blocks, nh, block_size, 1] one f32
    scale per row; each incoming row is quantized symmetrically over its
    dh vector on the way in — amax/127 per (slot, head) row, an all-zero
    row at scale 1.0 so it dequantizes exactly. In place under the same
    rule as `paged_cache_write`, for the pool and the scales each."""
    pool, scales = ins["Cache"][0], ins["Scales"][0]
    new = ins["New"][0].to(torch.float32)
    blocks, offs = _paged_targets("paged_cache_write_quant", pool, new, ins)
    amax = new.abs().amax(dim=-1, keepdim=True)
    sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(new / sc), -127, 127).to(torch.int8)
    out = pool if ctx.writes_input("Cache", "Out") else pool.clone()
    sout = scales if ctx.writes_input("Scales", "ScalesOut") \
        else scales.clone()
    out[blocks, :, offs, :] = q
    sout[blocks, :, offs, :] = sc
    return {"Out": [out], "ScalesOut": [sout]}


@register_op("one_hot")
def _one_hot(ctx, ins, attrs):
    x = ins["X"][0]
    depth = attrs["depth"]
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    # an index outside [0, depth) gives an all-zero row, as jax.nn.one_hot
    classes = torch.arange(depth, device=x.device, dtype=x.dtype)
    return {"Out": [(x.unsqueeze(-1) == classes).to(torch.float32)]}


def float_to_int(x, dtype):
    """≙ XLA's convert from a floating type to an integer one: toward zero,
    saturating at the type's least and greatest values, NaN to 0 (torch's
    own conversion leaves the out-of-range and NaN cases undefined)."""
    info = torch.iinfo(dtype)
    # the bounds round to x's type (2^31 - 1 to 2^31 in float32): a value
    # at or past them saturates, every value inside converts exactly
    hi, lo = x >= info.max, x <= info.min
    out = torch.where(hi | lo | x.isnan(), torch.zeros((), dtype=x.dtype,
                                                       device=x.device), x)
    return out.to(dtype).masked_fill(hi, info.max).masked_fill(lo, info.min)


@register_op("cast")
def _cast(ctx, ins, attrs):
    x = ins["X"][0]
    dtype = convert_dtype(attrs["out_dtype"])
    if x.is_floating_point() and not dtype.is_floating_point \
            and dtype != torch.bool:
        return {"Out": [float_to_int(x, dtype)]}
    return {"Out": [x.to(dtype)]}


@register_op("fill_constant")
def _fill_constant(ctx, ins, attrs):
    dtype = convert_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(list(attrs["shape"]), attrs["value"],
                               dtype=dtype, device=ctx.device)]}


@register_op("fill_constant_batch_size_like")
def _fill_constant_bsl(ctx, ins, attrs):
    ref = ins["Input"][0]
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = ref.shape[
        attrs.get("input_dim_idx", 0)]
    return {"Out": [torch.full(shape, attrs["value"],
                               dtype=convert_dtype(attrs.get("dtype",
                                                             "float32")),
                               device=ctx.device)]}


@register_op("assign_value")
def _assign_value(ctx, ins, attrs):
    def make():
        return torch.tensor(attrs["values"],
                            dtype=convert_dtype(attrs["dtype"]),
                            device=ctx.device).reshape(attrs["shape"])
    return {"Out": [ctx.constant(make)]}


@register_op("lookup_table")
def _lookup_table(ctx, ins, attrs):
    """Embedding lookup (≙ lookup_table_op.cc:21)."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = take_rows(w, ids)
    padding_idx = attrs.get("padding_idx", None)
    if padding_idx is not None:
        if padding_idx < 0:  # negative indexes from the end, as in reference
            padding_idx += w.shape[0]
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return {"Out": [out]}


@register_op("qlookup")
def _qlookup(ctx, ins, attrs):
    """Weight-only quantized embedding lookup (quantize_params_pass rewrite
    of `lookup_table`, ≙ tensor_ops.py:381): gathers int8/int4 payload
    ROWS plus their row-block scales and dequantizes only the gathered
    rows — the float32 table is never made. Out-of-range ids take jax's
    fill rows, as `lookup_table`'s do."""
    qw, scales, ids = ins["QW"][0], ins["Scales"][0], ins["Ids"][0]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    idx, filled = index_in_range(ids, qw.shape[0])
    rows = qw[idx]
    if attrs.get("bits", 8) == 4:
        from ..parallel.collective import unpack_int4
        lead, c2 = tuple(rows.shape[:-1]), rows.shape[-1]
        rows = unpack_int4(rows.reshape(-1, c2)).reshape(lead + (2 * c2,))
    nr, nc = scales.shape
    br = qw.shape[0] // nr
    bc = rows.shape[-1] // nc
    s = scales[torch.div(idx, br, rounding_mode="floor")]     # [..., nc]
    out = (rows.to(torch.float32).reshape(tuple(rows.shape[:-1]) + (nc, bc))
           * s[..., :, None]).reshape(rows.shape)
    out = out.masked_fill(filled.unsqueeze(-1), float("nan"))
    padding_idx = attrs.get("padding_idx", None)
    if padding_idx is not None:
        if padding_idx < 0:
            padding_idx += qw.shape[0]
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return {"Out": [out]}


@register_op("increment")
def _increment(ctx, ins, attrs):
    """X + step in X's dtype (an int64 step counter stays int64). Where
    the output variable is X itself (the learning-rate schedules' step
    counter, a persistable), the tensor is updated in place, once a run."""
    x = ins["X"][0]
    step = attrs.get("step", 1.0)
    if not x.is_floating_point():
        step = int(step)
    if ctx.writes_input("X", "Out"):
        return {"Out": [x.add_(step)]}
    return {"Out": [x + step]}


@register_op("piecewise_decay")
def _piecewise_decay(ctx, ins, attrs):
    """values[i] for the step's place among the boundaries: the number of
    boundaries at or below the step (≙ searchsorted side="right"), with
    no branch and no device->host sync: both tables are copied to the
    device once per plan (`LowerCtx.constant`), not once a run."""
    step = ins["Step"][0].reshape(())

    def make():
        return (torch.tensor(attrs["boundaries"], dtype=step.dtype,
                             device=step.device),
                torch.tensor(attrs["values"], dtype=torch.float32,
                             device=step.device))
    boundaries, values = ctx.constant(make)
    idx = (boundaries <= step).sum().reshape(1)
    # index_select: indexing with a 0-d tensor reads it on the host
    return {"Out": [values.index_select(0, idx)]}


# --- sparse-table helpers ------------------------------------------------
# ≙ split_ids_op / merge_ids_op / lookup_sparse_table_op, the pserver
# row-dispatch family (JAX: tensor_ops.py:540-601). Static shapes: shard
# membership is a mask, outputs are padded to the input length with -1 ids
# and zero rows, and the counts come back alongside. Ids live in the int32
# space, as in the JAX package (which runs without x64).

_INVALID_ID = -(2 ** 31 - 1)


def _as_id32(ids):
    """int32 ids; an id beyond the int32 range becomes the invalid sentinel
    (negative) rather than wrapping into another row."""
    if ids.dtype == torch.int64:
        ids = torch.where(ids.abs() > 2 ** 31 - 1, _INVALID_ID, ids)
    return ids.to(torch.int32)


@register_op("split_ids")
def _split_ids(ctx, ins, attrs):
    """Ids partitioned across `num_shards` by modulo: one [N] id tensor per
    shard (its ids in order, then -1) and the [num_shards] counts."""
    ids = _as_id32(ins["Ids"][0].reshape(-1))
    n, size = attrs["num_shards"], ids.shape[0]
    outs, counts = [], []
    for s in range(n):
        mask = (ids % n) == s
        pos = torch.cumsum(mask.to(torch.int32), 0) - 1
        at = torch.where(mask, pos, size).to(torch.long)
        buf = torch.full((size + 1,), -1, dtype=torch.int32,
                         device=ids.device).scatter_(0, at, ids)
        outs.append(buf[:-1])
        counts.append(mask.sum(dtype=torch.int32))
    return {"Out": outs, "Count": [torch.stack(counts)]}


@register_op("merge_ids")
def _merge_ids(ctx, ins, attrs):
    """Per-shard row values (split_ids' order) routed back to the order of
    the original ids."""
    ids = _as_id32(ins["Ids"][0].reshape(-1))
    shard_rows = ins["Rows"]
    n = len(ins["X"])
    out = torch.zeros((ids.shape[0], shard_rows[0].shape[-1]),
                      dtype=shard_rows[0].dtype, device=ids.device)
    for s in range(n):
        mask = (ids % n) == s
        pos = (torch.cumsum(mask.to(torch.int32), 0) - 1).clamp_min(0)
        out = torch.where(mask[:, None], shard_rows[s][pos.to(torch.long)],
                          out)
    return {"Out": [out]}


@register_op("lookup_sparse_table")
def _lookup_sparse_table(ctx, ins, attrs):
    """Rows of a table shard by id; padded (-1) ids give zero rows (the
    reference grows unseen rows; the static form returns their init, 0)."""
    w = ins["W"][0]
    ids = _as_id32(ins["Ids"][0].reshape(-1))
    valid = ids >= 0
    rows = take_rows(w, torch.where(valid, ids, 0))
    return {"Out": [torch.where(valid[:, None], rows, 0.0)]}


@register_op("expand")
def _expand(ctx, ins, attrs):
    """≙ jnp.tile(x, expand_times): X repeated along each dim (times
    shorter than X's rank count for its trailing dims)."""
    x = ins["X"][0]
    times = list(attrs["expand_times"])
    times = [1] * (x.dim() - len(times)) + times
    return {"Out": [x.repeat(*times)]}


@register_op("assign")
def _assign(ctx, ins, attrs):
    # a copy: an in-place update of X (an optimizer op, an in-place
    # increment) must not reach the assigned variable
    return {"Out": [ins["X"][0].clone()]}


# --- tensor arrays (≙ tensor_array_read_write.cc over a preallocated
# [max_len, ...] array, the JAX package's static-shape translation of the
# reference's growing LoDTensorArray). The index lives on the device; as
# jax's dynamic index, one in [-max_len, 0) counts from the end and any
# other is clamped into [0, max_len). No value is read on the host.


def _array_index(i, cap, what):
    """The array index `i` (one element) as a [1] long tensor in [0, cap),
    wrapped and clamped as jax's dynamic index. Under the check_nan_inf
    flag an index outside [0, cap) raises IndexError on a CPU tensor (≙
    the JAX package's `_array_bounds_guard`, a CPU-debug facility there
    too)."""
    from ..core import flags
    i = i.reshape(1).to(torch.long)
    if flags.get_flag("check_nan_inf") and i.device.type == "cpu":
        iv = int(i[0])
        if iv < 0 or iv >= cap:
            raise IndexError(f"{what} index {iv} outside preallocated "
                             f"capacity {cap}")
    return index_in_range(i, cap)[0]


@register_op("array_write")
def _array_write(ctx, ins, attrs):
    """≙ WriteToArray: the array with X written at index I (a new tensor;
    the builder threads the returned variable)."""
    arr = ins["Array"][0]
    i = _array_index(ins["I"][0], arr.shape[0], "array_write")
    return {"Out": [arr.index_copy(0, i, ins["X"][0].to(arr.dtype)[None])]}


@register_op("array_read")
def _array_read(ctx, ins, attrs):
    """≙ ReadFromArray: the element at index I."""
    arr = ins["Array"][0]
    i = _array_index(ins["I"][0], arr.shape[0], "array_read")
    return {"Out": [arr.index_select(0, i)[0]]}


@register_op("array_length")
def _array_length(ctx, ins, attrs):
    """≙ lod_array_length_op: the array's (static) capacity."""
    x = ins["X"][0]
    return {"Out": [torch.full((), x.shape[0], dtype=torch.int64,
                               device=x.device)]}


# --- the rest of the tensor library -------------------------------------


@register_op("split")
def _split(ctx, ins, attrs):
    """≙ jnp.split: at the running sums of `sections` (the last piece runs
    to the end of the axis, whatever the last section says), or into
    `num` equal pieces; a `num` that does not divide the axis raises, as
    jnp.split does."""
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    if attrs.get("sections"):
        cuts = [int(c) for c in np.cumsum(attrs["sections"])[:-1]]
        return {"Out": list(torch.tensor_split(x, cuts, dim=axis))}
    num = attrs["num"]
    enforce(x.shape[axis] % num == 0,
            "split: axis %d of size %d does not divide into %d equal "
            "pieces", axis, x.shape[axis], num, exc=InvalidArgumentError)
    return {"Out": list(torch.chunk(x, num, dim=axis))}


@register_op("scatter")
def _scatter(ctx, ins, attrs):
    """≙ x.at[Ids].set(Updates) (or .add when not `overwrite`): an index
    in [-n, 0) counts from the end, any other outside [0, n) is dropped
    (jax's scatter mode), by writing it to a spare row cut off after."""
    x, index, updates = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    n = x.shape[0]
    index = index.to(torch.long)
    index = torch.where(index < 0, index + n, index)
    index = torch.where((index < 0) | (index >= n), n, index)
    spare = torch.cat([x, x[:1]], dim=0)
    out = torch.index_put(spare, (index,), updates.to(x.dtype),
                          accumulate=not attrs.get("overwrite", True))
    return {"Out": [out[:n]]}


@register_op("stack")
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("unstack")
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))}


@register_op("flatten")
def _flatten(ctx, ins, attrs):
    # [prod(dims before axis), prod(the rest)]
    x = ins["X"][0]
    ax = attrs.get("axis", 1)
    lead = int(np.prod(x.shape[:ax])) if ax > 0 else 1
    return {"Out": [x.reshape(lead, -1)]}


@register_op("expand_as")
def _expand_as(ctx, ins, attrs):
    return {"Out": [ins["X"][0].expand(ins["Y"][0].shape)]}


def _pad_to(x, pairs, value):
    # F.pad takes (before, after) pairs from the last dim backwards
    flat = [p for pair in reversed(pairs) for p in pair]
    return F.pad(x, flat, value=value)


@register_op("pad")
def _pad(ctx, ins, attrs):
    # paddings flat: [before0, after0, before1, after1, ...]
    x = ins["X"][0]
    p = attrs["paddings"]
    return {"Out": [_pad_to(x, [(p[2 * i], p[2 * i + 1])
                                for i in range(x.dim())],
                            attrs.get("pad_value", 0.0))]}


@register_op("pad_constant_like")
def _pad_constant_like(ctx, ins, attrs):
    # Y padded after each dim to X's shape
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [_pad_to(y, [(0, xd - yd)
                                for xd, yd in zip(x.shape, y.shape)],
                            attrs.get("pad_value", 0.0))]}


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register_op("shape")
def _shape(ctx, ins, attrs):
    # built once per plan: the shape is static, and a tensor made from a
    # host list waits for the stream on a card
    x = ins["Input"][0]
    return {"Out": [ctx.constant(lambda: torch.tensor(
        list(x.shape), dtype=torch.int64, device=x.device))]}


@register_op("reverse")
def _reverse(ctx, ins, attrs):
    axis = attrs["axis"]
    axis = [axis] if isinstance(axis, int) else list(axis)
    return {"Out": [torch.flip(ins["X"][0], dims=axis)]}


@register_op("multiplex")
def _multiplex(ctx, ins, attrs):
    """Row i of candidate Ids[i] (≙ jax's indexing: an id in [-n, 0) counts
    from the end, any other is clamped into range)."""
    stacked = torch.stack(ins["X"], dim=0)     # [n_candidates, batch, ...]
    ids = index_in_range(ins["Ids"][0].reshape(-1), stacked.shape[0])[0]
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return {"Out": [stacked[ids, rows]]}


@register_op("crop")
def _crop(ctx, ins, attrs):
    x = ins["X"][0]
    idx = tuple(slice(o, o + s)
                for o, s in zip(attrs["offsets"], attrs["shape"]))
    return {"Out": [x[idx]]}


@register_op("label_smooth")
def _label_smooth(ctx, ins, attrs):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    if ins.get("PriorDist"):
        return {"Out": [(1 - eps) * x + eps * ins["PriorDist"][0]]}
    return {"Out": [(1 - eps) * x + eps / x.shape[-1]]}


@register_op("print")
def _print(ctx, ins, attrs):
    """≙ print_op, a debugging dump: it reads the tensor on the host (a
    sync on a card) and lies on no training or serving path."""
    x = ins["In"][0]
    print(f"{attrs.get('message', 'print_op')}: {x.detach().cpu().numpy()}",
          flush=True)
    return {"Out": [x]}


@register_op("arange")
def _arange(ctx, ins, attrs):
    return {"Out": [torch.arange(
        attrs["start"], attrs["end"], attrs["step"],
        dtype=convert_dtype(attrs.get("dtype", "int64")),
        device=ctx.device)]}


@register_op("cumsum")
def _cumsum(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("reverse", False):
        x = torch.flip(x, dims=[axis])
    # jnp keeps an integer type's width (torch would widen to int64)
    out = torch.cumsum(x, dim=axis, dtype=None if x.is_floating_point()
                       else x.dtype)
    if attrs.get("exclusive", False):
        out = torch.cat([torch.zeros_like(out.narrow(axis, 0, 1)),
                         out.narrow(axis, 0, out.shape[axis] - 1)], dim=axis)
    if attrs.get("reverse", False):
        out = torch.flip(out, dims=[axis])
    return {"Out": [out]}
