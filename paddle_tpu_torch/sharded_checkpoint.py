"""Sharded (per-process) checkpointing: tensorstore-style save/restore.

≙ paddle_tpu/sharded_checkpoint.py, in its layout. Each process writes
ONLY the blocks its scope holds — a native tensor container
(`shard-<p>.pts`) plus a JSON manifest (`manifest-<p>.json`) mapping each
chunk to its global-offset slice. A restore reads, per rank, only the
chunks its new block intersects, straight into a tensor on the
executor's device, so state that never fits one process (ZeRO-1
accumulators, tp blocks) round-trips without a gather and onto any new
mesh.

The JAX package reads `jax.Array.addressable_shards`; the port's ranks
are processes whose scopes hold their own blocks, placed by the
executor's `Placement` (`ParallelExecutor.state_sharding`): rank r writes
the block at its mesh coordinates. A block replicated over some axes is
written once, by the rank at coordinate 0 of those axes (JAX's
`replica_id == 0`).

Layout of a checkpoint directory:
    shard-0.pts      chunks owned by process 0 (native container)
    manifest-0.json  {var: {shape, dtype, chunks: [{start, shape, file,
                      key}]}}, plus {"__meta__": {"world_size": N}}
    shard-1.pts, manifest-1.json, ...

Chunk keys are `name@start,...` (global start offsets).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.enforce import InvalidArgumentError, NotFoundError, enforce

MANIFEST_PREFIX = "manifest-"
SHARD_PREFIX = "shard-"


def dtype_name(t) -> str:
    """The manifest's dtype string (numpy's names; bfloat16 included)."""
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(np.asarray(t).dtype)


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


def block_of(mesh, placement, rank: int, shape: Sequence[int]
             ) -> Tuple[List[int], List[int], bool]:
    """(start, block shape, writer) of `rank`'s block of a tensor of global
    `shape` placed by `placement` over `mesh`: each split dim cut into
    equal blocks by the rank's coordinate(s) on its axis name(s), the
    first name major (as `DeviceMesh.local_slice`). `writer` is True for
    the rank at coordinate 0 of every mesh axis the placement does not
    split over: the one that writes this replicated block."""
    shape = [int(d) for d in shape]
    if mesh is None:
        return [0] * len(shape), shape, True
    coords = mesh.coords(rank)
    used = set()
    start, block = [0] * len(shape), list(shape)
    for d, s in enumerate(placement or ()):
        if s is None or d >= len(shape):
            continue
        names = s if isinstance(s, (tuple, list)) else (s,)
        parts, idx = 1, 0
        for a in names:
            idx = idx * mesh.axes.get(a, 1) + coords.get(a, 0)
            parts *= mesh.axes.get(a, 1)
            used.add(a)
        enforce(shape[d] % parts == 0,
                f"dim {d} of size {shape[d]} does not split into {parts} "
                f"blocks over {names}", exc=InvalidArgumentError)
        block[d] = shape[d] // parts
        start[d] = idx * block[d]
    writer = all(c == 0 for a, c in coords.items() if a not in used)
    return start, block, writer


def collect_chunks(arrays: Dict[str, object],
                   process_index: int = 0,
                   world_size: int = 1,
                   mesh=None,
                   placements: Optional[Dict[str, object]] = None,
                   rank: Optional[int] = None,
                   shapes: Optional[Dict[str, Sequence[int]]] = None,
                   local: bool = True):
    """The selection phase of a sharded save, split out so an async
    snapshot (parallel/elastic.py) can copy the chunks off the card at a
    step boundary and hand the file writes to a background thread.

    `arrays` maps name -> value. With `local=True` (a rank of a world)
    each value is `rank`'s own block of the global tensor, whose shape
    `shapes[name]` gives; with `local=False` (one process holding every
    value whole) the block is cut here. `placements[name]` places it over
    `mesh` (None: replicated). Returns (chunks, manifest, pid): `chunks`
    maps chunk key -> tensor (on the value's device, not yet copied),
    `manifest` is the per-process manifest referencing them."""
    pid = int(process_index)
    placements = placements or {}
    shapes = shapes or {}
    rank = rank if rank is not None else (
        mesh.rank if mesh is not None else 0)
    chunks: Dict[str, torch.Tensor] = {}
    manifest: Dict[str, dict] = {"__meta__": {"world_size": int(world_size)}}
    shard_file = f"{SHARD_PREFIX}{pid}.pts"
    for name, value in arrays.items():
        t = _as_tensor(value)
        gshape = list(shapes.get(name) or t.shape) if local else \
            list(t.shape)
        start, block, writer = block_of(mesh, placements.get(name), rank,
                                        gshape)
        if not writer:
            continue
        if local:
            enforce(list(t.shape) == block,
                    f"{name!r}: this rank holds shape {list(t.shape)}, its "
                    f"placement's block is {block}", exc=InvalidArgumentError)
        else:
            for d, (a, n) in enumerate(zip(start, block)):
                if n != gshape[d]:
                    t = t.narrow(d, a, n)
        key = name + "@" + ",".join(map(str, start))
        chunks[key] = t
        manifest[name] = {"shape": gshape, "dtype": dtype_name(t),
                          "chunks": [{"start": start, "shape": block,
                                      "file": shard_file, "key": key}]}
    return chunks, manifest, pid


def _fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def truncate_payload_at(dirname: str, offset: int,
                        exclude: Sequence[str] = ()) -> bool:
    """Make `dirname` look exactly as if a sequential writer died `offset`
    bytes into its payload: truncate the file holding that offset, delete
    everything after it (name order; `.tmp` files and `exclude` names are
    not payload). Returns False when the offset lies beyond the payload
    (nothing touched) — the one copy of the crash-offset accounting that
    elastic's crash_mid_save and process_world's crash_rank share."""
    names = sorted(n for n in os.listdir(dirname)
                   if n not in exclude and not n.endswith(".tmp"))
    cum = 0
    for i, n in enumerate(names):
        sz = os.path.getsize(os.path.join(dirname, n))
        if offset < cum + sz:
            with open(os.path.join(dirname, n), "r+b") as f:
                f.truncate(offset - cum)
            for later in names[i + 1:]:
                os.unlink(os.path.join(dirname, later))
            return True
        cum += sz
    return False


def write_chunks(dirname: str, chunks: Dict[str, object],
                 manifest: Dict[str, dict], pid: int,
                 fsync: bool = False) -> str:
    """The file-write phase of a sharded save (see collect_chunks): the
    container first, then the manifest, each written to a temp name and
    renamed. fsync=True forces both to stable storage before returning —
    the elastic commit protocol needs it (the COMMIT marker must never
    become visible before the data it names). Returns the manifest
    path."""
    from .data.tensor_store import save_tensors
    os.makedirs(dirname, exist_ok=True)
    spath = os.path.join(dirname, f"{SHARD_PREFIX}{pid}.pts")
    save_tensors(spath + ".tmp", chunks)
    os.replace(spath + ".tmp", spath)
    mpath = os.path.join(dirname, f"{MANIFEST_PREFIX}{pid}.json")
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, mpath)  # atomic: a crash never clobbers a good manifest
    if fsync:
        _fsync_file(spath)
        _fsync_file(dirname)
    return mpath


def save_sharded(dirname: str, arrays: Dict[str, object],
                 process_index: int = 0, world_size: int = 1,
                 mesh=None, placements=None, shapes=None,
                 fsync: bool = False) -> str:
    """Write this process's blocks of `arrays` (see collect_chunks) to
    `dirname`. The manifest records `world_size`; a reader refuses a
    directory whose manifest count does not match it, so a re-save from a
    smaller world over an old directory errors instead of stitching stale
    shard files in. Returns the manifest path."""
    chunks, manifest, pid = collect_chunks(
        arrays, process_index=process_index, world_size=world_size,
        mesh=mesh, placements=placements, shapes=shapes,
        local=shapes is not None)
    return write_chunks(dirname, {k: v.cpu() for k, v in chunks.items()},
                        manifest, pid, fsync=fsync)


def _torch_dtype(name: str) -> torch.dtype:
    enforce(hasattr(torch, name), f"unknown checkpoint dtype {name!r}",
            exc=InvalidArgumentError)
    return getattr(torch, name)


class ShardedCheckpoint:
    """Reader over all manifests of a checkpoint directory. Chunk data is
    loaded lazily per (file, key) and cached, so restoring a block reads
    only the chunks it intersects; `loaded` lists the (file, key) pairs
    read so far, in order, and `read_bytes` counts the bytes read_slice
    copied out of them."""

    def __init__(self, dirname: str):
        self.dirname = dirname
        paths = sorted(glob.glob(
            os.path.join(dirname, MANIFEST_PREFIX + "*.json")))
        if not paths:
            raise NotFoundError(f"no sharded checkpoint under {dirname!r} "
                                f"(no {MANIFEST_PREFIX}*.json)")
        self.vars: Dict[str, dict] = {}
        world_sizes = set()
        for p in paths:
            try:
                with open(p) as f:
                    m = json.load(f)
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise InvalidArgumentError(
                    f"checkpoint dir {dirname!r}: manifest "
                    f"{os.path.basename(p)!r} is truncated or corrupt "
                    f"({e}) — an interrupted save? Restore from a "
                    f"committed snapshot instead") from e
            meta = m.pop("__meta__", None)
            if meta is not None:
                world_sizes.add(int(meta.get("world_size", len(paths))))
            for name, entry in m.items():
                known = self.vars.get(name)
                if known is None:
                    self.vars[name] = {"shape": entry["shape"],
                                       "dtype": entry["dtype"],
                                       "chunks": list(entry["chunks"])}
                else:
                    enforce(known["shape"] == entry["shape"] and
                            known["dtype"] == entry["dtype"],
                            f"manifests disagree on {name!r}",
                            exc=InvalidArgumentError)
                    known["chunks"].extend(entry["chunks"])
        if world_sizes:
            enforce(len(world_sizes) == 1 and
                    world_sizes == {len(paths)},
                    f"checkpoint dir {dirname!r} holds {len(paths)} "
                    f"manifest(s) but the save recorded world_size"
                    f"={sorted(world_sizes)} — stale files from an earlier "
                    f"save with a different process count? Save into a "
                    f"fresh directory.", exc=InvalidArgumentError)
        self._cache: Dict[tuple, torch.Tensor] = {}
        self._readers: Dict[str, object] = {}
        self.loaded: List[Tuple[str, str]] = []
        #: bytes copied out of chunks by read_slice (the intersections)
        self.read_bytes = 0
        missing = sorted({e["file"] for v in self.vars.values()
                          for e in v["chunks"]
                          if not os.path.exists(
                              os.path.join(dirname, e["file"]))})
        enforce(not missing,
                f"checkpoint dir {dirname!r} is missing shard container(s) "
                f"{missing} referenced by its manifest(s) — a partially "
                f"written or partially deleted save. Restore from a "
                f"committed snapshot instead", exc=InvalidArgumentError)

    def names(self) -> List[str]:
        return sorted(self.vars)

    def _chunk(self, c) -> torch.Tensor:
        key = (c["file"], c["key"])
        if key not in self._cache:
            from .data.tensor_store import Reader
            try:
                reader = self._readers.get(c["file"])
                if reader is None:
                    reader = self._readers[c["file"]] = Reader(
                        os.path.join(self.dirname, c["file"]))
                got = reader.read(c["key"])
            except (IOError, OSError, KeyError, ValueError) as e:
                raise InvalidArgumentError(
                    f"checkpoint dir {self.dirname!r}: shard container "
                    f"{c['file']!r} is truncated or corrupt reading chunk "
                    f"{c['key']!r} ({e}) — an interrupted save? Restore "
                    f"from a committed snapshot instead") from e
            self._cache[key] = got
            self.loaded.append(key)
        return self._cache[key]

    def close(self):
        """Release the open containers and the chunks read."""
        for r in self._readers.values():
            r.close()
        self._readers.clear()
        self._cache.clear()

    def read_slice(self, name: str, index) -> torch.Tensor:
        """Assemble the sub-tensor `index` (a tuple of slices in global
        coordinates) of var `name` from every chunk it intersects, as a
        CPU tensor in the saved dtype."""
        if name not in self.vars:
            raise NotFoundError(f"{name!r} not in checkpoint")
        entry = self.vars[name]
        shape = entry["shape"]
        starts, stops = [], []
        for sl, dim in zip(index, shape):
            a, b, step = sl.indices(dim)
            enforce(step == 1, "strided restore not supported",
                    exc=InvalidArgumentError)
            starts.append(a)
            stops.append(b)
        whole = [c for c in entry["chunks"]
                 if list(c["start"] or [0] * len(shape)) == starts
                 and list(c["shape"]) == [b - a for a, b in
                                          zip(starts, stops)]]
        if whole:
            # one chunk is exactly the slice: handed over, not assembled
            t = self._chunk(whole[0]).reshape(
                [b - a for a, b in zip(starts, stops)])
            self._cache.pop((whole[0]["file"], whole[0]["key"]))
            self.read_bytes += t.numel() * t.element_size()
            return t
        out = torch.empty([b - a for a, b in zip(starts, stops)],
                          dtype=_torch_dtype(entry["dtype"]))
        filled = torch.zeros(out.shape, dtype=torch.bool) \
            if entry["chunks"] else None
        for c in entry["chunks"]:
            c_start = c["start"] or [0] * len(shape)
            c_stop = [s + d for s, d in zip(c_start, c["shape"])]
            inter_a = [max(a, ca) for a, ca in zip(starts, c_start)]
            inter_b = [min(b, cb) for b, cb in zip(stops, c_stop)]
            if any(a >= b for a, b in zip(inter_a, inter_b)) and out.dim():
                continue
            dst = tuple(slice(a - o, b - o)
                        for a, b, o in zip(inter_a, inter_b, starts))
            src = tuple(slice(a - o, b - o)
                        for a, b, o in zip(inter_a, inter_b, c_start))
            if out.dim() == 0:
                out.copy_(self._chunk(c).reshape(()))
            else:
                out[dst] = self._chunk(c)[src]
            self.read_bytes += int(np.prod(
                [b - a for a, b in zip(inter_a, inter_b)],
                dtype=np.int64)) * out.element_size()
            if filled is not None:
                filled[dst] = True
        if filled is not None and not bool(filled.all()):
            raise NotFoundError(
                f"checkpoint chunks do not cover the requested slice of "
                f"{name!r} (a shard file from another process is missing?)")
        return out

    def read(self, name: str) -> torch.Tensor:
        entry = self.vars[name]
        return self.read_slice(
            name, tuple(slice(0, d) for d in entry["shape"]))


def restore_array(ckpt: ShardedCheckpoint, name: str, placement=None,
                  mesh=None, device=None, rank: Optional[int] = None):
    """Var `name` from the checkpoint: with no mesh the whole tensor;
    with a mesh and a `placement`, only `rank`'s (default: this process's)
    block, read from the chunks it intersects. On `device` when given
    (else on the CPU), in the saved dtype."""
    entry = ckpt.vars.get(name)
    if entry is None:
        raise NotFoundError(f"{name!r} not in checkpoint")
    shape = entry["shape"]
    if mesh is None or placement is None:
        t = ckpt.read(name)
    else:
        rank = mesh.rank if rank is None else rank
        start, block, _ = block_of(mesh, placement, rank, shape)
        t = ckpt.read_slice(name, tuple(slice(a, a + n)
                                        for a, n in zip(start, block)))
    return t if device is None else t.to(device)


def restore_sharded(dirname: str, placements: Optional[Dict] = None,
                    names: Optional[Sequence[str]] = None, mesh=None,
                    device=None) -> Dict[str, torch.Tensor]:
    """{name: tensor} for `names` (default: everything saved), each this
    rank's block under `placements[name]` over `mesh` (whole when either
    is missing)."""
    ckpt = ShardedCheckpoint(dirname)
    placements = placements or {}
    try:
        return {name: restore_array(ckpt, name, placements.get(name), mesh,
                                    device)
                for name in (names if names is not None else ckpt.names())}
    finally:
        ckpt.close()
