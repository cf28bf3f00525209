"""Device mesh over the ranks of a torch.distributed world.

≙ paddle_tpu/parallel/mesh.py. The JAX package names a logical N-D mesh
over the devices of one SPMD program; the port has one process per rank,
so its mesh is the world's ranks laid out row-major over named axes (dp
data, tp tensor, pp pipeline, sp sequence): rank r sits where JAX device r
sits in `Mesh(np.asarray(devices).reshape(shape), axes)`. Every axis
slice gets its own process group, so a collective over an axis runs among
the ranks that differ only in that axis' coordinate.

Building a mesh is a collective call: `torch.distributed.new_group` must
be entered by every rank of the world, in the same order, so every rank
constructs the same meshes in the same order (ranks outside the mesh
included). Without a joined world a mesh's collectives are the
identity over its axes of size 1 and raise over a larger one.

`sharding(*spec)` returns a `Placement`: an axis name (or a tuple of
them) or None per dim, with the names the mesh does not have dropped —
the port's counterpart of `NamedSharding` (ROADMAP.md §3, deliberate
differences).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.enforce import InvalidArgumentError, enforce

DATA_AXIS = "dp"
MODEL_AXIS = "tp"
PIPELINE_AXIS = "pp"
SEQUENCE_AXIS = "sp"


class Placement(tuple):
    """Per-dim placement of a tensor over a mesh: an axis name, a tuple of
    axis names (the dim split over their product, the first major) or
    None (replicated) per dim. An empty placement is replicated."""

    @property
    def is_replicated(self) -> bool:
        return all(s is None for s in self)

    def __repr__(self):
        return f"Placement{tuple(self)!r}"


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


class DeviceMesh:
    """Named logical mesh over the ranks of the world.

    `ranks` defaults to every rank of the joined world (or this process
    alone when none was joined); `axes` to {"dp": len(ranks)}."""

    def __init__(self, ranks: Optional[Sequence[int]] = None,
                 axes: Optional[Dict[str, int]] = None):
        world = _world()
        if ranks is None:
            ranks = range(world[1]) if world else [0]
        ranks = [int(r) for r in ranks]
        if axes is None:
            axes = {DATA_AXIS: len(ranks)}
        n = 1
        for s in axes.values():
            n *= int(s)
        enforce(n == len(ranks),
                f"mesh axes {axes} require {n} ranks, got {len(ranks)}",
                exc=InvalidArgumentError)
        self.axes = {k: int(v) for k, v in axes.items()}
        self.ranks = ranks
        self.joined = world is not None
        self.rank = world[0] if world else ranks[0]
        self._groups: Dict[Tuple[str, int], object] = {}
        self._slices: Dict[str, List[List[int]]] = {}
        for axis in self.axis_names:
            self._slices[axis] = self._axis_slices(axis)
        self.mesh_group = None
        if self.joined:
            import torch.distributed as dist
            # every rank enters every new_group, in one order
            for axis in self.axis_names:
                for k, members in enumerate(self._slices[axis]):
                    self._groups[(axis, k)] = dist.new_group(members)
            self.mesh_group = dist.new_group(self.ranks)

    # -- layout -------------------------------------------------------------
    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axes.keys())

    def axis_size(self, name: str) -> int:
        return self.axes.get(name, 1)

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.axes.values():
            n *= s
        return n

    @property
    def in_mesh(self) -> bool:
        return self.rank in self.ranks

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The axis coordinates of `rank` (default: this process), row-major
        over `axes` as JAX lays out its mesh's devices."""
        rank = self.rank if rank is None else rank
        enforce(rank in self.ranks,
                f"rank {rank} is not in this mesh (ranks {self.ranks})",
                exc=InvalidArgumentError)
        i = self.ranks.index(rank)
        out = {}
        for name in reversed(self.axis_names):
            out[name] = i % self.axes[name]
            i //= self.axes[name]
        return {n: out[n] for n in self.axis_names}

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis `name` (0 on an absent axis)."""
        if name not in self.axes:
            return 0
        return self.coords()[name]

    def _axis_slices(self, axis: str) -> List[List[int]]:
        """The rank lists that differ only in `axis`' coordinate, each in
        coordinate order (slice k holds the ranks whose other coordinates
        read k in row-major order)."""
        names = self.axis_names
        sizes = [self.axes[n] for n in names]
        a = names.index(axis)
        out: Dict[tuple, List[int]] = {}
        for i, r in enumerate(self.ranks):
            coord, j = [], i
            for s in reversed(sizes):
                coord.append(j % s)
                j //= s
            coord.reverse()
            key = tuple(c for d, c in enumerate(coord) if d != a)
            out.setdefault(key, []).append(r)
        return [out[k] for k in sorted(out)]

    def axis_ranks(self, name: str) -> List[int]:
        """The ranks of this rank's slice of axis `name`, by coordinate."""
        if name not in self.axes:
            return [self.rank]
        return next(s for s in self._slices[name] if self.rank in s)

    def group(self, name: str):
        """The process group of this rank's slice of axis `name`; None for
        an axis of size 1 in a mesh with no joined world (a collective over
        it is the identity). An axis above 1 with no world behind it
        raises: its collectives have no peers to reach."""
        if not self.joined:
            enforce(self.axis_size(name) == 1,
                    f"axis {name!r} of {self!r} spans "
                    f"{self.axis_size(name)} ranks, but no world was joined "
                    f"(init_parallel_env, or launch for local processes): "
                    f"its collectives have no peers", exc=InvalidArgumentError)
            return None
        if name not in self.axes:
            return None
        for k, members in enumerate(self._slices[name]):
            if self.rank in members:
                return self._groups[(name, k)]
        raise InvalidArgumentError(
            f"rank {self.rank} is not in this mesh (ranks {self.ranks})")

    # -- placements ---------------------------------------------------------
    def pspec(self, *spec) -> Placement:
        """The spec with axis names not in this mesh dropped, so model code
        can annotate for the most general mesh."""
        cleaned = []
        for s in spec:
            if s is None:
                cleaned.append(None)
            elif isinstance(s, (tuple, list)):
                kept = tuple(a for a in s if a in self.axes)
                # one name left reads as that name (PartitionSpec's rule)
                cleaned.append(kept[0] if len(kept) == 1
                               else kept if kept else None)
            else:
                cleaned.append(s if s in self.axes else None)
        return Placement(cleaned)

    def sharding(self, *spec) -> Placement:
        """The placement of a tensor split per `spec` (≙ NamedSharding)."""
        return self.pspec(*spec)

    def replicated(self) -> Placement:
        return Placement(())

    def batch_sharding(self, ndim: int = None) -> Placement:
        """Dim 0 split over the data axis (≙ SplitLoDTensor)."""
        if ndim is None:
            return self.sharding(DATA_AXIS)
        return self.sharding(DATA_AXIS, *([None] * (ndim - 1)))

    def local_slice(self, value, placement: Sequence):
        """This rank's block of the global tensor `value` under
        `placement`: each split dim cut into equal blocks by the
        coordinate(s) of its axis name(s), the first name major."""
        coords = self.coords()
        for d, s in enumerate(placement):
            if s is None:
                continue
            names = s if isinstance(s, (tuple, list)) else (s,)
            parts, idx = 1, 0
            for a in names:
                idx = idx * self.axes.get(a, 1) + coords.get(a, 0)
                parts *= self.axes.get(a, 1)
            if parts == 1:
                continue
            n = value.shape[d]
            enforce(n % parts == 0,
                    f"dim {d} of size {n} does not split into {parts} "
                    f"blocks over {names}", exc=InvalidArgumentError)
            c = n // parts
            value = value.narrow(d, idx * c, c)
        return value

    # -- the current mesh -----------------------------------------------------
    def __enter__(self):
        _MESH_STACK.append(self)
        return self

    def __exit__(self, *a):
        _MESH_STACK.pop()
        return False

    def __repr__(self):
        return f"DeviceMesh(axes={self.axes}, ranks={self.ranks})"


_MESH_STACK: List[DeviceMesh] = []


def current_mesh() -> DeviceMesh:
    """The innermost `with mesh:` (ParallelExecutor enters its own for a
    step), else the default mesh: the mesh the collectives of
    `collective.py` run over."""
    return _MESH_STACK[-1] if _MESH_STACK else get_default_mesh()


def make_mesh(axes: Optional[Dict[str, int]] = None,
              ranks=None) -> DeviceMesh:
    return DeviceMesh(ranks=ranks, axes=axes)


_default_mesh: Optional[DeviceMesh] = None


def get_default_mesh() -> DeviceMesh:
    """A dp mesh over the joined world, or a world of one when none was
    joined. Built on first use: every rank must ask for it at the same
    point (it creates process groups)."""
    global _default_mesh
    if _default_mesh is None or (_default_mesh.joined != (_world() is not None)):
        _default_mesh = DeviceMesh()
    return _default_mesh


def set_default_mesh(mesh: Optional[DeviceMesh]):
    global _default_mesh
    _default_mesh = mesh


def shard_map(f, *, mesh: DeviceMesh, in_specs, out_specs, check_vma=True,
              check_rep=None):
    """Run `f` per rank on its blocks (≙ jax.shard_map): each argument is
    the GLOBAL value, cut to this rank's block by its spec (a Placement or
    tuple per dim; a dim split over several axes is cut major-first); each
    output is this rank's block, gathered back to the global value over
    the axes its out spec names. Differentiable as the JAX package's
    replicated in/out values are: an input's gradient is the full one on
    every rank (the cut's backward gathers) and an output's cotangent is
    taken once (the gather's backward cuts). `check_vma` / `check_rep`
    are accepted for the JAX signature and mean nothing here."""
    from .tensor_parallel import gather_once, split_once

    def one_spec(specs, i, n):
        if isinstance(specs, (list, tuple)) and len(specs) == n and all(
                s is None or isinstance(s, (list, tuple)) for s in specs):
            return specs[i]
        return specs

    def names_of(s):
        return s if isinstance(s, (list, tuple)) else (s,)

    @functools.wraps(f)
    def mapped(*args):
        with mesh:
            locs = []
            for i, a in enumerate(args):
                spec = one_spec(in_specs, i, len(args)) or ()
                for d, s in enumerate(spec if a is not None else ()):
                    for ax in (names_of(s) if s is not None else ()):
                        n = mesh.axis_size(ax)
                        if n > 1:
                            a = split_once(a, ax, d, n, mesh.axis_index(ax))
                locs.append(a)
            outs = f(*locs)
            single = not isinstance(outs, tuple)
            outs = (outs,) if single else outs
            res = []
            for i, o in enumerate(outs):
                spec = one_spec(out_specs, i, len(outs)) or ()
                for d, s in enumerate(spec):
                    for ax in reversed(names_of(s) if s is not None
                                       else ()):
                        if mesh.axis_size(ax) > 1:
                            o = gather_once(o, ax, d, mesh.axis_index(ax),
                                            mesh.axis_size(ax))
                res.append(o)
        return res[0] if single else tuple(res)

    return mapped
