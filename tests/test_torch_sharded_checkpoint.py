"""The port's native tensor container and sharded checkpoints against the
JAX package's.

- The container (`data/tensor_store.py` over `csrc/tensor_store.cc`, a
  table CRC-32 in place of zlib): for every dtype code, bfloat16
  included, the port writes the same bytes as the JAX package for the
  same tensors in the same order; each package reads the other's files,
  and each rejects a flipped bit and a truncation.
- The `.pts` route of `io.save_vars` / `load_vars`, both ways.
- A JAX `save_sharded` over a dp2 x tp2 layout on 4 virtual devices, read
  by the port: `read_slice` and `restore_array` of each of the 4 ranks'
  blocks equal the global array's blocks, reading only the chunks each
  block intersects.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import sharded_checkpoint as tsc
from paddle_tpu_torch.data import tensor_store as tts

from tests.port_env import port_jax_compile_cache  # noqa: F401

DTYPES = ("float32", "float64", "int32", "int64", "uint8", "bool",
          "bfloat16", "float16", "int16", "uint32", "uint64")


def _arrays():
    """name -> numpy array (JAX's side: ml_dtypes bfloat16) per code,
    plus a scalar and an empty tensor."""
    import ml_dtypes
    rng = np.random.RandomState(0)
    out = {}
    for name in DTYPES:
        if name == "bool":
            a = rng.rand(3, 4) > 0.5
        elif name == "bfloat16":
            a = rng.randn(3, 5).astype(ml_dtypes.bfloat16)
        elif name.startswith("float"):
            a = rng.randn(2, 3, 4).astype(name)
        else:
            a = rng.randint(0, 100, (5,)).astype(name)
        out["v_" + name] = a
    out["scalar"] = np.array(3.5, np.float32)
    out["empty"] = np.zeros((0, 3), np.float32)
    return out


def _to_torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    """Raw bytes of a torch tensor or a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy().tobytes() \
            if t.dim() else t.reshape(1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


def test_container_files_are_byte_equal_and_cross_read(tmp_path):
    from paddle_tpu.data import tensor_store as jts
    arrays = _arrays()
    jpath, tpath = str(tmp_path / "j.pts"), str(tmp_path / "t.pts")
    jts.save_tensors(jpath, arrays)
    tts.save_tensors(tpath, {k: _to_torch(v) for k, v in arrays.items()})
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    # a CUDA-less host: the port's library was built with g++ into the
    # build dir, no zlib
    assert os.path.exists(tts._lib_path())
    # the port reads the JAX file; JAX reads the port's
    got = tts.load_tensors(jpath)
    back = jts.load_tensors(tpath)
    assert sorted(got) == sorted(back) == sorted(arrays)
    for k, a in arrays.items():
        # both store a scalar as shape (1,)
        assert tuple(got[k].shape) == (a.shape or (1,)), k
        assert str(got[k].dtype) == f"torch.{a.dtype.name}", k
        assert _bits(got[k]) == _bits(a), k
        assert back[k].dtype == a.dtype and _bits(back[k]) == _bits(a), k
    assert tts.list_tensors(jpath) == jts.list_tensors(jpath)
    # only the named entries are read
    assert sorted(tts.load_tensors(jpath, ["v_int64"])) == ["v_int64"]


@pytest.mark.parametrize("damage", ["bitflip", "truncate"])
def test_both_packages_reject_a_damaged_file(tmp_path, damage):
    from paddle_tpu.data import tensor_store as jts
    path = str(tmp_path / "x.pts")
    tts.save_tensors(path, {"a": torch.arange(4096, dtype=torch.float32),
                            "b": torch.ones(7, dtype=torch.int64)})
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if damage == "bitflip":
            f.seek(100)               # inside tensor a's payload
            byte = f.read(1)
            f.seek(100)
            f.write(bytes([byte[0] ^ 0x01]))
        else:
            f.truncate(size // 2)
    for load in (tts.load_tensors, jts.load_tensors):
        with pytest.raises((IOError, OSError)):
            load(path)


def _tiny(pkg):
    pkg.reset_default_programs()
    pkg.reset_global_scope()
    guard = (pkg.unique_name.guard() if pkg is ptt
             else pkg.core.unique_name.guard())
    with guard:
        x = pkg.layers.data("x", shape=[6])
        pkg.layers.fc(x, size=3)
    return pkg.default_main_program()


def test_pts_route_of_save_and_load_vars(tmp_path):
    """`.pts` through io.save_vars / load_vars: the port's container loads
    in the JAX package and the JAX package's in the port, values equal;
    save_as_bf16 stores float32 parameters as bfloat16 (code 6)."""
    import paddle_tpu as pt
    jmain = _tiny(pt)
    pt.Executor().run(pt.default_startup_program())
    jvals = {n: np.asarray(pt.global_scope().get(n))
             for n in ("fc_0.w_0", "fc_0.w_1")}
    pt.io.save_params(pt.Executor(), str(tmp_path / "j"),
                      main_program=jmain, filename="params.pts")
    main = _tiny(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(ptt.default_startup_program())
    ptt.io.load_params(exe, str(tmp_path / "j"), main_program=main,
                       filename="params.pts")
    for n, v in jvals.items():
        np.testing.assert_array_equal(ptt.global_scope().get(n).numpy(), v)
    ptt.global_scope().set_var("fc_0.w_1", torch.tensor([1., 2., 3.]))
    ptt.io.save_params(exe, str(tmp_path / "t"), main_program=main,
                       filename="params.pts")
    ptt.io.save_params(exe, str(tmp_path / "t16"), main_program=main,
                       filename="params.pts", save_as_bf16=True)
    jmain = _tiny(pt)
    pt.io.load_params(pt.Executor(), str(tmp_path / "t"),
                      main_program=jmain, filename="params.pts")
    np.testing.assert_array_equal(
        np.asarray(pt.global_scope().get("fc_0.w_1")), [1., 2., 3.])
    np.testing.assert_array_equal(
        np.asarray(pt.global_scope().get("fc_0.w_0")), jvals["fc_0.w_0"])
    stored = tts.load_tensors(str(tmp_path / "t16" / "params.pts"))
    assert stored["fc_0.w_0"].dtype == torch.bfloat16
    # loading converts to the declared dtype
    ptt.io.load_params(exe, str(tmp_path / "t16"), main_program=main,
                       filename="params.pts")
    w = ptt.global_scope().get("fc_0.w_0")
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(
        w.numpy(), torch.from_numpy(np.array(jvals["fc_0.w_0"])).to(
            torch.bfloat16).float().numpy())


# the port's placements of the JAX PartitionSpecs below, over dp2 x tp2
PLACEMENTS = {"both": ("dp", "tp"), "rows": ("dp", None),
              "cols": (None, "tp"), "joint": (("tp", "dp"), None),
              "repl": (), "bf16": ("tp", None)}


def _jax_saved(tmp_path):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import ml_dtypes

    from paddle_tpu.sharded_checkpoint import save_sharded
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("dp", "tp"))
    rng = np.random.RandomState(1)
    specs = {"both": P("dp", "tp"), "rows": P("dp", None),
             "cols": P(None, "tp"), "joint": P(("tp", "dp"), None),
             "repl": P(), "bf16": P("tp", None)}
    arrays, placed = {}, {}
    for name, spec in specs.items():
        a = rng.randn(8, 6).astype(np.float32)
        if name == "bf16":
            a = a.astype(ml_dtypes.bfloat16)
        arrays[name] = a
        placed[name] = jax.device_put(a, NamedSharding(mesh, spec))
    save_sharded(str(tmp_path), placed)
    return arrays


def _placement(name):
    from paddle_tpu_torch.parallel.mesh import Placement
    return Placement(PLACEMENTS[name])


def test_port_reads_a_jax_sharded_checkpoint_block_by_block(tmp_path):
    """Each rank of a dp2 x tp2 mesh restores exactly its block of every
    array, reading only the chunks the block intersects."""
    from paddle_tpu_torch.parallel import DeviceMesh
    arrays = _jax_saved(tmp_path)
    mesh = DeviceMesh(ranks=range(4), axes={"dp": 2, "tp": 2})
    full = tsc.ShardedCheckpoint(str(tmp_path))
    assert full.names() == sorted(arrays)
    for name, a in arrays.items():
        want_all = _to_torch(a)
        assert _bits(full.read(name)) == _bits(want_all)
        for rank in range(4):
            placement = _placement(name)
            ckpt = tsc.ShardedCheckpoint(str(tmp_path))
            got = tsc.restore_array(ckpt, name, placement, mesh,
                                    rank=rank)
            start, block, _ = tsc.block_of(mesh, placement, rank, a.shape)
            want = want_all[start[0]:start[0] + block[0],
                            start[1]:start[1] + block[1]]
            assert got.dtype == want.dtype and _bits(got) == _bits(want), \
                (name, rank)
            if name != "bf16":
                # the block DeviceMesh.local_slice cuts for this rank
                mesh.rank = rank
                assert torch.equal(mesh.local_slice(want_all, placement),
                                   got)
            # the chunks read are exactly those the block intersects
            hit = {c["key"] for c in ckpt.vars[name]["chunks"]
                   if all(cs < s + b and s < cs + cb for cs, cb, s, b in
                          zip(c["start"], c["shape"], start, block))}
            assert {k for _, k in ckpt.loaded} == hit, (name, rank)
            assert ckpt.read_bytes == got.numel() * got.element_size()
            # read_slice of any window assembles across chunks
            win = ckpt.read_slice(name, (slice(1, 7), slice(2, 5)))
            assert _bits(win) == _bits(want_all[1:7, 2:5])
    # rank 3 of the dp-split rows reads one chunk of two
    ckpt = tsc.ShardedCheckpoint(str(tmp_path))
    tsc.restore_array(ckpt, "rows", _placement("rows"), mesh, rank=3)
    assert len(ckpt.loaded) == 1 and len(ckpt.vars["rows"]["chunks"]) == 2


def test_sharded_persistables_round_trip_through_the_jax_package(tmp_path):
    """save_persistables(sharded=True) in the port loads in the JAX
    package, and the JAX package's loads in the port."""
    import paddle_tpu as pt
    main = _tiny(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(ptt.default_startup_program())
    want = {n: ptt.global_scope().get(n).numpy().copy()
            for n in ("fc_0.w_0", "fc_0.w_1")}
    ptt.io.save_persistables(exe, str(tmp_path / "t"), main_program=main,
                             sharded=True)
    assert sorted(os.listdir(tmp_path / "t")) == ["manifest-0.json",
                                                  "shard-0.pts"]
    jmain = _tiny(pt)
    pt.io.load_persistables(pt.Executor(), str(tmp_path / "t"),
                            main_program=jmain, sharded=True)
    for n, v in want.items():
        np.testing.assert_array_equal(np.asarray(pt.global_scope().get(n)),
                                      v)
    pt.io.save_persistables(pt.Executor(), str(tmp_path / "j"),
                            main_program=jmain, sharded=True)
    main = _tiny(ptt)
    ptt.io.load_persistables(exe, str(tmp_path / "j"), main_program=main,
                             sharded=True)
    for n, v in want.items():
        np.testing.assert_array_equal(ptt.global_scope().get(n).numpy(), v)
