"""The port's public signatures against `API.spec`, the JAX package's
frozen surface, and the keywords the port once dropped.

- `print_signatures --check`: every `API.spec` line equals the port's
  line for the same path (paddle_tpu read as paddle_tpu_torch, the TPU
  names as the CUDA ones), or the path is named with a one-line reason in
  `SIGNATURE_DIFFERENCES`, which names nothing that compares equal.
- Each repaired keyword, called the way JAX-package code calls it:
  `register_op`'s `stop_gradient` / `tags` / `infer_spec` (also through
  the `parallel.grad_comm` and `parallel.pipeline` re-exports),
  `fused_decode_attention`'s `backend` in the JAX position,
  `HostTierConfig(pin_index_nodes=)`, `shardings=` of
  `io.load_persistables` / `load_checkpoint` / `trainer.load_checkpoint`,
  and `as_numpy(x=)`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.fusion import decode_attention as jda

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import (AlreadyExistsError,
                                           InvalidArgumentError)
from paddle_tpu_torch.framework import registry
from paddle_tpu_torch.tools import print_signatures as ps

from tests.port_env import port_jax_compile_cache  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


def test_every_spec_line_equals_the_port_or_is_named():
    diffs = ps.differences()
    unnamed = sorted(p for p in diffs if p not in ps.SIGNATURE_DIFFERENCES)
    assert unnamed == [], [diffs[p] for p in unnamed[:5]]
    stale = sorted(p for p in ps.SIGNATURE_DIFFERENCES if p not in diffs)
    assert stale == [], "named differences that compare equal"
    for path, reason in ps.SIGNATURE_DIFFERENCES.items():
        assert reason and "\n" not in reason, path
    # the surface the check reads is the JAX list mapped to the port
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_jax_print_signatures",
        os.path.join(ROOT, "tools", "print_signatures.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    assert [m.replace("paddle_tpu", "paddle_tpu_torch", 1)
            for m in jmod.PUBLIC_MODULES] == ps.PUBLIC_MODULES


def test_check_cli_exits_0_and_never_writes_the_spec(tmp_path):
    before = os.stat(os.path.join(ROOT, "API.spec")).st_mtime_ns
    r = subprocess.run([sys.executable, "-m",
                        "paddle_tpu_torch.tools.print_signatures", "--check"],
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "0 unnamed, 0 stale" in r.stdout
    assert os.stat(os.path.join(ROOT, "API.spec")).st_mtime_ns == before
    with pytest.raises(SystemExit):
        ps.main(["--update"])


def test_an_unnamed_difference_fails_the_check(monkeypatch):
    path = "paddle_tpu.parallel.ParallelExecutor"
    monkeypatch.delitem(ps.SIGNATURE_DIFFERENCES, path)
    assert ps.check() == 1
    monkeypatch.setitem(ps.SIGNATURE_DIFFERENCES, path, "x")
    monkeypatch.setitem(ps.SIGNATURE_DIFFERENCES, "paddle_tpu.Executor",
                        "equal, so stale")
    assert ps.check() == 1


# ---------------------------------------------------------------------------
# the repaired keywords
# ---------------------------------------------------------------------------


@pytest.fixture
def scratch_ops():
    made = []
    yield made
    for name in made:
        registry._OPS.pop(name, None)


def _spec(ctx, shapes, dtypes, attrs):
    return {"Out": [(shapes["X"][0], dtypes["X"][0])]}


@pytest.mark.parametrize("where", ["framework.registry", "parallel.grad_comm",
                                   "parallel.pipeline"])
def test_register_op_takes_the_jax_keywords(where, scratch_ops):
    mod = __import__(f"paddle_tpu_torch.{where}", fromlist=["_"])
    name = f"_sig_test_{where.replace('.', '_')}"
    scratch_ops.append(name)

    @mod.register_op(name, stop_gradient=True, tags=("metric", "host"),
                     infer_spec=_spec)
    def _lower(ctx, ins, attrs):
        return {"Out": [ins["X"][0]]}

    op = registry.lookup_op(name)
    assert op.stop_gradient is True and op.tags == ("metric", "host")
    assert op.infer_spec is _spec and op.lower is _lower
    # infer_spec= is the rule register_infer_spec would attach: a second
    # one is refused the same way
    with pytest.raises(AlreadyExistsError):
        registry.register_infer_spec(name)(_spec)
    plain = name + "_plain"
    scratch_ops.append(plain)
    mod.register_op(plain)(_lower)
    registry.register_infer_spec(plain)(_spec)
    got = registry.lookup_op(plain)
    assert (got.stop_gradient, got.tags, got.infer_spec) == (False, (),
                                                             _spec)


def test_register_op_keywords_match_the_jax_opdef():
    import paddle_tpu.framework.registry as jreg
    for op_type in ("cache_write", "accuracy", "fill_constant", "matmul"):
        j, t = jreg.lookup_op(op_type), registry.lookup_op(op_type)
        assert t.stop_gradient in (False, j.stop_gradient)
    jfields = set(jreg.OpDef.__dataclass_fields__)
    assert jfields == set(registry.OpDef.__dataclass_fields__)


def _decode_inputs():
    rng = np.random.RandomState(3)
    q = rng.randn(2, 4, 1, 16).astype("f4")
    k = rng.randn(2, 4, 12, 16).astype("f4")
    v = rng.randn(2, 4, 12, 16).astype("f4")
    bias = np.where(rng.rand(2, 1, 1, 12) < 0.2, -1e9, 0.0).astype("f4")
    return q, k, v, bias


@pytest.mark.parametrize("backend", [None, "pallas", "xla",
                                     "pallas_interpret"])
def test_decode_attention_backend_in_the_jax_position(backend):
    from paddle_tpu_torch.fusion import fused_decode_attention
    q, k, v, bias = _decode_inputs()
    # the JAX call, positionally: (q, k, v, bias, scale, backend)
    want = jda.fused_decode_attention(*(jnp.asarray(a) for a in
                                        (q, k, v, bias)), 0.25, "xla")
    got = fused_decode_attention(*(torch.from_numpy(a) for a in
                                   (q, k, v, bias)), 0.25, backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_decode_attention_backend_refusals(monkeypatch):
    from paddle_tpu_torch.fusion import fused_decode_attention
    args = [torch.from_numpy(a) for a in _decode_inputs()]
    with pytest.raises(InvalidArgumentError, match="unknown backend"):
        fused_decode_attention(*args, 0.25, "mosaic")
    # a CUDA tensor launches the kernel or raises: the plain-version
    # names are refused on it before anything runs
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    for name in ("xla", "pallas_interpret"):
        with pytest.raises(InvalidArgumentError, match="CUDA tensor"):
            fused_decode_attention(*args, 0.25, name)


def test_host_tier_config_takes_pin_index_nodes():
    jcfg = pt.serving.HostTierConfig(host_blocks=8, pin_index_nodes=True)
    cfg = ptt.serving.HostTierConfig(host_blocks=8, pin_index_nodes=True)
    assert cfg.pin_index_nodes is jcfg.pin_index_nodes is True
    assert ptt.serving.kv_pager.HostTierConfig is ptt.HostTierConfig
    with pytest.raises(InvalidArgumentError, match="pin_index_nodes"):
        ptt.HostTierConfig(pin_index_nodes=False)


def _saved_sharded(tmp_path):
    prog, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(prog, startup):
        w = prog.global_block().create_var(name="w", shape=[4, 3],
                                           dtype="float32", persistable=True)
    want = np.arange(12, dtype="f4").reshape(4, 3)
    scope = ptt.Scope()
    scope.set_var("w", torch.from_numpy(want.copy()))
    d = str(tmp_path / "ckpt")
    ptt.io.save_persistables(None, d, main_program=prog, scope=scope,
                             sharded=True)
    assert w.name == "w"
    return d, prog, want


def test_load_persistables_takes_shardings(tmp_path):
    from paddle_tpu_torch.parallel import DeviceMesh
    d, prog, want = _saved_sharded(tmp_path)
    exe = ptt.Executor(ptt.CPUPlace())
    for shardings in (None, {"w": (DeviceMesh(ranks=[0], axes={"dp": 1}),
                                   ("dp", None))}):
        scope = ptt.Scope()
        # the JAX package's call, keywords and all
        got = ptt.io.load_persistables(exe, d, main_program=prog,
                                       scope=scope, sharded=True,
                                       shardings=shardings)
        assert got == ["w"]
        np.testing.assert_array_equal(scope.get("w").numpy(), want)
    with pytest.raises(InvalidArgumentError, match="place="):
        ptt.io.load_persistables(exe, d, main_program=prog,
                                 scope=ptt.Scope(), sharded=True,
                                 shardings={"w": "NamedSharding"})


def test_load_checkpoint_takes_shardings(tmp_path):
    L = ptt.layers
    x = L.data("x", shape=[3])
    loss = L.mean(L.fc(x, size=2))
    ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(ptt.default_startup_program())
    main = ptt.default_main_program()
    d = str(tmp_path / "ck")
    ptt.trainer.save_checkpoint(exe, d, main, trainer_args={"step": 3})
    for fn in (ptt.load_checkpoint, ptt.trainer.load_checkpoint):
        args = fn(exe, d, main, sharded=False, shardings=None)
        assert args == {"step": 3}


def test_as_numpy_names_its_parameter_x():
    from paddle_tpu_torch.io import as_numpy
    t = torch.arange(4, dtype=torch.bfloat16)
    out = as_numpy(x=t)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, np.asarray(pt.io.as_numpy(
        x=jnp.arange(4, dtype=jnp.bfloat16)), dtype="f4"))
