"""The port's examples (`paddle_tpu_torch.examples`) on the CPU, with
their step counts lowered through their module constants.

- `train_mnist` and `generate_text` print the JAX examples' lines and
  train to the JAX examples' losses (float32 tolerance) from the same
  starting weights: the JAX example's source runs with the same lowered
  counts, its startup weights are carried into the port's scope, and
  both record every training fetch. `use_bf16_matmul` is off in both.
- `serve_model`: the in-process, TCP and C++ legs print the same first
  three outputs (the C++ server from the port's native CPU build).
"""

import os
import re

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.framework.executor import Executor as JExecutor

import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework.executor import Executor as TExecutor

from tests.port_env import port_jax_compile_cache  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_both():
    olds = [f.get_flag("use_bf16_matmul") for f in (pt.core.flags,
                                                     ptt.flags)]
    pt.core.flags.set_flag("use_bf16_matmul", False)
    ptt.flags.set_flag("use_bf16_matmul", False)
    for pkg in (pt, ptt):
        pkg.reset_default_programs()
        pkg.reset_global_scope()
    yield
    pt.core.flags.set_flag("use_bf16_matmul", olds[0])
    ptt.flags.set_flag("use_bf16_matmul", olds[1])


def _recording(monkeypatch, cls, pkg, init=None):
    """Wrap `cls.run`: keep every fetch of a training run (a feed with a
    label or targets) and, after the startup program, either keep the
    scope's values (init is None) or load `init` over them."""
    rec = {"losses": [], "init": None}
    orig = cls.run

    def run(self, program=None, *a, **kw):
        out = orig(self, program, *a, **kw)
        if program is pkg.default_startup_program():
            scope = pkg.global_scope()
            if init is None:
                rec["init"] = {n: np.asarray(scope.get(n))
                               for n in scope.local_var_names()}
            else:
                ptt.io.load_numpy_params(init, place=ptt.CPUPlace())
        feed = kw.get("feed") or {}
        if "label" in feed or "targets" in feed:
            rec["losses"].append(float(np.asarray(out[0]).ravel()[0]))
        return out

    monkeypatch.setattr(cls, "run", run)
    return rec


def _jax_example(name, subs):
    """Run examples/<name>.py's main() with its counts replaced."""
    src = open(os.path.join(ROOT, "examples", f"{name}.py")).read()
    for old, new in subs.items():
        assert old in src, old
        src = src.replace(old, new)
    ns = {"__name__": f"_jax_example_{name}",
          "__file__": os.path.join(ROOT, "examples", f"{name}.py")}
    exec(compile(src, ns["__file__"], "exec"), ns)
    with pt.core.unique_name.guard():
        ns["main"]()


def _pair(monkeypatch, capsys, name, subs, constants):
    jrec = _recording(monkeypatch, JExecutor, pt)
    _jax_example(name, subs)
    jout = capsys.readouterr().out.splitlines()
    import importlib
    mod = importlib.import_module(f"paddle_tpu_torch.examples.{name}")
    for k, v in constants.items():
        monkeypatch.setattr(mod, k, v)
    trec = _recording(monkeypatch, TExecutor, ptt, init=jrec["init"])
    with ptt.unique_name.guard():
        mod.main(["--place", "cpu"])
    tout = capsys.readouterr().out.splitlines()
    assert len(trec["losses"]) == len(jrec["losses"]) > 0
    np.testing.assert_allclose(trec["losses"], jrec["losses"], rtol=1e-4,
                               atol=1e-5)
    return jout, tout


def test_train_mnist_matches_the_jax_example(monkeypatch, capsys):
    jout, tout = _pair(monkeypatch, capsys, "train_mnist",
                       {"if i >= 12800:": "if i >= 320:"}, {"SAMPLES": 320})
    # 6 batches of 64: one progress line, then the reloaded predictor
    assert [ln for ln in tout if ln.startswith("epoch")] == \
        [ln for ln in jout if ln.startswith("epoch")]
    assert len([ln for ln in tout if ln.startswith("epoch")]) == 1
    assert tout[-1] == jout[-1]
    assert re.fullmatch(r"reloaded predictor says: \d", tout[-1])


def test_generate_text_matches_the_jax_example(monkeypatch, capsys):
    jout, tout = _pair(monkeypatch, capsys, "generate_text",
                       {"for step in range(300):": "for step in range(4):"},
                       {"STEPS": 4})
    assert tout[0] == jout[0] and tout[0].startswith("step 0: loss ")
    gen = tout[-1]
    assert gen.startswith("generated: 't") and len(eval(gen[11:])) == 49


def test_serve_model_legs_agree(capsys):
    from paddle_tpu_torch.examples import serve_model
    serve_model.main(["--place", "cpu"])
    out = capsys.readouterr().out.splitlines()
    legs = {}
    for ln in out:
        key, _, vals = ln.partition(":")
        legs[key] = np.array([float(v) for v in
                              vals.strip().strip("[]").split()])
    assert list(legs) == ["in-process", "served (4 pipelined)",
                          "C++ server"]
    for key in legs:
        assert legs[key].shape == (3,)
        np.testing.assert_allclose(legs[key], legs["in-process"],
                                   rtol=1e-5, atol=1e-6)
