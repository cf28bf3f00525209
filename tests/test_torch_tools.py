"""The port's command-line tools against the JAX package's (`tools/`).

- `lint_program`: `lint_one` over the 23 builders gives the JAX tool's
  JSON rows (timing fields dropped) plain, at --dp 2, --tp 2,
  --pipeline_stages 2, --offload and --serving, and under --memory_plan
  with the JAX package's cost constants; the builder names are the JAX
  tool's; the exit contract (0 clean / 2 gate-rejected / 0 with
  --allow_gate_rejects) holds through a subprocess, which raises without
  a card unless given --place cpu.
- `trace_merge`: the same document as the JAX tool's for the same rank-
  tagged trace (the port's tracing exports it), rank and memory lanes.
- `demo_trainer`: `synth_feed` draws the JAX tool's arrays, and a saved
  LM trained through the tool (sequence lengths 0 and 1) gives the JAX
  tool's losses from the same weights (float32 matmuls in both).
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as pt

import paddle_tpu_torch as ptt
from paddle_tpu_torch.tools import demo_trainer as tdemo
from paddle_tpu_torch.tools import lint_program as tlint
from paddle_tpu_torch.tools import trace_merge as tmerge

from test_torch_memory_plan import jax_constants  # noqa: F401

from tests.port_env import port_jax_compile_cache  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jlint():
    return _load_jax_tool("lint_program")


@pytest.fixture(autouse=True)
def _fresh_port():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


def _args(**kw):
    d = dict(tp=0, dp=0, pipeline_stages=0, num_microbatches=4,
             memory_plan=False, offload=False, serving=False, strategy="",
             restore_dir="", batch_size=8, optimizer="sgd",
             comm_bucket_bytes=1 << 20, json=True, max_shard_rows=24,
             max_diags=40, allow_gate_rejects=True)
    d.update(kw)
    return argparse.Namespace(**d)


def _rows(mod, builders, args):
    out = []
    for name in sorted(builders):
        row = mod.lint_one(name, builders[name], args)
        row.pop("build_s", None)
        row.pop("analyze_s", None)
        out.append(row)
    return out


def _assert_rows_equal(jrows, trows):
    assert [r["model"] for r in trows] == [r["model"] for r in jrows]
    for j, t in zip(jrows, trows):
        assert t == j, t["model"]
    assert sum(r["errors"] for r in trows) == 0


def test_builder_names_are_the_jax_tools(jlint):
    assert sorted(tlint._builders()) == sorted(jlint._builders())
    assert len(tlint._builders()) == 23


@pytest.mark.parametrize("flags", [
    {}, {"dp": 2}, {"tp": 2}, {"pipeline_stages": 2}, {"offload": True},
    {"serving": True}], ids=lambda f: ",".join(f) or "plain")
def test_lint_rows_equal_the_jax_tools(jlint, flags):
    args = _args(**flags)
    jrows = _rows(jlint, jlint._builders(), args)
    trows = _rows(tlint, tlint._builders(ptt.CPUPlace()), args)
    _assert_rows_equal(jrows, trows)
    if flags:
        assert any(r["gate_rejected"] is None for r in trows)


def test_lint_memory_plan_rows_equal_under_jax_constants(jlint,
                                                         jax_constants):
    args = _args(memory_plan=True)
    jrows = _rows(jlint, jlint._builders(), args)
    trows = _rows(tlint, tlint._builders(ptt.CPUPlace()), args)
    _assert_rows_equal(jrows, trows)
    assert sum("memory_plan" in r for r in trows) >= 10


def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.lint_program",
         *argv], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
             "OMP_NUM_THREADS": "1"})


def test_lint_cli_exit_contract():
    r = _cli("--model", "mnist", "--json", "--place", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    rows = json.loads(r.stdout)
    assert len(rows) == 1 and rows[0]["model"] == "mnist"
    for key in ("config", "gate_rejected", "errors", "warnings",
                "diagnostics", "ops", "memory", "peak_at"):
        assert key in rows[0], key
    r = _cli("--model", "mnist", "--tp", "2", "--json", "--place", "cpu")
    assert r.returncode == 2 and json.loads(r.stdout)[0]["gate_rejected"]
    assert tlint.main(["--model", "mnist", "--tp", "2", "--json",
                       "--allow_gate_rejects", "--place", "cpu"]) == 0
    # the card by default: without one it raises, as the Executor does
    r = _cli("--model", "mnist", "--json")
    assert r.returncode not in (0, 2) and "no CUDA device" in r.stderr


def test_lint_strategy_rejects_unknown_keys():
    with pytest.raises(SystemExit, match="unknown key"):
        tlint._parse_strategy('{"dp": 2, "bogus": 1}')


# ---------------------------------------------------------------------------
# trace_merge
# ---------------------------------------------------------------------------


def test_trace_merge_equals_the_jax_tool(tmp_path, capsys):
    from paddle_tpu_torch.observability import memory as obs_memory
    from paddle_tpu_torch.observability import tracing
    jmerge = _load_jax_tool("trace_merge")
    tracing.clear()
    try:
        for r in (0, 1):
            with tracing.rank_scope("wm", r, 2):
                tracing.record_span("checkpoint", "barrier/stage",
                                    1.0 + r, 1.2 + r, serial=5)
                tracing.record_span("checkpoint", "barrier/ack",
                                    1.2 + r, 1.3 + r, serial=5)
                obs_memory.update_watermark("kv_cache_bytes", 5 + r)
        with tracing.span("user", "host_side"):
            pass
        path = str(tmp_path / "t.json")
        tracing.export_chrome_trace(path)
    finally:
        tracing.clear()
    for align in ("barrier/stage", ""):
        doc = tmerge.merge([path, path], align_span=align)
        assert doc == jmerge.merge([path, path], align_span=align)
    doc = tmerge.merge([path])
    evs = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    meta = [e for e in doc["traceEvents"] if e.get("ph") == "M"]
    assert {e["pid"] for e in evs
            if str(e["name"]).startswith("barrier/")} == {0, 1}
    pnames = {e["pid"]: e["args"]["name"] for e in meta
              if e["name"] == "process_name"}
    assert pnames[0].startswith("rank 0") and 999 in pnames
    lanes = {(e["pid"], e["tid"]): e["args"]["name"] for e in meta
             if e["name"] == "thread_name"}
    counters = [e for e in evs if e.get("ph") == "C"]
    assert {c["pid"] for c in counters} == {0, 1}
    assert {lanes[(c["pid"], c["tid"])] for c in counters} == {"memory"}
    assert min(e["ts"] for e in evs if e["name"] == "barrier/stage") == \
        pytest.approx(0.0)
    out = str(tmp_path / "m" / "merged.json")
    assert tmerge.main([path, "-o", out]) == 0
    assert json.load(open(out)) == doc
    assert "3 process lane(s)" in capsys.readouterr().out
    assert tmerge.main([str(tmp_path / "missing.json"), "-o", out]) == 2


# ---------------------------------------------------------------------------
# demo_trainer
# ---------------------------------------------------------------------------


@pytest.fixture
def f32_matmuls():
    olds = [f.get_flag("use_bf16_matmul") for f in (pt.core.flags,
                                                     ptt.flags)]
    pt.core.flags.set_flag("use_bf16_matmul", False)
    ptt.flags.set_flag("use_bf16_matmul", False)
    yield
    pt.core.flags.set_flag("use_bf16_matmul", olds[0])
    ptt.flags.set_flag("use_bf16_matmul", olds[1])


def test_demo_trainer_gives_the_jax_tools_losses(tmp_path, f32_matmuls,
                                                 capsys):
    jdemo = _load_jax_tool("demo_trainer")
    pt.reset_default_programs()
    pt.reset_global_scope()
    with pt.core.unique_name.guard():
        loss, _ = pt.models.transformer.transformer_lm(
            vocab=50, max_len=8, d_model=16, d_inner=32, num_heads=2,
            num_layers=1)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    d = str(tmp_path / "lm")
    pt.io.save_program(d, feed_names=["tokens", "tokens@SEQLEN", "targets"],
                       fetch_names=[loss])
    # the JAX tool's loop, in-process
    pt.reset_global_scope()
    jmain, jstart, feeds, fetches = pt.io.load_program(d)
    jexe = pt.Executor()
    jexe.run(jstart)
    init = {n: np.asarray(pt.global_scope().get(n))
            for n in pt.global_scope().local_var_names()}
    jfeed = jdemo.synth_feed(jmain, feeds, 8)
    want = [float(np.asarray(jexe.run(jmain, feed=jfeed,
                                      fetch_list=fetches)[0]).ravel()[0])
            for _ in range(3)]
    # the port's tool on the same directory, from the same weights
    tmain, tstart, tfeeds, tfetches = ptt.io.load_program(d)
    assert (tfeeds, tfetches) == (feeds, fetches)
    texe = ptt.Executor(ptt.CPUPlace())
    texe.run(tstart)
    ptt.io.load_numpy_params(init, place=ptt.CPUPlace())
    tfeed = tdemo.synth_feed(tmain, tfeeds, 8)
    assert sorted(tfeed) == sorted(jfeed)
    for n in jfeed:
        np.testing.assert_array_equal(tfeed[n], jfeed[n])
    assert set(np.unique(tfeed["tokens@SEQLEN"])) <= {0, 1}
    got = [float(v[0].reshape(-1)[0]) for v in
           tdemo.train(texe, tmain, tfeed, tfetches, 3)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(np.isfinite(got))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("iter 0: ") and fetches[0] in lines[0]
    # the CLI: one line an iteration, then the JAX tool's status line
    hist = tdemo.main(["--model_dir", d, "--iters", "2", "--place", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(hist) == 2 and out[:2][1].startswith("iter 1: ")
    assert json.loads(out[-1]) == {"status": "ok", "iters": 2,
                                   "fetches": fetches}
