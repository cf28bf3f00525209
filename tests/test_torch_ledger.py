"""The cost ledger (`observability/ledger.py`) and the flight recorder
(`observability/flight_recorder.py`) against the JAX package.

- `LedgerRow` / `CostLedger`: the same prediction, census and checks (wire
  bytes exact, pipeline boundary, bubble band, the memory identity, the
  plan reduction, a relative check) give equal `to_dict`s, and the same
  artifact file.
- The flight recorder: the same sequence of phases, states and dossiers
  gives the JAX package's beacons, dossier fields, state board, analysis
  verdict and post-mortem (timestamps and process fields aside); the
  excepthook `install` arms writes a dossier holding the last spans, for
  a `Trainer` stopped by an EnforceError.
"""

import json
import os
import sys

import numpy as np
import pytest

from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import ledger as jled
from paddle_tpu.observability import tracing as jtracing

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import ledger as tled
from paddle_tpu_torch.observability import tracing as ttracing

from test_torch_analysis import fresh_port_state  # noqa: F401

from tests.port_env import port_jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True)
def jax_recorder_reset():
    jfr.reset()
    yield
    jfr.reset()


def _report():
    per_device = {"params": 1000, "params_quantized": 0, "params_draft": 0,
                  "optimizer_state": 2000, "ef_residual": 0,
                  "other_state": 4, "feeds": 64, "seed": 4,
                  "transient_peak": 5000}
    return {"dp_comm": {"wire_bytes": 3000}, "tp_comm": None,
            "pipeline": {"bubble_fraction": 0.2,
                         "boundary": {"buffer_numel": 16},
                         "grad_psum_wire_bytes": 0},
            "memory": {"per_device": per_device}}


def _census(temp):
    cats = {"params": 1000.0, "params_quantized": 0.0, "params_draft": 0.0,
            "optimizer_state": 2000.0, "ef_residual": 0.0, "kv_cache": 0.0,
            "other_state": 4.0}
    cats["state_total"] = sum(cats.values())
    return {"state": {"categories": cats, "per_var": {}},
            "feeds": {"per_device_bytes": 64.0, "per_feed": {}, "dp": 1},
            "seed_bytes": 4,
            "xla": {"argument_bytes": 3072, "output_bytes": 3004,
                    "temp_bytes": temp, "alias_bytes": 3004,
                    "generated_code_bytes": 0, "temp_source": "xla"},
            "peak_bytes": 3072 + temp}


def _fill(mod, ledger):
    row = ledger.row("cell", dp=2, batch=8)
    row.set_prediction(_report())
    row.set_census({"all-reduce": [(1000, "g"), (4, "loss")],
                    "collective-permute": [(64, "a"), (64, "b")]}, 2)
    row.set_spans({"executor/run": {"calls": 3, "total_ms": 1.23456}})
    row.set_measured(step_ms=10.0)
    row.check_wire_bytes_exact()
    row.check_pp_boundary()
    row.check_bubble_fraction(0.21)
    row.set_memory_census(_census(5200))
    row.check_memory_identity(0.1)
    row.check_plan_reduction({"memory": _census(6000), "step_ms": 10.1})
    row.check("step_ms", 9.0, 10.0, 0.2)
    return row


def test_ledger_rows_equal_jax(tmp_path):
    jl, tl = jled.CostLedger("r", {"card": "x"}), \
        tled.CostLedger("r", {"card": "x"})
    jr, tr = _fill(jled, jl), _fill(tled, tl)
    assert tr.to_dict() == jr.to_dict()
    assert tl.to_dict() == jl.to_dict()
    assert tr.ok == jr.ok
    jp = jl.write(str(tmp_path / "j" / "l.json"))
    tp = tl.write(str(tmp_path / "t" / "l.json"))
    assert open(tp).read() == open(jp).read()
    assert tled.LedgerRow.MEMORY_EXACT_CATEGORIES == \
        jled.LedgerRow.MEMORY_EXACT_CATEGORIES
    assert ptt.observability.CostLedger is tled.CostLedger
    assert ptt.observability.LedgerRow is tled.LedgerRow
    with pytest.raises(Exception, match="need both"):
        tled.LedgerRow("x").check_wire_bytes_exact()


_VOLATILE = {"ts", "pid", "host", "written_ts", "time", "wall"}


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _drive(fr, tracing, d):
    """A fixed sequence: phases on two ranks, a state board, a dossier."""
    fr.configure(d, world_id="w0")
    fr.note_phase("barrier", "enter", rank=0, serial=1)
    fr.note_phase("barrier", "enter", rank=1, serial=1)
    fr.note_phase("barrier", "exit", rank=0, serial=1, crashing=True)
    fr.set_state("trainer", step=3, epoch=0)
    fr.set_state("engine", ticks=7)
    fr.clear_state("engine")
    with tracing.span("user", "work"):
        pass
    path = fr.dump_dossier("test death", rank=0,
                           exc=ValueError("boom"), extra={"k": 1})
    with open(path) as f:
        dossier = json.load(f)
    return dossier


def _dossier_view(dossier):
    out = _strip(dossier)
    out.pop("spans", None)
    out.pop("metrics", None)
    out.pop("memory", None)
    return out


def test_flight_recorder_equals_jax(tmp_path):
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jdoc = _drive(jfr, jtracing, jd)
    tdoc = _drive(tfr, ttracing, td)
    assert set(tdoc) == set(jdoc)
    assert _dossier_view(tdoc) == _dossier_view(jdoc)
    assert [s["name"] for s in tdoc["spans"]][-1:] == ["work"]
    assert _strip(tfr.state_board()) == _strip(jfr.state_board())
    assert _strip(tfr.read_beacons(td)) == _strip(jfr.read_beacons(jd))
    assert _strip(tfr.analyze(td)) == _strip(jfr.analyze(jd))
    jp = jfr.write_post_mortem(jd, incarnation=2, extra={"x": 1})
    tp = tfr.write_post_mortem(td, incarnation=2, extra={"x": 1})
    assert os.path.basename(tp) == os.path.basename(jp)
    assert _strip(json.load(open(tp))) == _strip(json.load(open(jp)))
    assert len(tfr.collect_dossiers(td)) == len(jfr.collect_dossiers(jd))
    assert tfr.dossier_dir() == td and tfr.enabled()
    tfr.reset()
    assert not tfr.enabled() and tfr.state_board() == {}


def _tiny_trainer(ptt_):
    def train_func():
        x = ptt_.layers.data("x", [4])
        y = ptt_.layers.data("y", [1])
        pred = ptt_.layers.fc(x, 1)
        return [ptt_.layers.mean(ptt_.layers.square_error_cost(pred, y))]

    def opt_func():
        return ptt_.optimizer.SGD(learning_rate=0.01)

    with ptt_.unique_name.guard():
        return ptt_.Trainer(train_func, opt_func, place=ptt_.CPUPlace())


def test_installed_recorder_writes_a_dossier_for_a_stopped_trainer(
        tmp_path):
    d = str(tmp_path / "dossiers")
    prev = sys.excepthook
    tfr.install(d, excepthook=True, sigterm=False)
    assert sys.excepthook is not prev
    trainer = _tiny_trainer(ptt)
    rng = np.random.RandomState(0)

    def reader():
        for _ in range(8):
            yield [(rng.randn(4).astype("float32"),
                    rng.randn(1).astype("float32")) for _ in range(2)]

    def handler(event):
        if isinstance(event, ptt.EndStepEvent) and event.step == 2:
            raise EnforceError("injected stop at step 2")

    with pytest.raises(EnforceError) as e:
        trainer.train(num_epochs=1, event_handler=handler, reader=reader,
                      feed_order=["x", "y"])
    sys.excepthook(type(e.value), e.value, e.value.__traceback__)
    dossiers = tfr.collect_dossiers(d)
    assert len(dossiers) == 1
    assert dossiers[0]["reason"] == "uncaught exception"
    assert "injected stop" in json.dumps(dossiers[0])
    assert any(s["name"] == "executor/run" for s in dossiers[0]["spans"])
    assert tfr.analyze(d)["n_dossiers"] == 1
    tfr.reset()
    assert sys.excepthook is prev
