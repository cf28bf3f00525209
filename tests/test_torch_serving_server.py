"""The port's server half against the JAX package's: EngineServer /
EngineClient, the PredictorServer transport, /metrics and /healthz, and
the engine's tracing spans.

Small model (vocab 64, d_model 32, d_inner 64, 4 heads, 2 layers, 3
slots of 24 positions) in float32 (use_bf16_matmul off in both
packages), weights from the JAX package's startup program carried over
by `load_numpy_params`: the server's tokens must be the JAX engine's,
token for token. The wire format is shared: a JAX client talks to a port
server and the other way round. Waits use threading.Events, not
sleep-polling, and no assertion depends on the order in which two
frames arrive.
"""

import os
import re
import signal
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.observability.metrics import MultiRegistry, default_registry
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import EngineServer as JServer
from paddle_tpu.serving import HostTierConfig as JTier
from paddle_tpu.serving import PagedKVEngine as JPaged
from paddle_tpu.serving import PredictorClient as JClient
from paddle_tpu.serving import PredictorServer as JPredServer
from paddle_tpu.serving import SpecConfig as JSpec

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.enforce import UnavailableError
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      EngineClient, EngineServer,
                                      HostTierConfig, PagedKVEngine,
                                      PredictorClient, PredictorServer,
                                      SpecConfig, scrape_healthz,
                                      scrape_metrics)
from paddle_tpu_torch.serving.transport import _recv_msg

DIMS = dict(vocab=64, max_len=24, d_model=32, d_inner=64, num_heads=4,
            num_layers=2)
PROMPTS = [[3, 4, 5], [9], [1, 2, 3, 4, 5, 6, 7], [11, 12], [30, 31, 32, 33],
           [7, 7], [2, 60, 5, 8, 13], [40]]
MAX_NEW = [6, 9, 4, 7, 5, 8, 3, 6]
CPU = ptt.CPUPlace()
TIMEOUT = 60


@pytest.fixture(autouse=True)
def fresh_port_state():
    saved = {n: (jflags.get_flag(n), tflags.get_flag(n))
             for n in ("use_bf16_matmul", "trace")}
    for f in (jflags, tflags):
        f.set_flag("use_bf16_matmul", False)
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    tracing.clear()
    with ptt.unique_name.guard():
        yield
    for n, (jv, tv) in saved.items():
        jflags.set_flag(n, jv)
        tflags.set_flag(n, tv)


@pytest.fixture(scope="module")
def params():
    """The JAX package's initial weights for DIMS, as numpy (float32)."""
    saved = jflags.get_flag("use_bf16_matmul")
    jflags.set_flag("use_bf16_matmul", False)
    try:
        jscope = pt.Scope()
        eng = JEngine(n_slots=3, scope=jscope, **DIMS)
        return {p.name: np.asarray(jscope.get(p.name))
                for p in eng._program.all_parameters()}
    finally:
        jflags.set_flag("use_bf16_matmul", saved)


def _jscope(params):
    scope = pt.Scope()
    for n, a in params.items():
        scope.set_var(n, jnp.asarray(a))
    return scope


def _port(params, cls=ContinuousBatchingEngine, **kw):
    return cls(n_slots=3, place=CPU,
               scope=ptt.load_numpy_params(params, ptt.Scope(), CPU),
               **kw, **DIMS)


@pytest.fixture(scope="module")
def want(params):
    """The JAX engine's tokens for PROMPTS (run in-process)."""
    saved = jflags.get_flag("use_bf16_matmul")
    jflags.set_flag("use_bf16_matmul", False)
    try:
        eng = JEngine(n_slots=3, scope=_jscope(params), **DIMS)
        reqs = [eng.submit(p, m) for p, m in zip(PROMPTS, MAX_NEW)]
        eng.run_until_idle()
        return [list(r.tokens) for r in reqs]
    finally:
        jflags.set_flag("use_bf16_matmul", saved)


# -- generation over the wire ----------------------------------------------


def test_server_pipelined_tokens_match_jax(params, want):
    """Two clients pipeline four requests each; completions come back in
    the engine's order, keyed by tag; every token is the JAX engine's."""
    eng = _port(params)
    got = {}
    with EngineServer(eng, metrics_port=None) as srv:
        clients = [EngineClient(*srv.address) for _ in range(2)]
        try:
            sent = {}
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW)):
                c = clients[i % 2]
                sent[c.send_gen(p, m, tag=f"r{i}",
                                request_id=f"id{i}")] = i
            for k, c in enumerate(clients):
                for _ in range(len(PROMPTS) // 2):
                    tag, tokens, latency_ms = c.recv_done()
                    got[sent[tag]] = tokens
                    assert latency_ms >= 0
        finally:
            for c in clients:
                c.close()
    assert [got[i] for i in range(len(PROMPTS))] == want
    # the transport phase closed for every request: phases sum to e2e
    for req in eng.completed_log:
        ph = req.phases()
        assert ph["transport"] >= 0.0
        assert abs(sum(ph.values()) - req.e2e_s()) < 1e-9


def test_oversized_request_answered_with_error_connection_still_served(
        params, want):
    eng = _port(params)
    with EngineServer(eng, metrics_port=None) as srv, \
            EngineClient(*srv.address) as c:
        c.send_gen(list(range(1, 20)), max_new=10)         # 29 > 24
        with pytest.raises(RuntimeError, match="max_len=24"):
            c.recv_done()
        assert c.generate(PROMPTS[0], MAX_NEW[0]) == want[0]


def test_idle_drain_is_immediate(params):
    srv = EngineServer(_port(params)).start()
    assert srv.drain(timeout=10) is True
    assert srv._stop.is_set()


def test_sigterm_finishes_in_flight_and_rejects_new(params, want):
    """SIGTERM: the in-flight request completes in full and its frame is
    flushed; a request sent after the drain began gets an explicit
    draining error; the server shuts down. Both frames are read without
    assuming which arrives first."""
    eng = _port(params)
    submitted = threading.Event()
    real_submit = eng.submit

    def submit(*a, **kw):
        req = real_submit(*a, **kw)
        submitted.set()
        return req

    eng.submit = submit
    srv = EngineServer(eng, metrics_port=None).start()
    srv.install_sigterm_handler(exit_process=False)
    try:
        with EngineClient(*srv.address) as c:
            tag = c.send_gen(PROMPTS[1], max_new=MAX_NEW[1])
            assert submitted.wait(TIMEOUT), "never submitted"
            os.kill(os.getpid(), signal.SIGTERM)
            assert srv._draining.wait(TIMEOUT), "drain never started"
            late = c.send_gen([6], max_new=2)
            frames = [_recv_msg(c._sock)[0] for _ in range(2)]
        errors = [f for f in frames if "error" in f]
        dones = [f["done"] for f in frames if "done" in f]
        assert len(errors) == 1 and "draining" in errors[0]["error"]
        assert errors[0]["tag"] == late
        assert len(dones) == 1 and dones[0]["tag"] == tag
        assert dones[0]["tokens"] == want[1]
        assert srv._stop.wait(TIMEOUT), "drain never shut down"
        assert eng.n_active == 0 and eng.n_pending == 0
    finally:
        if srv._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, srv._prev_sigterm)
        srv.shutdown()


# -- /metrics, /healthz, spans against the JAX engine's ---------------------


def _families(text, keep=None):
    """{family: (type, sorted label keys)} from a Prometheus exposition
    (bucket `le` labels dropped)."""
    types = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    labels = {name: set() for name in types}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([A-Za-z_:][\w:]*)(\{[^}]*\})?", line)
        name = m.group(1)
        fam = next((f for f in (name, re.sub(r"_(bucket|sum|count)$", "",
                                              name)) if f in types), None)
        if fam is None:
            continue
        keys = set(re.findall(r"(\w+)=", m.group(2) or "")) - {"le"}
        labels[fam].add(tuple(sorted(keys)))
    out = {f: (t, sorted(labels[f])) for f, t in types.items()}
    if keep is not None:
        out = {f: v for f, v in out.items() if f.startswith(keep)}
    return out


#: the process-wide families EngineServer registers before its first
#: scrape (the rest of the default registry depends on what else ran in
#: the process)
PROCESS = ("ptpu_memory_", "ptpu_mfu", "ptpu_ckpt_", "ptpu_train_")

CONFIGS = {
    "slot": (JEngine, ContinuousBatchingEngine, {}, {}),
    "paged": (JPaged, PagedKVEngine, dict(block_size=4),
              dict(block_size=4)),
    "paged_host_tier": (
        JPaged, PagedKVEngine,
        dict(block_size=4, n_blocks=9, host_tier=JTier(host_blocks=8)),
        dict(block_size=4, n_blocks=9,
             host_tier=HostTierConfig(host_blocks=8))),
    "speculative": (JEngine, ContinuousBatchingEngine,
                    dict(speculative=JSpec(gamma=2, draft="int8")),
                    dict(speculative=SpecConfig(gamma=2, draft="int8"))),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_metrics_and_healthz_match_jax(params, config):
    """The port engine's /metrics lists the JAX engine's families (names,
    types, label keys) for the same configuration, and /healthz has the
    same keys; the port's engine stats add `kv_cache_bytes`."""
    jcls, tcls, jkw, tkw = CONFIGS[config]
    jeng = jcls(n_slots=3, scope=_jscope(params), **jkw, **DIMS)
    teng = _port(params, tcls, **tkw)
    # the JAX side: what its server's scrape and /healthz serve, read
    # without starting the server (it registers the process-wide
    # families at construction)
    jsrv = JServer(jeng, metrics_port=0)
    try:
        jeng.submit(PROMPTS[0], 3)
        jeng.run_until_idle()
        jtext = MultiRegistry([jeng.metrics_registry,
                               default_registry()]).expose()
        jhealth, jreg = jsrv.health(), jeng.metrics_registry.expose()
    finally:
        jsrv.shutdown()
    with EngineServer(teng, metrics_port=0) as srv:
        teng.submit(PROMPTS[0], 3).wait(TIMEOUT)
        host, port = srv.metrics_address
        ttext = scrape_metrics(host, port)
        thealth = scrape_healthz(host, port)
        treg = teng.metrics_registry.expose()
    assert _families(treg) == _families(jreg)
    assert _families(ttext, PROCESS) == _families(jtext, PROCESS)
    assert set(_families(ttext, "ptpu_engine_")) >= \
        set(_families(jreg, "ptpu_engine_"))
    for fam in ("ptpu_engine_tokens_total", "ptpu_memory_kv_cache_bytes",
                "ptpu_ckpt_pending_async", "ptpu_request_e2e_seconds"):
        assert fam in _families(ttext)
    assert set(thealth) == set(jhealth)
    assert set(thealth["engine"]) - set(jhealth["engine"]) == \
        {"kv_cache_bytes"}
    assert set(jhealth["engine"]) <= set(thealth["engine"])
    assert set(thealth["memory"]) == set(jhealth["memory"])
    assert thealth["status"] == "serving"
    assert thealth["checkpoints"] == {"pending_async": 0}
    assert thealth["engine"]["tokens_out"] == 3


@pytest.mark.parametrize("config", ["slot", "paged"])
def test_one_tick_records_the_jax_span_kinds_and_names(params, config):
    jcls, tcls, jkw, tkw = CONFIGS[config]
    jeng = jcls(n_slots=3, scope=_jscope(params), **jkw, **DIMS)
    teng = _port(params, tcls, **tkw)
    seen = []
    for trc, flg, eng in ((jtracing, jflags, jeng),
                          (tracing, tflags, teng)):
        flg.set_flag("trace", True)
        eng.submit(PROMPTS[2], 2)
        eng.step()                                  # warm
        mark = trc.mark()
        eng.step()
        seen.append({(s.kind, s.name) for s in trc.spans_since(mark)})
    assert seen[1] == seen[0]
    assert ("tick", "engine/tick") in seen[1]
    assert ("dispatch", "engine/dispatch") in seen[1]
    assert ("admission", "engine/admit") in seen[1]


def test_trace_off_records_nothing_and_spans_aggregate(params):
    eng = _port(params)
    tflags.set_flag("trace", False)
    mark = tracing.mark()
    eng.submit(PROMPTS[0], 3)
    eng.run_until_idle()
    assert tracing.spans_since(mark) == []
    tflags.set_flag("trace", True)
    eng.submit(PROMPTS[0], 3)
    eng.run_until_idle()
    agg = tracing.aggregate(tracing.spans_since(mark))
    assert agg["engine/tick"]["calls"] == 5      # 2 prompt + 3 new
    assert agg["request/decode"]["calls"] == 1


# -- the transport, across packages ----------------------------------------


@pytest.fixture
def model_dir(tmp_path):
    """A small inference model saved by the port (the JAX package's
    format): x [4, 8] -> fc(16, relu) -> fc(5)."""
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        x = ptt.layers.data("x", [8])
        h = ptt.layers.fc(x, 16, act="relu")
        y = ptt.layers.fc(h, 5)
    scope = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(start, scope=scope)
    ptt.io.save_inference_model(str(tmp_path), ["x"], [y], executor=exe,
                                main_program=main, scope=scope)
    return str(tmp_path)


def test_predictor_server_answers_with_predictor_run(model_dir):
    pred = ptt.Predictor(model_dir, place=CPU)
    x = np.random.RandomState(0).randn(4, 8).astype("float32")
    ref = pred.run({"x": x})[0]
    with PredictorServer(pred) as srv, \
            PredictorClient(*srv.address) as c:
        for _ in range(3):                        # pipelined
            c.send({"x": x})
        for _ in range(3):
            np.testing.assert_array_equal(c.recv()[0], ref)
        c.send({"y": x})                          # a per-request error
        with pytest.raises(RuntimeError, match="missing feeds"):
            c.recv()
        np.testing.assert_array_equal(c.infer({"x": x})[0], ref)


def test_wire_format_is_shared_across_packages(model_dir):
    x = np.random.RandomState(1).randn(4, 8).astype("float32")
    tpred = ptt.Predictor(model_dir, place=CPU)
    jpred = pt.inferencer.Predictor(model_dir)
    ref = tpred.run({"x": x})[0]
    np.testing.assert_allclose(np.asarray(jpred.run({"x": x})[0]), ref,
                               rtol=1e-5, atol=1e-6)
    with PredictorServer(tpred) as srv, JClient(*srv.address) as c:
        np.testing.assert_array_equal(c.infer({"x": x})[0], ref)
    with JPredServer(jpred) as srv, PredictorClient(*srv.address) as c:
        np.testing.assert_allclose(c.infer({"x": x})[0], ref, rtol=1e-5,
                                   atol=1e-6)


def test_engine_server_defaults_to_the_card():
    """Without a card the engine behind a server raises instead of
    dropping to the CPU; with one its default place is CUDAPlace(0)."""
    if torch.cuda.is_available():
        assert ptt.default_place() == ptt.CUDAPlace(0)
        return
    with pytest.raises(UnavailableError):
        EngineServer(ContinuousBatchingEngine(n_slots=2, **DIMS))
    with pytest.raises(UnavailableError):
        ptt.Predictor("unused")
