"""The dataflow layer (`framework/dataflow.py`) against the JAX package.

On the zoo programs of test_torch_analysis.py (and the LM with dropout,
whose draws carry rng taints), built in both packages: every op's effect
set, the def-use chains, the variable lifetimes (with and without the
backward-region rule), the interference graph, the divergence taints,
a custom `propagate` and the dataflow checks are equal, and so is the
declared-shape byte pricing (`declared_var_bytes`: the declared dtype's
width in both packages, 64-bit types included).
"""

import pytest

import paddle_tpu as pt
from paddle_tpu.framework import dataflow as jdf

import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework import dataflow as tdf

from test_torch_analysis import ZOO, build_pair, diag_keys  # noqa: F401
from test_torch_analysis import fresh_port_state  # noqa: F401


def _lm_dropout(pkg):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        loss, _ = pkg.models.transformer.transformer_lm(
            vocab=64, max_len=8, d_model=32, d_inner=64, num_heads=4,
            num_layers=2, dropout=0.1)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main


def _pair(name):
    if name == "lm_dropout":
        j, t = _lm_dropout(pt), _lm_dropout(ptt)
        assert t.to_json() == j.to_json()
        return j, t
    return build_pair(name)


NAMES = sorted(ZOO) + ["lm_dropout"]


def _taints(env):
    return {k: sorted((x.axis, x.kind, x.src) for x in v)
            for k, v in env.items()}


@pytest.mark.parametrize("name", NAMES)
def test_effects_def_use_lifetimes_and_interference_equal_jax(name):
    j, t = _pair(name)
    for jb, tb in zip(j.blocks, t.blocks):
        assert [tuple(vars(tdf.op_effects(op)).values())
                for op in tb.ops] == \
            [tuple(vars(jdf.op_effects(op)).values()) for op in jb.ops]
        jd, td = jdf.def_use_chains(jb), tdf.def_use_chains(tb)
        assert (td.block_idx, td.producers, td.consumers) == \
            (jd.block_idx, jd.producers, jd.consumers)
        for name_ in list(td.consumers)[:5]:
            assert td.uses_after(name_, 0) == jd.uses_after(name_, 0)
        for regions in (True, False):
            assert tdf.var_lifetimes(tb, include_regions=regions) == \
                jdf.var_lifetimes(jb, include_regions=regions)
        assert tdf.interference_graph(tb) == jdf.interference_graph(jb)


@pytest.mark.parametrize("name", NAMES)
def test_taints_and_checks_equal_jax(name):
    j, t = _pair(name)
    assert _taints(tdf.divergence_taints(t)) == \
        _taints(jdf.divergence_taints(j))
    assert diag_keys(tdf.dataflow_checks(t)) == \
        diag_keys(jdf.dataflow_checks(j))
    assert diag_keys(tdf.cache_write_aliasing(t)) == \
        diag_keys(jdf.cache_write_aliasing(j))

    def seeds(mod):
        # every data var tainted over dp: propagate's default transfer
        # carries the union to everything computed from the feeds
        return lambda block, n, v: (
            [mod.Taint("dp", "shard", n)] if v.is_data else [])

    assert _taints(tdf.propagate(t, var_seeds=seeds(tdf))) == \
        _taints(jdf.propagate(j, var_seeds=seeds(jdf)))


def test_declared_var_bytes_equal_jax():
    j, t = build_pair("lm")
    jb, tb = j.global_block(), t.global_block()
    for name in tb.vars:
        jn = jdf.declared_var_bytes(jb, name, 3)
        tn = tdf.declared_var_bytes(tb, name, 3)
        assert tn == jn, name
    assert tdf.REGION_OPS == jdf.REGION_OPS
    assert (tdf.DP_AXIS, tdf.TP_AXIS, tdf.PP_AXIS) == \
        (jdf.DP_AXIS, jdf.TP_AXIS, jdf.PP_AXIS)
