"""Program inspection (`paddle_tpu_torch.debugger`) against the JAX
package: `pprint_block_codes`, `pprint_program_codes` and
`draw_block_graphviz` (and `graph_viz_pass` over it) give the same text
for the same program, on a trained LM (its autodiff region and Adam ops),
ResNet-8 and a control-flow program with a sub-block; `dump_hlo` on the
CPU returns the `torch.export` graph of the op plan, naming its ATen ops.
"""

import pytest

import paddle_tpu as pt
from paddle_tpu import debugger as jdbg

import paddle_tpu_torch as ptt
from paddle_tpu_torch import debugger as tdbg

CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


def _lm(pkg):
    loss, _ = pkg.models.transformer.transformer_lm(
        vocab=40, max_len=8, d_model=32, d_inner=64, num_heads=4,
        num_layers=2)
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)


def _resnet8(pkg):
    img = pkg.layers.data("img", shape=[16, 16, 3])
    loss, _, _ = pkg.models.resnet.resnet_cifar10(img=img, depth=8)
    pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)


def _while(pkg):
    L = pkg.layers
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    n = L.fill_constant(shape=[1], dtype="int64", value=5)
    acc = L.fill_constant(shape=[1], dtype="float32", value=1.0)
    cond = L.less_than(i, n)
    w = L.control_flow.While(cond)
    with w.block():
        L.assign(acc * 2.0, acc)
        L.increment(i, in_place=True)
        L.less_than(i, n, cond=cond)


PROGRAMS = {"lm": _lm, "resnet8": _resnet8, "while": _while}


def _build(pkg, name):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        PROGRAMS[name](pkg)
    return main


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_printing_and_graphviz_match_jax(name, tmp_path):
    jmain, tmain = _build(pt, name), _build(ptt, name)
    assert tmain.to_json() == jmain.to_json()
    text = tdbg.pprint_program_codes(tmain)
    assert text == jdbg.pprint_program_codes(jmain)
    assert text.count("block ") == len(tmain.blocks)
    assert tdbg.pprint_block_codes(tmain.global_block()) == \
        jdbg.pprint_block_codes(jmain.global_block())
    for b in range(len(tmain.blocks)):
        tp, jp = str(tmp_path / f"t{b}.dot"), str(tmp_path / f"j{b}.dot")
        tdbg.draw_block_graphviz(tmain.blocks[b], tp, highlights={"fc_0.w_0"})
        jdbg.draw_block_graphviz(jmain.blocks[b], jp, highlights={"fc_0.w_0"})
        assert open(tp).read() == open(jp).read()
    viz, jviz = str(tmp_path / "pass.dot"), str(tmp_path / "jpass.dot")
    ptt.get_pass("graph_viz_pass", path=viz)(tmain)
    jdbg.draw_block_graphviz(jmain.global_block(), jviz)
    assert open(viz).read() == open(jviz).read()


def test_dump_hlo_returns_the_exported_plan_on_the_cpu(tmp_path):
    def build(pkg):
        L = pkg.layers
        x = L.data("x", shape=[6])
        h = L.fc(x, size=8, act="relu")
        L.reduce_mean(L.fc(h, size=3))
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        build(ptt)
    path = str(tmp_path / "plan.txt")
    text = tdbg.dump_hlo(main, {"x": [4, 6]}, path=path, place=CPU)
    assert open(path).read() == text
    for op in ("aten.matmul", "aten.relu", "aten.mean"):
        assert op in text, op
    # a fetch named explicitly, and a feed with its own dtype
    mid = next(op for op in main.global_block().ops
               if op.type == "relu").output_names()[0]
    text = tdbg.dump_hlo(main, {"x": ([4, 6], "float32")}, fetch_list=[mid],
                         place=CPU)
    assert "aten.relu" in text and "relu: USER_OUTPUT" in text
