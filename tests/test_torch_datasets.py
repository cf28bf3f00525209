"""The port's copy of the synthetic datasets (`paddle_tpu_torch.data.
datasets`) against the JAX package's module: every reader yields the same
first samples, and the dictionaries and constants agree.
"""

import inspect

import numpy as np
import pytest

from paddle_tpu.data import datasets as jD

import paddle_tpu_torch as ptt
from paddle_tpu_torch.data import datasets as tD

from tests.port_env import port_jax_compile_cache  # noqa: F401

SAMPLES = 4

READERS = [(cls, meth) for cls, c in sorted(vars(jD).items())
           if inspect.isclass(c) and c.__module__ == jD.__name__
           for meth in ("train", "test", "valid", "val", "train10",
                        "test10", "train100") if meth in vars(c)]


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("cls,meth", READERS,
                         ids=[f"{c}.{m}" for c, m in READERS])
def test_reader_yields_the_jax_packages_samples(cls, meth):
    want = getattr(getattr(jD, cls), meth)()()
    got = getattr(getattr(tD, cls), meth)()()
    for _ in range(SAMPLES):
        _same(next(want), next(got))


def test_dictionaries_and_constants_agree():
    assert tD.conll05.get_dict() == jD.conll05.get_dict()
    assert tD.sentiment.get_word_dict() == jD.sentiment.get_word_dict()
    assert tD.imdb.word_dict() == jD.imdb.word_dict()
    for cls in ("conll05", "wmt_synthetic", "movielens", "flowers",
                "mq2007", "wmt14"):
        jc, tc = getattr(jD, cls), getattr(tD, cls)
        consts = {k: v for k, v in vars(jc).items()
                  if k.isupper() or k in ("src_vocab", "trg_vocab", "bos",
                                          "eos")}
        assert consts == {k: getattr(tc, k) for k in consts}, cls
