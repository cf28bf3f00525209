"""The port's host-side metric classes (`paddle_tpu_torch.metrics`, and
the `evaluator` aliases) against the JAX package's: the same updates give
the same `eval()` (exactly: both are the same numpy arithmetic), the same
states after `reset()`, and the same errors. Updates are fed torch tensors
on the port's side, numpy arrays on the JAX package's, as each package's
executor returns them."""

import numpy as np
import pytest
import torch

from paddle_tpu import evaluator as jevaluator
from paddle_tpu import metrics as jmetrics

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import InvalidArgumentError

from tests.port_env import port_jax_compile_cache  # noqa: F401

R = np.random.RandomState(37)


def _updates(name):
    """(constructor kwargs, a list of update-argument tuples)."""
    if name in ("Precision", "Recall"):
        return {}, [(R.uniform(0, 1, (8, 1)), R.randint(0, 2, (8, 1)))
                    for _ in range(3)]
    if name == "Accuracy":
        return {}, [(np.float32(R.uniform()), 8), (np.float32(0.25), 3)]
    if name == "ChunkEvaluator":
        return {}, [(np.int64([5]), np.int64([6]), np.int64([3])),
                    (np.int64([2]), np.int64([1]), np.int64([1]))]
    if name == "EditDistance":
        return {}, [(np.float32([[0], [2], [1], [0]]), np.int64([4])),
                    (np.float32([[3]]), 1)]
    if name == "Auc":
        p = R.uniform(0, 1, (40, 1))
        return {"num_thresholds": 200}, [
            (np.concatenate([1 - p, p], 1), R.randint(0, 2, (40, 1)))]
    if name == "DetectionMAP":
        det = np.float32([[1, 0.9, 0.1, 0.1, 0.4, 0.4],
                          [1, 0.8, 0.1, 0.1, 0.4, 0.4],
                          [2, 0.7, 0.5, 0.5, 0.9, 0.9],
                          [2, 0.95, 0.2, 0.2, 0.6, 0.6],
                          [1, 0.6, 0.0, 0.0, 0.3, 0.3]])
        gt = np.float32([[1, 0.1, 0.1, 0.4, 0.4], [2, 0.5, 0.5, 0.85, 0.9],
                         [2, 0.25, 0.2, 0.6, 0.6], [3, 0.0, 0.0, 0.2, 0.2]])
        return {"overlap_threshold": 0.5}, [(det, [3, 2], gt, [2, 2])]
    raise KeyError(name)


def _as_torch(a):
    return torch.from_numpy(np.asarray(a)) if isinstance(
        a, np.ndarray) else a


NAMES = ["Precision", "Recall", "Accuracy", "ChunkEvaluator",
         "EditDistance", "Auc", "DetectionMAP"]


@pytest.mark.parametrize("name", NAMES)
def test_metric_matches_jax(name):
    kwargs, updates = _updates(name)
    jm = getattr(jmetrics, name)(**kwargs)
    tm = getattr(ptt.metrics, name)(**kwargs)
    for args in updates:
        jm.update(*args)
        tm.update(*(_as_torch(a) for a in args))
        assert tm.eval() == jm.eval()
    assert {k: v for k, v in tm.get_config()["states"].items()} == \
        {k: v for k, v in jm.get_config()["states"].items()}
    tm.reset()
    jm.reset()
    assert tm.get_config()["states"] == jm.get_config()["states"]


@pytest.mark.parametrize("version", ["integral", "11point"])
def test_detection_map_versions_match_jax(version):
    kwargs, updates = _updates("DetectionMAP")
    jm = jmetrics.DetectionMAP(ap_version=version, **kwargs)
    tm = ptt.metrics.DetectionMAP(ap_version=version, **kwargs)
    for args in updates:
        jm.update(*args)
        tm.update(*args)
    assert 0.0 < tm.eval() == jm.eval() < 1.0


def test_composite_metric_and_evaluator_aliases():
    comp = ptt.metrics.CompositeMetric()
    jcomp = jmetrics.CompositeMetric()
    for pkg, c in ((ptt.metrics, comp), (jmetrics, jcomp)):
        c.add_metric(pkg.Precision())
        c.add_metric(pkg.Recall())
    for args in _updates("Precision")[1]:
        comp.update(*(_as_torch(a) for a in args))
        jcomp.update(*args)
    assert comp.eval() == jcomp.eval()
    assert ptt.evaluator.__all__ == jevaluator.__all__
    for n in ptt.evaluator.__all__:
        assert getattr(ptt.evaluator, n) is getattr(ptt.metrics, n)


def test_metric_errors_match_jax():
    for pkg in (jmetrics, ptt.metrics):
        with pytest.raises(Exception, match="call update first"):
            pkg.EditDistance().eval()
        with pytest.raises(Exception, match="non-negative"):
            pkg.Accuracy().update(0.5, -1)
    with pytest.raises(InvalidArgumentError):
        ptt.metrics.DetectionMAP(ap_version="voc")
    with pytest.raises(InvalidArgumentError):
        ptt.metrics.CompositeMetric().add_metric(object())
