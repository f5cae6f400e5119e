"""The port's ``GridSearch`` and ``RandomSearch`` against the JAX
package's with sweep fusion off (``LO_SWEEP_FUSION=0``: every point an
independent trial, as the port runs them).

Each trial trains from scratch, so both packages' trials must start
from one init: the port's ``NeuralModel._build_params`` (and, for the
classifier sweep, the JAX ``TextClassifier._build_params``) is patched
here to draw the other package's tree. Both compute in float32 on the
CPU; batch sizes are multiples of 8 (the JAX refit pads a batch to the
8-device test mesh) and fits run unshuffled (the JAX package's scan
path shuffles with ``jax.random``, ROADMAP Queue 3 deliberate item
11). Held: the same points in the same order (the
``random.Random(seed).sample`` picks), the same ``best_params_``, each
point's scores and metrics within 1e-5 (relative, an absolute floor of
1e-5; accuracy exactly), the refit's predictions within 1e-5, trial
fault isolation, artifacts in both directions and the refusals.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.catalog import ArtifactStore as JaxArtifactStore
from learningorchestra_tpu.models import sweep as jax_sweep
from learningorchestra_tpu.models import transformer as jax_tlm
from learningorchestra_tpu.models.neural import NeuralModel as JaxNeuralModel
from learningorchestra_tpu.services import faults as jax_faults
from learningorchestra_tpu_torch.catalog import ArtifactStore
from learningorchestra_tpu_torch.models import (GridSearch, NeuralModel,
                                                RandomSearch, TextClassifier,
                                                weights)
from learningorchestra_tpu_torch.services import faults

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
BODY = [{"kind": "dense", "units": 16, "activation": "relu"},
        {"kind": "dense", "units": 2, "activation": "softmax"}]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_built(self, sample_x):
    """The port's ``_build_params`` drawing the JAX package's init."""
    jm = JaxNeuralModel(self.layer_configs)
    jm.seed = self.seed
    jm._build_params(jm._coerce_x(sample_x))
    stats = weights.params_from_flax(
        _np(jm.model_state.get("batch_stats", {})), sequential=True)
    self.set_params(weights.params_from_flax(_np(jm.params),
                                             sequential=True),
                    {"batch_stats." + k: v for k, v in stats.items()},
                    input_shape=jm.input_shape)


@pytest.fixture()
def unfused(monkeypatch):
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("LO_SWEEP_FUSION", "0")
    monkeypatch.setattr(NeuralModel, "_build_params", _jax_built)
    jax_config.reset_config()
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()
    jax_config.reset_config()


def _estimators():
    jm = JaxNeuralModel(BODY, name="toy")
    jm.compile({"kind": "adam", "learning_rate": 1e-3})
    pm = NeuralModel(BODY, name="toy", device="cpu")
    pm.compile({"kind": "adam", "learning_rate": 1e-3})
    return jm, pm


def _data(n=64):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    x[:, 1] = y * 2.0 + rng.normal(size=n) * 0.5
    return x, y


def _hold(got, want):
    assert got.cv_results_["params"] == want.cv_results_["params"]
    assert got.best_params_ == want.best_params_
    np.testing.assert_allclose(got.cv_results_["mean_test_score"],
                               want.cv_results_["mean_test_score"],
                               rtol=RTOL, atol=ATOL)
    for g, w in zip(got.cv_results_["metrics"], want.cv_results_["metrics"]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)
    assert sorted(got.cv_results_) == sorted(want.cv_results_)
    assert got.fusion_info_ == want.fusion_info_ == {
        "fusedTrials": 0, "cohorts": 0, "fallbackTrials": 0,
        "earlyStopped": 0}


SWEEPS = {
    "grid, learning rates": (
        "grid", {"learning_rate": [1e-4, 5e-2]},
        dict(validation_split=0.25),
        dict(epochs=3, batch_size=16, shuffle=False)),
    "grid, optimizer x batch_size, loss scoring": (
        "grid", {"optimizer": ["sgd", "adam"], "batch_size": [8, 16]},
        dict(scoring="loss"), dict(epochs=2, shuffle=False)),
    "random, n_iter 3 of 8, seed 1": (
        "random", {"learning_rate": [1e-4, 1e-3, 1e-2, 1e-1],
                   "batch_size": [8, 16]},
        dict(n_iter=3, seed=1), dict(epochs=1, shuffle=False)),
    "random, momentum and epochs, no refit": (
        "random", {"optimizer": ["sgd"], "momentum": [0.0, 0.9],
                   "epochs": [1, 2]},
        dict(n_iter=2, seed=5, refit=False),
        dict(batch_size=8, shuffle=False)),
}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_sweep_matches_jax(unfused, case):
    kind, grid, sweep_kw, fit_kw = SWEEPS[case]
    x, y = _data()
    jm, pm = _estimators()
    jcls = jax_sweep.GridSearch if kind == "grid" else jax_sweep.RandomSearch
    cls = GridSearch if kind == "grid" else RandomSearch
    want = jcls(jm, grid, **sweep_kw).fit(x, y, **fit_kw)
    got = cls(pm, grid, device="cpu", **sweep_kw).fit(x, y, **fit_kw)
    _hold(got, want)
    if sweep_kw.get("refit", True):
        np.testing.assert_allclose(got.predict(x[:16], batch_size=8),
                                   want.predict(x[:16], batch_size=8),
                                   rtol=RTOL, atol=ATOL)
        assert got.evaluate(x, y, batch_size=8)["accuracy"] == \
            want.evaluate(x, y, batch_size=8)["accuracy"]
        assert got.summary() == want.summary()
    else:
        assert got.best_estimator_ is None
        with pytest.raises(RuntimeError, match="no refit model"):
            got.predict(x)
    # the estimator itself is never trained
    assert pm.params is None


def test_trial_fault_isolation_matches_jax(unfused, monkeypatch):
    """``sweep_trial:1``: one point fails with the injected fault and
    the sweep finishes from the rest; every point failing re-raises the
    first cause."""
    x, y = _data()
    grid = {"learning_rate": [1e-3, 1e-2, 5e-2]}
    monkeypatch.setenv("LO_FAULT_INJECT", "sweep_trial:1")
    jax_config.reset_config()
    runs = []
    for cls, est in ((jax_sweep.GridSearch, _estimators()[0]),
                     (GridSearch, _estimators()[1])):
        kw = {} if cls is jax_sweep.GridSearch else {"device": "cpu"}
        runs.append(cls(est, grid, max_parallel=1, **kw).fit(
            x, y, epochs=1, batch_size=16, shuffle=False))
    want, got = runs
    for sweep in runs:
        errors = sweep.cv_results_["error"]
        assert errors == ["InjectedFault: injected fault at sweep_trial "
                          "(1/1)", None, None]
        assert sweep.cv_results_["mean_test_score"][0] == float("-inf")
        assert sweep.best_params_ in [{"learning_rate": v}
                                      for v in grid["learning_rate"][1:]]
    assert got.best_params_ == want.best_params_
    monkeypatch.setenv("LO_FAULT_INJECT", "sweep_trial:99")
    jax_config.reset_config()
    faults.reset()
    jax_faults.reset()
    for cls, est in ((jax_sweep.GridSearch, _estimators()[0]),
                     (GridSearch, _estimators()[1])):
        kw = {} if cls is jax_sweep.GridSearch else {"device": "cpu"}
        with pytest.raises(IOError, match="injected fault at sweep_trial"):
            cls(est, grid, max_parallel=1, **kw).fit(x, y, epochs=1,
                                                     batch_size=16)


def test_unknown_hyperparameter_and_scoring_raise_as_jax(unfused):
    x, y = _data(16)
    for cls, est, kw in ((jax_sweep.GridSearch, _estimators()[0], {}),
                         (GridSearch, _estimators()[1], {"device": "cpu"})):
        with pytest.raises(ValueError, match="warp_factor"):
            cls(est, {"warp_factor": [9]}, refit=False, **kw).fit(
                x, y, epochs=1)
        with pytest.raises(ValueError, match="scoring metric 'recall'"):
            est.compile("adam", metrics=["accuracy"])
            cls(est, {"learning_rate": [1e-3]}, scoring="recall",
                refit=False, **kw).fit(x, y, epochs=1, batch_size=8)
        with pytest.raises(ValueError, match="param_grid must not be empty"):
            cls(est, {}, **kw)


def test_sweep_artifacts_load_in_both_packages(tmp_path, unfused):
    """A fitted sweep (its estimator and refit in nested dirs) saved by
    either package loads in the other with its results."""
    x, y = _data(32)
    jm, pm = _estimators()
    grid = {"learning_rate": [1e-2]}
    want = jax_sweep.GridSearch(jm, grid, validation_split=0.25).fit(
        x, y, epochs=2, batch_size=8, shuffle=False)
    JaxArtifactStore(str(tmp_path)).save(want, "jsweep", "tune/tensorflow")
    loaded = ArtifactStore(str(tmp_path), device="cpu").load("jsweep")
    assert isinstance(loaded, GridSearch)
    assert loaded.best_params_ == want.best_params_
    assert loaded.cv_results_ == want.cv_results_
    np.testing.assert_allclose(loaded.predict(x[:8], batch_size=8),
                               want.predict(x[:8], batch_size=8), atol=ATOL)
    got = RandomSearch(pm, grid, n_iter=1, validation_split=0.25,
                       device="cpu").fit(x, y, epochs=2, batch_size=8)
    d = ArtifactStore(str(tmp_path), device="cpu").save(
        got, "psweep", "tune/tensorflow")
    back = jax_sweep.RandomSearch.__lo_load__(os.path.join(d, "native"))
    assert back.best_params_ == got.best_params_
    assert back.best_score_ == got.best_score_
    np.testing.assert_allclose(back.predict(x[:8], batch_size=8),
                               got.predict(x[:8], batch_size=8), atol=ATOL)
    again = RandomSearch.__lo_load__(os.path.join(d, "native"),
                                     device="cpu")
    assert again.n_iter == 1 and again.cv_results_ == got.cv_results_


def test_text_classifier_sweep_matches_jax(unfused, monkeypatch):
    """The clone protocol over the port's module-backed classifier: a
    2-point learning-rate grid as ``tests/test_sweep.py`` runs it, both
    packages' trials starting from the port's ``init_params`` tree."""
    cfg = dict(vocab_size=16, n_classes=2, d_model=16, n_layers=1,
               n_heads=2, max_len=8)

    def built(self, sample_x):
        self.params = jax.tree_util.tree_map(
            jnp.asarray, weights.init_params(cfg, self.seed))

    monkeypatch.setattr(jax_tlm.TextClassifier, "_build_params", built)
    rng = np.random.default_rng(0)
    x = rng.integers(1, 16, size=(32, 8)).astype(np.int32)
    y = (x[:, 0] > 8).astype(np.int32)
    grid = {"learning_rate": [1e-2, 1e-3]}
    want = jax_sweep.GridSearch(jax_tlm.TextClassifier(**cfg), grid,
                                validation_split=0.25, refit=False).fit(
        x, y, batch_size=8, epochs=2, shuffle=False)
    base = TextClassifier(**cfg, device="cpu")
    got = GridSearch(base, grid, validation_split=0.25, refit=False,
                     device="cpu").fit(x, y, batch_size=8, epochs=2,
                                       shuffle=False)
    _hold(got, want)
    assert base.module is None


def test_each_trial_model_is_freed_before_the_next(unfused, monkeypatch):
    """A trial's clone (with its params and engine) is gone before the
    next trial clones, failed trials included: on the card its memory is
    free for the next one."""
    import weakref

    from learningorchestra_tpu_torch.models import sweep as sweep_lib

    clones = []
    real = sweep_lib._clone

    def tracked(estimator):
        assert all(ref() is None for ref in clones), "a trial model lives on"
        clone = real(estimator)
        clones.append(weakref.ref(clone))
        return clone

    monkeypatch.setattr(sweep_lib, "_clone", tracked)
    monkeypatch.setenv("LO_FAULT_INJECT", "sweep_trial:1")
    x, y = _data(32)
    sweep = GridSearch(_estimators()[1], {"learning_rate": [1e-3, 1e-2, 3e-2]},
                       device="cpu").fit(x, y, epochs=1, batch_size=8)
    assert len(clones) == 3  # two trials and the refit
    assert clones[-1]() is sweep.best_estimator_
    assert sweep.cv_results_["error"][0].startswith("InjectedFault")
