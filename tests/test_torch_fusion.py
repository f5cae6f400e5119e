"""The port's sweep fusion (``models/sweep.py``'s cohort planner over
``NeuralModel.fit_sweep_fused`` and ``runtime/engine.py``'s
``FusedEngine``), against the JAX package's.

- The cases of ``tests/test_sweep_fusion.py`` run on the port: the
  planner, fused-vs-unfused parity, one fused step build per cohort, the
  fallback of a grid with no fusable axis, early stop, trial fault
  isolation, scoring and the stats.
- The port's fused sweep against the JAX package's fused sweep for a
  dense toy, a small CNN with batch norm (and a dropout layer of rate 0:
  the packages draw dropout differently) and a small LSTM: unshuffled,
  each trial starting from the JAX package's init (the port's
  ``_build_params`` patched, as ``tests/test_torch_sweep.py`` does). Held:
  the same ``fusion_info_`` and ``best_params_``, each point's metrics
  within 1e-4 (the bound of the JAX package's own
  ``test_fused_matches_unfused_trials``).
- The port fused against the port unfused with ``shuffle=True`` and
  dropout, within 1e-4, for a CNN, an LSTM and a bidirectional GRU.
- ``LO_SCAN_FIT_MAX_BYTES`` below the data: every point falls back
  (``fallbackTrials`` N) and the results equal the unfused sweep's bit
  for bit; so does a fit keyword the fused path does not take, and
  ``grad_accum`` reaches the fused fit.

float32 throughout; batch sizes are multiples of 8 (the JAX batcher pads
to the 8-device test mesh).
"""

import jax
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.models import sweep as jax_sweep
from learningorchestra_tpu.models.neural import NeuralModel as JaxNeuralModel
from learningorchestra_tpu_torch.models import GridSearch, NeuralModel, weights
from learningorchestra_tpu_torch.models import sweep as sweep_lib
from learningorchestra_tpu_torch.runtime import engine as engine_lib
from learningorchestra_tpu_torch.services import faults

torch.set_num_threads(2)

TOL = 1e-4
DENSE = [{"kind": "dense", "units": 16, "activation": "relu"},
         {"kind": "dense", "units": 2, "activation": "softmax"}]
CNN = [{"kind": "conv2d", "filters": 4, "kernel": [3, 3],
        "activation": "relu"},
       {"kind": "batchnorm"}, {"kind": "maxpool2d"},
       {"kind": "dropout", "rate": 0.0}, {"kind": "flatten"},
       {"kind": "dense", "units": 3, "activation": "softmax"}]
LSTM = [{"kind": "embedding", "vocab": 40, "dim": 8},
        {"kind": "lstm", "units": 6},
        {"kind": "dense", "units": 2, "activation": "softmax"}]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    monkeypatch.delenv("LO_SWEEP_FUSION", raising=False)
    jax_config.reset_config()
    faults.reset()
    yield
    faults.reset()
    jax_config.reset_config()


def _estimator(body=DENSE, opt=None):
    model = NeuralModel(body, name="toy", device="cpu")
    model.compile(opt or {"kind": "adam", "learning_rate": 1e-3})
    return model


def _data(n=64):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    x[:, 1] = y * 2.0  # separable
    return x, y


def _images(n=48):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    x[np.arange(n), y, y, 0] += 3.0
    return x, y


def _tokens(n=64):
    rng = np.random.default_rng(2)
    x = rng.integers(1, 40, size=(n, 7)).astype(np.int32)
    y = (x[:, -1] < 20).astype(np.int32)
    return x, y


def _sweep(monkeypatch, fused: bool, body, grid, x, y, sweep_kw=None,
           **fit_kw):
    monkeypatch.setenv("LO_SWEEP_FUSION", "1" if fused else "0")
    sweep = GridSearch(_estimator(body), grid, device="cpu",
                       **dict(dict(validation_split=0.25, refit=False),
                              **(sweep_kw or {})))
    return sweep.fit(x, y, **fit_kw)


def _hold(got, want, exact=False):
    assert got.cv_results_["params"] == want.cv_results_["params"]
    assert got.best_params_ == want.best_params_
    for g, w in zip(got.cv_results_["metrics"], want.cv_results_["metrics"]):
        assert sorted(g) == sorted(w)
        for k in w:
            if exact:
                assert g[k] == w[k], (k, g[k], w[k])
            else:
                assert abs(g[k] - w[k]) < TOL, (k, g[k], w[k])


# ---------------------------------------------------------------------
# the cohort planner
# ---------------------------------------------------------------------
def test_planner_fuses_homogeneous_lr_grid():
    sweep = GridSearch(_estimator(), {"learning_rate": [1e-4, 1e-3]},
                       refit=False, device="cpu")
    cohorts, residual = sweep._plan_cohorts(sweep._combinations())
    assert residual == []
    assert len(cohorts) == 1
    assert cohorts[0]["indices"] == [0, 1]
    assert cohorts[0]["hyper"] == [{"learning_rate": 1e-4},
                                   {"learning_rate": 1e-3}]


def test_planner_groups_by_program_shaping_keys():
    """batch_size shapes the program: a lr x batch_size grid is one
    cohort per batch size."""
    sweep = GridSearch(_estimator(), {"learning_rate": [1e-4, 1e-3],
                                      "batch_size": [8, 16]},
                       refit=False, device="cpu")
    combos = sweep._combinations()
    cohorts, residual = sweep._plan_cohorts(combos)
    assert residual == []
    assert sorted(len(c["indices"]) for c in cohorts) == [2, 2]
    for cohort in cohorts:
        assert len({combos[i]["batch_size"] for i in cohort["indices"]}) == 1


def test_planner_leaves_unfusable_grid_residual():
    sweep = GridSearch(_estimator(), {"batch_size": [8, 16]}, refit=False,
                       device="cpu")
    assert sweep._plan_cohorts(sweep._combinations()) == ([], [0, 1])
    sweep = GridSearch(_estimator(), {"lr": [1e-4, 1e-3]}, refit=False,
                       device="cpu")
    cohorts, _ = sweep._plan_cohorts(sweep._combinations())
    assert len(cohorts) == 1
    assert cohorts[0]["hyper"][0] == {"learning_rate": 1e-4}


def test_planner_respects_estimator_opt_out():
    est = _estimator()
    combos = GridSearch(est, {"learning_rate": [1e-4, 1e-3]},
                        device="cpu")._combinations()

    class NoFusion(NeuralModel):
        def fit(self, *a, **k):  # overriding training opts out
            return super().fit(*a, **k)

    opted_out = NoFusion(est.layer_configs, device="cpu")
    assert est.supports_sweep_fusion()
    assert not opted_out.supports_sweep_fusion()
    sweep = GridSearch(opted_out, {"learning_rate": [1e-4, 1e-3]},
                       refit=False, device="cpu")
    assert sweep._plan_cohorts(combos) == ([], [0, 1])


# ---------------------------------------------------------------------
# fusion against independent trials (the port's own)
# ---------------------------------------------------------------------
def test_fused_matches_unfused_trials(monkeypatch):
    x, y = _data()
    grid = {"learning_rate": [1e-5, 5e-2]}
    fused = _sweep(monkeypatch, True, DENSE, grid, x, y, epochs=4,
                   batch_size=16)
    assert fused.fusion_info_ == {"fusedTrials": 2, "cohorts": 1,
                                  "fallbackTrials": 0, "earlyStopped": 0}
    serial = _sweep(monkeypatch, False, DENSE, grid, x, y, epochs=4,
                    batch_size=16)
    assert serial.fusion_info_["fusedTrials"] == 0
    _hold(fused, serial)


def test_fused_sweep_traces_once(monkeypatch):
    """One cohort is one build of the fused step, however many points it
    carries."""
    x, y = _data()
    before = engine_lib.fused_epoch_traces()
    sweep = _sweep(monkeypatch, True, DENSE,
                   {"learning_rate": [1e-4, 1e-3, 1e-2, 5e-2]}, x, y,
                   epochs=3, batch_size=16)
    assert sweep.fusion_info_["fusedTrials"] == 4
    assert engine_lib.fused_epoch_traces() - before == 1


def test_heterogeneous_grid_falls_back_bit_for_bit(monkeypatch):
    x, y = _data(32)
    grid = {"batch_size": [8, 16]}
    on = _sweep(monkeypatch, True, DENSE, grid, x, y, epochs=2)
    assert on.fusion_info_["fusedTrials"] == 0
    off = _sweep(monkeypatch, False, DENSE, grid, x, y, epochs=2)
    assert on.cv_results_["params"] == off.cv_results_["params"]
    assert on.cv_results_["mean_test_score"] == \
        off.cv_results_["mean_test_score"]
    assert on.cv_results_["metrics"] == off.cv_results_["metrics"]
    assert "error" not in on.cv_results_ and "error" not in off.cv_results_


def test_earlystop_margin_never_changes_unstopped_sweep(monkeypatch):
    x, y = _data()
    grid = {"learning_rate": [1e-3, 5e-2]}
    baseline = _sweep(monkeypatch, True, DENSE, grid, x, y, epochs=3,
                      batch_size=16)
    monkeypatch.setenv("LO_SWEEP_EARLYSTOP_MARGIN", "1e9")
    monkeypatch.setenv("LO_SWEEP_EARLYSTOP_MIN_EPOCHS", "1")
    armed = _sweep(monkeypatch, True, DENSE, grid, x, y, epochs=3,
                   batch_size=16)
    assert armed.fusion_info_["earlyStopped"] == 0
    assert armed.cv_results_["metrics"] == baseline.cv_results_["metrics"]
    assert armed.best_params_ == baseline.best_params_


def test_earlystop_freezes_trailing_config(monkeypatch):
    x, y = _data()
    monkeypatch.setenv("LO_SWEEP_EARLYSTOP_MARGIN", "0.05")
    monkeypatch.setenv("LO_SWEEP_EARLYSTOP_MIN_EPOCHS", "2")
    sweep = _sweep(monkeypatch, True, DENSE,
                   {"learning_rate": [1e-5, 5e-2]}, x, y, epochs=6,
                   batch_size=16)
    assert sweep.fusion_info_["fusedTrials"] == 2
    assert sweep.fusion_info_["earlyStopped"] >= 1
    assert sweep.best_params_["learning_rate"] == 5e-2


# ---------------------------------------------------------------------
# trial fault isolation and scoring
# ---------------------------------------------------------------------
def test_failing_trial_does_not_abort_sweep(monkeypatch):
    x, y = _data(32)
    monkeypatch.setenv("LO_FAULT_INJECT", "sweep_trial:1")
    before = sweep_lib.fusion_stats()["trialErrors"]
    sweep = _sweep(monkeypatch, False, DENSE, {"learning_rate": [1e-4, 5e-2]},
                   x, y, sweep_kw={"max_parallel": 1}, epochs=1,
                   batch_size=16)
    errors = sweep.cv_results_["error"]
    assert errors[0] and "InjectedFault" in errors[0]
    assert errors[1] is None
    assert sweep.cv_results_["mean_test_score"][0] == float("-inf")
    assert sweep.best_params_ == {"learning_rate": 5e-2}
    assert "_exc" not in sweep.cv_results_
    assert sweep_lib.fusion_stats()["trialErrors"] == before + 1


def test_all_trials_failed_reraises_cause(monkeypatch):
    x, y = _data(32)
    monkeypatch.setenv("LO_FAULT_INJECT", "sweep_trial:2")
    with pytest.raises(faults.InjectedFault):
        _sweep(monkeypatch, False, DENSE, {"learning_rate": [1e-4, 5e-2]},
               x, y, sweep_kw={"max_parallel": 1}, epochs=1, batch_size=16)


def test_unknown_scoring_names_available_metrics(monkeypatch):
    x, y = _data(32)
    with pytest.raises(ValueError, match="accuracy"):
        _sweep(monkeypatch, True, DENSE, {"learning_rate": [1e-3]}, x, y,
               sweep_kw={"scoring": "f1"}, epochs=1, batch_size=16)


def test_valid_scoring_rejects_unknown_metric():
    from learningorchestra_tpu_torch.services import validators as V

    with pytest.raises(V.HttpError) as err:
        V.valid_scoring("f1")
    assert err.value.status == V.HTTP_NOT_ACCEPTABLE
    assert "accuracy" in err.value.message
    for ok in ("auto", "loss", "accuracy", "precision", "recall", None):
        V.valid_scoring(ok)


def test_model_service_gates_sweep_scoring():
    from learningorchestra_tpu_torch.services import validators as V
    from learningorchestra_tpu_torch.services.model_service import \
        _valid_sweep_scoring

    with pytest.raises(V.HttpError):
        _valid_sweep_scoring(GridSearch, {"scoring": "f1"})
    _valid_sweep_scoring(GridSearch, {"scoring": "accuracy"})
    _valid_sweep_scoring(GridSearch, {})
    _valid_sweep_scoring(NeuralModel, {"scoring": "f1"})


def test_fusion_stats_surface(monkeypatch):
    x, y = _data()
    before = sweep_lib.fusion_stats()
    for key in ("fusedTrials", "cohorts", "fallbackTrials",
                "earlyStopped", "trialErrors", "fusedEpochTraces"):
        assert key in before
    _sweep(monkeypatch, True, DENSE, {"learning_rate": [1e-3, 1e-2]}, x, y,
           epochs=1, batch_size=16)
    after = sweep_lib.fusion_stats()
    assert after["fusedTrials"] == before["fusedTrials"] + 2
    assert after["cohorts"] == before["cohorts"] + 1
    assert after["fusedEpochTraces"] == before["fusedEpochTraces"] + 1


# ---------------------------------------------------------------------
# the port's fused sweep against the JAX package's
# ---------------------------------------------------------------------
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


JAX_CASES = {
    "dense toy, learning rates": (DENSE, _data, {
        "learning_rate": [1e-5, 5e-2]}, {"kind": "adam"}, 16, 3),
    "cnn with batch norm, learning rates x batch sizes": (CNN, _images, {
        "learning_rate": [1e-3, 2e-2], "batch_size": [8, 16]},
        {"kind": "adam"}, None, 2),
    "lstm, sgd learning rate x momentum": (LSTM, _tokens, {
        "learning_rate": [5e-2, 2e-1], "momentum": [0.0, 0.9]},
        {"kind": "sgd"}, 16, 2),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_fused_sweep_matches_jax_fused(case, monkeypatch):
    body, data, grid, opt, batch_size, epochs = JAX_CASES[case]
    monkeypatch.setattr(NeuralModel, "_build_params", _jax_built)
    monkeypatch.setenv("LO_SWEEP_FUSION", "1")
    jax_config.reset_config()
    x, y = data()
    fit_kw = dict(epochs=epochs, shuffle=False)
    if batch_size is not None:
        fit_kw["batch_size"] = batch_size
    jm = JaxNeuralModel(body, name="toy")
    jm.compile(dict(opt, learning_rate=1e-3))
    want = jax_sweep.GridSearch(jm, grid, validation_split=0.25,
                                refit=False).fit(x, y, **fit_kw)
    pm = _estimator(body, dict(opt, learning_rate=1e-3))
    got = GridSearch(pm, grid, validation_split=0.25, refit=False,
                     device="cpu").fit(x, y, **fit_kw)
    assert want.fusion_info_["fusedTrials"] == len(want.cv_results_["params"])
    assert got.fusion_info_ == want.fusion_info_
    _hold(got, want)


FUSED_CASES = {
    "cnn with batch norm and dropout": (
        [dict(CNN[0]), CNN[1], CNN[2], {"kind": "dropout", "rate": 0.3},
         CNN[4], CNN[5]], _images, {"learning_rate": [1e-3, 2e-2]}, 8),
    "lstm": (LSTM, _tokens, {"learning_rate": [1e-3, 5e-2]}, 16),
    "bidirectional gru, sequences, dropout": (
        [LSTM[0], {"kind": "bidirectional_gru", "units": 5,
                   "return_sequences": True},
         {"kind": "dropout", "rate": 0.2}, {"kind": "flatten"}, LSTM[2]],
        _tokens, {"learning_rate": [1e-3, 5e-2]}, 16),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_matches_unfused_shuffled(case, monkeypatch):
    body, data, grid, batch_size = FUSED_CASES[case]
    x, y = data()
    kw = dict(epochs=2, batch_size=batch_size, shuffle=True)
    fused = _sweep(monkeypatch, True, body, grid, x, y, **kw)
    assert fused.fusion_info_["fusedTrials"] == 2
    _hold(fused, _sweep(monkeypatch, False, body, grid, x, y, **kw))


def test_over_budget_falls_back_bit_for_bit(monkeypatch):
    x, y = _images()
    grid = {"learning_rate": [1e-3, 2e-2], "batch_size": [8, 16]}
    monkeypatch.setenv("LO_SCAN_FIT_MAX_BYTES", str(x.nbytes // 2))
    over = _sweep(monkeypatch, True, CNN, grid, x, y, epochs=1)
    assert over.fusion_info_ == {"fusedTrials": 0, "cohorts": 0,
                                 "fallbackTrials": 4, "earlyStopped": 0}
    _hold(over, _sweep(monkeypatch, False, CNN, grid, x, y, epochs=1),
          exact=True)


def test_fused_cohort_takes_grad_accum(monkeypatch):
    """``grad_accum`` reaches a fused cohort's fit, so a fused point
    still equals its trial (the JAX fused path drops it: ROADMAP Queue 3
    item 36); batch norm makes the micro-batches show."""
    x, y = _data()
    body = [DENSE[0], {"kind": "batchnorm"}, DENSE[1]]
    grid = {"learning_rate": [1e-3, 5e-2]}
    kw = dict(epochs=2, batch_size=16, grad_accum=2)
    fused = _sweep(monkeypatch, True, body, grid, x, y, **kw)
    assert fused.fusion_info_["fusedTrials"] == 2
    _hold(fused, _sweep(monkeypatch, False, body, grid, x, y, **kw))
    plain = _sweep(monkeypatch, True, body, grid, x, y, epochs=2,
                   batch_size=16)
    assert plain.cv_results_["metrics"] != fused.cv_results_["metrics"]


def test_trial_only_fit_keywords_fall_back(monkeypatch):
    """A fit keyword the fused path does not take (here ``class_weight``)
    runs the cohort as trials, equal to the unfused sweep bit for bit."""
    x, y = _data()
    grid = {"learning_rate": [1e-3, 5e-2]}
    kw = dict(epochs=1, batch_size=16, class_weight={0: 1.0, 1: 3.0})
    over = _sweep(monkeypatch, True, DENSE, grid, x, y, **kw)
    assert over.fusion_info_ == {"fusedTrials": 0, "cohorts": 0,
                                 "fallbackTrials": 2, "earlyStopped": 0}
    _hold(over, _sweep(monkeypatch, False, DENSE, grid, x, y, **kw),
          exact=True)


OPTIMIZER_CASES = {
    "adam": {"learning_rate": [1e-3, 3e-2], "beta_1": [0.9, 0.8],
             "beta_2": [0.999, 0.99]},
    "adamw": {"learning_rate": [1e-3, 3e-2], "weight_decay": [1e-4, 1e-2]},
    "sgd": {"learning_rate": [1e-2, 1e-1], "momentum": [0.0, 0.9]},
    "rmsprop": {"learning_rate": [1e-3, 1e-2], "rho": [0.9, 0.5],
                "momentum": [0.0, 0.5]},
    "adagrad": {"learning_rate": [1e-2, 1e-1]},
}


@pytest.mark.parametrize("kind", list(OPTIMIZER_CASES))
def test_stacked_optimizer_equals_each_configs_own(kind):
    """Three steps of the update rule over tensors stacked on a config
    axis, with one value per config of each scalar, equal each config's
    own unstacked rule bit for bit (its spec's floats, cast to float32)."""
    from learningorchestra_tpu_torch.models.neural import (
        Optimizer, build_optimizer_factory)

    hyper = OPTIMIZER_CASES[kind]
    rng = np.random.default_rng(3)
    init = {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in init.items()} for _ in range(3)]
    stacked = {k: torch.from_numpy(np.stack([v, v])) for k, v in init.items()}
    fused = build_optimizer_factory({"kind": kind})(hyper)
    state = fused.init(stacked)
    for g in grads:
        fused.update(stacked, {k: torch.from_numpy(np.stack([v, v]))
                               for k, v in g.items()}, state)
    for i in range(2):
        own = Optimizer({"kind": kind, **{k: v[i] for k, v in hyper.items()}})
        params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
        own_state = own.init(params)
        for g in grads:
            own.update(params, {k: torch.from_numpy(v) for k, v in g.items()},
                       own_state)
        for k, v in params.items():
            assert torch.equal(stacked[k][i], v), (kind, i, k)
