"""Hyperparameter sweeps of the port: :class:`GridSearch` and
:class:`RandomSearch` (:mod:`learningorchestra_tpu.models.sweep`), with
the GridSearchCV-shaped surface the tune route exists for (``fit``,
``best_params_``, ``best_score_``, ``cv_results_``, ``best_estimator_``).

On one card every point runs as its own trial, one after another on the
calling thread, as the JAX package runs them when one trial fits at a
time: a clone of the estimator through its artifact protocol
(``__lo_save__``/``__lo_load__`` on the estimator's device, weights
dropped), the point's overrides routed to the optimizer spec, the fit's
keywords or the model's attributes, a fit on the head of the data and an
``evaluate`` on the tail ``validation_split``. A failed point is recorded
with its ``error`` and a score of -inf (its traceback's frames are
cleared, so a failed trial's model does not hold card memory); a sweep
whose every point failed raises the first cause. Each trial's model is
collected before the next trial starts. The best point is
refitted on all the data into ``best_estimator_``. The ``sweep_trial``
fault site (:mod:`..services.faults`) fires at the start of each trial.

Sweep fusion (the JAX package's fused cohorts, ``LO_SWEEP_FUSION``) is
not ported: ``fusion_info_`` reports what the JAX package reports with
fusion off, every point a trial of its own.
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import random as random_mod
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from learningorchestra_tpu_torch.config import Config, resolve_device
from learningorchestra_tpu_torch.runtime.data import dataframe_to_arrays
from learningorchestra_tpu_torch.services import faults

# hyperparameter names routed into the optimizer spec
_OPTIMIZER_KEYS = {"kind", "learning_rate", "lr", "momentum",
                   "weight_decay", "beta_1", "beta_2", "rho", "nesterov"}
# names routed into fit() kwargs
_FIT_KEYS = {"batch_size", "epochs"}


def _clone(estimator):
    """A clone through the artifact protocol on the estimator's device,
    without weights: sweep trials train from scratch."""
    with tempfile.TemporaryDirectory(prefix="lo_sweep_clone_") as tmp:
        estimator.__lo_save__(tmp)
        clone = type(estimator).__lo_load__(tmp, device=estimator.device)
    clone.module = None  # the port's models build their weights at fit
    return clone


def _apply_overrides(model, overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Route hyperparameters to the optimizer spec, fit kwargs or model
    attributes. Returns the fit kwargs."""
    fit_kwargs: Dict[str, Any] = {}
    for key, value in overrides.items():
        if key in _FIT_KEYS:
            fit_kwargs[key] = value
        elif key in _OPTIMIZER_KEYS:
            if key == "lr":
                key = "learning_rate"
            model.optimizer_spec[key] = value
        elif key == "optimizer":
            model.optimizer_spec["kind"] = value
        elif hasattr(model, key):
            setattr(model, key, value)
        else:
            raise ValueError(
                f"unknown hyperparameter {key!r} for "
                f"{type(model).__name__}")
    model._engine = None  # spec changes must rebuild the engine
    return fit_kwargs


class GridSearch:
    """Exhaustive (or, with ``n_iter``, sampled) search over
    ``param_grid`` for the port's keras-shaped models (``NeuralModel``,
    ``TextClassifier``, ``LanguageModel``), scored by ``scoring`` from
    ``evaluate`` (``"auto"``: accuracy if reported, else minus the loss;
    ``"loss"`` is minimized). ``max_parallel`` is kept for the JAX
    package's signature; on one card trials run one at a time.
    ``device`` is where the sweep's artifacts load; trials run on the
    estimator's device."""

    def __init__(self, estimator, param_grid: Dict[str, Sequence[Any]],
                 n_iter: Optional[int] = None, scoring: str = "auto",
                 validation_split: float = 0.2,
                 max_parallel: Optional[int] = None, refit: bool = True,
                 seed: int = 0, name: str = "grid_search", device="cuda"):
        if not param_grid:
            raise ValueError("param_grid must not be empty")
        self.name = name
        self.estimator = estimator
        self.param_grid = {k: list(v) for k, v in param_grid.items()}
        self.n_iter = n_iter
        self.scoring = scoring
        self.validation_split = float(validation_split)
        self.max_parallel = max_parallel
        self.refit = refit
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.cv_results_: Dict[str, List[Any]] = {}
        self.best_params_: Optional[Dict[str, Any]] = None
        self.best_score_: Optional[float] = None
        self.best_estimator_ = None
        self.fusion_info_: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def _combinations(self) -> List[Dict[str, Any]]:
        keys = sorted(self.param_grid)
        combos = [dict(zip(keys, values)) for values in
                  itertools.product(*(self.param_grid[k] for k in keys))]
        if self.n_iter is not None and self.n_iter < len(combos):
            rng = random_mod.Random(self.seed)
            combos = rng.sample(combos, self.n_iter)
        return combos

    def _split(self, x, y):
        if hasattr(x, "to_numpy"):  # a catalog Table from the $ DSL
            x = dataframe_to_arrays(x)["x"]
        if y is not None and hasattr(y, "to_numpy"):
            y = y.to_numpy()
        x = np.asarray(x)
        n = len(x)
        n_val = max(1, int(n * self.validation_split)) \
            if self.validation_split > 0 else 0
        if n_val == 0 or n_val >= n:
            return x, y, x, y  # degenerate: score on train data
        tx, vx = x[:-n_val], x[-n_val:]
        if y is None:
            return tx, None, vx, None
        y = np.asarray(y)
        return tx, y[:-n_val], vx, y[-n_val:]

    def _score(self, metrics: Dict[str, float]) -> float:
        if self.scoring == "auto":
            if "accuracy" in metrics:
                return float(metrics["accuracy"])
            return -float(metrics["loss"])
        if self.scoring == "loss":
            return -float(metrics["loss"])
        if self.scoring not in metrics:
            raise ValueError(
                f"scoring metric {self.scoring!r} not reported by the "
                f"estimator; available: {sorted(metrics)}")
        return float(metrics[self.scoring])

    def _run_trial(self, combo: Dict[str, Any], tx, ty, vx, vy,
                   fit_kwargs: Dict[str, Any]) -> Dict[str, Any]:
        t0 = time.perf_counter()
        model = None
        try:
            faults.maybe_inject("sweep_trial", Config())
            model = _clone(self.estimator)
            trial_kwargs = dict(fit_kwargs)
            trial_kwargs.update(_apply_overrides(model, combo))
            batch_size = trial_kwargs.get("batch_size")
            if ty is None:
                model.fit(tx, **trial_kwargs)
                metrics = model.evaluate(vx, batch_size=batch_size)
            else:
                model.fit(tx, ty, **trial_kwargs)
                metrics = model.evaluate(vx, vy, batch_size=batch_size)
            return {"params": combo, "metrics": metrics,
                    "score": self._score(metrics),
                    "fit_time": round(time.perf_counter() - t0, 4)}
        except Exception as exc:
            # trial fault isolation: record the point and keep searching;
            # the exception rides along for an all-failed sweep, its
            # frames cleared so the failed model's memory is freed
            model = None
            traceback.clear_frames(exc.__traceback__)
            return {"params": combo, "metrics": {}, "score": float("-inf"),
                    "fit_time": round(time.perf_counter() - t0, 4),
                    "error": f"{type(exc).__name__}: {exc}", "_exc": exc}

    # ------------------------------------------------------------------
    def fit(self, x=None, y=None, **fit_kwargs) -> "GridSearch":
        combos = self._combinations()
        tx, ty, vx, vy = self._split(x, y)
        results = []
        for combo in combos:
            results.append(self._run_trial(combo, tx, ty, vx, vy,
                                           fit_kwargs))
            # a model and its engine hold each other: collect the trial's
            # model now, so its card memory is free for the next trial
            gc.collect()
        self.fusion_info_ = {"fusedTrials": 0, "cohorts": 0,
                             "fallbackTrials": 0, "earlyStopped": 0}
        failed = [r for r in results if "error" in r]
        ok = [r for r in results if "error" not in r]
        if not ok:
            raise failed[0]["_exc"]
        for r in failed:
            r.pop("_exc", None)
        self.cv_results_ = {
            "params": [r["params"] for r in results],
            "mean_test_score": [r["score"] for r in results],
            "mean_fit_time": [r["fit_time"] for r in results],
            "metrics": [r["metrics"] for r in results],
        }
        if failed:
            self.cv_results_["error"] = [r.get("error") for r in results]
        best = max(ok, key=lambda r: r["score"])
        self.best_params_ = best["params"]
        self.best_score_ = best["score"]
        if self.refit:
            self.best_estimator_ = None  # frees the last refit first
            model = _clone(self.estimator)
            refit_kwargs = dict(fit_kwargs)
            refit_kwargs.update(_apply_overrides(model,
                                                 dict(best["params"])))
            if y is None:
                model.fit(x, **refit_kwargs)
            else:
                model.fit(x, y, **refit_kwargs)
            self.best_estimator_ = model
        return self

    # keras-ish conveniences, so tune results flow through the
    # evaluate/predict routes
    def evaluate(self, x=None, y=None, **kwargs) -> Dict[str, float]:
        self._require_fitted()
        return self.best_estimator_.evaluate(x, y, **kwargs)

    def predict(self, x=None, **kwargs):
        self._require_fitted()
        return self.best_estimator_.predict(x, **kwargs)

    def _require_fitted(self) -> None:
        if self.best_estimator_ is None:
            raise RuntimeError(
                "sweep has no refit model — call fit() first "
                "(with refit=True)")

    def summary(self) -> Dict[str, Any]:
        return {"best_params": self.best_params_,
                "best_score": self.best_score_,
                "n_trials": len(self.cv_results_.get("params", []))}

    # ------------------------------------------------------------------
    # artifact-store native protocol (catalog/artifacts.py)
    # ------------------------------------------------------------------
    def __lo_save__(self, path: str) -> None:
        est_dir = os.path.join(path, "estimator")
        os.makedirs(est_dir, exist_ok=True)
        self.estimator.__lo_save__(est_dir)
        best_dir = None
        if self.best_estimator_ is not None:
            best_dir = os.path.join(path, "best_estimator")
            os.makedirs(best_dir, exist_ok=True)
            self.best_estimator_.__lo_save__(best_dir)
        config = {
            "name": self.name,
            "estimator_class": type(self.estimator).__name__,
            "param_grid": self.param_grid,
            "n_iter": self.n_iter,
            "scoring": self.scoring,
            "validation_split": self.validation_split,
            "max_parallel": self.max_parallel,
            "refit": self.refit,
            "seed": self.seed,
            "cv_results": self.cv_results_,
            "best_params": self.best_params_,
            "best_score": self.best_score_,
            "has_best": best_dir is not None,
        }
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)

    @classmethod
    def __lo_load__(cls, path: str, device="cuda") -> "GridSearch":
        from learningorchestra_tpu_torch import models as models_pkg

        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
        est_cls = getattr(models_pkg, config["estimator_class"])
        estimator = est_cls.__lo_load__(os.path.join(path, "estimator"),
                                        device=device)
        sweep = cls(estimator, config["param_grid"],
                    n_iter=config["n_iter"], scoring=config["scoring"],
                    validation_split=config["validation_split"],
                    max_parallel=config["max_parallel"],
                    refit=config["refit"], seed=config["seed"],
                    name=config["name"], device=device)
        sweep.cv_results_ = config["cv_results"]
        sweep.best_params_ = config["best_params"]
        sweep.best_score_ = config["best_score"]
        if config["has_best"]:
            sweep.best_estimator_ = est_cls.__lo_load__(
                os.path.join(path, "best_estimator"), device=device)
        return sweep


class RandomSearch(GridSearch):
    """GridSearch with sampled combinations (``n_iter`` required)."""

    def __init__(self, estimator, param_grid: Dict[str, Sequence[Any]],
                 n_iter: int = 8, device="cuda", **kwargs):
        # device is named here, so the services see it and supply theirs
        super().__init__(estimator, param_grid, n_iter=n_iter,
                         device=device, **kwargs)
