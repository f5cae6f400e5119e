"""Hyperparameter sweeps of the port: :class:`GridSearch` and
:class:`RandomSearch` (:mod:`learningorchestra_tpu.models.sweep`), with
the GridSearchCV-shaped surface the tune route exists for (``fit``,
``best_params_``, ``best_score_``, ``cv_results_``, ``best_estimator_``).

Sweep fusion (``LO_SWEEP_FUSION``, on by default, as in the JAX
package): before any trial runs, :meth:`GridSearch._plan_cohorts`
partitions the points into cohorts that share everything that shapes the
program (architecture, optimizer kind, ``batch_size``, ``epochs``, model
attributes) and differ only in the optimizer scalars the estimator
declares fusable (``NeuralModel``'s ``_FUSABLE_BY_KIND``). Each cohort of
two or more points trains as one stacked program
(``NeuralModel.fit_sweep_fused``) under a ``fusedCohort`` span, its wall
clock shared evenly among its points' ``fit_time``; ``grad_accum``
reaches the fused fit. A cohort whose fused run fails for any reason (the
data above ``LO_SCAN_FIT_MAX_BYTES``, an unfusable spec, a fit keyword
the fused path does not take: ``sample_weight``, ``class_weight``,
``validation_split``, ``checkpointer``, ``health_policy``) runs as
independent trials, counted as ``fallbackTrials``;
``LO_SWEEP_EARLYSTOP_MARGIN`` (with ``_MIN_EPOCHS`` and ``_ALPHA``)
freezes a config that trails the cohort's best.
``fusion_info_`` counts the sweep's ``fusedTrials``, ``cohorts``,
``fallbackTrials`` and ``earlyStopped``; :func:`fusion_stats` the
process's, with ``trialErrors`` and ``fusedEpochTraces``.

Every other point runs as its own trial, one after another on the
calling thread, as the JAX package runs them when one trial fits at a
time: a clone of the estimator through its artifact protocol
(``__lo_save__``/``__lo_load__`` on the estimator's device, weights
dropped), the point's overrides routed to the optimizer spec, the fit's
keywords or the model's attributes, a fit on the head of the data and an
``evaluate`` on the tail ``validation_split``. A failed point is recorded
with its ``error`` and a score of -inf (its traceback's frames are
cleared, so a failed trial's model does not hold card memory); a sweep
whose every point failed raises the first cause. Each trial's (and each
cohort's) model is collected before the next starts. The best point is
refitted on all the data into ``best_estimator_``. The ``sweep_trial``
fault site (:mod:`..services.faults`) fires at the start of each trial.
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
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from learningorchestra_tpu_torch.config import Config, resolve_device
from learningorchestra_tpu_torch.observability import trace as obs_trace
from learningorchestra_tpu_torch.runtime import locks, preempt
from learningorchestra_tpu_torch.runtime.data import dataframe_to_arrays
from learningorchestra_tpu_torch.services import faults

# hyperparameter names routed into the optimizer spec
_OPTIMIZER_KEYS = {"kind", "learning_rate", "lr", "momentum",
                   "weight_decay", "beta_1", "beta_2", "rho", "nesterov"}
# names routed into fit() kwargs
_FIT_KEYS = {"batch_size", "epochs"}
# fit() keywords that change a trial's training and that the fused path
# does not take: a cohort given one runs as trials
_TRIAL_ONLY_KWARGS = ("sample_weight", "class_weight", "validation_split",
                      "checkpointer", "health_policy")

# process-wide fusion counters, the /metrics sweepFusion block and the
# lo_sweep_* series (services/server.py)
_FUSION_LOCK = locks.make_lock("sweep.fusion")
_FUSION_STATS = {"fusedTrials": 0, "cohorts": 0, "fallbackTrials": 0,
                 "earlyStopped": 0, "trialErrors": 0}


def _fusion_count(**deltas: int) -> None:
    with _FUSION_LOCK:
        for k, v in deltas.items():
            _FUSION_STATS[k] = _FUSION_STATS.get(k, 0) + v


def fusion_stats() -> Dict[str, int]:
    with _FUSION_LOCK:
        out = dict(_FUSION_STATS)
    from learningorchestra_tpu_torch.runtime import engine as engine_lib

    out["fusedEpochTraces"] = engine_lib.fused_epoch_traces()
    return out


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
    package's signature; on one card trials run one at a time, after
    the fused cohorts.
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
        except preempt.JobCancelled:
            raise
        except Exception as exc:
            # trial fault isolation: record the point and keep searching;
            # the exception rides along for an all-failed sweep, its
            # frames cleared so the failed model's memory is freed
            model = None
            traceback.clear_frames(exc.__traceback__)
            _fusion_count(trialErrors=1)
            return {"params": combo, "metrics": {}, "score": float("-inf"),
                    "fit_time": round(time.perf_counter() - t0, 4),
                    "error": f"{type(exc).__name__}: {exc}", "_exc": exc}

    # ------------------------------------------------------------------
    # the fusion planner
    # ------------------------------------------------------------------
    def _plan_cohorts(self, combos: List[Dict[str, Any]]
                      ) -> Tuple[List[Dict[str, Any]], List[int]]:
        """``(cohorts, residual indices)``. A cohort's points share every
        program-shaping entry and differ only in the optimizer scalars
        the estimator declares fusable for their kind; groups of one
        stay residual."""
        from learningorchestra_tpu_torch.models import neural as neural_lib

        est = self.estimator
        supports = getattr(est, "supports_sweep_fusion", None)
        if supports is None or not supports():
            return [], list(range(len(combos)))
        spec = getattr(est, "optimizer_spec", None) or {}
        base_kind = str(spec.get("kind", "adam")).lower()
        groups: Dict[Any, List[Tuple[int, Dict[str, float],
                                     Dict[str, Any]]]] = {}
        residual: List[int] = []
        for i, combo in enumerate(combos):
            kind = str(combo.get("optimizer",
                                 combo.get("kind", base_kind))).lower()
            allowed = set(neural_lib._FUSABLE_BY_KIND.get(kind, ()))
            hyper: Dict[str, float] = {}
            shared: Dict[str, Any] = {}
            for k, v in combo.items():
                nk = "learning_rate" if k == "lr" else k
                if nk in allowed and isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    hyper[nk] = float(v)
                else:
                    shared[k] = v
            if not hyper:
                residual.append(i)
                continue
            key = (tuple(sorted((k, repr(v)) for k, v in shared.items())),
                   tuple(sorted(hyper)))
            groups.setdefault(key, []).append((i, hyper, shared))
        cohorts = []
        for members in groups.values():
            if len(members) < 2:
                residual.extend(i for i, _, _ in members)
                continue
            cohorts.append({"indices": [i for i, _, _ in members],
                            "hyper": [h for _, h, _ in members],
                            "shared": dict(members[0][2])})
        residual.sort()
        return cohorts, residual

    def _run_fused_cohort(self, cohort: Dict[str, Any],
                          combos: List[Dict[str, Any]], tx, ty, vx, vy,
                          fit_kwargs: Dict[str, Any]
                          ) -> Tuple[List[Dict[str, Any]], List[Any]]:
        from learningorchestra_tpu_torch.runtime import engine as engine_lib

        trial_only = [k for k in _TRIAL_ONLY_KWARGS if fit_kwargs.get(k)]
        if trial_only:
            raise engine_lib.FusedSweepUnsupported(
                f"fit keywords {trial_only} run as independent trials")
        model = _clone(self.estimator)
        trial_kwargs = dict(fit_kwargs)
        trial_kwargs.update(_apply_overrides(model, dict(cohort["shared"])))
        cfg = Config()
        earlystop = None
        if cfg.sweep_earlystop_margin > 0:
            earlystop = {"margin": cfg.sweep_earlystop_margin,
                         "min_epochs": cfg.sweep_earlystop_min_epochs,
                         "alpha": cfg.sweep_earlystop_alpha}
        t0 = time.perf_counter()
        per_config, stopped = model.fit_sweep_fused(
            tx, ty, cohort["hyper"],
            batch_size=trial_kwargs.get("batch_size"),
            epochs=trial_kwargs.get("epochs", 1),
            validation_data=(vx, vy),
            shuffle=trial_kwargs.get("shuffle", True),
            score_fn=self._score, earlystop=earlystop,
            grad_accum=trial_kwargs.get("grad_accum"))
        # one program trained the whole cohort: its wall clock is shared
        # evenly, so mean_fit_time stays comparable across paths
        dt = (time.perf_counter() - t0) / max(1, len(per_config))
        results = []
        for idx, metrics in zip(cohort["indices"], per_config):
            results.append({"params": combos[idx], "metrics": metrics,
                            "score": self._score(metrics),
                            "fit_time": round(dt, 4)})
        return results, stopped

    def _run_cohorts(self, combos, tx, ty, vx, vy, fit_kwargs,
                     results: List[Optional[Dict[str, Any]]]) -> List[int]:
        """Trains every fusable cohort, filling ``results``; returns the
        indices left for independent trials."""
        cohorts, residual = self._plan_cohorts(combos)
        for cohort in cohorts:
            n = len(cohort["indices"])
            try:
                with obs_trace.span("fusedCohort", points=n,
                                    hyper=sorted(cohort["hyper"][0])):
                    cohort_results, stopped = self._run_fused_cohort(
                        cohort, combos, tx, ty, vx, vy, fit_kwargs)
            except preempt.JobCancelled:
                raise
            except Exception as exc:  # noqa: BLE001
                # any fused failure reverts the cohort to independent
                # trials: fusion is an optimization, never a behaviour
                # change
                traceback.clear_frames(exc.__traceback__)
                residual.extend(cohort["indices"])
                _fusion_count(fallbackTrials=n)
                self.fusion_info_["fallbackTrials"] += n
                continue
            finally:
                # the cohort's stacked state is free before the next
                gc.collect()
            for idx, res in zip(cohort["indices"], cohort_results):
                results[idx] = res
            n_stopped = sum(1 for s in stopped if s is not None)
            self.fusion_info_["fusedTrials"] += n
            self.fusion_info_["cohorts"] += 1
            self.fusion_info_["earlyStopped"] += n_stopped
            _fusion_count(fusedTrials=n, cohorts=1, earlyStopped=n_stopped)
        return sorted(residual)

    # ------------------------------------------------------------------
    def fit(self, x=None, y=None, **fit_kwargs) -> "GridSearch":
        combos = self._combinations()
        tx, ty, vx, vy = self._split(x, y)
        self.fusion_info_ = {"fusedTrials": 0, "cohorts": 0,
                             "fallbackTrials": 0, "earlyStopped": 0}
        results: List[Optional[Dict[str, Any]]] = [None] * len(combos)
        residual = list(range(len(combos)))
        if Config().sweep_fusion:
            residual = self._run_cohorts(combos, tx, ty, vx, vy, fit_kwargs,
                                         results)
        for i in residual:
            results[i] = self._run_trial(combos[i], tx, ty, vx, vy,
                                         fit_kwargs)
            # a model and its engine hold each other: collect the trial's
            # model now, so its card memory is free for the next trial
            gc.collect()
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
