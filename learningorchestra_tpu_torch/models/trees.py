"""The Builder's tree families without scikit-learn: the port's
``DecisionTreeClassifier``, ``RandomForestClassifier`` and
``GradientBoostingClassifier`` (sklearn's class names), each over the
exact best-split tree of :mod:`learningorchestra_tpu_torch.native.trees`
(the port's C++ tree core, its numpy version where no ``g++`` exists).

Each is sklearn 1.9's class at the defaults the JAX package's Builder
builds it with, on the host as the JAX package's trees are:

- Rows are cast to float32 (sklearn's tree dtype) for fit and predict;
  NaN or an infinity is refused.
- ``DecisionTreeClassifier()``: gini, best splitter, no depth limit,
  every feature; predict is the argmax of the leaf's class weights (a tie
  to the lower class).
- ``RandomForestClassifier()``: 100 trees, ``sqrt`` features, bootstrap
  drawn as sample counts; predict is the argmax of the mean
  ``predict_proba`` over the trees.
- ``GradientBoostingClassifier()``: log loss, 100 stages of one squared
  error tree of depth 3 per class (one for two classes) on the residual
  y - p, each leaf one Newton step, learning rate 0.1, the first raw
  score from the class prior.

``random_state`` seeds every draw the way sklearn's does (the splitter's
feature order, the forest's bootstraps), so the port is deterministic,
and a model equals sklearn's at the same ``random_state``; where it is
not given it is 0 (sklearn draws a fresh one). It is the one parameter:
the rest are the JAX package's defaults, as constants.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from learningorchestra_tpu_torch.native import trees as core

_MAX_INT = np.iinfo(np.int32).max
# RandomForestClassifier(): trees; GradientBoostingClassifier(): stages,
# learning rate, tree depth
RF_TREES = 100
GB_STAGES, GB_LEARNING_RATE, GB_MAX_DEPTH = 100, 0.1, 3


def _rows(x) -> np.ndarray:
    with np.errstate(over="ignore"):  # a value past float32 is refused
        x = np.asarray(x, dtype=np.float32)
    if x.ndim != 2 or not x.shape[0]:
        raise ValueError(f"expected a 2-D array of at least one row, got "
                         f"shape {x.shape}")
    if not np.isfinite(x).all():
        raise ValueError("Input X contains NaN, infinity or a value too "
                         "large for dtype('float32').")
    return np.ascontiguousarray(x)


def _labels(y):
    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    return classes, y_idx.astype(np.int32).ravel()


class _Fitted:
    classes_: Optional[np.ndarray] = None

    def _checked_rows(self, x) -> np.ndarray:
        if self.classes_ is None:
            raise RuntimeError(f"{type(self).__name__} is not fitted")
        x = _rows(x)
        if x.shape[1] != self.n_features_in_:
            raise ValueError(f"X has {x.shape[1]} features, but "
                             f"{type(self).__name__} is expecting "
                             f"{self.n_features_in_} features as input.")
        return x


def _tree_proba(tree: core.Tree, x: np.ndarray) -> np.ndarray:
    proba = tree.value[core.apply(tree, x)]
    normalizer = proba.sum(axis=1)[:, None]
    normalizer[normalizer == 0.0] = 1.0
    return proba / normalizer


class DecisionTreeClassifier(_Fitted):
    def __init__(self, random_state: int = 0):
        self.random_state = random_state
        self.tree_: Optional[core.Tree] = None

    def fit(self, x, y) -> "DecisionTreeClassifier":
        x = _rows(x)
        self.classes_, y_idx = _labels(y)
        self.n_features_in_ = x.shape[1]
        self.tree_ = core.fit_tree(x, y_idx, n_classes=len(self.classes_),
                                   seed=core.rand_r_state(self.random_state))
        return self

    def predict_proba(self, x) -> np.ndarray:
        return _tree_proba(self.tree_, self._checked_rows(x))

    def predict(self, x) -> np.ndarray:
        x = self._checked_rows(x)
        value = self.tree_.value[core.apply(self.tree_, x)]
        return self.classes_[np.argmax(value, axis=1)]


class RandomForestClassifier(_Fitted):
    """The trees are fitted one after the other (the streaming Builder
    asks sklearn for ``n_jobs=1``)."""

    def __init__(self, random_state: int = 0):
        self.random_state = random_state
        self.estimators_: List[core.Tree] = []

    def fit(self, x, y) -> "RandomForestClassifier":
        x = _rows(x)
        self.classes_, y_idx = _labels(y)
        n, f = x.shape
        self.n_features_in_ = f
        max_features = max(1, int(np.sqrt(f)))
        states = np.random.RandomState(self.random_state)
        self.estimators_ = []
        for _ in range(RF_TREES):
            seed = states.randint(_MAX_INT)
            # sklearn's bootstrap: n draws with replacement, as counts
            drawn = np.random.RandomState(seed).randint(0, n, n)
            counts = np.bincount(drawn, minlength=n).astype(np.float64)
            self.estimators_.append(core.fit_tree(
                x, y_idx, n_classes=len(self.classes_),
                sample_weight=counts, max_features=max_features,
                seed=core.rand_r_state(seed)))
        return self

    def predict_proba(self, x) -> np.ndarray:
        x = self._checked_rows(x)
        proba = np.zeros((len(x), len(self.classes_)))
        for tree in self.estimators_:
            proba += _tree_proba(tree, x)
        proba /= len(self.estimators_)
        return proba

    def predict(self, x) -> np.ndarray:
        return self.classes_[np.argmax(self.predict_proba(x), axis=1)]


def _safe_divide(numerator: float, denominator: float) -> float:
    if abs(denominator) < 1e-150:
        return 0.0
    return float(numerator) / float(denominator)


class GradientBoostingClassifier(_Fitted):
    def __init__(self, random_state: int = 0):
        self.random_state = random_state
        # stages x trees per stage: (tree, leaf values over its nodes)
        self.estimators_: List[List[tuple]] = []

    def _init_raw(self, n: int) -> np.ndarray:
        return np.tile(self.init_raw_, (n, 1))

    def fit(self, x, y) -> "GradientBoostingClassifier":
        from scipy.special import logit
        from scipy.stats import gmean

        x = _rows(x)
        self.classes_, y_idx = _labels(y)
        n, self.n_features_in_ = x.shape
        k = len(self.classes_)
        if k < 2:
            raise ValueError("y contains 1 class; need at least 2")
        eps = np.finfo(np.float64).eps
        prior = np.clip(np.bincount(y_idx, minlength=k) / n, eps, 1 - eps)
        if k == 2:
            self.init_raw_ = np.array([logit(prior[1])])
        else:
            self.init_raw_ = np.log(prior / gmean(prior))
        raw = self._init_raw(n)
        trees_per_stage = raw.shape[1]
        sw = np.ones(n)
        states = np.random.RandomState(self.random_state)
        self.estimators_ = []
        for _ in range(GB_STAGES):
            neg_g = core.gb_residuals(raw, y_idx)
            stage = []
            for j in range(trees_per_stage):
                tree = core.fit_tree(
                    x, neg_g[:, j], n_classes=0, max_depth=GB_MAX_DEPTH,
                    seed=states.randint(0, core.RAND_R_MAX))
                target = (y_idx == j if k > 2 else y_idx).astype(np.float64)
                leaf = core.apply(tree, x)
                values = tree.value[:, 0].copy()
                # one Newton step a leaf over its rows, in row order
                order = np.argsort(leaf, kind="stable")
                bounds = np.flatnonzero(np.diff(leaf[order])) + 1
                for rows in np.split(order, bounds):
                    g = neg_g[rows, j]
                    prob = target[rows] - g
                    numerator = np.average(g, weights=sw[rows])
                    if k > 2:
                        numerator *= (k - 1) / k
                    values[leaf[rows[0]]] = _safe_divide(
                        numerator, np.average(prob * (1 - prob),
                                              weights=sw[rows]))
                raw[:, j] += GB_LEARNING_RATE * values.take(leaf)
                stage.append((tree, values))
            self.estimators_.append(stage)
        return self

    def decision_function(self, x) -> np.ndarray:
        x = self._checked_rows(x)
        raw = self._init_raw(len(x))
        for stage in self.estimators_:
            for j, (tree, values) in enumerate(stage):
                raw[:, j] += GB_LEARNING_RATE * values.take(
                    core.apply(tree, x))
        return raw.ravel() if raw.shape[1] == 1 else raw

    def predict(self, x) -> np.ndarray:
        raw = self.decision_function(x)
        if raw.ndim == 1:
            return self.classes_[(raw >= 0).astype(int)]
        return self.classes_[np.argmax(raw, axis=1)]
