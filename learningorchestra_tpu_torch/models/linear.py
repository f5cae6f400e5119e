"""The Builder's linear families on the host without scikit-learn: the
port's ``LogisticRegression``, ``GaussianNB`` and ``SGDClassifier``
(sklearn's class names), each sklearn 1.9's class at the settings the JAX
package's Builder builds it with, written for numpy and scipy:

- ``LogisticRegression(max_iter=1000)``: L2 with C = 1 and an
  unpenalized intercept, one coefficient row for two classes and the
  multinomial softmax above, sklearn's mean loss and gradient minimized
  by ``scipy.optimize.minimize(method="L-BFGS-B")`` with sklearn's
  options (``gtol`` = tol = 1e-4, 1000 iterations, ``maxls`` 50).
- ``GaussianNB()``: sklearn's own numpy code: float64 ``theta_`` and
  ``var_``, epsilon = 1e-9 x the largest feature variance of the last
  batch, priors from the counts, and ``partial_fit``'s incremental mean
  and variance.
- ``SGDClassifier(loss="log_loss")`` through ``partial_fit``: alpha
  1e-4, L2, the "optimal" learning rate, one-vs-rest above two classes,
  ``t_`` carried across calls; each epoch runs in the port's C++ core
  (:mod:`learningorchestra_tpu_torch.native.sgd`). Each call visits its
  rows in an order drawn from ``numpy.random.default_rng(random_state)``
  (sklearn shuffles with its own generator), the same order for every
  class; rows are float64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from learningorchestra_tpu_torch.native import sgd as sgd_core

# LogisticRegression(max_iter=1000): L2 strength C, iterations and
# tolerance; GaussianNB(): variance smoothing; SGDClassifier(): alpha
LR_C, LR_MAX_ITER, LR_TOL = 1.0, 1000, 1e-4
NB_VAR_SMOOTHING = 1e-9
SGD_ALPHA = 1e-4


def _rows(x) -> np.ndarray:
    """Rows as given where they are floats (sklearn keeps float32), else
    float64."""
    x = np.asarray(x)
    if x.dtype.kind != "f":
        x = x.astype(np.float64)
    if x.ndim != 2 or not x.shape[0]:
        raise ValueError(f"expected a 2-D array of at least one row, got "
                         f"shape {x.shape}")
    if not np.isfinite(x).all():
        raise ValueError("Input X contains NaN or infinity.")
    return x


def _checked(x, fitted, n_features: int) -> np.ndarray:
    if not fitted:
        raise RuntimeError("the estimator is not fitted")
    x = _rows(x)
    if x.shape[1] != n_features:
        raise ValueError(f"X has {x.shape[1]} features, but the estimator "
                         f"is expecting {n_features} features as input.")
    return x


class _Linear:
    classes_: Optional[np.ndarray] = None
    coef_: Optional[np.ndarray] = None
    intercept_: Optional[np.ndarray] = None

    def decision_function(self, x) -> np.ndarray:
        x = _checked(x, self.coef_ is not None,
                     0 if self.coef_ is None else self.coef_.shape[1])
        scores = x @ self.coef_.T + self.intercept_
        return scores.ravel() if scores.shape[1] == 1 else scores

    def predict(self, x) -> np.ndarray:
        scores = self.decision_function(x)
        if scores.ndim == 1:
            return self.classes_[(scores > 0).astype(int)]
        return self.classes_[np.argmax(scores, axis=1)]


def _log1pexp(raw: np.ndarray) -> np.ndarray:
    """log(1 + exp(raw)), sklearn's piecewise form."""
    out = np.empty_like(raw)
    a = raw <= -37
    b = (raw > -37) & (raw <= -2)
    c = (raw > -2) & (raw <= 18)
    d = (raw > 18) & (raw <= 33.3)
    e = raw > 33.3
    out[a] = np.exp(raw[a])
    out[b] = np.log1p(np.exp(raw[b]))
    out[c] = np.log(1.0 + np.exp(raw[c]))
    out[d] = raw[d] + np.exp(-raw[d])
    out[e] = raw[e]
    return out


def _binomial_gradient(y: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """expit(raw) - y, sklearn's stable form."""
    out = np.empty_like(raw)
    hi = raw > -37
    e = np.exp(-raw[hi])
    out[hi] = ((1 - y[hi]) - y[hi] * e) / (1 + e)
    out[~hi] = np.exp(raw[~hi]) - y[~hi]
    return out


class LogisticRegression(_Linear):
    def fit(self, x, y) -> "LogisticRegression":
        from scipy import optimize

        x = _rows(x).astype(np.float64, copy=False)
        self.classes_, y_idx = np.unique(np.asarray(y), return_inverse=True)
        y_idx = y_idx.ravel()
        n, f = x.shape
        k = len(self.classes_)
        if k < 2:
            raise ValueError("This solver needs samples of at least 2 "
                             "classes in the data")
        l2 = 1.0 / (LR_C * n)
        if k == 2:
            target = (y_idx == 1).astype(np.float64)

            def loss_grad(w):
                coef, b = w[:f], w[f]
                raw = x @ coef + b
                loss = (_log1pexp(raw) - target * raw).sum() / n
                loss += 0.5 * l2 * (coef @ coef)
                g = _binomial_gradient(target, raw) / n
                grad = np.empty_like(w)
                grad[:f] = x.T @ g + l2 * coef
                grad[f] = g.sum()
                return loss, grad

            w0 = np.zeros(f + 1)
        else:
            onehot = np.zeros((n, k))
            onehot[np.arange(n), y_idx] = 1.0

            def loss_grad(w):
                w = w.reshape((k, f + 1), order="F")
                coef, b = w[:, :f], w[:, f]
                raw = x @ coef.T + b
                top = raw.max(axis=1, keepdims=True)
                e = np.exp(raw - top)
                total = e.sum(axis=1, keepdims=True)
                loss = (np.log(total[:, 0]) + top[:, 0] -
                        raw[np.arange(n), y_idx]).sum() / n
                loss += 0.5 * l2 * (coef * coef).sum()
                g = (e / total - onehot) / n
                grad = np.empty((k, f + 1))
                grad[:, :f] = g.T @ x + l2 * coef
                grad[:, f] = g.sum(axis=0)
                return loss, grad.ravel(order="F")

            w0 = np.zeros((k, f + 1)).ravel(order="F")
        result = optimize.minimize(
            loss_grad, w0, method="L-BFGS-B", jac=True,
            options={"maxiter": LR_MAX_ITER, "maxls": 50,
                     "gtol": LR_TOL, "ftol": 64 * np.finfo(float).eps})
        w = result.x
        if k == 2:
            self.coef_, self.intercept_ = w[None, :f], w[f:]
        else:
            w = w.reshape((k, f + 1), order="F")
            self.coef_, self.intercept_ = w[:, :f].copy(), w[:, f].copy()
        return self


class GaussianNB:
    def __init__(self):
        self.classes_: Optional[np.ndarray] = None

    def fit(self, x, y) -> "GaussianNB":
        self.classes_ = None
        return self.partial_fit(x, y, np.unique(np.asarray(y)))

    @staticmethod
    def _update_mean_variance(n_past, mu, var, x):
        if x.shape[0] == 0:
            return mu, var
        n_new = x.shape[0]
        new_var = np.var(x, axis=0)
        new_mu = np.mean(x, axis=0)
        if n_past == 0:
            return new_mu, new_var
        n_total = float(n_past + n_new)
        total_mu = (n_new * new_mu + n_past * mu) / n_total
        old_ssd = n_past * var
        new_ssd = n_new * new_var
        total_ssd = (old_ssd + new_ssd +
                     (n_new * n_past / n_total) * (mu - new_mu) ** 2)
        return total_mu, total_ssd / n_total

    def partial_fit(self, x, y, classes=None) -> "GaussianNB":
        x = _rows(x)
        y = np.asarray(y)
        first = self.classes_ is None
        if first:
            if classes is None:
                raise ValueError("classes must be passed on the first call "
                                 "to partial_fit.")
            self.classes_ = np.unique(np.asarray(classes))
        self.epsilon_ = NB_VAR_SMOOTHING * np.var(x, axis=0).max()
        if first:
            k, f = len(self.classes_), x.shape[1]
            self.theta_ = np.zeros((k, f))
            self.var_ = np.zeros((k, f))
            self.class_count_ = np.zeros(k, dtype=np.float64)
            self.class_prior_ = np.zeros(k, dtype=np.float64)
        else:
            if x.shape[1] != self.theta_.shape[1]:
                raise ValueError(
                    f"Number of features {x.shape[1]} does not match "
                    f"previous data {self.theta_.shape[1]}.")
            self.var_[:, :] -= self.epsilon_
        unique_y = np.unique(y)
        missing = ~np.isin(unique_y, self.classes_)
        if missing.any():
            raise ValueError(f"The target label(s) {unique_y[missing]} in y "
                             f"do not exist in the initial classes "
                             f"{self.classes_}")
        for y_i in unique_y:
            i = self.classes_.searchsorted(y_i)
            x_i = x[y == y_i, :]
            self.theta_[i, :], self.var_[i, :] = self._update_mean_variance(
                self.class_count_[i], self.theta_[i, :], self.var_[i, :],
                x_i)
            self.class_count_[i] += x_i.shape[0]
        self.var_[:, :] += self.epsilon_
        self.class_prior_ = self.class_count_ / self.class_count_.sum()
        return self

    def _joint_log_likelihood(self, x) -> np.ndarray:
        jll = []
        for i in range(np.size(self.classes_)):
            jointi = np.log(self.class_prior_[i])
            n_ij = -0.5 * np.sum(np.log(2.0 * np.pi * self.var_[i, :]))
            n_ij -= 0.5 * np.sum(((x - self.theta_[i, :]) ** 2) /
                                 (self.var_[i, :]), 1)
            jll.append(jointi + n_ij)
        return np.array(jll).T

    def predict(self, x) -> np.ndarray:
        x = _checked(x, self.classes_ is not None,
                     0 if self.classes_ is None else self.theta_.shape[1])
        jll = self._joint_log_likelihood(x)
        return self.classes_[np.argmax(jll, axis=1)]


class SGDClassifier(_Linear):
    """sklearn's ``SGDClassifier(loss="log_loss")``."""

    def __init__(self, random_state: int = 0):
        self.random_state = random_state
        self._rng = np.random.default_rng(random_state)

    def partial_fit(self, x, y, classes=None) -> "SGDClassifier":
        x = np.ascontiguousarray(_rows(x), np.float64)
        y = np.asarray(y)
        if self.classes_ is None:
            if classes is None:
                raise ValueError("classes must be passed on the first call "
                                 "to partial_fit.")
            self.classes_ = np.unique(np.asarray(classes))
            if len(self.classes_) < 2:
                raise ValueError("The number of classes has to be greater "
                                 "than one; got 1 class")
            rows = 1 if len(self.classes_) == 2 else len(self.classes_)
            self.coef_ = np.zeros((rows, x.shape[1]))
            self.intercept_ = np.zeros(rows)
            self.t_ = 1.0
        elif x.shape[1] != self.coef_.shape[1]:
            raise ValueError(f"Number of features {x.shape[1]} does not "
                             f"match previous data {self.coef_.shape[1]}.")
        missing = ~np.isin(np.unique(y), self.classes_)
        if missing.any():
            raise ValueError(f"y holds labels {np.unique(y)[missing]} not "
                             f"in classes {self.classes_}")
        order = self._rng.permutation(len(x))
        positives = self.classes_[1:] if len(self.classes_) == 2 \
            else self.classes_
        for i, positive in enumerate(positives):
            w = np.ascontiguousarray(self.coef_[i])
            self.intercept_[i] = sgd_core.partial_fit_binary(
                x, (y == positive).astype(np.float64), order, w,
                float(self.intercept_[i]), SGD_ALPHA, self.t_)
            self.coef_[i] = w
        self.t_ += len(x)
        return self
