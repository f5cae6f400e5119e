"""One epoch of log-loss SGD for one binary problem through the port's
C++ core (``csrc/sgd_core.cpp``, the ``sgd_core`` library of
:mod:`learningorchestra_tpu_torch.native`), with its plain Python
version beside it. :class:`~learningorchestra_tpu_torch.models.linear.
SGDClassifier` runs one call per class and ``partial_fit``.

Both are scikit-learn 1.9's ``_plain_sgd64`` loop at the
``SGDClassifier(loss="log_loss")`` settings (the core's header lists
them), operation for operation, so they compute the same weights bit for
bit; :func:`partial_fit_binary` counts its calls and rows by path
(``native`` or ``python``) in :func:`native.counts`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np

from learningorchestra_tpu_torch import native


def core() -> Optional[ctypes.CDLL]:
    """The loaded ``sgd_core``, or None (``LO_NATIVE=0``, no ``g++``)."""
    return native.get_lib(native.SGD)


def partial_fit_binary(x: np.ndarray, y: np.ndarray, order: np.ndarray,
                       w: np.ndarray, intercept: float, alpha: float,
                       t: float) -> float:
    """One epoch over the float64 rows ``x`` in ``order``, targets ``y``
    in {0, 1}: updates ``w`` (float64, contiguous) in place from step
    ``t`` and returns the new intercept. Raises ``ValueError`` where a
    weight overflows, as sklearn does."""
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    order = np.ascontiguousarray(order, np.int64)
    n, f = x.shape
    if y.shape != (n,) or order.shape != (n,) or (
            n and (order.min() < 0 or order.max() >= n)):
        raise ValueError(f"{n} rows, {y.shape} targets, an order of "
                         f"{order.shape}")
    if w.dtype != np.float64 or w.shape != (f,) or \
            not w.flags.c_contiguous:
        raise ValueError(f"weights {w.dtype} {w.shape}: need contiguous "
                         f"float64 of {f}")
    lib = core()
    if lib is None:
        native.count("sgd_partial_fit", "python", n)
        intercept, finite = _py_partial_fit_binary(x, y, order, w,
                                                   intercept, alpha, t)
    else:
        b = ctypes.c_double(intercept)
        status = lib.lo_sgd_partial_fit(
            x.ctypes.data, y.ctypes.data, order.ctypes.data, n, f,
            w.ctypes.data, ctypes.addressof(b), alpha, t)
        native.count("sgd_partial_fit", "native", n)
        intercept, finite = b.value, status == 0
    if not finite:
        raise ValueError("Floating-point under-/overflow occurred at epoch "
                         "#1. Scaling input data with StandardScaler or "
                         "MinMaxScaler might help.")
    return intercept


def _half_binomial_gradient(y: float, raw: float) -> float:
    if raw > -37.0:
        e = math.exp(-raw)
        return ((1.0 - y) - y * e) / (1.0 + e)
    return math.exp(raw) - y


def _py_partial_fit_binary(x, y, order, w, intercept, alpha, t):
    """The core's loop in Python floats (IEEE doubles, libm's exp)."""
    typw = math.sqrt(1.0 / math.sqrt(alpha))
    initial_eta0 = typw / max(1.0, _half_binomial_gradient(1.0, -typw))
    optimal_init = 1.0 / (initial_eta0 * alpha)
    weights = w.tolist()
    rows = x.tolist()
    targets = y.tolist()
    f = len(weights)
    wscale = 1.0
    for i in order.tolist():
        row = rows[i]
        inner = 0.0
        for j in range(f):
            inner += weights[j] * row[j]
        inner *= wscale
        p = inner + intercept
        eta = 1.0 / (alpha * (optimal_init + t - 1.0))
        dloss = min(max(_half_binomial_gradient(targets[i], p), -1e12),
                    1e12)
        update = -eta * dloss
        shrink = 1.0 - eta * alpha
        wscale *= shrink if shrink > 0.0 else 0.0
        if wscale < 1e-9:
            weights = [v * wscale for v in weights]
            wscale = 1.0
        if update != 0.0:
            step = update / wscale
            for j in range(f):
                weights[j] += row[j] * step
            intercept += update
        t += 1.0
    w[:] = [v * wscale for v in weights]
    finite = math.isfinite(intercept) and bool(np.isfinite(w).all())
    return intercept, finite
