"""The port's host linear families (``learningorchestra_tpu_torch/models/
linear.py``; SGD's epoch in the C++ core ``csrc/sgd_core.cpp`` and its
Python version in ``native/sgd.py``) held to scikit-learn's, which the
JAX package's Builder fits.

- SGD's core equals its Python version: the same weights and intercept
  bit for bit, binary and one-vs-rest over 3 classes.
- ``SGDClassifier(loss="log_loss")``: fed the same batches in the order
  the port draws, sklearn's ``SGDClassifier(loss="log_loss",
  shuffle=False)`` reaches coefficients within 1e-12 (relative to the
  largest) and ``t_`` equal; predictions >= 99% equal (all are, here).
- ``LogisticRegression(max_iter=1000)``: coefficients and intercept
  within 1e-6 of sklearn's (relative to the largest |coefficient|) on
  float64 rows where sklearn converges; predictions >= 99.9% equal.
- ``GaussianNB``: ``fit`` and a sequence of ``partial_fit`` calls give
  ``theta_``, ``var_`` and ``class_prior_`` within 1e-10 relative of
  sklearn's, and equal predictions.
"""

import os
import shutil

import numpy as np
import pytest
from sklearn import linear_model, naive_bayes

from learningorchestra_tpu_torch import native
from learningorchestra_tpu_torch.models import linear
from learningorchestra_tpu_torch.native import sgd

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="g++ is absent: the C++ SGD core cannot be built here")

SGD_COEF_TOL, SGD_AGREE = 1e-12, 0.99
LR_COEF_TOL, LR_AGREE = 1e-6, 0.999
NB_TOL = 1e-10
SCALE = np.array([1.0, 3.0, 0.5, 2.0])
SHIFT = np.array([0.0, 1.0, -1.0, 5.0])


def _data(n, k, seed):
    """Rows of four features at different scales and offsets, ``k``
    classes from a noisy linear score."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)) * SCALE + SHIFT
    w = np.random.default_rng(99).normal(size=(4, k))
    y = np.argmax(x @ w + rng.normal(size=(n, k)), axis=1)
    return x, y


@pytest.mark.parametrize("k", [2, 3])
def test_sgd_core_equals_its_python_version(k, monkeypatch):
    x, y = _data(1500, k, seed=1)
    monkeypatch.delenv("LO_NATIVE", raising=False)
    assert sgd.core() is not None, native.build_error(native.SGD)
    order = np.random.default_rng(2).permutation(len(x))
    results = []
    for path in ("native", "python"):
        if path == "python":
            monkeypatch.setenv("LO_NATIVE", "0")
        native.reset_counts()
        w = np.zeros((k if k > 2 else 1, 4))
        b = np.zeros(len(w))
        for t in (1.0, 1501.0):  # two epochs, t_ carried
            for i in range(len(w)):
                row = np.zeros(4)
                row[:] = w[i]
                b[i] = sgd.partial_fit_binary(
                    x, (y == (i if k > 2 else 1)).astype(float), order,
                    row, b[i], 1e-4, t)
                w[i] = row
        assert native.counts()["sgd_partial_fit"] == {
            path: {"calls": 2 * len(w), "rows": 2 * len(w) * len(x)}}
        results.append((w, b))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_array_equal(results[0][1], results[1][1])


@pytest.mark.parametrize("k", [2, 3])
def test_sgd_matches_sklearns_fed_the_same_batches(k):
    x, y = _data(4000, k, seed=3)
    x_test, _ = _data(2000, k, seed=4)
    port = linear.SGDClassifier()
    ref = linear_model.SGDClassifier(loss="log_loss", shuffle=False)
    draws = np.random.default_rng(port.random_state)
    classes = np.arange(k)
    for start in range(0, len(x), 700):
        xb, yb = x[start:start + 700], y[start:start + 700]
        order = draws.permutation(len(xb))
        port.partial_fit(xb, yb, classes=classes)
        ref.partial_fit(xb[order], yb[order], classes=classes)
    assert port.t_ == ref.t_ == len(x) + 1
    scale = np.abs(ref.coef_).max()
    assert np.abs(port.coef_ - ref.coef_).max() <= SGD_COEF_TOL * scale
    assert np.abs(port.intercept_ - ref.intercept_).max() <= \
        SGD_COEF_TOL * scale
    agree = np.mean(port.predict(x_test) == ref.predict(x_test))
    assert agree >= SGD_AGREE
    x_check, y_check = _data(2000, k, seed=5)
    assert np.mean(port.predict(x_check) == y_check) > 0.6


def test_sgd_refuses_what_sklearns_refuses():
    x, y = _data(50, 2, seed=6)
    with pytest.raises(ValueError, match="classes must be passed"):
        linear.SGDClassifier().partial_fit(x, y)
    clf = linear.SGDClassifier().partial_fit(x, y, classes=[0, 1])
    with pytest.raises(ValueError, match="Number of features"):
        clf.partial_fit(x[:, :3], y)
    with pytest.raises(ValueError, match="not in classes"):
        clf.partial_fit(x, y + 5)
    with pytest.raises(ValueError, match="3 features, but"):
        clf.predict(x[:, :3])
    with pytest.raises(ValueError, match="at least one row"):
        linear.LogisticRegression().fit(np.zeros((0, 4)), [])


@pytest.mark.parametrize("k", [2, 3])
def test_lr_matches_sklearns(k):
    x, y = _data(3000, k, seed=7)
    x_test, _ = _data(2000, k, seed=8)
    port = linear.LogisticRegression().fit(x, y)
    ref = linear_model.LogisticRegression(max_iter=1000).fit(x, y)
    assert ref.n_iter_[0] < 1000  # sklearn converged
    assert port.coef_.shape == ref.coef_.shape
    scale = np.abs(ref.coef_).max()
    assert np.abs(port.coef_ - ref.coef_).max() <= LR_COEF_TOL * scale
    assert np.abs(port.intercept_ - ref.intercept_).max() <= \
        LR_COEF_TOL * scale
    agree = np.mean(port.predict(x_test) == ref.predict(x_test))
    assert agree >= LR_AGREE
    labels = np.array(["no", "yes", "maybe"])[y]
    named = linear.LogisticRegression().fit(x, labels)
    np.testing.assert_array_equal(named.predict(x_test),
                                  np.array(["no", "yes", "maybe"])[
                                      port.predict(x_test)])


def _assert_nb_close(port, ref):
    for name in ("theta_", "var_", "class_prior_"):
        got, want = getattr(port, name), getattr(ref, name)
        np.testing.assert_allclose(got, want, rtol=NB_TOL, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("k", [2, 3])
def test_nb_fit_and_partial_fit_match_sklearns(k):
    x, y = _data(3000, k, seed=9)
    x_test, _ = _data(2000, k, seed=10)
    port = linear.GaussianNB().fit(x, y)
    ref = naive_bayes.GaussianNB().fit(x, y)
    _assert_nb_close(port, ref)
    np.testing.assert_array_equal(port.predict(x_test), ref.predict(x_test))
    port, ref = linear.GaussianNB(), naive_bayes.GaussianNB()
    for start in range(0, len(x), 450):
        batch = (x[start:start + 450], y[start:start + 450])
        port.partial_fit(*batch, classes=np.arange(k))
        ref.partial_fit(*batch, classes=np.arange(k))
        _assert_nb_close(port, ref)
    np.testing.assert_array_equal(port.predict(x_test), ref.predict(x_test))
    with pytest.raises(ValueError, match="do not exist"):
        port.partial_fit(x[:5], y[:5] + 7)


def test_the_linear_families_import_without_sklearn():
    """models/linear.py and models/trees.py load neither sklearn nor
    torch: the Builder's host families need numpy and scipy only."""
    import subprocess
    import sys

    probe = ("import sys\n"
             "sys.modules['sklearn'] = None\n"
             "import learningorchestra_tpu_torch.models.linear\n"
             "import learningorchestra_tpu_torch.models.trees\n"
             "print(sorted(m for m in ('torch', 'sklearn') "
             "if sys.modules.get(m)))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         env={**os.environ, "PYTHONPATH": root},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
