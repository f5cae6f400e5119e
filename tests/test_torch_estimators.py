"""The port's Builder estimators (``learningorchestra_tpu_torch/models/
estimators.py``) held to the JAX package's ``LogisticRegressionJAX`` and
``GaussianNBJAX`` and to sklearn, at the cases of
``tests/test_builder_mesh.py``, plus the carry of a fitted JAX estimator
into the port and a JAX ``dill`` artifact of each loading as the port's
class.

Tolerances, and why:
- LR against the JAX fit: the JAX side runs its per-step path
  (``LO_SCAN_FIT_MAX_BYTES=0``) on a one-device mesh, whose shuffle is
  the port's ``default_rng(seed + epoch)``; both compute in bfloat16.
  ``w`` and ``b``, each centred over the classes (softmax is unchanged by
  a constant added to every logit, so no gradient holds that direction
  and bfloat16 rounding lets it drift), agree within 2e-3 of the largest
  ``|w|``, and the last epoch's loss within 1e-3 relative, the
  tolerance of the port's bfloat16 fit tests.
- NB against the JAX fit: ``theta_``, ``var_`` and ``class_prior_``
  within 1e-5 relative to each array's largest value (both sum float32
  on the device; the port in blocks finished in float64).
- A carried or loaded estimator predicts exactly as the JAX one.
"""

import os

import numpy as np
import pytest

from learningorchestra_tpu_torch.catalog.artifacts import ArtifactStore
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.models.estimators import (
    GaussianNBJAX,
    LogisticRegressionJAX,
)

LR_TOL, LOSS_RTOL, NB_RTOL = 2e-3, 1e-3, 1e-5


def _synth(n, seed, d=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ np.array([1.0, -2.0, 0.5, 1.5])[:d] > 0).astype(np.int64)
    return x, y


@pytest.fixture(scope="module")
def jax_side():
    """The JAX estimators on a one-device mesh, fitting on the per-step
    path."""
    import jax

    from learningorchestra_tpu import config as config_mod
    from learningorchestra_tpu.models import estimators as jax_est
    from learningorchestra_tpu.runtime import mesh as mesh_lib

    old = os.environ.get("LO_SCAN_FIT_MAX_BYTES")
    os.environ["LO_SCAN_FIT_MAX_BYTES"] = "0"
    config_mod.reset_config()
    one = mesh_lib.slice_mesh(jax.devices()[:1])

    def make(cls, **kwargs):
        est = getattr(jax_est, cls)(**kwargs)
        est.set_mesh(one)
        return est

    yield make
    if old is None:
        os.environ.pop("LO_SCAN_FIT_MAX_BYTES", None)
    else:
        os.environ["LO_SCAN_FIT_MAX_BYTES"] = old
    config_mod.reset_config()


def _centred(params):
    w, b = np.asarray(params["w"]), np.asarray(params["b"])
    return w - w.mean(axis=1, keepdims=True), b - b.mean()


def _assert_lr_close(port, jax_lr):
    (pw, pb), (jw, jb) = _centred(port.params), _centred(jax_lr.params)
    scale = float(np.abs(np.asarray(jax_lr.params["w"])).max())
    assert np.abs(pw - jw).max() <= LR_TOL * scale
    assert np.abs(pb - jb).max() <= LR_TOL * scale
    np.testing.assert_allclose(port.history[-1]["loss"],
                               float(jax_lr.history[-1]["loss"]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", ["separable", "sub-slice", "ragged tail"])
def test_logreg_learns_and_matches_jax(jax_side, case):
    n, seed, epochs, batch, bound = {
        "separable": (4096, 0, 8, 512, 0.95),
        "sub-slice": (2048, 2, 6, 256, 0.9),
        # 1000 rows: the last batch of each epoch is padded and masked
        "ragged tail": (1000, 6, 3, 128, 0.9)}[case]
    x, y = _synth(n, seed)
    port = LogisticRegressionJAX(epochs=epochs, batch_size=batch,
                                 device="cpu").fit(x, y)
    jax_lr = jax_side("LogisticRegressionJAX", epochs=epochs,
                      batch_size=batch).fit(x, y)
    xt, yt = _synth(1024, seed + 1)
    assert port.score(xt, yt) > bound
    probs = port.predict_proba(xt)
    assert probs.shape == (1024, 2)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    _assert_lr_close(port, jax_lr)
    assert np.mean(port.predict(xt) == jax_lr.predict(xt)) >= 0.99
    assert port.params["w"].dtype == np.float32


def test_logreg_multiclass_labels_and_sklearn():
    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(3)
    x = rng.normal(size=(6000, 5)).astype(np.float32)
    y = np.array(["a", "b", "c"])[np.digitize(
        x @ np.array([1.0, -1.0, 0.5, 0.2, 0.0]), [-0.7, 0.7])]
    port = LogisticRegressionJAX(epochs=10, batch_size=512,
                                 device="cpu").fit(x, y)
    assert list(port.classes_) == ["a", "b", "c"]
    ref = LogisticRegression(max_iter=1000).fit(x, y)
    assert np.mean(port.predict(x) == ref.predict(x)) > 0.95


def test_gaussian_nb_matches_jax_and_sklearn(jax_side):
    from sklearn.naive_bayes import GaussianNB

    x, y = _synth(2048, seed=4)
    port = GaussianNBJAX(device="cpu").fit(x, y)
    jax_nb = jax_side("GaussianNBJAX").fit(x, y)
    ref = GaussianNB().fit(x, y)
    xt, _ = _synth(512, seed=5)
    assert np.mean(port.predict(xt) == ref.predict(xt)) > 0.99
    np.testing.assert_allclose(port.theta_, ref.theta_, atol=1e-4)
    for key in ("theta_", "var_", "class_prior_"):
        got, want = getattr(port, key), getattr(jax_nb, key)
        assert np.abs(got - want).max() <= NB_RTOL * np.abs(want).max()
    assert np.array_equal(port.predict(xt), jax_nb.predict(xt))


def test_gaussian_nb_large_mean_features(jax_side):
    """On raw float32 data E[x^2] - mean^2 cancels where |mean| >> std;
    the host centring keeps variances and predictions sklearn's."""
    from sklearn.naive_bayes import GaussianNB

    rng = np.random.default_rng(11)
    x = rng.normal(size=(4096, 3)).astype(np.float64)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int64)
    x = x + np.array([1e4, 5e4, 1e5])
    port = GaussianNBJAX(device="cpu").fit(x, y)
    ref = GaussianNB().fit(x, y)
    np.testing.assert_allclose(port.var_, ref.var_, rtol=5e-2)
    xt = rng.normal(size=(512, 3)) + np.array([1e4, 5e4, 1e5])
    assert np.mean(port.predict(xt) == ref.predict(xt)) > 0.99
    jax_nb = jax_side("GaussianNBJAX").fit(x, y)
    np.testing.assert_allclose(port.var_, jax_nb.var_, rtol=5e-2)


@pytest.mark.parametrize("rows", [1000, 8192, 20000])
def test_gaussian_nb_blocks_match_one_float64_pass(rows):
    """Rows that do not fill the last block (zero-padded rows have an
    all-zero one-hot) give the statistics of one float64 pass."""
    x, y = _synth(rows, seed=6)
    port = GaussianNBJAX(device="cpu").fit(x, y)
    xc = x.astype(np.float64)
    theta = np.stack([xc[y == c].mean(axis=0) for c in (0, 1)])
    var = np.stack([xc[y == c].var(axis=0) for c in (0, 1)])
    np.testing.assert_allclose(port.theta_, theta, atol=1e-5)
    np.testing.assert_allclose(port.var_, var, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.class_prior_,
                               np.bincount(y) / len(y), rtol=0, atol=0)


def test_unfitted_estimators_raise():
    with pytest.raises(RuntimeError, match="not fitted"):
        LogisticRegressionJAX(device="cpu").predict(np.zeros((1, 2)))
    with pytest.raises(RuntimeError, match="not fitted"):
        GaussianNBJAX(device="cpu").predict(np.zeros((1, 2)))


def test_fitted_jax_estimators_carry_across(jax_side):
    x, y = _synth(2048, seed=7)
    xt, _ = _synth(512, seed=8)
    jax_lr = jax_side("LogisticRegressionJAX", epochs=3,
                      batch_size=256).fit(x, y)
    jax_nb = jax_side("GaussianNBJAX").fit(x, y)
    lr = weights.estimator_from_jax(jax_lr, device="cpu")
    nb = weights.estimator_from_jax(jax_nb, device="cpu")
    assert isinstance(lr, LogisticRegressionJAX)
    assert isinstance(nb, GaussianNBJAX)
    assert (lr.epochs, lr.batch_size, lr.learning_rate, lr.seed) == \
        (3, 256, jax_lr.learning_rate, jax_lr.seed)
    assert lr.device.type == nb.device.type == "cpu"
    assert np.array_equal(lr.predict(xt), jax_lr.predict(xt))
    np.testing.assert_array_equal(lr.predict_proba(xt),
                                  jax_lr.predict_proba(xt))
    assert np.array_equal(nb.predict(xt), jax_nb.predict(xt))
    np.testing.assert_array_equal(nb.predict_proba(xt),
                                  jax_nb.predict_proba(xt))
    # a carried estimator refits on the port
    assert lr.fit(x, y).score(xt, jax_lr.predict(xt)) > 0.95


def test_jax_dill_artifacts_load_as_port_estimators(jax_side, tmp_path,
                                                    tmp_config):
    from learningorchestra_tpu.catalog.artifacts import \
        ArtifactStore as JaxStore

    x, y = _synth(2048, seed=9)
    xt, _ = _synth(512, seed=10)
    fitted = {"lr": jax_side("LogisticRegressionJAX", epochs=2,
                             batch_size=256).fit(x, y),
              "nb": jax_side("GaussianNBJAX").fit(x, y),
              "unfitted": jax_side("GaussianNBJAX")}
    jax_store = JaxStore(str(tmp_path))
    port_store = ArtifactStore(str(tmp_path), device="cpu")
    for name, est in fitted.items():
        # the JAX estimators hold a mesh: the JAX model service stores
        # them before any set_mesh
        est._mesh_override = None
        jax_store.save(est, name, "train/scikitlearn")
        meta = (tmp_path / "train" / "scikitlearn" / name / "meta.json")
        assert '"dill"' in meta.read_text()
        loaded = port_store.load(name)
        assert type(loaded).__module__ == \
            "learningorchestra_tpu_torch.models.estimators"
        assert type(loaded).__name__ == type(est).__name__
        assert loaded.device.type == "cpu"
        if name == "unfitted":
            assert loaded.classes_ is None
            loaded.fit(x, y)
            continue
        assert np.array_equal(loaded.predict(xt), est.predict(xt))
    # the port's own pickle keeps its device and state
    port_store.save(loaded, "refit", "train/scikitlearn")
    again = port_store.load("refit")
    assert again.device.type == "cpu"
    np.testing.assert_array_equal(again.theta_, loaded.theta_)
