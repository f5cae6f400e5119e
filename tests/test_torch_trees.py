"""The port's tree families (``learningorchestra_tpu_torch/models/
trees.py`` over the C++ tree core ``csrc/tree_core.cpp`` and its Python
version in ``native/trees.py``) held to scikit-learn's, which the JAX
package's Builder fits.

- The core equals its Python version: the same nodes (features,
  thresholds, children, values) bit for bit, the same
  leaves and GB's same residuals, for gini over 2 and 3 classes, squared
  error, bootstrap weights and a feature subset; the estimators give the
  same predictions on both paths (``LO_NATIVE=0`` is the Python one).
- At sklearn's ``random_state`` the port's DT, RF and GB are sklearn's,
  split for split: the splitter's feature draws, its sort and partition
  of a node's rows and its order of sums are reproduced, so predictions
  and ``predict_proba`` are equal (tolerance 0) and GB's
  ``decision_function`` within 1e-9.
- The JAX package leaves ``random_state`` unset, and sklearn's trees then
  depend on the unseeded feature order where two features split a node
  equally well; parity with the JAX package is promised where sklearn's
  predictions agree over seeds (checked before the comparison): the
  tutorial's ``pclass``/``sex`` rows for DT and GB, and GB on the Builder
  test's continuous rows.
- RF: deterministic under its seed; its held-out accuracy within 0.02 of
  the mean of sklearn's over three seeds.
"""

import os
import shutil

import numpy as np
import pytest
from sklearn import ensemble, tree

from learningorchestra_tpu_torch import native
from learningorchestra_tpu_torch.models import trees
from learningorchestra_tpu_torch.native import trees as core

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="g++ is absent: the C++ tree core cannot be built here")

NODE_FIELDS = ("feature", "threshold", "left", "right", "value")
# GB's decision_function against sklearn's
GB_TOL = 1e-9
# RF's held-out accuracy against the mean of sklearn's over three seeds
RF_ACCURACY_TOL = 0.02


def _continuous(n, k, seed, features=5):
    """Rows of a linear margin in ``k`` classes (tie-free floats)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, features))
    margin = x @ np.random.default_rng(99).normal(size=features)
    y = np.digitize(margin, np.quantile(margin, np.arange(1, k) / k))
    return x, y


def _titanic(n=891, seed=7):
    """The tutorial's section 6 rows (tests/test_server.py's generator)
    as its modelingCode sees them: ``pclass`` and ``sex == female``."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        pclass = int(rng.integers(1, 4))
        female = str(rng.choice(["male", "female"])) == "female"
        rng.uniform(1, 70), rng.uniform(5, 200)  # age, fare
        survived = int(rng.random() < (0.8 if female else 0.2))
        rows.append((pclass, float(female), survived))
    a = np.array(rows, np.float64)
    return a[:, :2], a[:, 2].astype(np.int64)


@pytest.fixture(autouse=True)
def core_on(monkeypatch):
    monkeypatch.delenv("LO_NATIVE", raising=False)
    assert core.core() is not None, native.build_error(native.TREE)


def _on_both_paths(fn):
    """``fn()`` through the core, then on the numpy path
    (``LO_NATIVE=0``)."""
    got = fn()
    os.environ["LO_NATIVE"] = "0"
    try:
        assert core.core() is None
        want = fn()
    finally:
        os.environ.pop("LO_NATIVE")
    return got, want


CORE_CASES = {
    "gini binary": dict(k=2),
    "gini 3-class": dict(k=3),
    "gini bootstrap weights, 2 of 5 features": dict(k=3, weights=True,
                                                    max_features=2),
    "squared error, depth 3": dict(k=0, max_depth=3),
    "squared error, no depth limit": dict(k=0),
}


@pytest.mark.parametrize("case", sorted(CORE_CASES))
def test_core_equals_its_numpy_version(case):
    spec = CORE_CASES[case]
    k = spec["k"]
    x, y = _continuous(400, max(k, 2), seed=1)
    x = x.astype(np.float32)
    rng = np.random.default_rng(2)
    if k == 0:
        y = rng.normal(size=len(x))
    weights = np.bincount(rng.integers(0, len(x), len(x)),
                          minlength=len(x)).astype(np.float64) \
        if spec.get("weights") else None
    fit = dict(n_classes=k, sample_weight=weights,
               max_depth=spec.get("max_depth"),
               max_features=spec.get("max_features"), seed=12345)
    native.reset_counts()
    got, want = _on_both_paths(lambda: core.fit_tree(x, y, **fit))
    assert got.node_count == want.node_count > 7
    for field in NODE_FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    x_new = np.random.default_rng(3).normal(size=(500, 5)).astype(
        np.float32)
    leaves = _on_both_paths(lambda: core.apply(got, x_new))
    np.testing.assert_array_equal(*leaves)
    raw = np.random.default_rng(4).normal(size=(400, max(k, 2) - 1)) * 20
    residuals = _on_both_paths(lambda: core.gb_residuals(raw, y % 2 if k
                                                         < 3 else y))
    np.testing.assert_array_equal(*residuals)
    counts = native.counts()
    assert counts["tree_fit"] == {"native": {"calls": 1, "rows": 400},
                                  "python": {"calls": 1, "rows": 400}}
    assert counts["tree_predict"]["native"]["rows"] == 500
    assert counts["gb_residuals"]["python"]["rows"] == 400


@pytest.mark.parametrize("family", ["DT", "RF", "GB"])
def test_estimators_predict_alike_on_both_paths(family):
    x, y = _continuous(300, 3, seed=4)
    make = {"DT": trees.DecisionTreeClassifier,
            "RF": trees.RandomForestClassifier,
            "GB": trees.GradientBoostingClassifier}[family]
    x, y = x[:120], y[:120]  # the Python version's loops are slow
    x_new = _continuous(200, 3, seed=5)[0]
    got, want = _on_both_paths(lambda: make().fit(x, y).predict(x_new))
    np.testing.assert_array_equal(got, want)


DT_DATA = {"continuous binary": lambda: _continuous(600, 2, seed=6),
           "continuous 3-class": lambda: _continuous(600, 3, seed=7),
           "tutorial pclass/sex": _titanic}


@pytest.mark.parametrize("data", sorted(DT_DATA))
@pytest.mark.parametrize("random_state", [0, 5])
def test_dt_is_sklearns_tree(data, random_state):
    x, y = DT_DATA[data]()
    x_new = _continuous(400, 2, seed=8, features=x.shape[1])[0] \
        if "continuous" in data else x
    port = trees.DecisionTreeClassifier(random_state=random_state).fit(x, y)
    ref = tree.DecisionTreeClassifier(random_state=random_state).fit(x, y)
    assert port.tree_.node_count == ref.tree_.node_count
    np.testing.assert_array_equal(port.tree_.feature, ref.tree_.feature)
    np.testing.assert_array_equal(port.tree_.threshold,
                                  ref.tree_.threshold)
    np.testing.assert_array_equal(port.predict(x_new), ref.predict(x_new))
    np.testing.assert_array_equal(port.predict_proba(x_new),
                                  ref.predict_proba(x_new))


def test_dt_and_gb_predict_as_the_jax_builders_on_the_tutorial_rows():
    """The JAX package's Builder fits ``DecisionTreeClassifier()`` and
    ``GradientBoostingClassifier()`` with no seed: on the tutorial's rows
    every seed gives the same model, and the port's equals it."""
    x, y = _titanic()
    for make, port in ((tree.DecisionTreeClassifier,
                        trees.DecisionTreeClassifier()),
                       (ensemble.GradientBoostingClassifier,
                        trees.GradientBoostingClassifier())):
        refs = [make(random_state=s).fit(x, y) for s in range(4)]
        unseeded = make().fit(x, y)
        port.fit(x, y)
        for ref in refs + [unseeded]:
            np.testing.assert_array_equal(port.predict(x), ref.predict(x))
        if isinstance(port, trees.GradientBoostingClassifier):
            np.testing.assert_allclose(port.decision_function(x),
                                       unseeded.decision_function(x),
                                       rtol=0, atol=GB_TOL)


def _builder_rows(n, seed):
    """tests/test_torch_builder.py's rows: four float32 features and the
    sign of a fixed margin."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    y = (x @ np.array([1.0, -2.0, 0.5, 1.5]) > 0).astype(np.int64)
    return x.astype(np.float32), y


GB_DATA = {"builder rows": lambda: _builder_rows(4096, 7),
           "tutorial pclass/sex": _titanic}


@pytest.mark.parametrize("data", sorted(GB_DATA))
def test_gb_equals_sklearn_where_sklearn_is_deterministic(data):
    """Most continuous tables hold a node that two features split equally
    well, so an unseeded sklearn GB is not one model; these two tables
    hold none (the premise is checked over three seeds)."""
    x, y = GB_DATA[data]()
    x_new = _builder_rows(1024, 8)[0] if data == "builder rows" else x
    refs = [ensemble.GradientBoostingClassifier(random_state=s).fit(x, y)
            for s in range(3)]
    scores = [r.decision_function(x_new) for r in refs]
    # the premise: sklearn's model does not depend on its seed here
    for s in scores[1:]:
        np.testing.assert_allclose(s, scores[0], rtol=0, atol=GB_TOL)
    port = trees.GradientBoostingClassifier().fit(x, y)
    np.testing.assert_allclose(port.decision_function(x_new), scores[0],
                               rtol=0, atol=GB_TOL)
    np.testing.assert_array_equal(port.predict(x_new),
                                  refs[0].predict(x_new))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("random_state", [0, 7])
def test_gb_is_sklearns_at_its_seed(k, random_state):
    """One tree a class a stage (one for two classes), the Newton step
    ((K-1)/K of it above two classes), sklearn's residuals bit for bit."""
    x, y = _continuous(600, k, seed=11)
    x_new = _continuous(400, k, seed=15)[0]
    port = trees.GradientBoostingClassifier(
        random_state=random_state).fit(x, y)
    ref = ensemble.GradientBoostingClassifier(
        random_state=random_state).fit(x, y)
    np.testing.assert_allclose(port.decision_function(x_new),
                               ref.decision_function(x_new), rtol=0,
                               atol=GB_TOL)
    np.testing.assert_array_equal(port.predict(x_new), ref.predict(x_new))


def test_rf_is_seeded_and_as_accurate_as_sklearns():
    x, y = _continuous(1500, 3, seed=12)
    x_test, y_test = _continuous(1000, 3, seed=13)
    first = trees.RandomForestClassifier().fit(x, y)
    again = trees.RandomForestClassifier().fit(x, y)
    other = trees.RandomForestClassifier(random_state=1).fit(x, y)
    np.testing.assert_array_equal(first.predict_proba(x_test),
                                  again.predict_proba(x_test))
    assert not np.array_equal(first.predict_proba(x_test),
                              other.predict_proba(x_test))
    assert len(first.estimators_) == 100
    sk = [ensemble.RandomForestClassifier(random_state=s).fit(x, y).score(
        x_test, y_test) for s in range(3)]
    accuracy = np.mean(first.predict(x_test) == y_test)
    assert abs(accuracy - np.mean(sk)) < RF_ACCURACY_TOL
    # at sklearn's seed its bootstraps and feature draws are sklearn's
    ref = ensemble.RandomForestClassifier(random_state=0).fit(x, y)
    np.testing.assert_array_equal(first.predict_proba(x_test),
                                  ref.predict_proba(x_test))


def test_the_core_with_every_feature_and_unit_weights_is_the_dt():
    x, y = _continuous(500, 3, seed=14)
    dt = trees.DecisionTreeClassifier().fit(x, y)
    one = core.fit_tree(x.astype(np.float32), y, n_classes=3,
                        sample_weight=np.ones(len(x)), max_features=5,
                        seed=core.rand_r_state(0))
    for field in NODE_FIELDS:
        np.testing.assert_array_equal(getattr(one, field),
                                      getattr(dt.tree_, field))


def test_rows_are_cast_to_float32_and_non_finite_rows_refused():
    """Two values one float32 apart in float64 are one value to the tree
    (sklearn's cast); NaN and infinities are refused."""
    x = np.array([[1.0], [1.0 + 1e-12], [2.0], [2.0 + 1e-12]])
    y = np.array([0, 1, 0, 1])
    dt = trees.DecisionTreeClassifier().fit(x, y)
    # one split, between 1 and 2 (a split that gains nothing is taken,
    # as sklearn takes it); each leaf holds a 1 and its twin
    np.testing.assert_array_equal(dt.tree_.threshold, [1.5, -2, -2])
    np.testing.assert_array_equal(dt.tree_.value, [[2, 2], [1, 1], [1, 1]])
    np.testing.assert_array_equal(
        dt.predict_proba(x),
        tree.DecisionTreeClassifier().fit(x, y).predict_proba(x))
    for bad in (np.nan, np.inf, 1e39):
        with pytest.raises(ValueError, match="NaN, infinity"):
            trees.DecisionTreeClassifier().fit(np.array([[bad], [0.0]]),
                                               [0, 1])
    with pytest.raises(ValueError, match="1 class"):
        trees.GradientBoostingClassifier().fit(x, np.zeros(4))
    with pytest.raises(ValueError, match="2 features, but"):
        dt.predict(np.zeros((3, 2)))
    with pytest.raises(ValueError, match="class ids outside"):
        core.fit_tree(x, np.array([0, 1, 2, 1]), n_classes=2)
    with pytest.raises(ValueError, match="at least one row"):
        trees.RandomForestClassifier().fit(np.zeros((0, 2)), [])
