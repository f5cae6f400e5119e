"""The port's histogram booster (``learningorchestra_tpu_torch/native/``,
its own copy of ``csrc/locore.cpp``'s ``lo_hgb_*`` core in
``csrc/hgb_core.cpp``) held to the JAX package's ``native/hgb.py``: bin
edges and codes bit-equal, the C++ core's predictions and raw scores
equal to the JAX core's, the numpy fallback's to the JAX fallback's, and
a build raced by two processes leaving one good library.

The JAX core is built into a cache of this test's own
(``LO_NATIVE_CACHE``), so no other test process's build of it races
this one.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from learningorchestra_tpu import native as jax_native
from learningorchestra_tpu.native import hgb as jax_hgb
from learningorchestra_tpu_torch import native
from learningorchestra_tpu_torch.native import hgb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(kind, n=6000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    margin = x @ np.array([1.0, -2.0, 0.5, 1.5])
    if kind == "multiclass":
        y = np.digitize(margin, [-1.5, 1.5])
    else:
        y = (margin > 0).astype(np.int64)
    if kind == "awkward":
        # NaNs, infinities, a low-cardinality feature, string labels
        x[rng.random(n) < 0.05, 0] = np.nan
        x[:7, 1] = np.inf
        x[7:9, 1] = -np.inf
        x[:, 2] = np.round(x[:, 2])
        y = np.where(y == 1, "yes", "no")
    return x, y


@pytest.fixture(scope="module")
def jax_core(tmp_path_factory):
    """The JAX package's C++ core, built into this module's cache."""
    saved = (os.environ.get("LO_NATIVE_CACHE"), jax_native._LIB,
             jax_native._TRIED)
    os.environ["LO_NATIVE_CACHE"] = str(tmp_path_factory.mktemp("jaxcore"))
    jax_native._LIB, jax_native._TRIED = None, False
    assert jax_native.get_lib() is not None
    yield
    if saved[0] is None:
        os.environ.pop("LO_NATIVE_CACHE", None)
    else:
        os.environ["LO_NATIVE_CACHE"] = saved[0]
    jax_native._LIB, jax_native._TRIED = saved[1], saved[2]


@pytest.mark.parametrize("kind", ["binary", "multiclass", "awkward"])
def test_edges_and_codes_bit_equal(kind):
    x, _ = _data(kind)
    edges, want = hgb.quantile_edges(x), jax_hgb.quantile_edges(x)
    assert len(edges) == len(want)
    for got, expected in zip(edges, want):
        assert got.dtype == expected.dtype
        assert np.array_equal(got, expected)
    small = hgb.quantile_edges(x, max_bins=16)
    assert all(np.array_equal(a, b) for a, b in zip(
        small, jax_hgb.quantile_edges(x, max_bins=16)))
    codes = hgb.bin_codes(x, edges)
    assert codes.dtype == np.uint8
    assert np.array_equal(codes, jax_hgb.bin_codes(x, want))


@pytest.mark.parametrize("kind", ["binary", "multiclass", "awkward"])
def test_core_predictions_equal_the_jax_core(jax_core, kind):
    x, y = _data(kind, n=12000, seed=1)
    edges = hgb.quantile_edges(x)
    codes = hgb.bin_codes(x, edges)
    port = hgb.HistGB(n_iter=6, max_depth=4).fit_binned(codes, y)
    ref = jax_hgb.HistGB(n_iter=6, max_depth=4).fit_binned(codes, y)
    assert port._model is not None and ref._model is not None
    assert np.array_equal(port.classes_, ref.classes_)
    assert np.array_equal(port.predict_binned(codes),
                          ref.predict_binned(codes))
    # the raw scores, exactly
    k = 1 if len(port.classes_) == 2 else len(port.classes_)
    got, want = (np.empty((len(codes), k)) for _ in range(2))
    port._lib.lo_hgb_predict(port._model, codes.ctypes.data, len(codes),
                             got.ctypes.data)
    ref._lib.lo_hgb_predict.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int64, ctypes.c_char_p]
    ref._lib.lo_hgb_predict(ctypes.c_void_p(ref._model),
                            codes.ctypes.data_as(ctypes.c_char_p),
                            len(codes), want.ctypes.data_as(ctypes.c_char_p))
    np.testing.assert_array_equal(got, want)
    assert (port.predict_binned(codes) == y).mean() > 0.85
    # a refit frees the previous model and trains anew
    port.fit_binned(codes, y)
    assert np.array_equal(port.predict_binned(codes),
                          ref.predict_binned(codes))


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_numpy_fallback_equals_the_jax_fallback(monkeypatch, kind):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    x, y = _data(kind, n=3000, seed=2)
    codes = hgb.bin_codes(x, hgb.quantile_edges(x))
    port = hgb.HistGB(n_iter=4, max_depth=3).fit_binned(codes, y)
    ref = jax_hgb.HistGB(n_iter=4, max_depth=3).fit_binned(codes, y)
    assert port._model is None and port._py is not None
    np.testing.assert_array_equal(port._py["bases"], ref._py["bases"])
    for a, b in zip(port._py["trees"], ref._py["trees"]):
        assert a[0] == b[0]
        for u, v in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(u, v)
    assert np.array_equal(port.predict_binned(codes),
                          ref.predict_binned(codes))
    # four shallow iterations: well above chance, not converged
    assert (port.predict_binned(codes) == y).mean() > 0.8


def test_fit_needs_two_classes():
    codes = np.zeros((10, 2), np.uint8)
    with pytest.raises(ValueError, match="at least 2 classes"):
        hgb.HistGB().fit_binned(codes, np.zeros(10))


_BUILD = """
import sys
from pathlib import Path
from learningorchestra_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
print(native.build())
"""


def test_two_processes_building_at_once_leave_one_good_library(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(paths.pop())]
    lib = ctypes.CDLL(str(next(tmp_path.iterdir())))
    assert lib.lo_hgb_abi_version() == 1


def test_nothing_builds_at_import():
    """Neither core (the booster's, the CSV core) is built or loaded by
    importing their modules."""
    probe = ("import learningorchestra_tpu_torch.native.hgb as h, "
             "learningorchestra_tpu_torch.native.ops as o, "
             "learningorchestra_tpu_torch.native as n; "
             "print(n._tried, n._lib)")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["{}", "{}"], out.stderr
