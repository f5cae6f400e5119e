"""The port's ``tensorflow.keras`` shim (``models/tf_compat``), its place
in the sandbox and the ``#`` DSL, and the REST routes that reach it,
against the JAX package's shim.

- Every layer, optimizer and loss spec carries the JAX shim's config;
  its refusals (non-default gates, ``Bidirectional`` of a simple RNN)
  are the JAX shim's words.
- The same ``Sequential`` of specs in both packages, with the JAX
  model's weights carried across, predicts within 1e-5 (float32).
- ``test_keras_shim_model_lineage``: ``tests/test_executors.py``'s
  lineage through both packages' REST: ``#tensorflow.keras.layers``
  layers, ``#tensorflow.keras.optimizers.Adam(0.05)``, a fit whose
  epoch losses (``shuffle=False``, the JAX init) are within 1e-5 of the
  JAX package's, and an evaluate.
- BASELINE config 5 in the reference's form: ``ResNet50`` (stages
  ``[1, 1, 1, 1]``) from a ``save_weights`` export through
  ``tensorflow.keras.applications``, then a GridSearch on ``/tune``
  (``tests/test_server.py``'s transfer and tune flow).
- ``load_model`` over REST of every committed fixture
  (``tests/fixtures/keras``, made by ``scripts/make_keras_fixtures.py``)
  predicts TensorFlow's outputs within 1e-5.
- ``#`` specs cross the subprocess boundary in a child that imports no
  torch, and a forged envelope that names ``os.system``, a function of
  the shim or a module outside it reaches nothing.

No test here imports TensorFlow.
"""

import json
import os
import pickle
import time

import jax
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.catalog import ArtifactStore as JaxArtifactStore
from learningorchestra_tpu.models.neural import NeuralModel as JaxNeuralModel
from learningorchestra_tpu.models.tf_compat import keras as jax_keras
from learningorchestra_tpu.models.tf_compat.keras import models as jax_models
from learningorchestra_tpu_torch.catalog import ArtifactStore
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import NeuralModel, weights
from learningorchestra_tpu_torch.models.tf_compat import keras as port_keras
from learningorchestra_tpu_torch.models.tf_compat.keras import (
    applications, models as port_models)
from learningorchestra_tpu_torch.services import sandbox
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "keras")
PREFIX = "/api/learningOrchestra/v1"
TOL = 1e-5


@pytest.fixture()
def float32(monkeypatch):
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    jax_config.reset_config()
    yield
    jax_config.reset_config()


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


# ----------------------------------------------------------------------
# the specs
# ----------------------------------------------------------------------
LAYERS = {
    "Dense": ((16,), {"activation": "relu", "input_shape": [4]}),
    "Conv2D": ((8, 3), {"strides": 2, "padding": "same"}),
    "Conv1D": ((4, [5]), {"strides": [2], "activation": "tanh"}),
    "Conv2DTranspose": ((3, (3, 2)), {"strides": 2}),
    "MaxPooling1D": ((), {"pool_size": 3}),
    "MaxPooling2D": (((2, 3),), {}),
    "AveragePooling2D": ((3,), {"strides": 1}),
    "GlobalAveragePooling1D": ((), {}),
    "GlobalAveragePooling2D": ((), {}),
    "GlobalMaxPooling1D": ((), {}),
    "GlobalMaxPooling2D": ((), {}),
    "Flatten": ((), {}),
    "Reshape": (((28, 28, 1),), {}),
    "Dropout": ((0.25,), {}),
    "BatchNormalization": ((), {"momentum": 0.9, "epsilon": 1e-5}),
    "LayerNormalization": ((), {"epsilon": 1e-6}),
    "Embedding": ((20000, 128), {"input_length": 200}),
    "LSTM": ((128,), {"return_sequences": True}),
    "GRU": ((32,), {}),
    "SimpleRNN": ((8,), {"activation": "relu"}),
    "Activation": (("gelu",), {}),
    "ReLU": ((), {}),
    "InputLayer": ((), {"input_shape": (28, 28)}),
    "Input": ((), {"shape": (7,)}),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_specs_equal_the_jax_shims(name):
    args, kwargs = LAYERS[name]
    port = getattr(port_keras.layers, name)(*args, **kwargs)
    want = getattr(jax_keras.layers, name)(*args, **kwargs)
    assert vars(port) == vars(want)
    assert type(port).__module__ == \
        "learningorchestra_tpu_torch.models.tf_compat.keras.layers"


def test_bidirectional_and_the_refusals_are_the_jax_shims():
    assert vars(port_keras.layers.Bidirectional(
        port_keras.layers.LSTM(4, return_sequences=True))) == vars(
        jax_keras.layers.Bidirectional(jax_keras.layers.LSTM(
            4, return_sequences=True)))
    assert vars(port_keras.layers.Bidirectional(
        port_keras.layers.GRU(3))) == vars(jax_keras.layers.Bidirectional(
            jax_keras.layers.GRU(3)))
    refused = (lambda k: k.layers.LSTM(4, activation="relu"),
               lambda k: k.layers.GRU(4, recurrent_activation="hard_sigmoid"),
               lambda k: k.layers.Bidirectional(k.layers.SimpleRNN(4)))
    for make in refused:
        messages = []
        for keras in (port_keras, jax_keras):
            with pytest.raises(ValueError) as err:
                make(keras)
            messages.append(str(err.value))
        assert messages[0] == messages[1]


OPTIMIZERS = {
    "Adam": ((0.05,), {}),
    "AdamW": ((3e-4,), {"weight_decay": 0.01, "beta_1": 0.8}),
    "SGD": ((0.1,), {"momentum": 0.9, "nesterov": True}),
    "RMSprop": ((), {"rho": 0.8, "momentum": 0.5}),
    "Adagrad": ((0.01,), {"epsilon": 1e-7}),
}
LOSSES = ("SparseCategoricalCrossentropy", "CategoricalCrossentropy",
          "BinaryCrossentropy", "MeanSquaredError")


@pytest.mark.parametrize("name", list(OPTIMIZERS) + list(LOSSES))
def test_optimizer_and_loss_specs_compile_as_the_jax_shims(name):
    """The spec, and what ``compile`` makes of it in each package."""
    if name in OPTIMIZERS:
        args, kwargs = OPTIMIZERS[name]
        port = getattr(port_keras.optimizers, name)(*args, **kwargs)
        want = getattr(jax_keras.optimizers, name)(*args, **kwargs)
        assert port.spec == want.spec
        compile_kw = ({"optimizer": port}, {"optimizer": want})
    else:
        port = getattr(port_keras.losses, name)()
        want = getattr(jax_keras.losses, name)()
        assert port.spec == want.spec
        compile_kw = ({"loss": port}, {"loss": want})
    pm = NeuralModel([{"kind": "dense", "units": 2}], device="cpu")
    jm = JaxNeuralModel([{"kind": "dense", "units": 2}])
    pm.compile(**compile_kw[0])
    jm.compile(**compile_kw[1])
    assert (pm.optimizer_spec, pm.loss_name) == (jm.optimizer_spec,
                                                 jm.loss_name)


# ----------------------------------------------------------------------
# Sequential against the JAX Sequential
# ----------------------------------------------------------------------
def _cnn(k):
    return [k.layers.InputLayer(input_shape=(10, 10, 1)),
            k.layers.Conv2D(4, 3, padding="same", activation="relu"),
            k.layers.BatchNormalization(), k.layers.MaxPooling2D(),
            k.layers.Flatten(), k.layers.Dropout(0.2),
            k.layers.Dense(8, activation="relu"),
            k.layers.Dense(3, activation="softmax")]


def _rnn(k):
    return [k.layers.Embedding(40, 6),
            k.layers.Bidirectional(k.layers.LSTM(5, return_sequences=True)),
            k.layers.GRU(4, return_sequences=True),
            k.layers.SimpleRNN(3), k.layers.LayerNormalization(),
            k.layers.Dense(2, activation="softmax")]


BODIES = {"cnn": (_cnn, lambda rng: rng.normal(size=(6, 10, 10, 1))
                  .astype(np.float32)),
          "rnn": (_rnn, lambda rng: rng.integers(0, 40, size=(6, 9))
                  .astype(np.int32))}


@pytest.mark.parametrize("body", list(BODIES))
def test_sequential_predicts_as_the_jax_sequential(float32, body):
    layers, make_x = BODIES[body]
    x = make_x(np.random.default_rng(3))
    jm = jax_models.Sequential(layers(jax_keras))
    jm._build_params(jm._coerce_x(x))
    # running statistics that are not the identity
    state = _np(jm.model_state)
    for stats in state.get("batch_stats", {}).values():
        stats["mean"] = stats["mean"] + 0.3
        stats["var"] = stats["var"] * 1.7
    jm.model_state = state
    pm = port_models.Sequential(layers(port_keras), device="cpu")
    assert isinstance(pm, NeuralModel)
    assert pm.layer_configs == jm.layer_configs
    stats = weights.params_from_flax(state.get("batch_stats", {}),
                                     sequential=True)
    pm.set_params(weights.params_from_flax(_np(jm.params), sequential=True),
                  {"batch_stats." + k: v for k, v in stats.items()},
                  input_shape=jm.input_shape)
    np.testing.assert_allclose(pm.predict(x, batch_size=len(x)),
                               jm.predict(x, batch_size=len(x)),
                               atol=TOL, rtol=0)
    # add() takes specs and dicts, and drops an input hint, as in JAX
    pm.add(port_keras.layers.InputLayer(input_shape=(3,)))
    pm.add({"kind": "dense", "units": 2})
    assert pm.layer_configs[-1] == {"kind": "dense", "units": 2}
    assert port_keras.models.Model is port_keras.Sequential


# ----------------------------------------------------------------------
# the lineage over REST, in both packages
# ----------------------------------------------------------------------
def _call(api, method, path, body=None):
    return api.dispatch(method, PREFIX + path, {}, body)[:2]


def _wait(api, name, path, timeout=300.0):
    api.ctx.jobs.wait(name, timeout=timeout)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, body = _call(api, "GET", path)
        assert status == 200, body
        if body["metadata"]["finished"]:
            return body
        if any(d.get("exception") for d in body["result"]):
            raise AssertionError(f"job failed: {body['result'][-1]}")
        time.sleep(0.02)
    raise AssertionError(f"timeout polling {path}")


def _store(api, name, value):
    api.ctx.artifacts.save(value, name, "function/python")
    api.ctx.catalog.create_collection(name, "function/python")
    api.ctx.catalog.mark_finished(name)


def _lineage(api, x, y):
    """model -> compile -> fit -> evaluate, as the reference's keras
    workflow; returns (epoch losses, evaluate result)."""
    _store(api, "ix", x)
    _store(api, "iy", y)
    steps = [
        ("/model/tensorflow", "net", {
            "modelName": "net", "modulePath": "tensorflow.keras.models",
            "class": "Sequential", "classParameters": {"layers": [
                "#tensorflow.keras.layers.Dense(16, activation='relu')",
                "#tensorflow.keras.layers.Dense(2, activation='softmax')"]}}),
        ("/train/tensorflow", "net_c", {
            "name": "net_c", "modelName": "net", "method": "compile",
            "methodParameters": {
                "optimizer": "#tensorflow.keras.optimizers.Adam(0.05)",
                "loss": "sparse_categorical_crossentropy",
                "metrics": ["accuracy"]}}),
        ("/train/tensorflow", "net_t", {
            "name": "net_t", "modelName": "net_c", "method": "fit",
            "methodParameters": {"x": "$ix", "y": "$iy", "epochs": 8,
                                 "batch_size": 32, "shuffle": False}}),
        ("/evaluate/tensorflow", "net_e", {
            "name": "net_e", "modelName": "net_t", "method": "evaluate",
            "methodParameters": {"x": "$ix", "y": "$iy"}}),
    ]
    docs = {}
    for route, name, body in steps:
        status, answer = _call(api, "POST", route, body)
        assert status == 201, answer
        docs[name] = _wait(api, name, f"{route}/{name}")["result"]
    losses = [d["epochRecord"]["loss"] for d in docs["net_t"]
              if "epochRecord" in d]
    result = api.ctx.artifacts.load("net_e", "evaluate/tensorflow")
    return losses, result


def test_keras_shim_model_lineage(tmp_path, float32, monkeypatch):
    """``tests/test_executors.py::test_keras_shim_model_lineage`` through
    both packages' REST: the port's init is the JAX package's, so the
    epoch losses agree within 1e-5; each evaluate is above 0.85."""
    from learningorchestra_tpu.services.server import Api as JaxApi

    rng = np.random.default_rng(7)
    x = rng.normal(size=(96, 2)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32)
    monkeypatch.setattr(NeuralModel, "_build_params", _jax_built)
    # the JAX '#' pass in process (its jailed child imports the whole JAX
    # package); the port's in its default subprocess jail
    jax_config.set_config(jax_config.Config(
        home=str(tmp_path / "jax_home"), compute_dtype="float32",
        sandbox_mode="restricted"))
    jax_api = JaxApi()
    port_api = Api(ServiceContext(Config(home=str(tmp_path / "port_home")),
                                  device="cpu"))
    try:
        want_losses, want = _lineage(jax_api, x, y)
        got_losses, got = _lineage(port_api, x, y)
        port_model = port_api.ctx.artifacts.load("net_c", "train/tensorflow")
    finally:
        for api in (jax_api, port_api):
            api.ctx.close()
    assert type(port_model).__name__ == "Sequential"
    assert port_model.optimizer_spec == {"kind": "adam",
                                         "learning_rate": 0.05}
    assert len(got_losses) == len(want_losses) == 8
    np.testing.assert_allclose(got_losses, want_losses, rtol=TOL, atol=TOL)
    assert got_losses[-1] < got_losses[0]
    assert got["accuracy"] > 0.85 and want["accuracy"] > 0.85
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL,
                               atol=TOL)


def test_resnet50_transfer_and_tune_over_rest(tmp_path, float32):
    """BASELINE config 5 in the reference's form, shrunk: a ResNet-50
    (stages [1, 1, 1, 1], 3 classes, 32x32x3) from a ``save_weights``
    export through ``tensorflow.keras.applications``, then a GridSearch
    of two learning rates on ``/tune``."""
    pre = applications.ResNet50(classes=3, input_shape=(32, 32, 3),
                                stage_sizes=[1, 1, 1, 1], device="cpu")
    pre._build_for((32, 32, 3))
    weights_path = str(tmp_path / "resnet50_pretrained.npz")
    pre.save_weights(weights_path)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=12).astype(np.int32)
    api = Api(ServiceContext(Config(home=str(tmp_path / "home")),
                             device="cpu"))
    try:
        _store(api, "rn_data", {"x": x, "y": y})
        posts = [
            ("/model/tensorflow", "rn_model", {
                "modelName": "rn_model",
                "modulePath": "tensorflow.keras.applications",
                "class": "ResNet50",
                "classParameters": {"classes": 3, "weights": weights_path,
                                    "input_shape": [32, 32, 3],
                                    "stage_sizes": [1, 1, 1, 1]}}),
            ("/model/tensorflow", "rn_sweep", {
                "modelName": "rn_sweep",
                "modulePath": "learningorchestra_tpu.models",
                "class": "GridSearch",
                "classParameters": {"estimator": "$rn_model", "param_grid": {
                    "learning_rate": [1e-3, 1e-4]},
                    "validation_split": 0.25}}),
            ("/tune/tensorflow", "rn_tune", {
                "name": "rn_tune", "modelName": "rn_sweep", "method": "fit",
                "methodParameters": {"x": "$rn_data.x", "y": "$rn_data.y",
                                     "epochs": 1, "batch_size": 4}}),
        ]
        for route, name, body in posts:
            status, answer = _call(api, "POST", route, body)
            assert status == 201, answer
            _wait(api, name, f"{route}/{name}")
            if name == "rn_model":
                loaded = api.ctx.artifacts.load("rn_model")
                np.testing.assert_allclose(
                    loaded.predict(x[:4], batch_size=4),
                    pre.predict(x[:4], batch_size=4), atol=1e-6, rtol=0)
        sweep = api.ctx.artifacts.load("rn_tune", "tune/tensorflow")
    finally:
        api.ctx.close()
    assert sweep.best_params_ in sweep.cv_results_["params"]
    assert len(sweep.cv_results_["params"]) == 2
    with pytest.warns(UserWarning, match="initialized randomly"):
        random = applications.ResNet50(weights="imagenet", classes=3,
                                       stage_sizes=[1, 1, 1, 1],
                                       device="cpu")
    assert random.layer_configs == pre.layer_configs
    with pytest.raises(FileNotFoundError):
        applications.ResNet50(weights=str(tmp_path / "none.npz"),
                              device="cpu")


FIXTURE_CASES = [(name, fmt) for name, fmts in (
    ("cnn", ("savedmodel",)), ("cnn_narrow", ("keras", "h5")),
    ("rnn", ("savedmodel", "keras", "h5"))) for fmt in fmts]


@pytest.fixture(scope="module")
def fixture_api(tmp_path_factory):
    api = Api(ServiceContext(Config(home=str(
        tmp_path_factory.mktemp("fixtures_home"))), device="cpu"))
    yield api
    api.ctx.close()


@pytest.mark.parametrize("name,fmt", FIXTURE_CASES)
def test_load_model_over_rest_predicts_tensorflows_outputs(
        fixture_api, float32, name, fmt):
    """``load_model`` of each committed fixture through ``POST /model``,
    then ``/predict``: TensorFlow's own predictions within 1e-5."""
    folder = os.path.join(FIXTURES, name)
    with open(os.path.join(folder, "meta.json")) as f:
        meta = json.load(f)
    x = np.load(os.path.join(folder, meta["x"]))
    want = np.load(os.path.join(folder, meta["want"]))
    model = f"{name}_{fmt}"
    for route, job, body in (
            ("/model/tensorflow", model, {
                "modelName": model, "modulePath": "tensorflow.keras.models",
                "class": "load_model", "classParameters": {
                    "path": os.path.join(folder, meta["formats"][fmt])}}),
            ("/predict/tensorflow", f"{model}_p", {
                "name": f"{model}_p", "modelName": model,
                "method": "predict",
                "methodParameters": {"x": x.tolist(),
                                     "batch_size": len(x)}})):
        status, answer = _call(fixture_api, "POST", route, body)
        assert status == 201, answer
        _wait(fixture_api, job, f"{route}/{job}")
    got = np.asarray(fixture_api.ctx.artifacts.load(
        f"{model}_p", "predict/tensorflow"))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_jax_only_methods_of_a_sequential_are_refused(fixture_api):
    status, answer = _call(fixture_api, "POST", "/model/tensorflow", {
        "modelName": "seq", "modulePath": "tensorflow.keras.models",
        "class": "Sequential", "classParameters": {"layers": [
            {"kind": "dense", "units": 2}]}})
    assert status == 201, answer
    _wait(fixture_api, "seq", "/model/tensorflow/seq")
    # sweep fusion runs now: a Sequential takes fit_sweep_fused, whose
    # job fails on the missing arguments as the JAX package's does
    status, answer = _call(fixture_api, "POST", "/train/tensorflow", {
        "name": "seq_f", "modelName": "seq", "method": "fit_sweep_fused",
        "methodParameters": {}})
    assert status == 201, answer
    fixture_api.ctx.jobs.wait("seq_f", timeout=60)
    status, body = _call(fixture_api, "GET", "/train/tensorflow/seq_f")
    assert body["metadata"]["finished"] is False
    assert "missing 3 required positional arguments" in \
        body["result"][-1]["exception"]
    for method in ("set_mesh",):
        status, answer = _call(fixture_api, "POST", "/train/tensorflow", {
            "name": "seq_t", "modelName": "seq", "method": method,
            "methodParameters": {}})
        assert status == 406
        assert answer["result"] == (f"invalid method name: {method} is not "
                                    f"yet ported to the PyTorch package")


def test_jax_sequential_artifact_loads_as_the_ports(tmp_path, float32):
    x = np.random.default_rng(5).normal(size=(4, 10, 10, 1)).astype(
        np.float32)
    jm = jax_models.Sequential(_cnn(jax_keras))
    jm._build_params(jm._coerce_x(x))
    JaxArtifactStore(str(tmp_path)).save(jm, "seq", "model/tensorflow")
    pm = ArtifactStore(str(tmp_path), device="cpu").load("seq")
    assert type(pm) is port_models.Sequential
    np.testing.assert_allclose(pm.predict(x, batch_size=4),
                               jm.predict(x, batch_size=4), atol=TOL, rtol=0)


# ----------------------------------------------------------------------
# the '#' DSL and the jail
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["subprocess", "restricted", "trusted"])
def test_hash_specs_cross_the_boundary(tmp_path, mode):
    cfg = Config(home=str(tmp_path / "home"))
    a, b, dense, loss = sandbox.eval_hash_expressions(
        ["#tensorflow.keras.optimizers.Adam(0.01)",
         "#tensorflow.keras.optimizers.Adam(0.01)",
         "#tensorflow.keras.layers.Dense(2, activation='softmax')",
         "#tensorflow.keras.losses.BinaryCrossentropy()"],
        mode=mode, config=cfg)
    assert type(a) is port_keras.optimizers.Adam and a is not b
    assert a.spec == b.spec == {"kind": "adam", "learning_rate": 0.01}
    assert type(dense) is port_keras.layers.Dense
    assert dense.config == {"kind": "dense", "units": 2,
                            "activation": "softmax"}
    assert loss.spec == "binary_crossentropy"


def test_hash_child_imports_no_torch(tmp_path, monkeypatch):
    """``#tensorflow.keras.layers.Dense(2)`` in the subprocess jail: the
    child's modules after the expression hold no torch (a probe value
    the child's encoder answers with them)."""
    boot = sandbox._CHILD_BOOT.replace(
        "sandbox._child_main(p)\n",
        "_encode = sandbox._encode_value\n"
        "sandbox._encode_value = lambda v, depth=0: sorted(\n"
        "    m for m in ('torch', 'numpy', 'learningorchestra_tpu_torch"
        ".models.tf_compat.keras.layers') if m in sys.modules)\\\n"
        "    if v == '__lo_modules__' else _encode(v, depth)\n"
        "sandbox._child_main(p)\n")
    monkeypatch.setattr(sandbox, "_CHILD_BOOT", boot)
    g, _ = sandbox.run_user_code(
        "spec = tensorflow.keras.layers.Dense(2)\n"
        "modules = '__lo_modules__'\n",
        mode="subprocess", config=Config(home=str(tmp_path / "home")))
    assert g["modules"] == [
        "learningorchestra_tpu_torch.models.tf_compat.keras.layers",
        "numpy"]
    assert type(g["spec"]) is port_keras.layers.Dense
    assert "tensorflow" not in g


def _reduce(callable_module: str, name: str, arg: str) -> bytes:
    """A pickle that calls ``module.name(arg)`` when loaded."""
    return (b"\x80\x02c" + callable_module.encode() + b"\n"
            + name.encode() + b"\nX" + len(arg).to_bytes(4, "little")
            + arg.encode() + b"\x85R.")


def test_forged_envelopes_reach_no_callable(tmp_path):
    marker = tmp_path / "fired"
    shim = "learningorchestra_tpu_torch.models.tf_compat.keras"
    forged = {
        "os.system": _reduce("os", "system", f"touch {marker}"),
        "posix.system": _reduce("posix", "system", f"touch {marker}"),
        "a function of the shim": _reduce(f"{shim}.models", "load_model",
                                          str(marker)),
        "the shim's ResNet50": _reduce(f"{shim}.applications", "ResNet50",
                                       str(marker)),
        "a module beside the shim": _reduce(
            "learningorchestra_tpu_torch.models.tf_compat_x", "Dense", "1"),
        "a missing module under the shim": _reduce(f"{shim}.nothing",
                                                   "Dense", "1"),
        "the JAX shim": _reduce(
            "learningorchestra_tpu.models.tf_compat.keras.layers", "Dense",
            "1"),
    }
    for what, raw in forged.items():
        for load in (sandbox._safe_load_envelope,
                     lambda r: sandbox._decode_value(
                         [sandbox._PICKLE_TAG, r])):
            with pytest.raises(pickle.UnpicklingError,
                               match="may not reference"):
                load(raw)
        assert not marker.exists(), what
    # a class of the shim resolves, its state as pickled
    spec = port_keras.optimizers.SGD(0.1, momentum=0.9)
    back = sandbox._decode_value([sandbox._PICKLE_TAG, pickle.dumps(spec)])
    assert type(back) is port_keras.optimizers.SGD
    assert back.spec == spec.spec
    envelope = pickle.dumps({"vars": {"s": sandbox._encode_value(spec)}})
    assert sandbox._safe_load_envelope(envelope)["vars"]["s"][0] == \
        sandbox._PICKLE_TAG
