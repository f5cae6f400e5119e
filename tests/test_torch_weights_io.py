"""Real keras artifacts through the port (``models/weights_io.py``,
``models/tf_bundle.py``, ``NeuralModel.from_*``/``to_keras``/
``save_keras``) against real keras and against the JAX package.

Each case builds a small model with stock keras 3 (``.weights.h5``
weights and ``.keras`` archives) or tf_keras (SavedModel directories and
legacy whole-model ``.h5`` files), saves it, reads the file with the
port and with the JAX package, and holds the port's predictions to
keras's own and to the JAX package's within 1e-5 (float32 on the CPU).
The layers: Dense, Conv2D, Conv1D, LSTM, GRU, SimpleRNN, Bidirectional,
BatchNormalization (with moving statistics that are not the identity),
LayerNormalization and Conv2DTranspose, as ``tests/test_weights_io.py``
covers them for the JAX package. Also: ``save_keras`` then stock
``keras.models.load_model`` predicts the same, ``load_model`` of the
shim routes every format, the JAX package's refusals hold (an unknown
layer, a non-default config, a directory without ``keras_metadata.pb``,
a model without the file's layers), and without h5py or keras each call
that needs one raises an ``ImportError`` naming it.

TensorFlow, keras and tf_keras are imported once for the file (a
module-scoped fixture builds every artifact).
"""

import os
import sys

import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.models import weights_io as jax_weights_io
from learningorchestra_tpu.models.neural import NeuralModel as JaxNeuralModel
from learningorchestra_tpu_torch.models import weights_io
from learningorchestra_tpu_torch.models.neural import NeuralModel
from learningorchestra_tpu_torch.models.tf_compat.keras import models as shim

torch.set_num_threads(2)

TOL = 1e-5


@pytest.fixture(scope="module")
def float32(tmp_path_factory):
    old = os.environ.get("LO_COMPUTE_DTYPE")
    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    jax_config.set_config(jax_config.Config(
        home=str(tmp_path_factory.mktemp("jax_home")),
        compute_dtype="float32"))
    yield
    jax_config.reset_config()
    if old is None:
        os.environ.pop("LO_COMPUTE_DTYPE", None)
    else:
        os.environ["LO_COMPUTE_DTYPE"] = old


def _stats(model, rng) -> None:
    """Moving statistics of every batch norm, drawn from ``rng``."""
    for layer in model.layers:
        if type(layer).__name__ == "BatchNormalization":
            gamma, beta, mean, var = layer.get_weights()
            layer.set_weights([
                rng.normal(1.0, 0.2, gamma.shape).astype(np.float32),
                rng.normal(0.0, 0.2, beta.shape).astype(np.float32),
                rng.normal(0.0, 0.5, mean.shape).astype(np.float32),
                rng.uniform(0.5, 2.0, var.shape).astype(np.float32)])


def _floats(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _ids(rng, shape, vocab=30):
    return rng.integers(0, vocab, size=shape).astype(np.int32)


# the configs of the port (and the JAX package) for the .weights.h5 cases
DENSE = [{"kind": "dense", "units": 8, "activation": "relu"},
         {"kind": "dense", "units": 3, "activation": "softmax"}]
CONV_BN = [{"kind": "conv2d", "filters": 4, "kernel": [3, 3],
            "padding": "SAME", "activation": "relu"},
           {"kind": "batchnorm"}, {"kind": "flatten"},
           {"kind": "dense", "units": 6, "activation": "relu"},
           {"kind": "dense", "units": 2}]
LSTM = [{"kind": "embedding", "vocab": 30, "dim": 8},
        {"kind": "lstm", "units": 5},
        {"kind": "dense", "units": 3, "activation": "softmax"}]


def _cases(keras, tfk):
    """name -> (format, keras model, input, port configs for the
    weights-only format)."""
    kl, tl = keras.layers, tfk.layers
    rng = np.random.default_rng(19)
    cases = {
        # keras 3 weights files, loaded into a model of the same configs
        "h5 dense": ("h5", keras.Sequential([
            kl.Input((6,)), kl.Dense(8, activation="relu"),
            kl.Dense(3, activation="softmax")]), _floats(rng, (5, 6)),
            DENSE),
        "h5 conv + batchnorm": ("h5", keras.Sequential([
            kl.Input((8, 8, 3)),
            kl.Conv2D(4, 3, padding="same", activation="relu"),
            kl.BatchNormalization(), kl.Flatten(),
            kl.Dense(6, activation="relu"), kl.Dense(2)]),
            _floats(rng, (3, 8, 8, 3)), CONV_BN),
        "h5 lstm": ("h5", keras.Sequential([
            kl.Input((7,)), kl.Embedding(30, 8), kl.LSTM(5),
            kl.Dense(3, activation="softmax")]), _ids(rng, (4, 7)), LSTM),
        # keras 3 archives: architecture and weights
        "keras gru + simple_rnn": ("keras", keras.Sequential([
            kl.Input((7,)), kl.Embedding(30, 6),
            kl.GRU(5, return_sequences=True),
            kl.SimpleRNN(4, activation="relu"),
            kl.Dense(2, activation="softmax")]), _ids(rng, (4, 7)), None),
        "keras bidirectional": ("keras", keras.Sequential([
            kl.Input((6,)), kl.Embedding(30, 4),
            kl.Bidirectional(kl.LSTM(3, return_sequences=True)),
            kl.Bidirectional(kl.GRU(3)),
            kl.Dense(2, activation="softmax")]), _ids(rng, (4, 6)), None),
        "keras conv transpose + layernorm": ("keras", keras.Sequential([
            kl.Input((5, 5, 2)),
            kl.Conv2DTranspose(3, 3, strides=2, padding="same",
                               activation="relu"),
            kl.LayerNormalization(),
            kl.Flatten(), kl.Dense(4)]),
            _floats(rng, (3, 5, 5, 2)), None),
        # (keras 3 writes MaxPooling1D's pool_size as a list, which the
        # JAX shim's int() refuses: ROADMAP Queue 3 item 31)
        "keras conv1d + pools": ("keras", keras.Sequential([
            kl.Input((12, 3)), kl.Conv1D(4, 3, activation="relu"),
            kl.GlobalMaxPooling1D(), kl.Dense(2)]),
            _floats(rng, (4, 12, 3)), None),
        # tf_keras SavedModel directories
        "savedmodel cnn": ("savedmodel", tfk.Sequential([
            tl.Conv2D(4, (3, 3), activation="relu", input_shape=(8, 8, 1)),
            tl.MaxPooling2D(), tl.Flatten(),
            tl.Dense(10, activation="relu"),
            tl.Dense(2, activation="softmax")]),
            _floats(rng, (4, 8, 8, 1)), None),
        "savedmodel rnn stack": ("savedmodel", tfk.Sequential([
            tl.Embedding(30, 5, input_length=9),
            tl.Bidirectional(tl.LSTM(4, return_sequences=True)),
            tl.GRU(3), tl.BatchNormalization(),
            tl.Dense(2, activation="softmax")]), _ids(rng, (4, 9)), None),
        # tf_keras legacy whole-model files
        "legacy h5 dense": ("legacy", tfk.Sequential([
            tl.Dense(8, activation="relu", input_shape=(6,)),
            tl.Dense(3, activation="softmax")]), _floats(rng, (5, 6)),
            None),
        "legacy h5 bidirectional": ("legacy", tfk.Sequential([
            tl.Embedding(20, 4, input_length=7),
            tl.Bidirectional(tl.LSTM(3)),
            tl.Dense(2, activation="softmax")]), _ids(rng, (4, 7), 20),
            None),
    }
    for fmt, km, x, _ in cases.values():
        if fmt in ("savedmodel", "legacy"):
            km.build((None,) + x.shape[1:])
        _stats(km, rng)
    return cases


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, float32):
    """Every case written by keras: name -> (path, format, input, keras's
    predictions, configs); plus the two libraries."""
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
    tf = pytest.importorskip("tensorflow")
    # two threads, as torch here: the other test workers share the cores.
    # TensorFlow fixes its pools when its context starts, and another file
    # of the same process (tests/test_weights_io.py under xdist's loadfile)
    # may have started it already: then the pools stay as they are.
    try:
        tf.config.threading.set_intra_op_parallelism_threads(2)
        tf.config.threading.set_inter_op_parallelism_threads(2)
    except RuntimeError:
        pass
    keras = pytest.importorskip("keras")
    tfk = pytest.importorskip("tf_keras")
    root = tmp_path_factory.mktemp("keras_artifacts")
    out = {}
    for i, (name, (fmt, km, x, configs)) in enumerate(
            _cases(keras, tfk).items()):
        want = np.asarray(km(x, training=False))
        path = str(root / f"case{i}")
        if fmt == "h5":
            path += ".weights.h5"
            km.save_weights(path)
        elif fmt == "keras":
            path += ".keras"
            km.save(path)
        elif fmt == "savedmodel":
            # without traced functions (keras's save_traces=False, as
            # scripts/make_keras_fixtures.py writes): the readers take the
            # layers from keras_metadata.pb, and tracing an RNN costs
            # seconds (tests/test_weights_io.py reads traced ones)
            km.save(path, save_format="tf", save_traces=False)
        else:
            path += ".h5"
            km.save(path, save_format="h5")
        out[name] = (path, fmt, x, want, configs)
    return keras, out


READERS = {"keras": "from_keras", "savedmodel": "from_savedmodel",
           "legacy": "from_legacy_h5"}


def _port(path, fmt, x, configs) -> NeuralModel:
    """The port's model from one file."""
    if fmt == "h5":
        pm = NeuralModel(configs, device="cpu")
        pm.load_weights(path, input_shape=x.shape[1:])
        return pm
    return getattr(NeuralModel, READERS[fmt])(path, device="cpu")


def _jax(path, fmt, x, configs) -> JaxNeuralModel:
    if fmt == "h5":
        jm = JaxNeuralModel(configs)
        jm.load_weights(path, input_shape=x.shape[1:])
        return jm
    return getattr(JaxNeuralModel, READERS[fmt])(path)


CASES = ["h5 dense", "h5 conv + batchnorm", "h5 lstm",
         "keras gru + simple_rnn", "keras bidirectional",
         "keras conv transpose + layernorm", "keras conv1d + pools",
         "savedmodel cnn", "savedmodel rnn stack", "legacy h5 dense",
         "legacy h5 bidirectional"]


# one case of each format also predicts through the JAX package (its
# compile costs seconds a model here); every case holds the JAX package's
# layer configs
THROUGH_JAX = ("h5 dense", "keras conv transpose + layernorm",
               "savedmodel cnn", "legacy h5 bidirectional")


@pytest.mark.parametrize("case", CASES)
def test_real_keras_files_predict_as_keras_and_as_jax(artifacts, case):
    _, cases = artifacts
    path, fmt, x, want, configs = cases[case]
    pm = _port(path, fmt, x, configs)
    got = pm.predict(x, batch_size=len(x))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    if case in THROUGH_JAX:
        jm = _jax(path, fmt, x, configs)
        assert pm.layer_configs == jm.layer_configs
        np.testing.assert_allclose(got, jm.predict(x, batch_size=len(x)),
                                   atol=TOL, rtol=0)
    elif fmt != "h5":
        read = {"keras": jax_weights_io.read_keras_archive,
                "savedmodel": jax_weights_io.read_savedmodel,
                "legacy": jax_weights_io.read_legacy_h5_model}[fmt]
        jax_configs, jax_shape = read(path)[:2]
        assert pm.layer_configs == jax_configs
        assert pm.input_shape == list(jax_shape)


@pytest.mark.parametrize("case", ["keras bidirectional", "savedmodel cnn",
                                  "legacy h5 dense"])
def test_shim_load_model_routes_every_format(artifacts, case):
    _, cases = artifacts
    path, _, x, want, _ = cases[case]
    model = shim.load_model(path, device="cpu")
    assert isinstance(model, NeuralModel)
    np.testing.assert_allclose(model.predict(x, batch_size=len(x)), want,
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("case", ["keras gru + simple_rnn",
                                  "keras bidirectional",
                                  "savedmodel rnn stack",
                                  "keras conv transpose + layernorm"])
def test_save_keras_loads_in_stock_keras(artifacts, tmp_path, case):
    """``save_keras`` writes an archive stock keras opens and predicts
    with as the port does; the port's ``from_keras`` of it too."""
    keras, cases = artifacts
    path, fmt, x, _, configs = cases[case]
    pm = _port(path, fmt, x, configs)
    out = str(tmp_path / "exported.keras")
    pm.save_keras(out)
    got = pm.predict(x, batch_size=len(x))
    again = keras.models.load_model(out)
    np.testing.assert_allclose(np.asarray(again(x, training=False)), got,
                               atol=TOL, rtol=0)
    back = NeuralModel.from_keras(out, device="cpu")
    np.testing.assert_allclose(back.predict(x, batch_size=len(x)), got,
                               atol=1e-6, rtol=0)


def test_refusals_are_the_jax_packages(artifacts, tmp_path):
    keras, cases = artifacts
    kl = keras.layers
    refused = {
        "unknown layer": keras.Sequential([
            kl.Input((4,)), kl.UnitNormalization(), kl.Dense(2)]),
        "non-default config": keras.Sequential([
            kl.Input((8, 8, 1)), kl.Conv2D(2, 3, dilation_rate=2),
            kl.Flatten(), kl.Dense(2)]),
        "padded pooling": keras.Sequential([
            kl.Input((8, 8, 1)), kl.MaxPooling2D(padding="same"),
            kl.Flatten(), kl.Dense(2)]),
    }
    for what, km in refused.items():
        path = str(tmp_path / f"{what.replace(' ', '_')}.keras")
        km.save(path)
        messages = []
        for cls in (NeuralModel, JaxNeuralModel):
            with pytest.raises(ValueError) as err:
                cls.from_keras(path)
            messages.append(str(err.value))
        assert messages[0] == messages[1], what
    # a SavedModel directory without keras_metadata.pb
    plain = tmp_path / "plain_sm"
    plain.mkdir()
    (plain / "saved_model.pb").write_bytes(b"\x08\x01")
    for cls in (NeuralModel, JaxNeuralModel):
        with pytest.raises(ValueError, match="keras_metadata"):
            cls.from_savedmodel(str(plain))
    # a weights file with a layer the model does not declare, and one
    # whose shapes are not the model's
    messages = []
    for configs, shape in ((DENSE[:1], (6,)), (DENSE, (3, 8))):
        for cls, kw in ((NeuralModel, {"device": "cpu"}),
                        (JaxNeuralModel, {})):
            with pytest.raises(ValueError) as err:
                cls(configs, **kw).load_weights(cases["h5 dense"][0],
                                                input_shape=shape)
            messages.append(str(err.value))
    assert messages[0] == messages[1] and "does not declare" in messages[0]
    assert messages[2] == messages[3] and "h5 has shape" in messages[2]


def test_bfloat16_bundle_tensors_widen_to_float32(tmp_path, artifacts):
    """A bfloat16 variable of a SavedModel bundle reads as float32 with
    the same values (the JAX reader gives an ml_dtypes array)."""
    import tensorflow as tf

    from learningorchestra_tpu.models import tf_bundle as jax_bundle
    from learningorchestra_tpu_torch.models import tf_bundle

    values = np.array([1.5, -2.25, 3.0e-3, 65504.0], np.float32)
    ckpt = tf.train.Checkpoint(v=tf.Variable(tf.constant(
        values, dtype=tf.bfloat16)))
    prefix = ckpt.write(str(tmp_path / "ckpt"))
    got = tf_bundle.read_bundle(prefix)
    want = jax_bundle.read_bundle(prefix)
    key = next(k for k in want if k.startswith("v/"))
    assert got[key].dtype == np.float32
    np.testing.assert_array_equal(got[key],
                                  np.asarray(want[key], np.float32))


def test_without_h5py_or_keras_the_calls_name_them(artifacts, monkeypatch,
                                                   tmp_path):
    _, cases = artifacts
    h5_path = cases["h5 dense"][0]
    archive = cases["keras bidirectional"][0]
    legacy = cases["legacy h5 dense"][0]
    saved = cases["savedmodel cnn"]
    model = NeuralModel(DENSE, device="cpu")
    model.load_weights(h5_path, input_shape=(6,))
    monkeypatch.setitem(sys.modules, "h5py", None)
    for call in (lambda: NeuralModel(DENSE, device="cpu").load_weights(
                     h5_path, input_shape=(6,)),
                 lambda: NeuralModel.from_keras(archive, device="cpu"),
                 lambda: NeuralModel.from_legacy_h5(legacy, device="cpu"),
                 lambda: shim.load_model(legacy, device="cpu")):
        with pytest.raises(ImportError, match="'h5py'") as err:
            call()
        assert err.value.name == "h5py"
    # the SavedModel reader needs numpy alone
    sm = NeuralModel.from_savedmodel(saved[0], device="cpu")
    np.testing.assert_allclose(sm.predict(saved[2], batch_size=4), saved[3],
                               atol=TOL, rtol=0)
    # a store artifact never reaches h5py
    model.__lo_save__(str(tmp_path))
    assert isinstance(shim.load_model(str(tmp_path), device="cpu"),
                      NeuralModel)
    monkeypatch.setitem(sys.modules, "keras", None)
    for call in (lambda: model.to_keras(),
                 lambda: model.save_keras(str(tmp_path / "m.keras"))):
        with pytest.raises(ImportError, match="'keras'") as err:
            call()
        assert err.value.name == "keras"
    assert weights_io.is_legacy_h5_model(str(tmp_path)) is False
