"""The port's ``NeuralModel`` and its layer stack against the JAX package's.

One flax tree drives both packages: the JAX model's own init (its
``params`` and ``batch_stats``, perturbed so running statistics matter),
carried across by ``weights.params_from_flax(..., sequential=True)``.
Both compute in float32 on the CPU. Tolerances, as
``tests/test_ops.py`` states them: layer outputs and losses within 1e-5
(relative, with an absolute floor of 1e-5), parameters after training
within 5e-5; ResNet-50 within 1e-4 relative (16 convolutions and 17
batch norms deep, random weights give logits of 1e4, and in training
its last batch norms divide by the spread of a few samples a channel:
float32 summation order shows up to ~3e-5).

- every layer kind of ``SequentialModule`` (stride-2 ``"SAME"`` on odd
  sizes, ``flatten`` after a conv, both ``conv2d_transpose`` paddings,
  the recurrent kinds on both routes, ``LO_LSTM_HOIST=1``, ``resnet50``
  with stages ``[1, 1, 1, 1]`` at 32x32) in inference and training mode;
- ``batch_stats`` after one training step; 2-epoch fits for each
  optimizer kind (the adamw mask included); ``sample_weight``,
  ``class_weight`` and ``validation_split`` as ``tests/test_models.py``
  uses them; binary and MSE heads with precision and recall;
- artifacts and ``.npz`` weights in both directions, a checkpointed fit
  resumed equal to an uninterrupted one, and the refusals.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.catalog import ArtifactStore as JaxArtifactStore
from learningorchestra_tpu.models import sequential_module as jax_seq
from learningorchestra_tpu.models.neural import NeuralModel as JaxNeuralModel
from learningorchestra_tpu_torch.catalog import ArtifactStore
from learningorchestra_tpu_torch.models import NeuralModel, weights
from learningorchestra_tpu_torch.models import sequential_module as seq
from learningorchestra_tpu_torch.runtime.checkpoint import Checkpointer

torch.set_num_threads(2)

RTOL = ATOL = 1e-5   # float32 values
PARAM_ATOL = 5e-5    # float32 params after training (gradients)
RESNET_RTOL = 1e-4

CNN = [{"kind": "reshape", "shape": [8, 8, 1]},
       {"kind": "conv2d", "filters": 4, "kernel": [3, 3],
        "activation": "relu"},
       {"kind": "batchnorm"},
       {"kind": "maxpool2d"},
       {"kind": "flatten"},
       {"kind": "dense", "units": 16, "activation": "relu"},
       {"kind": "dense", "units": 3, "activation": "softmax"}]


@pytest.fixture()
def float32(monkeypatch):
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    jax_config.reset_config()
    yield
    jax_config.reset_config()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stats(jax_model_state) -> dict:
    return {"batch_stats." + k: v for k, v in weights.params_from_flax(
        _np(jax_model_state.get("batch_stats", {})),
        sequential=True).items()}


def _pair(configs, x, seed=0, **compile_kw):
    """The JAX model built on ``x`` and the port's model holding its
    tree, both compiled alike."""
    jm = JaxNeuralModel(configs)
    jm.seed = seed
    if compile_kw:
        jm.compile(**compile_kw)
    jm._build_params(jm._coerce_x(x))
    pm = NeuralModel(configs, device="cpu")
    pm.seed = seed
    if compile_kw:
        pm.compile(**compile_kw)
    pm.set_params(weights.params_from_flax(_np(jm.params), sequential=True),
                  _stats(jm.model_state), input_shape=jm.input_shape)
    return jm, pm


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ----------------------------------------------------------------------
# every layer kind, forward
# ----------------------------------------------------------------------
def _f(shape):
    return ("float", shape)


def _i(shape):
    return ("int", shape)


LAYERS = {
    "conv2d stride-2 SAME on odd sizes, flatten, dense": (
        [{"kind": "conv2d", "filters": 4, "kernel": [3, 3],
          "strides": [2, 2], "activation": "relu"},
         {"kind": "flatten"},
         {"kind": "dense", "units": 3, "activation": "softmax"}],
        _f((2, 7, 9, 3))),
    "conv2d VALID 5x5 stride 2": (
        [{"kind": "conv2d", "filters": 4, "kernel": [5, 5],
          "strides": [2, 2], "padding": "VALID", "activation": "tanh"},
         {"kind": "globalavgpool2d"}], _f((2, 11, 9, 2))),
    "conv2d 4x4 SAME (asymmetric at stride 1)": (
        [{"kind": "conv2d", "filters": 3, "kernel": [4, 4]},
         {"kind": "flatten"}], _f((2, 6, 5, 2))),
    "conv1d, maxpool1d, globalmaxpool1d": (
        [{"kind": "conv1d", "filters": 4, "kernel": 4, "strides": 2},
         {"kind": "maxpool1d"}, {"kind": "globalmaxpool1d"}],
        _f((2, 11, 3))),
    "conv1d VALID, globalavgpool1d": (
        [{"kind": "conv1d", "filters": 4, "kernel": [3], "padding": "VALID",
          "activation": "elu"}, {"kind": "globalavgpool1d"}],
        _f((2, 9, 3))),
    "maxpool2d, avgpool2d, globalavgpool2d": (
        [{"kind": "maxpool2d"},
         {"kind": "avgpool2d", "pool": [2, 2], "strides": [1, 1]},
         {"kind": "globalavgpool2d"}], _f((2, 9, 8, 3))),
    "conv2d_transpose SAME, globalmaxpool2d": (
        [{"kind": "conv2d_transpose", "filters": 4, "kernel": [3, 3],
          "strides": [2, 2], "activation": "relu"},
         {"kind": "globalmaxpool2d"}], _f((2, 5, 6, 3))),
    "conv2d_transpose SAME, kernel 4 stride 2": (
        [{"kind": "conv2d_transpose", "filters": 2, "kernel": [4, 4],
          "strides": [2, 2]}, {"kind": "flatten"}], _f((2, 3, 4, 2))),
    "conv2d_transpose SAME, kernel under stride": (
        [{"kind": "conv2d_transpose", "filters": 2, "kernel": [2, 2],
          "strides": [3, 3]}, {"kind": "flatten"}], _f((2, 3, 4, 2))),
    "conv2d_transpose VALID": (
        [{"kind": "conv2d_transpose", "filters": 4, "kernel": [3, 3],
          "strides": [2, 2], "padding": "VALID"}, {"kind": "flatten"}],
        _f((2, 5, 6, 3))),
    "embedding, lstm": (
        [{"kind": "embedding", "vocab": 12, "dim": 6},
         {"kind": "lstm", "units": 5},
         {"kind": "dense", "units": 2, "activation": "softmax"}],
        _i((3, 7))),
    "keras embedding keys, gru sequences, simple_rnn": (
        [{"kind": "embedding", "input_dim": 12, "output_dim": 6},
         {"kind": "gru", "units": 5, "return_sequences": True},
         {"kind": "simple_rnn", "units": 4}, {"kind": "dense", "units": 2}],
        _i((3, 7))),
    "simple_rnn gelu (the loop route), simple_rnn relu": (
        [{"kind": "simple_rnn", "units": 4, "activation": "gelu",
          "return_sequences": True},
         {"kind": "simple_rnn", "units": 4, "activation": "relu"}],
        _f((3, 7, 2))),
    "bidirectional_lstm": (
        [{"kind": "bidirectional_lstm", "units": 4},
         {"kind": "dense", "units": 1, "activation": "sigmoid"}],
        _f((3, 7, 2))),
    "bidirectional_gru sequences, lstm, bidirectional_lstm": (
        [{"kind": "bidirectional_gru", "units": 4, "return_sequences": True},
         {"kind": "lstm", "units": 3, "return_sequences": True},
         {"kind": "bidirectional_lstm", "units": 2}], _f((3, 7, 2))),
    "input, batchnorm, layernorm, activations, dropout, reshape": (
        [{"kind": "input"}, {"kind": "batchnorm"},
         {"kind": "layernorm"},
         {"kind": "dense", "units": 6, "activation": "leaky_relu"},
         {"kind": "activation", "fn": "gelu"},
         {"kind": "dense", "units": 6, "activation": "softplus"},
         {"kind": "dropout", "rate": 0.3},
         {"kind": "dense", "units": 6, "activation": "silu"},
         {"kind": "reshape", "shape": [3, 2]},
         {"kind": "activation", "fn": "softmax"}], _f((4, 5))),
    "resnet50 stages [1, 1, 1, 1] at 32x32": (
        [{"kind": "resnet50", "stages": [1, 1, 1, 1], "classes": 7}],
        _f((4, 32, 32, 3))),
}


def _data(spec, seed=0):
    kind, shape = spec
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, 12, size=shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


def _perturbed(variables):
    """The JAX init moved off its starting values (running statistics,
    biases and scales that are not 0 and 1)."""
    leaves, tree = jax.tree_util.tree_flatten(variables)
    rng = np.random.default_rng(7)
    out = []
    for leaf in leaves:
        noise = rng.normal(size=np.shape(leaf)).astype(np.float32) * 0.1
        out.append(np.abs(np.asarray(leaf) + noise) if leaf.ndim == 1
                   else np.asarray(leaf) + noise)
    return jax.tree_util.tree_unflatten(tree, out)


def _layer_case(case, train, monkeypatch):
    configs, spec = LAYERS[case]
    x = _data(spec)
    module = jax_seq.SequentialModule(tuple(configs))
    variables = _perturbed(module.init(jax.random.PRNGKey(1),
                                       jnp.asarray(x), train=False))
    port = seq.SequentialModule(configs, x.shape[1:])
    state = weights.params_from_flax(variables.get("params", {}),
                                     sequential=True)
    state.update(weights.params_from_flax(
        variables.get("batch_stats", {}), sequential=True))
    port.load_state_dict(state)
    updates = {}
    got = port(torch.from_numpy(x), train=train, updates=updates)
    if train:
        collections = [k for k in variables if k != "params"]
        want, new = module.apply(variables, jnp.asarray(x), train=True,
                                 mutable=collections)
        want_stats = weights.params_from_flax(
            _np(new.get("batch_stats", {})), sequential=True)
    else:
        want = module.apply(variables, jnp.asarray(x), train=False)
        want_stats = {}
    return got.detach().numpy(), np.asarray(want), updates, want_stats


@pytest.mark.parametrize("case", list(LAYERS))
def test_every_layer_kind_matches_jax(case, monkeypatch):
    """Inference-mode outputs (running statistics, no dropout)."""
    got, want, _, _ = _layer_case(case, False, monkeypatch)
    assert got.shape == want.shape
    rtol = RESNET_RTOL if "resnet" in case else RTOL
    _close(got, want, rtol=rtol)


@pytest.mark.parametrize("case", [
    "input, batchnorm, layernorm, activations, dropout, reshape",
    "resnet50 stages [1, 1, 1, 1] at 32x32"])
def test_training_mode_outputs_and_batch_stats_match_jax(case, monkeypatch):
    """Training mode: the batch's statistics normalize, and the new
    running statistics equal flax's mutated ``batch_stats``. The dropout
    layer is dropped here (the packages draw differently)."""
    if "dropout" in case:
        configs, spec = LAYERS[case]
        monkeypatch.setitem(LAYERS, case, (
            [c for c in configs if c["kind"] != "dropout"], spec))
    got, want, updates, want_stats = _layer_case(case, True, monkeypatch)
    rtol = RESNET_RTOL if "resnet" in case else RTOL
    _close(got, want, rtol=rtol, atol=rtol)
    assert sorted(updates) == sorted(want_stats) and want_stats
    for k, v in want_stats.items():
        _close(updates[k].numpy(), v.numpy(), rtol=rtol, atol=rtol)


def test_hoisted_lstm_matches_jax(monkeypatch):
    """``LO_LSTM_HOIST=1``: the keras-packed tree, named by the layer."""
    monkeypatch.setenv("LO_LSTM_HOIST", "1")
    configs = [{"kind": "lstm", "units": 5, "return_sequences": True},
               {"kind": "lstm", "units": 3}]
    monkeypatch.setitem(LAYERS, "hoisted", (configs, _f((3, 7, 2))))
    got, want, _, _ = _layer_case("hoisted", False, monkeypatch)
    _close(got, want)
    port = seq.SequentialModule(configs, (7, 2))
    assert sorted(port.state_dict()) == [
        f"lstm_{i}.{leaf}" for i in (0, 1)
        for leaf in ("bias", "kernel", "recurrent_kernel")]


def test_module_names_and_shapes_are_flax_tree():
    """Every layer kind's params and batch statistics have flax's paths
    and shapes (the recurrent cells by class and counter)."""
    for case, (configs, spec) in LAYERS.items():
        x = _data(spec)
        variables = jax_seq.SequentialModule(tuple(configs)).init(
            jax.random.PRNGKey(0), jnp.asarray(x), train=False)
        want = {}
        for collection in ("params", "batch_stats"):
            want.update({k: tuple(v.shape) for k, v in
                         weights.params_from_flax(_np(variables.get(
                             collection, {})), sequential=True).items()})
        port = seq.SequentialModule(configs, x.shape[1:])
        got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
        assert got == want, case


def test_rnn_routes_by_rule():
    assert seq.rnn_route("lstm") == seq.rnn_route("gru") == "fused"
    assert seq.rnn_route("simple_rnn", "relu") == "fused"
    assert seq.rnn_route("simple_rnn", "gelu") == "loop"


def test_unknown_kind_and_activation_raise_as_jax():
    for configs, words in (([{"kind": "warp"}], "unknown layer kind: 'warp'"),
                           ([{"kind": "dense", "units": 2,
                              "activation": "nope"}],
                            "unknown activation: 'nope'"),
                           ([{"kind": "embedding"}], "needs vocab/dim")):
        with pytest.raises(ValueError, match=words):
            jax_seq.SequentialModule(tuple(configs)).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 4)), train=False)
        with pytest.raises(ValueError, match=words):
            seq.SequentialModule(configs, (4,))


# ----------------------------------------------------------------------
# NeuralModel: fit, evaluate, predict
# ----------------------------------------------------------------------
def _pixels(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 64)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    return x, y


def _hold_fit(jm, pm, jhist, phist, keys=("loss",)):
    for key in keys:
        _close(phist[key], jhist[key])
    for k, v in weights.params_from_flax(_np(jm.params),
                                         sequential=True).items():
        _close(pm.params[k].detach().numpy(), v.numpy(), atol=PARAM_ATOL)
    for k, v in _stats(jm.model_state).items():
        _close(pm.model_state[k].numpy(), v.numpy(), atol=PARAM_ATOL)


def test_batch_stats_after_one_training_step_match_jax(float32):
    x, y = _pixels(16)
    jm, pm = _pair(CNN, x)
    jh = jm.fit(x, y, batch_size=16, epochs=1, shuffle=False).history
    ph = pm.fit(x, y, batch_size=16, epochs=1, shuffle=False).history
    assert set(pm.model_state) == {"batch_stats.batchnorm_2.mean",
                                   "batch_stats.batchnorm_2.var"}
    _hold_fit(jm, pm, jh, ph)
    assert not torch.equal(pm.model_state["batch_stats.batchnorm_2.var"],
                           torch.ones(4))


@pytest.mark.parametrize("optimizer", [
    {"kind": "adam", "learning_rate": 3e-3, "beta_1": 0.8},
    {"kind": "adamw", "learning_rate": 3e-3, "weight_decay": 0.1},
    {"kind": "sgd", "learning_rate": 0.05, "momentum": 0.9,
     "nesterov": True},
    {"kind": "rmsprop", "learning_rate": 3e-3, "rho": 0.8,
     "momentum": 0.5},
    {"kind": "adagrad", "learning_rate": 0.05}],
    ids=lambda o: o["kind"])
def test_fit_matches_jax_for_each_optimizer(float32, optimizer):
    """2 epochs of 4 steps: losses, accuracy, params and batch
    statistics; under adamw only matrices decay (the mask by ndim)."""
    x, y = _pixels()
    jm, pm = _pair(CNN, x, optimizer=optimizer)
    jh = jm.fit(x, y, batch_size=8, epochs=2, shuffle=False).history
    ph = pm.fit(x, y, batch_size=8, epochs=2, shuffle=False).history
    _hold_fit(jm, pm, jh, ph, keys=("loss", "accuracy"))
    assert ph["loss"][1] < ph["loss"][0]
    _close(pm.evaluate(x, y, batch_size=8)["loss"],
           jm.evaluate(x, y, batch_size=8)["loss"])
    _close(pm.predict(x, batch_size=8), jm.predict(x, batch_size=8))


def test_grad_accum_and_lstm_fit_match_jax(float32):
    """An IMDb-shaped body (embedding, lstm, softmax head) with
    grad_accum 2: the micro-batches' weighted gradients, as the JAX
    engine sums them."""
    rng = np.random.default_rng(3)
    x = rng.integers(1, 20, size=(32, 10)).astype(np.int32)
    y = (x[:, 0] > 10).astype(np.int32)
    body = [{"kind": "embedding", "vocab": 20, "dim": 8},
            {"kind": "lstm", "units": 8},
            {"kind": "dense", "units": 2, "activation": "softmax"}]
    jm, pm = _pair(body, x)
    jh = jm.fit(x, y, batch_size=16, epochs=2, shuffle=False,
                grad_accum=2).history
    ph = pm.fit(x, y, batch_size=16, epochs=2, shuffle=False,
                grad_accum=2).history
    _hold_fit(jm, pm, jh, ph)


FIT_OPTIONS = {
    "sample_weight": dict(sample_weight=np.linspace(0.1, 2.0, 32)),
    "class_weight": dict(class_weight={0: 3.0, 1: 0.5}),
    "class_weight and sample_weight": dict(
        class_weight={2: 2.0}, sample_weight=np.linspace(2.0, 0.5, 32)),
    "validation_split": dict(validation_split=0.25),
    "validation_split with sample_weight": dict(
        validation_split=0.25, sample_weight=np.linspace(0.1, 2.0, 32)),
    "validation_data": dict(validation_data=_pixels(16, seed=5)),
}


@pytest.mark.parametrize("case", list(FIT_OPTIONS))
def test_fit_options_match_jax(float32, case):
    """keras semantics as ``tests/test_models.py`` holds them: the tail
    split before any shuffle, the weights split with the data, class
    weights on the training loss only."""
    x, y = _pixels()
    jm, pm = _pair(CNN, x)
    kw = FIT_OPTIONS[case]
    jh = jm.fit(x, y, batch_size=8, epochs=2, shuffle=False, **kw).history
    ph = pm.fit(x, y, batch_size=8, epochs=2, shuffle=False, **kw).history
    # the JAX records also carry its roofline keys (tflopsPerSecPerChip...)
    assert set(ph) <= set(jh)
    assert {k for k in ph if k.startswith("val_")} == \
        {k for k in jh if k.startswith("val_")}
    _hold_fit(jm, pm, jh, ph, keys=[k for k in ph
                                    if k not in ("epoch", "epochSeconds",
                                                 "samplesPerSecond")])


def test_fit_option_errors_match_jax(float32):
    x, y = _pixels()
    for kw, words in ((dict(sample_weight=np.ones(5)), "sample_weight has 5"),
                      (dict(validation_split=1.5), "validation_split"),
                      (dict(class_weight={0: 2.0}, sample_weight=np.ones(5),
                            validation_split=0.25), "sample_weight has 0")):
        for model in _pair(CNN, x):
            with pytest.raises(ValueError, match=words):
                model.fit(x, y, batch_size=8, **kw)
    for model in _pair(CNN, x):
        with pytest.raises(ValueError, match="class_weight requires"):
            model.fit(x, class_weight={0: 1.0})


HEADS = {
    "binary": ([{"kind": "dense", "units": 8, "activation": "tanh"},
                {"kind": "dense", "units": 1, "activation": "sigmoid"}],
               dict(optimizer="adam", loss="binary_crossentropy",
                    metrics=["accuracy", "precision", "recall"])),
    "binary, two logits": (
        [{"kind": "dense", "units": 2}],
        dict(optimizer="sgd", loss="sparse_categorical_crossentropy",
             metrics=["acc", "precision", "recall"])),
    "mse": ([{"kind": "dense", "units": 8, "activation": "relu"},
             {"kind": "dense", "units": 1}],
            dict(optimizer={"kind": "adam", "learning_rate": 1e-2},
                 loss="mean_squared_error", metrics=[])),
}


@pytest.mark.parametrize("case", list(HEADS))
def test_binary_and_mse_heads_match_jax(float32, case):
    body, compile_kw = HEADS[case]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = (x[:, 0] + 0.3 * x[:, 1] > 0).astype(np.float32) \
        if case != "mse" else (x @ np.arange(6.0) / 6).astype(np.float32)
    jm, pm = _pair(body, x, **compile_kw)
    jh = jm.fit(x, y, batch_size=8, epochs=2, shuffle=False).history
    ph = pm.fit(x, y, batch_size=8, epochs=2, shuffle=False).history
    keys = ["loss"] + list(compile_kw["metrics"])
    _hold_fit(jm, pm, jh, ph, keys=keys)
    jev, pev = jm.evaluate(x, y, batch_size=8), pm.evaluate(x, y,
                                                            batch_size=8)
    assert sorted(pev) == sorted(jev)
    for k in jev:
        _close(pev[k], jev[k])
    _close(pm.predict(x, batch_size=8), jm.predict(x, batch_size=8))


def test_compile_and_metric_errors_match_jax(float32):
    x, y = _pixels()
    for model in _pair(CNN, x):
        with pytest.raises(ValueError, match="unknown loss: 'hinge'"):
            model.compile("adam", loss="hinge")
        with pytest.raises(ValueError, match="unknown metric: 'f1'"):
            model.compile("adam", metrics=["f1"])
        with pytest.raises(TypeError, match="unsupported optimizer"):
            model.compile(3)
        model.compile("adam", metrics=["precision"])
        with pytest.raises(ValueError, match="is binary"):
            model.fit(x, y, batch_size=8)
        model.compile("warp")
        with pytest.raises(ValueError, match="unknown optimizer: 'warp'"):
            model.fit(x, y, batch_size=8)


def test_unbuilt_model_and_out_of_range_ids():
    """``predict`` before a fit raises as JAX's does; token ids outside
    the embedding's vocabulary raise ValueError in the port (the JAX
    package takes them: ROADMAP Queue 3, deliberate item 3)."""
    for model in (JaxNeuralModel(CNN), NeuralModel(CNN, device="cpu")):
        with pytest.raises(RuntimeError, match="no parameters yet"):
            model.predict(np.zeros((2, 64), np.float32))
    body = [{"kind": "embedding", "vocab": 10, "dim": 4},
            {"kind": "globalavgpool1d"}, {"kind": "dense", "units": 2}]
    model = NeuralModel(body, device="cpu")
    for bad in (10, -1):
        x = np.zeros((4, 3), np.int64)
        x[1, 2] = bad
        with pytest.raises(ValueError, match=r"token ids must be in \[0, 10\)"):
            model.fit(x, np.zeros(4, np.int32), batch_size=4)
    model.fit(np.full((4, 3), 9), np.zeros(4, np.int32), batch_size=4)
    assert model.input_dtype == "int32"


def test_summary_num_params_and_add_match_jax(float32):
    x, _ = _pixels()
    jm, pm = _pair(CNN, x)
    assert pm.num_params() == jm.num_params() > 0
    assert pm.summary() == jm.summary()
    for model in (jm, pm):
        model.add({"kind": "dense", "units": 2})
        assert model.params is None and model.num_params() == 0
    assert pm.summary() == jm.summary()
    assert NeuralModel(CNN, device="cpu").output_activation == "softmax"


def test_port_init_has_flax_shapes_and_scales():
    """Without a JAX tree the port draws its own init from its seed:
    flax's shapes, lecun-normal kernels, orthogonal recurrent kernels,
    unit scales and variances."""
    body = [{"kind": "embedding", "vocab": 50, "dim": 16},
            {"kind": "gru", "units": 32}, {"kind": "batchnorm"},
            {"kind": "dense", "units": 64}]
    x = np.zeros((2, 5), np.int32)
    jm = JaxNeuralModel(body)
    jm._build_params(x)
    pm = NeuralModel(body, device="cpu")
    pm._build_params(pm._coerce_x(x))
    want = weights.params_from_flax(_np(jm.params), sequential=True)
    assert {k: tuple(v.shape) for k, v in pm.params.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    rec = pm.params["GRUCell_0.hr.kernel"].detach()
    torch.testing.assert_close(rec.T @ rec, torch.eye(32), atol=1e-5,
                               rtol=0)
    dense = pm.params["dense_3.kernel"].detach()
    assert abs(float(dense.std()) - 32 ** -0.5) < 0.02
    assert torch.equal(pm.model_state["batch_stats.batchnorm_2.var"],
                       torch.ones(32))
    again = NeuralModel(body, device="cpu")
    again._build_params(again._coerce_x(x))
    assert all(torch.equal(again.params[k], v)
               for k, v in pm.params.items())


# ----------------------------------------------------------------------
# artifacts, weights files, checkpoints
# ----------------------------------------------------------------------
BODIES = {"with batchnorm": CNN,
          "without batch statistics": [c for c in CNN
                                       if c["kind"] != "batchnorm"]}


@pytest.mark.parametrize("case", list(BODIES))
def test_artifacts_load_in_both_packages(tmp_path, float32, case):
    """A trained ``NeuralModel`` saved by either package loads in the
    other (``config.json`` and ``weights.msgpack`` of ``{"params",
    "model_state"}``) and predicts the same."""
    x, y = _pixels()
    jm, pm = _pair(BODIES[case], x)
    jm.fit(x, y, batch_size=8, epochs=1, shuffle=False)
    pm.fit(x, y, batch_size=8, epochs=1, shuffle=False)
    jstore = JaxArtifactStore(str(tmp_path / "jax"))
    pstore = ArtifactStore(str(tmp_path / "jax"), device="cpu")
    jstore.save(jm, "jm", "train/tensorflow")
    from_jax = pstore.load("jm")
    assert isinstance(from_jax, NeuralModel)
    _close(from_jax.predict(x, batch_size=8), jm.predict(x, batch_size=8))
    assert from_jax.history == jm.history
    # the JAX class reads the port's artifact dir (its meta.json names
    # the port's class, which the JAX store would import)
    native = os.path.join(pstore.save(pm, "pm", "train/tensorflow"),
                          "native")
    from_port = JaxNeuralModel.__lo_load__(native)
    _close(from_port.predict(x, batch_size=8), pm.predict(x, batch_size=8))
    saved = json.loads(open(os.path.join(native, "config.json")).read())
    assert saved["input_dtype"] == "float32" and saved["built"]
    # an unbuilt model round-trips as config alone
    native = os.path.join(pstore.save(NeuralModel(CNN, device="cpu"), "raw",
                                      "model/tensorflow"), "native")
    raw = JaxNeuralModel.__lo_load__(native)
    assert raw.params is None and raw.layer_configs == CNN


def test_npz_weights_load_in_both_packages(tmp_path, float32):
    x, y = _pixels()
    jm, pm = _pair(CNN, x)
    jm.fit(x, y, batch_size=8, epochs=1, shuffle=False)
    jm.save_weights(str(tmp_path / "j.npz"))
    fresh = NeuralModel(CNN, device="cpu")
    fresh.load_weights(str(tmp_path / "j.npz"), input_shape=[64])
    _close(fresh.predict(x, batch_size=8), jm.predict(x, batch_size=8))
    fresh.save_weights(str(tmp_path / "p.npz"))
    back = JaxNeuralModel(CNN)
    back.load_weights(str(tmp_path / "p.npz"), input_shape=[64])
    _close(back.predict(x, batch_size=8), jm.predict(x, batch_size=8))
    with pytest.raises(ValueError, match="not yet ported"):
        fresh.load_weights(str(tmp_path / "w.h5"))
    bad = NeuralModel(CNN[:-1] + [{"kind": "dense", "units": 5}],
                      device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        bad.load_weights(str(tmp_path / "p.npz"), input_shape=[64])


def test_checkpointed_fit_resumes_equal_to_uninterrupted(tmp_path, float32):
    """A 1-epoch checkpointed fit, then the same fit asked for 2 epochs
    from a fresh copy: it restores params, optimizer state and batch
    statistics and trains epoch 2 as the uninterrupted fit does, bit for
    bit. The step's saved form has the JAX engine's ``model_state``."""
    x, y = _pixels()
    _, base = _pair(CNN, x)
    store = ArtifactStore(str(tmp_path / "a"), device="cpu")
    store.save(base, "base", "model/tensorflow")

    def fresh():
        return store.load("base", "model/tensorflow")

    whole = fresh().fit(x, y, batch_size=8, epochs=2, shuffle=True).history
    ckpt = Checkpointer(str(tmp_path / "ck"))
    first = fresh()
    first.fit(x, y, batch_size=8, epochs=1, checkpointer=ckpt)
    resumed = fresh()
    hist = resumed.fit(x, y, batch_size=8, epochs=2,
                       checkpointer=Checkpointer(str(tmp_path / "ck")))
    assert hist.history["loss"] == [whole["loss"][1]]
    reference = fresh()
    reference.fit(x, y, batch_size=8, epochs=2)
    for k, v in reference.params.items():
        assert torch.equal(resumed.params[k], v), k
    for k, v in reference.model_state.items():
        assert torch.equal(resumed.model_state[k], v), k
    from learningorchestra_tpu_torch.runtime import serialization

    step = sorted(int(d) for d in os.listdir(tmp_path / "ck")
                  if d.isdigit())[-1]
    raw = serialization.msgpack_restore(
        (tmp_path / "ck" / str(step) / "checkpoint.msgpack").read_bytes())
    assert set(raw) == {"step", "params", "opt_state", "model_state"}
    assert set(raw["model_state"]["batch_stats"]["batchnorm_2"]) == \
        {"mean", "var"}
