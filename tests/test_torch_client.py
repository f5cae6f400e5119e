"""The tutorial's three workflows (``docs/TUTORIAL.md:22-120``) as written,
each package's server driven over HTTP by its own client
(``learningorchestra_tpu.client`` and ``learningorchestra_tpu_torch.
client``), on the CPU, with data of the published shapes made from a
seed with numpy: a Titanic-like CSV (891 rows of Pclass, Age with blanks,
SibSp, Parch, Fare, Survived), a 785-column MNIST-like CSV and an
``imdb_tokens`` function step that writes ids below 20000.

Held:

- the function artifacts equal, exactly, and ``ctx.wait`` returns through
  ``GET /observe`` (the long-poll, not the metadata poll);
- the LogisticRegression ``score`` equal, exactly (the same sklearn on
  the same arrays);
- with the stored CNN and LSTM holding one JAX tree, their epoch losses
  within 1e-5 relative (float32; ``tests/test_torch_neural.py``);
- the classifier's REST ``fit`` on ``$imdb_tokens.x`` (2 layers, d_model
  64, ``dot`` attention, float32, SGD: ``tests/test_torch_classifier.py``'s
  parity test) with weights carried across by ``params_from_flax``: its
  losses within 1e-5 relative;
- a route the port lacks answers through the client as the server does,
  and the histogram, cancel and function-timeout calls the port lacked
  until its lifecycle and explore routes came answer as the JAX
  package's through its client.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu import native as jax_native
from learningorchestra_tpu.models import transformer as jax_tlm
from learningorchestra_tpu.models.neural import NeuralModel as JaxNM
from learningorchestra_tpu_torch import client as port_client
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import (NeuralModel, TextClassifier,
                                                weights)
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import RestServer

torch.set_num_threads(2)

RTOL = 1e-5
MNIST_ROWS = 256
IMDB_ROWS = 128

# the tutorial's bodies, as written
TITANIC_PREP = (
    "import numpy as np\n"
    "df = df.dropna(subset=['Age'])\n"
    "x = df[['Pclass', 'Age', 'SibSp', 'Parch', 'Fare']]"
    ".to_numpy('float32')\n"
    "y = df['Survived'].to_numpy('int32')\n"
    "response = {'x': x, 'y': y}\n")
MNIST_ARRAYS = (
    "import numpy as np\n"
    "x = df.drop(columns=['label']).to_numpy('float32') / 255.0\n"
    "y = df['label'].to_numpy('int32')\n"
    "response = {'x': x, 'y': y}\n")
# the step the tutorial reads as $imdb_tokens and does not show
IMDB_TOKENS = (
    "import numpy as np\n"
    "rng = np.random.default_rng(seed)\n"
    "x = rng.integers(1, 20000, size=(rows, seq)).astype('int32')\n"
    "y = (x[:, 0] % 2).astype('int32')\n"
    "response = {'x': x, 'y': y}\n")
CNN = [{"kind": "reshape", "shape": [28, 28, 1]},
       {"kind": "conv2d", "filters": 32, "kernel": [3, 3],
        "activation": "relu"},
       {"kind": "maxpool2d"},
       {"kind": "flatten"},
       {"kind": "dense", "units": 128, "activation": "relu"},
       {"kind": "dense", "units": 10, "activation": "softmax"}]
LSTM = [{"kind": "embedding", "vocab": 20000, "dim": 128},
        {"kind": "lstm", "units": 128},
        {"kind": "dense", "units": 2, "activation": "softmax"}]
CLF = {"vocab_size": 20000, "n_classes": 2, "d_model": 64, "n_layers": 2,
       "n_heads": 8, "n_kv_heads": 4, "max_len": 512, "attention": "dot"}
MODELS = "learningorchestra_tpu.models"


def _titanic(path) -> str:
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        f.write("Pclass,Age,SibSp,Parch,Fare,Survived\n")
        for _ in range(891):
            pclass = int(rng.integers(1, 4))
            age = "" if rng.random() < 0.2 else f"{rng.uniform(0.4, 80):.1f}"
            fare = rng.gamma(2.0, 40.0 / pclass)
            survived = int(rng.random() < 0.75 - 0.2 * pclass + fare / 400)
            f.write(f"{pclass},{age},{int(rng.integers(0, 6))},"
                    f"{int(rng.integers(0, 5))},{fare:.4f},{survived}\n")
    return str(path)


def _mnist(path) -> str:
    rng = np.random.default_rng(8)
    labels = rng.integers(0, 10, MNIST_ROWS)
    pixels = rng.integers(0, 256, (MNIST_ROWS, 784))
    with open(path, "w") as f:
        f.write("label," + ",".join(f"pixel{i}" for i in range(784)) + "\n")
        for label, row in zip(labels, pixels):
            f.write(f"{label}," + ",".join(map(str, row)) + "\n")
    return str(path)


def _paired_neural(configs, x):
    jm = JaxNM(configs)
    jm._build_params(jm._coerce_x(x))
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    pm = NeuralModel(configs, device="cpu")
    pm.set_params(weights.params_from_flax(tree, sequential=True),
                  input_shape=jm.input_shape)
    return jm, pm


def _paired_classifier():
    config = {k: v for k, v in CLF.items() if k != "attention"}
    tree = weights.init_params(config, 0)
    jclf = jax_tlm.TextClassifier(**CLF)
    jclf.params = jax.tree_util.tree_map(jnp.asarray, tree)
    clf = TextClassifier(**CLF, device="cpu")
    clf.set_params(weights.params_from_flax(tree))
    for model in (jclf, clf):
        model.compile({"kind": "sgd", "learning_rate": 0.1})
    return jclf, clf


class _WaitCounter:
    """Counts the client's observe long-polls and metadata reads."""

    def __init__(self, ctx, tool_cls):
        self.observes = 0
        self.metadata_reads = 0
        observe = ctx.observe

        def counted(*args, **kwargs):
            self.observes += 1
            return observe(*args, **kwargs)

        ctx.observe = counted
        metadata = tool_cls.metadata

        def counted_metadata(tool, name):
            self.metadata_reads += 1
            return metadata(tool, name)

        self._patch = (tool_cls, metadata)
        tool_cls.metadata = counted_metadata

    def close(self):
        tool_cls, metadata = self._patch
        tool_cls.metadata = metadata


def _losses(ctx, tool, name):
    docs = tool.read(name)["result"]
    return [d["epochRecord"]["loss"] for d in docs if "epochRecord" in d]


def _workflows(ctx, store, files, pairs):
    """Workflows 1-3 of docs/TUTORIAL.md through ``ctx``; ``store`` is
    the server's artifact store (for the shared weights)."""
    out = {}
    # 1. Titanic -> LogisticRegression
    ctx.dataset_csv.insert("titanic", files["titanic"])
    out["titanic"] = ctx.wait("titanic")
    ctx.function_python.run_function("titanic_prep", TITANIC_PREP,
                                     {"df": "$titanic"})
    ctx.wait("titanic_prep")
    ctx.model_scikitlearn.create("lr", "sklearn.linear_model",
                                 "LogisticRegression", {"max_iter": 500})
    ctx.wait("lr")
    ctx.train_scikitlearn.run("lr_t", "lr", "fit", {
        "X": "$titanic_prep.x", "y": "$titanic_prep.y"})
    ctx.wait("lr_t")
    ctx.evaluate_scikitlearn.run("lr_e", "lr_t", "score", {
        "X": "$titanic_prep.x", "y": "$titanic_prep.y"})
    ctx.wait("lr_e")
    out["score"] = [d["result"] for d in ctx.evaluate_scikitlearn.read(
        "lr_e", limit=5)["result"] if "result" in d]

    # 2. MNIST -> CNN
    ctx.dataset_csv.insert("mnist", files["mnist"])
    ctx.wait("mnist")
    ctx.function_python.run_function("mnist_arrays", MNIST_ARRAYS,
                                     {"df": "$mnist"})
    ctx.wait("mnist_arrays")
    ctx.model_tensorflow.create("cnn", MODELS, "NeuralModel",
                                {"layer_configs": CNN})
    ctx.wait("cnn")
    store.save(pairs["cnn"], "cnn", "model/tensorflow")
    ctx.train_tensorflow.run(
        "cnn_t", "cnn", "fit",
        {"x": "$mnist_arrays.x", "y": "$mnist_arrays.y", "epochs": 4,
         "batch_size": 256, "checkpoint": True})
    ctx.wait("cnn_t")
    ctx.evaluate_tensorflow.run(
        "cnn_e", "cnn_t", "evaluate",
        {"x": "$mnist_arrays.x", "y": "$mnist_arrays.y"})
    out["cnn_e"] = ctx.wait("cnn_e")
    out["cnn_losses"] = _losses(ctx, ctx.train_tensorflow, "cnn_t")

    # 3. IMDb -> LSTM, and the classifier on the same tokens
    ctx.function_python.run_function(
        "imdb_tokens", IMDB_TOKENS,
        {"rows": IMDB_ROWS, "seq": 200, "seed": 0})
    ctx.wait("imdb_tokens")
    ctx.model_tensorflow.create("lstm", MODELS, "NeuralModel",
                                {"layer_configs": LSTM})
    ctx.wait("lstm")
    store.save(pairs["lstm"], "lstm", "model/tensorflow")
    ctx.train_tensorflow.run(
        "lstm_t", "lstm", "fit",
        {"x": "$imdb_tokens.x", "y": "$imdb_tokens.y", "epochs": 3,
         "batch_size": 128})
    ctx.wait("lstm_t")
    out["lstm_losses"] = _losses(ctx, ctx.train_tensorflow, "lstm_t")
    ctx.model_tensorflow.create("clf", MODELS, "TextClassifier", CLF)
    ctx.wait("clf")
    store.save(pairs["clf"], "clf", "model/tensorflow")
    ctx.train_tensorflow.run(
        "clf_t", "clf", "fit",
        {"x": "$imdb_tokens.x", "y": "$imdb_tokens.y", "epochs": 2,
         "batch_size": 128, "shuffle": False})
    ctx.wait("clf_t")
    out["clf_losses"] = _losses(ctx, ctx.train_tensorflow, "clf_t")
    for name in ("titanic_prep", "mnist_arrays", "imdb_tokens"):
        out[name] = store.load(name, "function/python")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tutorial")
    files = {"titanic": _titanic(root / "titanic.csv"),
             "mnist": _mnist(root / "mnist.csv")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LO_COMPUTE_DTYPE", "float32")
        # the JAX ingest takes its pyarrow reader, the port's reference
        mp.setattr(jax_native, "available", lambda: False)
        jax_config.set_config(jax_config.Config(home=str(root / "jax")))
        from learningorchestra_tpu import client as jax_client
        from learningorchestra_tpu.services.server import \
            RestServer as JaxRestServer

        # the stored models' shared weights, from the function steps'
        # arrays (equal in both packages: test_function_artifacts_equal)
        rng = np.random.default_rng(8)
        rng.integers(0, 10, MNIST_ROWS)
        pixels = rng.integers(0, 256, (MNIST_ROWS, 784))
        jcnn, pcnn = _paired_neural(CNN, (pixels / 255.0).astype(np.float32))
        tokens = np.random.default_rng(0).integers(
            1, 20000, size=(IMDB_ROWS, 200)).astype(np.int32)
        jlstm, plstm = _paired_neural(LSTM, tokens)
        jclf, pclf = _paired_classifier()
        servers = (JaxRestServer(host="127.0.0.1", port=0).start(),
                   RestServer(host="127.0.0.1", port=0,
                              context=ServiceContext(
                                  Config(home=str(root / "port")),
                                  device="cpu")).start())
        outs, waits = [], []
        try:
            for srv, lib, pairs in (
                    (servers[0], jax_client,
                     {"cnn": jcnn, "lstm": jlstm, "clf": jclf}),
                    (servers[1], port_client,
                     {"cnn": pcnn, "lstm": plstm, "clf": pclf})):
                ctx = lib.Context(srv.base_url)
                counter = _WaitCounter(ctx, lib.Tool)
                try:
                    t0 = time.monotonic()
                    outs.append(_workflows(ctx, srv.api.ctx.artifacts,
                                           files, pairs))
                    outs[-1]["seconds"] = time.monotonic() - t0
                finally:
                    counter.close()
                waits.append(counter)
            yield outs, waits, servers
        finally:
            for srv in servers:
                srv.stop()
            jax_config.reset_config()


def test_function_artifacts_equal_jax_exactly(runs):
    (want, got), _, _ = runs
    for name in ("titanic_prep", "mnist_arrays", "imdb_tokens"):
        assert set(got[name]) == set(want[name]) == {"x", "y"}
        for key in ("x", "y"):
            assert got[name][key].dtype == np.asarray(want[name][key]).dtype
            np.testing.assert_array_equal(got[name][key], want[name][key])
    x = got["titanic_prep"]["x"]
    assert x.shape[1] == 5 and 600 < len(x) < 800  # the blank ages dropped
    assert got["mnist_arrays"]["x"].shape == (MNIST_ROWS, 784)
    assert got["imdb_tokens"]["x"].max() < 20000
    assert got["titanic"]["rows"] == want["titanic"]["rows"] == 891


def test_logistic_regression_score_equals_jax_exactly(runs):
    (want, got), _, _ = runs
    assert got["score"] == want["score"]
    assert len(got["score"]) == 1 and 0.5 < got["score"][0] <= 1.0


def test_cnn_and_lstm_losses_match_jax(runs):
    (want, got), _, _ = runs
    for key, epochs in (("cnn_losses", 4), ("lstm_losses", 3)):
        assert len(got[key]) == len(want[key]) == epochs
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)
    assert got["cnn_e"]["finished"] and want["cnn_e"]["finished"]


def test_classifier_rest_fit_on_function_tokens_matches_jax(runs):
    (want, got), _, _ = runs
    assert len(got["clf_losses"]) == len(want["clf_losses"]) == 2
    np.testing.assert_allclose(got["clf_losses"], want["clf_losses"],
                               rtol=RTOL)


def test_wait_returns_through_observe(runs):
    """Every ``ctx.wait`` of the workflows long-polled ``/observe``; none
    fell back to reading metadata."""
    _, waits, _ = runs
    for counter in waits:
        assert counter.observes >= 15
        assert counter.metadata_reads == 0


def test_routes_the_port_lacks_answer_through_the_client_as_the_server(
        runs):
    _, _, servers = runs
    ctx = port_client.Context(servers[1].base_url)
    # the observability plane answers since it was ported; the
    # autoscaler's route waits for the autoscaler
    assert ctx.health()["status"] == "ok"
    assert "job" in {s["name"] for s in ctx.trace("cnn_t")["spans"]}
    with pytest.raises(port_client.ApiError) as err:
        ctx.autoscaler()
    assert err.value.status == 404
    # the tensorflow shim's load_model is accepted as in the JAX package;
    # its job fails on the missing file
    assert ctx.model_tensorflow.create(
        "tf", "tensorflow.keras.models", "load_model",
        {"path": "/m.keras"}) == "/api/learningOrchestra/v1/model/tensorflow/tf"
    servers[1].api.ctx.jobs.wait("tf", timeout=60)
    tf_doc = ctx.model_tensorflow.read("tf")["result"][-1]
    assert tf_doc["exception"].startswith("FileNotFoundError")
    observed = ctx.observe("titanic", seq=0, timeout=1)
    assert observed["metadata"]["finished"] and observed["changes"]
    assert {"seq"} == set(ctx._http.request(
        "GET", port_client.API_PREFIX + "/observe")[1]["result"])


# the calls the port answered 404 or 406 to until its explore route and
# its job lifecycle came: each package's client against its server
def _histogram(ctx, lib):
    uri = ctx.explore_histogram.run_histogram("titanic", "hist_pclass",
                                              ["Pclass"])
    ctx.wait("hist_pclass")
    docs = ctx.explore_histogram.read("hist_pclass")["result"]
    return uri, [d for d in docs if "Pclass" in d]


def _cancel(ctx, lib):
    outcomes = []
    try:
        ctx.train_tensorflow.cancel("cnn_t")  # finished: nothing to cancel
    except lib.ApiError as err:
        outcomes.append((err.status, err.args))
    ctx.function_python.run_function(
        "slow_cancel", "import time\n"
                       "for _ in range(600):\n"
                       "    time.sleep(0.1)\n"
                       "response = 1\n")
    deadline = time.monotonic() + 60
    while ctx.function_python.metadata("slow_cancel").get(
            "status") != "running":
        assert time.monotonic() < deadline
        time.sleep(0.05)
    outcomes.append(ctx.function_python.cancel("slow_cancel"))
    while ctx.function_python.metadata("slow_cancel").get(
            "status") == "running":
        assert time.monotonic() < deadline
        time.sleep(0.05)
    meta = ctx.function_python.metadata("slow_cancel")
    return outcomes + [meta["finished"], meta["status"]]


def _function_timeout(ctx, lib):
    # a deadline well past the JAX jail's start (it imports that package)
    uri = ctx.function_python.run_function("t_timeout", "response = 1",
                                           timeout=90)
    ctx.wait("t_timeout")
    meta = ctx.function_python.metadata("t_timeout")
    return uri, meta["finished"], meta["status"], meta["timeout"]


LIFTED_CLIENT_CALLS = {"histogram": _histogram, "cancel": _cancel,
                       "function timeout": _function_timeout}


@pytest.mark.parametrize("case", list(LIFTED_CLIENT_CALLS))
def test_lifted_client_calls_answer_as_jax(runs, case):
    from learningorchestra_tpu import client as jax_client

    _, _, servers = runs
    want, got = (LIFTED_CLIENT_CALLS[case](lib.Context(srv.base_url), lib)
                 for srv, lib in zip(servers, (jax_client, port_client)))
    assert got == want
