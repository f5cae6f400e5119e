"""The PyTorch port's REST pipeline (dataset -> model -> train ->
evaluate -> predict -> serve) on the CPU, held against the port's
direct calls and against the JAX package.

- Validation: the same bad requests through both packages' ``Api`` give
  equal status codes and bodies (the JAX preflight does not answer any
  of them).
- A REST pipeline in the port gives the losses, evaluate document and
  tokens of the same calls made directly on a ``LanguageModel``.
- With the stored model carrying a JAX weight tree, the REST fit's
  losses equal the JAX package's direct fit of that tree (float32, the
  tolerance of ``tests/test_torch_training.py::test_fit_matches_jax``).
- A failed job leaves ``finished`` false and an execution document with
  JAX's keys; what the port does not run yet answers 406 at submit and
  leaves no collection, and what it runs since (``timeout``,
  ``healthPolicy``, http(s) and generic ingest, cancel, the explore and
  transform routes) answers and ends as in the JAX package; the pipeline
  runs with pandas, pyarrow and dill unimportable.

The model is small (vocab 64, d_model 32, 2 layers, windows of 32
tokens of a cyclic-successor stream); both packages compute in float32.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu import native as jax_native
from learningorchestra_tpu.models import transformer as jax_tlm
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.models.transformer import LanguageModel
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api, RestServer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "/api/learningOrchestra/v1"
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           max_len=32, sliding_window=16)
SEQ = 32
MODEL_BODY = {"modelName": "lm", "modulePath": "learningorchestra_tpu.models",
              "class": "LanguageModel", "classParameters": CFG}


def _stream(n: int, seed: int) -> np.ndarray:
    """``n`` windows of the stream where t is followed by t % 63 + 1."""
    start = np.random.default_rng(seed).integers(1, 64, size=n)
    return ((start[:, None] + np.arange(SEQ)[None, :]) % 63 + 1) \
        .astype(np.int32)


def _write_csv(path, x) -> str:
    with open(path, "w") as f:
        f.write(",".join(f"t{i}" for i in range(x.shape[1])) + "\n")
        for row in x:
            f.write(",".join(str(int(t)) for t in row) + "\n")
    return str(path)


def _call(api, method, path, body=None, params=None):
    return api.dispatch(method, PREFIX + path, params or {}, body)[:2]


def _wait(api, path, timeout=300.0):
    """Polls ``finished``; the metadata and documents once it flips."""
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


@pytest.fixture()
def float32(monkeypatch):
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    jax_config.reset_config()
    yield
    jax_config.reset_config()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    x = _stream(32, seed=4)
    return x, _write_csv(tmp_path_factory.mktemp("corpus") / "c.csv", x)


def _port_api(root, name="port_home") -> Api:
    return Api(ServiceContext(Config(home=str(root / name)), device="cpu"))


# ----------------------------------------------------------------------
# validation parity
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def both(tmp_path_factory, corpus):
    """The JAX and the port ``Api``, each with dataset ``corpus`` and a
    finished model ``lm``."""
    root = tmp_path_factory.mktemp("both")
    jax_config.set_config(jax_config.Config(home=str(root / "jax_home")))
    from learningorchestra_tpu.services.server import Api as JaxApi

    # the JAX ingest takes its pyarrow reader, the port's reference (its
    # native parser builds into one cache shared by every process)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        apis = (JaxApi(), _port_api(root))
        try:
            for api in apis:
                assert _call(api, "POST", "/dataset/csv", {
                    "datasetName": "corpus",
                    "datasetURI": corpus[1]})[0] == 201
                assert _call(api, "POST", "/model/tensorflow",
                             MODEL_BODY)[0] == 201
            for api in apis:
                # a GET while the JAX ingest writes can answer 500
                api.ctx.jobs.wait("corpus", timeout=300)
                _wait(api, "/dataset/csv/corpus")
                _wait(api, "/model/tensorflow/lm")
            yield apis
        finally:
            for api in apis:
                api.ctx.close()
            jax_config.reset_config()


def _model(**changes):
    body = dict(MODEL_BODY, modelName="lm2")
    body.update(changes)
    return {k: v for k, v in body.items() if v is not None}


def _run(name="r", model="lm", method="fit", params=None, **changes):
    body = {"name": name, "modelName": model, "method": method,
            "methodParameters": {} if params is None else params}
    body.update(changes)
    return {k: v for k, v in body.items() if v is not None}


BAD_REQUESTS = {
    "missing field": ("POST", "/model/tensorflow", _model(modelName=None)),
    "duplicate": ("POST", "/model/tensorflow", _model(modelName="lm")),
    "unsafe name": ("POST", "/model/tensorflow", _model(modelName="../x")),
    "unknown class": ("POST", "/model/tensorflow", _model(**{
        "class": "NoSuchModel"})),
    "bad class kwarg": ("POST", "/model/tensorflow", _model(
        classParameters=dict(CFG, bogus=1))),
    "nonexistent parent": ("POST", "/train/tensorflow", _run(model="ghost")),
    "unknown method": ("POST", "/train/tensorflow", _run(method="bogus")),
    "bad generate kwarg": ("POST", "/predict/tensorflow", _run(
        method="generate", params={"prompt": [[1, 2]], "beams": 2})),
    "missing methodParameters": ("POST", "/evaluate/tensorflow", {
        "name": "r", "modelName": "lm", "method": "evaluate"}),
    "duplicate execution": ("POST", "/train/tensorflow", _run(
        name="corpus")),
    "GET a missing name": ("GET", "/train/tensorflow/ghost", None),
    "DELETE a missing name": ("DELETE", "/model/tensorflow/ghost", None),
    "PATCH without a name": ("PATCH", "/model/tensorflow", {}),
    "PATCH a dataset": ("PATCH", "/dataset/csv/corpus", {}),
    "POST with a name": ("POST", "/model/tensorflow/lm", {}),
    "unknown dataset tool": ("POST", "/dataset/xml", {
        "datasetName": "d2", "datasetURI": "x.csv"}),
    "unknown service": ("GET", "/nosuch/tool", None),
    "unsupported verb": ("PUT", "/model/tensorflow", {}),
    "unknown sweep scoring": ("POST", "/model/tensorflow", _model(
        **{"class": "GridSearch"}, classParameters={
            "estimator": "$lm", "param_grid": {"learning_rate": [1e-3]},
            "scoring": "f1"})),
}


@pytest.mark.parametrize("case", list(BAD_REQUESTS))
def test_bad_requests_answer_as_jax(both, case):
    method, path, body = BAD_REQUESTS[case]
    got, want = (_call(api, method, path, body) for api in both[::-1])
    assert got == want
    assert got[0] in (404, 405, 406, 409)
    for api in both:
        for name in ("lm2", "r", "d2"):
            assert not api.ctx.catalog.exists(name)


def test_failed_job_is_recorded_as_jax(both):
    """A fit on a nonexistent ``$`` reference: ``finished`` stays false
    and the execution document has JAX's keys and exception."""
    docs = []
    for api in both:
        assert _call(api, "POST", "/train/tensorflow", _run(
            name="bad", params={"x": "$ghost"}))[0] == 201
        api.ctx.jobs.wait("bad", timeout=60)
        status, body = _call(api, "GET", "/train/tensorflow/bad")
        assert status == 200 and body["metadata"]["finished"] is False
        assert body["metadata"]["status"] == "deadLettered"
        docs.append(body["result"][-1])
    want, got = docs
    assert set(got) == set(want)
    assert got["exception"] == want["exception"] == \
        "KeyError('unknown artifact: ghost')"
    assert got["errorKind"] == want["errorKind"] == "permanent"


# ----------------------------------------------------------------------
# what is not ported yet
# ----------------------------------------------------------------------
NOT_PORTED = {
    "a JAX method": ("POST", "/train/tensorflow", _run(
        method="set_mesh")),
    "sliceDevices": ("POST", "/train/tensorflow", _run(sliceDevices=2)),
    "tensorflow.keras": ("POST", "/model/tensorflow", _model(
        modulePath="tensorflow.keras.models", **{"class": "Sequential"})),
    "a submodule of the mapped path": ("POST", "/model/tensorflow", _model(
        modulePath="learningorchestra_tpu.models.neural")),
    "migrate": ("POST", "/train/tensorflow/lm/migrate", {}),
}


# the cases above the port answers since its tensorflow shim: as the JAX
# package does (201, then a job that builds an empty Sequential)
ANSWERED_NOW = ("tensorflow.keras",)


@pytest.mark.parametrize("case", list(NOT_PORTED))
def test_unported_requests_are_refused_at_submit(both, case):
    method, path, body = NOT_PORTED[case]
    port = both[1]
    if case in ANSWERED_NOW:
        answers = [_call(api, method, path, body) for api in both]
        assert answers[0] == answers[1] and answers[1][0] == 201
        for api in both:
            api.ctx.jobs.wait(body["modelName"], timeout=60)
            meta = api.ctx.catalog.get_metadata(body["modelName"])
            assert meta["finished"] and meta["class"] == "Sequential"
            assert _call(api, "DELETE",
                         f"/model/tensorflow/{body['modelName']}")[0] == 200
        return
    status, answer = _call(port, method, path, body)
    assert status == 406
    assert "is not yet ported to the PyTorch package" in answer["result"]
    for name in ("lm2", "r", "d2"):
        assert _call(port, "GET", f"/train/tensorflow/{name}")[0] == 404
    assert port.ctx.catalog.get_metadata("lm")["finished"]


# NeuralModel methods of the JAX package the port lacked (mesh placement,
# the keras import and export, sweep fusion); the keras import and export
# and sweep fusion run now, only set_mesh is refused
NEURAL_JAX_ONLY = ("set_mesh", "from_keras", "from_savedmodel",
                   "from_legacy_h5", "to_keras", "save_keras",
                   "fit_sweep_fused", "supports_sweep_fusion")
KERAS_METHODS = ("from_keras", "from_savedmodel", "from_legacy_h5",
                 "to_keras", "save_keras")
# what the JAX package's job makes of each sweep fusion method called
# with no parameters: None = finished, else the failure's text
FUSION_METHODS = {
    "fit_sweep_fused": "missing 3 required positional arguments: 'x', "
                       "'y', and 'hyper_overrides'",
    "supports_sweep_fusion": None}


@pytest.fixture(scope="module")
def port_neural(both):
    """The port's Api with a finished NeuralModel ``nm_root``."""
    port = both[1]
    assert _call(port, "POST", "/model/tensorflow", {
        "modelName": "nm_root", "modulePath": "learningorchestra_tpu.models",
        "class": "NeuralModel", "classParameters": {
            "layer_configs": [{"kind": "dense", "units": 2}]}})[0] == 201
    _wait(port, "/model/tensorflow/nm_root")
    return port


@pytest.mark.parametrize("method", NEURAL_JAX_ONLY)
def test_neural_methods_the_port_lacks_are_refused(port_neural, method):
    if method in KERAS_METHODS:
        # accepted, as in the JAX package; the job reaches the method,
        # which has no path (or, unbuilt, no weights) to work on
        name = f"nm_{method}"
        assert _call(port_neural, "POST", "/train/tensorflow", _run(
            name=name, model="nm_root", method=method))[0] == 201
        port_neural.ctx.jobs.wait(name, timeout=60)
        status, body = _call(port_neural, "GET", f"/train/tensorflow/{name}")
        assert status == 200 and body["metadata"]["finished"] is False
        assert ("no parameters yet" if method == "to_keras" else
                "missing 1 required positional argument: 'path'") \
            in body["result"][-1]["exception"]
        return
    if method in FUSION_METHODS:
        # accepted, as in the JAX package
        name = f"nm_{method}"
        assert _call(port_neural, "POST", "/train/tensorflow", _run(
            name=name, model="nm_root", method=method))[0] == 201
        port_neural.ctx.jobs.wait(name, timeout=60)
        status, body = _call(port_neural, "GET", f"/train/tensorflow/{name}")
        want = FUSION_METHODS[method]
        assert status == 200 and body["metadata"]["finished"] is (
            want is None)
        if want is not None:
            assert want in body["result"][-1]["exception"]
        return
    status, answer = _call(port_neural, "POST", "/train/tensorflow",
                           _run(name="nm_r", model="nm_root", method=method))
    assert status == 406
    assert answer["result"] == (f"invalid method name: {method} is not yet "
                                f"ported to the PyTorch package")
    assert _call(port_neural, "GET", "/train/tensorflow/nm_r")[0] == 404


# the classes the port refused before it had NeuralModel and the sweeps:
# the bodies NOT_PORTED held answer as in the JAX package (201, then a
# job that fails on the missing constructor arguments)
PORTED_CLASSES = {
    "NeuralModel": _model(modelName="nm", **{"class": "NeuralModel"},
                          classParameters={}),
    "GridSearch": _model(modelName="gs", **{"class": "GridSearch"},
                         classParameters={}),
    "RandomSearch": _model(modelName="rs", **{"class": "RandomSearch"},
                           classParameters={}),
}


@pytest.mark.parametrize("case", list(PORTED_CLASSES))
def test_ported_classes_answer_as_jax(both, case):
    body = PORTED_CLASSES[case]
    name = body["modelName"]
    seen = []
    for api in both:
        answer = _call(api, "POST", "/model/tensorflow", body)
        api.ctx.jobs.wait(name, timeout=60)
        status, doc = _call(api, "GET", f"/model/tensorflow/{name}")
        assert status == 200
        seen.append((answer, doc["metadata"]["finished"],
                     doc["metadata"].get("status"),
                     doc["result"][-1].get("exception")))
    assert seen[1] == seen[0]
    assert seen[0][0] == (201, {"result": PREFIX +
                                f"/model/tensorflow/{name}"})
    assert "missing" in seen[0][3]


# the LM options ported since: each answers as in the JAX package
LM_OPTIONS = {
    "n_experts": ("/model/tensorflow", _model(
        modelName="lm_moe", classParameters=dict(CFG, n_experts=4))),
    "fused_proj": ("/model/tensorflow", _model(
        modelName="lm_fused", classParameters=dict(CFG, fused_proj=True))),
    "remat dots": ("/model/tensorflow", _model(
        modelName="lm_dots", classParameters=dict(CFG, remat="dots"))),
    "remat full": ("/model/tensorflow", _model(
        modelName="lm_full", classParameters=dict(CFG, remat="full"))),
    "num_beams": ("/predict/tensorflow", _run(
        name="lm_beams", model="lm_seeded", method="generate",
        params={"prompt": [[1, 2, 3]], "max_new_tokens": 4,
                "num_beams": 2})),
}


def _seed_models(both, name: str) -> None:
    """Model ``name`` in both packages, holding one weight tree."""
    tree = weights.init_params(CFG, seed=3)
    jlm = jax_tlm.LanguageModel(**CFG)
    jlm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    plm = LanguageModel(**CFG, device="cpu")
    plm.set_params(weights.params_from_flax(tree))
    for api, model in zip(both, (jlm, plm)):
        assert _call(api, "POST", "/model/tensorflow",
                     _model(modelName=name))[0] == 201
        _wait(api, f"/model/tensorflow/{name}")
        api.ctx.artifacts.save(model, name, "model/tensorflow")


@pytest.mark.parametrize("case", list(LM_OPTIONS))
def test_lm_options_are_accepted_as_jax(both, case):
    """What the port refused until these options ran: the POST answers
    JAX's status and body and the job finishes in both packages; a
    created model takes the option, and beam search from one weight
    tree gives JAX's tokens."""
    path, body = LM_OPTIONS[case]
    creates = path.startswith("/model")
    if not creates:
        _seed_models(both, body["modelName"])
    name = body["modelName"] if creates else body["name"]
    seen = []
    for api in both:
        answer = _call(api, "POST", path, body)
        done = _wait(api, f"{path}/{name}")
        result = None if creates else [
            d["result"] for d in done["result"] if "result" in d][0]
        seen.append((answer, done["metadata"]["finished"], result))
    assert seen[1] == seen[0]
    assert seen[1][0] == (201, {"result": PREFIX + f"{path}/{name}"})
    if creates:
        stored = both[1].ctx.artifacts.load(name)
        for key, value in body["classParameters"].items():
            assert getattr(stored, key) == value
    else:
        assert np.asarray(seen[1][2]).shape == (1, 7)


# what NOT_PORTED held until the function route, the '#' DSL and any
# importable module path came: each answers as in the JAX package, and
# its job ends alike
PORTED_SINCE = {
    "hash in a method parameter": ("/train/tensorflow", _run(
        params={"x": "$corpus", "epochs": "#2", "batch_size": 16,
                "shuffle": False})),
    "hash in a class parameter": ("/model/tensorflow", _model(
        classParameters=dict(CFG, d_model="#32"))),
    "sklearn": ("/model/scikitlearn", _model(
        modulePath="sklearn.linear_model",
        **{"class": "LogisticRegression"}, classParameters={})),
    "an importable module": ("/model/tensorflow", _model(
        modulePath="numpy", **{"class": "ndarray"})),
}


@pytest.mark.parametrize("case", list(PORTED_SINCE))
def test_requests_ported_since_answer_as_jax(both, case):
    path, body = PORTED_SINCE[case]
    name = body.get("name", body.get("modelName"))
    seen = []
    for api in both:
        answer = _call(api, "POST", path, body)
        api.ctx.jobs.wait(name, timeout=300)
        status, doc = _call(api, "GET", f"{path}/{name}")
        assert status == 200
        last = doc["result"][-1]
        seen.append((answer, doc["metadata"]["finished"],
                     doc["metadata"].get("status"), last.get("exception")))
        assert _call(api, "DELETE", f"{path}/{name}")[0] == 200
    assert seen[1] == seen[0]
    assert seen[1][0] == (201, {"result": PREFIX + f"{path}/{name}"})
    assert seen[1][1] is (case != "an importable module")


def test_other_services_stay_unrouted(both):
    """The observability routes, ``/profile``, ``/health`` and
    ``/metrics``, unrouted until the observability plane came, answer as
    the JAX server's; the autoscaler's route stays unrouted until the
    autoscaler is ported."""
    jax_api, port = both
    for path in ("/observability/trace", "/profile"):
        assert _call(port, "GET", path)[0] == \
            _call(jax_api, "GET", path)[0] == 200
    for path in ("/health", "/metrics"):
        assert port.dispatch("GET", path, {}, None)[0] == \
            jax_api.dispatch("GET", path, {}, None)[0] == 200
    assert _call(port, "GET", "/observability/autoscaler") == \
        (404, {"result": "unknown route"})


@pytest.mark.parametrize("method, body", [
    ("GET", None), ("POST", {"trainDatasetName": "corpus"}),
    ("POST", {"trainDatasetName": "corpus", "testDatasetName": "corpus",
              "classifiersList": ["LR"], "modelingCode": "x = 1\n",
              "streaming": True, "meshParallel": True})])
def test_builder_route_answers_as_jax(both, method, body):
    """``/builder/sparkml``, unrouted until the Builder came: a listing
    and refused submits answer as in the JAX package."""
    got, want = (_call(api, method, "/builder/sparkml", body)
                 for api in both[::-1])
    assert got == want
    assert got[0] == (200 if method == "GET" else 406)


# what NOT_PORTED and the unrouted services held until the lifecycle,
# URL ingest and the explore and transform routes came: each answers as
# in the JAX package, and its job ends alike
@pytest.fixture(scope="module")
def corpus_url(corpus):
    """The corpus CSV behind a local ``http.server`` (no network)."""
    import functools
    import http.server
    import threading

    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=os.path.dirname(corpus[1]))
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    server.RequestHandlerClass.log_message = lambda *a: None
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield (f"127.0.0.1:{server.server_address[1]}/"
           f"{os.path.basename(corpus[1])}")
    server.shutdown()
    server.server_close()


def _job_end(api, path, name):
    """The job's metadata and last document, without times."""
    api.ctx.jobs.wait(name, timeout=300)
    deadline = time.monotonic() + 30
    while True:
        status, body = _call(api, "GET", f"{path}/{name}")
        last = body["result"][-1]
        if "queueWaitSeconds" in last or last.get("exception") or \
                time.monotonic() > deadline:
            break
        time.sleep(0.01)
    meta = body["metadata"]
    keep = ("finished", "status", "timeout", "healthPolicy", "fields",
            "rows", "sizeBytes")
    return ({k: meta.get(k) for k in keep},
            {k: last.get(k) for k in ("status", "errorKind",
                                      "deadLettered")},
            bool(last.get("exception")))


_FIT_ONE = {"x": "$corpus", "epochs": 1, "batch_size": 16,
            "shuffle": False}


def _lifted_timeout(api, url):
    answer = _call(api, "POST", "/train/tensorflow", _run(
        name="lifted_to", timeout=120, params=_FIT_ONE))
    return answer, _job_end(api, "/train/tensorflow", "lifted_to")


def _lifted_health_policy(api, url):
    # the LM's fit takes no health_policy: stored, not armed (as in JAX)
    answer = _call(api, "POST", "/train/tensorflow", _run(
        name="lifted_hp", healthPolicy={"maxRollbacks": 1},
        params=_FIT_ONE))
    return answer, _job_end(api, "/train/tensorflow", "lifted_hp")


def _lifted_ingest(scheme, tool, name):
    def case(api, url):
        answer = _call(api, "POST", f"/dataset/{tool}", {
            "datasetName": name, "datasetURI": f"{scheme}://{url}"})
        end = _job_end(api, f"/dataset/{tool}", name)
        rows = _call(api, "GET", f"/dataset/{tool}/{name}",
                     params={"skip": 1, "limit": 2})[1]["result"]
        return answer, end, rows if tool == "csv" and end[0][
            "finished"] else None
    return case


def _lifted_cancel(api, url):
    return [_call(api, "DELETE", path) for path in (
        "/model/tensorflow/lm/run", "/model/tensorflow/ghost/run")]


def _lifted_explore(api, url):
    answers = [_call(api, "GET", "/explore/histogram"),
               _call(api, "POST", "/explore/histogram", {
                   "inputDatasetName": "corpus",
                   "outputDatasetName": "lifted_h", "names": ["t0", "t1"]})]
    end = _job_end(api, "/explore/histogram", "lifted_h")
    docs = _call(api, "GET", "/explore/histogram/lifted_h")[1]["result"]
    return answers, end, docs[1:3]


def _lifted_transform(api, url):
    answers = [_call(api, "GET", "/transform/projection"),
               _call(api, "POST", "/transform/projection", {
                   "inputDatasetName": "corpus",
                   "outputDatasetName": "lifted_p", "names": ["t3", "t0"]})]
    end = _job_end(api, "/transform/projection", "lifted_p")
    rows = _call(api, "GET", "/transform/projection/lifted_p",
                 params={"skip": 1, "limit": 3})[1]["result"]
    return answers, end, rows


LIFTED = {
    "timeout": _lifted_timeout,
    "healthPolicy": _lifted_health_policy,
    "http": _lifted_ingest("http", "csv", "lifted_http"),
    "https": _lifted_ingest("https", "csv", "lifted_https"),
    "dataset/generic": _lifted_ingest("http", "generic", "lifted_gen"),
    "cancel": _lifted_cancel,
    "explore": _lifted_explore,
    "transform": _lifted_transform,
}


# what each case's outcome must show beyond equality with the JAX one
LIFTED_HOLDS = {
    "timeout": lambda o: o[0][0] == 201 and o[1][0]["timeout"] == 120.0
    and o[1][0]["finished"],
    "healthPolicy": lambda o: o[1][0]["healthPolicy"] == {
        "maxRollbacks": 1} and o[1][0]["finished"],
    "http": lambda o: o[1][0]["rows"] == 32 and len(o[2]) == 2,
    "https": lambda o: o[0][0] == 201 and not o[1][0]["finished"]
    and o[1][1]["status"] == "deadLettered",
    "dataset/generic": lambda o: o[1][0]["sizeBytes"] > 0,
    "cancel": lambda o: [a[0] for a in o] == [406, 404],
    "explore": lambda o: o[0][1][0] == 201 and len(o[2]) == 2,
    "transform": lambda o: o[0][1][0] == 201 and len(o[2]) == 3,
}


@pytest.mark.parametrize("case", list(LIFTED))
def test_lifted_refusals_answer_as_jax(both, corpus_url, case):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        want, got = (LIFTED[case](api, corpus_url) for api in both)
    assert got == want
    assert LIFTED_HOLDS[case](got), got


# ----------------------------------------------------------------------
# the pipeline
# ----------------------------------------------------------------------
def _http(srv, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(srv.base_url + PREFIX + path, data=data,
                                 method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _result(api, path):
    return [d["result"] for d in _wait(api, path)["result"]
            if "result" in d][0]


def test_rest_pipeline_equals_direct_calls(tmp_path, corpus, float32):
    """Over HTTP: ingest, create, fit (shuffled, grad_accum 2), evaluate,
    predict, generate and serve give what the same calls on a
    ``LanguageModel`` give."""
    x, path = corpus
    srv = RestServer(port=0, context=ServiceContext(
        Config(home=str(tmp_path / "home")), device="cpu")).start()
    api = srv.api
    try:
        assert _http(srv, "POST", "/dataset/csv", {
            "datasetName": "corpus", "datasetURI": "file://" + path}) == (
            201, {"result": PREFIX + "/dataset/csv/corpus"})
        _wait(api, "/dataset/csv/corpus")
        assert _http(srv, "POST", "/model/tensorflow", MODEL_BODY)[0] == 201
        _wait(api, "/model/tensorflow/lm")
        fit = {"x": "$corpus", "batch_size": 8, "epochs": 2,
               "grad_accum": 2}
        assert _http(srv, "POST", "/train/tensorflow", _run(
            name="lm_t", params=fit))[0] == 201
        docs = _wait(api, "/train/tensorflow/lm_t")["result"]
        records = [d["epochRecord"] for d in docs if "epochRecord" in d]
        for verb, name, method, params in (
                ("evaluate", "ev", "evaluate", {"x": "$corpus",
                                                "batch_size": 8}),
                ("predict", "logits", "predict", {"x": "$corpus",
                                                  "batch_size": 16}),
                ("predict", "gen", "generate", {
                    "prompt": x[:2, :5].tolist(), "max_new_tokens": 6})):
            assert _http(srv, "POST", f"/{verb}/tensorflow", _run(
                name=name, model="lm_t", method=method,
                params=params))[0] == 201
        evaluated = _result(api, "/evaluate/tensorflow/ev")
        logits = np.asarray(_result(api, "/predict/tensorflow/logits"))
        generated = _result(api, "/predict/tensorflow/gen")
        assert _http(srv, "POST", "/serve/lm_t", {
            "type": "lm", "maxSlots": 2, "cacheLen": 32})[0] == 201
        status, served = _http(srv, "POST", "/serve/lm_t/predict", {
            "prompt": x[0, :5].tolist(), "maxNewTokens": 6})
        assert status == 200
    finally:
        srv.stop()

    lm = LanguageModel(**CFG, device="cpu")
    hist = lm.fit(x, batch_size=8, epochs=2, grad_accum=2).history
    assert [r["loss"] for r in records] == hist["loss"]
    assert [r["accuracy"] for r in records] == hist["accuracy"]
    assert hist["loss"][1] < hist["loss"][0]
    assert evaluated == lm.evaluate(x, batch_size=8)
    np.testing.assert_allclose(logits, lm.predict(x, batch_size=16),
                               rtol=0, atol=1e-6)
    want = lm.generate(x[:2, :5], max_new_tokens=6)
    assert generated == want.tolist()
    assert served["tokens"] == want[0, 5:].tolist()


def test_rest_fit_of_a_jax_tree_matches_jax(tmp_path, corpus, float32):
    """The stored model carries ``params_from_flax`` of a JAX tree: the
    REST fit's losses equal the JAX package's direct fit of that tree,
    and the trained artifact's weights JAX's."""
    x, path = corpus
    tree = weights.init_params(CFG, seed=2)
    api = _port_api(tmp_path)
    try:
        _call(api, "POST", "/dataset/csv", {"datasetName": "corpus",
                                            "datasetURI": path})
        _call(api, "POST", "/model/tensorflow", MODEL_BODY)
        _wait(api, "/dataset/csv/corpus")
        _wait(api, "/model/tensorflow/lm")
        seeded = LanguageModel(**CFG, device="cpu")
        seeded.set_params(weights.params_from_flax(tree))
        api.ctx.artifacts.save(seeded, "lm", "model/tensorflow")
        assert _call(api, "POST", "/train/tensorflow", _run(
            name="lm_t", params={"x": "$corpus", "batch_size": 16,
                                 "epochs": 2, "shuffle": False}))[0] == 201
        docs = _wait(api, "/train/tensorflow/lm_t")["result"]
        trained = api.ctx.artifacts.load("lm_t")
    finally:
        api.ctx.close()
    got = [d["epochRecord"] for d in docs if "epochRecord" in d]
    jlm = jax_tlm.LanguageModel(**CFG)
    jlm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jlm.fit(x, batch_size=16, epochs=2, shuffle=False).history
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose([r[key] for r in got], want[key],
                                   rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(
            weights.params_to_flax(trained.params)),
            jax.tree_util.tree_leaves(jlm.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6,
                                   rtol=0)


# the tutorial's MNIST CNN (docs/TUTORIAL.md workflow 2)
TUTORIAL_CNN = [
    {"kind": "reshape", "shape": [28, 28, 1]},
    {"kind": "conv2d", "filters": 32, "kernel": [3, 3],
     "activation": "relu"},
    {"kind": "maxpool2d"},
    {"kind": "flatten"},
    {"kind": "dense", "units": 128, "activation": "relu"},
    {"kind": "dense", "units": 10, "activation": "softmax"}]


def _write_table(path, header, rows) -> str:
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in rows:
            f.write(",".join(f"{v:.4f}" if isinstance(v, float) else str(v)
                             for v in row) + "\n")
    return str(path)


def test_tutorial_cnn_workflow_answers_as_jax(tmp_path, monkeypatch):
    """Workflow 2 through both packages' ``Api``: pixels and labels as
    two CSVs, ``POST /model`` of the tutorial's CNN, ``/train`` ``fit``
    on ``$`` references with ``"checkpoint": true``, ``/evaluate``,
    ``/predict``, then a ``GridSearch`` and a ``RandomSearch`` over
    ``$cnn`` through ``/model`` and ``/tune``. Every POST answers alike; with the stored models
    holding one JAX tree (and the port's trials drawing JAX's init),
    epoch losses, evaluate, predict and the sweep's scores agree within
    1e-5 (float32; the JAX sweep unfused)."""
    from learningorchestra_tpu.models.neural import NeuralModel as JaxNM
    from learningorchestra_tpu.services.server import Api as JaxApi
    from learningorchestra_tpu_torch.models import NeuralModel

    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("LO_SWEEP_FUSION", "0")
    monkeypatch.setattr(jax_native, "available", lambda: False)
    rng = np.random.default_rng(0)
    x = rng.random((48, 784)).astype(np.float32)
    y = rng.integers(0, 10, 48)
    pixels = _write_table(tmp_path / "pixels.csv",
                          [f"p{i}" for i in range(784)],
                          [[float(v) for v in row] for row in x])
    labels = _write_table(tmp_path / "labels.csv", ["label"],
                          [[int(v)] for v in y])
    jm = JaxNM(TUTORIAL_CNN)
    jm._build_params(np.zeros((1, 784), np.float32))
    tree = jax.tree_util.tree_map(np.asarray, jm.params)

    def jax_built(self, sample_x):
        self.set_params(weights.params_from_flax(tree, sequential=True),
                        input_shape=[784])

    monkeypatch.setattr(NeuralModel, "_build_params", jax_built)
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax")))
    apis = (JaxApi(), _port_api(tmp_path))
    fit = {"x": "$pixels", "y": "$labels", "epochs": 2, "batch_size": 16,
           "shuffle": False, "checkpoint": True}
    steps = (
        ("/model/tensorflow", {"modelName": "cnn", "modulePath":
                               "learningorchestra_tpu.models",
                               "class": "NeuralModel", "classParameters":
                               {"layer_configs": TUTORIAL_CNN}}),
        ("/train/tensorflow", _run(name="cnn_t", model="cnn", params=fit)),
        ("/evaluate/tensorflow", _run(
            name="cnn_e", model="cnn_t", method="evaluate",
            params={"x": "$pixels", "y": "$labels", "batch_size": 16})),
        ("/predict/tensorflow", _run(
            name="cnn_p", model="cnn_t", method="predict",
            params={"x": "$pixels", "batch_size": 16})),
        ("/model/tensorflow", {"modelName": "sweep", "modulePath":
                               "learningorchestra_tpu.models",
                               "class": "GridSearch", "classParameters": {
                                   "estimator": "$cnn", "param_grid": {
                                       "learning_rate": [1e-3, 1e-2]}}}),
        ("/tune/tensorflow", _run(
            name="sweep_t", model="sweep",
            params={"x": "$pixels", "y": "$labels", "epochs": 1,
                    "batch_size": 16, "shuffle": False,
                    "checkpoint": True})),
        ("/model/tensorflow", {"modelName": "rsweep", "modulePath":
                               "learningorchestra_tpu.models",
                               "class": "RandomSearch", "classParameters": {
                                   "estimator": "$cnn", "n_iter": 1,
                                   "param_grid": {"batch_size": [8, 16]},
                                   "refit": False}}),
        ("/tune/tensorflow", _run(
            name="rsweep_t", model="rsweep",
            params={"x": "$pixels", "y": "$labels", "epochs": 1,
                    "shuffle": False})))
    seen = []
    try:
        for api in apis:
            for name, path in (("pixels", pixels), ("labels", labels)):
                assert _call(api, "POST", "/dataset/csv", {
                    "datasetName": name, "datasetURI": path})[0] == 201
                api.ctx.jobs.wait(name, timeout=300)
            docs = {}
            for path, body in steps:
                answer = _call(api, "POST", path, body)
                name = body.get("name", body.get("modelName"))
                docs[name] = _wait(api, f"{path}/{name}")
                docs[name + "_answer"] = answer
                if name == "cnn":  # the JAX tree in both stores
                    model = jm if api is apis[0] else NeuralModel(
                        TUTORIAL_CNN, device="cpu")
                    if model is not jm:
                        jax_built(model, None)
                    api.ctx.artifacts.save(model, "cnn", "model/tensorflow")
            docs["sweep_art"] = api.ctx.artifacts.load("sweep_t")
            docs["rsweep_art"] = api.ctx.artifacts.load("rsweep_t")
            seen.append(docs)
    finally:
        for api in apis:
            api.ctx.close()
        jax_config.reset_config()
    want, got = seen
    for _, body in steps:
        name = body.get("name", body.get("modelName"))
        assert got[name + "_answer"] == want[name + "_answer"]
        assert got[name]["metadata"]["finished"]
    records = [[d["epochRecord"] for d in docs["cnn_t"]["result"]
                if "epochRecord" in d] for docs in (got, want)]
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose([r[key] for r in records[0]],
                                   [r[key] for r in records[1]], rtol=1e-5,
                                   atol=1e-5)
    assert records[0][1]["loss"] < records[0][0]["loss"]
    assert len(got["cnn_t"]["metadata"]["checkpointCommits"]) == 2
    ev = [[d["result"] for d in docs["cnn_e"]["result"] if "result" in d][0]
          for docs in (got, want)]
    assert sorted(ev[0]) == sorted(ev[1])
    for k in ev[1]:
        np.testing.assert_allclose(ev[0][k], ev[1][k], rtol=1e-5, atol=1e-5)
    preds = [np.asarray([d["result"] for d in docs["cnn_p"]["result"]
                         if "result" in d][0]) for docs in (got, want)]
    assert preds[0].shape == (48, 10)
    np.testing.assert_allclose(preds[0], preds[1], atol=1e-5)
    assert got["sweep_t"]["metadata"]["sweepFusion"] == \
        want["sweep_t"]["metadata"]["sweepFusion"]
    gs, ws = got["sweep_art"], want["sweep_art"]
    assert gs.cv_results_["params"] == ws.cv_results_["params"]
    assert gs.best_params_ == ws.best_params_
    np.testing.assert_allclose(gs.cv_results_["mean_test_score"],
                               ws.cv_results_["mean_test_score"], atol=1e-5)
    assert gs.best_estimator_.num_params() == \
        ws.best_estimator_.num_params()
    gs, ws = got["rsweep_art"], want["rsweep_art"]
    assert gs.cv_results_["params"] == ws.cv_results_["params"]
    np.testing.assert_allclose(gs.cv_results_["mean_test_score"],
                               ws.cv_results_["mean_test_score"], atol=1e-5)
    assert gs.best_estimator_ is None is ws.best_estimator_


_BLOCKED = """
import sys, time
for mod in ("pandas", "pyarrow", "dill", "msgpack", "jax",
            "learningorchestra_tpu"):
    sys.modules[mod] = None
import numpy as np
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

home, path = sys.argv[1], sys.argv[2]
api = Api(ServiceContext(Config(home=home), device="cpu"))
P = "/api/learningOrchestra/v1"
def call(method, route, body=None):
    return api.dispatch(method, P + route, {}, body)[:2]
def wait(route):
    for _ in range(3000):
        meta = call("GET", route)[1]["metadata"]
        if meta["finished"]:
            return
        time.sleep(0.02)
    raise SystemExit("timeout " + route)
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, max_len=32)
call("POST", "/dataset/csv", {"datasetName": "c", "datasetURI": path})
call("POST", "/model/tensorflow", {"modelName": "m", "modulePath":
     "learningorchestra_tpu.models", "class": "LanguageModel",
     "classParameters": CFG})
wait("/dataset/csv/c"); wait("/model/tensorflow/m")
for verb, name, parent, method, params in (
        ("train", "t", "m", "fit", {"x": "$c", "batch_size": 16}),
        ("evaluate", "e", "t", "evaluate", {"x": "$c", "batch_size": 16}),
        ("predict", "g", "t", "generate", {"prompt": [[1, 2, 3]],
                                           "max_new_tokens": 3})):
    call("POST", "/" + verb + "/tensorflow", {"name": name, "modelName":
         parent, "method": method, "methodParameters": params})
    wait("/" + verb + "/tensorflow/" + name)
print(call("GET", "/predict/tensorflow/g")[1]["result"][1]["result"])
api.ctx.close()
"""


def test_pipeline_runs_without_pandas_pyarrow_or_dill(tmp_path, corpus):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, LO_COMPUTE_DTYPE="float32")
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(tmp_path / "home"),
         corpus[1]], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tokens = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(tokens) == 1 and tokens[0][:3] == [1, 2, 3] and \
        len(tokens[0]) == 6
