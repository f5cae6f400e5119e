"""The function route, the ``#`` DSL and any importable module path in
the port, held against the JAX package on the CPU.

The same bodies go through both packages' ``Api``, each on its own
store, in the default ``subprocess`` sandbox:

- a function over a dataset with blanks (``dropna``, column selection,
  ``to_numpy``) stores equal ``response`` arrays (exactly), equal
  ``functionMessage`` and ``resultShapes``; ``$fn.key`` indexes it; a
  PATCH re-run, a DELETE, a function fetched from a local ``http://``
  server and a failed job without ``response`` answer alike;
- a lint refusal (406 with its findings), a ``sandboxMode`` above the
  ceiling and a ``#`` expression the lint refuses answer with equal
  status codes and bodies; ``timeout`` is accepted and stored alike;
- ``#`` expressions in class and method parameters (``"layer_configs":
  "#[...]"``, ``"batch_size": "#2 ** 3"``) run in one sandbox pass per
  request: with the stored models holding one JAX tree, the fits' losses
  agree within 1e-5 relative (float32; ``tests/test_torch_neural.py``);
- ``GET /observe`` and ``GET /observe/{name}`` answer alike.
"""

import functools
import http.server
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu import native as jax_native
from learningorchestra_tpu.models.neural import NeuralModel as JaxNM
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import NeuralModel, weights
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
RTOL = 1e-5

PREP = ("import numpy as np\n"
        "d = d.dropna(subset=['a'])\n"
        "x = d[['a', 'b']].to_numpy('float32')\n"
        "y = d['label'].to_numpy('int32')\n"
        "print(len(d), int(y.sum()))\n"
        "response = {'x': x, 'y': y}\n")
LAYERS = "#[{'kind': 'dense', 'units': u, 'activation': a} " \
         "for u, a in ((8, 'relu'), (2, 'softmax'))]"
LAYER_CONFIGS = [{"kind": "dense", "units": 8, "activation": "relu"},
                 {"kind": "dense", "units": 2, "activation": "softmax"}]


def _call(api, method, path, body=None, params=None):
    return api.dispatch(method, PREFIX + path, params or {}, body)[:2]


def _done(api, path, timeout=300.0):
    """The GET body once the job ended (finished, or failed with a
    document carrying its exception) and its execution document is in:
    both packages flip ``finished`` before they append that document
    and set the final status."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, body = _call(api, "GET", path)
        assert status == 200, body
        ended = body["metadata"]["finished"] or any(
            d.get("exception") for d in body["result"][1:])
        if ended and "elapsedSeconds" in body["result"][-1]:
            return body
        time.sleep(0.05)
    raise AssertionError(f"timeout polling {path}")


def _write_csv(path, rows: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write("a,b,label\n")
        for _ in range(rows):
            a = "" if rng.random() < 0.25 else f"{rng.normal():.4f}"
            f.write(f"{a},{int(rng.integers(0, 5))},"
                    f"{int(rng.integers(0, 2))}\n")
    return str(path)


class _Quiet(http.server.SimpleHTTPRequestHandler):
    def log_message(self, format, *args):  # noqa: A002
        pass


@pytest.fixture(scope="module")
def served_code(tmp_path_factory):
    """A local http.server serving one function body."""
    root = tmp_path_factory.mktemp("served")
    (root / "fn.py").write_text("print('fetched')\nresponse = {'v': v * 3}\n")
    handler = functools.partial(_Quiet, directory=str(root))
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}/fn.py"
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX and the port ``Api`` (float32), each with dataset ``d``."""
    root = tmp_path_factory.mktemp("fn")
    csv = _write_csv(root / "d.csv", 64, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LO_COMPUTE_DTYPE", "float32")
        mp.setattr(jax_native, "available", lambda: False)
        jax_config.set_config(jax_config.Config(home=str(root / "jax")))
        from learningorchestra_tpu.services.server import Api as JaxApi

        apis = (JaxApi(), Api(ServiceContext(
            Config(home=str(root / "port")), device="cpu")))
        try:
            for api in apis:
                assert _call(api, "POST", "/dataset/csv", {
                    "datasetName": "d", "datasetURI": csv})[0] == 201
            for api in apis:
                api.ctx.jobs.wait("d", timeout=300)
                assert _done(api, "/dataset/csv/d")["metadata"]["finished"]
            yield apis
        finally:
            for api in apis:
                api.ctx.close()
            jax_config.reset_config()


def _fn(name, function, params=None, **extra):
    return {"name": name, "function": function,
            "functionParameters": {} if params is None else params, **extra}


def _both(both, method, path, body=None, params=None):
    return [_call(api, method, path, body, params) for api in both]


def _equal_values(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _equal_values(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal_values(u, v)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.fixture(scope="module")
def ran(both, served_code):
    """Every function job of the module, submitted to both packages at
    once (a JAX sandbox child takes seconds to start), then awaited."""
    jobs = {
        "prep": _fn("prep", PREP, {"d": "$d"}),
        "keyed": None,  # after prep: reads $prep.x
        "hashed": _fn("hashed", "response = {'n': n, 'layers': layers}",
                      {"n": "#2 ** 7", "layers": LAYERS}),
        "silent": _fn("silent", "x = 1\n"),
        "fetched": _fn("fetched", served_code, {"v": 7}),
        "gone": _fn("gone", "response = 1\n"),
    }
    answers = {}
    for name, body in jobs.items():
        if body is not None:
            answers[name] = _both(both, "POST", "/function/python", body)
    done = {name: [_done(api, f"/function/python/{name}") for api in both]
            for name in answers}
    body = _fn("keyed", "response = {'z': x * 2, 'n': len(x)}",
               {"x": "$prep.x"})
    answers["keyed"] = _both(both, "POST", "/function/python", body)
    done["keyed"] = [_done(api, "/function/python/keyed") for api in both]
    return answers, done


def _docs(body):
    return [d for d in body["result"][1:]]


def test_function_posts_answer_as_jax(ran):
    answers, done = ran
    for name, (want, got) in answers.items():
        assert got == want == (201, {"result": PREFIX +
                                     f"/function/python/{name}"})


def test_function_artifacts_and_messages_equal_jax(both, ran):
    _, done = ran
    for name in ("prep", "keyed", "hashed", "fetched", "gone"):
        want, got = done[name]
        assert want["metadata"]["finished"] and got["metadata"]["finished"]
        _equal_values(both[1].ctx.artifacts.load(name),
                      both[0].ctx.artifacts.load(name))
        messages = [[d["functionMessage"] for d in _docs(b)
                     if "functionMessage" in d] for b in (want, got)]
        assert messages[0] == messages[1]
        assert got["metadata"].get("resultShapes") == \
            want["metadata"].get("resultShapes")
        assert {k: got["metadata"].get(k) for k in (
            "function", "functionParameters", "sandboxMode", "status")} == \
            {k: want["metadata"].get(k) for k in (
                "function", "functionParameters", "sandboxMode", "status")}
    prep = both[1].ctx.artifacts.load("prep")
    assert prep["x"].dtype == np.float32 and prep["y"].dtype == np.int32
    assert 30 < len(prep["x"]) < 64  # the blanks of column a dropped
    assert done["fetched"][1]["result"][1]["functionMessage"] == "fetched\n"
    assert both[1].ctx.artifacts.load("hashed") == {
        "n": 128, "layers": LAYER_CONFIGS}


def test_missing_response_fails_as_jax(ran):
    _, done = ran
    want, got = (b["result"][-1] for b in done["silent"])
    assert got["exception"] == want["exception"]
    assert "never assigned" in got["exception"]
    assert got["status"] == want["status"] == "deadLettered"
    for body in done["silent"]:
        assert body["metadata"]["finished"] is False


def test_patch_and_delete_answer_as_jax(both, ran):
    patched = _both(both, "PATCH", "/function/python/prep", {
        "function": PREP.replace("'float32'", "'float64'")})
    assert patched[0] == patched[1] == (200, {
        "result": PREFIX + "/function/python/prep"})
    done = [_done(api, "/function/python/prep") for api in both]
    assert all(b["metadata"]["finished"] for b in done)
    got, want = (api.ctx.artifacts.load("prep") for api in both[::-1])
    _equal_values(got, want)
    assert got["x"].dtype == np.float64
    assert done[1]["metadata"]["resultShapes"] == \
        done[0]["metadata"]["resultShapes"]
    deleted = _both(both, "DELETE", "/function/python/gone")
    assert deleted[0] == deleted[1] == (200, {"result": "deleted file gone"})
    assert _both(both, "GET", "/function/python/gone")[0][0] == 404
    assert _both(both, "GET", "/function/python/gone")[1][0] == 404
    for api in both:
        assert api.ctx.artifacts.find("gone") is None


REFUSED = {
    "lint": _fn("lint", "x = open('/etc/passwd')\nresponse = 1\n"),
    "dunder": _fn("dunder", "response = ().__class__.__bases__\n"),
    "hash lint": _fn("hashlint", "response = p", {"p": "#open('x')"}),
    "above the ceiling": _fn("ceiling", "response = 1", sandboxMode="trusted"),
    "unknown mode": _fn("mode", "response = 1", sandboxMode="jail"),
    "missing field": {"name": "nofn", "functionParameters": {}},
    "unsafe name": _fn("../x", "response = 1"),
    "duplicate": _fn("d", "response = 1"),
    "PATCH a missing name": ("PATCH", "/function/python/ghost", {}),
    "DELETE a missing name": ("DELETE", "/function/python/ghost", None),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusals_answer_as_jax(both, case):
    body = REFUSED[case]
    method, path = "POST", "/function/python"
    if isinstance(body, tuple):
        method, path, body = body
    want, got = _both(both, method, path, body)
    assert got == want
    assert got[0] in (404, 406, 409)
    if case in ("lint", "dunder", "hash lint"):
        assert got[1]["analysis"] and got[1]["result"].startswith(
            "analysis rejected the request")
    for name in ("lint", "dunder", "hashlint", "ceiling", "mode", "nofn"):
        assert not both[1].ctx.catalog.exists(name)


def test_timeout_is_not_yet_ported(both):
    """Named for the refusal it held until the job lifecycle came: the
    ``timeout`` field now answers, is stored and ends its job as in the
    JAX package (a deadline well past the JAX jail's start)."""
    answers = _both(both, "POST", "/function/python",
                    _fn("timed", "response = 1", timeout=90))
    assert answers[1] == answers[0]
    assert answers[1][0] == 201
    outcomes = []
    for api in both:
        api.ctx.jobs.wait("timed", timeout=120)
        meta = api.ctx.catalog.get_metadata("timed")
        outcomes.append((meta["finished"], meta["status"], meta["timeout"]))
    assert outcomes[1] == outcomes[0] == (True, "finished", 90.0)


def test_hash_expressions_in_class_and_method_parameters(both, ran):
    """``layer_configs`` and ``batch_size`` as ``#`` expressions: both
    packages build the same model; with one JAX tree in both stores the
    fit's losses agree."""
    prep = both[0].ctx.artifacts.load("prep")
    model = {"modelName": "hm", "modulePath": "learningorchestra_tpu.models",
             "class": "NeuralModel",
             "classParameters": {"layer_configs": LAYERS}}
    answers = _both(both, "POST", "/model/tensorflow", model)
    assert answers[0] == answers[1] == (201, {
        "result": PREFIX + "/model/tensorflow/hm"})
    for api in both:
        assert _done(api, "/model/tensorflow/hm")["metadata"]["finished"]
    jm = JaxNM(LAYER_CONFIGS)
    jm._build_params(np.asarray(prep["x"], np.float32))
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    pm = NeuralModel(LAYER_CONFIGS, device="cpu")
    pm.set_params(weights.params_from_flax(tree, sequential=True),
                  input_shape=jm.input_shape)
    for api, m in zip(both, (jm, pm)):
        assert api.ctx.artifacts.load("hm").layer_configs == LAYER_CONFIGS
        api.ctx.artifacts.save(m, "hm", "model/tensorflow")
    fit = {"name": "hm_t", "modelName": "hm", "method": "fit",
           "methodParameters": {"x": "$prep.x", "y": "$prep.y",
                                "batch_size": "#2 ** 3", "epochs": 2,
                                "shuffle": False}}
    answers = _both(both, "POST", "/train/tensorflow", fit)
    assert answers[0] == answers[1]
    losses = []
    for api in both:
        done = _done(api, "/train/tensorflow/hm_t")
        assert done["metadata"]["finished"], done["result"][-1]
        losses.append([d["epochRecord"]["loss"] for d in _docs(done)
                       if "epochRecord" in d])
    np.testing.assert_allclose(losses[1], losses[0], rtol=RTOL)
    # 8 rows a batch: as many steps as batches of the prepared rows
    assert len(losses[1]) == 2


def test_observe_answers_as_jax(both, ran):
    for api in both:
        status, body = _call(api, "GET", "/observe")
        assert status == 200 and set(body["result"]) == {"seq"}
        assert body["result"]["seq"] >= 1
    got = []
    for api in both:
        t0 = time.monotonic()
        status, body = _call(api, "GET", "/observe/keyed",
                             params={"seq": "0", "timeout": "5"})
        assert status == 200 and time.monotonic() - t0 < 5
        result = body["result"]
        assert result["seq"] >= result["changes"][-1]["seq"]
        got.append(([c["op"] for c in result["changes"]],
                    result["metadata"]["finished"]))
    assert got[0] == got[1]
    assert got[1][0][0] == "create" and got[1][1] is True
    # nothing past the newest seq: an empty answer once the window ends
    for api in both:
        seq = _call(api, "GET", "/observe")[1]["result"]["seq"]
        t0 = time.monotonic()
        status, body = _call(api, "GET", "/observe/keyed",
                             params={"seq": str(seq), "timeout": "0.3"})
        assert status == 200 and body["result"]["changes"] == []
        assert 0.25 < time.monotonic() - t0 < 5


def test_observe_wakes_on_a_commit_of_another_thread(both):
    """A long-poll returns when a job thread commits, not at its
    window's end."""
    port = both[1]
    seq = port.ctx.catalog.latest_seq()
    out = {}

    def poll():
        t0 = time.monotonic()
        out["body"] = _call(port, "GET", "/observe/woken",
                            params={"seq": str(seq), "timeout": "60"})
        out["seconds"] = time.monotonic() - t0

    thread = threading.Thread(target=poll)
    thread.start()
    time.sleep(0.3)
    assert _call(port, "POST", "/function/python",
                 _fn("woken", "response = 2"))[0] == 201
    thread.join(timeout=60)
    assert out["seconds"] < 10
    assert out["body"][1]["result"]["changes"][0]["op"] == "create"
    _done(port, "/function/python/woken")


def test_listing_of_functions_answers_as_jax(both, ran):
    listed = _both(both, "GET", "/function/python")
    names = [sorted(m["name"] for m in body["result"]
                    if m["name"] != "woken") for _, body in listed]
    assert names[0] == names[1]
    assert {"prep", "keyed", "hashed"} <= set(names[1])


def test_documents_of_a_function_keep_jax_keys(ran):
    """The ``functionMessage`` document, then the execution document,
    with the JAX package's keys."""
    _, done = ran
    for name in ("prep", "silent"):
        want, got = done[name]
        assert [sorted(d) for d in _docs(got)] == \
            [sorted(d) for d in _docs(want)]
        assert got["metadata"]["functionParameters"] == \
            want["metadata"]["functionParameters"]


def test_jax_dill_artifacts_load_where_dill_wrote_plain_pickle(
        tmp_path, monkeypatch):
    """What the JAX store wrote with dill (a fitted sklearn estimator, a
    dict of arrays) loads in the port through the standard pickle; what
    only dill can read raises, where dill is absent (the card's machine),
    an error that names dill."""
    from sklearn.linear_model import LogisticRegression

    from learningorchestra_tpu.catalog import ArtifactStore as JaxStore
    from learningorchestra_tpu_torch.catalog import ArtifactStore

    jax_store = JaxStore(str(tmp_path / "art"))
    x = np.random.default_rng(0).normal(size=(40, 3))
    y = (x[:, 0] > 0).astype(np.int64)
    model = LogisticRegression().fit(x, y)
    jax_store.save(model, "lr", "train/scikitlearn")
    jax_store.save({"x": x, "n": 3}, "fn", "function/python")
    jax_store.save(lambda v: v + 1, "closure", "function/python")
    store = ArtifactStore(str(tmp_path / "art"), device="cpu")
    for module in ("dill", "dill._dill"):
        monkeypatch.setitem(sys.modules, module, None)
    np.testing.assert_array_equal(store.load("lr").predict(x),
                                  model.predict(x))
    back = store.load("fn", "function/python")
    assert back["n"] == 3
    np.testing.assert_array_equal(back["x"], x)
    with pytest.raises(ValueError, match="dill"):
        store.load("closure", "function/python")
