"""The PyTorch port's explore and transform routes and its URL ingest on
the CPU, held against the JAX package (its native CSV core patched off,
so it parses with pyarrow, the port's reference).

- One CSV (ints, floats with a null, text with an empty cell, booleans,
  integral floats written as ``3.0``) through both packages' ``Api``:
  ``transform/projection`` gives the same rows, ``explore/histogram`` the
  same documents (buckets in first-row order, a null as ``None``), and
  ``transform/dataType`` the same values (``""`` to a null, integral
  numbers as ints, numbers to text as pandas writes them), there and
  back.
- Reflection: ``transform/scikitlearn`` stores the fitted estimator,
  PATCH re-runs it, DELETE removes it; ``explore/scikitlearn`` answers a
  PNG; where matplotlib cannot be imported the port's job fails with an
  ``ImportError`` that names it.
- ``http://`` ingest and ``dataset/generic`` from a local
  ``http.server``: the same rows and the same bytes.
"""

import functools
import http.server
import os
import sys
import threading
import time

import numpy as np
import pytest

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu import native as jax_native
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services import columnar
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

PREFIX = "/api/learningOrchestra/v1"
# what differs between two runs of one job: times
_TIMES = ("timeCreated", "elapsedSeconds", "queueWaitSeconds",
          "leaseWaitSeconds", "url")

CSV = ("id,score,name,flag,label,ftxt\n"
       "1,2.5,ann,true,1,3.0\n"
       "2,,bob,false,0,4.0\n"
       "3,1.25,,true,1,12.0\n"
       "4,7.0,ann,true,1,3.0\n"
       "5,-0.5,cy,false,0,-2.0\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("files")
    (root / "d.csv").write_text(CSV)
    rng = np.random.default_rng(0)
    (root / "blob.bin").write_bytes(rng.integers(0, 256, 70000,
                                                 dtype=np.uint8).tobytes())
    return root


@pytest.fixture(scope="module")
def httpd(files):
    """A local HTTP server over the files (no network)."""
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=str(files))
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    server.RequestHandlerClass.log_message = lambda *a: None
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


@pytest.fixture(scope="module")
def apis(tmp_path_factory, files):
    root = tmp_path_factory.mktemp("apis")
    jax_config.set_config(jax_config.Config(home=str(root / "jax")))
    from learningorchestra_tpu.services.server import Api as JaxApi

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        pair = (JaxApi(), Api(ServiceContext(
            Config(home=str(root / "port")), device="cpu")))
        try:
            for api in pair:
                assert _call(api, "POST", "/dataset/csv", {
                    "datasetName": "d", "datasetURI": str(
                        files / "d.csv")})[0] == 201
                _done(api, "d")
            yield pair
        finally:
            for api in pair:
                api.ctx.close()
            jax_config.reset_config()


def _call(api, method, path, body=None, **params):
    return api.dispatch(method, PREFIX + path, params, body)


def _done(api, name, timeout=120):
    api.ctx.jobs.wait(name, timeout=timeout)
    # the job marks finished, then appends its execution document
    deadline = time.monotonic() + 30
    while "queueWaitSeconds" not in api.ctx.catalog.get_documents(name)[-1] \
            and not api.ctx.catalog.get_documents(name)[-1].get("exception"):
        assert time.monotonic() < deadline
        time.sleep(0.01)


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in _TIMES}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _read(api, path):
    status, body, _ = _call(api, "GET", path)
    assert status == 200, body
    return _strip(body)


def _both(apis, method, path, body=None):
    return [_call(api, method, path, body)[:2] for api in apis]


def test_projection_rows_match_jax(apis):
    answers = _both(apis, "POST", "/transform/projection", {
        "inputDatasetName": "d", "outputDatasetName": "proj",
        "names": ["label", "score", "name"]})
    assert answers[1] == answers[0]
    assert answers[1][0] == 201
    for api in apis:
        _done(api, "proj")
    want, got = (_read(api, "/transform/projection/proj") for api in apis)
    assert got == want
    assert [r["score"] for r in got["result"][1:6]] == [
        2.5, None, 1.25, 7.0, -0.5]


def test_histogram_documents_match_jax(apis):
    answers = _both(apis, "POST", "/explore/histogram", {
        "inputDatasetName": "d", "outputDatasetName": "hist",
        "names": ["label", "name", "score", "flag", "ftxt"]})
    assert answers[1] == answers[0]
    for api in apis:
        _done(api, "hist")
    want, got = (_read(api, "/explore/histogram/hist") for api in apis)
    assert got == want
    assert got["result"][1] == {"label": [{"_id": 1, "count": 3},
                                          {"_id": 0, "count": 2}],
                                "_id": 1}


def test_histogram_counts_equal_numpy_unique():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 7, 1000)
    mask = rng.random(1000) < 0.1
    got = columnar.value_counts(data, mask)
    present = data[~mask]
    values, counts = np.unique(present, return_counts=True)
    assert sorted((v, c) for v, c in got if v is not None) == \
        sorted(zip(values.tolist(), counts.tolist()))
    assert (None, int(mask.sum())) in got
    firsts = [int(np.flatnonzero((data == v) & ~mask)[0]) if v is not None
              else int(np.flatnonzero(mask)[0]) for v, _ in got]
    assert firsts == sorted(firsts)


@pytest.mark.parametrize("types", [
    {"ftxt": "number", "id": "string", "score": "string"},
    {"id": "number", "score": "number", "flag": "string"},
    {"name": "number"}], ids=["to number and text", "back",
                              "a failed cast"])
def test_datatype_values_match_jax(apis, types):
    """In order: integral floats to ints and numbers to text, then the
    text back to numbers; a text column that is not numeric fails the
    job in both, leaving the rows as they were."""
    answers = _both(apis, "POST", "/transform/dataType",
                    {"datasetName": "d", "types": types})
    assert answers[1] == answers[0]
    for api in apis:
        _done(api, "d")
    want, got = (_read(api, "/dataset/csv/d") for api in apis)
    assert got["metadata"] == want["metadata"]
    assert got["result"][1:6] == want["result"][1:6]
    failed = [bool(body["result"][-1]["exception"]) for body in (want, got)]
    assert failed == [types == {"name": "number"}] * 2


@pytest.mark.parametrize("case", ["unknown field", "bad type",
                                  "missing types", "unknown dataset",
                                  "duplicate output"])
def test_columnar_refusals_match_jax(apis, case):
    method, path, body = {
        "unknown field": ("POST", "/transform/projection", {
            "inputDatasetName": "d", "outputDatasetName": "p2",
            "names": ["ghost"]}),
        "bad type": ("POST", "/transform/dataType", {
            "datasetName": "d", "types": {"id": "date"}}),
        "missing types": ("POST", "/transform/dataType", {
            "datasetName": "d"}),
        "unknown dataset": ("POST", "/explore/histogram", {
            "inputDatasetName": "ghost", "outputDatasetName": "h2",
            "names": ["x"]}),
        "duplicate output": ("POST", "/explore/histogram", {
            "inputDatasetName": "d", "outputDatasetName": "d",
            "names": ["id"]}),
    }[case]
    answers = _both(apis, method, path, body)
    assert answers[1] == answers[0]
    assert answers[1][0] in (404, 406, 409)


SCALER = {"name": "scaler", "modulePath": "sklearn.preprocessing",
          "class": "StandardScaler", "classParameters": {},
          "method": "fit", "methodParameters": {"X": [[1.0, 2.0],
                                                      [3.0, 6.0]]}}


def test_transform_reflection_patch_and_delete_match_jax(apis):
    pytest.importorskip("sklearn")
    assert _both(apis, "POST", "/transform/scikitlearn", SCALER) == \
        [(201, {"result": PREFIX + "/transform/scikitlearn/scaler"})] * 2
    for api in apis:
        _done(api, "scaler")
    means = [api.ctx.artifacts.load("scaler").mean_ for api in apis]
    np.testing.assert_array_equal(means[1], means[0])
    assert _both(apis, "PATCH", "/transform/scikitlearn/scaler", {
        "methodParameters": {"X": [[5.0, 0.0], [7.0, 2.0]]}}) == \
        [(200, {"result": PREFIX + "/transform/scikitlearn/scaler"})] * 2
    for api in apis:
        _done(api, "scaler")
    means = [api.ctx.artifacts.load("scaler").mean_ for api in apis]
    np.testing.assert_array_equal(means[1], [6.0, 1.0])
    np.testing.assert_array_equal(means[1], means[0])
    want, got = _both(apis, "DELETE", "/transform/scikitlearn/scaler")
    assert got == want and got[0] == 200
    want, got = _both(apis, "GET", "/transform/scikitlearn/scaler")
    assert got == want and got[0] == 404


def test_explore_plot_is_a_png_as_jax(apis):
    body = {"name": "plot", "modulePath": "numpy", "class": "eye",
            "classParameters": {"N": 5}}
    assert _both(apis, "POST", "/explore/scikitlearn", body)[1][0] == 201
    for api in apis:
        _done(api, "plot")
    answers = [_call(api, "GET", "/explore/scikitlearn/plot")
               for api in apis]
    for status, payload, content_type in answers:
        assert status == 200 and content_type == "image/png"
        assert payload[:8] == b"\x89PNG\r\n\x1a\n"
    # paged reads still give the documents, for polling
    for api in apis:
        status, body, _ = _call(api, "GET", "/explore/scikitlearn/plot",
                                limit="1")
        assert status == 200 and body["metadata"]["finished"]


def test_explore_without_matplotlib_fails_with_an_import_error(
        apis, monkeypatch):
    port = apis[1]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    assert _call(port, "POST", "/explore/scikitlearn", {
        "name": "noplot", "modulePath": "numpy", "class": "eye",
        "classParameters": {"N": 3}})[0] == 201
    _done(port, "noplot")
    doc = port.ctx.catalog.get_documents("noplot")[-1]
    assert doc["exception"].startswith("ImportError(")
    assert "an explore plot needs matplotlib and seaborn" in \
        doc["exception"]
    assert doc["errorKind"] == "permanent"
    assert port.ctx.catalog.get_metadata("noplot")["finished"] is False


def test_http_and_generic_ingest_match_jax(apis, httpd, files):
    for name, tool, path in (("web", "csv", "d.csv"),
                             ("blob", "generic", "blob.bin")):
        answers = _both(apis, "POST", f"/dataset/{tool}", {
            "datasetName": name, "datasetURI": f"{httpd}/{path}"})
        assert answers[1] == answers[0]
        assert answers[1][0] == 201
    for api in apis:
        _done(api, "web")
        _done(api, "blob")
    want, got = (_read(api, "/dataset/csv/web") for api in apis)
    assert got == want
    assert len(got["result"]) == 1 + 5 + 1
    want, got = (_read(api, "/dataset/generic/blob")["metadata"]
                 for api in apis)
    assert got == want and got["sizeBytes"] == 70000
    raw = (files / "blob.bin").read_bytes()
    for api in apis:
        assert api.ctx.artifacts.load("blob", "dataset/generic") == raw
    # a URL that answers 404 fails the job in both
    for api in apis:
        _call(api, "POST", "/dataset/csv", {
            "datasetName": "gone", "datasetURI": f"{httpd}/nope.csv"})
        _done(api, "gone")
    errors = [api.ctx.catalog.get_documents("gone")[-1] for api in apis]
    assert all(e["exception"] for e in errors)
    assert [e["status"] for e in errors] == ["deadLettered"] * 2
    assert os.path.getsize(files / "blob.bin") == 70000
