"""The port's Builder (``POST /builder/sparkml``,
``learningorchestra_tpu_torch/services/builder_service.py``) through the
JAX package's ``Api`` and the port's on the same datasets and code.

- Requests answer alike: status codes, output names (one
  ``{testDatasetName}{classifier}`` URI a classifier), the 406s
  (``streaming`` with ``meshParallel``, a bad classifier, escaping
  ``modelingCode``, a missing field, a nonexistent dataset), and the
  output collections' metadata keys. The JAX package's observability
  keys (``compileSeconds``, ``perf``, ``sliceHistory``) are not ported;
  ``engine`` is ``"torch"`` where JAX writes ``"jax"`` and
  ``meshDevices`` is 1 (one card).
- Predictions: NB and GB equal, LR >= 99% equal on the card (the JAX
  mesh fit shuffles on the device in an order the port does not draw)
  and equal on the host. The port's host families are its own
  counterparts of the JAX package's sklearn estimators (``engine:
  "host"`` where JAX writes ``"sklearn"``): DT and GB predict as sklearn
  does wherever sklearn does not depend on its unseeded feature order
  (the tutorial's ``pclass``/``sex`` rows; GB on the continuous rows
  here), RF, drawn from its own seed, within 0.05 accuracy.
- ``accuracy`` and ``f1`` equal sklearn's ``accuracy_score`` and
  ``f1_score(average="weighted")`` of the port's predictions within
  1e-12 (the port counts a confusion matrix; sklearn's sums run in
  another order).
- The streaming path never reads a whole dataset (``read_table`` and
  ``read_columns`` raise), GB trains on every row and DT on a reservoir
  that holds them all.
- A failed classifier documents its own output and the others finish;
  with sklearn unimportable, every family finishes, with and without
  ``meshParallel`` and streaming.

The JAX side runs user code in its ``restricted`` sandbox (its jailed
child takes ~5 s to start); the port in its default ``subprocess`` one.
"""

import sys

import numpy as np
import pytest

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu_torch import client as lo_client
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services import builder_service
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api, RestServer

PREFIX = "/api/learningOrchestra/v1"
FEATS = ["f0", "f1", "f2", "f3"]
# the JAX package's observability and scheduler keys, not ported
JAX_ONLY_KEYS = {"compileSeconds", "perf", "sliceHistory"}
# the job's roofline: the JAX package's LR fit is one window, its
# compile, which carries none; the port compiles nothing, so its one
# window carries a roofline, stamped on the metadata as "perf"
PORT_ONLY_KEYS = {"perf"}
MODELING = """
import numpy as np
feats = ["f0", "f1", "f2", "f3"]
features_training = (training_df[feats].to_numpy(np.float32),
                     training_df["label"].to_numpy())
features_testing = testing_df[feats].to_numpy(np.float32)
features_evaluation = (testing_df[feats].to_numpy(np.float32),
                       testing_df["label"].to_numpy())
"""


def _synth(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    y = (x @ np.array([1.0, -2.0, 0.5, 1.5]) > 0).astype(np.int64)
    columns = {f: x[:, i] for i, f in enumerate(FEATS)}
    columns["label"] = y
    return columns


# the tutorial's section 6: a Titanic-shaped table (tests/test_server.py's
# generator) and its modelingCode on ``pclass`` and ``sex``
TITANIC_ROWS = 891
TITANIC_MODELING = (
    "import numpy as np\n"
    "def feats(df):\n"
    "    return np.stack([df['pclass'].to_numpy(float),"
    " (df['sex']=='female').to_numpy(float)], axis=1)\n"
    "features_training = (feats(training_df),"
    " training_df['survived'].to_numpy('int64'))\n"
    "features_evaluation = features_training\n"
    "features_testing = feats(testing_df)\n")


def _titanic(n=TITANIC_ROWS, seed=7):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        pclass = int(rng.integers(1, 4))
        sex = str(rng.choice(["male", "female"]))
        rng.uniform(1, 70), rng.uniform(5, 200)  # age, fare
        survived = int(rng.random() < (0.8 if sex == "female" else 0.2))
        rows.append((pclass, sex, survived))
    pclass, sex, survived = zip(*rows)
    return {"pclass": np.array(pclass, np.int64), "sex": np.array(sex),
            "survived": np.array(survived, np.int64)}


DATASETS = {"mp_train": (4096, 7), "mp_test": (1024, 8),
            "pl_test": (1024, 8),
            "st_train": (20000, 0), "st_test": (2000, 1),
            "st_eval": (2000, 2)}


def _write(catalog, name, columns, arrow):
    catalog.create_collection(name, "dataset/csv", {})
    with catalog.dataset_writer(name) as w:
        if arrow:
            import pyarrow as pa

            w.write_batch(pa.table(columns))
        else:
            w.write_batch(columns)
    catalog.mark_finished(name)


@pytest.fixture(scope="module")
def apis(tmp_path_factory):
    """The JAX and the port ``Api``, each holding ``DATASETS``."""
    root = tmp_path_factory.mktemp("builder")
    jax_config.set_config(jax_config.Config(home=str(root / "jax"),
                                            sandbox_mode="restricted"))
    from learningorchestra_tpu.services.server import Api as JaxApi

    pair = (JaxApi(), Api(ServiceContext(Config(home=str(root / "port")),
                                         device="cpu")))
    try:
        for arrow, api in zip((True, False), pair):
            for name, (n, seed) in DATASETS.items():
                _write(api.ctx.catalog, name, _synth(n, seed), arrow)
            _write(api.ctx.catalog, "titanic", _titanic(), arrow)
        yield pair
    finally:
        for api in pair:
            api.ctx.close()
        jax_config.reset_config()


def _call(api, method, path, body=None, params=None):
    return api.dispatch(method, PREFIX + path, params or {}, body)[:2]


def _run(api, body):
    status, answer = _call(api, "POST", "/builder/sparkml", body)
    if status == 201:
        first = answer["result"][0].rsplit("/", 1)[1]
        api.ctx.jobs.wait(first, timeout=600)
    return status, answer


def _outputs(api, test_name, classifiers):
    out = {}
    for c in classifiers:
        status, body = _call(api, "GET", f"/builder/sparkml/{test_name}{c}")
        assert status == 200
        rows = [r for r in body["result"] if "prediction" in r]
        out[c] = (body["metadata"], rows, body["result"])
    return out


def _predictions(rows):
    return np.array([r["prediction"] for r in rows])


def _assert_metrics_are_sklearns(meta, y_true, y_pred):
    from sklearn.metrics import accuracy_score, f1_score

    assert meta["accuracy"] == pytest.approx(
        accuracy_score(y_true, y_pred), rel=1e-12, abs=0)
    assert meta["f1"] == pytest.approx(
        f1_score(y_true, y_pred, average="weighted"), rel=1e-12, abs=0)


def _compare(jax_out, port_out, classifiers):
    for c in classifiers:
        (jm, jrows, _), (pm, prows, _) = jax_out[c], port_out[c]
        assert jm["finished"] is pm["finished"] is True, (c, pm)
        assert set(pm) - PORT_ONLY_KEYS == set(jm) - JAX_ONLY_KEYS, c
        assert len(prows) == len(jrows)
        assert set(prows[0]) == set(jrows[0])


def test_mesh_parallel_pipeline_answers_as_jax(apis):
    body = {"trainDatasetName": "mp_train", "testDatasetName": "mp_test",
            "evaluationDatasetName": "mp_test", "modelingCode": MODELING,
            "classifiersList": ["LR", "NB", "DT"], "meshParallel": True}
    answers = [_run(api, body) for api in apis]
    assert answers[1] == answers[0]
    assert answers[0][0] == 201 and len(answers[0][1]["result"]) == 3
    jax_out, port_out = (_outputs(api, "mp_test", ["LR", "NB", "DT"])
                         for api in apis)
    _compare(jax_out, port_out, ["LR", "NB", "DT"])
    y = _synth(*DATASETS["mp_test"])["label"]
    for c, engine, devices in (("LR", "torch", 1), ("NB", "torch", 1),
                               ("DT", "host", None)):
        meta, rows, _ = port_out[c]
        assert meta["engine"] == engine and meta.get("meshDevices") == \
            devices
        assert jax_out[c][0]["engine"] == ("sklearn" if engine ==
                                           "host" else "jax")
        assert meta["accuracy"] > 0.9
        _assert_metrics_are_sklearns(meta, y, _predictions(rows))
    # the job held the card lease: the first output records its wait
    assert "leaseWaitSeconds" in port_out["LR"][0]
    nb = [_predictions(out["NB"][1]) for out in (jax_out, port_out)]
    assert np.array_equal(nb[0], nb[1])
    lr = [_predictions(out["LR"][1]) for out in (jax_out, port_out)]
    assert np.mean(lr[0] == lr[1]) >= 0.99
    # the rows carry the test set's columns and the prediction
    first = port_out["LR"][1][0]
    assert [first[f] for f in FEATS] == pytest.approx(
        [_synth(*DATASETS["mp_test"])[f][0] for f in FEATS])


def test_plain_pipeline_fits_sklearn_as_jax(apis):
    """Without ``meshParallel`` the port fits its host counterparts of the
    JAX package's sklearn estimators (``engine: "host"``): LR, NB and GB
    predict as JAX does on every test row (GB's sklearn trees do not
    depend on their unseeded feature order on these rows), with equal
    accuracy and f1."""
    # a test set of its own: the JAX package attributes its traces by
    # collection name, so a reused output name would carry the mesh
    # job's lease wait into this job's metadata
    families = ["LR", "NB", "GB"]
    body = {"trainDatasetName": "mp_train", "testDatasetName": "pl_test",
            "evaluationDatasetName": "pl_test", "modelingCode": MODELING,
            "classifiersList": families}
    answers = [_run(api, body) for api in apis]
    assert answers[1] == answers[0]
    jax_out, port_out = (_outputs(api, "pl_test", families)
                         for api in apis)
    _compare(jax_out, port_out, families)
    for c in families:
        assert port_out[c][0]["engine"] == "host"
        assert jax_out[c][0]["engine"] == "sklearn"
        assert np.array_equal(_predictions(port_out[c][1]),
                              _predictions(jax_out[c][1]))
        for key in ("accuracy", "f1"):
            assert port_out[c][0][key] == pytest.approx(
                jax_out[c][0][key], rel=1e-12, abs=0)


def test_the_reference_body_fits_five_families_as_jax(apis):
    """The tutorial's section 6 without ``meshParallel`` (the reference's
    own body): all five families finish on the host; DT and GB predict
    every row as the JAX package's sklearn trees do (on ``pclass`` and
    ``sex`` their splits never tie), LR and NB too, and RF, whose trees
    the port draws from its own seed, within 0.05 accuracy."""
    families = ["LR", "NB", "DT", "RF", "GB"]
    body = {"trainDatasetName": "titanic", "testDatasetName": "titanic",
            "evaluationDatasetName": "titanic",
            "modelingCode": TITANIC_MODELING, "classifiersList": families}
    answers = [_run(api, body) for api in apis]
    assert answers[1] == answers[0]
    jax_out, port_out = (_outputs(api, "titanic", families)
                         for api in apis)
    _compare(jax_out, port_out, families)
    y = _titanic()["survived"]
    for c in families:
        meta, rows, _ = port_out[c]
        assert meta["engine"] == "host" and meta["accuracy"] > 0.6
        assert all("prediction" in r for r in rows)
        _assert_metrics_are_sklearns(meta, y, _predictions(rows))
        if c == "RF":
            assert abs(meta["accuracy"] - jax_out[c][0]["accuracy"]) < 0.05
            continue
        assert np.array_equal(_predictions(rows),
                              _predictions(jax_out[c][1])), c
        for key in ("accuracy", "f1"):
            assert meta[key] == pytest.approx(jax_out[c][0][key],
                                              rel=1e-12, abs=0)


def test_streaming_pipeline_never_reads_a_whole_dataset(apis, monkeypatch):
    jax_api, port_api = apis

    def whole(*args, **kwargs):
        raise AssertionError("the streaming builder read a whole dataset")

    catalog = type(port_api.ctx.catalog)
    monkeypatch.setattr(catalog, "read_table", whole)
    monkeypatch.setattr(catalog, "read_columns", whole)
    classifiers = ["LR", "NB", "GB", "DT"]
    body = {"trainDatasetName": "st_train", "testDatasetName": "st_test",
            "evaluationDatasetName": "st_eval",
            "classifiersList": classifiers, "streaming": True,
            "batchSize": 4096}
    answers = [_run(api, body) for api in apis]
    assert answers[1] == answers[0]
    jax_out, port_out = (_outputs(api, "st_test", classifiers)
                         for api in apis)
    _compare(jax_out, port_out, classifiers)
    for c in classifiers:
        meta = port_out[c][0]
        assert meta["streaming"] is True and meta["accuracy"] > 0.9
        assert meta["trainedOnSample"] is False
        assert set(port_out[c][1][0]) == set(FEATS) | {"prediction", "_id"}
    gb = port_out["GB"][0]
    assert gb["trainedRows"] == DATASETS["st_train"][0]
    assert gb["booster"] == jax_out["GB"][0]["booster"]
    for c in ("NB", "GB"):
        assert np.array_equal(_predictions(port_out[c][1]),
                              _predictions(jax_out[c][1]))
        for key in ("accuracy", "f1"):
            assert port_out[c][0][key] == pytest.approx(
                jax_out[c][0][key], rel=1e-12, abs=0)


REFUSALS = {
    "streaming with meshParallel": {
        "trainDatasetName": "mp_train", "testDatasetName": "mp_test",
        "classifiersList": ["LR"], "streaming": True,
        "meshParallel": True},
    "bad classifier": {
        "trainDatasetName": "mp_train", "testDatasetName": "mp_test",
        "modelingCode": MODELING, "classifiersList": ["LR", "SVM"]},
    "empty classifier list": {
        "trainDatasetName": "mp_train", "testDatasetName": "mp_test",
        "modelingCode": MODELING, "classifiersList": []},
    "escaping modelingCode": {
        "trainDatasetName": "mp_train", "testDatasetName": "mp_test",
        "modelingCode": "import os\nfeatures_training = training_df\n",
        "classifiersList": ["LR"]},
    "missing modelingCode": {
        "trainDatasetName": "mp_train", "testDatasetName": "mp_test",
        "classifiersList": ["LR"]},
    "nonexistent dataset": {
        "trainDatasetName": "ghost", "testDatasetName": "mp_test",
        "modelingCode": MODELING, "classifiersList": ["LR"]},
    "nonexistent evaluation dataset": {
        "trainDatasetName": "mp_train", "testDatasetName": "mp_test",
        "evaluationDatasetName": "ghost", "modelingCode": MODELING,
        "classifiersList": ["LR"]},
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_answer_as_jax(apis, case):
    body = dict(REFUSALS[case], testDatasetName="rf_test")
    for api in apis:
        if not api.ctx.catalog.exists("rf_test"):
            _write(api.ctx.catalog, "rf_test", _synth(8, 3),
                   api is apis[0])
    got, want = (_call(api, "POST", "/builder/sparkml", body)
                 for api in apis[::-1])
    assert got == want
    assert got[0] == 406
    for api in apis:
        assert not any(api.ctx.catalog.exists(f"rf_test{c}")
                       for c in ("LR", "SVM"))


def test_outputs_list_read_patch_and_delete_as_jax(apis):
    body = {"trainDatasetName": "mp_train", "testDatasetName": "od_test",
            "modelingCode": MODELING.replace(
                "features_evaluation = (testing_df[feats].to_numpy("
                "np.float32),\n                       testing_df"
                "[\"label\"].to_numpy())\n", ""),
            "classifiersList": ["NB"]}
    for api in apis:
        _write(api.ctx.catalog, "od_test", _synth(16, 4), api is apis[0])
        assert _run(api, body)[0] == 201
    got, want = ([sorted(m["name"] for m in _call(
        api, "GET", "/builder/sparkml")[1]["result"])] for api in apis)
    assert got == want and "od_testNB" in got[0]
    reads = [_call(api, "GET", "/builder/sparkml/od_testNB",
                   params={"skip": "1", "limit": "2"}) for api in apis]
    assert [r[0] for r in reads] == [200, 200]
    assert [len(r[1]["result"]) for r in reads] == [2, 2]
    assert "accuracy" not in reads[1][1]["metadata"]
    got, want = (_call(api, "PATCH", "/builder/sparkml/od_testNB", {})
                 for api in apis[::-1])
    assert got == want and got[0] == 406
    got, want = (_call(api, "DELETE", "/builder/sparkml/od_testNB")
                 for api in apis[::-1])
    assert got == want and got[0] == 200
    got, want = (_call(api, "GET", "/builder/sparkml/od_testNB")
                 for api in apis[::-1])
    assert got[0] == want[0] == 404


def test_a_failed_classifier_documents_its_own_output_as_jax(
        apis, monkeypatch):
    """DT fails in both packages (its factory raises): its output gets
    the classifier's document and then the job's, LR and NB finish, and
    the documents match the JAX package's."""
    from learningorchestra_tpu.services import builder_service as jax_bs

    def failing(make):
        def make_classifier(name):
            if name == "DT":
                raise ImportError("No module named 'sklearn'")
            return make(name)
        return make_classifier

    for module in (jax_bs, builder_service):
        monkeypatch.setattr(module, "_make_classifier",
                            failing(module._make_classifier))
    body = {"trainDatasetName": "mp_train", "testDatasetName": "fail_test",
            "modelingCode": MODELING, "classifiersList": ["LR", "NB", "DT"],
            "meshParallel": True}
    docs = []
    for api in apis:
        _write(api.ctx.catalog, "fail_test", _synth(64, 5), api is apis[0])
        assert _run(api, body)[0] == 201
        out = _outputs(api, "fail_test", ["LR", "NB", "DT"])
        assert out["LR"][0]["finished"] and out["NB"][0]["finished"]
        assert not out["DT"][0]["finished"]
        docs.append({c: [(d.get("description"), d.get("exception"),
                          d.get("status"))
                         for d in out[c][2] if "description" in d]
                     for c in ("LR", "NB", "DT")})
    assert docs[1] == docs[0]
    dt = docs[1]["DT"]
    assert dt[0] == ("builder classifier",
                     "ImportError(\"No module named 'sklearn'\")", None)
    assert dt[1][0] == "builder pipeline" and dt[1][2] == "deadLettered"


def test_without_sklearn_dt_fails_and_the_card_families_finish(
        apis, monkeypatch):
    """With sklearn unimportable every family finishes (the name is kept
    from when DT, RF and GB needed sklearn): the five with and without
    ``meshParallel``, and the four streaming ones (LR, NB, DT, RF)."""
    port = apis[1]
    for name in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    families = ["LR", "NB", "DT", "RF", "GB"]
    for test, extra, engines in (
            ("nosk_test", {"meshParallel": True},
             {"LR": "torch", "NB": "torch"}),
            ("nosk_plain", {}, {})):
        _write(port.ctx.catalog, test, _synth(256, 6), False)
        body = {"trainDatasetName": "mp_train", "testDatasetName": test,
                "evaluationDatasetName": test, "modelingCode": MODELING,
                "classifiersList": families, **extra}
        assert _run(port, body)[0] == 201
        out = _outputs(port, test, families)
        for c in families:
            meta = out[c][0]
            assert meta["finished"], (test, c, out[c][2])
            assert meta["engine"] == engines.get(c, "host")
            assert meta["accuracy"] > 0.9  # metrics without sklearn
    streaming = ["LR", "NB", "DT", "RF"]
    body = {"trainDatasetName": "st_train", "testDatasetName": "st_nosk",
            "evaluationDatasetName": "st_eval",
            "classifiersList": streaming, "streaming": True,
            "batchSize": 4096}
    _write(port.ctx.catalog, "st_nosk", _synth(500, 9), False)
    assert _run(port, body)[0] == 201
    out = _outputs(port, "st_nosk", streaming)
    for c in streaming:
        assert out[c][0]["finished"] and out[c][0]["streaming"] is True
        assert out[c][0]["accuracy"] > 0.9, (c, out[c][0])
        assert len(out[c][1]) == 500


def test_client_runs_the_builder_over_http(apis, tmp_path):
    """``client.run_builder`` against the port's RestServer, as the
    tutorial's section 6 calls it."""
    server = RestServer(port=0, context=ServiceContext(
        Config(home=str(tmp_path)), device="cpu")).start()
    try:
        for name in ("mp_train", "mp_test"):
            _write(server.api.ctx.catalog, name,
                   _synth(*DATASETS[name]), False)
        client = lo_client.Context(server.base_url)
        uris = client.builder_sparkml.run_builder(
            "mp_train", "mp_test", MODELING, ["LR", "NB"],
            meshParallel=True, evaluationDatasetName="mp_test")
        assert uris == [f"{PREFIX}/builder/sparkml/mp_test{c}"
                        for c in ("LR", "NB")]
        for c in ("LR", "NB"):
            meta = client.wait(f"mp_test{c}", timeout=120)
            assert meta["finished"] and meta["engine"] == "torch"
            rows = client.builder_sparkml.read(f"mp_test{c}", skip=1,
                                               limit=3)["result"]
            assert all("prediction" in r for r in rows)
    finally:
        server.stop()


def test_helpers_match_the_jax_builder():
    """``_confusion_metrics``, ``_reservoir_update`` and ``_split_xy``
    give the JAX builder's results; ``_split_xy`` takes a catalog Table
    as the JAX one takes a DataFrame."""
    import pandas as pd

    from learningorchestra_tpu.services import builder_service as jax_bs
    from learningorchestra_tpu_torch.catalog.store import Table

    rng = np.random.default_rng(0)
    confusion = rng.integers(0, 50, size=(4, 4))
    assert builder_service._confusion_metrics(confusion) == \
        jax_bs._confusion_metrics(confusion)
    x, y = rng.normal(size=(5000, 3)), rng.integers(0, 3, size=5000)
    states = []
    for module in (jax_bs, builder_service):
        r = np.random.default_rng(17)
        res_x = res_y = None
        seen = 0
        for start in range(0, 5000, 700):
            res_x, res_y, seen = module._reservoir_update(
                res_x, res_y, x[start:start + 700], y[start:start + 700],
                seen, 1000, r)
        states.append((res_x, res_y, seen))
    assert states[1][2] == states[0][2] == 5000
    assert np.array_equal(states[1][0], states[0][0])
    assert np.array_equal(states[1][1], states[0][1])
    columns = _synth(10, 9)
    frame = pd.DataFrame(columns)
    table = Table(columns, 10)
    for needs_label in (True, False):
        want = jax_bs._split_xy(frame, needs_label)
        for value in (frame, table):
            got = builder_service._split_xy(value, needs_label)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    no_label = pd.DataFrame({f: columns[f] for f in FEATS})
    np.testing.assert_array_equal(
        builder_service._split_xy(Table(
            {f: columns[f] for f in FEATS}, 10), False)[0],
        jax_bs._split_xy(no_label, False)[0])
    with pytest.raises(ValueError, match="label"):
        builder_service._split_xy(no_label, True)
    assert builder_service._split_xy(None, True) == (None, None)
    tup = builder_service._split_xy((x[:4], y[:4]), True)
    np.testing.assert_array_equal(tup[1], y[:4])
    y_true, y_pred = rng.integers(0, 3, 500), rng.integers(0, 4, 500)
    _assert_metrics_are_sklearns(
        builder_service._classification_metrics(y_true, y_pred),
        y_true, y_pred)
