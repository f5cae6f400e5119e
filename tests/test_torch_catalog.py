"""The PyTorch port's catalog, artifact store, CSV ingest and ``$``
resolution, held against the JAX package's on the CPU.

The port keeps datasets as numpy columns (no pyarrow, no pandas); the
JAX package keeps Parquet and reads pandas. The same operations and the
same CSV go into both, and what a client sees must match: metadata and
execution documents, the paged ``GET`` bodies (except timestamps, the
seconds a job took and the JAX-only ``analysis``), the rows with their
``_id``, and ``dataframe_to_arrays`` of ``$name``. The JAX ingest runs
its pyarrow CSV reader (its optional native parser is switched off: the
port takes pyarrow's inference as its reference).
"""

import csv
import io
import json
import time

import numpy as np
import pyarrow as pa
import pyarrow.csv as pa_csv
import pytest

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu import native as jax_native
from learningorchestra_tpu.catalog.store import Catalog as JaxCatalog
from learningorchestra_tpu.runtime import data as jax_data
from learningorchestra_tpu_torch.catalog.artifacts import ArtifactStore
from learningorchestra_tpu_torch.catalog.store import Catalog, Table
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models.neural import History
from learningorchestra_tpu_torch.runtime import data
from learningorchestra_tpu_torch.services import dataset as dataset_service
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

PREFIX = "/api/learningOrchestra/v1"
# fields whose values depend on the clock
_CLOCK_FIELDS = ("timeCreated",)


def _normalize(value):
    """A GET body with the clock's values blanked and the JAX-only
    ``analysis`` dropped: every key stays, so shapes still compare."""
    if isinstance(value, list):
        return [_normalize(v) for v in value]
    if isinstance(value, dict):
        return {k: (None if k in _CLOCK_FIELDS or k.endswith("Seconds")
                    else _normalize(v))
                for k, v in value.items() if k != "analysis"}
    return value


def _catalog_script(cat):
    """One sequence of catalog operations; returns what each step
    gave, timestamps blanked."""
    out = [cat.create_collection("a", "dataset/csv", {"url": "x.csv"}),
           cat.create_collection("m", "model/tensorflow", {"class": "C"}),
           cat.create_collection("e", "evaluate/sckitlearn")]
    seq0 = cat.latest_seq()
    cat.update_metadata("a", {"fields": ["u"], "rows": 0})
    cat.mark_finished("m", {"note": 1})
    out.append([cat.append_document("m", {"n": i}) for i in range(3)])
    out += [cat.get_metadata("a"), cat.get_metadata("nope"),
            cat.get_type("e"), cat.exists("m"), cat.exists("nope"),
            cat.get_documents("m"), cat.list_collections(),
            cat.list_collections("model/tensorflow"),
            cat.list_collections("evaluate/sckitlearn"),
            cat.read_entries("m", skip=1, limit=2),
            cat.read_entries("m", query={"n": {"$gte": 1}}),
            cat.latest_seq() - seq0, cat.collection_seq("m") > 0,
            cat.delete_collection("m"), cat.delete_collection("m"),
            cat.exists("m"), [c["name"] for c in cat.list_collections()]]
    return _normalize(out)


def test_catalog_documents_match_jax(tmp_path):
    port = Catalog(str(tmp_path / "p.sqlite"), str(tmp_path / "pd"))
    jax = JaxCatalog(str(tmp_path / "j.sqlite"), str(tmp_path / "jd"))
    try:
        got, want = _catalog_script(port), _catalog_script(jax)
    finally:
        port.close()
        jax.close()
    assert got == want
    assert got[2]["type"] == "evaluate/scikitlearn"  # the typo's alias
    assert got[3] == [1, 2, 3]


def _sample_columns(n: int = 7):
    rng = np.random.default_rng(3)
    ints = rng.integers(-5, 5, size=n).astype(object)
    ints[2] = None
    floats = rng.normal(size=n).astype(object)
    floats[4] = None
    bools = (rng.random(n) < 0.5).astype(object)
    bools[1] = None
    words = np.array(["b", "a", None, "b", "c", "a", "d"][:n], object)
    return {"i": ints.tolist(), "f": floats.tolist(), "b": bools.tolist(),
            "s": words.tolist(), "k": list(range(n))}


def test_dataset_rows_and_table_match_pyarrow(tmp_path):
    """Rows (``_id`` from 1, nulls as None) at several pages and queries,
    and the Table's columns against ``pyarrow.Table.to_pandas``."""
    columns = _sample_columns()
    port = Catalog(str(tmp_path / "p.sqlite"), str(tmp_path / "pd"))
    jax = JaxCatalog(str(tmp_path / "j.sqlite"), str(tmp_path / "jd"))
    try:
        for cat in (port, jax):
            cat.create_collection("ds", "dataset/csv")
        with port.dataset_writer("ds") as w:
            w.write_batch({k: v[:4] for k, v in columns.items()})
            w.write_batch({k: v[4:] for k, v in columns.items()})
        with jax.dataset_writer("ds") as w:
            w.write_batch(pa.table(columns))
        for skip, limit, query in ((0, None, None), (2, 3, None),
                                   (1, 2, {"s": "a"}),
                                   (0, 0, {"i": {"$gte": 0}})):
            assert port.read_rows("ds", skip, limit, query) == \
                jax.read_rows("ds", skip, limit, query)
        assert port.count_rows("ds") == 7
        table = port.read_table("ds")
        frame = jax.read_dataframe("ds")
        assert isinstance(table, Table) and len(table) == 7
        assert table.columns == list(frame.columns)
        for name in columns:
            want = frame[name].to_numpy()
            got = table[name]
            assert got.dtype == (object if want.dtype.kind in "OUT"
                                 else want.dtype), name
            if got.dtype == object:
                assert got.tolist() == [None if v is None or v != v else v
                                        for v in want.tolist()]
            else:
                np.testing.assert_array_equal(got, want)
        assert table.to_numpy().shape == (7, 5)
        assert port.delete_collection("ds") and port.count_rows("ds") == 0
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("cells", [
    ["1", "0", "-7", " 5"], ["+5", "6"], ["1e5", ".5", "-inf"],
    ["1", "0", "true"], ["True", "FALSE", "NA"], ["NA", "x", ""],
    ["NA", "nan", ""], ["1_0", "2"], ["9223372036854775808", "1"],
    ["t", "f"], ["1.5", "", "2"], ["", "3", "null"]])
def test_csv_kind_inference_matches_pyarrow(cells):
    """Each column's kind and values as pyarrow's CSV reader infers
    them (a second column keeps empty cells off empty lines)."""
    text = "a,pad\n" + "".join(f"{c},0\n" for c in cells)
    table = pa_csv.read_csv(io.BytesIO(text.encode()))
    want = table.column("a").to_pylist()
    kind = dataset_service.infer_kind(cells)
    assert {"int64": "int64", "double": "float64", "bool": "bool",
            "string": "string", "null": "null"}[
        str(table.schema.field("a").type)] == kind
    column = dataset_service.convert(kind, cells)
    got = [None if m else v for v, m in zip(
        np.asarray(column).tolist(), np.ma.getmaskarray(column).tolist())]
    assert got == want


# ----------------------------------------------------------------------
# the same CSV through both REST planes
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus_csv(tmp_path_factory):
    """int, float, bool and string columns, empty cells, a quoted comma,
    and a 2048-column token row block (``t0..t2047``)."""
    path = tmp_path_factory.mktemp("csv") / "mixed.csv"
    rng = np.random.default_rng(5)
    header = ["n", "x", "flag", "word"] + [f"t{i}" for i in range(2048)]
    words = ["alpha", "beta, gamma", "", "delta", "beta, gamma", "eps"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i in range(6):
            w.writerow([i if i != 3 else "", round(float(rng.normal()), 4)
                        if i != 1 else "", ["true", "false"][i % 2]
                        if i != 4 else "", words[i]]
                       + rng.integers(1, 97, size=2048).tolist())
    return str(path)


@pytest.fixture(scope="module")
def apis(tmp_path_factory, corpus_csv):
    root = tmp_path_factory.mktemp("apis")
    jax_config.set_config(jax_config.Config(home=str(root / "jax_home")))
    from learningorchestra_tpu.services.server import Api as JaxApi

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        jax_api = JaxApi()
        port_api = Api(ServiceContext(Config(home=str(root / "port_home")),
                                      device="cpu"))
        try:
            for api in (jax_api, port_api):
                status, body = api.dispatch(
                    "POST", PREFIX + "/dataset/csv", {},
                    {"datasetName": "mixed", "datasetURI": corpus_csv})[:2]
                assert status == 201, body
            for api in (jax_api, port_api):
                api.ctx.jobs.wait("mixed", timeout=120)
            yield jax_api, port_api
        finally:
            jax_api.ctx.close()
            port_api.ctx.close()
            jax_config.reset_config()


@pytest.mark.parametrize("params,count", [
    ({}, 8), ({"skip": "0", "limit": "2"}, 2),
    ({"skip": "3", "limit": "4"}, 4), ({"limit": "1"}, 1), ({"skip": "6"}, 2),
    ({"query": json.dumps({"flag": True})}, 2),
    ({"query": json.dumps({"n": {"$gte": 2}}), "skip": "1", "limit": "2"}, 2),
    ({"query": json.dumps({"word": "beta, gamma"})}, 2),
    ({"query": json.dumps({"description": {"$ne": None}})}, 1)])
def test_csv_ingest_pages_match_jax(apis, params, count):
    """The metadata document, 6 rows and the ingest's execution document
    as one paged sequence."""
    jax_api, port_api = apis
    got, want = (api.dispatch("GET", PREFIX + "/dataset/csv/mixed", params,
                              None)[:2] for api in (port_api, jax_api))
    assert got[0] == want[0] == 200
    assert _normalize(got[1]) == _normalize(want[1])
    assert len(got[1]["result"]) == count


def test_csv_ingest_listing_and_metadata_match_jax(apis):
    jax_api, port_api = apis
    got, want = (api.dispatch("GET", PREFIX + "/dataset/csv", {}, None)[:2]
                 for api in (port_api, jax_api))
    assert _normalize(got) == _normalize(want)
    meta = got[1]["result"][0]
    assert meta["finished"] and meta["rows"] == 6 and \
        meta["fields"][:5] == ["n", "x", "flag", "word", "t0"]


def test_table_feed_matches_jax_dataframe_feed(apis):
    """``dataframe_to_arrays`` of ``$mixed`` (a Table in the port, a
    DataFrame in the JAX package): string codes in order of first
    appearance, nulls of numeric columns as 0, ``_id`` dropped."""
    jax_api, port_api = apis
    table = port_api.ctx.params.resolve_value("$mixed")
    frame = jax_api.ctx.params.resolve_value("$mixed")
    assert isinstance(table, Table)
    for label in (None, "word", "n"):
        got = data.dataframe_to_arrays(table, label_column=label)
        want = jax_data.dataframe_to_arrays(frame, label_column=label)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, (label, key)
            np.testing.assert_array_equal(got[key], want[key])
    codes = data.dataframe_to_arrays(table, feature_columns=["word"])["x"]
    assert codes[:, 0].tolist() == [0, 1, 2, 3, 1, 4]


# ----------------------------------------------------------------------
# artifacts and "$" resolution
# ----------------------------------------------------------------------
def test_results_are_stored_without_pickle(tmp_path):
    store = ArtifactStore(str(tmp_path / "art"), device="cpu")
    arr = np.arange(12, dtype=np.int32).reshape(3, 4)
    store.save(arr, "gen", "predict/tensorflow")
    np.testing.assert_array_equal(store.load("gen"), arr)
    value = {"loss": np.float32(0.5), "acc": 0.25, "rows": [arr, (1, "x")],
             "nested": {"ok": True, "none": None}}
    store.save(value, "ev", "evaluate/tensorflow")
    back = store.load("ev", "evaluate/tensorflow")
    np.testing.assert_array_equal(back["rows"][0], arr)
    assert back["rows"][1] == [1, "x"] and back["loss"] == 0.5 and \
        back["nested"] == {"ok": True, "none": None}
    history = History([{"loss": 2.0, "epoch": 0}, {"loss": 1.0, "epoch": 1}])
    store.save(history, "h", "train/tensorflow")
    assert store.load("h").history == history.history
    for bad in (object(), {"f": lambda: 0}, np.array([None, 1]), {1: 2}):
        with pytest.raises(TypeError):
            store.save(bad, "bad", "predict/tensorflow")
        assert not store.exists("bad", "predict/tensorflow")
    assert store.list("evaluate/tensorflow") == ["ev"]
    assert store.list() == ["evaluate/tensorflow/ev", "predict/tensorflow/gen",
                            "train/tensorflow/h"]
    assert store.stored_class("gen", "predict/tensorflow") is None
    assert store.delete("gen") and not store.delete("gen")
    for path in tmp_path.rglob("*"):
        assert path.suffix in ("", ".json", ".npy"), path


def test_dollar_references_resolve_like_jax(apis):
    """``$name`` gives a Table, ``$name.key`` indexes a stored result,
    lists resolve element by element, and any string holding ``$`` is
    a reference."""
    jax_api, port_api = apis
    for api in (port_api, jax_api):
        api.ctx.catalog.create_collection("ev", "evaluate/tensorflow")
        api.ctx.artifacts.save({"loss": 1.5, "accuracy": 0.25}, "ev",
                               "evaluate/tensorflow")
    request = {"a": "$ev.loss", "b": ["$ev.accuracy", 3, "plain"],
               "c": 7, "d": "$ev.loss$"}
    got = port_api.ctx.params.treat(request)
    assert got == jax_api.ctx.params.treat(request) == {
        "a": 1.5, "b": [0.25, 3, "plain"], "c": 7, "d": 1.5}
    assert port_api.ctx.params.treat(None) == {}
    assert isinstance(port_api.ctx.params.resolve_value("$mixed"), Table)
    for api in (port_api, jax_api):
        with pytest.raises(KeyError):
            api.ctx.params.resolve_value("$ghost")


def test_jobs_run_fifo_on_the_card_lease(tmp_path):
    """Jobs that touch the card hold its lease one at a time, in the
    order they were submitted; the others do not wait for it."""
    ctx = ServiceContext(Config(home=str(tmp_path / "home"),
                                max_workers=4), device="cpu")
    order, active, peak = [], [0], [0]

    def job(i):
        def run():
            active[0] += 1
            peak[0] = max(peak[0], active[0])
            time.sleep(0.05)
            order.append(i)
            active[0] -= 1
            return i
        return run

    try:
        for i in range(4):
            ctx.catalog.create_collection(f"j{i}", "train/tensorflow")
            ctx.jobs.submit(f"j{i}", job(i), needs_card=True)
        assert [ctx.jobs.wait(f"j{i}", timeout=30) for i in range(4)] == \
            [0, 1, 2, 3]
        assert order == [0, 1, 2, 3] and peak[0] == 1
        assert ctx.jobs.running() == 0 and ctx.jobs.active_job() is None
        meta = ctx.catalog.get_metadata("j3")
        assert meta["finished"] and meta["status"] == "finished"
        doc = ctx.catalog.get_documents("j3")[1]
        assert set(doc) == {"_id", "description", "methodParameters",
                            "exception", "timeCreated", "queueWaitSeconds",
                            "attempt", "elapsedSeconds", "leaseWaitSeconds"}
    finally:
        ctx.close()


def test_shutdown_records_the_queued_jobs_it_drops(tmp_path):
    """Shutting the job manager down drops the jobs still queued, each
    with a terminal shutdownAborted document, and lets the running one
    end."""
    import threading
    ctx = ServiceContext(Config(home=str(tmp_path / "home"),
                                max_workers=1), device="cpu")
    started, release = threading.Event(), threading.Event()

    def hold():
        started.set()
        release.wait(30)

    try:
        for name, fn in (("running", hold), ("queued", lambda: 1)):
            ctx.catalog.create_collection(name, "train/tensorflow")
            ctx.jobs.submit(name, fn, description="d", parameters={"a": 1})
        assert started.wait(30)
        ctx.jobs.shutdown()
        release.set()
        ctx.jobs.wait("running", timeout=30)
        meta = ctx.catalog.get_metadata("queued")
        assert not meta["finished"] and meta["status"] == "shutdownAborted"
        doc = ctx.catalog.get_documents("queued")[-1]
        assert doc["shutdownAborted"] and doc["methodParameters"] == {"a": 1}
        assert doc["exception"].startswith("ShutdownAborted(")
        assert ctx.catalog.get_metadata("running")["finished"]
    finally:
        release.set()
        ctx.close()
