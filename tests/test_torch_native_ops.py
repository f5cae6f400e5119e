"""The port's CSV core (``learningorchestra_tpu_torch/csrc/csv_core.cpp``
through ``native/ops.py``) on the CPU.

Held against the JAX package's ``learningorchestra_tpu.native.ops`` where
the two define the same thing (float columns of numeric CSVs bit for bit,
record cuts, headers, value counts, filter masks, the row gather), and
against the port's own Python path everywhere (hypothesis over cells and
whole CSV texts: the kinds, the values bit for bit, the null masks and
the error messages), through ``POST /dataset/csv`` and the queried read.
"""

import csv
import io
import os
import shutil
import types

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from learningorchestra_tpu import native as jax_native
from learningorchestra_tpu.native import ops as jax_ops
from learningorchestra_tpu_torch import native
from learningorchestra_tpu_torch.catalog.store import Catalog
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.native import ops
from learningorchestra_tpu_torch.services import dataset as dataset_service
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="g++ is absent: the C++ CSV core cannot be built here")

PREFIX = "/api/learningOrchestra/v1"
SETTINGS = settings(max_examples=150, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow,
                                           HealthCheck.function_scoped_fixture])


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


@pytest.fixture(autouse=True)
def core_on(monkeypatch):
    monkeypatch.delenv("LO_NATIVE", raising=False)
    assert ops.core() is not None, native.build_error(native.CSV)


def _python(monkeypatch):
    monkeypatch.setenv("LO_NATIVE", "0")
    assert ops.core() is None


def _on_both_paths(fn):
    """``fn()`` through the core, then on the Python path
    (``LO_NATIVE=0``)."""
    saved = os.environ.pop("LO_NATIVE", None)
    try:
        got = fn()
        os.environ["LO_NATIVE"] = "0"
        want = fn()
    finally:
        os.environ.pop("LO_NATIVE", None)
        if saved is not None:
            os.environ["LO_NATIVE"] = saved
    return got, want


def _outcome(fn, *args, **kwargs):
    """What a call gives, comparable across paths: the columns as
    (dtype, raw bytes, null mask) and the kinds, or the exception's
    class and message."""
    try:
        cols, kinds = fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 - compared, not handled
        return ("raised", type(exc).__name__, str(exc))
    return ("ok", list(kinds), [
        (np.asarray(c).dtype.str, np.asarray(c).tobytes(),
         np.ma.getmaskarray(c).tolist()) for c in cols])


# ----------------------------------------------------------------------
# the JAX package's core
# ----------------------------------------------------------------------
def _numeric_csv(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(500, 4)) * np.array([1, 1e3, 1e-7, 1e12])
    x[::7, 1] = np.round(x[::7, 1], 2)
    lines = ["a,b,c,d"]
    for row in x:
        lines.append(",".join([f"{row[0]:.17g}", f"{row[1]:.6f}",
                               f"{row[2]:e}", repr(float(row[3]))]))
    return ("\n".join(lines) + "\n").encode()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float_columns_bit_equal_to_the_jax_core(jax_core, seed):
    buf = _numeric_csv(seed)
    got, kinds = ops.parse_csv(buf)
    want, types_ = jax_ops.parse_csv(buf)
    assert kinds == ["float64"] * 4 and types_ == [0] * 4
    for g, w in zip(got, want):
        assert not np.ma.getmaskarray(g).any()
        assert np.array_equal(np.asarray(g).view(np.int64),
                              w.view(np.int64))


def _quoted_csv(rng) -> bytes:
    out = io.StringIO()
    writer = csv.writer(out, lineterminator="\n")
    writer.writerow(["id", "text", "x"])
    words = ["plain", "with, comma", 'with "quotes"', "two\nlines",
             "", "x\n\ny"]
    for i in range(60):
        writer.writerow([i, words[int(rng.integers(len(words)))],
                         float(rng.normal())])
    return out.getvalue().encode()


@pytest.mark.parametrize("seed", [0, 1])
def test_safe_split_and_header_match_the_jax_core(jax_core, seed):
    rng = np.random.default_rng(seed)
    buf = _quoted_csv(rng)
    for end in list(range(0, 40)) + rng.integers(40, len(buf),
                                                 60).tolist() + [len(buf)]:
        part = buf[:end]
        assert ops.safe_split(part) == jax_ops.safe_split(part), part
    first = buf[:ops.safe_split(buf, 1)].decode()
    assert ops.csv_header(first) == jax_ops.csv_header(first) == \
        ["id", "text", "x"]


def test_value_counts_match_the_jax_core(jax_core):
    rng = np.random.default_rng(4)
    floats = rng.integers(0, 5, 1000).astype(np.float64)
    floats[rng.random(1000) < 0.1] = np.nan
    floats[3], floats[700] = -0.0, 0.0
    words = np.array([f"w{int(v)}" for v in rng.integers(0, 9, 1000)])
    for data, jax_data in ((floats, floats),
                           (words, words.astype(object))):
        got = ops.value_counts(data)
        keys, counts = jax_ops.value_counts(jax_data)
        assert [c for _, c in got] == counts.tolist()
        for (value, _), key in zip(got, keys):
            assert value == key or (value != value and key != key)
            if isinstance(value, float) and value == 0:
                assert np.signbit(value) == np.signbit(key)


@pytest.mark.parametrize("query", [
    {"x": {"$gt": 0.5}}, {"x": {"$gte": 1.0, "$lt": 3}},
    {"n": 3}, {"n": {"$ne": 2}}, {"n": {"$lte": 2.5}},
    {"s": "b"}, {"s": {"$ne": "a"}}, {"s": "b", "n": {"$gt": 1}}])
def test_filter_masks_match_the_jax_core(jax_core, query):
    rng = np.random.default_rng(6)
    cols = {"x": rng.normal(size=300) * 2, "n": rng.integers(0, 5, 300),
            "s": np.array(["a", "b", "c"])[rng.integers(0, 3, 300)]}
    want = jax_ops.filter_mask(
        {"x": cols["x"], "n": cols["n"], "s": cols["s"].astype(object)},
        query)
    assert np.array_equal(ops.filter_mask(cols, query), want)


def test_gather_rows_matches_the_jax_core(jax_core):
    rng = np.random.default_rng(7)
    src = rng.normal(size=(50, 33)).astype(np.float32)
    idx = rng.integers(0, 50, 80)
    got = ops.gather_rows(src, idx)
    assert np.array_equal(got.view(np.uint32),
                          jax_ops.gather_rows(src, idx).view(np.uint32))


# ----------------------------------------------------------------------
# the core against the port's Python path
# ----------------------------------------------------------------------
_TOKENS = [
    "", "0", "1", "-0", "007", "5", " 5 ", "\t7\n", "-12", "+3",
    "9223372036854775807", "-9223372036854775808", "9223372036854775808",
    "-9223372036854775809", "1e5", "1E-3", ".5", "5.", "-.5e+2", "1e",
    "1e+", ".", "-", "1_0", "0x10", "inf", "-Infinity", "iNfInItY", "infinit",
    "nan", "NaN", "NAN", "-NAN", "+nan", "nan(1)", "1.7976931348623157e308",
    "1e400", "-1e-400", "4.9e-324", "0.1", "123456789012345678901234567890",
    "0.30000000000000004", "true", "FALSE", "True", "t", "NA", "N/A", "null",
    "NULL", "#N/A", "#N/A N/A", "-1.#IND", "1.#QNAN", "n/a", "\xa05",
    "5 ", "٣", "-١٢", "\x1c5", "5\x1f", "\x00", "é",
    "a\x00", "x y", "1 2", "\x0b5\x0c"]


def _cell():
    return st.one_of(st.sampled_from(_TOKENS),
                     st.text(alphabet=st.characters(
                         blacklist_categories=("Cs",)), max_size=6),
                     st.text(alphabet="0123456789.-+eE ,\"\n\r", max_size=6))


def _field(cell: str, quote: bool) -> str:
    if quote or any(c in cell for c in ',"\r\n'):
        return '"' + cell.replace('"', '""') + '"'
    return cell


@st.composite
def _csv_texts(draw, header=True):
    ncols = draw(st.integers(1, 4))
    nrows = draw(st.integers(0, 8))
    end = draw(st.sampled_from(["\n", "\r\n", "\r"]))
    lines = []
    if header:
        lines.append(",".join(f"c{j}" for j in range(ncols)))
    for _ in range(nrows):
        width = ncols if draw(st.integers(0, 9)) else draw(
            st.integers(1, 5))
        cells = [draw(_cell()) for _ in range(width)]
        raw = draw(st.integers(0, 5)) == 0
        lines.append(",".join(
            c if raw and not any(x in c for x in "\r\n") else
            _field(c, draw(st.booleans())) for c in cells))
        if draw(st.integers(0, 7)) == 0:
            lines.append("")  # a blank line
    text = end.join(lines)
    if draw(st.booleans()):
        text += end
    return text.encode("utf-8")


@SETTINGS
@given(_csv_texts())
def test_core_parse_equals_the_python_path(buf):
    got, want = _on_both_paths(lambda: _outcome(ops.parse_csv, buf))
    assert got == want


@SETTINGS
@given(st.lists(_cell(), min_size=1, max_size=12),
       st.sampled_from(["int64", "float64", "bool", "string", "null"]))
def test_core_cells_equal_the_python_path(cells, kind):
    """One column of cells, quoted, under each pinned kind and inferred."""
    buf = ("c\n" + "".join(_field(c, True) + "\n" for c in cells)).encode()
    for kinds in ([kind], None):
        got, want = _on_both_paths(lambda: _outcome(
            ops.parse_csv, buf, kinds=kinds, row_base=7))
        assert got == want
        if kinds is None and want[0] == "ok":
            assert want[1] == [ops.infer_kind(cells)]


@SETTINGS
@given(_csv_texts(), st.integers(0, 4), st.booleans())
def test_record_cuts_equal_the_python_path(buf, limit, final):
    for end in range(len(buf) + 1):
        got = ops.split_records(buf[:end], limit, final)
        assert got == ops._split_records_py(buf[:end], limit, final)


def test_non_ascii_cells_go_to_the_python_predicates():
    before = ops.counts().get("deferredCells", {}).get("python", {})
    buf = "a,b\n\xa012,x\n٣,y\n7,z\n".encode()
    cols, kinds = ops.parse_csv(buf)
    assert kinds == ["int64", "string"]
    assert np.asarray(cols[0]).tolist() == [12, 3, 7]
    after = ops.counts()["deferredCells"]["python"]
    assert after["rows"] - before.get("rows", 0) >= 2


def test_utf8_and_the_field_limit_refuse_the_core():
    with pytest.raises(ops.CoreRefused):
        ops.parse_csv(b"a\n\xff\n", fallback=False)
    with pytest.raises(UnicodeDecodeError):
        ops.parse_csv(b"a\n\xff\n")
    big = b"a\n" + b"x" * 131073 + b"\n"
    with pytest.raises(ops.CoreRefused):
        ops.parse_csv(big, fallback=False)
    with pytest.raises(csv.Error, match="field larger than field limit"):
        ops.parse_csv(big)


# ----------------------------------------------------------------------
# the chunked ingest: core against the Python path
# ----------------------------------------------------------------------
def _ingest(tmp_path, name, data: bytes):
    """(fields, rows, stored columns) of ``_ingest_csv`` on ``data``, or
    the exception's class and message."""
    path = tmp_path / f"{name}.csv"
    path.write_bytes(data)
    catalog = Catalog(str(tmp_path / f"{name}.sqlite"),
                      str(tmp_path / f"{name}_ds"))
    try:
        catalog.create_collection(name, "dataset/csv", {})
        service = dataset_service.DatasetService.__new__(
            dataset_service.DatasetService)
        service._ctx = types.SimpleNamespace(catalog=catalog)
        try:
            service._ingest_csv(name, str(path))
        except Exception as exc:  # noqa: BLE001 - compared
            return ("raised", type(exc).__name__, str(exc))
        meta = catalog.get_metadata(name)
        stored = {}
        if catalog.count_rows(name):
            stored = {c: (k, d.dtype.str, d.tobytes(), None if m is None
                          else m.tolist())
                      for c, (k, d, m) in catalog.read_columns(name).items()}
        return ("ok", meta.get("fields"), meta.get("rows"), stored)
    finally:
        catalog.close()


def _both(tmp_path, data: bytes, tag: str):
    paths = iter(("core", "py"))
    return _on_both_paths(
        lambda: _ingest(tmp_path, f"{next(paths)}{tag}", data))


_CHUNKED = {
    "plain": b"a,b\n1,x\n2,y\n3,z\n4,w\n5,v\n",
    "quoted_across_chunks": b'a,b\n1,"x\ny"\n2,"p,q"\n3,"r\n\ns"\n4,t\n',
    "kind_from_first_chunk": b"a\n1\n2\n3\n4.5\n",
    "later_bad_value": b"a,b\n1,2\n3,4\n5,6\nx,8\n",
    "later_ragged": b"a,b\n1,2\n3,4\n5,6\n7\n",
    "ragged_after_bad_in_chunk": b"a,b\n1,2\nx,4\n5\n",
    "duplicate_header": b"a,a\n1,2\n",
    "empty": b"",
    "blank_only": b"\n\r\n\n",
    "header_only": b"a,b\n",
    "null_first_chunk": b"a,b\nNA,1\n,2\nnull,3\n7,4\n",
    "crlf_and_cr": b"a,b\r\n1,2\r3,4\r\n\r\n5,6",
    "invalid_utf8_late": b"a\n1\n2\n3\n\xff\n",
    "invalid_utf8_after_bad": b"a\n1\n2\nx\n3\n\xff\n",
    "non_ascii_ints": "a\n1\n\xa02\n٣\n4\n".encode(),
    "control_int": b"a\n1\n2\n\x1c3\n",
    "open_quote_at_end": b'a,b\n1,"x\n2,3\n',
}


@pytest.mark.parametrize("case", sorted(_CHUNKED))
@pytest.mark.parametrize("chunk_rows,block",
                         [(2, 3), (3, 64), (65536, 1 << 22)])
def test_chunked_ingest_equals_the_python_path(tmp_path, monkeypatch, case,
                                               chunk_rows, block):
    monkeypatch.setattr(dataset_service, "_CHUNK_ROWS", chunk_rows)
    monkeypatch.setattr(dataset_service, "_READ_BLOCK", block)
    got, want = _both(tmp_path, _CHUNKED[case], case)
    assert got == want


@SETTINGS
@given(_csv_texts(), st.integers(1, 4), st.integers(1, 40))
def test_chunked_ingest_texts_equal_the_python_path(tmp_path_factory,
                                                    monkeypatch, buf,
                                                    chunk_rows, block):
    monkeypatch.setattr(dataset_service, "_CHUNK_ROWS", chunk_rows)
    monkeypatch.setattr(dataset_service, "_READ_BLOCK", block)
    got, want = _both(tmp_path_factory.mktemp("h"), buf, "h")
    assert got == want


def test_rest_ingest_with_and_without_the_core(tmp_path, monkeypatch):
    """``POST /dataset/csv`` stores equal columns and metadata either
    way; the core's run parsed every row."""
    rng = np.random.default_rng(9)
    lines = ["i,f,b,s,e"]
    for i in range(2000):
        lines.append(f"{int(rng.integers(-99, 99))},"
                     f"{float(rng.normal()):.17g},"
                     f"{['true', 'false', ''][i % 3]},"
                     f"\"w {i % 17}, x\",{['', 'NA'][i % 2]}")
    path = tmp_path / "mixed.csv"
    path.write_text("\n".join(lines) + "\n")
    out = []
    for env in ("1", "0"):
        monkeypatch.setenv("LO_NATIVE", env)
        ops.reset_counts()
        api = Api(ServiceContext(Config(home=str(tmp_path / env)),
                                 device="cpu"))
        try:
            status, body = api.dispatch("POST", PREFIX + "/dataset/csv", {},
                                        {"datasetName": "mixed",
                                         "datasetURI": str(path)})[:2]
            assert status == 201, body
            api.ctx.jobs.wait("mixed", timeout=120)
            meta = api.ctx.catalog.get_metadata("mixed")
            cols = api.ctx.catalog.read_columns("mixed")
            path_rows = ops.counts()["parse_csv"]
            out.append((meta["fields"], meta["rows"], meta["finished"],
                        {c: (k, d.dtype.str, d.tobytes(), None if m is None
                             else m.tolist()) for c, (k, d, m) in
                         cols.items()}))
            assert path_rows == {"native" if env == "1" else "python":
                                 {"calls": 1, "rows": 2000}}
        finally:
            api.ctx.close()
    assert out[0] == out[1]
    assert [v[0] for v in out[0][3].values()] == [
        "int64", "float64", "bool", "string", "string"]


# ----------------------------------------------------------------------
# the queried read
# ----------------------------------------------------------------------
_QUERIES = [
    {"i": 3}, {"i": {"$gt": 2, "$lte": 40}}, {"i": {"$ne": 3}},
    {"i": {"$lt": 2.5}}, {"i": 9007199254740993},
    {"i": {"$gte": 9007199254740992.0}}, {"f": {"$gt": 0.25}},
    {"f": {"$ne": 0.5}}, {"f": 1}, {"f": {"$lte": -1}},
    {"s": "b"}, {"s": {"$ne": "b"}}, {"s": ""}, {"s": "b", "i": {"$gt": 1}},
    {"b": True}, {"i": {"$in": [1, 2]}}, {"missing": None},
    {"_id": {"$gt": 5}}, {"s": {"$gt": "a"}}, {"i": "3"}, {"f": None},
    {"i": {}}, {"i": 2 ** 70}]


@pytest.fixture(scope="module")
def queried(tmp_path_factory):
    rng = np.random.default_rng(12)
    n = 3000
    i = rng.integers(-5, 50, n).astype(object)
    i[::97] = None
    i[5] = 9007199254740993
    f = rng.normal(size=n).round(2).astype(object)
    f[::89] = None
    f[7] = float("nan")
    f[8], f[9] = 0.5, 1.0
    s = np.array(["a", "b", "", "c"])[rng.integers(0, 4, n)].astype(object)
    s[::83] = None
    b = (rng.random(n) < 0.5).astype(object)
    root = tmp_path_factory.mktemp("queried")
    cat = Catalog(str(root / "c.sqlite"), str(root / "ds"))
    cat.create_collection("t", "dataset/csv")
    with cat.dataset_writer("t") as w:
        for start in range(0, n, 1000):
            sl = slice(start, start + 1000)
            w.write_batch({"i": i[sl].tolist(), "f": f[sl].tolist(),
                           "s": s[sl].tolist(), "b": b[sl].tolist()})
    yield cat
    cat.close()


@pytest.mark.parametrize("query", _QUERIES)
@pytest.mark.parametrize("skip,limit", [(0, None), (3, 5), (0, 1),
                                        (2900, 0), (10, 40)])
def test_queried_pages_equal_the_per_row_loop(queried, monkeypatch, query,
                                              skip, limit):
    got = queried.read_entries("t", skip=skip, limit=limit, query=query)
    core_used = ops._predicates(
        {k: v for k, (_, v, _) in queried.read_columns("t").items()},
        query) is not None
    monkeypatch.setattr(ops, "filter_mask", lambda *a, **k: None)
    want = queried.read_entries("t", skip=skip, limit=limit, query=query)
    # repr: a NaN row's value is a new float object on each path
    assert repr(got) == repr(want)
    monkeypatch.undo()
    _python(monkeypatch)
    assert repr(queried.read_entries("t", skip=skip, limit=limit,
                                     query=query)) == repr(want)
    # the shapes the JAX filter takes go through the mask
    assert core_used == (query in _QUERIES[:14] or query == {"i": {}})


# ----------------------------------------------------------------------
# value counts and the gather against their Python versions
# ----------------------------------------------------------------------
_ARRAYS = st.one_of(
    st.lists(st.sampled_from([0.0, -0.0, 1.5, float("nan"), -2.0,
                              float("inf")]), max_size=40).map(
        lambda v: np.array(v, np.float64)),
    st.lists(st.integers(-3, 3) | st.sampled_from([2 ** 62, -2 ** 63]),
             max_size=40).map(lambda v: np.array(v, np.int64)),
    st.lists(st.booleans(), max_size=40).map(lambda v: np.array(v, bool)),
    st.lists(st.sampled_from(["", "a", "ab", "b\x00", "é", "a"]),
             max_size=40).map(lambda v: np.array(v, dtype=str)))


@SETTINGS
@given(_ARRAYS, st.data())
def test_value_counts_equal_the_python_path(data, draw):
    mask = None
    if len(data) and draw.draw(st.booleans()):
        mask = np.array(draw.draw(st.lists(st.booleans(), min_size=len(data),
                                           max_size=len(data))), bool)
    got, want = _on_both_paths(lambda: ops.value_counts(data, mask))
    assert repr(got) == repr(want)


def test_gather_rows_is_fancy_indexing():
    rng = np.random.default_rng(3)
    src = rng.normal(size=(40, 3, 5)).astype(np.float32)
    idx = rng.integers(0, 40, 100)
    before = ops.counts().get("gather_rows", {}).get("native", {})
    got = ops.gather_rows(src, idx)
    assert got.shape == (100, 3, 5)
    assert np.array_equal(got.view(np.uint32), src[idx].view(np.uint32))
    after = ops.counts()["gather_rows"]["native"]
    assert after["calls"] == before.get("calls", 0) + 1
    # negative or out-of-range indices, other dtypes: numpy's own answer
    assert np.array_equal(ops.gather_rows(src, [-1, 0]), src[[-1, 0]])
    with pytest.raises(IndexError):
        ops.gather_rows(src, [40])
    ints = np.arange(12).reshape(4, 3)
    assert np.array_equal(ops.gather_rows(ints, [3, 1]), ints[[3, 1]])


def test_mismatched_lengths_are_refused():
    with pytest.raises(ValueError, match="rows long"):
        ops.filter_mask({"a": np.arange(5), "b": np.arange(4.0)},
                        {"a": 1, "b": 2.0})
    with pytest.raises(ValueError, match="rows long"):
        ops.filter_mask({"a": np.arange(5)}, {"a": 1},
                        {"a": np.zeros(3, bool)})
    with pytest.raises(ValueError, match="a mask of"):
        ops.value_counts(np.arange(5), np.zeros(4, bool))


def test_path_counters_lose_no_update_under_threads():
    """More threads than cores count at once, with a short switch
    interval: every call and row is in the totals."""
    import sys
    import threading

    threads, calls = 2 * (os.cpu_count() or 4), 400
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ops.reset_counts()
        workers = [threading.Thread(target=lambda: [
            native.count("stress", "native", 3) for _ in range(calls)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert ops.counts()["stress"]["native"] == {
        "calls": threads * calls, "rows": 3 * threads * calls}


# ----------------------------------------------------------------------
# the build
# ----------------------------------------------------------------------
def test_a_failed_build_where_gxx_exists_raises(tmp_path, monkeypatch):
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "csv_core.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", {})
    monkeypatch.setattr(native, "_tried", {})
    monkeypatch.setattr(native, "_errors", {})
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ exited"):
        ops.core()
    assert "g++ exited" in native.build_error(native.CSV)
    monkeypatch.setenv("LO_NATIVE", "0")
    assert ops.core() is None
