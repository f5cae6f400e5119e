"""The port's feature cache
(``learningorchestra_tpu_torch/services/feature_cache.py``) against the
JAX package's ``services/feature_cache.py``.

Each case replays one sequence of dataset writes and reads on a JAX
catalog with its cache (DataFrames) and on a port catalog with the
port's (its ``Table`` and ``read_columns`` forms) and requires equal
stats: hits, misses, invalidations and entries, with the arenas' counts
where the case stages. These are the cases of the JAX package's
tests/test_feature_cache.py: a write revalidates (the JAX package
appends a parquet part, the port rewrites its columns: neither rides the
change feed, so only the version's file stamp catches it), projections
and dtypes key separately, the caller's copy is isolated, a delete sweeps
both tiers, a read racing a writer never mixes two versions, and a warm
Builder run reads nothing from the catalog. Bytes are compared within
each package only.
"""

import sys
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.catalog import Catalog as JaxCatalog
from learningorchestra_tpu.runtime.arena import DeviceArena as JaxArena
from learningorchestra_tpu.services.feature_cache import \
    FeatureCache as JaxFeatureCache
from learningorchestra_tpu_torch.catalog.store import (Catalog,
                                                       CollectionNotFound,
                                                       Table)
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.runtime.arena import DeviceArena
from learningorchestra_tpu_torch.services.feature_cache import FeatureCache

COUNTS = ("entries", "hits", "misses", "invalidations")
PREFIX = "/api/learningOrchestra/v1"


@pytest.fixture()
def catalogs(tmp_path):
    """A JAX catalog and a port catalog, each in its own directory."""
    cfg = jax_config.Config(home=str(tmp_path / "jax"))
    jax_config.set_config(cfg)
    pair = {"jax": JaxCatalog(cfg.catalog_path, cfg.datasets_dir),
            "port": Catalog(str(tmp_path / "port" / "catalog.sqlite"),
                            str(tmp_path / "port" / "datasets"))}
    yield pair
    for c in pair.values():
        c.close()
    jax_config.reset_config()


def _write(kind, catalog, name, columns, append=False):
    """One write of ``columns``: the JAX package's write_dataframe (an
    appended part with ``append``), the port's dataset writer (which
    replaces the rows: a write of the whole new content)."""
    if not catalog.exists(name):
        catalog.create_collection(name, "dataset/csv", {})
    if kind == "jax":
        catalog.write_dataframe(name, pd.DataFrame(columns),
                                replace=not append)
    else:
        if append:
            old = catalog.read_table(name)
            columns = {c: np.concatenate([np.asarray(old[c]),
                                          np.asarray(v)])
                       for c, v in columns.items()}
        with catalog.dataset_writer(name) as w:
            w.write_batch({c: np.asarray(v) for c, v in columns.items()})
    catalog.mark_finished(name)


def _caches(catalogs, arenas=None):
    arenas = arenas or {"jax": JaxArena(0), "port": DeviceArena(0)}
    return {"jax": JaxFeatureCache(catalogs["jax"], arena=arenas["jax"]),
            "port": FeatureCache(catalogs["port"], arena=arenas["port"])}


def _full(kind, fc, name):
    """The whole dataset, in each package's read form."""
    return fc.dataframe(name) if kind == "jax" else fc.table(name)


def _column(frame, name) -> list:
    return np.asarray(frame[name]).tolist()


def _counts(fc):
    s = fc.stats()
    return {k: s[k] for k in COUNTS}


def _same(caches):
    assert _counts(caches["jax"]) == _counts(caches["port"])


# ------------------------------------------------------------ host tier
def test_host_tier_hit_then_write_revalidates(catalogs):
    caches = _caches(catalogs)
    for kind, fc in caches.items():
        cat = catalogs[kind]
        _write(kind, cat, "ds", {"a": [1, 2]})
        assert _column(_full(kind, fc, "ds"), "a") == [1, 2]
        assert _column(_full(kind, fc, "ds"), "a") == [1, 2]
        s = fc.stats()
        assert (s["hits"], s["misses"]) == (1, 1)
        _write(kind, cat, "ds", {"a": [3]}, append=True)
        assert _column(_full(kind, fc, "ds"), "a") == [1, 2, 3]
        s = fc.stats()
        assert s["misses"] == 2 and s["invalidations"] == 1
        _write(kind, cat, "ds", {"a": [9]})
        assert _column(_full(kind, fc, "ds"), "a") == [9]
    _same(caches)


def test_projection_and_dtype_key_separately(catalogs):
    caches = _caches(catalogs)
    for kind, fc in caches.items():
        _write(kind, catalogs[kind], "ds", {"a": [1.0, 2.0], "b": [3, 4]})
        full = _full(kind, fc, "ds")
        if kind == "jax":
            proj = fc.dataframe("ds", columns=["a"])
        else:
            proj = fc.columns("ds", ["a"])
        assert list(full.columns) == ["a", "b"]
        assert list(proj) == ["a"]
        arrs = fc.arrays("ds", ["a", "b"], np.float32)
        assert arrs["a"].dtype == np.float32
        assert fc.stats()["entries"] == 3
        if kind == "jax":
            fc.dataframe("ds", columns=["a"])
        else:
            fc.columns("ds", ["a"])
        fc.arrays("ds", ["a", "b"], np.float32)
        assert fc.stats()["hits"] == 2
        # another dtype policy is another entry
        assert fc.arrays("ds", ["a"], np.float64)["a"].dtype == np.float64
    _same(caches)


def test_cached_read_isolated_from_caller_mutation(catalogs):
    caches = _caches(catalogs)
    for kind, fc in caches.items():
        _write(kind, catalogs[kind], "ds", {"a": [1]})
        if kind == "jax":
            df = fc.dataframe("ds")
            df["extra"] = 7
            again = fc.dataframe("ds")
        else:
            cols = fc.columns("ds")
            cols["extra"] = ("int64", np.array([7]), None)
            del cols["a"]
            t = fc.table("ds")
            assert t is not fc.table("ds")
            arrs = fc.arrays("ds", ["a"])
            arrs["extra"] = np.zeros(1)
            assert "extra" not in fc.arrays("ds", ["a"])
            again = fc.columns("ds")
        assert "extra" not in list(again) and "a" in list(again)
    # JAX: 1 miss + 1 hit; the port: its columns, table and arrays reads
    assert caches["jax"].stats()["hits"] == 1
    assert caches["port"].stats()["hits"] == 3


def test_delete_collection_sweeps_both_tiers(catalogs):
    arenas = {"jax": JaxArena(1 << 20), "port": DeviceArena(1 << 20)}
    caches = _caches(catalogs, arenas)
    for kind, fc in caches.items():
        cat, a = catalogs[kind], arenas[kind]
        _write(kind, cat, "doomed", {"a": [1]})
        _write(kind, cat, "other", {"b": [2]})
        _full(kind, fc, "doomed")
        block = ((lambda: {"x": np.ones(8, np.float32)}) if kind == "jax"
                 else (lambda: {"x": torch.ones(8)}))
        a.get_or_put(fc.token("doomed"), block, tags=("doomed",)).release()
        assert fc.stats()["entries"] == 1 and a.stats()["entries"] == 1
        cat.delete_collection("doomed")
        _full(kind, fc, "other")
        assert fc.stats()["entries"] == 1
        assert a.stats()["entries"] == 0
        assert a.stats()["invalidations"] == 1
    _same(caches)


def test_device_arrays_stage_through_the_arena(catalogs):
    a = DeviceArena(1 << 20)
    fc = FeatureCache(catalogs["port"], arena=a)
    _write("port", catalogs["port"], "ds", {"a": [1.0, 2.0], "b": [3, 4]})
    with fc.arrays("ds", ["a", "b"], np.float32, device="cpu") as e:
        assert isinstance(e.arrays["b"], torch.Tensor)
        assert e.arrays["b"].tolist() == [3.0, 4.0]
    with fc.arrays("ds", ["a", "b"], np.float32, device="cpu"):
        pass
    s = a.stats()
    assert (s["hits"], s["misses"], s["entries"], s["pins"]) == (1, 1, 1, 0)
    # a write: a new token misses, the change feed is not involved
    _write("port", catalogs["port"], "ds", {"a": [5.0], "b": [6]})
    with fc.arrays("ds", ["a", "b"], np.float32, device="cpu") as e:
        assert e.arrays["a"].tolist() == [5.0]
    assert a.stats()["misses"] == 2
    # the delete sweeps the arena's copies out with the host tier's
    catalogs["port"].delete_collection("ds")
    _write("port", catalogs["port"], "x", {"z": [1]})
    fc.table("x")
    assert a.stats()["entries"] == 0


def test_a_zero_host_budget_caches_nothing(catalogs):
    fc = FeatureCache(catalogs["port"], host_bytes=0, arena=DeviceArena(0))
    jfc = JaxFeatureCache(catalogs["jax"], host_bytes=0, arena=JaxArena(0))
    for kind, cache in (("port", fc), ("jax", jfc)):
        _write(kind, catalogs[kind], "ds", {"a": [1, 2]})
        _full(kind, cache, "ds")
        _full(kind, cache, "ds")
    assert _counts(fc) == _counts(jfc) == {
        "entries": 0, "hits": 0, "misses": 2, "invalidations": 0}


def test_the_lru_evicts_the_oldest_read(catalogs):
    # room for two of the three 8000-byte reads
    fc = FeatureCache(catalogs["port"], host_bytes=20000,
                      arena=DeviceArena(0))
    jfc = JaxFeatureCache(catalogs["jax"], host_bytes=20000,
                          arena=JaxArena(0))
    for kind, cache in (("port", fc), ("jax", jfc)):
        for name in ("d1", "d2", "d3"):
            _write(kind, catalogs[kind], name,
                   {"v": np.arange(1000, dtype=np.float64)})
        cache.arrays("d1", ["v"], np.float64)
        cache.arrays("d2", ["v"], np.float64)
        cache.arrays("d3", ["v"], np.float64)
        cache.arrays("d1", ["v"], np.float64)   # evicted: a miss
        cache.arrays("d3", ["v"], np.float64)   # still there: a hit
        assert cache.stats()["bytesInUse"] == 16000
    assert _counts(fc) == _counts(jfc)


# ---------------------------------------------------- read-during-write
def test_concurrent_read_during_write_never_mixes(catalogs):
    """Readers racing the writer's directory swap see one coherent
    version, every row from the same write: through the cache, and
    straight from the catalog (where no version check guards a read)."""
    cat = catalogs["port"]

    def frame(i):
        return {"v": np.full(256, i, np.int64), "w": np.full(256, i,
                                                             np.int64)}

    _write("port", cat, "ds", frame(0))
    fc = FeatureCache(cat, arena=DeviceArena(0))
    stop = threading.Event()
    bad, reads = [], [0]

    def reader(read):
        while not stop.is_set():
            try:
                t = read("ds")
            except (CollectionNotFound, OSError):
                continue  # the read fell inside a swap
            vals = set(np.asarray(t["v"]).tolist()) | \
                set(np.asarray(t["w"]).tolist())
            reads[0] += 1
            if len(vals) != 1:
                bad.append(sorted(vals))

    # through the cache, and straight from the catalog, whose reads open
    # one directory generation
    threads = [threading.Thread(target=reader, args=(read,))
               for read in (fc.table, cat.read_table) * 4]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for i in range(1, 40):
            with cat.dataset_writer("ds") as w:
                w.write_batch(frame(i))
    finally:
        stop.set()
        sys.setswitchinterval(interval)
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not bad, f"mixed-version reads observed: {bad[:3]}"
    assert reads[0] > 0
    assert int(np.asarray(fc.table("ds")["v"])[0]) == 39


# ------------------------------------------------- warm builder pipeline
MODELING = """
import numpy as np
feats = ["f0", "f1", "f2", "f3"]
def xs(df):
    return np.stack([np.asarray(df[c], dtype=np.float32) for c in feats], 1)
features_training = (xs(training_df), np.asarray(training_df["label"]))
features_testing = xs(testing_df)
features_evaluation = (xs(testing_df), np.asarray(testing_df["label"]))
"""


def _synth(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x @ np.array([1.0, -2.0, 0.5, 1.5]) > 0).astype(np.int64)
    columns = {f"f{i}": x[:, i] for i in range(4)}
    columns["label"] = y
    return columns


@pytest.fixture()
def apis(tmp_path):
    """The JAX and the port ``Api`` with fcb_train (2048 rows: LR's
    batch of 4096 makes one step) and fcb_test."""
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax"),
                                            sandbox_mode="restricted"))
    from learningorchestra_tpu.services.server import Api as JaxApi
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import Api

    pair = {"jax": JaxApi(),
            "port": Api(ServiceContext(Config(home=str(tmp_path / "port")),
                                       device="cpu"))}
    try:
        for kind, api in pair.items():
            _write(kind, api.ctx.catalog, "fcb_train", _synth(2048, 1))
            _write(kind, api.ctx.catalog, "fcb_test", _synth(512, 2))
        yield pair
    finally:
        for api in pair.values():
            api.ctx.close()
        jax_config.reset_config()


def _builder(api):
    body = {"trainDatasetName": "fcb_train", "testDatasetName": "fcb_test",
            "evaluationDatasetName": "fcb_test", "modelingCode": MODELING,
            "classifiersList": ["LR", "NB"], "meshParallel": True}
    status, _ = api.dispatch("POST", PREFIX + "/builder/sparkml", {},
                             body)[:2]
    assert status == 201
    api.ctx.jobs.wait("fcb_testLR", timeout=600)
    for c in ("LR", "NB"):
        meta = api.ctx.catalog.get_metadata(f"fcb_test{c}")
        assert meta["finished"] is True and meta["accuracy"] > 0.9, meta


def test_warm_builder_run_reads_nothing_from_the_catalog(apis,
                                                         monkeypatch):
    """The second Builder run on unchanged datasets reads no table from
    the catalog and takes NB's statistics from the arena; a write to the
    training dataset makes the next run read and stage again. The feature
    caches' counts equal the JAX package's at every stage."""
    from learningorchestra_tpu_torch.runtime import arena

    calls = {"jax": [], "port": []}
    for kind, api in apis.items():
        _builder(api)
        name = "read_dataframe" if kind == "jax" else "read_table"
        orig = getattr(api.ctx.catalog, name)

        def counted(*a, _orig=orig, _calls=calls[kind], **k):
            _calls.append(a)
            return _orig(*a, **k)

        monkeypatch.setattr(api.ctx.catalog, name, counted)
    fc0 = {k: api.ctx.features.stats() for k, api in apis.items()}
    ar0 = arena.get_default_arena().stats()
    for api in apis.values():
        _builder(api)
    fc1 = {k: api.ctx.features.stats() for k, api in apis.items()}
    ar1 = arena.get_default_arena().stats()
    for kind in apis:
        assert calls[kind] == [], f"warm {kind} run hit the catalog"
        assert fc1[kind]["hits"] - fc0[kind]["hits"] >= 2
        assert fc1[kind]["misses"] == fc0[kind]["misses"]
    assert {k: fc1["port"][k] for k in COUNTS} == \
        {k: fc1["jax"][k] for k in COUNTS}
    # NB's centred x and one-hot came from the arena
    assert ar1["hits"] > ar0["hits"] and ar1["misses"] == ar0["misses"]

    for kind, api in apis.items():
        _write(kind, api.ctx.catalog, "fcb_train", _synth(256, 3),
               append=True)
        _builder(api)
        assert any(a[0] == "fcb_train" for a in calls[kind]), \
            f"the written dataset was served stale ({kind})"
    fc2 = {k: api.ctx.features.stats() for k, api in apis.items()}
    assert fc2["port"]["misses"] > fc1["port"]["misses"]
    assert {k: fc2["port"][k] for k in COUNTS} == \
        {k: fc2["jax"][k] for k in COUNTS}
    assert arena.get_default_arena().stats()["misses"] > ar1["misses"]


def test_dollar_name_and_datatype_read_through_the_cache(tmp_path):
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import Api

    api = Api(ServiceContext(Config(home=str(tmp_path)), device="cpu"))
    try:
        ctx = api.ctx
        _write("port", ctx.catalog, "ds", {"a": [1, 2], "b": [3.0, 4.0]})
        first = ctx.params.resolve_value("$ds")
        second = ctx.params.resolve_value("$ds")
        assert isinstance(second, Table) and second is not first
        assert _column(second, "a") == [1, 2]
        assert ctx.features.stats()["hits"] == 1
        status, _ = api.dispatch("POST", PREFIX + "/transform/dataType", {},
                                 {"datasetName": "ds",
                                  "types": {"a": "string"}})[:2]
        assert status == 200
        ctx.jobs.wait("ds", timeout=60)
        # the rewrite read its columns through the cache (a key of its
        # own: a miss), and the next $ds misses the stale table
        assert ctx.features.stats()["misses"] == 2
        assert _column(ctx.params.resolve_value("$ds"), "a") == ["1", "2"]
        assert ctx.features.stats()["misses"] == 3
    finally:
        api.ctx.close()


def test_cached_columns_are_read_only(catalogs):
    """An in-place write to a cached column raises instead of changing
    every later read of the same version."""
    fc = FeatureCache(catalogs["port"], arena=DeviceArena(0))
    _write("port", catalogs["port"], "ds", {"a": [1, 2], "b": [3.0, 4.0]})
    reads = [fc.table("ds")["a"], fc.columns("ds")["b"][1],
             fc.arrays("ds", ["a"])["a"]]
    for column in reads:
        with pytest.raises(ValueError):
            column[0] = 99
    assert _column(fc.table("ds"), "a") == [1, 2]
    assert fc.stats()["hits"] == 1


@pytest.mark.parametrize("mode", ["restricted", "trusted"])
@pytest.mark.parametrize("frames", ["pandas", "no-pandas"])
def test_in_process_function_step_writes_its_own_copy(tmp_path, monkeypatch,
                                                      mode, frames):
    """A Function step run in process writes into its parameter's columns
    (a DataFrame, or the Table itself where pandas cannot be imported);
    the next ``$name`` read still gets the dataset's rows, from the
    cache."""
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import Api

    if frames == "no-pandas":
        monkeypatch.setitem(sys.modules, "pandas", None)
        write = "df['a'][0] = 99"
    else:
        write = "df.loc[0, 'a'] = 99"
    api = Api(ServiceContext(Config(home=str(tmp_path), sandbox_mode=mode),
                             device="cpu"))
    try:
        ctx = api.ctx
        _write("port", ctx.catalog, "ds", {"a": [1, 2], "b": [3.0, 4.0]})
        assert _column(ctx.params.resolve_value("$ds"), "a") == [1, 2]
        status, _ = api.dispatch(
            "POST", PREFIX + "/function/python", {},
            {"name": "fn", "function": f"{write}\nresponse = int(df['a'][0])",
             "functionParameters": {"df": "$ds"}})[:2]
        assert status == 201
        ctx.jobs.wait("fn", timeout=60)
        assert ctx.artifacts.load("fn", "function/python") == 99
        assert _column(ctx.params.resolve_value("$ds"), "a") == [1, 2]
        assert ctx.features.stats()["hits"] == 2
    finally:
        api.ctx.close()
