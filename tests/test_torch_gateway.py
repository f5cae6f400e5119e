"""The PyTorch port's gateway on the CPU, held against the JAX package:
the GET response cache (hits on a repeated poll, misses after any
change: a document, the finished flag, rows, a new collection; off at a
zero TTL) counts the same hits and misses and answers the same bodies,
and under ``LO_REQUEST_TIMEOUT`` a slow request gets the same 504 while
its work goes on, and a request past ``LO_GATEWAY_MAX_INFLIGHT`` the
same instant 503.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pyarrow as pa
import pytest

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api, RestServer

PREFIX = "/api/learningOrchestra/v1"


def _jax_api(tmp_path, **overrides):
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax"),
                                            **overrides))
    from learningorchestra_tpu.services.server import Api as JaxApi

    return JaxApi()


def _port_api(tmp_path, **overrides):
    return Api(ServiceContext(Config(home=str(tmp_path / "port"),
                                     **overrides), device="cpu"))


@pytest.fixture()
def apis(tmp_path):
    pair = (_jax_api(tmp_path), _port_api(tmp_path))
    yield pair
    for api in pair:
        api.ctx.close()
    jax_config.reset_config()


def _get(api, path, **params):
    return api.dispatch("GET", PREFIX + path, params, None)[:2]


def _write_rows(api, name, values, new):
    """Rows ``values`` end up stored: the port's writer replaces the
    dataset, the JAX one appends a part file with the ``new`` rows."""
    writer = api.ctx.catalog.dataset_writer(name)
    if isinstance(api, Api):
        writer.write_batch({"a": np.array(values, np.int64)})
    else:
        writer.write_batch(pa.Table.from_pylist(
            [{"a": v} for v in values[-new:]]))
    writer.close()


def _hits(api):
    return api.read_cache.stats()["hits"]


def _scenario_repeat_poll(api):
    api.ctx.catalog.create_collection("c1", "function/python", {})
    api.ctx.catalog.append_document("c1", {"note": "v1"})
    first = _get(api, "/function/python/c1", limit="1")
    before = _hits(api)
    second = _get(api, "/function/python/c1", limit="1")
    assert second == first
    return [_hits(api) - before, first[0]]


def _scenario_finished_flag(api):
    api.ctx.catalog.create_collection("c2", "train/tensorflow", {})
    seen = [_get(api, "/train/tensorflow/c2", limit="1")[1]["metadata"][
        "finished"] for _ in range(2)]
    api.ctx.catalog.mark_finished("c2")
    seen.append(_get(api, "/train/tensorflow/c2", limit="1")[1][
        "metadata"]["finished"])
    return seen + [api.read_cache.stats()]


def _scenario_new_documents(api):
    api.ctx.catalog.create_collection("c3", "function/python", {})
    b1 = _get(api, "/function/python/c3")[1]
    assert _get(api, "/function/python/c3")[1] == b1
    api.ctx.catalog.append_document("c3", {"epochRecord": {"loss": 1.0}})
    b2 = _get(api, "/function/python/c3")[1]
    return [len(b1["result"]), len(b2["result"]), api.read_cache.stats()]


def _scenario_dataset_rows(api):
    api.ctx.catalog.create_collection("d1", "dataset/csv", {})
    _write_rows(api, "d1", [1, 2], 2)
    b1 = _get(api, "/dataset/csv/d1")[1]
    _get(api, "/dataset/csv/d1")
    time.sleep(0.01)  # a distinct mtime for the new files
    _write_rows(api, "d1", [1, 2, 3], 1)
    b2 = _get(api, "/dataset/csv/d1")[1]
    return [[r.get("a") for r in b1["result"]],
            [r.get("a") for r in b2["result"]], api.read_cache.stats()]


def _scenario_listing(api):
    b1 = _get(api, "/function/python")[1]
    before = _hits(api)
    assert _get(api, "/function/python")[1] == b1
    hit = _hits(api) - before
    api.ctx.catalog.create_collection("newfn", "function/python", {})
    names = [m["name"] for m in _get(api, "/function/python")[1]["result"]]
    return [len(b1["result"]), hit, names]


SCENARIOS = {
    "a repeated poll hits": _scenario_repeat_poll,
    "the finished flag is never stale": _scenario_finished_flag,
    "a new document misses": _scenario_new_documents,
    "new rows miss": _scenario_dataset_rows,
    "a new collection misses the listing": _scenario_listing,
}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_read_cache_matches_jax(apis, case):
    want, got = (SCENARIOS[case](api) for api in apis)
    assert got == want


def test_zero_ttl_turns_the_cache_off_as_jax(tmp_path):
    stats = []
    for api in (_jax_api(tmp_path, get_cache_ttl_seconds=0.0),
                _port_api(tmp_path, get_cache_ttl_seconds=0.0)):
        try:
            api.ctx.catalog.create_collection("z1", "function/python", {})
            _get(api, "/function/python/z1")
            _get(api, "/function/python/z1")
            stats.append(api.read_cache.stats())
        finally:
            api.ctx.close()
    jax_config.reset_config()
    assert stats[1] == stats[0] == {"entries": 0, "hits": 0, "misses": 0}


def _servers(tmp_path, **overrides):
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax"),
                                            **overrides))
    from learningorchestra_tpu.services.server import \
        RestServer as JaxRestServer

    return (JaxRestServer(host="127.0.0.1", port=0).start(),
            RestServer(port=0, context=ServiceContext(
                Config(home=str(tmp_path / "port"), **overrides),
                device="cpu")).start())


def _urlopen(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _slow_reads(srv, seconds, ran):
    real = srv.api.dataset.read_file

    def slow_read(*args, **kwargs):
        time.sleep(seconds)
        ran.append(1)
        return real(*args, **kwargs)

    srv.api.dataset.read_file = slow_read


def test_request_timeout_gives_504_and_the_work_finishes_as_jax(tmp_path):
    servers = _servers(tmp_path, request_timeout_seconds=0.3)
    answers, ran = [], [[], []]
    try:
        for srv, done in zip(servers, ran):
            srv.api.ctx.catalog.create_collection("slow1",
                                                  "function/python", {})
            _slow_reads(srv, 1.0, done)
            t0 = time.monotonic()
            answers.append(_urlopen(
                f"{srv.base_url}{PREFIX}/function/python/slow1"))
            assert time.monotonic() - t0 < 0.9  # the deadline, not the sleep
            # a fast request is unaffected
            assert _urlopen(f"{srv.base_url}{PREFIX}/function/python")[0] \
                == 200
        time.sleep(1.2)  # the abandoned dispatches finish their work
        assert ran == [[1], [1]]
        assert servers[1].api.gateway["abandonedTotal"] == 1
        assert servers[1].api.gateway["inflight"] == 0
    finally:
        for srv in servers:
            srv.stop()
        jax_config.reset_config()
    assert answers[1] == answers[0]
    assert answers[1] == (504, {"result": "request timed out after 0.3s"})


def test_saturated_gateway_gives_503_at_once_as_jax(tmp_path):
    servers = _servers(tmp_path, request_timeout_seconds=0.2,
                       gateway_max_inflight=1)
    answers = []
    try:
        for srv in servers:
            srv.api.ctx.catalog.create_collection("slow2",
                                                  "function/python", {})
            _slow_reads(srv, 1.0, [])
            url = f"{srv.base_url}{PREFIX}/function/python/slow2"
            first = _urlopen(url)  # 504, still in flight
            t0 = time.monotonic()
            answers.append((first, _urlopen(url)))
            assert time.monotonic() - t0 < 0.15
        time.sleep(1.0)
        assert servers[1].api.gateway["saturatedTotal"] == 1
    finally:
        for srv in servers:
            srv.stop()
        jax_config.reset_config()
    assert answers[1] == answers[0]
    assert [status for status, _ in answers[1]] == [504, 503]


def test_observe_clamps_to_the_gateway_deadline(tmp_path):
    servers = _servers(tmp_path, request_timeout_seconds=0.5)
    try:
        bodies = []
        for srv in servers:
            srv.api.ctx.catalog.create_collection("obs1",
                                                  "function/python", {})
            seq = srv.api.ctx.catalog.latest_seq()
            t0 = time.monotonic()
            status, body = _urlopen(f"{srv.base_url}{PREFIX}/observe/obs1"
                                    f"?seq={seq}&timeout=20")
            assert status == 200 and time.monotonic() - t0 < 2.0
            bodies.append(body["result"]["changes"])
    finally:
        for srv in servers:
            srv.stop()
        jax_config.reset_config()
    assert bodies == [[], []]


def test_concurrent_polls_share_one_cache(tmp_path):
    api = _port_api(tmp_path)
    try:
        api.ctx.catalog.create_collection("c5", "function/python", {})
        _get(api, "/function/python/c5", limit="1")
        threads = [threading.Thread(
            target=_get, args=(api, "/function/python/c5"),
            kwargs={"limit": "1"}) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert api.read_cache.stats()["hits"] == 8
    finally:
        api.ctx.close()
