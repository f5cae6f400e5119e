"""The PyTorch port's paged and quantized LM serving sessions, on the CPU.

Mirrors the paged and quantized session tests of ``tests/test_serving.py``
by name, on the port's ``Api`` (no sockets) with a small LM whose weights
come from ``init_params`` through ``params_from_flax``. Paged streams
must equal the port's solo ``generate`` and its slot session token for
token (sampled streams draw from the same per-request, per-position
generators), greedy paged streams must equal the JAX paged session's,
and the create and predict error bodies must equal the JAX server's.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.models.transformer import \
    LanguageModel as JaxLanguageModel
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.models.transformer import LanguageModel
from learningorchestra_tpu_torch.ops import attention as attn_ops
from learningorchestra_tpu_torch.services import faults
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
CFG = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           max_len=64, sliding_window=16)
VOCAB = CFG["vocab_size"]


@pytest.fixture(scope="module")
def tree():
    return weights.init_params(CFG, seed=1)


def _api_with(tmp_path, tree, **overrides):
    faults.reset()
    ctx = ServiceContext(Config(home=str(tmp_path / "torch_home"),
                                **overrides), device="cpu")
    lm = LanguageModel(**CFG, device="cpu")
    lm.set_params(weights.params_from_flax(tree))
    ctx.artifacts.save(lm, "slm", "train/tensorflow")
    return Api(ctx)


@pytest.fixture()
def api(tmp_path, tree):
    a = _api_with(tmp_path, tree)
    yield a
    a.ctx.close()
    faults.reset()


def _call(api, method, path, body=None):
    status, payload, _ = api.dispatch(method, PREFIX + path, {}, body)
    return status, payload


def _paged_session(api, **extra):
    body = {"kv": "paged", "pageLen": 8, "maxSlots": 4, "cacheLen": 32,
            "temperature": 0.7, "topK": 12}
    body.update(extra)
    status, resp = _call(api, "POST", "/serve/slm", body)
    assert status == 201, resp
    assert resp["kv"]["mode"] == "paged"
    return resp


def _solo(lm, prompt, new, seed, temperature=0.7, top_k=12):
    out = lm.generate([prompt], max_new_tokens=new,
                      temperature=temperature, top_k=top_k, seed=seed)
    return [int(t) for t in out[0][len(prompt):]]


def _predict(api, prompt, new, seed, **extra):
    return _call(api, "POST", "/serve/slm/predict",
                 dict({"prompt": prompt, "maxNewTokens": new,
                       "seed": seed}, **extra))


def _prompt(rng, n):
    return [int(t) for t in rng.integers(1, VOCAB, size=n)]


def _session(api):
    return api.ctx.serving._sessions["slm"]


def test_paged_serving_bit_identical_to_solo_decode(api):
    """Concurrent sampled streams joining mid-flight: each equals the
    port's solo ``generate`` and the slot session's stream."""
    lm = api.ctx.artifacts.load("slm")
    resp = _paged_session(api)
    # auto pool: slots x pages per stream, the trash page not counted
    assert resp["kv"]["pageLen"] == 8
    assert resp["kv"]["pagesTotal"] == 4 * (32 // 8)
    rng = np.random.default_rng(5)
    specs = [(_prompt(rng, plen), new, 300 + i) for i, (plen, new) in
             enumerate([(3, 5), (5, 8), (8, 6), (4, 9), (6, 7), (7, 5)])]

    def run():
        out = [None] * len(specs)

        def client(i):
            prompt, new, seed = specs[i]
            time.sleep(0.03 * i)  # join mid-flight of earlier requests
            status, body = _predict(api, prompt, new, seed)
            assert status == 200, body
            out[i] = body["tokens"]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(specs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        return out

    paged = run()
    for i, (prompt, new, seed) in enumerate(specs):
        assert paged[i] == _solo(lm, prompt, new, seed), \
            f"paged request {i} diverged from its solo decode"
    stats = _call(api, "GET", "/serve/slm")[1]
    assert stats["tokensTotal"] == sum(n for _, n, _ in specs)
    assert stats["kv"]["mode"] == "paged"
    assert stats["kv"]["allocFailures"] == 0
    assert _call(api, "DELETE", "/serve/slm")[0] == 200

    status, resp = _call(api, "POST", "/serve/slm", {
        "maxSlots": 4, "cacheLen": 32, "temperature": 0.7, "topK": 12})
    assert status == 201 and "kv" not in resp
    assert run() == paged
    assert _call(api, "DELETE", "/serve/slm")[0] == 200


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_retired_lane_past_the_live_width_appends_to_the_trash_page(
        api, kv_dtype):
    """A long stream retires past its first page while only a short
    stream lives: the next step slices the block tables to the short
    stream's one page, and the retired lane, which keeps its column as
    the JAX session's does, appends into the trash page (the column
    clamped into the slice, as the JAX gather clamps it). Driven on the
    session's own loop without its thread, so the order is fixed."""
    from learningorchestra_tpu_torch.services.serving import (
        PagedLMServingSession, _Request)

    lm = api.ctx.artifacts.load("slm")
    sess = PagedLMServingSession(
        "lane", api.ctx, lm, slots=4, cache_len=32, temperature=0.0,
        top_k=None, top_p=None, page_len=8, n_pages=4 * 4 + 1,
        kv_dtype=kv_dtype)
    assert not sess._degraded
    rng = np.random.default_rng(9)
    long_req = _Request({"prompt": _prompt(rng, 10), "maxNewTokens": 3})
    short_req = _Request({"prompt": _prompt(rng, 3), "maxNewTokens": 8})
    sess._queue.extend([long_req, short_req])
    overruns = 0
    while sess._queue or sess._active_slots():
        if sess._active_slots() == [1]:
            # the retired lane's page column lies past the step's slice
            overruns += int(sess._col[0]) // sess.page_len >= \
                sess._gather_width()
        sess._serve_once()
    assert overruns
    for req in (long_req, short_req):
        assert req.error is None
    trash = [int(p) for p in sess._bt[0]]
    assert trash == [0] * len(trash)
    if kv_dtype == "int8":
        assert [len(r.result["tokens"]) for r in (long_req, short_req)] \
            == [3, 8]
        return
    for req in (long_req, short_req):
        prompt = req.payload["prompt"]
        assert req.result["tokens"] == _solo(
            lm, prompt, req.payload["maxNewTokens"], 0, temperature=0.0,
            top_k=None)


def test_paged_greedy_tokens_match_jax_paged_session(api, tree, tmp_path):
    """Greedy paged streams of the port equal the JAX package's paged
    session's for the same weights and prompts."""
    rng = np.random.default_rng(12)
    specs = [(_prompt(rng, n), new) for n, new in
             [(9, 6), (17, 8), (30, 5)]]
    body = {"kv": "paged", "pageLen": 8, "maxSlots": 2, "cacheLen": 64,
            "temperature": 0.0}
    _paged_session(api, **body)
    got = []
    for prompt, new in specs:
        status, out = _predict(api, prompt, new, 0)
        assert status == 200, out
        got.append(out["tokens"])
    lm = api.ctx.artifacts.load("slm")
    for (prompt, new), tokens in zip(specs, got):
        assert tokens == _solo(lm, prompt, new, 0, temperature=0.0)

    jax_config.set_config(jax_config.Config(
        home=str(tmp_path / "jax_home"), compute_dtype="float32",
        serve_max_wait_ms=1.0))
    try:
        from learningorchestra_tpu.services.server import Api as JaxApi

        japi = JaxApi()
        jlm = JaxLanguageModel(**CFG, attention="dot")
        jlm.params = jax.tree_util.tree_map(jnp.asarray, tree)
        japi.ctx.artifacts.save(jlm, "slm", "train/tensorflow")
        status, resp, _ = japi.dispatch("POST", PREFIX + "/serve/slm", {},
                                        body)
        assert status == 201, resp
        for (prompt, new), tokens in zip(specs, got):
            status, out, _ = japi.dispatch(
                "POST", PREFIX + "/serve/slm/predict", {},
                {"prompt": prompt, "maxNewTokens": new, "seed": 0})
            assert status == 200, out
            assert out["tokens"] == tokens
        japi.ctx.close()
    finally:
        jax_config.reset_config()


def test_paged_prefix_reuse_shares_pages_and_skips_prefill(api,
                                                           monkeypatch):
    lm = api.ctx.artifacts.load("slm")
    _paged_session(api, maxSlots=2)
    prefills = []
    real_flash = attn_ops.flash_attention

    def counting_flash(*args, **kwargs):
        prefills.append(1)
        return real_flash(*args, **kwargs)

    monkeypatch.setattr(attn_ops, "flash_attention", counting_flash)
    rng = np.random.default_rng(6)
    prompt = _prompt(rng, 12)
    new = 6  # ceil((12 + 6) / 8) = 3 pages cold

    def predict(p, seed):
        before = len(prefills)
        status, b = _predict(api, p, new, seed)
        assert status == 200, b
        launched = len(prefills) - before
        assert b["tokens"] == _solo(lm, p, new, seed)
        return launched

    assert predict(prompt, 7) == CFG["n_layers"]
    # exact repeat, another seed: a full hit, no forward over the prompt
    assert predict(prompt, 11) == 0
    # the same first page, another tail: a partial hit, the prefill runs
    prompt2 = prompt[:8] + _prompt(rng, 4)
    assert prompt2 != prompt
    assert predict(prompt2, 13) == CFG["n_layers"]

    kv = _call(api, "GET", "/serve/slm")[1]["kv"]
    prefix = kv["prefix"]
    assert prefix["hitsFull"] == 1
    assert prefix["hitsPartial"] == 1
    assert prefix["prefillsSkipped"] == 1
    assert prefix["pagesReused"] == 2
    # cold 3, full hit 3 - 1, partial hit 3 - 1
    assert kv["allocTotal"] == 7
    assert kv["pagesFree"] == kv["pagesTotal"] - 3
    assert kv["pagesShared"] == 1


def test_paged_admission_survives_prefix_eviction_under_pressure(api):
    lm = api.ctx.artifacts.load("slm")
    _paged_session(api, maxSlots=2)  # 8 usable pages
    session = _session(api)
    rng = np.random.default_rng(9)
    prompt = _prompt(rng, 12)
    new = 6

    status, b = _predict(api, prompt, new, 17)
    assert status == 200, b
    assert len(session.prefix) == 1

    hog = session.pool.alloc(session.pool.free_count(), "hog")
    status, b = _predict(api, prompt, new, 19)
    assert status == 429, b
    assert len(session.prefix) == 0
    assert session.pool.free_count() == 2
    assert session.pool.tenant_pages("default") == 0

    session.pool.decref(hog, "hog")
    status, b = _predict(api, prompt, new, 19)
    assert status == 200, b
    assert b["tokens"] == _solo(lm, prompt, new, 19)


def test_paged_admission_failure_releases_pages(api, monkeypatch):
    lm = api.ctx.artifacts.load("slm")
    _paged_session(api)
    session = _session(api)
    free0 = session.pool.free_count()
    real_prefill_for = session._pprefill_for

    def boom(s):
        raise RuntimeError("injected prefill failure")

    monkeypatch.setattr(session, "_pprefill_for", boom)
    prompt = _prompt(np.random.default_rng(10), 10)
    status, b = _predict(api, prompt, 5, 23)
    assert status == 503, b
    assert session.pool.free_count() == free0
    assert session.pool.tenant_pages("default") == 0

    monkeypatch.setattr(session, "_pprefill_for", real_prefill_for)
    status, b = _predict(api, prompt, 5, 23)
    assert status == 200, b
    assert b["tokens"] == _solo(lm, prompt, 5, 23)


def test_paged_tenant_series_cardinality_is_bounded(tmp_path, tree):
    api = _api_with(tmp_path, tree, serve_tenant_weights="vip:3")
    try:
        _paged_session(api)
        session = _session(api)
        session._MAX_TENANT_SERIES = 2
        rng = np.random.default_rng(11)
        for i, tenant in enumerate(["vip", "t0", "t1", "t2", "t3", "vip"]):
            status, b = _predict(api, _prompt(rng, 6), 4, 31 + i,
                                 tenant=tenant)
            assert status == 200, b
        assert set(session._tenant_requests) == {"vip", "t0", "t1",
                                                 "other"}
        assert session._tenant_requests["vip"] == 2
        assert session._tenant_requests["other"] == 2
        tenants = session.stats()["kv"]["tenants"]
        assert "t2" not in tenants and "t3" not in tenants
    finally:
        api.ctx.close()


def test_paged_tenant_quota_and_weighted_qos(tmp_path, tree):
    api = _api_with(tmp_path, tree, serve_tenant_weights="vip:3,std:1")
    try:
        lm = api.ctx.artifacts.load("slm")
        # 6 usable pages: a 4-page request is over a half-pool quota (3)
        # and within a 3/4-pool one (4)
        _paged_session(api, maxSlots=2, pages=7)
        session = _session(api)
        held = session.pool.alloc(2, "victim")
        rng = np.random.default_rng(8)
        p_std, p_vip = _prompt(rng, 8), _prompt(rng, 8)

        status, b = _predict(api, p_std, 24, 21, tenant="std")
        assert status == 429, b
        status, b = _predict(api, p_vip, 24, 21, tenant="vip")
        assert status == 200, b
        assert b["tokens"] == _solo(lm, p_vip, 24, 21)
        session.pool.decref(held, "victim")
        status, b = _predict(api, p_std, 24, 21, tenant="std")
        assert status == 200, b
        assert b["tokens"] == _solo(lm, p_std, 24, 21)

        stats = session.stats()
        assert stats["rejectedTotal"] >= 1
        tenants = stats["kv"]["tenants"]
        assert tenants["vip"]["weight"] == 3.0
        assert tenants["vip"]["requests"] == 1
        assert tenants["std"]["requests"] == 1
        assert tenants["std"]["latency"]["count"] >= 1
    finally:
        api.ctx.close()


def test_paged_weighted_fair_pick_prefers_the_lighter_tenant(tmp_path, tree):
    """The queue pick: the request whose tenant holds the fewest pages per
    unit weight goes first, FIFO within a tenant."""
    api = _api_with(tmp_path, tree, serve_tenant_weights="vip:3,std:1")
    try:
        _paged_session(api, maxSlots=2)
        session = _session(api)
        held = session.pool.alloc(3, "std") + session.pool.alloc(3, "vip")
        from learningorchestra_tpu_torch.services.serving import _Request

        reqs = [_Request({"prompt": [1], "tenant": t})
                for t in ("std", "std", "vip", "vip")]
        with session._cv:
            session._queue.extend(reqs)
            order = [session._pop_next() for _ in reqs]
        # std holds 3 / 1, vip 3 / 3: vip first, each tenant in order
        assert order == [reqs[2], reqs[3], reqs[0], reqs[1]]
        session.pool.decref(held[:3], "std")
        session.pool.decref(held[3:], "vip")
    finally:
        api.ctx.close()


def test_paged_kv_alloc_transient_fault_is_retryable(tmp_path, tree):
    api = _api_with(tmp_path, tree, fault_inject="kv_page_alloc:1")
    try:
        lm = api.ctx.artifacts.load("slm")
        _paged_session(api)
        prompt = _prompt(np.random.default_rng(9), 6)
        status, b = _predict(api, prompt, 5, 31)
        assert status == 429, b
        status, b = _predict(api, prompt, 5, 31)
        assert status == 200, b
        assert b["tokens"] == _solo(lm, prompt, 5, 31)
        stats = _call(api, "GET", "/serve/slm")[1]
        assert stats["kv"]["mode"] == "paged"
        assert stats["rejectedTotal"] == 1
    finally:
        api.ctx.close()
        faults.reset()


def test_paged_kv_alloc_latched_fault_degrades_to_slot(tmp_path, tree):
    api = _api_with(tmp_path, tree, fault_inject="kv_page_alloc:100")
    try:
        lm = api.ctx.artifacts.load("slm")
        _paged_session(api)
        prompt = _prompt(np.random.default_rng(10), 6)
        for _ in range(3):
            status, b = _predict(api, prompt, 5, 41)
            assert status == 429, b
        stats = _call(api, "GET", "/serve/slm")[1]
        assert stats["kv"]["mode"] == "slot-degraded"
        # the slot path never allocates pages: the armed budget cannot
        # touch it
        status, b = _predict(api, prompt, 5, 41)
        assert status == 200, b
        assert b["tokens"] == _solo(lm, prompt, 5, 41)
    finally:
        api.ctx.close()
        faults.reset()


def test_quantized_session_streams_with_drift_and_dtype_stamps(api):
    status, b = _call(api, "POST", "/serve/slm", {
        "maxSlots": 2, "cacheLen": 32, "kvDtype": "int8"})
    assert status == 406, b
    status, b = _call(api, "POST", "/serve/slm", {
        "kv": "paged", "pageLen": 8, "kvDtype": "int4"})
    assert status == 406 and "int8" in str(b), b

    resp = _paged_session(api, kvDtype="int8", weights="int8")
    assert resp["kv"]["dtype"] == "int8"
    status, b = _predict(api, _prompt(np.random.default_rng(70), 6), 6, 4)
    assert status == 200, b
    assert len(b["tokens"]) == 6
    stats = _call(api, "GET", "/serve/slm")[1]
    assert stats["kv"]["dtype"] == "int8"
    assert stats["weights"]["dtype"] == "int8"
    drift = stats["drift"]
    assert drift["probes"] >= 1
    assert drift["value"] <= drift["max"], drift
    assert set(drift["parts"]) == {"kv", "weights"}
    assert stats["quant"] == {"degrades": 0, "kv": "int8",
                              "weights": "int8"}
    # the int8 copy of the matmul weights: a quarter of float32, plus
    # scales (and the exact norms)
    assert stats["weights"]["bytes"] < _weight_bytes(api) / 3


def test_quantized_kv_bytes_per_token_is_payload_plus_scales(api):
    resp = _paged_session(api, kvDtype="int8")
    sess = _session(api)
    pages_total = resp["kv"]["pagesTotal"] + 1
    page_len = resp["kv"]["pageLen"]
    kv, d, layers = 2, 16, CFG["n_layers"]
    payload = layers * 2 * pages_total * page_len * kv * d  # int8
    scales = layers * 2 * pages_total * kv * 4              # float32
    assert sess._cache_bytes == payload + scales
    assert resp["kv"]["bytesPerToken"] == round(
        (payload + scales) / (pages_total * page_len), 3)


def test_quantized_kv_transient_fault_is_retryable_429(tmp_path, tree):
    api = _api_with(tmp_path, tree, fault_inject="kv_quant:1")
    try:
        _paged_session(api, kvDtype="int8")
        prompt = _prompt(np.random.default_rng(71), 5)
        status, b = _predict(api, prompt, 4, 2)
        assert status == 429, b
        status, b = _predict(api, prompt, 4, 2)
        assert status == 200, b
        assert _call(api, "GET", "/serve/slm")[1]["kv"]["dtype"] == "int8"
    finally:
        api.ctx.close()
        faults.reset()


def test_quantized_kv_latched_fault_degrades_to_exact_bf16(tmp_path, tree):
    api = _api_with(tmp_path, tree, fault_inject="kv_quant:100")
    try:
        lm = api.ctx.artifacts.load("slm")
        _paged_session(api, kvDtype="int8", weights="int8")
        prompt = _prompt(np.random.default_rng(72), 6)
        for _ in range(3):
            status, b = _predict(api, prompt, 5, 51)
            assert status == 429, b
        stats = _call(api, "GET", "/serve/slm")[1]
        assert stats["kv"]["dtype"] == "bf16", stats["kv"]
        assert stats["kv"]["mode"] == "paged", stats["kv"]
        assert stats["weights"]["dtype"] == "bf16", stats["weights"]
        assert stats["quant"]["degrades"] == 1
        status, b = _predict(api, prompt, 5, 51)
        assert status == 200, b
        assert b["tokens"] == _solo(lm, prompt, 5, 51)
    finally:
        api.ctx.close()
        faults.reset()


def test_forced_drift_breach_degrades_to_exact(tmp_path, tree):
    """A drift bound no quantization meets: the create-time probe
    degrades the session to exact pages and weights, and its streams
    equal the solo decode."""
    api = _api_with(tmp_path, tree, serve_drift_max=1e-9)
    try:
        lm = api.ctx.artifacts.load("slm")
        resp = _paged_session(api, kvDtype="int8", weights="fp8")
        assert resp["kv"]["dtype"] == "bf16"
        assert resp["weights"]["dtype"] == "bf16"
        assert resp["quant"]["degrades"] == 1
        assert resp["drift"]["value"] > resp["drift"]["max"]
        prompt = _prompt(np.random.default_rng(74), 9)
        status, b = _predict(api, prompt, 6, 8)
        assert status == 200, b
        assert b["tokens"] == _solo(lm, prompt, 6, 8)
        # the periodic probe stays quiet on the exact path
        sess = _session(api)
        sess._steps_since_probe = 10 ** 6
        status, b = _predict(api, prompt, 6, 9)
        assert status == 200 and sess.quant_degrades == 1
    finally:
        api.ctx.close()


def test_bf16_paged_session_is_unchanged_by_quant_plumbing(api):
    lm = api.ctx.artifacts.load("slm")
    resp = _paged_session(api)
    assert resp["kv"]["dtype"] == "bf16"
    sess = _session(api)
    assert sess._serve_module is sess._model.module
    pages_total = resp["kv"]["pagesTotal"] + 1
    # float32 pools only, no scales
    assert sess._cache_bytes == CFG["n_layers"] * 2 * pages_total * 8 * \
        2 * 16 * 4
    prompt = _prompt(np.random.default_rng(73), 7)
    status, b = _predict(api, prompt, 6, 5)
    assert status == 200 and b["tokens"] == _solo(lm, prompt, 6, 5)
    stats = _call(api, "GET", "/serve/slm")[1]
    assert "drift" not in stats
    assert stats["weights"]["dtype"] == "bf16"


def test_paged_error_bodies_match_jax(api, tree, tmp_path):
    """Create and predict refusals of the paged and quantized fields
    answer as the JAX server does, word for word."""
    jax_config.set_config(jax_config.Config(
        home=str(tmp_path / "jax_home"), compute_dtype="float32",
        serve_max_wait_ms=1.0))
    try:
        from learningorchestra_tpu.services.server import Api as JaxApi

        japi = JaxApi()
        jlm = JaxLanguageModel(**CFG, attention="dot")
        jlm.params = jax.tree_util.tree_map(jnp.asarray, tree)
        japi.ctx.artifacts.save(jlm, "slm", "train/tensorflow")
        cases = [
            ("POST", "/serve/slm", {"kvDtype": "int8"}),
            ("POST", "/serve/slm", {"kv": "paged", "kvDtype": "int4"}),
            ("POST", "/serve/slm", {"kv": "paged", "weights": "int4"}),
            ("POST", "/serve/slm", {"kv": "paged", "pageLen": 0}),
            ("POST", "/serve/slm", {"kv": "paged", "pageLen": "8"}),
            ("POST", "/serve/slm", {"kv": "paged", "pages": -1}),
            ("POST", "/serve/slm", {"kv": "paged", "pageLen": 8,
                                    "cacheLen": 32}),           # 201
            ("POST", "/serve/slm/predict", {"prompt": [1, 2],
                                            "tenant": ""}),
            ("POST", "/serve/slm/predict", {"prompt": [1, 2],
                                            "tenant": 7}),
            ("POST", "/serve/slm/predict", {"prompt": [1, 2],
                                            "tenant": "x" * 65}),
            ("POST", "/serve/slm/predict", {"prompt": [1, 2],
                                            "maxNewTokens": 32}),
        ]
        for method, path, body in cases:
            status, want, _ = japi.dispatch(method, PREFIX + path, {}, body)
            got = _call(api, method, path, body)
            if status == 201:
                assert got[0] == 201, got
                continue
            assert got == (status, want), (method, path, body)
        japi.dispatch("DELETE", PREFIX + "/serve/slm", {}, None)
        japi.ctx.close()
    finally:
        jax_config.reset_config()


@pytest.mark.parametrize("spec", [
    "", "kv_page_alloc", "kv_page_alloc:3", "kv_quant:100:raise",
    "kv_page_alloc:2:latency:0.25, kv_quant:1", "job_run:1:hang",
    "ckpt_write:1:corrupt:64", "engine_step:1:nan", ":1", "a:b",
    "a:1:boom", "a:1:latency:x", "a:1:nan:3", "a:1:corrupt:1.5",
    "a:1:raise:2:3"])
def test_fault_specs_parse_as_in_jax(spec):
    from learningorchestra_tpu.services import faults as jax_faults

    try:
        want = {k: (v.site, v.count, v.mode, v.arg)
                for k, v in jax_faults.parse_spec(spec).items()}
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            faults.parse_spec(spec)
        assert str(got.value) == str(exc)
        return
    got = {k: (v.site, v.count, v.mode, v.arg)
           for k, v in faults.parse_spec(spec).items()}
    assert got == want


def test_latency_fault_delays_and_budget_is_consumed():
    cfg = Config(home="unused", fault_inject="kv_page_alloc:2:latency:0.05")
    faults.reset()
    t0 = time.monotonic()
    faults.maybe_inject("kv_page_alloc", cfg)
    faults.maybe_inject("kv_page_alloc", cfg)
    assert time.monotonic() - t0 >= 0.1
    t0 = time.monotonic()
    faults.maybe_inject("kv_page_alloc", cfg)  # budget spent
    faults.maybe_inject("kv_quant", cfg)       # not armed
    assert time.monotonic() - t0 < 0.05
    faults.reset()


def test_config_defaults_pick_paged_quantized_sessions(tmp_path, tree):
    """``LO_SERVE_KV``, ``LO_SERVE_KV_DTYPE`` and ``LO_SERVE_WEIGHTS``
    (the Config fields) choose the session when the body names none; a
    slot session takes quantized weights too, as the JAX one does."""
    api = _api_with(tmp_path, tree, serve_kv="paged", serve_kv_dtype="int8",
                    serve_weights="int8", serve_page_len=8)
    try:
        status, resp = _call(api, "POST", "/serve/slm",
                             {"maxSlots": 2, "cacheLen": 30})
        assert status == 201, resp
        assert resp["kv"]["mode"] == "paged"
        assert resp["kv"]["dtype"] == "int8" and resp["kv"]["pageLen"] == 8
        assert resp["cacheLen"] == 24  # rounded down to whole pages
        assert resp["weights"]["dtype"] == "int8"
        assert _call(api, "DELETE", "/serve/slm")[0] == 200

        status, resp = _call(api, "POST", "/serve/slm", {
            "kv": "slot", "maxSlots": 2, "cacheLen": 32, "weights": "fp8"})
        assert status == 201, resp
        assert "kv" not in resp and resp["weights"]["dtype"] == "fp8"
        exact = _weight_bytes(api)
        assert resp["weights"]["bytes"] < exact / 3
        status, b = _predict(api, _prompt(np.random.default_rng(75), 5), 4,
                             1)
        assert status == 200 and len(b["tokens"]) == 4
    finally:
        api.ctx.close()


def _weight_bytes(api):
    lm = api.ctx.artifacts.load("slm")
    return sum(p.numel() * p.element_size() for p in lm.module.parameters())
