"""The port's device-memory ledger
(``learningorchestra_tpu_torch/observability/xray.py``) against the JAX
package's, on the CPU.

The same registrations and releases go through both ledgers: per-owner
totals, the named reports and the bare report's owners and rows are
equal (exactly; the rows' timestamps aside). The port's bare report
takes its bytes in use from the torch allocator, with the reserved
bytes beside it; the CPU has no allocator count and the report says so.
The JAX instruments with no torch counterpart answer as the JAX routes
do without a capture (``/observability/compile/{name}`` 404, retraces
0), and ``LO_TRANSFER_GUARD=fail`` is refused at context creation. The
allocation sites ledger their bytes: a fit's ``train-state`` while it
runs, a serving session's ``serving-params`` and ``kv-cache`` (the
cache's exact bytes, pages and dtype for a paged one) until its delete.
"""

import numpy as np
import pytest
import torch

from learningorchestra_tpu.observability import xray as jax_xray
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.models.transformer import LanguageModel
from learningorchestra_tpu_torch.observability import xray
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
LM_CFG = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, max_len=64)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("LO_XRAY", raising=False)
    xray.reset()
    jax_xray.reset()
    yield
    xray.reset()
    jax_xray.reset()


def _drive(lib):
    lib.register("train-state", 1, 4096, name="job")
    lib.register("serving-params", ("serving", "m", 7), 1000, name="m",
                 dtype="bf16")
    lib.register("kv-cache", ("kv", "m", 7), 512, name="m", slots=2,
                 cacheLen=32, obj=object())
    lib.register("snapshot", "s1", 300, name="job", host=True)
    lib.register("train-state", 1, 8192, name="job")   # replaced
    lib.register("custom", "c", 5)
    lib.release("snapshot", "s1")
    lib.release("nope", "x")


def _rows(report):
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in report["entries"]]


def test_ledger_matches_jax():
    _drive(xray)
    _drive(jax_xray)
    assert xray.by_owner() == jax_xray.by_owner()
    assert xray.attributed_bytes() == jax_xray.attributed_bytes() == \
        8192 + 1000 + 512 + 5
    for name in ("m", "job", "absent"):
        ours, theirs = xray.memory_report(name), jax_xray.memory_report(name)
        assert _rows(ours) == _rows(theirs)
        assert {k: v for k, v in ours.items() if k != "entries"} == \
            {k: v for k, v in theirs.items() if k != "entries"}
    ours, theirs = xray.memory_report(), jax_xray.memory_report()
    assert _rows(ours) == _rows(theirs)
    for key in ("enabled", "owners", "attributedBytes",
                "attributedDeviceBytes", "retracesTotal",
                "implicitTransfersTotal"):
        assert ours[key] == theirs[key]
    # the CPU has no allocator count: the report says so
    assert set(ours) == set(theirs) - {"unattributedBytes"} | {
        "bytesReserved", "bytesNote"}
    assert ours["bytesInUse"] is None and ours["bytesSource"] == \
        "unavailable" and ours["bytesReserved"] is None
    assert xray.ring_sample() == (xray.attributed_bytes(), None)


def test_xray_off_registers_nothing_and_still_releases(monkeypatch):
    xray.register("kv-cache", "k", 10)
    jax_xray.register("kv-cache", "k", 10)
    monkeypatch.setenv("LO_XRAY", "0")
    for lib in (xray, jax_xray):
        lib.register("train-state", "t", 99)
        lib.release("kv-cache", "k")
        assert lib.attributed_bytes() == 0
        assert lib.memory_report()["enabled"] is False


def test_instruments_without_a_torch_counterpart(tmp_path):
    assert xray.counters() == {"retraces": 0, "implicitTransfers": 0}
    assert xray.compile_report("any") is None and \
        xray.known_compiles() == []
    with pytest.raises(ValueError, match="not yet ported"):
        ServiceContext(Config(home=str(tmp_path), transfer_guard="fail"),
                       device="cpu")
    api = Api(ServiceContext(Config(home=str(tmp_path),
                                    transfer_guard="log", monitor=False),
                             device="cpu"))
    try:
        assert xray.transfer_guard_mode() == "log"
        # no card: the sentinel is a plain call
        assert xray.guarded_call(lambda a, b=0: a + b, 2, b=3) == 5
        assert api.dispatch("GET", f"{PREFIX}/observability/compile", {},
                            None)[:2] == (200, {"result": []})
        st, body, _ = api.dispatch(
            "GET", f"{PREFIX}/observability/compile/job", {}, None)
        assert st == 404 and "no compiled-artifact report" in body["result"]
        text = api.metrics_prometheus().decode()
        assert "lo_retraces_total 0" in text
        assert "lo_implicit_transfers_total 0" in text
        for owner in xray.OWNERS:
            assert f'lo_hbm_attributed_bytes{{owner="{owner}"}} 0' in text
    finally:
        api.ctx.close()


def _lm():
    lm = LanguageModel(**LM_CFG, device="cpu")
    lm.set_params(weights.params_from_flax(weights.init_params(LM_CFG,
                                                               seed=2)))
    return lm


def test_a_fit_ledgers_its_train_state():
    lm = _lm()
    seen = []
    x = np.random.default_rng(0).integers(1, 97, (16, 16)).astype(np.int32)
    lm.fit(x, batch_size=8, epochs=2,
           log_fn=lambda r: seen.append(xray.by_owner()["train-state"]))
    params = sum(p.numel() * 4 for p in lm.module.parameters())
    # float32 master params and Adam's two moments, at least
    assert len(seen) == 2 and all(b >= 3 * params for b in seen)
    assert xray.by_owner()["train-state"] == 0


@pytest.fixture()
def api(tmp_path):
    a = Api(ServiceContext(Config(home=str(tmp_path), monitor=False),
                           device="cpu"))
    a.ctx.artifacts.save(_lm(), "slm", "train/tensorflow")
    yield a
    a.ctx.close()


@pytest.mark.parametrize("body,kv_meta", [
    ({"type": "lm", "maxSlots": 2, "cacheLen": 32},
     {"slots": 2, "cacheLen": 32}),
    ({"type": "lm", "kv": "paged", "pageLen": 8, "maxSlots": 2,
      "cacheLen": 32}, {"slots": 2, "cacheLen": 32, "dtype": "bf16"}),
    ({"type": "lm", "kv": "paged", "pageLen": 8, "maxSlots": 2,
      "cacheLen": 32, "kvDtype": "int8"},
     {"slots": 2, "cacheLen": 32, "dtype": "int8"}),
])
def test_serving_sessions_ledger_params_and_cache(api, body, kv_meta):
    assert api.dispatch("POST", f"{PREFIX}/serve/slm", {}, body)[0] == 201
    session = api.ctx.serving._sessions["slm"]
    st, report, _ = api.dispatch(
        "GET", f"{PREFIX}/observability/memory/slm", {}, None)
    assert st == 200 and set(report["owners"]) == {"serving-params",
                                                    "kv-cache"}
    assert report["owners"]["kv-cache"] == session._cache_bytes
    assert report["owners"]["serving-params"] == session._param_bytes
    (kv,) = [r for r in report["entries"] if r["owner"] == "kv-cache"]
    assert {k: kv[k] for k in kv_meta} == kv_meta
    if body.get("kv") == "paged":
        assert kv["pages"] == session.n_pages
    assert api.dispatch("POST", f"{PREFIX}/serve/slm/predict", {},
                        {"prompt": [1, 2, 3], "maxNewTokens": 3})[0] == 200
    assert api.dispatch("DELETE", f"{PREFIX}/serve/slm", {}, None)[0] == 200
    assert api.dispatch("GET", f"{PREFIX}/observability/memory/slm", {},
                        None)[0] == 404
    owners = api.dispatch("GET", f"{PREFIX}/observability/memory", {},
                          None)[1]["owners"]
    assert owners["serving-params"] == owners["kv-cache"] == 0
