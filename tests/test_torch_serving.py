"""The PyTorch port's REST serving plane, on the CPU.

A real ``RestServer(device="cpu")`` on a free port serves a small LM
whose weights come from ``init_params``; the JAX package's ``Api``
serves the same weights. Concurrent greedy predicts must return the
port's solo ``generate`` tokens and JAX's, and the error bodies
(404/406/409) must equal the JAX server's word for word.
"""

import json
import threading
import urllib.error
import urllib.request

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
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import RestServer

# tiny shapes: two intra-op threads are as fast as all cores and leave
# the rest to the other test workers
torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
CFG = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           max_len=64, sliding_window=16)


@pytest.fixture(scope="module")
def tree():
    return weights.init_params(CFG, seed=1)


@pytest.fixture()
def server(tmp_path, tree):
    ctx = ServiceContext(Config(home=str(tmp_path / "torch_home")),
                         device="cpu")
    lm = LanguageModel(**CFG, device="cpu")
    lm.set_params(weights.params_from_flax(tree))
    ctx.artifacts.save(lm, "slm", "train/tensorflow")
    srv = RestServer(port=0, context=ctx).start()
    yield srv
    srv.stop()


@pytest.fixture()
def jax_api(tmp_path, tree):
    jax_config.set_config(jax_config.Config(
        home=str(tmp_path / "jax_home"), compute_dtype="float32",
        serve_max_wait_ms=1.0))
    from learningorchestra_tpu.services.server import Api

    api = Api()
    lm = JaxLanguageModel(**CFG, attention="dot")
    lm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    api.ctx.artifacts.save(lm, "slm", "train/tensorflow")
    yield api
    api.ctx.close()
    jax_config.reset_config()


def _call(srv, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(srv.base_url + PREFIX + path, data=data,
                                 method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _prompts():
    rng = np.random.default_rng(2)
    return [[int(t) for t in rng.integers(1, 97, size=n)]
            for n in (9, 23, 30, 17)]


def test_concurrent_greedy_predicts_match_solo_and_jax(server, jax_api):
    status, body = _call(server, "POST", "/serve/slm",
                         {"type": "lm", "maxSlots": 4, "cacheLen": 64,
                          "temperature": 0.0})
    assert status == 201, body
    assert body["kind"] == "lm" and body["slots"] == 4
    assert body["cacheLen"] == 64
    prompts, new = _prompts(), 12
    out = [None] * len(prompts)

    def client(i):
        out[i] = _call(server, "POST", "/serve/slm/predict",
                       {"prompt": prompts[i], "maxNewTokens": new})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)

    solo_lm = server.api.ctx.artifacts.load("slm")
    jax_lm = jax_api.ctx.artifacts.load("slm", "train/tensorflow")
    for prompt, (status, body) in zip(prompts, out):
        assert status == 200, body
        solo = solo_lm.generate([prompt], max_new_tokens=new)[0]
        want = jax_lm.generate(np.asarray([prompt], np.int32),
                               max_new_tokens=new)[0]
        assert body["tokens"] == [int(t) for t in solo[len(prompt):]]
        assert body["tokens"] == [int(t) for t in want[len(prompt):]]

    status, stats = _call(server, "GET", "/serve/slm")
    assert status == 200
    assert stats["tokensTotal"] == new * len(prompts)
    assert stats["requestsTotal"] == len(prompts)
    assert stats["ttft"]["count"] == len(prompts)
    assert stats["perf"]["decodeSteps"] >= new - 1
    assert 0 < stats["perf"]["goodputFrac"] <= 1
    status, listing = _call(server, "GET", "/serve")
    assert status == 200 and [s["model"] for s in listing["result"]] == \
        ["slm"]

    status, body = _call(server, "DELETE", "/serve/slm")
    assert status == 200 and body["deleted"] is True
    status, body = _call(server, "POST", "/serve/slm/predict",
                         {"prompt": [1, 2]})
    assert status == 404
    assert _call(server, "GET", "/serve") == (200, {"result": []})


def test_sampled_slot_streams_match_solo_generate(server):
    """Sampled streams draw from per-request, per-position generators,
    so a slot reproduces a solo ``generate`` with the same seed."""
    status, body = _call(server, "POST", "/serve/slm",
                         {"maxSlots": 3, "temperature": 0.7, "topK": 12})
    assert status == 201, body
    prompts = _prompts()[:3]
    out = [None] * 3

    def client(i):
        out[i] = _call(server, "POST", "/serve/slm/predict",
                       {"prompt": prompts[i], "maxNewTokens": 8 + i,
                        "seed": 40 + i})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    lm = server.api.ctx.artifacts.load("slm")
    for i, (status, body) in enumerate(out):
        assert status == 200, body
        solo = lm.generate([prompts[i]], max_new_tokens=8 + i,
                           temperature=0.7, top_k=12, seed=40 + i)[0]
        assert body["tokens"] == [int(t) for t in solo[len(prompts[i]):]]


def test_error_bodies_match_jax(server, jax_api):
    """Status codes and bodies of the refusals the two servers share."""

    def jax_call(method, path, body=None):
        status, payload, _ = jax_api.dispatch(method, PREFIX + path, {},
                                              body)
        return status, payload

    cases = [
        ("POST", "/serve/nope", {}),                        # 404 artifact
        ("POST", "/serve/slm", {"maxSlots": 0}),            # 406
        ("POST", "/serve/slm", {"type": "bad"}),            # 406
        ("POST", "/serve/slm", {"temperature": "hot"}),     # 406
        ("POST", "/serve/slm", {"kv": "ring"}),             # 406
        ("POST", "/serve/slm", {"weights": "int4"}),        # 406
        ("POST", "/serve/slm", {"kvDtype": "int8"}),        # 406 slot
        ("POST", "/serve/slm/predict", {"prompt": [1]}),    # 404 session
        ("GET", "/serve/slm", None),                        # 404 session
        ("DELETE", "/serve/slm", None),                     # 404 session
        ("GET", "/nothing/here", None),                     # 404 route
        ("POST", "/serve/slm", {"cacheLen": 16}),           # 201
        ("POST", "/serve/slm", {}),                         # 409
        ("POST", "/serve/slm/predict", {"prompt": []}),     # 406
        ("POST", "/serve/slm/predict", {"prompt": "abc"}),
        ("POST", "/serve/slm/predict", {"prompt": [1, 2],
                                        "maxNewTokens": 16}),
        ("POST", "/serve/slm/predict", {"prompt": [1, 2],
                                        "maxNewTokens": 0}),
        ("POST", "/serve/slm/predict", {"prompt": [1, 2], "seed": "x"}),
        ("POST", "/serve/slm/predict", {"prompt": [1, 2],
                                        "timeout": -1}),
    ]
    for method, path, body in cases:
        want = jax_call(method, path, body)
        got = _call(server, method, path, body)
        if want[0] == 201:
            assert got[0] == 201, got
            continue
        assert got == want, (method, path, body)
    assert _call(server, "DELETE", "/serve/slm")[0] == 200
    jax_call("DELETE", "/serve/slm")


def test_unported_session_options_are_refused(server, jax_api):
    """Only ``sliceDevices`` is refused as not yet ported (one card has
    no slice of a mesh to lease). The speculative, disaggregated and
    bucketed fields answer as the JAX server does, status and body: on
    the slot path ``disagg`` and ``draft`` are 406, ``specK`` and
    ``prefillDevices`` alone are accepted, and ``type: "predict"`` makes
    a bucketed session of the LM's ``predict``."""
    status, reply = _call(server, "POST", "/serve/slm", {"sliceDevices": 2})
    assert status == 406
    assert "not yet ported" in reply["result"]
    for body in ({"specK": 4}, {"prefillDevices": 2}, {"type": "predict"},
                 {"disagg": True}, {"draft": "d"}):
        want = jax_api.dispatch("POST", PREFIX + "/serve/slm", {}, body)
        got = _call(server, "POST", "/serve/slm", body)
        if want[0] == 201:
            assert got[0] == 201, (body, got)
            assert got[1]["kind"] == want[1]["kind"]
            assert _call(server, "DELETE", "/serve/slm")[0] == 200
            jax_api.dispatch("DELETE", PREFIX + "/serve/slm", {}, None)
        else:
            assert got == want[:2], body
            assert "not yet ported" not in got[1]["result"]
    status, reply = _call(server, "POST", "/serve/slm", {})
    assert status == 201
    status, reply = _call(server, "POST", "/serve/slm/predict",
                          {"prompt": [1, 500]})
    assert status == 406 and "token ids" in reply["result"]
    assert _call(server, "DELETE", "/serve/slm")[0] == 200
