"""The PyTorch port's speculative, disaggregated and bucketed serving, on
the CPU, against the JAX package's.

- The multi-position paged ops (``paged_append_tokens``,
  ``paged_verify_attention`` and their int8 forms) against the JAX ops,
  with windows that straddle a page end and writes past ``limit`` routed
  to trash page 0: appended pools equal JAX's exactly (float32, bf16 and
  int8 values with their scales; page 0 is left out, duplicate trash
  writes pick any winner in either package), the verify reductions equal
  the port's own one-token ``decode_attention`` bit for bit and JAX's at
  atol 2e-6 (two frameworks summing in their own order; the int8 form's
  larger outputs also at rtol 1e-6).
- ``serve_fns_spec``'s verify at temperature 0 and ``serve_fns_draft``'s
  propose give the JAX functions' tokens for one weight tree.
- The sessions, as ``tests/test_serving.py`` runs the JAX ones: greedy
  disaggregated spec streams equal solo ``generate``; sampled acceptance
  keeps the target's distribution (total variation under 0.08 over 800
  fixed seeds, the JAX test's bound); the handoff's refcounts after
  publish, adoption, drain and a latched fault; the error bodies of the
  new fields equal the JAX server's word for word.
- The bucketed ``predict`` session of a ``TextClassifier``: buckets 1, 4
  and 8, pad rows never returned, concurrent requests each get their own
  rows, ragged rows 406, and the predictions of JAX's session for the
  same weights within atol 2e-5 (float32; the classifier tests' bound).
"""

import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.models import transformer as jax_tlm
from learningorchestra_tpu.ops import attention as jax_ops
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import TextClassifier, weights
from learningorchestra_tpu_torch.models.transformer import LanguageModel
from learningorchestra_tpu_torch.ops import attention as ops
from learningorchestra_tpu_torch.services import faults
from learningorchestra_tpu_torch.services import serving as serving_mod
from learningorchestra_tpu_torch.services import validators as V
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
ATOL = 2e-6
# the JAX spec tests' LM, and the cycle of the successor stream both the
# target and the draft learn
CFG = dict(vocab_size=48, d_model=32, n_layers=1, n_heads=2, d_ff=64,
           max_len=32)
CYCLE = 16
CLF = dict(vocab_size=40, n_classes=3, d_model=32, n_layers=2, n_heads=4,
           n_kv_heads=2, max_len=24)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _long(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ----------------------------------------------------------------------
# the multi-position paged ops
# ----------------------------------------------------------------------
PAGE_LEN, N_PAGES, KV, D, H = 4, 12, 2, 8, 4
# three streams: a window inside one page, one across a page end, and one
# whose funded pages end inside the window (its tail goes to page 0)
BT = np.asarray([[3, 7, 0], [5, 1, 9], [2, 11, 0]], np.int64)
POS = np.asarray([0, 2, 5], np.int64)
LIMIT = np.asarray([11, 11, 6], np.int64)


def _pool(rng, dtype=np.float32):
    return (rng.normal(size=(N_PAGES, PAGE_LEN, KV, D)) * 3).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_limit", [False, True])
def test_paged_append_tokens_matches_jax(dtype, with_limit):
    rng = np.random.default_rng(1)
    pool = _pool(rng)
    new = rng.normal(size=(3, 4, KV, D)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    limit = LIMIT if with_limit else None
    got = ops.paged_append_tokens(
        _t(pool).to(tdt), _t(new).to(tdt), _long(BT), _long(POS), PAGE_LEN,
        limit=None if limit is None else _long(limit))
    want = jax_ops.paged_append_tokens(
        jnp.asarray(pool, dtype), jnp.asarray(new, dtype),
        jnp.asarray(BT, jnp.int32), jnp.asarray(POS, jnp.int32), PAGE_LEN,
        limit=None if limit is None else jnp.asarray(limit, jnp.int32))
    np.testing.assert_array_equal(_np(got)[1:],
                                  np.asarray(want, np.float32)[1:])
    # each row's position j sits where the one-token append puts it
    seq = _t(pool).to(tdt)
    for j in range(new.shape[1]):
        p = _long(POS + j)
        bt = _long(BT)
        if with_limit:
            bt = torch.where(p[:, None] <= _long(LIMIT)[:, None], bt, 0)
        ops.paged_append_token(seq, _t(new[:, j]).to(tdt), bt, p, PAGE_LEN)
    assert torch.equal(got[1:], seq[1:])
    if with_limit:
        # stream 2's positions 7 and 8 are past its limit: its page 11
        # keeps rows 3.. as they were
        np.testing.assert_array_equal(_np(got)[11, 3:],
                                      _np(_t(pool).to(tdt))[11, 3:])


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("with_pad", [False, True])
def test_paged_verify_attention_is_the_sequential_reduction(window, with_pad):
    rng = np.random.default_rng(2 + window)
    k_pool, v_pool = _pool(rng), _pool(rng)
    q = rng.normal(size=(3, 4, H, D)).astype(np.float32)
    pad = np.asarray([0, 1, 2], np.int64) if with_pad else None
    kw = dict(window=window)
    got = ops.paged_verify_attention(
        _t(q), _t(k_pool), _t(v_pool), _long(BT), _long(POS),
        pad_offset=None if pad is None else _long(pad), **kw)
    for j in range(4):
        one = ops.paged_decode_attention(
            _t(q[:, j:j + 1]), _t(k_pool), _t(v_pool), _long(BT),
            _long(POS + j), pad_offset=None if pad is None else _long(pad),
            **kw)
        assert torch.equal(got[:, j:j + 1], one), j
    want = jax_ops.paged_verify_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(BT, jnp.int32), jnp.asarray(POS, jnp.int32),
        pad_offset=None if pad is None else jnp.asarray(pad, jnp.int32),
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    clamped = ops.paged_verify_attention(
        _t(q), _t(k_pool), _t(v_pool), _long(BT), _long(POS), max_pages=2,
        **kw)
    assert torch.equal(clamped, ops.paged_verify_attention(
        _t(q), _t(k_pool), _t(v_pool), _long(BT[:, :2]), _long(POS), **kw))


def _int8_pool(rng):
    q, s = jax_ops.quantize_kv_pages(jnp.asarray(_pool(rng)))
    return np.array(q), np.array(s)


@pytest.mark.parametrize("with_limit", [False, True])
def test_quantized_paged_append_tokens_matches_jax(with_limit):
    rng = np.random.default_rng(3)
    pool, scales = _int8_pool(rng)
    new = rng.normal(size=(3, 4, KV, D)).astype(np.float32)
    limit = LIMIT if with_limit else None
    gq, gs = ops.quantized_paged_append_tokens(
        _t(pool), _t(scales), _t(new), _long(BT), _long(POS), PAGE_LEN,
        limit=None if limit is None else _long(limit))
    wq, ws = jax_ops.quantized_paged_append_tokens(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(new),
        jnp.asarray(BT, jnp.int32), jnp.asarray(POS, jnp.int32), PAGE_LEN,
        limit=None if limit is None else jnp.asarray(limit, jnp.int32))
    np.testing.assert_array_equal(gq.numpy()[1:], np.asarray(wq)[1:])
    np.testing.assert_array_equal(gs.numpy()[1:], np.asarray(ws)[1:])


@pytest.mark.parametrize("window", [0, 3])
def test_quantized_paged_verify_attention_matches_jax(window):
    rng = np.random.default_rng(4)
    (kq, ks), (vq, vs) = _int8_pool(rng), _int8_pool(rng)
    q = rng.normal(size=(3, 4, H, D)).astype(np.float32)
    got = ops.quantized_paged_verify_attention(
        _t(q), _t(kq), _t(ks), _t(vq), _t(vs), _long(BT), _long(POS),
        window=window)
    for j in range(4):
        one = ops.quantized_paged_decode_attention(
            _t(q[:, j:j + 1]), _t(kq), _t(ks), _t(vq), _t(vs), _long(BT),
            _long(POS + j), window=window)
        assert torch.equal(got[:, j:j + 1], one), j
    want = jax_ops.quantized_paged_verify_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), jnp.asarray(BT, jnp.int32),
        jnp.asarray(POS, jnp.int32), window=window)
    # outputs of up to ~7 here: a few float32 ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-6)


def test_multi_position_decode_needs_the_paged_path():
    lm = LanguageModel(**CFG, device="cpu")
    lm.set_params(weights.params_from_flax(weights.init_params(CFG, 0)))
    cache = lm.serve_cache(1, 16)
    with pytest.raises(ValueError, match="requires the paged KV path"):
        lm.module(torch.ones((1, 3), dtype=torch.long), cache=cache,
                  decode_pos=torch.zeros(1, dtype=torch.long))


# ----------------------------------------------------------------------
# verify and propose against the JAX functions
# ----------------------------------------------------------------------
SLOTS, CACHE_LEN, PL, SPEC_K = 2, 32, 8, 3
N_POOL = 1 + SLOTS * CACHE_LEN // PL


@pytest.fixture(scope="module")
def pair():
    tree = weights.init_params(CFG, seed=5)
    jlm = jax_tlm.LanguageModel(**CFG, attention="dot")
    jlm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    lm = LanguageModel(**CFG, device="cpu")
    lm.set_params(weights.params_from_flax(tree))
    return jlm, lm


def _prompts():
    rng = np.random.default_rng(6)
    return [[int(t) for t in rng.integers(1, 48, size=n)] for n in (5, 11)]


def _filled_pools(jlm, lm, prompts, temperature=0.0, top_k=None):
    """Both packages' pools holding each prompt's KV in the pages of its
    block-table row, and each prompt's first token."""
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int64)
    _, jprefill, jjoin, _, _ = jlm.serve_fns_paged(
        SLOTS, CACHE_LEN, PL, N_POOL, temperature, top_k)
    _, pprefill, pjoin, _, _ = lm.serve_fns_paged(
        SLOTS, CACHE_LEN, PL, N_POOL, temperature, top_k)
    jpool = jlm.serve_cache_paged(N_POOL, PL)
    ppool = lm.serve_cache_paged(N_POOL, PL)
    firsts = []
    for i, prompt in enumerate(prompts):
        s = len(prompt)
        n = -(-s // PL)
        nxt, _, pc = jprefill(s)(jlm.params, jnp.asarray([prompt], jnp.int32),
                                 jr.PRNGKey(0))
        jpool = jjoin(jpool, pc, jnp.asarray(bt[i, :n], jnp.int32), 0)
        pnxt, _, ppc = pprefill(s)(torch.tensor([prompt]), 0)
        pjoin(ppool, ppc, _long(bt[i, :n]), 0)
        assert int(pnxt[0]) == int(nxt[0])
        firsts.append(int(nxt[0]))
    return jpool, ppool, bt, firsts


def test_greedy_verify_matches_jax(pair):
    """A draft window that is the target's own greedy continuation (all
    accepted) and one of random ids (rejected at once): the same emitted
    tokens and acceptance counts as JAX's ``serve_fns_spec``."""
    jlm, lm = pair
    prompts = _prompts()
    jpool, ppool, bt, firsts = _filled_pools(jlm, lm, prompts)
    greedy = [list(np.asarray(jlm.generate(
        np.asarray([p], np.int32), max_new_tokens=SPEC_K + 1))[0][
            len(p) + 1:]) for p in prompts]
    rng = np.random.default_rng(7)
    junk = rng.integers(1, 48, size=(SLOTS, SPEC_K))
    jverify = jlm.serve_fns_spec(SLOTS, CACHE_LEN, PL, N_POOL, SPEC_K, 0.0)
    pverify = lm.serve_fns_spec(SLOTS, CACHE_LEN, PL, N_POOL, SPEC_K, 0.0)
    tok = np.asarray(firsts, np.int64)[:, None]
    col = np.asarray([len(p) for p in prompts], np.int64)
    limit = np.asarray([4 * PL - 1, 4 * PL - 1], np.int64)
    keys = np.stack([np.asarray(jr.PRNGKey(i)) for i in range(SLOTS)])
    for drafts in (np.asarray(greedy, np.int64), junk):
        emitted, n_acc, jpool = jverify(
            jlm.params, jpool, jnp.asarray(tok, jnp.int32),
            jnp.asarray(drafts, jnp.int32), jnp.asarray(col, jnp.int32),
            jnp.asarray(keys), jnp.asarray(bt, jnp.int32),
            jnp.asarray(limit, jnp.int32))
        got_e, got_n = pverify(ppool, tok, drafts, col,
                               np.zeros(SLOTS, np.int64), _long(bt), limit)
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(emitted))
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(n_acc))
    # the greedy window: every draft accepted, the bonus is solo's
    got_e, got_n = pverify(ppool, tok, np.asarray(greedy), col,
                           np.zeros(SLOTS, np.int64), _long(bt), limit)
    assert got_n.tolist() == [SPEC_K, SPEC_K]
    for i, p in enumerate(prompts):
        solo = lm.generate([p], max_new_tokens=SPEC_K + 2)[0][len(p) + 1:]
        assert got_e[i].tolist() == [int(t) for t in solo]


def test_propose_matches_jax(pair):
    """The draft's greedy proposals over its slot cache equal JAX's
    ``serve_fns_draft``'s, and the draft cache holds the k + 1 appended
    rows (the next window attends a whole prefix)."""
    jlm, lm = pair
    prompts = _prompts()
    _, jprefill, jjoin = jlm.serve_fns(SLOTS, CACHE_LEN, 0.0, None, None)
    _, pprefill, pjoin = lm.serve_fns(SLOTS, CACHE_LEN, 0.0, None, None)
    jcache = jlm.serve_cache(SLOTS, CACHE_LEN)
    pcache = lm.serve_cache(SLOTS, CACHE_LEN)
    firsts = []
    for i, prompt in enumerate(prompts):
        nxt, pc = jprefill(len(prompt))(
            jlm.params, jnp.asarray([prompt], jnp.int32), jr.PRNGKey(0))
        jcache = jjoin(jcache, pc, jnp.asarray(i, jnp.int32))
        _, ppc = pprefill(len(prompt))(torch.tensor([prompt]), 0)
        pcache = pjoin(pcache, ppc, i)
        firsts.append(int(nxt[0]))
    tok = np.asarray(firsts, np.int64)[:, None]
    col = np.asarray([len(p) for p in prompts], np.int64)
    want, _ = jlm.serve_fns_draft(SLOTS, CACHE_LEN, SPEC_K)(
        jlm.params, jcache, jnp.asarray(tok, jnp.int32),
        jnp.asarray(col, jnp.int32))
    got = lm.serve_fns_draft(SLOTS, CACHE_LEN, SPEC_K)(pcache, tok, col)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i, p in enumerate(prompts):
        solo = lm.generate([p], max_new_tokens=SPEC_K + 1)[0][len(p) + 1:]
        assert got[i].tolist() == [int(t) for t in solo]
        # rows col .. col + k were written, the row after stays zero
        ck = pcache[0][0][i]
        assert bool(ck[col[i] + SPEC_K].abs().sum() > 0)
        assert bool(ck[col[i] + SPEC_K + 1].abs().sum() == 0)


# ----------------------------------------------------------------------
# the sessions
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def cycle_states():
    """Target and draft state dicts fitted on the cyclic-successor
    stream (token t is always followed by t % 16 + 1), the draft on the
    rows in reverse order: close weights, not identical, so the draft
    mostly proposes what the target picks."""
    tokens = np.asarray([[(off + i) % CYCLE + 1 for i in range(16)]
                         for off in range(64)], np.int32)
    out = []
    for rows, seed in ((tokens, 0), (tokens[::-1].copy(), 1)):
        lm = LanguageModel(**CFG, device="cpu")
        lm.seed = seed
        lm.fit(rows, batch_size=16, epochs=25)
        out.append({k: t.detach().clone() for k, t in lm.params.items()})
    return out


def _api(tmp_path, states=None, **overrides):
    faults.reset()
    ctx = ServiceContext(Config(home=str(tmp_path / "torch_home"),
                                serve_max_wait_ms=1.0, **overrides),
                         device="cpu")
    if states is None:
        states = [weights.params_from_flax(weights.init_params(CFG, 5))]
    for name, state in zip(("slm", "sdraft"), states):
        lm = LanguageModel(**CFG, device="cpu")
        lm.set_params(state)
        ctx.artifacts.save(lm, name, "train/tensorflow")
    return Api(ctx)


def _call(api, method, path, body=None):
    status, payload, _ = api.dispatch(method, PREFIX + path, {}, body)
    return status, payload


def _paged_session(api, **extra):
    body = {"kv": "paged", "pageLen": 8, "maxSlots": 4, "cacheLen": 32,
            "temperature": 0.7, "topK": 12}
    body.update(extra)
    status, resp = _call(api, "POST", "/serve/slm", body)
    assert status == 201, resp
    return resp


def _solo(lm, prompt, new, seed=0, temperature=0.0, top_k=None):
    out = lm.generate([prompt], max_new_tokens=new, temperature=temperature,
                      top_k=top_k, seed=seed)
    return [int(t) for t in out[0][len(prompt):]]


def _wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _prefix_held(session):
    with session.prefix._lock:
        return sum(len(e["held"]) for e in session.prefix._entries.values())


def _session(api):
    return api.ctx.serving._sessions["slm"]


def _concurrent(api, specs, seed=1):
    out = [None] * len(specs)

    def client(i):
        prompt, new = specs[i]
        time.sleep(0.03 * i)
        out[i] = _call(api, "POST", "/serve/slm/predict",
                       {"prompt": prompt, "maxNewTokens": new, "seed": seed})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(specs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out


def _cycle_specs():
    rng = np.random.default_rng(81)
    specs = [([(phase * 3 + i) % CYCLE + 1 for i in range(plen)], new)
             for phase, (plen, new) in enumerate(
                 [(3, 6), (5, 8), (8, 5), (4, 7), (6, 6)])]
    # off the pattern: the draft and the target disagree, so the greedy
    # rejection path runs in the same batch
    specs.append(([int(t) for t in rng.integers(1, 48, size=6)], 6))
    return specs


def test_disagg_spec_greedy_bit_identical_to_solo(tmp_path, cycle_states):
    """A disaggregated session with a draft (prefill worker, refcounted
    handoff, 3-token propose and verify rounds) gives each request solo
    greedy ``generate``'s tokens, at >= 1 accepted token a verify step,
    and leaves the pool to the prefix cache's holds."""
    api = _api(tmp_path, cycle_states)
    try:
        lm = api.ctx.artifacts.load("slm")
        resp = _paged_session(api, disagg=True, draft="sdraft", specK=3,
                              temperature=0.0)
        assert resp["disagg"]["mode"] == "colocated"
        assert resp["spec"]["draft"] == "sdraft"
        assert resp["spec"]["specK"] == 3
        specs = _cycle_specs()
        out = _concurrent(api, specs)
        for i, (prompt, new) in enumerate(specs):
            assert out[i][0] == 200, out[i]
            assert out[i][1]["tokens"] == _solo(lm, prompt, new), i
        stats = _call(api, "GET", "/serve/slm")[1]
        assert stats["spec"]["steps"] > 0
        assert stats["spec"]["acceptedTokensPerStep"] >= 1.0
        assert stats["perf"]["acceptedTokensPerStep"] >= 1.0
        assert stats["disagg"]["handoffsTotal"] == len(specs)
        assert stats["disagg"]["handoffQueue"] == 0
        assert set(stats["roles"]) == {"prefill", "decode", "draft"}
        assert stats["ttft"]["count"] == len(specs)
        session = _session(api)
        assert session.pool.free_count() == \
            stats["kv"]["pagesTotal"] - _prefix_held(session)
        assert _call(api, "DELETE", "/serve/slm")[0] == 200
    finally:
        api.ctx.close()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_fused_spec_session_with_the_target_as_draft(tmp_path, kv_dtype):
    """The target as its own draft on a fused paged session: exact pages
    give solo's tokens with every draft accepted except where a stream's
    end clamps the window; int8 pages answer every request."""
    api = _api(tmp_path)
    try:
        lm = api.ctx.artifacts.load("slm")
        resp = _paged_session(api, draft="slm", specK=4, temperature=0.0,
                              kvDtype=kv_dtype)
        assert "disagg" not in resp and resp["spec"]["active"]
        rng = np.random.default_rng(8)
        specs = [([int(t) for t in rng.integers(1, 48, size=n)], new)
                 for n, new in ((3, 9), (7, 11), (12, 6), (5, 14))]
        out = _concurrent(api, specs)
        assert all(o[0] == 200 for o in out), out
        if kv_dtype == "bf16":
            for i, (prompt, new) in enumerate(specs):
                assert out[i][1]["tokens"] == _solo(lm, prompt, new), i
            spec = _call(api, "GET", "/serve/slm")[1]["spec"]
            assert spec["acceptedTokensPerStep"] >= 1.0
    finally:
        api.ctx.close()


def test_spec_sampled_acceptance_keeps_target_distribution(tmp_path):
    """The first token a sampled verify emits is distributed as the
    target's filtered softmax, whether the draft is the likeliest token
    (acceptance) or an impossible one (the residual): total variation
    under 0.08 over 800 fixed seeds."""
    lm = LanguageModel(**CFG, device="cpu")
    lm.set_params(weights.params_from_flax(weights.init_params(CFG, 5)))
    slots, cache_len, page_len, spec_k = 1, 32, 8, 2
    n_pages = 1 + cache_len // page_len
    _, prefill_for, join_paged, _, _ = lm.serve_fns_paged(
        slots, cache_len, page_len, n_pages, 0.7, 12)
    verify = lm.serve_fns_spec(slots, cache_len, page_len, n_pages, spec_k,
                               0.7, 12)
    prompt = [3, 9, 17, 5]
    s = len(prompt)
    pool = lm.serve_cache_paged(n_pages, page_len)
    nxt, _, pcache = prefill_for(s)(torch.tensor([prompt]), 0)
    join_paged(pool, pcache, _long([1]), 0)
    t0 = int(nxt[0])
    # the target's distribution at position s + 1, filtered as serving
    # filters it
    _, last, _ = prefill_for(s + 1)(torch.tensor([prompt + [t0]]), 0)
    p_target = torch.softmax(
        lm._filter_logits(last[0], 0.7, 12).double(), dim=-1).numpy()
    bt = _long([[1, 2, 3, 4]])
    n_draws = 800
    for arm, d in (("accept", int(np.argmax(p_target))),
                   ("residual", int(np.argmin(p_target)))):
        counts = np.zeros(48, np.int64)
        for i in range(n_draws):
            emitted, _ = verify(pool, [[t0]], [[d, 0]], [s], [1000 + i], bt,
                                [cache_len - 1])
            counts[int(emitted[0, 0])] += 1
        tv = 0.5 * float(np.abs(counts / n_draws - p_target).sum())
        assert tv < 0.08, (arm, tv)


def test_disagg_handoff_refcounts_publish_adopt_and_drain(tmp_path):
    """A published record holds its stream references and an uncharged
    publish hold: a drain before adoption restores the free count
    exactly, and an adopted record's pages are freed once, at
    retirement."""
    api = _api(tmp_path)
    try:
        lm = api.ctx.artifacts.load("slm")
        resp = _paged_session(api, disagg=True)
        session = _session(api)
        assert isinstance(session, serving_mod.DisaggLMServingSession)
        pages_total = resp["kv"]["pagesTotal"]
        assert session.pool.free_count() == pages_total
        rng = np.random.default_rng(91)
        prompt = [int(t) for t in rng.integers(1, 48, size=6)]
        status, body = _call(api, "POST", "/serve/slm/predict",
                             {"prompt": prompt, "maxNewTokens": 5,
                              "seed": 13})
        assert status == 200
        assert body["tokens"] == _solo(lm, prompt, 5, 13, 0.7, 12)
        assert _wait_until(lambda: session.pool.free_count()
                           == pages_total - _prefix_held(session))
        base = session.pool.free_count()

        # published, never adopted: ceil((6 + 5) / 8) = 2 pages
        req = serving_mod._Request(
            {"prompt": prompt, "maxNewTokens": 5, "seed": 17})
        rec = session._prepare(req)
        assert rec["published"] is True
        assert session.pool.free_count() == base - 2
        session._discard_record(rec, V.HttpError(
            V.HTTP_UNAVAILABLE, "prefill worker torn down"))
        assert session.pool.free_count() == base
        assert session.pool.tenant_pages("default") == 0
        assert req.error is not None and req.error.status == 503

        # published and adopted: the decode worker serves it
        req2 = serving_mod._Request(
            {"prompt": prompt, "maxNewTokens": 5, "seed": 19})
        rec2 = session._prepare(req2)
        with session._handoff_cv:
            session._ready.append(rec2)
            session.handoffs_total += 1
        with session._cv:
            session._cv.notify_all()
        assert req2.event.wait(30), "the adopted stream never finished"
        assert req2.error is None
        assert req2.result["tokens"] == _solo(lm, prompt, 5, 19, 0.7, 12)
        assert _wait_until(lambda: session.pool.free_count() == base)
        assert session.pool.tenant_pages("default") == 0
        assert _call(api, "DELETE", "/serve/slm")[0] == 200
    finally:
        api.ctx.close()


def test_disagg_handoff_transient_fault_is_retryable(tmp_path):
    api = _api(tmp_path, fault_inject="kv_page_handoff:1")
    try:
        resp = _paged_session(api, disagg=True)
        session = _session(api)
        prompt = [4, 8, 15, 16, 23]
        status, body = _call(api, "POST", "/serve/slm/predict",
                             {"prompt": prompt, "maxNewTokens": 4})
        assert status == 429 and "retry with backoff" in body["result"]
        assert session.pool.free_count() == resp["kv"]["pagesTotal"]
        status, body = _call(api, "POST", "/serve/slm/predict",
                             {"prompt": prompt, "maxNewTokens": 4})
        assert status == 200, body
        stats = _call(api, "GET", "/serve/slm")[1]
        assert stats["disagg"]["mode"] == "colocated"
        assert stats["disagg"]["handoffFaultStreak"] == 0
    finally:
        api.ctx.close()


def test_disagg_handoff_latched_fault_collapses_to_fused(tmp_path):
    """Three injected handoff faults are three 429s with every page
    reference restored; the session then collapses to fused serving and
    later requests give solo's tokens, the pool leak-free."""
    api = _api(tmp_path, fault_inject="kv_page_handoff:100")
    try:
        lm = api.ctx.artifacts.load("slm")
        # greedy: a spec session's sampled tokens follow solo's
        # distribution, not its draws
        resp = _paged_session(api, disagg=True, draft="slm", specK=2,
                              temperature=0.0)
        pages_total = resp["kv"]["pagesTotal"]
        session = _session(api)
        rng = np.random.default_rng(92)
        prompt = [int(t) for t in rng.integers(1, 48, size=6)]
        body = {"prompt": prompt, "maxNewTokens": 5, "seed": 43}
        for _ in range(3):
            status, out = _call(api, "POST", "/serve/slm/predict", body)
            assert status == 429, out
            assert session.pool.free_count() == pages_total
        assert _wait_until(lambda: _call(api, "GET", "/serve/slm")[1][
            "disagg"]["mode"] == "fused-degraded")
        status, out = _call(api, "POST", "/serve/slm/predict", body)
        assert status == 200, out
        assert out["tokens"] == _solo(lm, prompt, 5, 43)
        assert session.pool.free_count() == \
            pages_total - _prefix_held(session)
        stats = _call(api, "GET", "/serve/slm")[1]
        assert stats["kv"]["mode"] == "paged"
        assert stats["spec"]["active"] is True
    finally:
        api.ctx.close()


def test_slot_degrade_ends_speculation(tmp_path):
    """A latched ``kv_page_alloc`` fault on a disaggregated spec session
    collapses it to fused and then to the slot cache: the draft and its
    cache are dropped and later requests serve solo's tokens."""
    api = _api(tmp_path, fault_inject="kv_page_alloc:3")
    try:
        lm = api.ctx.artifacts.load("slm")
        _paged_session(api, disagg=True, draft="slm", specK=2,
                       temperature=0.0)
        prompt = [5, 6, 7, 8]
        for _ in range(3):
            status, _ = _call(api, "POST", "/serve/slm/predict",
                              {"prompt": prompt, "maxNewTokens": 4})
            assert status == 429
        status, out = _call(api, "POST", "/serve/slm/predict",
                            {"prompt": prompt, "maxNewTokens": 4})
        assert status == 200, out
        assert out["tokens"] == _solo(lm, prompt, 4)
        stats = _call(api, "GET", "/serve/slm")[1]
        assert stats["kv"]["mode"] == "slot-degraded"
        assert stats["disagg"]["mode"] == "fused-degraded"
        assert stats["spec"]["active"] is False
        assert _session(api)._draft_cache is None
    finally:
        api.ctx.close()


@pytest.fixture()
def jax_api(tmp_path):
    jax_config.set_config(jax_config.Config(
        home=str(tmp_path / "jax_home"), compute_dtype="float32",
        serve_max_wait_ms=1.0))
    from learningorchestra_tpu.services.server import Api as JaxApi

    japi = JaxApi()
    yield japi
    japi.ctx.close()
    jax_config.reset_config()


def _save_both(jax_api, api, name, config, seed=5):
    tree = weights.init_params(config, seed)
    jlm = jax_tlm.LanguageModel(**config, attention="dot")
    jlm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jax_api.ctx.artifacts.save(jlm, name, "train/tensorflow")
    lm = LanguageModel(**config, device="cpu")
    lm.set_params(weights.params_from_flax(tree))
    api.ctx.artifacts.save(lm, name, "train/tensorflow")


def test_spec_and_disagg_error_bodies_match_jax(tmp_path, jax_api):
    """The new create fields answer as the JAX server does, status and
    body: the slot path refuses disagg and draft, a draft must exist,
    share the vocabulary and cover cacheLen, and ``specK`` /
    ``prefillDevices`` alone are accepted."""
    api = _api(tmp_path)
    try:
        _save_both(jax_api, api, "slm", CFG)
        _save_both(jax_api, api, "dvocab", dict(CFG, vocab_size=40))
        _save_both(jax_api, api, "dshort", dict(CFG, max_len=16))
        paged = {"kv": "paged", "pageLen": 8, "cacheLen": 32}
        cases = [
            {"kv": "slot", "disagg": True},
            {"kv": "slot", "draft": "slm"},
            {"kv": "paged", "disagg": "yes"},
            {"kv": "paged", "draft": "nonexistent-draft"},
            dict(paged, draft=7),
            dict(paged, draft="dvocab"),
            dict(paged, draft="dshort"),
            dict(paged, draft="slm", specK=0),
            dict(paged, disagg=True, prefillDevices=0),
            dict(paged, disagg=True, prefillDevices={"min": 2, "max": 1}),
            dict(paged, disagg=True, prefillDevices={"n": 1}),
            {"specK": 4},
            {"prefillDevices": 2},
            {"kv": "slot", "disagg": False},
            dict(paged, specK=0),
            dict(paged, disagg=True, prefillDevices=2),
            dict(paged, disagg=True, draft="slm", specK=2),
        ]
        for body in cases:
            status, want, _ = jax_api.dispatch("POST", PREFIX + "/serve/slm",
                                               {}, body)
            got = _call(api, "POST", "/serve/slm", body)
            if status == 201:
                assert got[0] == 201, (body, got)
                for a in (api, None):
                    if a is None:
                        jax_api.dispatch("DELETE", PREFIX + "/serve/slm",
                                         {}, None)
                    else:
                        assert _call(a, "DELETE", "/serve/slm")[0] == 200
                continue
            assert got == (status, want), body
    finally:
        api.ctx.close()


# ----------------------------------------------------------------------
# bucketed predict serving
# ----------------------------------------------------------------------
@pytest.fixture()
def float32(monkeypatch):
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    yield


def _clf_pair(tmp_path, jax_api):
    tree = weights.init_params(CLF, 0)
    tree["cls_head"]["bias"] = np.array([0.1, -0.2, 0.05], np.float32)
    jclf = jax_tlm.TextClassifier(**CLF, attention="dot")
    jclf.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jax_api.ctx.artifacts.save(jclf, "clf", "train/tensorflow")
    ctx = ServiceContext(Config(home=str(tmp_path / "torch_home"),
                                serve_max_wait_ms=1.0), device="cpu")
    clf = TextClassifier(**CLF, device="cpu")
    clf.set_params(weights.params_from_flax(tree))
    ctx.artifacts.save(clf, "clf", "train/tensorflow")
    return Api(ctx), ctx.artifacts.load("clf")


def _rows(rng, n):
    x = rng.integers(1, CLF["vocab_size"], size=(n, CLF["max_len"]))
    x[:, rng.integers(6, CLF["max_len"]):] = 0
    return x.tolist()


def test_bucket_padding_correctness(tmp_path, jax_api, float32):
    """Bursts of 1, 3 and 5 rows land in buckets 1, 4 and 8; the rows
    are a padded predict's first rows exactly and JAX's session's within
    atol 2e-5; a concurrent burst returns each request its own rows;
    ragged and empty rows answer 406, as in JAX."""
    api, clf = _clf_pair(tmp_path, jax_api)
    try:
        for a in (api, jax_api):
            status, body, _ = a.dispatch("POST", PREFIX + "/serve/clf", {},
                                         {})
            assert status == 201, body
            assert body["kind"] == "predict"
        rng = np.random.default_rng(4)
        for n, bucket in ((1, 1), (3, 4), (5, 8)):
            rows = _rows(rng, n)
            status, body = _call(api, "POST", "/serve/clf/predict",
                                 {"x": rows})
            assert status == 200, body
            assert body["bucket"] == bucket
            padded = np.asarray(rows + [rows[0]] * (bucket - n))
            np.testing.assert_array_equal(
                np.asarray(body["predictions"], np.float32),
                clf.predict(padded, batch_size=bucket)[:n])
            np.testing.assert_allclose(body["predictions"],
                                       clf.predict(np.asarray(rows)),
                                       atol=1e-6, rtol=0)
            status, want, _ = jax_api.dispatch(
                "POST", PREFIX + "/serve/clf/predict", {}, {"x": rows})
            assert status == 200 and want["bucket"] == bucket
            np.testing.assert_allclose(body["predictions"],
                                       want["predictions"], atol=2e-5,
                                       rtol=0)

        sizes = (1, 2, 3)
        by_req = [_rows(rng, n) for n in sizes]
        got = [None] * len(sizes)

        def client(i):
            got[i] = _call(api, "POST", "/serve/clf/predict",
                           {"x": by_req[i]})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(sizes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for i, n in enumerate(sizes):
            assert got[i][0] == 200, got[i]
            assert len(got[i][1]["predictions"]) == n
            np.testing.assert_allclose(got[i][1]["predictions"],
                                       clf.predict(np.asarray(by_req[i])),
                                       atol=1e-6, rtol=0)

        for body in ({"x": [[1, 2], [1, 2, 3]]}, {"x": []}, {"x": 5},
                     {}):
            want = jax_api.dispatch("POST", PREFIX + "/serve/clf/predict",
                                    {}, body)
            got_one = _call(api, "POST", "/serve/clf/predict", body)
            assert got_one[0] == want[0] == 406, (body, got_one, want)
            if "rows do not stack" not in want[1]["result"]:
                assert got_one[1] == want[1]
        stats = _call(api, "GET", "/serve/clf")[1]
        assert stats["buckets"] == [1, 2, 4, 8, 16, 32, 64]
        assert stats["rowsTotal"] == 1 + 3 + 5 + sum(sizes)
        assert stats["perf"]["rowsPerSec"] > 0
        assert 0 < stats["perf"]["goodputFrac"] <= 1
    finally:
        api.ctx.close()


def test_bucket_session_answers_as_jax(tmp_path, jax_api):
    """Create answers of predict sessions equal JAX's: a classifier is a
    predict session by default and refuses ``type: "lm"``; an unknown
    type is 406; a failed predict is 503."""
    api, _ = _clf_pair(tmp_path, jax_api)
    try:
        for body in ({"type": "lm"}, {"type": "batch"},
                     {"type": "predict", "sliceDevices": 0}):
            want = jax_api.dispatch("POST", PREFIX + "/serve/clf", {}, body)
            got = _call(api, "POST", "/serve/clf", body)
            if body.get("sliceDevices") is not None:
                assert got[0] == 406 and "not yet ported" in got[1]["result"]
                continue
            assert got == want[:2], body
        assert _call(api, "POST", "/serve/clf", {"type": "predict"})[0] == 201
        # ids past the vocabulary: the classifier's predict raises
        status, body = _call(api, "POST", "/serve/clf/predict",
                             {"x": [[500] * 4]})
        assert status == 503 and body["result"].startswith("predict failed")
    finally:
        api.ctx.close()


# ----------------------------------------------------------------------
# configuration, lock rank and launch counters
# ----------------------------------------------------------------------
@pytest.mark.parametrize("field, env, value", [
    ("serve_buckets", "LO_SERVE_BUCKETS", "1,3,9"),
    ("serve_max_wait_ms", "LO_SERVE_MAX_WAIT_MS", "7.5"),
    ("serve_disagg", "LO_SERVE_DISAGG", "1"),
    ("serve_draft", "LO_SERVE_DRAFT", "small_lm"),
    ("serve_spec_k", "LO_SERVE_SPEC_K", "6")])
def test_serving_plane_config_matches_jax(monkeypatch, field, env, value):
    """The five new fields read the JAX package's variables with its
    defaults."""
    monkeypatch.delenv(env, raising=False)
    assert getattr(Config(home="unused"), field) == \
        getattr(jax_config.Config(), field)
    monkeypatch.setenv(env, value)
    assert getattr(Config(home="unused"), field) == \
        getattr(jax_config.Config(), field)


def test_handoff_lock_rank_matches_jax():
    from learningorchestra_tpu.runtime import locks as jax_locks
    from learningorchestra_tpu_torch.runtime import locks

    for name in ("serving.session", "serving.handoff", "serving.prefix",
                 "serving.kvpool"):
        assert locks.HIERARCHY[name] == jax_locks.HIERARCHY[name]
    assert locks.HIERARCHY["serving.session"] < \
        locks.HIERARCHY["serving.handoff"] < locks.HIERARCHY["serving.kvpool"]


def test_launch_counters_stay_exact_across_threads():
    """A disaggregated session launches from its prefill and decode
    threads; the counters chip_smoke.py holds exact must not lose an
    addition."""
    before = ops.FLASH_FWD_TF32X3_LAUNCHES
    n_threads, each = (os.cpu_count() or 1) + 2, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            ops._count_launch("FLASH_FWD_TF32X3_LAUNCHES")
            for _ in range(each)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert ops.FLASH_FWD_TF32X3_LAUNCHES == before + n_threads * each
    finally:
        sys.setswitchinterval(interval)
        ops.FLASH_FWD_TF32X3_LAUNCHES = before
