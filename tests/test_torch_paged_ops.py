"""The PyTorch port's paged and quantized KV ops and quantized serving
weights, against the JAX package's.

Case for case the paged tests of ``tests/test_ops.py``: the same inputs,
made with numpy from a seed, go through the port's op and the JAX op.
Within the port, the paged decode must equal the slot ``decode_attention``
bit for bit (the gather feeds the same reduction); against JAX every op
holds at atol 2e-6 in float32 (two frameworks summing in their own
order). The int8 KV values and scales and the int8/fp8 serving weights
must equal JAX's exactly: both divide by the scale and round half to
even (fp8 through ml_dtypes on the JAX side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.models import transformer as jax_tlm
from learningorchestra_tpu.ops import attention as jax_ops
from learningorchestra_tpu_torch.models import transformer as tlm
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.ops import attention as ops

torch.set_num_threads(2)

ATOL = 2e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _long(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _paged_view(k_cache, v_cache, page_len, seed, extra_pages=3):
    """A contiguous (b, L, kv, d) cache scattered over shuffled pages of a
    pool whose other rows (the trash page 0 too) are large garbage."""
    rng = np.random.default_rng(seed)
    b, length, kv, d = k_cache.shape
    n_per = length // page_len
    total = b * n_per + extra_pages + 1
    ids = rng.permutation(total - 1)[:b * n_per] + 1
    bt = ids.reshape(b, n_per).astype(np.int32)
    k_pool = (rng.normal(size=(total, page_len, kv, d)) * 1e3).astype(
        np.float32)
    v_pool = (rng.normal(size=(total, page_len, kv, d)) * 1e3).astype(
        np.float32)
    for i in range(b):
        for p in range(n_per):
            rows = slice(p * page_len, (p + 1) * page_len)
            k_pool[bt[i, p]] = k_cache[i, rows]
            v_pool[bt[i, p]] = v_cache[i, rows]
    return k_pool, v_pool, bt


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("with_pad", [False, True])
def test_paged_decode_bit_parity(window, with_pad):
    b, length, page_len, h, kv, d = 5, 32, 8, 4, 2, 16
    for trial in range(4):
        rng = np.random.default_rng(200 + trial)
        q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
        k_cache = rng.normal(size=(b, length, kv, d)).astype(np.float32)
        v_cache = rng.normal(size=(b, length, kv, d)).astype(np.float32)
        col = rng.integers(0, length, size=(b,)).astype(np.int32)
        pad = (rng.integers(0, 3, size=(b,)).astype(np.int32)
               if with_pad else None)
        k_pool, v_pool, bt = _paged_view(k_cache, v_cache, page_len,
                                         seed=300 + trial)
        ref = ops.decode_attention(
            _t(q), _t(k_cache), _t(v_cache), _long(col),
            pad_offset=None if pad is None else _long(pad), window=window)
        got = ops.paged_decode_attention(
            _t(q), _t(k_pool), _t(v_pool), _long(bt), _long(col),
            pad_offset=None if pad is None else _long(pad), window=window)
        assert torch.equal(ref, got), f"trial {trial}: diverged bitwise"
        want = jax_ops.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
            jnp.asarray(bt), jnp.asarray(col),
            pad_offset=None if pad is None else jnp.asarray(pad),
            window=window)
        _close(got, want)


def test_paged_decode_max_pages_clamp_is_bit_exact():
    b, length, page_len, h, kv, d = 4, 32, 8, 4, 2, 16
    rng = np.random.default_rng(42)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k_cache = rng.normal(size=(b, length, kv, d)).astype(np.float32)
    v_cache = rng.normal(size=(b, length, kv, d)).astype(np.float32)
    col = np.asarray([3, 9, 15, 7], np.int32)
    k_pool, v_pool, bt = _paged_view(k_cache, v_cache, page_len, seed=7)
    args = (_t(q), _t(k_pool), _t(v_pool), _long(bt), _long(col))
    ref = ops.decode_attention(_t(q), _t(k_cache), _t(v_cache), _long(col))
    full = ops.paged_decode_attention(*args)
    clamped = ops.paged_decode_attention(*args, max_pages=2)
    assert torch.equal(ref, full)
    assert torch.equal(full, clamped)
    sliced = ops.paged_decode_attention(_t(q), _t(k_pool), _t(v_pool),
                                        _long(bt[:, :2]), _long(col))
    assert torch.equal(clamped, sliced)
    want = jax_ops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(bt), jnp.asarray(col), max_pages=2)
    _close(clamped, want)


def test_paged_append_token_matches_slot_scatter():
    b, length, page_len, kv, d = 3, 16, 4, 2, 8
    rng = np.random.default_rng(11)
    cache = rng.normal(size=(b, length, kv, d)).astype(np.float32)
    new = rng.normal(size=(b, kv, d)).astype(np.float32)
    pos = np.asarray([0, 7, 15], np.int32)
    k_pool, _, bt = _paged_view(cache, cache, page_len, seed=12)
    slot = _t(cache).clone()
    slot[torch.arange(b), _long(pos)] = _t(new)
    pool = ops.paged_append_token(_t(k_pool).clone(), _t(new), _long(bt),
                                  _long(pos), page_len)
    gathered = pool[_long(bt)].reshape(b, length, kv, d)
    assert torch.equal(slot, gathered)
    want = jax_ops.paged_append_token(
        jnp.asarray(k_pool), jnp.asarray(new), jnp.asarray(bt),
        jnp.asarray(pos), page_len)
    assert np.array_equal(pool.numpy(), np.asarray(want))


def test_paged_prefill_write_roundtrip_and_prefix_skip():
    page_len, kv, d, n_pages = 4, 2, 8, 5
    rng = np.random.default_rng(21)
    pool = rng.normal(size=(12, page_len, kv, d)).astype(np.float32)
    rows = rng.normal(size=(n_pages * page_len, kv, d)).astype(np.float32)
    ids = np.asarray([3, 7, 1, 9, 5], np.int32)
    out = ops.paged_prefill_write(_t(pool).clone(), _t(rows), _long(ids), 0)
    assert torch.equal(out[_long(ids)].reshape(-1, kv, d), _t(rows))
    out2 = ops.paged_prefill_write(_t(pool).clone(), _t(rows),
                                   _long(ids[2:]), 2 * page_len)
    assert torch.equal(out2[_long(ids[2:])].reshape(-1, kv, d),
                       _t(rows[2 * page_len:]))
    for skipped in ids[:2]:
        assert torch.equal(out2[int(skipped)], _t(pool[skipped]))
    want = jax_ops.paged_prefill_write(
        jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(ids[2:]),
        2 * page_len)
    assert np.array_equal(out2.numpy(), np.asarray(want))


def test_checked_pool_cast_guards_raw_writes_into_int8_pool():
    b, length, page_len, kv, d = 3, 16, 4, 2, 8
    rng = np.random.default_rng(31)
    cache = rng.normal(size=(b, length, kv, d)).astype(np.float32)
    new = rng.normal(size=(b, kv, d)).astype(np.float32)
    pos = np.asarray([1, 5, 9], np.int32)
    k_pool, _, bt = _paged_view(cache, cache, page_len, seed=32)
    int8_pool = torch.zeros(k_pool.shape, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        ops.paged_append_token(int8_pool, _t(new), _long(bt), _long(pos),
                               page_len)
    rows = rng.normal(size=(2 * page_len, kv, d)).astype(np.float32)
    with pytest.raises(TypeError, match="int8"):
        ops.paged_prefill_write(int8_pool, _t(rows), _long([1, 2]), 0)
    # integer values into an integer pool still pass
    ops.paged_prefill_write(int8_pool, torch.zeros(rows.shape,
                                                   dtype=torch.int8),
                            _long([1, 2]), 0)


def test_quantize_kv_pages_matches_jax_and_roundtrip_is_bounded():
    rng = np.random.default_rng(41)
    pages = rng.normal(size=(6, 8, 2, 16)).astype(np.float32) * 3.0
    pages[4] = 0.0  # a fresh page must stay exactly zero
    # values at half a step of their page's scale: ties round to even
    pages[5, 0, 0, :4] = np.float32(2.5) * (np.abs(pages[5]).max(
        axis=(0, 2))[0] / np.float32(127.0))
    q, scales = ops.quantize_kv_pages(_t(pages))
    assert q.dtype == torch.int8 and scales.shape == (6, 2)
    jq, js = jax_ops.quantize_kv_pages(jnp.asarray(pages))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(scales.numpy(), np.asarray(js))
    back = ops.dequantize_kv_pages(q, scales).numpy()
    err = np.abs(back - pages)
    bound = scales.numpy()[:, None, :, None] * 0.5 + 1e-6
    assert np.all(err <= bound), float(err.max())
    assert np.array_equal(back[4], np.zeros_like(back[4]))
    _close(back, jax_ops.dequantize_kv_pages(jq, js))


def test_quantized_paged_decode_matches_exact_within_drift_bound():
    b, length, page_len, h, kv, d = 5, 32, 8, 4, 2, 16
    for trial in range(3):
        rng = np.random.default_rng(400 + trial)
        q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
        k_cache = rng.normal(size=(b, length, kv, d)).astype(np.float32)
        v_cache = rng.normal(size=(b, length, kv, d)).astype(np.float32)
        col = rng.integers(0, length, size=(b,)).astype(np.int32)
        k_pool, v_pool, bt = _paged_view(k_cache, v_cache, page_len,
                                         seed=500 + trial)
        kq, ks = ops.quantize_kv_pages(_t(k_pool))
        vq, vs = ops.quantize_kv_pages(_t(v_pool))
        ref = ops.paged_decode_attention(_t(q), _t(k_pool), _t(v_pool),
                                         _long(bt), _long(col)).numpy()
        got = ops.quantized_paged_decode_attention(
            _t(q), kq, ks, vq, vs, _long(bt), _long(col))
        rel = np.abs(got.numpy() - ref).mean() / (np.abs(ref).mean() + 1e-9)
        assert rel <= 0.05, f"trial {trial}: rel drift {rel}"
        clamped = ops.quantized_paged_decode_attention(
            _t(q), kq, ks, vq, vs, _long(bt), _long(col),
            max_pages=length // page_len)
        assert torch.equal(got, clamped)
        jkq, jks = jax_ops.quantize_kv_pages(jnp.asarray(k_pool))
        jvq, jvs = jax_ops.quantize_kv_pages(jnp.asarray(v_pool))
        want = jax_ops.quantized_paged_decode_attention(
            jnp.asarray(q), jkq, jks, jvq, jvs, jnp.asarray(bt),
            jnp.asarray(col))
        _close(got, want)


def test_quantized_prefill_write_touches_exactly_its_pages():
    page_len, kv, d = 4, 2, 8
    n_pages, total = 5, 12
    rng = np.random.default_rng(51)
    stale = rng.normal(size=(total, page_len, kv, d)).astype(np.float32)
    pool, scales = ops.quantize_kv_pages(_t(stale))
    rows = np.zeros((n_pages * page_len, kv, d), np.float32)
    rows[:18] = rng.normal(size=(18, kv, d)) * 2.0
    ids = np.asarray([3, 7, 1, 9, 5], np.int32)
    out_pool, out_scales = ops.quantized_paged_prefill_write(
        pool.clone(), scales.clone(), _t(rows), _long(ids), 0)
    back = ops.dequantize_kv_pages(out_pool[_long(ids)],
                                   out_scales[_long(ids)]).numpy()
    want = rows.reshape(n_pages, page_len, kv, d)
    amax = np.abs(want).max(axis=(1, 3))
    bound = np.maximum(amax / 127.0, 1e-8)[:, None, :, None] + 1e-6
    assert np.all(np.abs(back - want) <= bound)
    untouched = sorted(set(range(total)) - set(int(i) for i in ids))
    assert torch.equal(out_pool[untouched], pool[untouched])
    assert torch.equal(out_scales[untouched], scales[untouched])
    jpool, jscales = jax_ops.quantize_kv_pages(jnp.asarray(stale))
    jout, jsc = jax_ops.quantized_paged_prefill_write(
        jpool, jscales, jnp.asarray(rows), jnp.asarray(ids), 0)
    assert np.array_equal(out_pool.numpy(), np.asarray(jout))
    assert np.array_equal(out_scales.numpy(), np.asarray(jsc))
    out2, scales2 = ops.quantized_paged_prefill_write(
        pool.clone(), scales.clone(), _t(rows), _long(ids[2:]),
        2 * page_len)
    for skipped in ids[:2]:
        assert torch.equal(out2[int(skipped)], pool[int(skipped)])
        assert torch.equal(scales2[int(skipped)], scales[int(skipped)])


def test_quantized_append_token_requantizes_only_live_rows():
    b, page_len, kv, d = 2, 8, 2, 8
    rng = np.random.default_rng(61)
    live = rng.normal(size=(b, page_len, kv, d)).astype(np.float32)
    stale = live.copy()
    stale[:, 5:] = rng.normal(size=(b, 3, kv, d)) * 8.0
    pool, scales = ops.quantize_kv_pages(_t(stale))
    bt = np.asarray([[1], [2]], np.int32)
    new = rng.normal(size=(b, kv, d)).astype(np.float32)
    pos = np.asarray([5, 5], np.int32)
    full_pool = torch.zeros((4, page_len, kv, d), dtype=torch.int8)
    full_scales = torch.zeros((4, kv), dtype=torch.float32)
    full_pool[_long([1, 2])] = pool
    full_scales[_long([1, 2])] = scales
    jpool = jnp.asarray(full_pool.numpy())
    jscales = jnp.asarray(full_scales.numpy())
    out_pool, out_scales = ops.quantized_paged_append_token(
        full_pool, full_scales, _t(new), _long(bt), _long(pos), page_len)
    back = ops.dequantize_kv_pages(out_pool[_long([1, 2])],
                                   out_scales[_long([1, 2])]).numpy()
    want = live.copy()
    want[:, 5] = new
    want[:, 6:] = 0.0
    assert np.array_equal(back[:, 6:], want[:, 6:])
    step1 = scales.numpy()[:, None, :, None]
    step2 = out_scales.numpy()[[1, 2]][:, None, :, None]
    bound = 0.5 * (step1 + step2) + 1e-6
    assert np.all(np.abs(back - want) <= bound)
    assert np.all(out_scales.numpy()[[1, 2]] < scales.numpy() * 0.5)
    jout, jsc = jax_ops.quantized_paged_append_token(
        jpool, jscales, jnp.asarray(new), jnp.asarray(bt),
        jnp.asarray(pos), page_len)
    assert np.array_equal(out_pool.numpy(), np.asarray(jout))
    assert np.array_equal(out_scales.numpy(), np.asarray(jsc))


CFG = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           max_len=64)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_serving_params_matches_jax_leaf_for_leaf(dtype):
    tree = weights.init_params(CFG, seed=3)
    state = weights.params_from_flax(tree)
    got = tlm.quantize_serving_params(state, dtype)
    want = jax_tlm.quantize_serving_params(
        {k: v for k, v in _jax_tree(tree).items()}, dtype)
    n_quant = 0
    for key, leaf in got.items():
        path, transposed = weights.flax_path(key)
        node = want
        for p in path:
            node = node[p]
        if not isinstance(leaf, dict):
            assert "qvalue" not in node
            assert torch.equal(leaf, state[key])
            continue
        n_quant += 1
        q = leaf["qvalue"]
        q = q.t() if transposed else q
        jq = np.asarray(node["qvalue"])
        if dtype == "int8":
            assert np.array_equal(q.numpy(), jq), key
        else:
            assert np.array_equal(q.view(torch.uint8).numpy(),
                                  jq.view(np.uint8)), key
        assert np.array_equal(leaf["qscale"].reshape(-1).numpy(),
                              np.asarray(node["qscale"])), key
        deq = tlm.dequantize_serving_params({key: leaf})[key]
        jdeq = np.asarray(jax_tlm.dequantize_serving_params(node))
        assert np.array_equal((deq.t() if transposed else deq).numpy(),
                              jdeq), key
    # the embedding, lm_head and 2 layers x 7 projections
    assert n_quant == 2 + CFG["n_layers"] * 7


def test_exact_serving_weights_pass_through_unchanged():
    state = weights.params_from_flax(weights.init_params(CFG, seed=3))
    assert tlm.quantize_serving_params(state, "bf16") is state
    lm = tlm.LanguageModel(**CFG, device="cpu")
    lm.set_params(state)
    assert lm.serving_module("bf16") is lm.module
    with pytest.raises(ValueError, match="int4"):
        tlm.quantize_serving_params(state, "int4")


def _jax_tree(tree):
    import jax

    return jax.tree_util.tree_map(jnp.asarray, tree)
