"""The PyTorch port's attention ops against the JAX package's.

The same numpy inputs go through the JAX flash kernel (Pallas, in
interpret mode on the CPU, as tests/test_ops.py runs it) and through the
port's ops, which on CPU tensors run the kernel's plain version.
Tolerance: atol/rtol 2e-5 in float32, as tests/test_ops.py uses for the
kernel against its oracle (the two sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.ops import attention as jax_attn
from learningorchestra_tpu_torch.ops import attention as attn

# tiny shapes: two intra-op threads are as fast as all cores and leave
# the rest to the other test workers
torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, b, sq, sk, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, kvh, d), dtype=np.float32),
            rng.standard_normal((b, sk, kvh, d), dtype=np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("b,sq,sk,h,kvh,causal,window", [
    (2, 32, 32, 4, 4, False, 0),     # MHA, full
    (2, 32, 32, 4, 4, True, 0),      # MHA, causal
    (2, 40, 56, 4, 2, False, 0),     # GQA 4/2, ragged
    (1, 48, 48, 4, 2, True, 0),      # GQA causal, uneven tiles
    (1, 48, 48, 4, 1, True, 0),      # MQA 4/1
    (2, 48, 48, 4, 2, True, 16),     # GQA + sliding window
])
def test_flash_matches_jax(b, sq, sk, h, kvh, causal, window):
    q, k, v = _qkv(0, b, sq, sk, h, kvh, 16)
    want = jax_attn.flash_attention(*_j(q, k, v), causal=causal,
                                    window=window, block_q=16, block_k=16)
    got = attn.flash_attention(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window,kv_offset", [
    (False, 0, 0),
    (True, 0, 0),
    (True, 8, 0),
    (True, 4, 20),    # the window passes rows before the keys: lse -1e30
])
def test_flash_with_lse_matches_jax(causal, window, kv_offset):
    q, k, v = _qkv(1, 2, 32, 32, 2, 2, 16)
    want_o, want_lse = jax_attn.flash_attention_with_lse(
        *_j(q, k, v), causal=causal, window=window, kv_offset=kv_offset,
        block_q=16, block_k=16)
    got_o, got_lse = attn.flash_attention_with_lse(
        *_t(q, k, v), causal=causal, window=window, kv_offset=kv_offset)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               **TOL)
    if kv_offset:
        empty = got_lse.numpy() == attn.NEG_INF
        assert empty.any(), "the case must hold rows with no visible key"
        np.testing.assert_array_equal(empty,
                                      np.asarray(want_lse) == attn.NEG_INF)
        assert np.all(got_o.numpy()[empty] == 0.0)


def test_flash_matches_dense_reference():
    q, k, v = _qkv(2, 2, 40, 40, 4, 4, 16)
    got = attn.flash_attention(*_t(q, k, v), causal=True, window=8)
    want = attn.full_attention_reference(*_t(q, k, v), causal=True,
                                         window=8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("window,padded", [(0, False), (6, True)])
def test_decode_attention_matches_jax(window, padded):
    rng = np.random.default_rng(3)
    b, length, h, kvh, d = 3, 24, 4, 2, 16
    q = rng.standard_normal((b, 1, h, d), dtype=np.float32)
    kc = rng.standard_normal((b, length, kvh, d), dtype=np.float32)
    vc = rng.standard_normal((b, length, kvh, d), dtype=np.float32)
    col = np.array([3, 17, 23], np.int32)
    pad = np.array([0, 2, 5], np.int32) if padded else None
    want = jax_attn.decode_attention(
        *_j(q, kc, vc, col), window=window,
        pad_offset=None if pad is None else jnp.asarray(pad))
    got = attn.decode_attention(
        *_t(q, kc, vc), torch.from_numpy(col).long(), window=window,
        pad_offset=None if pad is None else torch.from_numpy(pad).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_never_launch_the_kernel():
    before = attn.FLASH_FWD_LAUNCHES
    q, k, v = _qkv(4, 1, 16, 16, 2, 1, 8)
    attn.flash_attention(*_t(q, k, v), causal=True)
    attn.flash_attention_with_lse(*_t(q, q, q), causal=True)
    assert attn.FLASH_FWD_LAUNCHES == before


def test_flash_rejects_bad_arguments():
    q, k, v = _t(*_qkv(5, 1, 8, 8, 3, 2, 8))
    with pytest.raises(ValueError, match="divide"):
        attn.flash_attention(q, k, v)
    q, k, v = _t(*_qkv(5, 1, 8, 8, 2, 2, 8))
    with pytest.raises(ValueError, match="causal"):
        attn.flash_attention(q, k, v, window=4)
    with pytest.raises(ValueError, match=">= 0"):
        attn.flash_attention(q, k, v, causal=True, window=-1)
    kq = _t(*_qkv(5, 1, 8, 8, 2, 1, 8))
    with pytest.raises(ValueError, match="equal head counts"):
        attn.flash_attention_with_lse(*kq)
