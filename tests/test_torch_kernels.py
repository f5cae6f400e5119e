"""The hand-written CUDA kernels against their plain versions on the
card. Needs no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from learningorchestra_tpu_torch.ops import attention as attn


def _qkv(seed, b, sq, sk, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, kvh, d), dtype=np.float32),
            rng.standard_normal((b, sk, kvh, d), dtype=np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-4, 1e-2)])
def test_kernel_matches_plain_version_on_card(dtype, atol, rtol):
    """The hand-written kernel against its plain version on the card.
    bf16: both compute in float32 and round o once, so they differ by at
    most one bf16 ulp of |o| (<= 2**-7 |o|, under rtol) plus the float32
    summation-order error (under atol)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cases = [(1, 200, 200, 8, 4, 64, True, 64, 0),
             (2, 40, 56, 4, 2, 16, False, 0, 0),
             (1, 64, 64, 4, 1, 128, True, 0, 0),
             (2, 48, 48, 2, 2, 32, True, 8, 30)]
    for b, sq, sk, h, kvh, d, causal, window, offset in cases:
        q, k, v = (torch.from_numpy(a).cuda().to(dtype)
                   for a in _qkv(6, b, sq, sk, h, kvh, d))
        before = attn.FLASH_FWD_LAUNCHES
        if h == kvh:
            o, lse = attn.flash_attention_with_lse(
                q, k, v, causal=causal, window=window, kv_offset=offset)
        else:
            o = attn.flash_attention(q, k, v, causal=causal, window=window)
            lse = None
        torch.cuda.synchronize()
        assert attn.FLASH_FWD_LAUNCHES == before + 1
        ro, rlse = attn.flash_attention_reference(
            q, k, v, causal=causal, window=window,
            kv_offset=offset if lse is not None else 0)
        torch.testing.assert_close(o.float(), ro.float(), atol=atol,
                                   rtol=rtol)
        if lse is not None:
            torch.testing.assert_close(lse, rlse, atol=2e-5, rtol=2e-5)
