"""The hand-written CUDA kernels against their plain versions on the
card. Needs no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from learningorchestra_tpu_torch.ops import attention as attn


# each wrapper's launch counter, by pass: the forward, dQ and dK/dV each
# have a wgmma (sm90) and a split-TF32 (tf32x3) kernel
FWD = ("FLASH_FWD_SM90_LAUNCHES", "FLASH_FWD_TF32X3_LAUNCHES")
DQ = ("FLASH_BWD_DQ_SM90_LAUNCHES", "FLASH_BWD_DQ_TF32X3_LAUNCHES")
DKV = ("FLASH_BWD_DKV_SM90_LAUNCHES", "FLASH_BWD_DKV_TF32X3_LAUNCHES")


def _launched(counters) -> int:
    """Launches of one pass's kernels, on either route."""
    return sum(getattr(attn, c) for c in counters)


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
        before = _launched(FWD)
        if h == kvh:
            o, lse = attn.flash_attention_with_lse(
                q, k, v, causal=causal, window=window, kv_offset=offset)
        else:
            o = attn.flash_attention(q, k, v, causal=causal, window=window)
            lse = None
        torch.cuda.synchronize()
        assert _launched(FWD) == before + 1
        ro, rlse = attn.flash_attention_reference(
            q, k, v, causal=causal, window=window,
            kv_offset=offset if lse is not None else 0)
        torch.testing.assert_close(o.float(), ro.float(), atol=atol,
                                   rtol=rtol)
        if lse is not None:
            torch.testing.assert_close(lse, rlse, atol=2e-5, rtol=2e-5)


# (b, sq, sk, h, kvh, d, causal, window, kv_offset, dlse): the forward's
# edge cases — GQA with a window, non-causal ragged sk, MQA at d 128, and
# a kv_offset that leaves rows with no visible key under a dlse term
_BWD_CASES = [(1, 200, 200, 8, 4, 64, True, 64, 0, False),
              (2, 40, 56, 4, 2, 16, False, 0, 0, False),
              (1, 130, 130, 4, 1, 128, True, 0, 0, False),
              (2, 48, 48, 2, 2, 32, True, 8, 30, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel_atol,rtol", [
    (torch.float32, 1e-4, 1e-4), (torch.bfloat16, 1e-3, 1e-2)])
def test_backward_kernels_match_plain_version_on_card(dtype, rel_atol,
                                                      rtol):
    """The backward kernels of the input's route (_flash_bwd) against
    flash_bwd_reference on the same inputs. Both compute in float32 from
    the same q/k/v/dO values and the forward kernel's (o, lse); they
    differ in summation order only, so the tolerance scales with the
    case's largest gradient (atol rel_atol * max |g|) plus rtol. bf16 is
    held to the bound a bf16 gradient would carry (rtol 1e-2, about one
    bf16 ulp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(7)
    for b, sq, sk, h, kvh, d, causal, window, offset, with_dlse in \
            _BWD_CASES:
        q, k, v = (torch.from_numpy(a).cuda().to(dtype)
                   for a in _qkv(8, b, sq, sk, h, kvh, d))
        do = torch.from_numpy(rng.standard_normal(
            (b, sq, h, d), dtype=np.float32)).cuda().to(dtype)
        dlse = torch.from_numpy(rng.standard_normal(
            (b, sq, h), dtype=np.float32)).cuda() if with_dlse else None
        scale = 1.0 / d ** 0.5
        o, lse = attn._flash_fwd(q, k, v, causal, scale, window, offset)
        before = (_launched(DQ), _launched(DKV))
        dq, dk, dv = attn._flash_bwd(q, k, v, o, lse, do, dlse, causal,
                                     scale, window, offset)
        torch.cuda.synchronize()
        assert (_launched(DQ), _launched(DKV)) == (before[0] + 1,
                                                   before[1] + 1)
        want = attn.flash_bwd_reference(q, k, v, o, lse, do, dlse,
                                        causal=causal, scale=scale,
                                        window=window, kv_offset=offset)
        for got, ref in zip((dq, dk, dv), want):
            assert bool(torch.isfinite(got).all())
            torch.testing.assert_close(
                got, ref, rtol=rtol,
                atol=rel_atol * ref.abs().max().item())
        if offset:
            empty = lse == attn.NEG_INF
            assert bool(empty.any())
            assert bool((dq[empty] == 0).all())


@pytest.mark.cuda
def test_flash_attention_gradients_on_card():
    """Autograd through flash_attention on a CUDA tensor runs both
    backward kernels and gives the plain path's gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q, k, v = (torch.from_numpy(a).cuda().requires_grad_()
               for a in _qkv(9, 2, 96, 96, 4, 2, 32))
    go = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 96, 4, 32), dtype=np.float32)).cuda()
    before = _launched(DKV)
    o = attn.flash_attention(q, k, v, causal=True, window=40)
    got = torch.autograd.grad((o * go).sum(), (q, k, v))
    assert _launched(DKV) == before + 1
    ro, _ = attn.flash_attention_reference(q, k, v, causal=True, window=40)
    want = torch.autograd.grad((ro * go).sum(), (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_fit_on_card_runs_the_kernels(monkeypatch):
    """A small bf16 fit on the card: every layer of every micro-batch
    runs the three kernels, and the loss is finite and falls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel

    monkeypatch.setenv("LO_COMPUTE_DTYPE", "bfloat16")
    start = np.random.default_rng(11).integers(1, 64, size=16)
    x = ((start[:, None] + np.arange(128)[None, :]) % 63 + 1) \
        .astype(np.int32)
    lm = LanguageModel(vocab_size=64, d_model=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, max_len=128, sliding_window=32,
                       device="cuda")
    lm.compile({"kind": "adamw", "learning_rate": 1e-2})
    before = [_launched(c) for c in (FWD, DQ, DKV)]
    loss = lm.fit(x, batch_size=8, epochs=3, shuffle=False,
                  grad_accum=2).history["loss"]
    # 2 layers x 3 epochs x 2 steps x 2 micro-batches
    assert [_launched(c) - b for c, b in zip((FWD, DQ, DKV), before)] == \
        [24, 24, 24]
    assert np.isfinite(loss).all() and loss[-1] < loss[0]


# (b, sq, sk, h, kvh, d, causal, window, kv_offset, dlse) in bf16 on the
# tensor-core route: non-causal, MQA, ragged sk at d 32, a kv_offset that
# leaves rows with no visible key at d 128, and head dims that do not
# fill the kernels' 64-column boxes (8, 72)
_SM90_CASES = [(2, 96, 96, 4, 2, 64, False, 0, 0, False),
               (2, 130, 130, 8, 1, 64, True, 0, 0, False),
               (2, 77, 201, 4, 2, 32, False, 0, 0, False),
               (2, 64, 64, 4, 4, 128, True, 16, 40, True),
               (1, 150, 150, 4, 2, 8, True, 32, 0, False),
               (1, 150, 150, 4, 4, 72, True, 0, 0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _SM90_CASES)
def test_tensor_core_route_on_card(case):
    """bf16 through the tensor-core kernels (flash_fwd_sm90,
    flash_bwd_dq_sm90, flash_bwd_dkv_sm90) against the plain versions.
    They split P and dS into bf16 hi + lo (about 2^-16 of each), so o
    meets the bf16 tolerance of a float32 o rounded to bf16 (one ulp plus
    float32 order) and dQ, dK and dV the float32 summation-order
    tolerance (1e-4 max |g| + 1e-4). Rows with no visible key get dQ 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    b, sq, sk, h, kvh, d, causal, window, offset, with_dlse = case
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
               for a in _qkv(13, b, sq, sk, h, kvh, d))
    do = torch.from_numpy(rng.standard_normal(
        (b, sq, h, d), dtype=np.float32)).cuda().to(torch.bfloat16)
    dlse = torch.from_numpy(rng.standard_normal(
        (b, sq, h), dtype=np.float32)).cuda() if with_dlse else None
    assert attn._tensor_core_route(q)
    scale = 1.0 / d ** 0.5
    counters = ("FLASH_FWD_SM90_LAUNCHES", "FLASH_BWD_DQ_SM90_LAUNCHES",
                "FLASH_BWD_DKV_SM90_LAUNCHES")
    before = [getattr(attn, c) for c in counters]
    o, lse = attn._flash_fwd(q, k, v, causal, scale, window, offset)
    delta = attn._bwd_delta(o, do, dlse)
    dq = attn._flash_bwd_dq_sm90(q, k, v, do, lse, delta, causal, scale,
                                 window, offset)
    dk, dv = attn._flash_bwd_dkv_sm90(q, k, v, do, lse, delta, causal,
                                      scale, window, offset)
    torch.cuda.synchronize()
    assert [getattr(attn, c) - n for c, n in zip(counters, before)] \
        == [1, 1, 1]
    ro, rlse = attn.flash_attention_reference(
        q, k, v, causal=causal, scale=scale, window=window, kv_offset=offset)
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-4, rtol=1e-2)
    seen = rlse != attn.NEG_INF
    assert torch.equal(seen, lse != attn.NEG_INF)
    torch.testing.assert_close(lse[seen], rlse[seen], atol=2e-5, rtol=2e-5)
    if offset:
        assert bool((~seen).any()) and bool((o[~seen] == 0).all())
    want = attn.flash_bwd_reference(q, k, v, o, lse, do, dlse,
                                    causal=causal, scale=scale,
                                    window=window, kv_offset=offset)
    for got, ref in zip((dq, dk, dv), want):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-4 * ref.abs().max().item())
    if offset:
        assert bool((dq[~seen] == 0).all())


@pytest.mark.cuda
def test_float32_and_odd_head_dims_take_the_split_tf32_route_on_card():
    """float32 (and a head_dim off the multiple of 8) never reaches the
    wgmma kernels: float32 at d 64 and d 12 and bf16 at d 20 take the
    split-TF32 forward (flash_fwd_tf32x3) and backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    counters = ("FLASH_FWD_SM90_LAUNCHES", "FLASH_BWD_DQ_SM90_LAUNCHES",
                "FLASH_BWD_DKV_SM90_LAUNCHES", "FLASH_FWD_TF32X3_LAUNCHES",
                "FLASH_BWD_DQ_TF32X3_LAUNCHES",
                "FLASH_BWD_DKV_TF32X3_LAUNCHES")
    before = [getattr(attn, c) for c in counters]
    for dtype, d in ((torch.float32, 64), (torch.float32, 12),
                     (torch.bfloat16, 20)):
        q, k, v = (torch.from_numpy(a).cuda().to(dtype).requires_grad_()
                   for a in _qkv(14, 1, 80, 80, 4, 2, d))
        o = attn.flash_attention(q, k, v, causal=True)
        torch.autograd.grad(o.float().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert [getattr(attn, c) - n for c, n in zip(counters, before)] == \
        [0, 0, 0, 3, 3, 3]


# (b, sq, sk, h, kvh, d, causal, window, kv_offset, dlse) on the
# split-TF32 route: chip_smoke's training shape and edge cases —
# non-causal ragged sk at d 32, MQA, a kv_offset that leaves rows with no
# visible key under a dlse term at d 128, a head_dim of 72 — and head
# dims off the multiple of 8: the d-12 LM's shape at 2 x 256 tokens, an
# odd d 13 (a bf16 row of odd length) with ragged sq and sk under a dlse
# term and every head its own kv head (an o pair stored past column d
# would land in the next head's row), d 36 (a multiple of 4, between
# widths) with GQA, causal and a window
_TF32X3_CASES = [(8, 2048, 2048, 8, 4, 64, True, 1024, 0, False),
                 (2, 77, 201, 4, 2, 32, False, 0, 0, False),
                 (2, 130, 130, 8, 1, 64, True, 0, 0, False),
                 (2, 64, 64, 4, 4, 128, True, 16, 40, True),
                 (1, 150, 150, 4, 4, 72, True, 0, 0, False),
                 (2, 256, 256, 8, 4, 12, True, 1024, 0, False),
                 (2, 75, 131, 4, 4, 13, False, 0, 0, True),
                 (2, 160, 160, 8, 2, 36, True, 48, 0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _TF32X3_CASES)
def test_tf32x3_backward_on_card(case, dtype):
    """flash_bwd_dq_tf32x3 and flash_bwd_dkv_tf32x3 against the float32
    plain version and against the plain version that splits every
    product 3xTF32 as the kernels do, each at the float32 tolerance (1e-4
    max |g| + 1e-4 |g|): the split departs by about 2^-22 of sum |x||y|,
    and bf16 inputs are exact in TF32 (their lo terms are 0), so bf16 is
    held to the same. Rows with no visible key get dQ 0; the same inputs
    give the same bits twice (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    b, sq, sk, h, kvh, d, causal, window, offset, with_dlse = case
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(a).cuda().to(dtype)
               for a in _qkv(16, b, sq, sk, h, kvh, d))
    do = torch.from_numpy(rng.standard_normal(
        (b, sq, h, d), dtype=np.float32)).cuda().to(dtype)
    dlse = torch.from_numpy(rng.standard_normal(
        (b, sq, h), dtype=np.float32)).cuda() if with_dlse else None
    # bf16 at a multiple of 8 routes to the wgmma kernels; the split-TF32
    # ones still take it when called
    assert attn._route(q) == (
        "sm90" if dtype == torch.bfloat16 and d % 8 == 0 else "tf32x3")
    scale = 1.0 / d ** 0.5
    o, lse = attn._flash_fwd(q, k, v, causal, scale, window, offset)
    delta = attn._bwd_delta(o, do, dlse)
    args = (q, k, v, do, lse, delta, causal, scale, window, offset)
    counters = ("FLASH_BWD_DQ_TF32X3_LAUNCHES",
                "FLASH_BWD_DKV_TF32X3_LAUNCHES")
    before = [getattr(attn, c) for c in counters]
    dq = attn._flash_bwd_dq_tf32x3(*args)
    dk, dv = attn._flash_bwd_dkv_tf32x3(*args)
    torch.cuda.synchronize()
    assert [getattr(attn, c) - n for c, n in zip(counters, before)] == [1, 1]
    for split in (False, True):
        want = attn.flash_bwd_reference(q, k, v, o, lse, do, dlse,
                                        causal=causal, scale=scale,
                                        window=window, kv_offset=offset,
                                        tf32x3=split)
        for got, ref in zip((dq, dk, dv), want):
            assert bool(torch.isfinite(got).all())
            torch.testing.assert_close(got, ref, rtol=1e-4,
                                       atol=1e-4 * ref.abs().max().item())
        del want
    if offset:
        empty = lse == attn.NEG_INF
        assert bool(empty.any()) and bool((dq[empty] == 0).all())
    again = (attn._flash_bwd_dq_tf32x3(*args),
             *attn._flash_bwd_dkv_tf32x3(*args))
    assert all(torch.equal(a, g) for a, g in zip(again, (dq, dk, dv)))


def _held_forward(o, lse, q, k, v, causal, scale, window, offset):
    """o and lse of the split-TF32 forward against the float32 plain
    version and against the plain version that splits both products
    3xTF32 as the kernel does. float32 o at atol 2e-5 + rtol 2e-5 (the
    split departs by about 2^-22 of sum |x||y|); bf16 o, rounded once
    from float32 by kernel and plain version alike, within one bf16 ulp
    (atol 1e-4 + rtol 1e-2); lse on rows that see a key at atol 2e-5 +
    rtol 2e-5. Rows with no visible key get exactly o = 0 and lse =
    NEG_INF."""
    tol = dict(atol=2e-5, rtol=2e-5) if q.dtype == torch.float32 \
        else dict(atol=1e-4, rtol=1e-2)
    for split in (False, True):
        ro, rlse = attn.flash_attention_reference(
            q, k, v, causal=causal, scale=scale, window=window,
            kv_offset=offset, tf32x3=split)
        seen = rlse != attn.NEG_INF
        assert o.dtype == q.dtype and torch.equal(seen, lse != attn.NEG_INF)
        torch.testing.assert_close(o.float(), ro.float(), **tol)
        torch.testing.assert_close(lse[seen], rlse[seen], atol=2e-5,
                                   rtol=2e-5)
        del ro, rlse
    assert bool((o[~seen] == 0).all())
    assert bool((lse[~seen] == attn.NEG_INF).all())
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _TF32X3_CASES)
def test_tf32x3_forward_on_card(case, dtype):
    """flash_fwd_tf32x3 against the plain versions (_held_forward), in
    float32 and in bf16, at every head_dim of the cases (bf16 at a
    multiple of 8 routes to the wgmma kernel; the split-TF32 one still
    takes it when called). The same inputs give the same bits twice (no
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    b, sq, sk, h, kvh, d, causal, window, offset, _ = case
    q, k, v = (torch.from_numpy(a).cuda().to(dtype)
               for a in _qkv(17, b, sq, sk, h, kvh, d))
    assert attn._route(q) == (
        "sm90" if dtype == torch.bfloat16 and d % 8 == 0 else "tf32x3")
    scale = 1.0 / d ** 0.5
    args = (q, k, v, causal, scale, window, offset)
    before = attn.FLASH_FWD_TF32X3_LAUNCHES
    o, lse = attn._flash_fwd_tf32x3(*args)
    torch.cuda.synchronize()
    assert attn.FLASH_FWD_TF32X3_LAUNCHES == before + 1
    seen = _held_forward(o, lse, *args)
    if offset:
        assert bool((~seen).any())
    again = attn._flash_fwd_tf32x3(*args)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 12),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 13),
                                     (torch.bfloat16, 36)])
def test_tf32x3_forward_at_a_misaligned_base_on_card(dtype, d):
    """q, k and v sliced one element into their storage: contiguous, so
    the wrapper takes them, but 4 (float32) or 2 (bf16) bytes off the
    16-byte boundary, so the kernel loads them in a narrower granule
    (or element by element) and still meets _held_forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    b, sq, sk, h, kvh = 2, 150, 150, 4, 2

    def shifted(a):
        flat = torch.zeros(a.size + 1, dtype=dtype, device="cuda")
        flat[1:] = torch.from_numpy(a).cuda().reshape(-1).to(dtype)
        return flat[1:].view(a.shape)

    q, k, v = (shifted(a) for a in _qkv(18, b, sq, sk, h, kvh, d))
    assert q.is_contiguous() and q.data_ptr() % 16
    scale = 1.0 / d ** 0.5
    args = (q, k, v, True, scale, 64, 0)
    o, lse = attn._flash_fwd_tf32x3(*args)
    torch.cuda.synchronize()
    _held_forward(o, lse, *args)
