"""The split-TF32 (3xTF32) tensor-core route of the PyTorch port on the
CPU: the plain split that emulates ``cvt.rna.tf32`` (and leaves a bf16
value whole), the plain forward and backward with every product split
as the kernels split it against the JAX package's Pallas forward and
backward (interpret mode, as tests/test_ops.py runs them; JAX pads the
head_dim to 128, the kernels to their variant's width), the route
predicate, the same for both passes, and the wrappers' refusals. The kernels
themselves run only on a card (tests/test_torch_kernels.py,
chip_smoke.py).

Tolerance: atol 2e-5, rtol 2e-5 on the forward and atol 5e-5, rtol 5e-4
on gradients, as tests/test_ops.py holds the Pallas kernel against its
float32 oracle; the split departs from float32 products by about 2^-22
of sum |x| |y|, far below it. A bf16 case's inputs are bf16 values,
which JAX gets as the same values in float32: its gradients keep the
float32 tolerance, and its forward o, rounded to bf16 once, half a bf16
ulp more (rtol 2^-8).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.ops import attention as jax_attn
from learningorchestra_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
BF16_O_TOL = dict(atol=2e-5, rtol=2.0 ** -8)


def _bits(*patterns):
    return torch.tensor(np.array(patterns, np.uint32).view(np.float32))


def _hex(t):
    return [hex(int(b)) for b in t.numpy().view(np.uint32)]


def test_tf32_split_rounds_to_nearest_ties_away():
    """hi keeps 10 explicit mantissa bits, rounded to nearest with ties
    away from zero (cvt.rna): 1 + 2^-11 is a tie between 1 (even) and
    1 + 2^-10 and goes away from zero, in both signs."""
    x = _bits(0x3F801000,   # 1 + 2^-11: tie -> 1 + 2^-10
              0xBF801000,   # its negative -> -(1 + 2^-10)
              0x3F800FFF,   # just below the tie -> 1
              0x3F803000,   # 1 + 3 * 2^-11: tie -> 1 + 2^-9
              0x3F802001,   # just above 1 + 2^-10 -> 1 + 2^-10
              0x40490FDB)   # pi: 0xFDB < 0x1000 -> 0x40490000
    hi, lo = attn._tf32_split(x)
    assert _hex(hi) == ["0x3f802000", "0xbf802000", "0x3f800000",
                        "0x3f804000", "0x3f802000", "0x40490000"]
    assert bool((((hi + lo) - x).abs() <= 2.0 ** -22 * x.abs()).all())
    special = torch.tensor([float("inf"), -float("inf"), 0.0, -0.0])
    hi, lo = attn._tf32_split(special)
    # lo of an infinity is inf - inf, NaN, as the kernels' x - hi is
    assert torch.equal(hi, special) and bool((lo[2:] == 0).all())
    hi, _ = attn._tf32_split(torch.tensor([float("nan")]))
    assert bool(torch.isnan(hi).all())


def test_tf32_split_keeps_ten_mantissa_bits_and_hi_lo_within_bound():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096, dtype=np.float32) * np.float32(10.0) ** np.random.default_rng(
            1).integers(-6, 6, 4096).astype(np.float32))
    hi, lo = attn._tf32_split(x)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((hi - x).abs() <= 2.0 ** -11 * x.abs()).all())
    # within 2^-22 |x|, so within the 2^-21 |x| a split must keep
    assert bool((((hi + lo) - x).abs() <= 2.0 ** -22 * x.abs()).all())
    assert bool((((hi + lo) - x).abs() <= 2.0 ** -21 * x.abs()).all())


def test_tf32_split_leaves_every_bf16_value_whole():
    """Every finite bf16 value (all 65,536 bit patterns but inf and NaN)
    is exact in TF32: hi is the value itself and lo is 0, bit for bit.
    The tf32x3 backward kernels drop the lo terms of bf16 inputs on
    this."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    x = torch.from_numpy(bits.view(np.float32))
    x = x[torch.isfinite(x)]
    # less the 256 patterns with an all-ones exponent (inf and NaN)
    assert x.numel() == (1 << 16) - (1 << 8)
    assert torch.equal(x.bfloat16().float(), x)
    hi, lo = attn._tf32_split(x.bfloat16())
    assert torch.equal(hi.view(torch.int32), x.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), torch.zeros_like(
        x.view(torch.int32)))


def test_tf32x3_einsum_is_float32_accurate():
    """Three TF32 products: the split product departs from the float32
    one by about 2^-22 sum |x||y|, where one TF32 product departs by about
    2^-11 of it."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((16, 64), dtype=np.float32))
    y = torch.from_numpy(rng.standard_normal((64, 8), dtype=np.float32))
    exact = torch.einsum("ik,kj->ij", x.double(), y.double())
    bound = torch.einsum("ik,kj->ij", x.abs().double(), y.abs().double())
    split = attn._tf32x3_einsum("ik,kj->ij", x, y).double()
    single = torch.einsum("ik,kj->ij", attn._tf32_split(x)[0],
                          attn._tf32_split(y)[0]).double()
    f32 = 64 * 2.0 ** -24 * bound
    assert bool(((split - exact).abs() <= 2.0 ** -21 * bound + f32).all())
    assert bool(((single - exact).abs() > 2.0 ** -21 * bound + f32).any())


def _inputs(seed, b, sq, sk, h, kvh, d, dtype=torch.float32):
    """q, k, v, dO and dlse from numpy; in bf16 the first four are
    rounded to bf16 values (still float32 arrays: JAX gets them so)."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shape, dtype=np.float32) for shape in (
        (b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d), (b, sq, h, d),
        (b, sq, h))]
    if dtype == torch.bfloat16:
        out[:4] = [torch.from_numpy(a).bfloat16().float().numpy()
                   for a in out[:4]]
    return tuple(out)


# (b, sq, sk, h, kvh, d, causal, window, kv_offset, dlse, dtype)
_SPLIT_CASES = [
    (2, 48, 48, 4, 2, 16, True, 16, 0, False, torch.float32),  # GQA, window
    (1, 40, 40, 4, 1, 16, True, 0, 0, False, torch.float32),   # MQA
    (2, 32, 32, 2, 2, 16, True, 4, 20, True, torch.float32),   # empty rows
    (2, 40, 56, 4, 2, 16, False, 0, 0, False, torch.float32),  # ragged sk
    (1, 32, 32, 2, 2, 128, True, 0, 0, False, torch.float32),  # d 128
    # head dims off the multiple of 8: d 12 (the d-12 LM's) in bf16, GQA,
    # causal + window; d 13 (odd) with ragged sq and sk and a dlse term
    (2, 48, 48, 4, 2, 12, True, 16, 0, False, torch.bfloat16),
    (2, 24, 40, 2, 2, 13, False, 0, 0, True, torch.float32),
    # d 13 in bf16 (a bf16 row of odd length) with rows that see no key
    (2, 32, 32, 2, 2, 13, True, 4, 20, True, torch.bfloat16),
]


@pytest.mark.parametrize("case", _SPLIT_CASES)
def test_split_forward_matches_jax(case):
    """flash_attention_reference with both products split 3xTF32, as the
    tf32x3 forward multiplies, against the Pallas forward (_fwd_kernel
    in interpret mode). Rows with no visible key get exactly o = 0 and
    lse = NEG_INF in both."""
    b, sq, sk, h, kvh, d, causal, window, offset, _, dtype = case
    q, k, v, _, _ = _inputs(22, b, sq, sk, h, kvh, d, dtype)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = attn.flash_attention_reference(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), causal=causal,
        window=window, kv_offset=offset, tf32x3=True)
    if h == kvh:
        want = jax_attn.flash_attention_with_lse(
            jq, jk, jv, causal=causal, window=window, kv_offset=offset,
            block_q=8, block_k=16)
    else:
        want = (jax_attn.flash_attention(jq, jk, jv, causal=causal,
                                         window=window, block_q=8,
                                         block_k=16), None)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for a, w, tol in zip(got, want, (
            TOL if dtype == torch.float32 else BF16_O_TOL, TOL)):
        if w is None:
            continue
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w), **tol)
    o, lse = got
    if offset:
        empty = lse == attn.NEG_INF
        assert bool(empty.any())
        assert np.array_equal(np.asarray(want[1]) == attn.NEG_INF,
                              empty.numpy())
        assert bool((o[empty] == 0).all())
        assert bool((np.asarray(want[0])[empty.numpy()] == 0).all())


@pytest.mark.parametrize("case", _SPLIT_CASES)
def test_split_backward_matches_jax(case):
    """flash_bwd_reference with every product split 3xTF32, as the tf32x3
    kernels multiply, against jax.grad through the Pallas backward
    (_bwd_dq_kernel / _bwd_dkv_kernel in interpret mode). A bf16 case
    feeds bf16 q, k, v and dO, with o from the float32 forward of the
    same values so that delta is the oracle's."""
    b, sq, sk, h, kvh, d, causal, window, offset, with_dlse, dtype = case
    q, k, v, go, gl = _inputs(20, b, sq, sk, h, kvh, d, dtype)

    def jax_loss(q, k, v):
        if h == kvh:
            o, lse = jax_attn.flash_attention_with_lse(
                q, k, v, causal=causal, window=window, kv_offset=offset,
                block_q=8, block_k=16)
            return jnp.sum(o * go) + (jnp.sum(lse * gl) if with_dlse
                                      else 0.0)
        o = jax_attn.flash_attention(q, k, v, causal=causal, window=window,
                                     block_q=8, block_k=16)
        return jnp.sum(o * go)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tgo, tgl = (torch.from_numpy(a) for a in (q, k, v, go, gl))
    o, lse = attn.flash_attention_reference(tq, tk, tv, causal=causal,
                                            window=window, kv_offset=offset)
    if offset:
        assert bool((lse == attn.NEG_INF).any())
    tq, tk, tv, tgo = (t.to(dtype) for t in (tq, tk, tv, tgo))
    got = attn.flash_bwd_reference(tq, tk, tv, o, lse, tgo,
                                   tgl if with_dlse else None,
                                   causal=causal, window=window,
                                   kv_offset=offset, tf32x3=True)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD_TOL)
    if offset:
        assert bool((got[0][lse == attn.NEG_INF] == 0).all())


@pytest.mark.parametrize("dtype,d,route", [
    (torch.float32, 64, "tf32x3"),
    (torch.float32, 8, "tf32x3"),
    (torch.float32, 128, "tf32x3"),
    (torch.float32, 36, "tf32x3"),    # a multiple of 4, not of 8
    (torch.float32, 136, None),       # above 128: no kernel takes it
    (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 36, "tf32x3"),
    (torch.float32, 12, "tf32x3"),    # the d-12 LM's head_dim
    (torch.float32, 13, "tf32x3"),    # odd
    (torch.bfloat16, 12, "tf32x3"),
    (torch.bfloat16, 13, "tf32x3"),
    (torch.float16, 36, None),        # no kernel takes float16
])
def test_backward_route_predicate(dtype, d, route):
    """The route of both passes: bf16 at a head_dim that is a multiple
    of 8 (<= 128) the wgmma kernels, every other float32 or bf16
    head_dim up to 128 the split-TF32 ones; anything else raises."""
    q = types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                              shape=(2, 16, 4, d))
    if route is None:
        with pytest.raises(ValueError, match="head_dim <= 128"):
            attn._route(q)
    else:
        assert attn._route(q) == route


@pytest.mark.parametrize("dtype,d,route", [
    (torch.float32, 64, "tf32x3"),
    (torch.float32, 128, "tf32x3"),
    (torch.float32, 12, "tf32x3"),    # not a multiple of 8
    (torch.float32, 136, None),       # above 128: no kernel takes it
    (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 12, "tf32x3"),
    (torch.bfloat16, 13, "tf32x3"),   # a bf16 row of odd length
    (torch.float32, 36, "tf32x3"),    # a multiple of 4, between widths
    (torch.float16, 36, None),        # no kernel takes float16
])
def test_forward_takes_the_backward_route(monkeypatch, dtype, d, route):
    """On a card, _flash_fwd launches the forward of the route the
    backward takes (tests/test_torch_attention.py
    test_backward_routes_dq_and_dkv_together, at these (dtype, d) too):
    bf16 with head_dim % 8 == 0 (<= 128) the wgmma kernel, every other
    float32 or bf16 head_dim up to 128 the split-TF32 kernel. Input no
    kernel takes raises before any wrapper, or the plain version, runs.
    The launches are stubbed and the tensors claim a CUDA device to the
    route predicate."""
    real_route = attn._route
    ran = []

    def stub(name):
        def launch(q, k, v, *args, **kwargs):
            ran.append(name)
            return torch.zeros(q.shape), torch.zeros(q.shape[:3])
        return launch

    monkeypatch.setattr(attn, "_on_device", lambda kernel, q: True)
    monkeypatch.setattr(attn, "_route", lambda q: real_route(
        types.SimpleNamespace(device=torch.device("cuda"), dtype=q.dtype,
                              shape=q.shape)))
    for name in ("_flash_fwd_sm90", "_flash_fwd_tf32x3",
                 "flash_attention_reference"):
        monkeypatch.setattr(attn, name, stub(name))
    q, k, v, _, _ = (torch.from_numpy(a) for a in
                     _inputs(23, 1, 16, 16, 4, 2, d))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    if route is None:
        with pytest.raises(ValueError, match="head_dim <= 128"):
            attn._flash_fwd(q, k, v, True, 0.125, 0, 0)
        assert ran == []
        return
    o, lse = attn._flash_fwd(q, k, v, True, 0.125, 0, 0)
    assert ran == [f"_flash_fwd_{route}"]
    assert o.shape == q.shape and lse.shape == q.shape[:3]


def test_tf32x3_forward_refuses_what_the_kernel_does_not_take():
    """The split-TF32 forward takes float32 or bf16 at any head_dim up
    to 128: float16 tensors and a head_dim of 136 raise before any build
    or launch, whatever the caller routed."""
    before = attn.FLASH_FWD_TF32X3_LAUNCHES
    for dtype, d, error, match in ((torch.float16, 16, TypeError,
                                    "takes float32 or bfloat16"),
                                   (torch.float32, 136, ValueError,
                                    "head_dim <= 128")):
        q, k, v, _, _ = (torch.from_numpy(a) for a in
                         _inputs(24, 1, 16, 16, 2, 1, d))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        with pytest.raises(error, match=match):
            attn._flash_fwd_tf32x3(q, k, v, True, 0.25, 0, 0)
    assert attn.FLASH_FWD_TF32X3_LAUNCHES == before


@pytest.mark.parametrize("wrapper", ["_flash_bwd_dq_tf32x3",
                                     "_flash_bwd_dkv_tf32x3"])
def test_tf32x3_wrappers_refuse_what_the_kernels_do_not_take(wrapper):
    """The split-TF32 backward kernels take float32 or bf16 at any
    head_dim up to 128: float16 tensors and a head_dim of 136 raise
    before any build or launch, whatever the caller routed."""
    fn = getattr(attn, wrapper)
    before = (attn.FLASH_BWD_DQ_TF32X3_LAUNCHES,
              attn.FLASH_BWD_DKV_TF32X3_LAUNCHES)
    for dtype, d, error, match in ((torch.float16, 16, TypeError,
                                    "takes float32 or bfloat16"),
                                   (torch.float32, 136, ValueError,
                                    "head_dim <= 128")):
        q, k, v, do, lse = (torch.from_numpy(a) for a in
                            _inputs(21, 1, 16, 16, 2, 1, d))
        q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
        with pytest.raises(error, match=match):
            fn(q, k, v, do, lse, lse, True, 0.25, 0, 0)
    assert (attn.FLASH_BWD_DQ_TF32X3_LAUNCHES,
            attn.FLASH_BWD_DKV_TF32X3_LAUNCHES) == before
