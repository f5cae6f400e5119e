"""The PyTorch port's attention ops against the JAX package's.

The same numpy inputs go through the JAX flash kernel (Pallas, in
interpret mode on the CPU, as tests/test_ops.py runs it) and through the
port's ops, which on CPU tensors run the kernel's plain version.
Tolerance: atol/rtol 2e-5 in float32 for values and atol 5e-5, rtol
5e-4 for gradients, as tests/test_ops.py uses for the kernel against its
oracle (the two sum in different orders).
"""

import types

import jax
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
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)


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


def _upstream(seed, b, sq, h, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sq, h), dtype=np.float32))


@pytest.mark.parametrize("b,sq,sk,h,kvh,causal,window", [
    (2, 32, 32, 4, 4, False, 0),     # MHA, full
    (2, 32, 32, 4, 4, True, 0),      # MHA, causal
    (2, 40, 56, 4, 2, False, 0),     # GQA 4/2, ragged sk
    (1, 48, 48, 4, 1, True, 0),      # MQA 4/1
    (2, 48, 48, 4, 2, True, 16),     # GQA + sliding window
])
def test_flash_gradients_match_jax(b, sq, sk, h, kvh, causal, window):
    """The port's backward (plain version on the CPU) against jax.grad
    through the Pallas VJP (_bwd_dq_kernel / _bwd_dkv_kernel in
    interpret mode, blocks 8/16)."""
    q, k, v = _qkv(10, b, sq, sk, h, kvh, 16)
    go, _ = _upstream(11, b, sq, h, 16)

    def jax_loss(q, k, v):
        o = jax_attn.flash_attention(q, k, v, causal=causal, window=window,
                                     block_q=8, block_k=16)
        return jnp.sum(o * go)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = attn.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad((o * torch.from_numpy(go)).sum(),
                              (tq, tk, tv))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("causal,window,kv_offset", [
    (False, 0, 0),
    (True, 8, 0),
    (True, 4, 20),    # rows before the keys: lse -1e30, no visible key
])
def test_flash_with_lse_gradients_match_jax(causal, window, kv_offset):
    """A loss on both outputs: the lse gradient (dlse) enters the
    backward through ``delta - dlse``."""
    q, k, v = _qkv(12, 2, 32, 32, 2, 2, 16)
    go, gl = _upstream(13, 2, 32, 2, 16)

    def jax_loss(q, k, v):
        o, lse = jax_attn.flash_attention_with_lse(
            q, k, v, causal=causal, window=window, kv_offset=kv_offset,
            block_q=8, block_k=16)
        return jnp.sum(o * go) + jnp.sum(lse * gl)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o, lse = attn.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                           window=window,
                                           kv_offset=kv_offset)
    if kv_offset:
        assert bool((lse == attn.NEG_INF).any())
    loss = (o * torch.from_numpy(go)).sum() \
        + (lse * torch.from_numpy(gl)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("h,kvh,causal,window,kv_offset,with_dlse", [
    (4, 2, True, 8, 0, False),
    (4, 1, False, 0, 0, False),
    (2, 2, True, 4, 20, True),
])
def test_flash_bwd_reference_matches_autograd(h, kvh, causal, window,
                                              kv_offset, with_dlse):
    """The plain backward against autograd of the plain forward: the
    same function, by the kernels' recurrence. Rows with no visible key
    give zeros, not NaN."""
    q, k, v = _t(*_qkv(14, 2, 24, 24, h, kvh, 8))
    go, gl = _t(*_upstream(15, 2, 24, h, 8))
    for t in (q, k, v):
        t.requires_grad_()
    o, lse = attn.flash_attention_reference(q, k, v, causal=causal,
                                            window=window,
                                            kv_offset=kv_offset)
    loss = (o * go).sum()
    if with_dlse:
        loss = loss + (torch.where(lse > attn.NEG_INF, lse, 0.0) * gl).sum()
    want = torch.autograd.grad(loss, (q, k, v))
    got = attn.flash_bwd_reference(q.detach(), k.detach(), v.detach(),
                                   o.detach(), lse.detach(), go,
                                   gl if with_dlse else None,
                                   causal=causal, window=window,
                                   kv_offset=kv_offset)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)


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
    counters = ("FLASH_FWD_SM90_LAUNCHES",
                "FLASH_BWD_DQ_SM90_LAUNCHES", "FLASH_BWD_DKV_SM90_LAUNCHES",
                "FLASH_BWD_DQ_TF32X3_LAUNCHES",
                "FLASH_BWD_DKV_TF32X3_LAUNCHES", "FLASH_FWD_TF32X3_LAUNCHES")
    before = [getattr(attn, c) for c in counters]
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(4, 1, 16, 16, 2, 1, 8)))
    o = attn.flash_attention(q, k, v, causal=True)
    o2, lse = attn.flash_attention_with_lse(q, q, q, causal=True)
    torch.autograd.grad(o.sum() + o2.sum() + lse.sum(), (q, k, v))
    assert [getattr(attn, c) for c in counters] == before


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


@pytest.mark.parametrize("device,dtype,d,route", [
    ("cuda", torch.bfloat16, 64, True),
    ("cuda", torch.bfloat16, 8, True),
    ("cuda", torch.bfloat16, 128, True),
    ("cuda", torch.bfloat16, 20, False),     # not a multiple of 8
    ("cuda", torch.bfloat16, 136, False),    # above 128
    ("cuda", torch.float32, 64, False),
    ("cpu", torch.bfloat16, 64, False),
])
def test_tensor_core_route_predicate(device, dtype, d, route):
    """bf16 with a head_dim that is a multiple of 8 up to 128 on a CUDA
    tensor takes the tensor-core kernels; everything else does not."""
    q = types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                              shape=(2, 16, 4, d))
    assert attn._tensor_core_route(q) is route


def test_cpu_calls_never_reach_the_route_predicate(monkeypatch):
    def refuse(q):
        raise AssertionError("a CPU tensor reached the route predicate")

    monkeypatch.setattr(attn, "_tensor_core_route", refuse)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype).requires_grad_()
                   for t in _t(*_qkv(16, 1, 16, 16, 2, 1, 16)))
        o = attn.flash_attention(q, k, v, causal=True)
        torch.autograd.grad(o.float().sum(), (q, k, v))


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 128, "sm90"),
    (torch.float32, 64, "tf32x3"),
    (torch.float32, 36, "tf32x3"),    # not a multiple of 8
    (torch.bfloat16, 20, "tf32x3"),   # not a multiple of 8
    # the forward route test's (dtype, d) pairs (tests/test_torch_tf32x3
    # .py)
    (torch.float32, 128, "tf32x3"),
    (torch.float32, 12, "tf32x3"),
    (torch.float32, 13, "tf32x3"),
    (torch.bfloat16, 12, "tf32x3"),
    (torch.bfloat16, 13, "tf32x3"),
])
def test_backward_routes_dq_and_dkv_together(monkeypatch, dtype, d, route):
    """On a card, _flash_bwd sends dQ and dK/dV down the same route:
    bf16 with head_dim % 8 == 0 to the wgmma kernels, every other
    float32 or bf16 head_dim up to 128 to the split-TF32 ones. The
    launches are stubbed and the tensors claim a CUDA device to the
    route predicate."""
    real_route = attn._route
    ran = []

    def stub(name, outs):
        def launch(q, k, v, do, lse, delta, *args):
            ran.append(name)
            if outs == 1:
                return torch.zeros(q.shape)
            return torch.zeros(k.shape), torch.zeros(v.shape)
        return launch

    monkeypatch.setattr(attn, "_on_device", lambda kernel, q: True)
    monkeypatch.setattr(attn, "_route", lambda q: real_route(
        types.SimpleNamespace(device=torch.device("cuda"), dtype=q.dtype,
                              shape=q.shape)))
    for name, outs in (("_flash_bwd_dq_sm90", 1),
                       ("_flash_bwd_dq_tf32x3", 1),
                       ("_flash_bwd_dkv_sm90", 2),
                       ("_flash_bwd_dkv_tf32x3", 2)):
        monkeypatch.setattr(attn, name, stub(name, outs))
    q, k, v = (t.to(dtype) for t in _t(*_qkv(18, 1, 16, 16, 4, 2, d)))
    o = torch.zeros_like(q)
    lse = torch.zeros(q.shape[:3])
    dq, dk, dv = attn._flash_bwd(q, k, v, o, lse, torch.ones_like(q), None,
                                 True, 0.125, 0, 0)
    assert ran == [f"_flash_bwd_dq_{route}", f"_flash_bwd_dkv_{route}"]
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


@pytest.mark.parametrize("dtype,d", [(torch.float32, 136),
                                     (torch.float16, 36)])
def test_backward_raises_where_no_kernel_takes_the_input(monkeypatch, dtype,
                                                         d):
    """On a card, a head_dim above 128 or a float16 tensor has no
    backward kernel: _flash_bwd raises before any wrapper is called,
    and never falls back to the plain version."""
    real_route = attn._route
    ran = []
    monkeypatch.setattr(attn, "_on_device", lambda kernel, q: True)
    monkeypatch.setattr(attn, "_route", lambda q: real_route(
        types.SimpleNamespace(device=torch.device("cuda"), dtype=q.dtype,
                              shape=q.shape)))
    for name in ("_flash_bwd_dq_sm90", "_flash_bwd_dq_tf32x3",
                 "_flash_bwd_dkv_sm90", "_flash_bwd_dkv_tf32x3",
                 "flash_bwd_reference"):
        monkeypatch.setattr(attn, name,
                            lambda *a, _name=name, **kw: ran.append(_name))
    q, k, v = (t.to(dtype) for t in _t(*_qkv(18, 1, 16, 16, 4, 2, d)))
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="head_dim <= 128"):
        attn._flash_bwd(q, k, v, torch.zeros_like(q), lse,
                        torch.ones_like(q), None, True, 0.125, 0, 0)
    assert ran == []


def test_the_port_builds_only_the_six_tensor_core_sources():
    """Every CUDA source of the port is a tensor-core kernel: the wgmma
    and the split-TF32 forward, dQ and dK/dV, nothing else."""
    from learningorchestra_tpu_torch.ops import _build

    assert _build.sources() == sorted(
        f"flash_{op}_{route}" for op in ("fwd", "bwd_dq", "bwd_dkv")
        for route in ("sm90", "tf32x3"))


@pytest.mark.parametrize("wrapper", ["_flash_fwd_sm90", "_flash_bwd_dq_sm90",
                                     "_flash_bwd_dkv_sm90"])
def test_tensor_core_wrappers_refuse_other_dtypes(wrapper):
    """A tensor-core kernel reads bf16 through TMA: its wrapper raises on
    float32 before any build or launch, whatever the caller routed."""
    q, k, v = _t(*_qkv(19, 1, 16, 16, 2, 1, 16))
    lse = torch.zeros(q.shape[:3])
    args = (q, k, v) if wrapper == "_flash_fwd_sm90" \
        else (q, k, v, torch.ones_like(q), lse, lse)
    before = attn.FLASH_BWD_DQ_SM90_LAUNCHES
    with pytest.raises(TypeError, match="takes bfloat16"):
        getattr(attn, wrapper)(*args, True, 0.25, 0, 0)
    assert attn.FLASH_BWD_DQ_SM90_LAUNCHES == before


def _dense_parts(seed):
    """float32 forward and backward of causal windowed attention at a
    small shape, with the products the tensor-core kernels round: the
    unnormalised weights e of o = e.v / l, p of dV = p^T.dO, and ds of
    dK = ds^T.q and of dQ = ds.k."""
    q, k, v = _t(*_qkv(seed, 2, 48, 48, 2, 2, 16))
    do, _ = _t(*_upstream(seed + 1, 2, 48, 2, 16))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    visible = attn._visible(48, 48, True, 12, 0, "cpu")
    m = torch.where(visible, s, attn.NEG_INF).amax(-1, keepdim=True)
    e = torch.where(visible, torch.exp(s - m), 0.0)
    l = e.sum(-1, keepdim=True)
    p = e / l
    o = torch.einsum("bhqk,bkhd->bhqd", p, v)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * o.transpose(1, 2)).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta) / 4.0
    dot = do.transpose(1, 2)
    return {
        # (weights, the operand they multiply, its layout, divisor)
        "o": (e, v.transpose(1, 2), "bhqk,bhkd->bhqd", l),
        "dv": (p, dot, "bhqk,bhqd->bhkd", 1.0),
        "dk": (ds, q.transpose(1, 2), "bhqk,bhqd->bhkd", 1.0),
        "dq": (ds, k.transpose(1, 2), "bhqk,bhkd->bhqd", 1.0),
    }


@pytest.mark.parametrize("part", ["o", "dv", "dk", "dq"])
def test_bf16_weights_stay_within_the_stated_bound(part):
    """The bound PERF.md and the kernels' notes state: rounding the
    weights w (p, or ds) of a product to bf16 moves each output element
    by at most 2^-8 sum |w| |x| (bf16's unit roundoff), and the
    tensor-core kernels' hi + lo split by at most 2^-16 of it. A float32
    sum of 48 terms adds at most 48 * 2^-24 of the same sum."""
    w, x, eq, div = _dense_parts(17)[part]
    exact = torch.einsum(eq, w, x) / div
    scale = torch.einsum(eq, w.abs(), x.abs()) / div
    f32 = 48 * 2.0 ** -24 * scale
    single = (torch.einsum(eq, w.bfloat16().float(), x) / div - exact).abs()
    split = (torch.einsum(eq, attn._bf16_split(w), x) / div - exact).abs()
    assert bool((single <= 2.0 ** -8 * scale + f32).all())
    assert bool((split <= 2.0 ** -16 * scale + f32).all())
    # the single rounding does exceed the split's bound: the split matters
    assert bool((single > 2.0 ** -16 * scale + f32).any())
