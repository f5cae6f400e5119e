"""Attention ops of the PyTorch port.

Counterpart of :mod:`learningorchestra_tpu.ops.attention`, in the same
``(batch, seq, heads, head_dim)`` layout with ``k``/``v`` at ``kv``
heads, ``kv | heads``.

- :func:`flash_attention` / :func:`flash_attention_with_lse` are
  differentiable (:class:`_FlashAttention`). On a CUDA tensor the
  forward runs a hand-written port of the TPU ``_fwd_kernel`` and the
  backward ports of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``; on a
  CPU tensor they run their plain PyTorch versions
  :func:`flash_attention_reference` and :func:`flash_bwd_reference`. A
  CUDA tensor never falls back to a plain version or to another route:
  the kernel launches or the call raises.
- Two routes, the same for both passes, by :func:`_route`: bf16 with a
  head_dim that is a multiple of 8 up to 128 takes the wgmma + TMA
  tensor-core kernels ``csrc/flash_fwd_sm90.cu``,
  ``csrc/flash_bwd_dq_sm90.cu`` and ``csrc/flash_bwd_dkv_sm90.cu``;
  every other float32 or bf16 head_dim up to 128 the split-TF32
  tensor-core kernels (mma.sync + cp.async) ``csrc/flash_fwd_tf32x3.cu``,
  ``csrc/flash_bwd_dq_tf32x3.cu`` and ``csrc/flash_bwd_dkv_tf32x3.cu``.
  Any other input raises before a build or launch.
- :func:`full_attention_reference` is the ``dot`` implementation.
- :func:`decode_attention` is the serving plane's single-token op, left
  as plain tensor ops exactly as the JAX package left it, and so are
  the paged KV ops around it (:func:`paged_decode_attention`, the page
  writes, the int8 pages of :func:`quantize_kv_pages`, and the
  speculative verify step's multi-position :func:`paged_append_tokens`
  and :func:`paged_verify_attention` with their int8 forms).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from learningorchestra_tpu_torch.runtime import locks

NEG_INF = -1e30

# launches of each kernel, one counter per CUDA source (CPU calls never
# count), added to under a lock: a disaggregated session launches from
# two threads
FLASH_FWD_SM90_LAUNCHES = 0
FLASH_BWD_DQ_SM90_LAUNCHES = 0
FLASH_BWD_DKV_SM90_LAUNCHES = 0
FLASH_BWD_DQ_TF32X3_LAUNCHES = 0
FLASH_BWD_DKV_TF32X3_LAUNCHES = 0
FLASH_FWD_TF32X3_LAUNCHES = 0
_LAUNCH_LOCK = locks.make_lock("attention.launches")


def _count_launch(counter: str) -> None:
    with _LAUNCH_LOCK:
        globals()[counter] += 1


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the widest head_dim any flash kernel takes
MAX_HEAD_DIM = 128


def _check_args(q, k, v, causal: bool, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (batch, seq, heads, head_dim)")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}")
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(
            f"q has {h} heads but k/v have {kvh} — kv heads must "
            f"divide query heads (GQA)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _visible(sq: int, sk: int, causal: bool, window: int, offset: int,
             device) -> torch.Tensor:
    """``(sq, sk)`` bool: key ``col`` is visible to query ``row``."""
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(sk, device=device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        valid = valid & (row >= col + offset)
    if window > 0:
        valid = valid & (col + offset > row - window)
    return valid


def _by_group(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """Per-row ``(b, sq, h)`` -> ``(b, kvh, group, sq, 1)``, the layout
    of the grouped scores."""
    b, sq, h = x.shape
    return x.reshape(b, sq, kvh, h // kvh).permute(0, 2, 3, 1)[..., None]


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = False,
                              scale: Optional[float] = None,
                              window: int = 0, kv_offset: int = 0,
                              tf32x3: bool = False,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash kernel: ``(o, lse)`` with the kernel's
    masking. Key ``col`` is visible to query ``row`` when ``col < sk``,
    ``row >= col + kv_offset`` (causal) and ``col + kv_offset > row -
    window`` (window > 0). A row with no visible key gets ``o = 0`` and
    ``lse = NEG_INF``. Computed in float32; ``o`` in q's dtype. With
    ``tf32x3`` both products are split as the tf32x3 forward splits them
    (:func:`_tf32x3_einsum`)."""
    _check_args(q, k, v, causal, window)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    mm = _tf32x3_einsum if tf32x3 else torch.einsum
    qg = q.float().reshape(b, sq, kvh, group, d)
    s = mm("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    valid = _visible(sq, sk, causal, window, kv_offset, q.device)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)
    o = mm("bhgqk,bkhd->bqhgd", p, v.float()) \
        / safe_l.permute(0, 3, 1, 2, 4)
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)[..., 0]
    return (o.reshape(b, sq, h, d).to(q.dtype),
            lse.permute(0, 3, 1, 2).reshape(b, sq, h))


def _bwd_delta(o: torch.Tensor, do: torch.Tensor,
               dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """``rowsum(dO * O) - dlse`` in float32, ``(b, sq, h)``: the one
    backward quantity outside the kernels. ``o`` is the forward's saved
    output in its own dtype. ``dlse`` (the gradient on the lse output)
    adds ``dlse * p`` to ``ds``, which is ``delta - dlse`` in place of
    ``delta``."""
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor,
                        dlse: Optional[torch.Tensor] = None, *,
                        causal: bool = False,
                        scale: Optional[float] = None, window: int = 0,
                        kv_offset: int = 0, tf32x3: bool = False,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of both backward kernels: float32 ``(dq, dk, dv)``
    of ``flash_attention_with_lse`` at its saved ``(o, lse)`` for the
    upstream gradients ``do`` (and ``dlse``), by the kernels'
    recurrence run densely: ``p = exp(s - lse)`` on visible pairs,
    ``ds = p * (dO.v - delta) * scale``, ``dq = ds k``, ``dk = ds^T q``
    and ``dv = p^T dO``, with dk and dv summed over each kv head's
    group of query heads. Masked pairs are zeroed before the exp, so a
    row with no visible key (``lse = NEG_INF``) gives zeros, not NaN.
    With ``tf32x3`` every product is split as the tf32x3 kernels split
    it (:func:`_tf32x3_einsum`)."""
    _check_args(q, k, v, causal, window)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    mm = _tf32x3_einsum if tf32x3 else torch.einsum
    qg = q.float().reshape(b, sq, kvh, group, d)
    dog = do.float().reshape(b, sq, kvh, group, d)
    kf, vf = k.float(), v.float()
    valid = _visible(sq, sk, causal, window, kv_offset, q.device)
    s = mm("bqhgd,bkhd->bhgqk", qg, kf) * scale
    p = torch.exp(torch.where(valid, s - _by_group(lse.float(), kvh),
                              NEG_INF))
    dp = mm("bqhgd,bkhd->bhgqk", dog, vf)
    ds = p * (dp - _by_group(_bwd_delta(o, do, dlse), kvh)) * scale
    dq = mm("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, sq, h, d)
    dk = mm("bhgqk,bqhgd->bkhd", ds, qg)
    dv = mm("bhgqk,bqhgd->bkhd", p, dog)
    return dq, dk, dv


def _check_cuda(kernel: str, tensors, dtype=None) -> None:
    """Every tensor on the first one's device, in ``dtype`` (default:
    the first one's), contiguous."""
    first_name, first = tensors[0]
    dtype = dtype or first.dtype
    for name, t in tensors:
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, {first_name} on "
                             f"{first.device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} needs contiguous tensors; {name} "
                             f"is not")


def _check_shape(kernel: str, q, k) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{kernel} takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, _, h, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{kernel} takes head_dim <= {MAX_HEAD_DIM}, "
                         f"got {d}")
    if b * h > 65535:
        raise ValueError(f"{kernel} takes batch * heads <= 65535, got "
                         f"{b * h}")


def _kernel(source: str, argtypes):
    """The C entry point ``lo_<source>`` of a built kernel source."""
    from learningorchestra_tpu_torch.ops import _build

    fn = getattr(_build.load(source), f"lo_{source}")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _tensor_core_route(q) -> bool:
    """True when a CUDA tensor takes the wgmma tensor-core kernels
    (``csrc/flash_*_sm90.cu``): bf16 with a head_dim that is a multiple
    of 8 up to 128, since TMA needs 16-byte strides."""
    d = q.shape[-1]
    return (q.device.type == "cuda" and q.dtype == torch.bfloat16
            and d % 8 == 0 and d <= MAX_HEAD_DIM)


def _bf16_split(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` as the tensor-core kernels multiply it: bf16 ``hi``
    plus bf16 ``lo = x - hi``, within about 2^-16 |x| of x (bf16 alone
    keeps 2^-8). The kernels do this to P and dS; the plain versions
    do not, and chip_smoke.py emulates it to hold the kernels tightly."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def _route(q) -> str:
    """The kernels a CUDA tensor takes, the same in the forward and the
    backward (dQ and dK/dV):

    ===================================  ==========
    q (dtype, head_dim d)                route
    ===================================  ==========
    bf16, d % 8 == 0, d <= 128           ``sm90``
    float32 or bf16, any other d <= 128  ``tf32x3``
    ===================================  ==========

    ``sm90``: wgmma tensor cores (:func:`_tensor_core_route`).
    ``tf32x3``: split-TF32 mma.sync tensor cores, which zero-fill any
    head_dim to their variant's width. Anything else (float16, a
    head_dim above 128) no kernel takes: raises ValueError, before any
    build or launch. A CPU tensor never gets here (it runs the plain
    version)."""
    if q.dtype not in _DTYPE_CODES or q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"flash attention takes float32 or bfloat16 with "
                         f"head_dim <= {MAX_HEAD_DIM}, got {q.dtype} at "
                         f"head_dim {q.shape[-1]}")
    return "sm90" if _tensor_core_route(q) else "tf32x3"


def _tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``x`` as the tf32x3 kernels cut it: ``hi`` is ``x``
    rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away
    from zero, 10 explicit mantissa bits), ``lo`` is ``x - hi`` rounded
    the same way; ``hi + lo`` is within 2^-22 |x| of x. Done on the int32
    view: adding half of the 13 dropped bits to the magnitude and
    clearing them rounds the magnitude half up, whatever the sign. inf
    and NaN pass through."""
    def rna(y):
        bits = (y.view(torch.int32) + 0x1000) & -0x2000
        return torch.where(torch.isfinite(y), bits.view(torch.float32), y)

    x = x.float().contiguous()
    hi = rna(x)
    return hi, rna(x - hi)


def _tf32x3_einsum(eq: str, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, x, y)`` as the tf32x3 kernels multiply: both operands
    split by :func:`_tf32_split` and summed as x_lo.y_hi + x_hi.y_lo +
    x_hi.y_hi (x_lo.y_lo dropped), in float32."""
    x_hi, x_lo = _tf32_split(x)
    y_hi, y_lo = _tf32_split(y)
    return (torch.einsum(eq, x_lo, y_hi) + torch.einsum(eq, x_hi, y_lo)
            + torch.einsum(eq, x_hi, y_hi))


def _check_tma(kernel: str, tensors) -> None:
    """The wgmma kernels read bf16 through TMA, from 16-byte aligned
    bases."""
    for name, t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} takes bfloat16; {name} is {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel} needs 16-byte aligned tensors; "
                             f"{name} is not")


def _flash_fwd_sm90(q, k, v, causal: bool, scale: float, window: int,
                    offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    tensors = (("q", q), ("k", k), ("v", v))
    _check_cuda("flash_fwd_sm90", tensors)
    _check_shape("flash_fwd_sm90", q, k)
    _check_tma("flash_fwd_sm90", tensors)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    fn = _kernel("flash_fwd_sm90", [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 6 + [ctypes.c_float]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    o = torch.empty_like(q)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, sq, sk, h, kvh, d, float(scale),
                 int(bool(causal)), int(window), int(offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_sm90 launch failed: CUDA error {err}")
    _count_launch("FLASH_FWD_SM90_LAUNCHES")
    return o, lse


def _bwd_inputs(kernel: str, q, k, v, do, lse, delta) -> None:
    _check_cuda(kernel, (("q", q), ("k", k), ("v", v), ("do", do)))
    _check_cuda(kernel, (("lse", lse), ("delta", delta)),
                dtype=torch.float32)
    _check_shape(kernel, q, k)
    if do.shape != q.shape or lse.shape != q.shape[:3] \
            or delta.shape != q.shape[:3] or lse.device != q.device:
        raise ValueError(f"{kernel}: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} "
                         f"do not match q {tuple(q.shape)} on {q.device}")


def _flash_bwd_dq_sm90(q, k, v, do, lse, delta, causal: bool,
                       scale: float, window: int,
                       offset: int) -> torch.Tensor:
    """float32 dq (b, sq, h, d) from the tensor-core flash_bwd_dq_sm90
    kernel."""
    _bwd_inputs("flash_bwd_dq_sm90", q, k, v, do, lse, delta)
    _check_tma("flash_bwd_dq_sm90",
               (("q", q), ("k", k), ("v", v), ("do", do)))
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    fn = _kernel("flash_bwd_dq_sm90", [ctypes.c_void_p] * 7
                 + [ctypes.c_int] * 6 + [ctypes.c_float]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, sq,
                 sk, h, kvh, d, float(scale), int(bool(causal)),
                 int(window), int(offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq_sm90 launch failed: CUDA error "
                           f"{err}")
    _count_launch("FLASH_BWD_DQ_SM90_LAUNCHES")
    return dq


def _by_head(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Per-row ``(b, sq, h)`` float32 -> contiguous ``(b, h, rows)``,
    zero past ``sq``: one head's rows side by side, as the tensor-core
    dK/dV kernel copies them."""
    b, sq, h = x.shape
    out = x.new_zeros((b, h, rows))
    out[:, :, :sq] = x.transpose(1, 2)
    return out


def _flash_bwd_dkv_sm90(q, k, v, do, lse, delta, causal: bool,
                        scale: float, window: int, offset: int,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (dk, dv), each (b, sk, kvh, d), from the tensor-core
    flash_bwd_dkv_sm90 kernel."""
    _bwd_inputs("flash_bwd_dkv_sm90", q, k, v, do, lse, delta)
    _check_tma("flash_bwd_dkv_sm90",
               (("q", q), ("k", k), ("v", v), ("do", do)))
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rows = -(-sq // 64) * 64  # the kernel's q tile
    lse_t, delta_t = _by_head(lse, rows), _by_head(delta, rows)
    fn = _kernel("flash_bwd_dkv_sm90", [ctypes.c_void_p] * 8
                 + [ctypes.c_int] * 7 + [ctypes.c_float]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse_t.data_ptr(), delta_t.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, sq, sk, h, kvh, d, rows, float(scale),
                 int(bool(causal)), int(window), int(offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv_sm90 launch failed: CUDA error "
                           f"{err}")
    _count_launch("FLASH_BWD_DKV_SM90_LAUNCHES")
    return dk, dv


def _flash_fwd_tf32x3(q, k, v, causal: bool, scale: float, window: int,
                      offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` from the split-TF32 tensor-core flash_fwd_tf32x3
    kernel: float32 or bf16 inputs, any head_dim up to 128; o (b, sq, h,
    d) in q's dtype and float32 lse (b, sq, h)."""
    _check_cuda("flash_fwd_tf32x3", (("q", q), ("k", k), ("v", v)))
    _check_shape("flash_fwd_tf32x3", q, k)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    fn = _kernel("flash_fwd_tf32x3", [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 6 + [ctypes.c_float]
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    o = torch.empty_like(q)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, sq, sk, h, kvh, d, float(scale),
                 int(bool(causal)), int(window), int(offset),
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_tf32x3 launch failed: CUDA error "
                           f"{err}")
    _count_launch("FLASH_FWD_TF32X3_LAUNCHES")
    return o, lse


def _flash_bwd_dq_tf32x3(q, k, v, do, lse, delta, causal: bool,
                         scale: float, window: int,
                         offset: int) -> torch.Tensor:
    """float32 dq (b, sq, h, d) from the split-TF32 tensor-core
    flash_bwd_dq_tf32x3 kernel: float32 or bf16 inputs, any head_dim up
    to 128."""
    _bwd_inputs("flash_bwd_dq_tf32x3", q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    fn = _kernel("flash_bwd_dq_tf32x3", [ctypes.c_void_p] * 7
                 + [ctypes.c_int] * 6 + [ctypes.c_float]
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, sq,
                 sk, h, kvh, d, float(scale), int(bool(causal)),
                 int(window), int(offset), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq_tf32x3 launch failed: CUDA error "
                           f"{err}")
    _count_launch("FLASH_BWD_DQ_TF32X3_LAUNCHES")
    return dq


def _flash_bwd_dkv_tf32x3(q, k, v, do, lse, delta, causal: bool,
                          scale: float, window: int, offset: int,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (dk, dv), each (b, sk, kvh, d), from the split-TF32
    tensor-core flash_bwd_dkv_tf32x3 kernel: float32 or bf16 inputs, any
    head_dim up to 128."""
    _bwd_inputs("flash_bwd_dkv_tf32x3", q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    fn = _kernel("flash_bwd_dkv_tf32x3", [ctypes.c_void_p] * 8
                 + [ctypes.c_int] * 6 + [ctypes.c_float]
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, sq, sk, h, kvh, d, float(scale),
                 int(bool(causal)), int(window), int(offset),
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv_tf32x3 launch failed: CUDA error "
                           f"{err}")
    _count_launch("FLASH_BWD_DKV_TF32X3_LAUNCHES")
    return dk, dv


def _on_device(kernel: str, q) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU one
    (the plain version runs); any other device raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu tensors, got "
                         f"{q.device}")
    return True


def _flash_fwd(q, k, v, causal: bool, scale: float, window: int,
               offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if not _on_device("flash attention", q):
        return flash_attention_reference(q, k, v, causal=causal,
                                         scale=scale, window=window,
                                         kv_offset=offset)
    fwd = {"sm90": _flash_fwd_sm90, "tf32x3": _flash_fwd_tf32x3}[_route(q)]
    return fwd(q, k, v, causal, scale, window, offset)


def _flash_bwd(q, k, v, o, lse, do, dlse, causal: bool, scale: float,
               window: int, offset: int):
    if not _on_device("flash attention backward", q):
        return flash_bwd_reference(q, k, v, o, lse, do, dlse,
                                   causal=causal, scale=scale,
                                   window=window, kv_offset=offset)
    dq_fn, dkv_fn = {
        "sm90": (_flash_bwd_dq_sm90, _flash_bwd_dkv_sm90),
        "tf32x3": (_flash_bwd_dq_tf32x3, _flash_bwd_dkv_tf32x3)}[_route(q)]
    do = do.contiguous()
    delta = _bwd_delta(o, do, dlse)
    args = (q, k, v, do, lse, delta, causal, scale, window, offset)
    dq = dq_fn(*args)
    dk, dv = dkv_fn(*args)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``(o, lse)`` of flash attention with its backward: the port of
    the JAX package's ``custom_vjp`` pair ``_flash`` / ``_flash_lse``.
    Forward saves q, k, v and the forward's own ``(o, lse)``; backward
    computes ``delta`` from that saved ``o`` and runs the two backward
    kernels (plain version on the CPU). Gradients come back in the
    inputs' dtypes, as the JAX backward casts them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, offset):
        o, lse = _flash_fwd(q, k, v, causal, scale, window, offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, window, offset)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, dlse, *ctx.args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _flash(q, k, v, causal: bool, scale: Optional[float], window: int,
           offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_args(q, k, v, causal, window)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale),
                                 int(window), int(offset))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Fused attention over ``(b, s, h, d)`` tensors, GQA-native: ``k``
    and ``v`` may carry fewer heads than ``q`` (``kv | h``) and are never
    repeated to ``h`` heads. ``window=W`` (requires ``causal``) lets
    query p attend keys in ``[p-W+1, p]``. Differentiable."""
    if window and not causal:
        raise ValueError("window requires causal=True (banded causal "
                         "attention)")
    return _flash(q, k, v, causal, scale, window, 0)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = False,
                             scale: Optional[float] = None,
                             window: int = 0, kv_offset: int = 0,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (b, sq, h, d), lse (b, sq, h))``: the blockwise form ring
    attention merges across devices. ``kv_offset`` shifts key positions
    (``col + kv_offset``). Differentiable in both outputs: the gradient
    on ``lse`` flows through the backward kernels' ``delta``."""
    h = q.shape[2]
    if k.shape[2] != h:
        raise ValueError(
            f"flash_attention_with_lse needs equal head counts "
            f"(q has {h}, k/v have {k.shape[2]}) — repeat K/V to "
            f"full heads first; grouped GQA is flash_attention only")
    return _flash(q, k, v, causal, scale, window, kv_offset)


def full_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             scale: Optional[float] = None,
                             window: int = 0,
                             kv_valid: Optional[torch.Tensor] = None,
                             ) -> torch.Tensor:
    """Plain full-softmax attention with equal head counts (the ``dot``
    implementation). ``kv_valid`` (bool ``(b, sk)``) masks padded key
    positions per batch row. NEG_INF scores underflow to exact zero."""
    d = q.shape[-1]
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window requires causal=True")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    if causal:
        sq, sk = scores.shape[1], scores.shape[3]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        mask = rows >= cols
        if window > 0:
            mask = mask & (cols > rows - window)
        scores = torch.where(mask[None, :, None, :], scores, NEG_INF)
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", p, v.float()).to(q.dtype)


def reference_attention(q, k, v, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Unfused full-softmax oracle (same layout and contract)."""
    return full_attention_reference(q, k, v, causal=causal, scale=scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, col: torch.Tensor, *,
                     pad_offset: Optional[torch.Tensor] = None,
                     window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token GQA attention against a per-row cache position.

    ``q`` is ``(b, 1, n_heads, d)``, ``k_cache``/``v_cache`` are
    ``(b, L, kv_heads, d)``, ``col`` is ``(b,)``: each row attends its
    own prefix ``[pad_offset[i], col[i]]`` (and only the last ``window``
    positions when ``window > 0``). Plain tensor ops, as in the JAX
    package: the serving contract needs a slot's decode to follow the
    solo decode's arithmetic, and the op is bound by the cache read."""
    b, s, h, d = q.shape
    kv = k_cache.shape[2]
    group = h // kv
    qg = q.float().reshape(b, s, kv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bqhgk", qg, k_cache.float())
    # DIVIDE by sqrt(d), as the JAX decode paths do: x/s and x*(1/s)
    # round differently
    scores = scores * scale if scale is not None else scores / (d ** 0.5)
    positions = torch.arange(k_cache.shape[1], device=q.device)
    visible = positions[None, :] <= col[:, None]
    if pad_offset is not None:
        visible = visible & (positions[None, :] >= pad_offset[:, None])
    if window > 0:
        visible = visible & (positions[None, :] > (col - window)[:, None])
    scores = torch.where(visible[:, None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v_cache.float())
    return o.reshape(b, s, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged KV (vLLM layout): a shared (pages, page_len, kv, d) pool per layer
# and a block table per stream. Plain tensor ops, as in the JAX package:
# the gathered pages go through decode_attention's reduction, so masked
# positions contribute exact zeros and a paged stream follows the slot
# path's arithmetic.


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor,
                           block_tables: torch.Tensor, col: torch.Tensor, *,
                           pad_offset: Optional[torch.Tensor] = None,
                           window: int = 0, scale: Optional[float] = None,
                           max_pages: int = 0) -> torch.Tensor:
    """:func:`decode_attention` over a paged KV pool.

    ``k_pool``/``v_pool`` are ``(pages, page_len, kv_heads, d)``;
    ``block_tables`` (``(b, n_pages)`` int) maps each row's logical cache
    onto pool pages. The pages are gathered into the contiguous ``(b,
    n_pages * page_len, kv, d)`` layout and fed through
    :func:`decode_attention`. ``max_pages > 0`` clamps the gather to the
    first ``max_pages`` table columns: every masked term past the highest
    live ``col`` is an exact zero, so short streams need not gather long
    streams' pages."""
    if max_pages and max_pages < block_tables.shape[1]:
        block_tables = block_tables[:, :max_pages]
    b, n_pages = block_tables.shape
    page_len, kv, d = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    k = k_pool[block_tables].reshape(b, n_pages * page_len, kv, d)
    v = v_pool[block_tables].reshape(b, n_pages * page_len, kv, d)
    return decode_attention(q, k, v, col, pad_offset=pad_offset,
                            window=window, scale=scale)


def checked_pool_cast(pool: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """``values`` in ``pool.dtype``, refusing raw floats into an integer
    (quantized) pool: a bare cast would truncate activations to garbage
    with no scale. The quantized writes scale first and never come
    here."""
    if not pool.dtype.is_floating_point and values.dtype.is_floating_point:
        raise TypeError(
            f"raw write of {values.dtype} values into a quantized "
            f"{pool.dtype} KV pool — use the quantized_* ops, which "
            f"scale per page/head before narrowing")
    return values.to(pool.dtype)


def paged_append_token(pool: torch.Tensor, new: torch.Tensor,
                       block_tables: torch.Tensor, pos: torch.Tensor,
                       page_len: int) -> torch.Tensor:
    """Scatter one decode step's K (or V) rows ``new`` (``(b, kv, d)``)
    into their pages, in place: row ``i`` lands at
    ``pool[block_tables[i, pos[i] // page_len], pos[i] % page_len]``.
    Returns ``pool``.

    The page column is clamped into the table's width, as the JAX
    package's gather clamps it: a retired lane keeps its position while
    the session slices the tables to the live streams' width, and its
    row (all trash page 0) then lands in page 0 instead of indexing
    past the slice (a device-side assert on the card)."""
    rows = torch.arange(new.shape[0], device=new.device)
    page = block_tables[rows, _page_column(pos, page_len, block_tables)]
    pool[page, pos % page_len] = checked_pool_cast(pool, new)
    return pool


def _page_column(pos: torch.Tensor, page_len: int,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """``pos // page_len`` clamped into ``block_tables``' columns."""
    return torch.clamp(pos // page_len, max=block_tables.shape[1] - 1)


def paged_prefill_write(pool: torch.Tensor, kv_rows: torch.Tensor,
                        page_ids: torch.Tensor,
                        start_row: int) -> torch.Tensor:
    """Write a prefill's prompt K (or V) rows into pages, in place: rows
    ``[start_row, start_row + n * page_len)`` of ``kv_rows`` (``(L, kv,
    d)``) as ``n = len(page_ids)`` page chunks to ``pool[page_ids]``.
    Shared prefix pages are not in ``page_ids`` and are never rewritten.
    Returns ``pool``."""
    n = page_ids.shape[0]
    page_len = pool.shape[1]
    chunk = kv_rows[start_row:start_row + n * page_len]
    chunk = chunk.reshape((n, page_len) + tuple(kv_rows.shape[1:]))
    pool[page_ids] = checked_pool_cast(pool, chunk)
    return pool


# ---------------------------------------------------------------------------
# Quantized paged KV: int8 pages and a (pages, kv) float32 scale pool, one
# symmetric scale per page per KV head. Dequantization runs in the bounded
# gather, so only the gathered working set exists in float, and the
# dequantized rows go through decode_attention's reduction.

_QUANT_EPS = 1e-8


def quantize_kv_pages(pages: torch.Tensor, eps: float = _QUANT_EPS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of ``(n, page_len, kv, d)`` pages:
    ``(q int8, scales (n, kv) float32)`` with ``scale = max(amax / 127,
    eps)`` over each page's ``(page_len, d)`` plane per KV head. It
    divides by the scale and rounds half to even, as the JAX package
    does, so both give the same int8 values; all-zero pages round-trip
    to exact zeros."""
    f = pages.float()
    amax = f.abs().amax(dim=(1, 3))
    scales = torch.clamp(amax / 127.0, min=eps)
    scaled = f / scales[:, None, :, None]
    q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    return q, scales


def dequantize_kv_pages(q: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_pages`: float32 pages."""
    return q.float() * scales[:, None, :, None]


def quantized_paged_prefill_write(pool: torch.Tensor, scales: torch.Tensor,
                                  kv_rows: torch.Tensor,
                                  page_ids: torch.Tensor, start_row: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`paged_prefill_write` into an int8 pool: the page chunks are
    quantized and their values and scales written to ``page_ids``, in
    place. Rows past the prompt are exact zeros (the prefill cache starts
    at zero), so a partial last page's scale reflects its live rows."""
    n = page_ids.shape[0]
    page_len = pool.shape[1]
    chunk = kv_rows[start_row:start_row + n * page_len]
    chunk = chunk.reshape((n, page_len) + tuple(kv_rows.shape[1:]))
    q, s = quantize_kv_pages(chunk)
    pool[page_ids] = q
    scales[page_ids] = s
    return pool, scales


def quantized_paged_append_token(pool: torch.Tensor, scales: torch.Tensor,
                                 new: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 pos: torch.Tensor, page_len: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`paged_append_token` into an int8 pool, requantizing the
    touched page in place: each stream's page is dequantized, masked to
    its live rows (``row < pos % page_len``: a reused page may carry a
    previous stream's rows), given the new row and quantized again. Rows
    of retired streams all point at the trash page 0, which is never read
    unmasked, so which duplicate write wins there does not matter; the
    page column is clamped as in :func:`paged_append_token`."""
    rows = torch.arange(new.shape[0], device=new.device)
    page = block_tables[rows, _page_column(pos, page_len, block_tables)]
    slot = pos % page_len
    cur = dequantize_kv_pages(pool[page], scales[page])
    live = torch.arange(page_len, device=new.device)[None, :, None, None] \
        < slot[:, None, None, None]
    cur = torch.where(live, cur, 0.0)
    cur[rows, slot] = new.float()
    q, s = quantize_kv_pages(cur)
    pool[page] = q
    scales[page] = s
    return pool, scales


def quantized_paged_decode_attention(
        q: torch.Tensor, k_pool: torch.Tensor, k_scales: torch.Tensor,
        v_pool: torch.Tensor, v_scales: torch.Tensor,
        block_tables: torch.Tensor, col: torch.Tensor, *,
        pad_offset: Optional[torch.Tensor] = None, window: int = 0,
        scale: Optional[float] = None, max_pages: int = 0) -> torch.Tensor:
    """:func:`paged_decode_attention` over int8 pools: pages and their
    scales are gathered together, multiplied out into the ``(b, width *
    page_len, kv, d)`` float32 working set and fed through
    :func:`decode_attention`. No pool-sized float copy exists."""
    if max_pages and max_pages < block_tables.shape[1]:
        block_tables = block_tables[:, :max_pages]
    return decode_attention(q, _dequantized_pages(k_pool, k_scales,
                                                  block_tables),
                            _dequantized_pages(v_pool, v_scales,
                                               block_tables), col,
                            pad_offset=pad_offset, window=window,
                            scale=scale)


def _dequantized_pages(pool: torch.Tensor, scales: torch.Tensor,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """The pages of ``block_tables`` (``(b, n)``) and their scales,
    gathered together and multiplied out: ``(b, n * page_len, kv, d)``
    float32."""
    b, n_pages = block_tables.shape
    page_len, kv, d = pool.shape[1], pool.shape[2], pool.shape[3]
    deq = pool[block_tables].float() * \
        scales[block_tables][:, :, None, :, None]
    return deq.reshape(b, n_pages * page_len, kv, d)


# ---------------------------------------------------------------------------
# Speculative-decode verify: k + 1 positions per paged step (the last
# accepted token and k drafts). The appends are the sequential one-token
# writes, in order, and each query position runs decode_attention's
# reduction at its own ``col + j`` over pages gathered once: positions
# past a query's col are masked as an unwritten row would be, so query j
# cannot see drafts j + 1..k, and rejected drafts need no rollback (their
# rows sit past the new col until the next window overwrites them).


def _window_pages(block_tables: torch.Tensor, p: torch.Tensor,
                  page_len: int, limit: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """The page position ``p`` of each row lands in: its block-table
    column clamped into the table's width, and trash page 0 past
    ``limit``."""
    rows = torch.arange(block_tables.shape[0], device=block_tables.device)
    page = block_tables[rows, _page_column(p, page_len, block_tables)]
    if limit is not None:
        page = torch.where(p <= limit, page, torch.zeros_like(page))
    return page


def paged_append_tokens(pool: torch.Tensor, new: torch.Tensor,
                        block_tables: torch.Tensor, pos: torch.Tensor,
                        page_len: int,
                        limit: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Scatter ``s`` consecutive positions' K (or V) rows, in place:
    ``new`` is ``(b, s, kv, d)`` and row ``i``'s position ``j`` lands
    where :func:`paged_append_token` at ``pos[i] + j`` would put it.
    ``limit`` (``(b,)``) is each stream's last funded position: writes
    past it go to trash page 0, so a window near the end of a stream's
    pages neither writes another stream's pages nor leaves its table
    row. Returns ``pool``."""
    for j in range(new.shape[1]):
        p = pos + j
        page = _window_pages(block_tables, p, page_len, limit)
        pool[page, p % page_len] = checked_pool_cast(pool, new[:, j])
    return pool


def _verify_reduction(q, k, v, col, pad_offset, window, scale):
    """:func:`decode_attention` for each of ``q``'s ``s`` positions, query
    ``j`` at ``col + j``, over one gathered ``k``/``v``."""
    outs = [decode_attention(q[:, j:j + 1], k, v, col + j,
                             pad_offset=pad_offset, window=window,
                             scale=scale)
            for j in range(q.shape[1])]
    return torch.cat(outs, dim=1)


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor,
                           block_tables: torch.Tensor, col: torch.Tensor, *,
                           pad_offset: Optional[torch.Tensor] = None,
                           window: int = 0, scale: Optional[float] = None,
                           max_pages: int = 0) -> torch.Tensor:
    """:func:`paged_decode_attention` for ``s`` query positions at once:
    ``q`` is ``(b, s, n_heads, d)`` and query ``j`` attends ``[0, col +
    j]``. The pages are gathered once and each position runs the
    single-token reduction, so position ``j``'s output is a sequential
    step's at ``col + j``."""
    if max_pages and max_pages < block_tables.shape[1]:
        block_tables = block_tables[:, :max_pages]
    b, n_pages = block_tables.shape
    page_len, kv, d = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    k = k_pool[block_tables].reshape(b, n_pages * page_len, kv, d)
    v = v_pool[block_tables].reshape(b, n_pages * page_len, kv, d)
    return _verify_reduction(q, k, v, col, pad_offset, window, scale)


def quantized_paged_append_tokens(pool: torch.Tensor, scales: torch.Tensor,
                                  new: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  pos: torch.Tensor, page_len: int,
                                  limit: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`paged_append_tokens` into an int8 pool: the ``s`` rows are
    appended one after another through
    :func:`quantized_paged_append_token` (each append requantizes its
    page against the live rows, as the one-token path does), writes past
    ``limit`` to trash page 0."""
    for j in range(new.shape[1]):
        p = pos + j
        page = _window_pages(block_tables, p, page_len, limit)
        # a one-column table whose only column is the resolved page
        quantized_paged_append_token(pool, scales, new[:, j], page[:, None],
                                     p % page_len, page_len)
    return pool, scales


def quantized_paged_verify_attention(
        q: torch.Tensor, k_pool: torch.Tensor, k_scales: torch.Tensor,
        v_pool: torch.Tensor, v_scales: torch.Tensor,
        block_tables: torch.Tensor, col: torch.Tensor, *,
        pad_offset: Optional[torch.Tensor] = None, window: int = 0,
        scale: Optional[float] = None, max_pages: int = 0) -> torch.Tensor:
    """:func:`paged_verify_attention` over int8 pools: one dequantizing
    gather shared by all ``s`` query positions."""
    if max_pages and max_pages < block_tables.shape[1]:
        block_tables = block_tables[:, :max_pages]
    return _verify_reduction(
        q, _dequantized_pages(k_pool, k_scales, block_tables),
        _dequantized_pages(v_pool, v_scales, block_tables), col,
        pad_offset, window, scale)
