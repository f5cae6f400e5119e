"""Attention ops of the PyTorch port.

Counterpart of :mod:`learningorchestra_tpu.ops.attention`, in the same
``(batch, seq, heads, head_dim)`` layout with ``k``/``v`` at ``kv``
heads, ``kv | heads``.

- :func:`flash_attention` / :func:`flash_attention_with_lse` run the
  hand-written CUDA kernel ``csrc/flash_fwd.cu`` (the port of the TPU
  ``_fwd_kernel``) on a CUDA tensor, and its plain PyTorch version
  :func:`flash_attention_reference` on a CPU tensor. A CUDA tensor never
  falls back to the plain version: the kernel launches or the call
  raises. Only the forward exists in this package so far.
- :func:`full_attention_reference` is the ``dot`` implementation.
- :func:`decode_attention` is the serving plane's single-token op, left
  as plain tensor ops exactly as the JAX package left it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

# launches of the flash_fwd kernel (CPU calls never count)
FLASH_FWD_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


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


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = False,
                              scale: Optional[float] = None,
                              window: int = 0, kv_offset: int = 0,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash kernel: ``(o, lse)`` with the kernel's
    masking. Key ``col`` is visible to query ``row`` when ``col < sk``,
    ``row >= col + kv_offset`` (causal) and ``col + kv_offset > row -
    window`` (window > 0). A row with no visible key gets ``o = 0`` and
    ``lse = NEG_INF``. Computed in float32; ``o`` in q's dtype."""
    _check_args(q, k, v, causal, window)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qg = q.float().reshape(b, sq, kvh, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    row = torch.arange(sq, device=q.device)[:, None]
    col = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (row >= col + kv_offset)
    if window > 0:
        valid = valid & (col + kv_offset > row - window)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()) \
        / safe_l.permute(0, 3, 1, 2, 4)
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)[..., 0]
    return (o.reshape(b, sq, h, d).to(q.dtype),
            lse.permute(0, 3, 1, 2).reshape(b, sq, h))


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float, window: int,
                    offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    global FLASH_FWD_LAUNCHES
    from learningorchestra_tpu_torch.ops import _build

    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd needs contiguous tensors; {name} "
                             f"is not")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_fwd takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd takes head_dim <= {_MAX_HEAD_DIM}, "
                         f"got {d}")
    if b * h > 65535:
        raise ValueError(f"flash_fwd takes batch * heads <= 65535, got "
                         f"{b * h}")
    fn = _build.load("flash_fwd").lo_flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    o = torch.empty_like(q)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, sq, sk, h, kvh, d, float(scale),
                 int(bool(causal)), int(window), int(offset),
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    FLASH_FWD_LAUNCHES += 1
    return o, lse


def _flash_fwd(q, k, v, causal: bool, scale: Optional[float], window: int,
               offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_args(q, k, v, causal, window)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         scale=scale, window=window,
                                         kv_offset=offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return _flash_fwd_cuda(q, k, v, causal, scale, window, offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Fused attention over ``(b, s, h, d)`` tensors, GQA-native: ``k``
    and ``v`` may carry fewer heads than ``q`` (``kv | h``) and are never
    repeated to ``h`` heads. ``window=W`` (requires ``causal``) lets
    query p attend keys in ``[p-W+1, p]``."""
    if window and not causal:
        raise ValueError("window requires causal=True (banded causal "
                         "attention)")
    return _flash_fwd(q, k, v, causal, scale, window, 0)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = False,
                             scale: Optional[float] = None,
                             window: int = 0, kv_offset: int = 0,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (b, sq, h, d), lse (b, sq, h))``: the blockwise form ring
    attention merges across devices. ``kv_offset`` shifts key positions
    (``col + kv_offset``)."""
    h = q.shape[2]
    if k.shape[2] != h:
        raise ValueError(
            f"flash_attention_with_lse needs equal head counts "
            f"(q has {h}, k/v have {k.shape[2]}) — repeat K/V to "
            f"full heads first; grouped GQA is flash_attention only")
    return _flash_fwd(q, k, v, causal, scale, window, kv_offset)


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
