"""Ulysses sequence parallelism: an all-to-all head scatter.

Counterpart of :mod:`learningorchestra_tpu.parallel.ulysses`. Instead
of rotating K/V, two all-to-alls re-shard the blocks
(:func:`..runtime.distributed.all_to_all`, q, k and v in one message):
each rank gathers the whole sequence of ``heads / sp`` of the heads,
runs ordinary attention on them, and the reverse all-to-all gives it its
sequence block of every head back. On CUDA tensors the local call is the
port's :func:`..ops.attention.flash_attention`, GQA-native: K/V may carry
fewer heads, both counts divisible by ``sp``, and then move at their own
width. On the CPU it is the dense reference (K/V repeated).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch

from learningorchestra_tpu_torch.ops import attention as attn_ops
from learningorchestra_tpu_torch.parallel import ring as ring_lib
from learningorchestra_tpu_torch.runtime import distributed as dist


def _dense(ql, kl, vl, causal: bool, window: int, scale):
    if kl.shape[2] != ql.shape[2]:
        g = ql.shape[2] // kl.shape[2]
        kl = torch.repeat_interleave(kl, g, dim=2)
        vl = torch.repeat_interleave(vl, g, dim=2)
    return attn_ops.full_attention_reference(ql, kl, vl, causal=causal,
                                             window=window, scale=scale)


def _by_destination(x: torch.Tensor, n: int) -> torch.Tensor:
    """(b, s/n, H, d) -> (n, b, s/n, H/n, d): head chunk j for member j."""
    b, s_loc, heads, d = x.shape
    return x.reshape(b, s_loc, n, heads // n, d).permute(2, 0, 1, 3, 4)


def _whole_sequence(x: torch.Tensor) -> torch.Tensor:
    """(n, b, s/n, H/n, d), block j from member j -> (b, s, H/n, d)."""
    n, b, s_loc, heads, d = x.shape
    return x.permute(1, 0, 2, 3, 4).reshape(b, n * s_loc, heads, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ranks: Sequence[int], group, causal: bool = False,
                      window: int = 0, scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """q: the local block ``(b, s_local, heads, d)``; k/v may carry
    fewer (kv) heads, both counts divisible by ``len(ranks)``. Returns
    the local output block ``(b, s_local, heads, d)``."""
    n = len(ranks)
    h, kvh = q.shape[2], k.shape[2]
    if h % n:
        raise ValueError(f"heads {h} not divisible by sp={n}")
    if kvh != h and (h % kvh or kvh % n):
        raise ValueError(
            f"GQA kv heads {kvh} must divide query heads {h} and be "
            f"divisible by sp={n} (repeat K/V to full heads otherwise)")
    if attn_fn is None:
        if q.is_cuda:
            attn_fn = functools.partial(attn_ops.flash_attention,
                                        causal=causal, scale=scale,
                                        window=window)
        else:
            attn_fn = functools.partial(_dense, causal=causal,
                                        window=window, scale=scale)
    b, s_loc, _, d = q.shape
    qs, ks, vs = dist.all_to_all(
        (_by_destination(q, n), _by_destination(k, n),
         _by_destination(v, n)), group)
    out = attn_fn(_whole_sequence(qs), _whole_sequence(ks),
                  _whole_sequence(vs))
    # (b, s, h/n, d) -> sequence block j for member j
    blocks = out.reshape(b, n, s_loc, h // n, d).permute(1, 0, 2, 3, 4)
    (back,) = dist.all_to_all((blocks,), group)
    # back[j]: member j's head chunk of this rank's block
    return back.permute(1, 2, 0, 3, 4).reshape(b, s_loc, h, d)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mesh, causal: bool = False,
                              window: int = 0,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The rank's blocks over the ``sp`` ranks of ``mesh`` (a mesh or a
    step's shard)."""
    ranks, group = ring_lib.seq_group(mesh)
    return ulysses_attention(q, k, v, ranks, group, causal=causal,
                             window=window, scale=scale)
