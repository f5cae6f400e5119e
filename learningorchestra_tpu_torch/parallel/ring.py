"""Ring attention: sequence parallelism over the ``sp`` axis.

Counterpart of :mod:`learningorchestra_tpu.parallel.ring`. Each rank
holds one block of the sequence; its Q block stays while the K/V blocks
rotate around the ring (:func:`..runtime.distributed.ring_shift`, one
message of K and V a hop, the backward sending the gradients the other
way), and a running log-sum-exp keeps the softmax exact.

- :func:`ring_attention` is the dense ring (einsum tiles, an online
  softmax): the plain version, and the CPU's.
- :func:`ring_flash_attention` runs each hop through the port's flash
  kernels (:func:`..ops.attention.flash_attention_with_lse`): a causal
  ring attends the past unmasked, the diagonal causal and skips the
  future; with a window, one call per distance ``d`` at
  ``kv_offset = -d·sk``, skipped once ``d·sk >= window + sq - 1``. The
  hops merge exactly by their lse; autograd carries the merge's
  gradient into the backward kernels' ``delta`` through ``dlse``.
- :func:`ring_attention_sharded` takes the rank's blocks and its mesh
  (or the step's :class:`..runtime.mesh.Shard`) and picks the block:
  flash on CUDA, dense on the CPU (``block_impl="auto"``).

Both take equal head counts: a GQA caller repeats K/V first.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from learningorchestra_tpu_torch.ops import attention as attn_ops
from learningorchestra_tpu_torch.runtime import distributed as dist
from learningorchestra_tpu_torch.runtime import mesh as mesh_lib

NEG_INF = attn_ops.NEG_INF
full_attention_reference = attn_ops.full_attention_reference


def _block_attn(q, k, v, scale: float, mask):
    """One (q block x kv block) tile: ``(numerator, row max, row sum)``
    of this tile only. q: (b, sq, h, d), k/v: (b, sk, h, d), mask:
    (sq, sk) or None."""
    scores = torch.einsum("bqhd,bkhd->bqhk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask[None, :, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    if mask is not None:
        # rows with no visible key: exp(NEG_INF - NEG_INF) = 1 is junk
        any_visible = mask.any(dim=-1)
        p = torch.where(any_visible[None, :, None, None], p, 0.0)
        m = torch.where(any_visible[None, :, None], m, NEG_INF)
    num = torch.einsum("bqhk,bkhd->bqhd", p, v.float())
    return num, m, p.sum(dim=-1)


def _check(q, k, causal: bool, window: int) -> None:
    if window and not causal:
        raise ValueError("window requires causal=True")
    if k.shape[2] != q.shape[2]:
        raise ValueError(
            f"ring attention needs equal head counts (q has "
            f"{q.shape[2]}, k/v have {k.shape[2]}): repeat K/V first")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ranks: Sequence[int], group, causal: bool = False,
                   scale: Optional[float] = None,
                   window: int = 0) -> torch.Tensor:
    """Exact attention over a sequence split along ``ranks`` (this rank
    holds block ``ranks.index(rank)``): q/k/v are the local blocks
    ``(b, s_local, h, d)``. Returns the local output in q's dtype."""
    _check(q, k, causal, window)
    ranks = [int(r) for r in ranks]
    n = len(ranks)
    me = ranks.index(dist.rank())
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qf = q.float()
    q_pos = me * sq + torch.arange(sq, device=q.device)
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, sq, h), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, h), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for hop in range(n):
        # after `hop` rotations this rank holds the block that started
        # on member (me - hop) mod n
        kv_idx = (me - hop) % n
        attend, mask = True, None
        if causal:
            # blocks wholly in the future, or wholly below the window's
            # band, are fully masked: skip them
            attend = not (kv_idx * sk > me * sq + sq - 1 or (
                window > 0 and kv_idx * sk + sk - 1 < me * sq - window + 1))
            k_pos = kv_idx * sk + torch.arange(sk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            if window > 0:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        if attend:
            num, bm, bl = _block_attn(qf, k_blk.float(), v_blk, scale, mask)
            new_m = torch.maximum(m, bm)
            old_c = torch.exp(m - new_m)
            blk_c = torch.exp(bm - new_m)
            o = o * old_c[..., None] + num * blk_c[..., None]
            l = l * old_c + bl * blk_c
            m = new_m
        else:
            o = dist.tie(o, (k_blk, v_blk))
        if hop < n - 1:
            k_blk, v_blk = dist.ring_shift((k_blk, v_blk), ranks, group)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         ranks: Sequence[int], group, causal: bool = False,
                         scale: Optional[float] = None,
                         window: int = 0) -> torch.Tensor:
    """:func:`ring_attention` with the flash kernels as each hop's block
    (their plain version for CPU tensors). Equal blocks: every causal
    hop is fully past (unmasked), the diagonal (causal) or fully future
    (skipped); with a window, a hop at distance ``d`` is the kernel at
    ``kv_offset = -d·sk``."""
    _check(q, k, causal, window)
    ranks = [int(r) for r in ranks]
    n = len(ranks)
    me = ranks.index(dist.rank())
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if sk != sq:
        raise ValueError(f"ring_flash_attention needs equal blocks "
                         f"(sq={sq}, sk={sk})")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    o_acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    lse_acc = torch.full((b, sq, h), NEG_INF, dtype=torch.float32,
                         device=q.device)
    k_blk, v_blk = k, v
    for hop in range(n):
        kv_idx = (me - hop) % n
        call = None
        if causal and window > 0:
            distance = me - kv_idx
            if 0 <= distance and distance * sk < window + sq - 1:
                call = dict(causal=True, window=window,
                            kv_offset=-distance * sk)
        elif causal:
            if kv_idx <= me:
                call = dict(causal=kv_idx == me)
        else:
            call = dict(causal=False)
        if call is not None:
            o_hop, lse_hop = attn_ops.flash_attention_with_lse(
                q, k_blk, v_blk, scale=scale, **call)
            # a skipped hop has lse NEG_INF: weight 0 in the merge, so
            # it is left out (hop 0, the diagonal, always attends), but
            # its blocks stay in the graph: their rotation's backward
            # carries the neighbours' gradients
            new_lse = torch.logaddexp(lse_acc, lse_hop)
            w_acc = torch.exp(lse_acc - new_lse)
            w_hop = torch.exp(lse_hop - new_lse)
            o_acc = o_acc * w_acc[..., None] + \
                o_hop.float() * w_hop[..., None]
            lse_acc = new_lse
        else:
            o_acc = dist.tie(o_acc, (k_blk, v_blk))
        if hop < n - 1:
            k_blk, v_blk = dist.ring_shift((k_blk, v_blk), ranks, group)
    return o_acc.to(q.dtype)


def seq_group(where):
    """``(ranks, group)`` of this rank's ``sp`` block of ``where``, a
    :class:`~..runtime.mesh.Mesh` or a :class:`~..runtime.mesh.Shard`."""
    if isinstance(where, mesh_lib.Shard):
        return where.seq_ranks, where.seq_group
    if mesh_lib.SP not in where.axis_names:
        raise ValueError("mesh has no 'sp' axis")
    return (where.axis_ranks(mesh_lib.SP, dist.rank()),
            where.group(mesh_lib.SP))


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh, causal: bool = False,
                           scale: Optional[float] = None,
                           block_impl: str = "auto",
                           window: int = 0) -> torch.Tensor:
    """The rank's sequence blocks in, its output block out, over the
    ``sp`` ranks of ``mesh`` (a mesh or a step's shard). ``block_impl``:
    ``"dense"``, ``"flash"`` or ``"auto"`` (flash for CUDA tensors)."""
    ranks, group = seq_group(mesh)
    if block_impl == "auto":
        block_impl = "flash" if q.is_cuda else "dense"
    inner = {"flash": ring_flash_attention,
             "dense": ring_attention}[block_impl]
    return inner(q, k, v, ranks, group, causal=causal, scale=scale,
                 window=window)
