"""Mixture-of-experts feed-forward of the PyTorch port.

Counterpart of :mod:`learningorchestra_tpu.parallel.moe` on one card.
Two dispatch schedules with the same routing (top-k over the softmax of
the router logits, gate weights renormalized over the k choices, one
per-expert capacity shared by all choices, choice 0 first and then
token order):

- ``route="sparse"`` (the default): the ``k·T`` token copies are sorted
  stably by expert, choice-major, and each copy's slot in its expert's
  ``(capacity, d)`` buffer is its rank within that expert. Dispatch and
  combine are one ``index_add`` each; no ``(T, E, C)`` tensor exists.
- ``route="dense"``: the GShard ``(T, E, C)`` one-hot dispatch and
  combine tensors, kept for parity checks at small shapes.

Params, in the flax layout (stored as they are, not transposed):
``gate`` ``(d_model, n_experts)``, ``experts/wi`` ``(n_experts, d_model,
d_ff)`` and ``experts/wo`` ``(n_experts, d_ff, d_model)``. The experts
are ungated GELU (tanh) FFNs. Their products run in the tokens' dtype
with float32 results, as the JAX einsums with
``preferred_element_type=float32`` give them: the GELU runs on the
float32 product before the cast back. On the CPU the bf16 operands are
upcast (exactly) and multiplied in float32, forward and backward, as
the JAX package multiplies them. On the card a bf16 pair takes ``bmm``
with a float32 output; its backward rounds the float32 cotangent to bf16
before the two bf16 products, as every other bf16 product of the port's
training does (the JAX package multiplies it in float32; the bf16
tolerances cover it).

Determinism: in the sparse route every expert slot receives at most one
kept copy (the dropped copies add zeros) and every token receives
exactly ``k`` combine copies, so with ``k <= 2`` the scatter-adds, and
the index_adds of the gathers' backward, give the same bits in any
order (``a + b == b + a``). With ``k > 2`` the order of the adds of a
token's copies can change the last bit from run to run on the card.

Over a mesh (a sharded fit's step, or ``mesh=``) the layer is the JAX
layer under GSPMD, computed by the ranks' blocks:

- routing is global: the capacity counts the mesh's tokens, each copy's
  place in its expert follows the copies of earlier choices and of
  earlier global token ids on every row block (an all-gather of the
  ``(T, k)`` expert indices, int32, over the row group), and the Switch
  loss takes the global means (one all-reduce of the top-1 counts and
  the probability sums, its gradient each block's own part, which the
  engine sums);
- expert parallelism: ``experts/wi`` is ``(E/ep, d, d_ff/tp)`` and
  ``experts/wo`` ``(E/ep, d_ff/tp, d)`` on a rank, the tokens are
  replicated over ``ep`` and ``tp``, each rank runs its experts' block
  of the expert buffer on its block of ``d_ff``, and the combine sums
  over the ``ep`` by ``tp`` group (Megatron's ``g``); the tokens and
  gate weights entering the experts take the matching ``f``.

A rank's expert buffer holds its own block's copies, each at its place
among that block's copies of its expert (the kept copies of an expert
are a prefix of them, so ``min(capacity, T_block)`` rows an expert do).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from learningorchestra_tpu_torch.runtime import distributed as dist
from learningorchestra_tpu_torch.runtime import mesh as mesh_lib


def init_moe_params(seed: int, d_model: int, d_ff: int, n_experts: int,
                    dtype=torch.float32) -> Dict[str, Any]:
    """Random params with the JAX package's scales (normal, standard
    deviation ``1/sqrt(fan_in)``), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        x = rng.standard_normal(shape, dtype=np.float32) \
            / np.float32(math.sqrt(fan_in))
        return torch.from_numpy(x).to(dtype)

    return {
        "gate": normal((d_model, n_experts), d_model),
        "experts": {
            "wi": normal((n_experts, d_model, d_ff), d_model),
            "wo": normal((n_experts, d_ff, d_model), d_ff),
        },
    }


def stable_top_k(values: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    top, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


def _topk_renorm(logits: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router head both schedules share: softmax, top-k, the gate
    weights renormalized over the k choices, and the Switch load-balance
    loss ``E * mean(frac_tokens * mean_prob)`` over the first choice.
    Returns ``(gate_idx (T, k), gate_vals (T, k), aux)``."""
    e = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = stable_top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    top1 = F.one_hot(gate_idx[:, 0], e).float()
    aux = e * torch.mean(top1.mean(dim=0) * probs.mean(dim=0))
    return gate_idx, gate_vals, aux


def top_k_gating(logits: torch.Tensor, k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense schedule: ``(dispatch (T, E, C) {0, 1}, combine (T, E,
    C) weights, aux)`` from router logits ``(T, E)``."""
    t, e = logits.shape
    gate_idx, gate_vals, aux = _topk_renorm(logits, k)
    dev = logits.device
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32,
                           device=dev)
    combine = torch.zeros_like(dispatch)
    # the expert fill carries across the k choices: capacity is shared
    fill = torch.zeros((e,), dtype=torch.long, device=dev)
    for choice in range(k):
        idx = gate_idx[:, choice]
        onehot = F.one_hot(idx, e)
        pos_in_e = (torch.cumsum(onehot, dim=0) - 1) + fill[None, :]
        fill = fill + onehot.sum(dim=0)
        pos = (pos_in_e * onehot).sum(dim=-1)
        keep = pos < capacity
        pos = torch.clamp(pos, 0, capacity - 1)
        hot = F.one_hot(idx, e).float()[:, :, None] * \
            F.one_hot(pos, capacity).float()[:, None, :]
        hot = hot * keep[:, None, None].float()
        dispatch = dispatch + hot
        combine = combine + hot * gate_vals[:, choice, None, None]
    return dispatch, combine, aux


def sparse_route(gate_idx: torch.Tensor, gate_vals: torch.Tensor, e: int,
                 capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """The sort/segment routing plan: ``(tok, slot, keep, w)``, each
    ``(T·k,)`` in expert-sorted order: each copy's source token, its
    flat index into the ``(E·C, d)`` expert buffer (clamped for dropped
    copies), the capacity mask and the gate weight. The stable
    choice-major sort gives the dense schedule's priority exactly."""
    t, k = gate_idx.shape
    dev = gate_idx.device
    flat_e = gate_idx.t().reshape(-1)
    flat_w = gate_vals.t().reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat(k)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    # each expert's first index in the sorted copies
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(k * t, device=dev) - starts[se]
    keep = pos < capacity
    slot = se * capacity + torch.clamp(pos, 0, capacity - 1)
    return flat_tok[order], slot, keep, flat_w.index_select(0, order)


class _Bf16BmmF32(torch.autograd.Function):
    """bf16 ``a @ b`` batched with a float32 result (``bmm``'s
    ``out_dtype``, for which torch registers no derivative); the
    backward's products take the cotangent in bf16."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = grad.to(a.dtype)
        grad_a = torch.bmm(grad, b.transpose(1, 2)) \
            if ctx.needs_input_grad[0] else None
        grad_b = torch.bmm(a.transpose(1, 2), grad) \
            if ctx.needs_input_grad[1] else None
        return grad_a, grad_b


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, with a float32 result from operands of any
    float dtype: ``einsum(..., preferred_element_type=float32)``. A bf16
    pair on the card takes ``bmm`` with ``out_dtype``; otherwise the
    operands are upcast, which is exact, and multiplied in float32 (the
    CPU build has no ``out_dtype`` kernel)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return _Bf16BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def moe_layer(params: Dict[str, Any], x: torch.Tensor, *, k: int = 2,
              capacity_factor: float = 1.25, mesh=None,
              route: str = "sparse",
              stats: Optional[Dict[str, Any]] = None,
              d_ff: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` ``(..., d_model)`` -> ``(same shape and dtype, aux)``. The
    capacity counts every token of ``x``: ``max(1, int(capacity_factor
    · k · T / E))``; over a mesh, every token of the mesh. ``mesh`` is a
    :class:`~..runtime.mesh.Mesh` or this rank's
    :class:`~..runtime.mesh.Shard` of one; by default the running
    step's shard, if any. ``d_ff`` is the experts' whole width, where
    ``experts/wi`` may hold this rank's block of it (None: it is whole).
    With ``stats`` (a dict) the count of dropped copies and of all
    copies is added under ``"dropped"`` and ``"copies"`` (this
    block's)."""
    if route not in ("sparse", "dense"):
        raise ValueError(f"unknown MoE route {route!r} (sparse|dense)")
    shard = _placement(mesh)
    if shard is not None and (shard.row_group is not None
                              or shard.model_group is not None):
        if route != "sparse":
            raise ValueError("a MoE layer over a mesh routes sparse")
        return _moe_sharded(params, x, shard, k, capacity_factor, stats,
                            d_ff)
    orig_shape = x.shape
    d = orig_shape[-1]
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    dtype = tokens.dtype
    gate = params["gate"]
    wi, wo = params["experts"]["wi"], params["experts"]["wo"]
    e = gate.shape[-1]
    capacity = max(1, int(capacity_factor * k * t / e))

    logits = tokens @ gate.to(dtype)
    if route == "sparse":
        gate_idx, gate_vals, aux = _topk_renorm(logits, k)
        tok, slot, keep, w = sparse_route(gate_idx, gate_vals, e, capacity)
        # index_select, not tokens[tok]: its backward is an index_add,
        # where advanced indexing's sorts its indices first (~6 ms a
        # layer and micro-batch of the tutorial's MoE fit on the card)
        copies = tokens.index_select(0, tok) * keep[:, None].to(dtype)
        expert_in = torch.zeros((e * capacity, d), dtype=dtype,
                                device=x.device).index_add(0, slot, copies)
        expert_in = expert_in.reshape(e, capacity, d)
    else:
        dispatch, combine, aux = top_k_gating(logits, k, capacity)
        keep = dispatch.sum(dim=(1, 2)) if stats is not None else None
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(dtype), tokens)
    if stats is not None:
        kept = int(keep.sum())
        stats["copies"] = stats.get("copies", 0) + k * t
        stats["dropped"] = stats.get("dropped", 0) + k * t - kept

    h = F.gelu(_bmm_f32(expert_in, wi.to(dtype)), approximate="tanh")
    expert_out = _bmm_f32(h.to(dtype), wo.to(dtype))

    if route == "sparse":
        picked = expert_out.reshape(e * capacity, d).index_select(0, slot)
        picked = picked * (w * keep.float())[:, None]
        out = torch.zeros((t, d), dtype=torch.float32,
                          device=x.device).index_add(0, tok, picked)
    else:
        out = torch.einsum("tec,ecd->td", combine, expert_out)
    return out.reshape(orig_shape).to(x.dtype), aux


# ----------------------------------------------------------------------
# over a mesh
# ----------------------------------------------------------------------
def _placement(mesh) -> Optional[mesh_lib.Shard]:
    """This rank's shard of ``mesh`` (a Mesh or a Shard), or the running
    step's when ``mesh`` is None."""
    if mesh is None:
        return mesh_lib.current_shard()
    if isinstance(mesh, mesh_lib.Shard):
        return mesh
    if isinstance(mesh, mesh_lib.Mesh):
        running = mesh_lib.current_shard()
        if running is not None and running.mesh == mesh:
            return running
        return mesh_lib.Shard(mesh, dist.rank(), seq_parallel=False)
    raise ValueError(f"mesh must be a Mesh or a Shard, got "
                     f"{type(mesh).__name__}")


def _global_ids(shard: mesh_lib.Shard, block: Tuple[int, int], b: int,
                s: int, device) -> torch.Tensor:
    """The global token ids of a ``(b, s)`` block's tokens, row-major over
    the mesh's ``(b · data_size, s · seq_size)`` batch."""
    di, si = block
    rows = di * b + torch.arange(b, device=device)
    cols = si * s + torch.arange(s, device=device)
    return (rows[:, None] * (s * shard.seq_size) + cols[None, :]).reshape(-1)


def _global_positions(gate_idx: torch.Tensor, shard: mesh_lib.Shard,
                      lead: Tuple[int, int], e: int) -> torch.Tensor:
    """``(k, T_block)``: each of this block's copies' place among all the
    mesh's copies of its expert, in the dense schedule's priority (choice
    0 first, then global token id). One all-gather of the indices."""
    t, k = gate_idx.shape
    b, s = lead
    dev = gate_idx.device
    parts = dist.all_gather(gate_idx.to(torch.int32), shard.row_group)
    members = sorted(zip(shard.row_ranks, shard.row_blocks))
    t_global = t * len(members)
    every = torch.empty((t_global, k), dtype=torch.long, device=dev)
    mine = None
    for part, (r, block) in zip(parts, members):
        ids = _global_ids(shard, block, b, s, dev)
        every[ids] = part.long()
        if r == shard.rank:
            mine = ids
    flat_e = every.t().reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(k * t_global, device=dev) - starts[se]
    return pos.view(k, t_global)[:, mine]


def _expert_group(shard: mesh_lib.Shard, split_ep: bool, split_tp: bool):
    """The group the expert combine sums over: the axes that split this
    layer's experts."""
    if split_ep and split_tp:
        return shard.model_group
    if split_ep:
        return shard.ep_group
    return shard.tp_group if split_tp else None


def _moe_sharded(params: Dict[str, Any], x: torch.Tensor,
                 shard: mesh_lib.Shard, k: int, capacity_factor: float,
                 stats: Optional[Dict[str, Any]],
                 d_ff: Optional[int] = None):
    """:func:`moe_layer` on this rank's block of a mesh (the module
    docstring's plan)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    lead = (orig_shape[0], int(np.prod(orig_shape[1:-1]))) \
        if len(orig_shape) > 2 else (orig_shape[0], 1)
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    dtype = tokens.dtype
    dev = x.device
    gate = params["gate"]
    wi, wo = params["experts"]["wi"], params["experts"]["wo"]
    e = gate.shape[-1]
    e_loc = wi.shape[0]
    # this rank's experts: its ep block when the experts are split
    e0 = shard.ep_index * e_loc if e_loc < e else 0
    t_global = t * shard.row_size
    capacity = max(1, int(capacity_factor * k * t_global / e))
    rows = min(capacity, t)

    logits = tokens @ gate.to(dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = stable_top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    # the Switch loss over the mesh's tokens
    both = torch.cat([F.one_hot(gate_idx[:, 0], e).float().sum(dim=0),
                      probs.sum(dim=0)])
    if shard.row_group is not None:
        both = dist.reduce_from(both, shard.row_group)
    aux = e * torch.mean((both[:e] / t_global) * (both[e:] / t_global))

    # a mesh without data blocks: the block is the mesh's tokens
    gpos = (_global_positions(gate_idx, shard, lead, e)
            if shard.row_group is not None else None)
    flat_e = gate_idx.t().reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat(k)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    local_pos = torch.arange(k * t, device=dev) - starts[se]
    if gpos is not None:
        keep = gpos.reshape(-1)[order] < capacity
    else:
        keep = local_pos < capacity
    if stats is not None:
        kept = int(keep.sum())
        stats["copies"] = stats.get("copies", 0) + k * t
        stats["dropped"] = stats.get("dropped", 0) + k * t - kept
    mine = (se >= e0) & (se < e0 + e_loc)
    keep = keep & mine
    slot = (se - e0).clamp(0, e_loc - 1) * rows + \
        local_pos.clamp(0, rows - 1)
    tok = flat_tok[order]
    group = _expert_group(shard, e_loc < e,
                          d_ff is not None and wi.shape[-1] < d_ff)
    if group is not None:
        tokens, gate_vals = dist.copy_to([tokens, gate_vals], group)
    w = gate_vals.t().reshape(-1).index_select(0, order)

    copies = tokens.index_select(0, tok) * keep[:, None].to(dtype)
    expert_in = torch.zeros((e_loc * rows, d), dtype=dtype,
                            device=dev).index_add(0, slot, copies)
    expert_in = expert_in.reshape(e_loc, rows, d)
    h = F.gelu(_bmm_f32(expert_in, wi.to(dtype)), approximate="tanh")
    expert_out = _bmm_f32(h.to(dtype), wo.to(dtype))
    picked = expert_out.reshape(e_loc * rows, d).index_select(0, slot)
    picked = picked * (w * keep.float())[:, None]
    out = torch.zeros((t, d), dtype=torch.float32,
                      device=dev).index_add(0, tok, picked)
    if group is not None:
        out = dist.reduce_from(out, group)
    return out.reshape(orig_shape).to(x.dtype), aux
