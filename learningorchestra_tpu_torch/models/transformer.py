"""Decoder-only transformer LM of the PyTorch port.

Counterpart of :mod:`learningorchestra_tpu.models.transformer` for the
serving and training paths: rotary position embeddings (half-split
rotation), RMSNorm as flax computes it, grouped-query attention with an
optional sliding window, a gated-SiLU MLP without bias or a mixture of
experts (:mod:`..parallel.moe`), fused projections, dropout, per-block
rematerialization, the next-token loss (with the chunked lm-head form
and the MoE load-balance term), LoRA adapters on the attention
projections, and :class:`LanguageModel` with
``fit``/``evaluate``/``predict``, ``generate`` (greedy, sampled or beam
search), ``enable_lora`` / ``merge_lora`` and the continuous-batching
serve functions over a slot cache or a shared page pool, with quantized
serving weights (:func:`serving_module`). The bidirectional encoder and
:class:`TextClassifier` live in :mod:`.encoder`.

Module and parameter names follow the flax tree (``layer_0.attn.q_proj``
for ``layer_0/attn/q_proj``) so :mod:`.weights` maps one onto the other.
The KV cache is a list of ``(k, v)`` tensors per layer, ``(b, cache_len,
kv_heads, head_dim)``, which the forward updates in place (JAX returns a
new cache; writing in place saves a copy of the whole cache per token).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from learningorchestra_tpu_torch.config import Config, resolve_device
from learningorchestra_tpu_torch.models import weights as weights_lib
from learningorchestra_tpu_torch.models.neural import (
    History, build_optimizer, is_adapter, validation_tail_count)
from learningorchestra_tpu_torch.ops import attention as attn_ops
from learningorchestra_tpu_torch.parallel import moe as moe_lib
from learningorchestra_tpu_torch.runtime import checkpoint as ckpt_lib
from learningorchestra_tpu_torch.runtime import data as data_lib
from learningorchestra_tpu_torch.runtime import engine as engine_lib

ATTENTION_IMPLS = ("dot", "flash")
NEG_INF = attn_ops.NEG_INF

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


# ----------------------------------------------------------------------
# rotary position embeddings
# ----------------------------------------------------------------------
def _rope_freqs(head_dim: int, base: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (base ** (torch.arange(half, dtype=torch.float32,
                                        device=device) / half))


def rope_tables(seq_len: int, head_dim: int, base: float = 10000.0,
                offset: int = 0, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    freqs = _rope_freqs(head_dim, base, device)
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)
    ang = pos[:, None] * freqs[None, :]                    # (s, half)
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, c: torch.Tensor,
            s: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of the pairs (x[:half], x[half:]) with cos
    and sin already broadcastable to ``x``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = c.to(x.dtype), s.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, d) with d even; cos/sin: (s, d/2)."""
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


# ----------------------------------------------------------------------
# modules
# ----------------------------------------------------------------------
class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: x * rsqrt(mean(x^2) + 1e-6) * scale over the
    last axis (``torch.nn.RMSNorm`` defaults to another epsilon). As in
    flax, the statistics and the product run in float32 whatever x's
    dtype, and the result takes the dtype of x and scale."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * (torch.rsqrt(ms + self.eps) * self.scale.float())
        return y.to(torch.promote_types(x.dtype, self.scale.dtype))


def _dropout(x: torch.Tensor, rate: float,
             generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scaled by
    1 / (1 - rate), from the step's own generator."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, 0.0)


def _dispatch_attention(q, k, v, *, impl: str, causal: bool,
                        window: int = 0, kv_valid=None):
    """q: (b, s, h, d); k/v may carry fewer (kv) heads under GQA. The
    flash kernel consumes them natively; the dense path repeats K/V up
    to h heads first. ``kv_valid`` (padded-batch prefill) always routes
    to the dense path: the kernel takes no per-row mask."""
    group = q.shape[2] // k.shape[2]

    def repeated():
        if group == 1:
            return k, v
        return (torch.repeat_interleave(k, group, dim=2),
                torch.repeat_interleave(v, group, dim=2))

    if kv_valid is None and impl == "flash":
        return attn_ops.flash_attention(q, k, v, causal=causal,
                                        window=window)
    kr, vr = repeated()
    return attn_ops.full_attention_reference(q, kr, vr, causal=causal,
                                             window=window,
                                             kv_valid=kv_valid)


class LoRALinear(nn.Linear):
    """A bias-free linear with an additive low-rank adapter, the JAX
    package's ``_LoRADense``: y = xW + (xA)B·α/r, with A ``(in, r)`` and
    B ``(r, out)`` cast to x's dtype and the scale rounded to it. B
    starts at zero, so an adapter leaves the base model's output as it
    was."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float):
        super().__init__(in_features, out_features, bias=False)
        self.rank = rank
        self.alpha = alpha
        self.lora_a = nn.Parameter(torch.zeros(in_features, rank))
        self.lora_b = nn.Parameter(torch.zeros(rank, out_features))
        self._scales: Dict[torch.dtype, float] = {}

    def _scale(self, dtype: torch.dtype) -> float:
        if dtype not in self._scales:
            self._scales[dtype] = float(torch.tensor(
                self.alpha / self.rank).to(dtype))
        return self._scales[dtype]

    def adapter(self, x):
        low = (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype)
        return low * self._scale(x.dtype)

    def forward(self, x):
        return F.linear(x, self.weight) + self.adapter(x)


def _linear(d_in: int, d_out: int, lora_rank: int,
            lora_alpha: float) -> nn.Linear:
    if lora_rank > 0:
        return LoRALinear(d_in, d_out, lora_rank, lora_alpha)
    return nn.Linear(d_in, d_out, bias=False)


class Attention(nn.Module):
    """Multi-head attention with grouped-query KV heads (``n_kv_heads <
    n_heads``; 1 is MQA). Four branches, as in the JAX module: a
    prefill over the whole sequence, a single-token step at one scalar
    position for the whole batch (solo ``generate``), a per-row step
    where every row sits at its own position (the serving slots, or a
    left-padded batch), and the speculative verify step, several
    positions per row over the page pool."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int,
                 impl: str, causal: bool, n_kv_heads: int = 0,
                 window: int = 0, rope_base: float = 10000.0,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 fused_qkv: bool = False):
        super().__init__()
        self.n_heads = n_heads
        self.kv_heads = n_kv_heads or n_heads
        if n_heads % self.kv_heads:
            raise ValueError(f"n_kv_heads={self.kv_heads} must divide "
                             f"n_heads={n_heads}")
        self.head_dim = head_dim
        self.impl = impl
        self.causal = causal
        self.window = window
        self.rope_base = rope_base
        proj = n_heads * head_dim
        kv_proj = self.kv_heads * head_dim
        # one (d, 3·proj) product for q, k and v: MHA only, as in the JAX
        # module (under GQA the three widths differ)
        self.fused_qkv = fused_qkv and self.kv_heads == n_heads
        if self.fused_qkv:
            self.qkv_proj = _linear(d_model, 3 * proj, lora_rank,
                                    lora_alpha)
        else:
            self.q_proj = _linear(d_model, proj, lora_rank, lora_alpha)
            self.k_proj = _linear(d_model, kv_proj, lora_rank, lora_alpha)
            self.v_proj = _linear(d_model, kv_proj, lora_rank, lora_alpha)
        self.o_proj = _linear(proj, d_model, lora_rank, lora_alpha)

    def _angles(self, rel: torch.Tensor):
        freqs = _rope_freqs(self.head_dim, self.rope_base, rel.device)
        ang = rel.to(torch.float32)[..., None] * freqs
        return torch.cos(ang), torch.sin(ang)

    def forward(self, x, cache=None, decode_pos=None, pad_offset=None,
                block_tables=None, verify_limit=None):
        b, s, _ = x.shape
        hd = self.head_dim
        if self.fused_qkv:
            q, k, v = self.qkv_proj(x).chunk(3, dim=-1)
            # column slices of one product; rope copies q and k, and the
            # kernels take v's rows contiguous
            v = v.contiguous()
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = q.reshape(b, s, self.n_heads, hd)
        k = k.reshape(b, s, self.kv_heads, hd)
        v = v.reshape(b, s, self.kv_heads, hd)

        if decode_pos is not None and s > 1:
            # the speculative verify step: s consecutive positions per
            # row (the last accepted token and the drafts), query j at
            # col + j, over the page pool
            if block_tables is None:
                raise ValueError(
                    "multi-position decode (speculative verify) requires "
                    "the paged KV path (block_tables)")
            col = decode_pos
            rel = col if pad_offset is None else col - pad_offset
            # position by position, so each row's angles are the
            # single-step branch's bits
            angles = [self._angles(rel + j) for j in range(s)]
            c = torch.stack([a[0] for a in angles], dim=1)[:, :, None, :]
            si = torch.stack([a[1] for a in angles], dim=1)[:, :, None, :]
            q, k = _rotate(q, c, si), _rotate(k, c, si)
            o = self._paged_verify(q, k, v, cache, block_tables, col,
                                   pad_offset, verify_limit)
        elif decode_pos is not None:
            if isinstance(decode_pos, int) and pad_offset is None and \
                    block_tables is None:
                # one position for the whole batch
                ck, cv = cache
                cos, sin = self._angles(torch.full(
                    (1,), decode_pos, device=x.device))
                c, si = cos[:, None, None, :], sin[:, None, None, :]
                q, k = _rotate(q, c, si), _rotate(k, c, si)
                ck[:, decode_pos] = k[:, 0]
                cv[:, decode_pos] = v[:, 0]
                col = torch.full((b,), decode_pos, device=x.device)
                o = attn_ops.decode_attention(q, ck, cv, col,
                                              window=self.window)
            else:
                # every row at its own position; the arithmetic is the
                # scalar branch's, row by row, so a slot's output
                # follows a solo decode of the same request
                col = decode_pos if torch.is_tensor(decode_pos) else \
                    torch.full((b,), decode_pos, device=x.device)
                rel = col if pad_offset is None else col - pad_offset
                cos, sin = self._angles(rel)
                c, si = cos[:, None, None, :], sin[:, None, None, :]
                q, k = _rotate(q, c, si), _rotate(k, c, si)
                if block_tables is not None:
                    o = self._paged_decode(q, k, v, cache, block_tables,
                                           col, pad_offset)
                else:
                    ck, cv = cache
                    rows = torch.arange(b, device=x.device)
                    ck[rows, col] = k[:, 0]
                    cv[rows, col] = v[:, 0]
                    o = attn_ops.decode_attention(q, ck, cv, col,
                                                  pad_offset=pad_offset,
                                                  window=self.window)
        else:
            kv_valid = None
            if pad_offset is None:
                cos, sin = rope_tables(s, hd, base=self.rope_base,
                                       device=x.device)
                q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            else:
                # left-padded batch prefill: each row's rope position is
                # its content-relative index (negative over the pad
                # columns, which are masked and never read)
                pos = torch.arange(s, device=x.device)
                cos, sin = self._angles(pos[None, :] - pad_offset[:, None])
                c, si = cos[:, :, None, :], sin[:, :, None, :]
                q, k = _rotate(q, c, si), _rotate(k, c, si)
                kv_valid = pos[None, :] >= pad_offset[:, None]
            if cache is not None:
                ck, cv = cache
                ck[:, :s] = k
                cv[:, :s] = v
            o = _dispatch_attention(q, k, v, impl=self.impl,
                                    causal=self.causal, window=self.window,
                                    kv_valid=kv_valid)
        return self.o_proj(o.reshape(b, s, self.n_heads * hd))


    def _paged_verify(self, q, k, v, pool, block_tables, col, pad_offset,
                      limit):
        """:meth:`_paged_decode` for the verify step's ``s`` positions:
        the rows append in order (past ``limit`` to trash page 0) and
        each query position runs the one-token reduction."""
        page_len = pool[0].shape[1]
        if len(pool) == 4:
            kp, vp, ks, vs = pool
            attn_ops.quantized_paged_append_tokens(
                kp, ks, k, block_tables, col, page_len, limit=limit)
            attn_ops.quantized_paged_append_tokens(
                vp, vs, v, block_tables, col, page_len, limit=limit)
            return attn_ops.quantized_paged_verify_attention(
                q, kp, ks, vp, vs, block_tables, col,
                pad_offset=pad_offset, window=self.window)
        kp, vp = pool
        attn_ops.paged_append_tokens(kp, k, block_tables, col, page_len,
                                     limit=limit)
        attn_ops.paged_append_tokens(vp, v, block_tables, col, page_len,
                                     limit=limit)
        return attn_ops.paged_verify_attention(
            q, kp, vp, block_tables, col, pad_offset=pad_offset,
            window=self.window)

    def _paged_decode(self, q, k, v, pool, block_tables, col, pad_offset):
        """The serving step over the shared page pool: ``pool`` is this
        layer's ``(k, v)`` pages, or ``(k, v, k_scale, v_scale)`` for int8
        pages. Rope, the written rows, the reduction and the mask are the
        slot branch's; only the storage addressing differs. The gather
        width is ``block_tables.shape[1]``."""
        page_len = pool[0].shape[1]
        if len(pool) == 4:
            kp, vp, ks, vs = pool
            attn_ops.quantized_paged_append_token(
                kp, ks, k[:, 0], block_tables, col, page_len)
            attn_ops.quantized_paged_append_token(
                vp, vs, v[:, 0], block_tables, col, page_len)
            return attn_ops.quantized_paged_decode_attention(
                q, kp, ks, vp, vs, block_tables, col,
                pad_offset=pad_offset, window=self.window)
        kp, vp = pool
        attn_ops.paged_append_token(kp, k[:, 0], block_tables, col,
                                    page_len)
        attn_ops.paged_append_token(vp, v[:, 0], block_tables, col,
                                    page_len)
        return attn_ops.paged_decode_attention(
            q, kp, vp, block_tables, col, pad_offset=pad_offset,
            window=self.window)


class MLP(nn.Module):
    """Gated SiLU, no bias (flax names ``gate``, ``up_proj``,
    ``down_proj``; ``gate_up`` for the fused ``(d, 2·d_ff)`` product)."""

    def __init__(self, d_model: int, d_ff: int, fused_gate_up: bool = False):
        super().__init__()
        self.fused_gate_up = fused_gate_up
        if fused_gate_up:
            self.gate_up = nn.Linear(d_model, 2 * d_ff, bias=False)
        else:
            self.gate = nn.Linear(d_model, d_ff, bias=False)
            self.up_proj = nn.Linear(d_model, d_ff, bias=False)
        self.down_proj = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x):
        if self.fused_gate_up:
            gate, up = self.gate_up(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class Experts(nn.Module):
    """The stacked expert weights, at flax's ``moe/experts/{wi,wo}``:
    ``wi`` ``(n_experts, d_model, d_ff)``, ``wo`` ``(n_experts, d_ff,
    d_model)``, in the flax layout (not transposed)."""

    def __init__(self, n_experts: int, d_model: int, d_ff: int):
        super().__init__()
        self.wi = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.wo = nn.Parameter(torch.empty(n_experts, d_ff, d_model))


class MoE(nn.Module):
    """The mixture-of-experts feed-forward (:func:`moe_lib.moe_layer`,
    sparse route): router ``gate`` ``(d_model, n_experts)`` and
    :class:`Experts`. ``stats``, when set to a dict, collects the dropped
    and total copies of every call (a host sync each; off by default)."""

    def __init__(self, d_model: int, n_experts: int, d_ff: int, k: int):
        super().__init__()
        self.k = k
        self.gate = nn.Parameter(torch.empty(d_model, n_experts))
        self.experts = Experts(n_experts, d_model, d_ff)
        self.stats: Optional[Dict[str, int]] = None

    def forward(self, x):
        params = {"gate": self.gate,
                  "experts": {"wi": self.experts.wi,
                              "wo": self.experts.wo}}
        return moe_lib.moe_layer(params, x, k=self.k, stats=self.stats)


class Block(nn.Module):
    """Pre-norm residual block: attention, then the gated MLP or, with
    ``n_experts``, the mixture of experts. Returns ``(x, aux)``, ``aux``
    the MoE load-balance loss or None for the MLP."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int,
                 d_ff: int, attention: str, causal: bool,
                 n_kv_heads: int = 0, window: int = 0,
                 rope_base: float = 10000.0, dropout: float = 0.0,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 n_experts: int = 0, moe_k: int = 2,
                 fused_proj: bool = False):
        super().__init__()
        self.dropout = dropout
        self.attn_norm = RMSNorm(d_model)
        self.attn = Attention(d_model, n_heads, head_dim, attention, causal,
                              n_kv_heads=n_kv_heads, window=window,
                              rope_base=rope_base, lora_rank=lora_rank,
                              lora_alpha=lora_alpha, fused_qkv=fused_proj)
        self.mlp_norm = RMSNorm(d_model)
        if n_experts > 0:
            self.moe = MoE(d_model, n_experts, d_ff, moe_k)
        else:
            self.mlp = MLP(d_model, d_ff, fused_gate_up=fused_proj)

    def forward(self, x, cache=None, decode_pos=None, pad_offset=None,
                train: bool = False, generator=None, block_tables=None,
                verify_limit=None):
        h = self.attn(self.attn_norm(x), cache=cache,
                      decode_pos=decode_pos, pad_offset=pad_offset,
                      block_tables=block_tables, verify_limit=verify_limit)
        if self.dropout and train:
            h = _dropout(h, self.dropout, generator)
        x = x + h
        aux = None
        if hasattr(self, "moe"):
            h, aux = self.moe(self.mlp_norm(x))
        else:
            h = self.mlp(self.mlp_norm(x))
        if self.dropout and train:
            h = _dropout(h, self.dropout, generator)
        return x + h, aux


# torch.utils.checkpoint policies of the JAX package's remat options:
# "dots" keeps the outputs of the 2-D products (the projections; the
# batched expert and attention products are recomputed, as
# dots_with_no_batch_dims_saveable keeps no batch-dim dot), "full"
# keeps nothing but the block's input
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMAT_POLICIES = ("none", "dots", "full")


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(
        _dots_policy)


def _remat_block(block: Block, x: torch.Tensor, policy: str,
                 generator: Optional[torch.Generator]):
    """``block(x, train=True)`` under ``torch.utils.checkpoint``: the
    backward recomputes what ``policy`` does not keep. The recompute
    runs on the weights this forward saw (the caller's compute-dtype
    copies, bound by ``functional_call``, not the module's own) and
    replays the dropout masks: the explicit generator's state is
    restored to what it was when the block first ran (checkpoint
    replays only the global RNG)."""
    weights = dict(block.named_parameters())
    state = None if generator is None else generator.get_state()

    def run(h):
        if state is not None:
            generator.set_state(state)
        return torch.func.functional_call(
            block, weights, (h,), {"train": True, "generator": generator})

    extra = {"context_fn": _dots_contexts} if policy == "dots" else {}
    return torch.utils.checkpoint.checkpoint(
        run, x, use_reentrant=False, preserve_rng_state=False, **extra)


class FusedHeadOut(NamedTuple):
    """Training output of the chunked lm-head path: the final hidden
    states and the lm_head weight, so the loss projects and scores a
    chunk of tokens at a time and the (tokens, vocab) logits never
    exist at once. ``kernel`` is ``lm_head.weight``, (vocab, d_model)
    (the transpose of the JAX package's (d_model, vocab) kernel)."""
    hidden: torch.Tensor    # (b, s, d) final-norm output
    kernel: torch.Tensor    # (vocab, d) lm_head weight
    aux: torch.Tensor       # MoE load-balance scalar (zero: dense MLP)


class TransformerLM(nn.Module):
    """Decoder-only LM: tokens (b, s) -> logits (b, s, vocab)."""

    def __init__(self, vocab_size: int, d_model: int = 256,
                 n_layers: int = 4, n_heads: int = 4, n_kv_heads: int = 0,
                 d_ff: int = 0, attention: str = "dot", causal: bool = True,
                 sliding_window: int = 0, rope_base: float = 10000.0,
                 dropout: float = 0.0, lora_rank: int = 0,
                 lora_alpha: float = 16.0, n_experts: int = 0,
                 moe_k: int = 2, fused_proj: bool = False):
        super().__init__()
        if attention not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention impl: {attention!r}")
        d_ff = d_ff or 4 * d_model
        head_dim = d_model // n_heads
        self.n_layers = n_layers
        self.embed = nn.Embedding(vocab_size, d_model)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", Block(
                d_model, n_heads, head_dim, d_ff, attention, causal,
                n_kv_heads=n_kv_heads, window=sliding_window,
                rope_base=rope_base, dropout=dropout, lora_rank=lora_rank,
                lora_alpha=lora_alpha, n_experts=n_experts, moe_k=moe_k,
                fused_proj=fused_proj))
        self.final_norm = RMSNorm(d_model)
        self.lm_head = nn.Linear(d_model, vocab_size, bias=False)

    def forward(self, tokens, cache: Optional[Cache] = None,
                decode_pos=None, pad_offset=None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                fused_head: bool = False, block_tables=None,
                remat: str = "none", return_aux: bool = False,
                verify_limit=None):
        """Logits (b, s, vocab) in the params' dtype, or ``(logits,
        aux)`` with ``return_aux`` (``aux`` the summed MoE load-balance
        loss, zero for the MLP). The train forward (``train``) applies
        dropout from ``generator`` and, under autograd, the ``remat``
        policy per block; with ``fused_head`` it returns
        :class:`FusedHeadOut` instead of logits, for the chunked loss.
        With ``block_tables`` (a serving decode step) ``cache`` is the
        shared page pool of :meth:`LanguageModel.serve_cache_paged`; with
        more than one token there, the step is a speculative verify
        (``verify_limit`` each stream's last funded position)."""
        if remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat!r} "
                             f"(none|dots|full)")
        remat_on = remat != "none" and train and decode_pos is None and \
            cache is None and torch.is_grad_enabled()
        x = self.embed(tokens)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device) \
            if train or return_aux else None
        for i in range(self.n_layers):
            block = getattr(self, f"layer_{i}")
            if remat_on:
                x, aux = _remat_block(block, x, remat, generator)
            else:
                x, aux = block(
                    x, cache=None if cache is None else cache[i],
                    decode_pos=decode_pos, pad_offset=pad_offset,
                    train=train, generator=generator,
                    block_tables=block_tables, verify_limit=verify_limit)
            if aux is not None and aux_total is not None:
                aux_total = aux_total + aux
        x = self.final_norm(x)
        if train and fused_head:
            return FusedHeadOut(hidden=x, kernel=self.lm_head.weight,
                                aux=aux_total)
        logits = self.lm_head(x)
        return (logits, aux_total) if return_aux else logits


# ----------------------------------------------------------------------
# quantized serving weights
# ----------------------------------------------------------------------
# A serving session may narrow its copy of the matmul weights: every
# ``kernel`` and ``embedding`` leaf of the flax tree with ndim >= 2, per
# output channel (the flax leaf's last axis), as int8 with scale amax /
# 127 or float8_e4m3fn with scale amax / 448. Norm scales and LoRA
# adapters stay as they are. The master params are untouched; the serving
# module dequantizes each layer's weights inside that layer's forward.

_FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def _channel_axis(key: str, t: torch.Tensor) -> Optional[int]:
    """The axis of ``state_dict`` value ``t`` that is the flax leaf's last
    (output-channel) axis, or None when the leaf stays exact."""
    path, transposed = weights_lib.flax_path(key)
    if path[-1] not in ("kernel", "embedding") or t.ndim < 2:
        return None
    return 0 if transposed else t.ndim - 1


def _quantize_leaf(t: torch.Tensor, axis: int, dtype: str) -> Dict[str, Any]:
    f = t.detach().float()
    others = tuple(i for i in range(f.ndim) if i != axis)
    amax = f.abs().amax(dim=others, keepdim=True)
    top = 127.0 if dtype == "int8" else _FP8_MAX
    scale = torch.clamp(amax / top, min=attn_ops._QUANT_EPS)
    if dtype == "int8":
        q = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
    else:
        q = (f / scale).to(torch.float8_e4m3fn)
    return {"qvalue": q, "qscale": scale, "qlike": t.dtype}


def quantize_serving_params(params: Dict[str, torch.Tensor],
                            dtype: str) -> Dict[str, Any]:
    """The serving copy of a ``state_dict``: ``"bf16"`` (the exact path)
    returns ``params`` itself; ``"int8"`` or ``"fp8"`` replace each
    quantized leaf by ``{"qvalue", "qscale", "qlike"}`` (the scale keeps
    the channel axis, size 1 on the others, so ``qvalue * qscale``
    dequantizes)."""
    if dtype in (None, "", "bf16"):
        return params
    if dtype not in ("int8", "fp8"):
        raise ValueError(
            f"unknown serving weight dtype {dtype!r} (bf16|int8|fp8)")
    out: Dict[str, Any] = {}
    for key, t in params.items():
        axis = _channel_axis(key, t)
        out[key] = t if axis is None else _quantize_leaf(t, axis, dtype)
    return out


def _dequantize_leaf(leaf: Dict[str, Any]) -> torch.Tensor:
    return (leaf["qvalue"].float() * leaf["qscale"]).to(leaf["qlike"])


def dequantize_serving_params(tree: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_serving_params` (exact leaves pass
    through)."""
    return {k: _dequantize_leaf(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


class _QuantLinear(nn.Module):
    """A bias-free linear whose weight is kept quantized and dequantized
    at each call (plus the LoRA adapter of the layer it replaces)."""

    def __init__(self, base: nn.Linear, leaf: Dict[str, Any]):
        super().__init__()
        self.leaf = leaf
        self.adapter = base.adapter if isinstance(base, LoRALinear) else None

    def forward(self, x):
        y = F.linear(x, _dequantize_leaf(self.leaf))
        return y if self.adapter is None else y + self.adapter(x)


class _QuantEmbedding(nn.Module):
    """An embedding whose table is kept quantized: the looked-up rows are
    dequantized (the scale is per column)."""

    def __init__(self, leaf: Dict[str, Any]):
        super().__init__()
        self.leaf = leaf

    def forward(self, tokens):
        leaf = self.leaf
        rows = leaf["qvalue"][tokens].float() * leaf["qscale"][0]
        return rows.to(leaf["qlike"])


def serving_module(module: nn.Module, dtype: str) -> nn.Module:
    """The module a serving session runs: ``module`` itself for ``"bf16"``
    (the model's exact dtype), else a copy that shares the exact leaves
    and holds the matmul weights quantized (:func:`quantize_serving_params`),
    each layer dequantizing its own inside its forward."""
    if dtype in (None, "", "bf16"):
        return module
    leaves = quantize_serving_params(module.state_dict(), dtype)

    def copy_of(mod: nn.Module, prefix: str) -> nn.Module:
        leaf = leaves.get(prefix + "weight")
        if isinstance(leaf, dict):
            if isinstance(mod, nn.Embedding):
                return _QuantEmbedding(leaf)
            return _QuantLinear(mod, leaf)
        new = copy.copy(mod)
        new.__dict__["_modules"] = {
            name: copy_of(child, f"{prefix}{name}.")
            for name, child in mod._modules.items()}
        return new

    return copy_of(module, "")


# ----------------------------------------------------------------------
# losses over (outputs, batch, weights)
# ----------------------------------------------------------------------
def _token_targets(batch, weights):
    tgt = batch["x"].long()[:, 1:]
    tok_mask = (tgt != 0).float()
    if weights is not None:
        tok_mask = tok_mask * weights.float()[:, None]
    return tgt, tok_mask


def _head_chunk_sums(h_c, kernel, t_c, m_c):
    """Masked cross-entropy and correct-prediction sums of one chunk of
    tokens: bf16 (or f32) inputs, float32 logits, as the JAX einsum with
    ``preferred_element_type=float32`` gives them."""
    lg = h_c.float() @ kernel.float().t()
    lse = torch.logsumexp(lg, dim=-1)
    correct = lg.gather(1, t_c[:, None])[:, 0]
    ok = (lg.argmax(dim=-1) == t_c).float()
    return ((lse - correct) * m_c).sum(), (ok * m_c).sum()


def _fused_head_loss(out: FusedHeadOut, batch, weights, chunk: int,
                     aux_coef: float):
    """Chunked vocab projection + softmax cross-entropy: ``chunk`` tokens
    at a time under ``torch.utils.checkpoint``, so one (chunk, vocab)
    float32 logits tile lives at once and the backward recomputes it.
    Accuracy comes out of the same pass as a loss metric."""
    tgt, tok_mask = _token_targets(batch, weights)
    hs = out.hidden[:, :-1]
    b, sm1, d = hs.shape
    t_total = b * sm1
    chunk = max(1, min(chunk, t_total))
    hs = hs.reshape(t_total, d)
    tg = tgt.reshape(t_total)
    mk = tok_mask.reshape(t_total)
    kernel = out.kernel.to(hs.dtype)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hs.device)
    ok_sum = torch.zeros((), dtype=torch.float32, device=hs.device)
    for start in range(0, t_total, chunk):
        end = start + chunk
        lsum, osum = torch.utils.checkpoint.checkpoint(
            _head_chunk_sums, hs[start:end], kernel, tg[start:end],
            mk[start:end], use_reentrant=False)
        loss_sum = loss_sum + lsum
        ok_sum = ok_sum + osum.detach()
    total = mk.sum().clamp_min(1e-9)
    loss = loss_sum / total + aux_coef * out.aux.float()
    return loss, {"accuracy": (ok_sum, total)}


def next_token_loss(aux_coef: float = 0.01, head_chunk: int = 1024):
    """Causal LM loss: predict token t+1 from the prefix up to t; padding
    tokens (id 0) and padded tail samples are masked out. On
    :class:`FusedHeadOut` the projection and cross-entropy run chunked
    (``head_chunk`` tokens at a time) and the loss also returns
    ``{"accuracy": (sum, count)}``; on ``(logits, aux)`` it is the mean
    cross-entropy of the float32 logits."""

    def loss_fn(outputs, batch, weights):
        if isinstance(outputs, FusedHeadOut):
            return _fused_head_loss(outputs, batch, weights, head_chunk,
                                    aux_coef)
        logits, aux = outputs
        tgt, tok_mask = _token_targets(batch, weights)
        lg = logits[:, :-1].float()
        per_tok = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                  tgt.reshape(-1), reduction="none")
        total = tok_mask.sum().clamp_min(1e-9)
        loss = (per_tok.reshape(tgt.shape) * tok_mask).sum() / total
        return loss + aux_coef * aux.float()

    return loss_fn


def token_accuracy(outputs, batch, weights):
    """(correct next-token predictions, counted tokens) on full logits."""
    if isinstance(outputs, FusedHeadOut):
        raise RuntimeError(
            "token_accuracy on FusedHeadOut — use the accuracy the fused "
            "loss emits (the engine skips same-named metric fns)")
    logits, _ = outputs
    tgt, tok_mask = _token_targets(batch, weights)
    pred = logits[:, :-1].float().argmax(dim=-1)
    return ((pred == tgt).float() * tok_mask).sum(), tok_mask.sum()


# ----------------------------------------------------------------------
# sampling schedule
# ----------------------------------------------------------------------
_MASK64 = (1 << 64) - 1


def _stream_seed(seed: int, pos: int, stream: int) -> int:
    """A 64-bit generator seed for ``(seed, pos, stream)``, mixed by
    splitmix64's finalizer so every bit depends on all three: the CPU
    generator (mt19937) keeps only the low 32 bits of its seed, the
    card's (Philox) all 64."""
    x = ((int(seed) % 2 ** 32) << 32) | (int(pos) % 2 ** 32)
    x = (x + (int(stream) + 1) * 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _position_generator(seed: int, pos: int,
                        device: torch.device) -> torch.Generator:
    """The random stream for the token written at buffer position
    ``pos`` of a request seeded ``seed`` — the port's counterpart of
    ``fold_in(key, pos)``. Solo ``generate`` and a serving slot draw
    from the same stream at the same position."""
    g = torch.Generator(device=device)
    g.manual_seed(_stream_seed(seed, pos, 0))
    return g


def _acceptance_generator(seed: int, pos: int,
                          device: torch.device) -> torch.Generator:
    """The speculative verify's own stream at ``(seed, pos)``: the
    acceptance uniform, then the residual draw. Independent of
    :func:`_position_generator`'s stream, which keeps the solo
    schedule's draw for the bonus token."""
    g = torch.Generator(device=device)
    g.manual_seed(_stream_seed(seed, pos, 1))
    return g


class LanguageModel:
    """Trainable LM artifact with the JAX package's configuration keys
    and method surface (``compile``, ``fit``, ``evaluate``, ``predict``,
    ``generate``).

    Covers the gated MLP or a mixture of experts (``n_experts``,
    ``moe_k``, ``aux_coef``), GQA, sliding window, RoPE, dropout, fused
    projections (``fused_proj``), per-block rematerialization under
    training (``remat`` ``"dots"``/``"full"``), beam search, and LoRA
    adapters on the attention projections (``lora_rank``; a model with
    adapters trains them alone, its base frozen). Ring and Ulysses
    attention raise at construction. ``LO_LM_HEAD_CHUNK``,
    ``LO_TLM_REMAT`` and ``LO_TLM_FUSED_PROJ`` override ``head_chunk``,
    ``remat`` and ``fused_proj`` as in the JAX package. Weights come in
    through :meth:`set_params` (see :mod:`.weights`), or from
    ``weights.init_params(seed)`` at the first ``fit``; they stay
    float32. ``attention="auto"`` resolves to ``flash``."""

    _CONFIG_KEYS = ("vocab_size", "d_model", "n_layers", "n_heads",
                    "n_kv_heads", "d_ff", "max_len", "attention",
                    "n_experts", "moe_k",
                    "dropout", "aux_coef", "head_chunk", "remat",
                    "fused_proj", "lora_rank", "lora_alpha",
                    "sliding_window", "rope_base")

    def __init__(self, vocab_size: int, d_model: int = 256,
                 n_layers: int = 4, n_heads: int = 4,
                 n_kv_heads: int = 0, d_ff: int = 0,
                 max_len: int = 512, attention: str = "auto",
                 n_experts: int = 0, moe_k: int = 2, dropout: float = 0.0,
                 aux_coef: float = 0.01, head_chunk: Optional[int] = None,
                 remat: Optional[str] = None, fused_proj: bool = False,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 sliding_window: int = 0, rope_base: float = 10000.0,
                 name: str = "language_model", device="cuda"):
        self.name = name
        self.vocab_size = int(vocab_size)
        self.d_model = int(d_model)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.n_kv_heads = int(n_kv_heads)
        if self.n_kv_heads < 0 or (
                self.n_kv_heads and self.n_heads % self.n_kv_heads):
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} must be a positive "
                f"divisor of n_heads={self.n_heads} (or 0 for MHA)")
        self.d_ff = int(d_ff)
        self.max_len = int(max_len)
        self.attention = attention
        if attention not in ("auto",) + ATTENTION_IMPLS:
            raise ValueError(
                f"attention={attention!r} is not ported to the PyTorch "
                f"package yet (auto, dot or flash)")
        self.n_experts = int(n_experts)
        self.moe_k = int(moe_k)
        self.dropout = float(dropout)
        self.aux_coef = float(aux_coef)
        self.head_chunk = head_chunk
        if remat not in (None,) + REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat!r} "
                             f"(none|dots|full)")
        self.remat = remat
        self.fused_proj = bool(fused_proj)
        self.lora_rank = int(lora_rank)
        self.lora_alpha = float(lora_alpha)
        if self.lora_rank < 0:
            raise ValueError(f"lora_rank must be >= 0, got {lora_rank}")
        self.sliding_window = int(sliding_window)
        if self.sliding_window < 0:
            raise ValueError(
                f"sliding_window must be >= 0, got {sliding_window}")
        self.rope_base = float(rope_base)
        if self.rope_base <= 1.0:
            raise ValueError(f"rope_base must be > 1, got {rope_base}")
        self.device = resolve_device(device)
        self.module: Optional[TransformerLM] = None
        self.optimizer_spec: Dict[str, Any] = {"kind": "adamw",
                                               "learning_rate": 3e-4}
        self.history: List[Dict[str, Any]] = []
        self.seed = 0
        self._engine: Optional[engine_lib.Engine] = None
        self._accum = engine_lib.default_grad_accum()

    # ------------------------------------------------------------------
    def _resolved_attention(self) -> str:
        if self.attention != "auto":
            return self.attention
        # the JAX package's dot-below-1024 crossover was measured on a
        # v5e; on the card the kernel serves every prefill length until
        # the crossover is measured there. No flash kernel takes a
        # head_dim above MAX_HEAD_DIM (the JAX package's Pallas kernels
        # pad any head_dim), so such a model runs dot
        if self.d_model // self.n_heads > attn_ops.MAX_HEAD_DIM:
            return "dot"
        return "flash"

    def _head_chunk(self) -> int:
        """Tokens per chunk of the fused lm-head loss (0 = full logits):
        fused when the vocab is large enough that the (tokens, vocab)
        float32 logits dominate the step's memory. ``LO_LM_HEAD_CHUNK``
        overrides (0 disables, N sets tokens per chunk)."""
        env = os.environ.get("LO_LM_HEAD_CHUNK")
        if env is not None:
            return max(0, int(env))
        if self.head_chunk is not None:
            return max(0, int(self.head_chunk))
        return 1024 if self.vocab_size >= 8192 else 0

    def _resolved_remat(self) -> str:
        """The remat policy of a training forward: ``LO_TLM_REMAT``, else
        the constructor's, else ``"none"``."""
        value = os.environ.get("LO_TLM_REMAT") or self.remat or "none"
        if value not in REMAT_POLICIES:
            raise ValueError(
                f"unknown remat policy {value!r} (none|dots|full)")
        return value

    def _resolved_fused_proj(self) -> bool:
        """``LO_TLM_FUSED_PROJ`` (1/true/yes or 0/false/no; unset or
        empty takes the constructor's value). Anything else raises, so a
        typo never measures the wrong path."""
        env = os.environ.get("LO_TLM_FUSED_PROJ")
        if not env:
            return self.fused_proj
        value = env.strip().lower()
        if value in ("1", "true", "yes"):
            return True
        if value in ("0", "false", "no"):
            return False
        raise ValueError(
            f"LO_TLM_FUSED_PROJ={env!r} (want 1/true/yes or "
            f"0/false/no)")

    def _config(self) -> Dict[str, Any]:
        """The configuration keys, ``fused_proj`` resolved: what decides
        the parameter tree (:func:`weights.init_params`)."""
        config = {k: getattr(self, k) for k in self._CONFIG_KEYS}
        config["fused_proj"] = self._resolved_fused_proj()
        return config

    def _new_module(self) -> TransformerLM:
        """The module on the meta device (no memory, no init)."""
        with torch.device("meta"):
            return TransformerLM(
                self.vocab_size, d_model=self.d_model,
                n_layers=self.n_layers, n_heads=self.n_heads,
                n_kv_heads=self.n_kv_heads, d_ff=self.d_ff,
                attention=self._resolved_attention(), causal=True,
                sliding_window=self.sliding_window,
                rope_base=self.rope_base, dropout=self.dropout,
                lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
                n_experts=self.n_experts, moe_k=self.moe_k,
                fused_proj=self._resolved_fused_proj())

    def set_params(self, state_dict) -> None:
        """Build the module on the model's device and load (copy)
        weights: the float32 master params that ``fit`` trains in place
        and serving reads (under ``inference_mode``). With adapters,
        only they stay trainable (``requires_grad``)."""
        self.module = load_module(self._new_module(), state_dict,
                                  self.device,
                                  frozen_base=self.lora_rank > 0)

    def num_params(self) -> int:
        if self.module is None:
            return 0
        return sum(p.numel() for p in self.module.parameters())

    @property
    def params(self):
        return None if self.module is None else self.module.state_dict()

    def _require_built(self) -> None:
        if self.module is None:
            raise RuntimeError(f"{self.name} has no weights yet — call "
                               f"set_params first")

    # ------------------------------------------------------------------
    # training (runtime/engine.py)
    # ------------------------------------------------------------------
    def compile(self, optimizer: Any = "adamw", loss: Any = None,
                metrics: Any = None, **_: Any) -> None:
        if isinstance(optimizer, str):
            self.optimizer_spec = {"kind": optimizer}
        elif isinstance(optimizer, dict):
            self.optimizer_spec = dict(optimizer)
        elif hasattr(optimizer, "spec"):
            self.optimizer_spec = dict(optimizer.spec)
        else:
            raise TypeError(f"unsupported optimizer: {optimizer!r}")
        self._engine = None

    def _apply_fn(self, params, batch, train: bool, rng: Optional[int]):
        generator = None
        if train and self.dropout and rng is not None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(rng)
        return torch.func.functional_call(
            self.module, params, (batch["x"],),
            {"train": train, "generator": generator,
             "fused_head": bool(self._head_chunk()),
             "remat": self._resolved_remat() if train else "none",
             "return_aux": True})

    def _get_engine(self) -> engine_lib.Engine:
        if self._engine is None:
            dtype = torch.bfloat16 if Config().compute_dtype == "bfloat16" \
                else torch.float32
            self._engine = engine_lib.Engine(
                apply_fn=self._apply_fn,
                loss_fn=next_token_loss(
                    self.aux_coef, head_chunk=self._head_chunk() or 1024),
                optimizer=build_optimizer(self.optimizer_spec,
                                          frozen_base=self.lora_rank > 0),
                metrics={"accuracy": token_accuracy},
                compute_dtype=dtype,
                predict_transform=lambda outputs: outputs[0],
                grad_accum=self._accum, param_layout=FLAX_LAYOUT)
        return self._engine

    def _set_grad_accum(self, grad_accum: Optional[int]) -> None:
        """Fit-time microbatch override (env default LO_GRAD_ACCUM); an
        effective change rebuilds the engine."""
        self._accum, changed = engine_lib.resolve_grad_accum(
            grad_accum, self._accum)
        if changed:
            self._engine = None

    def _coerce_tokens(self, x) -> np.ndarray:
        """(n, seq) int32 windows of ``x``: a flat corpus is cut into
        non-overlapping windows, longer rows to ``max_len``. Ids outside
        ``[0, vocab)`` raise here, before anything reaches the card,
        where an out-of-range embedding index is a device-side assert
        (the JAX package's gather gives NaN rows for them instead)."""
        if hasattr(x, "to_numpy"):  # a catalog Table: no _id column
            x = data_lib.dataframe_to_arrays(x)["x"]
        x = np.asarray(x)
        if x.ndim == 1:  # flat corpus -> non-overlapping windows
            seq = min(self.max_len, max(2, len(x) // 2))
            n = len(x) // seq
            x = x[:n * seq].reshape(n, seq)
        if x.ndim != 2 or x.size == 0:
            raise ValueError(f"tokens must be a non-empty (n, seq) array, "
                             f"got shape {x.shape}")
        if x.shape[1] > self.max_len:
            x = x[:, :self.max_len]
        if not np.issubdtype(x.dtype, np.integer) and \
                not np.array_equal(x, np.round(x)):
            raise ValueError("token ids must be integers")
        if x.min() < 0 or x.max() >= self.vocab_size:
            raise ValueError(f"token ids must be in [0, {self.vocab_size})"
                             f", got [{x.min()}, {x.max()}]")
        return x.astype(np.int32)

    def _batcher(self, x, batch_size: Optional[int],
                 shuffle: bool = False) -> data_lib.ArrayBatcher:
        return data_lib.ArrayBatcher(
            {"x": self._coerce_tokens(x)},
            batch_size or Config().default_batch_size,
            shuffle=shuffle, seed=self.seed)

    def _master_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.module.named_parameters())

    def fit(self, x=None, y=None, batch_size: Optional[int] = None,
            epochs: int = 1, shuffle: bool = True, checkpointer=None,
            log_fn=None, grad_accum: Optional[int] = None,
            validation_split: float = 0.0, **_: Any) -> History:
        """Next-token training on ``x`` (token windows, or a flat corpus
        cut into windows); one optimizer step per batch of
        ``batch_size`` windows, split into ``grad_accum`` micro-batches.
        With a ``checkpointer`` (:class:`~learningorchestra_tpu_torch.
        runtime.checkpoint.Checkpointer`) the fit resumes from its newest
        verified step, ``epochs`` being the total, and saves after every
        epoch. Appends the epoch records to :attr:`history`."""
        self._set_grad_accum(grad_accum)
        val_x = None
        if validation_split:
            x = self._coerce_tokens(x)
            n_val = validation_tail_count(len(x), validation_split)
            val_x = x[-n_val:]
            x = x[:-n_val]
        batcher = self._batcher(x, batch_size, shuffle=shuffle)
        if self.module is None:
            self.set_params(weights_lib.params_from_flax(
                weights_lib.init_params(self._config(), self.seed)))
        eng = self._get_engine()
        state = eng.init_state(self._master_params())
        state, history = eng.fit(state, batcher, epochs=epochs,
                                 seed=self.seed, checkpointer=checkpointer,
                                 log_fn=log_fn)
        if val_x is not None:
            val = eng.evaluate(state.params, self._batcher(val_x,
                                                           batch_size))
            if not history:
                history.append({})
            for k, v in val.items():
                history[-1][f"val_{k}"] = v
        self.history.extend(history)
        return History(history)

    def evaluate(self, x=None, y=None, batch_size: Optional[int] = None,
                 **_: Any) -> Dict[str, float]:
        self._require_built()
        return self._get_engine().evaluate(self._master_params(),
                                           self._batcher(x, batch_size))

    def predict(self, x=None, batch_size: Optional[int] = None,
                **_: Any) -> np.ndarray:
        """Next-token logits (n, seq, vocab), float32."""
        self._require_built()
        return self._get_engine().predict(self._master_params(),
                                          self._batcher(x, batch_size))

    # ------------------------------------------------------------------
    # LoRA
    # ------------------------------------------------------------------
    def enable_lora(self, rank: int, alpha: float = 16.0) -> None:
        """Attach fresh rank-``rank`` adapters to a trained model: the
        base weights keep their values (B starts at zero, so predictions
        are unchanged at step 0) and later ``fit`` calls train only the
        adapters. Any missing leaf other than an adapter raises."""
        if self.lora_rank > 0:
            raise RuntimeError(
                f"model already has LoRA adapters (rank {self.lora_rank}); "
                f"merge_lora() first")
        if int(rank) <= 0:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self._require_built()
        old = self.module.state_dict()
        self.lora_rank = int(rank)
        self.lora_alpha = float(alpha)
        fresh = weights_lib.lora_adapters(self._config(), self.seed,
                                          self.lora_rank)
        state = {}
        for key in self._new_module().state_dict():
            if key in old:
                state[key] = old[key]
            elif is_adapter(key):
                state[key] = fresh[key]
            else:
                path = "/".join(weights_lib.flax_path(key)[0])
                raise ValueError(
                    f"enable_lora: trained params have no leaf at "
                    f"{path!r}; refusing to re-initialize a base weight")
        self.set_params(state)
        self._engine = None

    def merge_lora(self) -> None:
        """Fold the adapters into the base kernels (W += A·B·α/r, in
        float32 on the host) and drop them: a plain model that computes
        what the adapted one did."""
        if self.lora_rank <= 0:
            raise RuntimeError("model has no LoRA adapters to merge")
        self._require_built()
        scale = self.lora_alpha / self.lora_rank
        state = {k: t.detach().cpu() for k, t in
                 self.module.state_dict().items()}
        merged = {}
        for key, t in state.items():
            if is_adapter(key):
                continue
            if key.endswith(".weight") and \
                    key[:-len("weight")] + "lora_a" in state:
                base = key[:-len("weight")]
                kernel = t.numpy().T + state[base + "lora_a"].numpy() @ \
                    state[base + "lora_b"].numpy() * scale
                t = torch.from_numpy(np.ascontiguousarray(kernel.T))
            merged[key] = t
        self.lora_rank = 0
        self.set_params(merged)
        self._engine = None

    def _new_cache(self, b: int, cache_len: int) -> Cache:
        kv = self.n_kv_heads or self.n_heads
        shape = (b, cache_len, kv, self.d_model // self.n_heads)
        dtype = self.module.embed.weight.dtype
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in range(self.n_layers)]

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    @staticmethod
    def _filter_logits(last: torch.Tensor, temperature: float,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None) -> torch.Tensor:
        """Pad mask, temperature, top-k, then top-p (the nucleus keeps
        tokens whose EXCLUSIVE prefix mass is < p)."""
        last = last.float().clone()
        last[..., 0] = NEG_INF  # id 0 is padding: never emit it
        if temperature <= 0:
            return last
        logits = last / temperature
        if top_k is not None and top_k < logits.shape[-1]:
            kth = torch.sort(logits, dim=-1).values[..., -top_k, None]
            logits = torch.where(logits < kth, NEG_INF, logits)
        if top_p is not None and top_p < 1.0:
            order = torch.argsort(-logits, dim=-1, stable=True)
            ranked = torch.gather(logits, -1, order)
            probs = torch.softmax(ranked, dim=-1)
            keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
            ranked = torch.where(keep, ranked, NEG_INF)
            inv = torch.argsort(order, dim=-1, stable=True)
            logits = torch.gather(ranked, -1, inv)
        return logits

    @staticmethod
    def _sample(last: torch.Tensor, temperature: float,
                top_k: Optional[int], top_p: Optional[float], seed: int,
                pos: int) -> torch.Tensor:
        """Next token per row of ``last`` (n, vocab): argmax when greedy,
        else a Gumbel-max draw from the stream of ``(seed, pos)``."""
        logits = LanguageModel._filter_logits(last, temperature, top_k,
                                              top_p)
        if temperature <= 0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, device=logits.device,
                       generator=_position_generator(seed, pos,
                                                     logits.device))
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------
    def _prep_prompt(self, prompt, max_new_tokens: int):
        """2-D prompt, left-padding (id 0) of unequal-length rows so the
        last prompt tokens align (``pad`` is each row's pad width, None
        for rectangular input), truncation of prompts at or over
        max_len to their last max_len - 1 tokens, and the clamped total
        length."""
        pad = None
        if isinstance(prompt, (list, tuple)) and len(prompt) > 1 and \
                all(hasattr(p, "__len__") for p in prompt) and \
                len({len(p) for p in prompt}) > 1:
            s = max(len(p) for p in prompt)
            rows = np.zeros((len(prompt), s), np.int32)
            pad = np.zeros(len(prompt), np.int32)
            for i, p in enumerate(prompt):
                arr = np.asarray(p, dtype=np.int32).reshape(-1)
                pad[i] = s - arr.shape[0]
                rows[i, pad[i]:] = arr
            prompt = rows
        prompt = np.atleast_2d(np.asarray(prompt)).astype(np.int32)
        b, s = prompt.shape
        if s >= self.max_len:
            keep = self.max_len - 1
            prompt = prompt[:, -keep:]
            if pad is not None:
                pad = np.minimum(pad - (s - keep), keep).clip(0) \
                    .astype(np.int32)
            s = prompt.shape[1]
        total = min(self.max_len, s + max_new_tokens)
        return prompt, b, s, total, pad

    def generate(self, prompt, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 num_beams: int = 1) -> np.ndarray:
        """Greedy or sampled continuation with an incremental KV cache:
        the prompt runs once (prefill), then one single-position forward
        per new token. ``top_k``/``top_p`` apply only when
        ``temperature > 0``. Unequal-length prompts (list of lists) are
        left-padded with id 0 and the leading pads stay in the output.
        ``num_beams`` above 1 runs deterministic beam search
        (:meth:`_beam_search`): greedy only, equal-length prompts. Returns
        (b, s + new) int32 tokens."""
        self._require_built()
        if num_beams > 1:
            if temperature > 0:
                raise ValueError(
                    "beam search is deterministic — use temperature=0 "
                    "(sampling and beams don't compose)")
            if top_k is not None or top_p is not None:
                raise ValueError(
                    "beam search is deterministic — top_k/top_p "
                    "sampling filters don't compose with num_beams>1")
            if num_beams >= self.vocab_size:
                # token 0 is pad-masked, so vocab-1 real candidates
                raise ValueError(
                    f"num_beams={num_beams} exceeds the "
                    f"{self.vocab_size - 1} non-pad vocabulary "
                    f"candidates")
            return self._beam_search(prompt, max_new_tokens,
                                     int(num_beams))
        if temperature <= 0:
            top_k = top_p = None
        if top_k is not None:
            top_k = int(top_k)
            if top_k < 1:
                raise ValueError(f"top_k must be >= 1, got {top_k}")
            if top_k >= self.vocab_size:
                top_k = None
        if top_p is not None:
            top_p = float(top_p)
            if not 0.0 < top_p <= 1.0:
                raise ValueError(f"top_p must be in (0, 1], got {top_p}")
            if top_p == 1.0:
                top_p = None
        prompt, b, s, total, pad = self._prep_prompt(prompt,
                                                     max_new_tokens)
        if total <= s:
            return prompt
        dev = self.device
        buf = torch.zeros((b, total), dtype=torch.long, device=dev)
        buf[:, :s] = torch.from_numpy(prompt).to(dev)
        pad_t = None if pad is None else \
            torch.from_numpy(pad).to(dev, torch.long)
        cache = self._new_cache(b, total)
        temperature = float(temperature)
        with torch.inference_mode():
            logits = self.module(buf[:, :s], cache=cache, pad_offset=pad_t)
            buf[:, s] = self._sample(logits[:, -1], temperature, top_k,
                                     top_p, seed, s)
            for pos in range(s + 1, total):
                logits = self.module(buf[:, pos - 1:pos], cache=cache,
                                     decode_pos=pos - 1, pad_offset=pad_t)
                buf[:, pos] = self._sample(logits[:, 0], temperature,
                                           top_k, top_p, seed, pos)
        return buf.cpu().numpy().astype(np.int32)

    def _beam_search(self, prompt, max_new_tokens: int,
                     num_beams: int) -> np.ndarray:
        """Deterministic beam search over the KV cache, as the JAX
        package runs it: the prompt prefills once per sample, the cache
        repeats to ``b·beams`` rows, and every step scores each (beam,
        token) candidate by its summed log-prob (token 0 masked), keeps
        the top ``num_beams`` (ties to the lower flat index, as
        ``lax.top_k``), and reorders the tokens and the cache by each
        survivor's parent. All beams have one length, so the raw sum
        ranks them. Returns the best beam per sample, (b, s + new)."""
        prompt, b, s, total, pad = self._prep_prompt(prompt,
                                                     max_new_tokens)
        if pad is not None:
            raise ValueError(
                "beam search requires equal-length prompts (pass one "
                "prompt at a time, or use num_beams=1 which "
                "left-pads)")
        if total <= s:
            return prompt
        n, vocab, dev = num_beams, self.vocab_size, self.device

        def logp_of(logits):
            lg = logits.float().clone()
            lg[..., 0] = NEG_INF  # the pad token
            return torch.log_softmax(lg, dim=-1)

        buf = torch.zeros((b, n, total), dtype=torch.long, device=dev)
        buf[:, :, :s] = torch.from_numpy(prompt).to(dev)[:, None, :]
        cache = self._new_cache(b, total)
        with torch.inference_mode():
            logits = self.module(buf[:, 0, :s], cache=cache)
            scores, toks = moe_lib.stable_top_k(logp_of(logits[:, -1]), n)
            buf[:, :, s] = toks
            cache = [(k.repeat_interleave(n, dim=0),
                      v.repeat_interleave(n, dim=0)) for k, v in cache]
            base = torch.arange(b, device=dev)[:, None] * n
            for pos in range(s + 1, total):
                tok = buf[:, :, pos - 1].reshape(b * n, 1)
                lg = self.module(tok, cache=cache, decode_pos=pos - 1)
                cand = scores[..., None] + \
                    logp_of(lg[:, 0]).reshape(b, n, vocab)
                scores, flat = moe_lib.stable_top_k(
                    cand.reshape(b, n * vocab), n)
                parent = flat // vocab
                buf = torch.gather(
                    buf, 1, parent[..., None].expand(b, n, total)).clone()
                buf[:, :, pos] = flat % vocab
                rows = (base + parent).reshape(-1)
                cache = [(k[rows], v[rows]) for k, v in cache]
            best = torch.argmax(scores, dim=1)
            out = buf[torch.arange(b, device=dev), best]
        return out.cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------------
    # resident serving (services/serving.py)
    # ------------------------------------------------------------------
    def serve_fns(self, slots: int, cache_len: int, temperature: float,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None, module=None):
        """Continuous-batching functions for a serving session:
        ``(step, prefill_for, join)``, over ``module`` (the model's own by
        default; a session with quantized weights passes its
        :func:`serving_module`).

        - ``step(cache, tok (slots, 1), col (slots,), seeds (slots,))``
          (host arrays) advances every slot one token: row i attends
          its own cache prefix at position ``col[i]`` and samples the
          token at ``col[i] + 1`` from its request's stream — the
          schedule a solo ``generate`` follows. Idle rows compute
          finite garbage that the caller discards. Returns the next
          tokens (slots,) on the device.
        - ``prefill_for(s)`` returns the batch-1 prefill for prompt
          length ``s``: ``prefill(tokens (1, s), seed) -> (next (1,),
          pcache)`` with a (1, cache_len) cache.
        - ``join(cache, pcache, slot)`` copies a prefill cache into the
          session cache at ``slot``, in place.
        """
        self._require_built()
        module = self.module if module is None else module
        dev = self.device
        temperature = float(temperature)
        step_sample = self._step_sampler(temperature, top_k, top_p)

        def step(cache, tok, col, seeds):
            col_t = torch.from_numpy(np.asarray(col, np.int64)).to(dev)
            tok_t = torch.from_numpy(np.asarray(tok, np.int64)).to(dev)
            with torch.inference_mode():
                logits = module(tok_t, cache=cache, decode_pos=col_t)[:, 0]
                return step_sample(logits, col, seeds)

        def prefill_for(s: int):
            def prefill(tokens, seed: int):
                nxt, _, pcache = self._prefill(module, tokens, seed,
                                               cache_len, temperature,
                                               top_k, top_p)
                return nxt, pcache

            return prefill

        def join(cache, pcache, slot: int):
            with torch.inference_mode():
                for (ck, cv), (pk, pv) in zip(cache, pcache):
                    ck[slot].copy_(pk[0])
                    cv[slot].copy_(pv[0])
            return cache

        return step, prefill_for, join

    def _step_sampler(self, temperature: float, top_k: Optional[int],
                      top_p: Optional[float]):
        """``sample(logits (slots, vocab), col, seeds)``: the next token of
        every row, row i drawn from its request's stream at position
        ``col[i] + 1`` (argmax when greedy)."""
        sample = self._sample

        def step_sample(logits, col, seeds):
            if temperature <= 0:
                return sample(logits, temperature, None, None, 0, 0)
            return torch.cat([
                sample(logits[i:i + 1], temperature, top_k, top_p,
                       int(seeds[i]), int(col[i]) + 1)
                for i in range(logits.shape[0])])

        return step_sample

    def _prefill(self, module, tokens, seed: int, rows: int,
                 temperature: float, top_k, top_p):
        """Batch-1 prefill of ``tokens`` (1, s) into a fresh (1, rows)
        cache: ``(next (1,), last logits (1, vocab), cache)``, the next
        token sampled at position s from the request's stream."""
        pcache = self._new_cache(1, rows)
        with torch.inference_mode():
            last = module(tokens, cache=pcache)[:, -1]
            nxt = self._sample(last, temperature, top_k, top_p, seed,
                               tokens.shape[1])
        return nxt, last, pcache

    def serve_cache(self, slots: int, cache_len: int) -> Cache:
        """Zero-initialized per-layer KV cache for a serving session."""
        self._require_built()
        return self._new_cache(slots, cache_len)

    def serve_fns_paged(self, slots: int, cache_len: int, page_len: int,
                        n_pages: int, temperature: float,
                        top_k: Optional[int] = None,
                        top_p: Optional[float] = None,
                        kv_dtype: str = "bf16", module=None):
        """Paged-KV counterpart of :meth:`serve_fns`: the per-layer cache
        is one shared pool (:meth:`serve_cache_paged`) and each stream
        owns an ordered page list, its block-table row. Returns ``(step,
        prefill_for, join_paged, copy_page, sample_first)``:

        - ``step(pool, tok, col, block_tables, seeds)``: one decode step
          over the pool; ``tok``, ``col`` and ``seeds`` are host arrays
          as in :meth:`serve_fns`, ``block_tables`` a ``(slots, width)``
          long tensor on the model's device. The gather width is
          ``width``: the session slices its tables to the page bucket of
          the longest live stream. Rope, mask and sampling schedule are
          the slot step's.
        - ``prefill_for(s)`` -> ``prefill(tokens (1, s), seed) -> (next
          (1,), last_logits (1, vocab), pcache)``; the prefix cache keeps
          ``last_logits`` so an exact-prompt hit samples its first token
          without the prefill.
        - ``join_paged(pool, pcache, page_ids, start_row)`` writes the
          prefill's rows ``[start_row, ...)`` into ``page_ids`` (a long
          tensor on the device), in place; shared prefix pages are not
          in ``page_ids``.
        - ``copy_page(pool, src, dst)`` clones one page (a prefix hit's
          partial tail page is copied on write).
        - ``sample_first(logits (vocab,), seed, pos)`` is the prefill's
          sampling epilogue alone: the token at ``pos`` from the
          request's stream, the same draw the prefill would make.

        ``kv_dtype="int8"`` pools hold int8 values and per-page-per-head
        scales; the same five functions serve them.
        """
        self._require_built()
        module = self.module if module is None else module
        temperature = float(temperature)
        step_sample = self._step_sampler(temperature, top_k, top_p)
        kv_quant = kv_dtype == "int8"
        dev = self.device

        def step(pool, tok, col, block_tables, seeds):
            col_t = torch.from_numpy(np.asarray(col, np.int64)).to(dev)
            tok_t = torch.from_numpy(np.asarray(tok, np.int64)).to(dev)
            with torch.inference_mode():
                logits = module(tok_t, cache=pool, decode_pos=col_t,
                                block_tables=block_tables)[:, 0]
                return step_sample(logits, col, seeds)

        def prefill_for(s: int):
            # the prompt's pages only: the rows past s stay zero
            rows = -(-s // page_len) * page_len

            def prefill(tokens, seed: int):
                return self._prefill(module, tokens, seed, rows,
                                     temperature, top_k, top_p)

            return prefill

        def join_paged(pool, pcache, page_ids, start_row: int):
            with torch.inference_mode():
                for layer, (pk, pv) in zip(pool, pcache):
                    if kv_quant:
                        kp, vp, ks, vs = layer
                        attn_ops.quantized_paged_prefill_write(
                            kp, ks, pk[0], page_ids, start_row)
                        attn_ops.quantized_paged_prefill_write(
                            vp, vs, pv[0], page_ids, start_row)
                    else:
                        kp, vp = layer
                        attn_ops.paged_prefill_write(kp, pk[0], page_ids,
                                                     start_row)
                        attn_ops.paged_prefill_write(vp, pv[0], page_ids,
                                                     start_row)
            return pool

        def copy_page(pool, src: int, dst: int):
            with torch.inference_mode():
                for layer in pool:
                    for t in layer:
                        t[dst].copy_(t[src])
            return pool

        def sample_first(logits, seed: int, pos: int):
            with torch.inference_mode():
                return self._sample(logits[None], temperature, top_k,
                                    top_p, seed, pos)[0]

        return step, prefill_for, join_paged, copy_page, sample_first

    def serve_cache_paged(self, n_pages: int, page_len: int,
                          kv_dtype: str = "bf16") -> List[Tuple]:
        """Zero-initialized shared KV page pool: per layer ``(k, v)``, each
        ``(n_pages, page_len, kv_heads, head_dim)`` in the model's dtype,
        or under ``kv_dtype="int8"`` ``(k, v, k_scale, v_scale)`` with
        int8 pages and ``(n_pages, kv_heads)`` float32 scales (zero scales
        dequantize to exact zeros)."""
        self._require_built()
        kv = self.n_kv_heads or self.n_heads
        shape = (n_pages, page_len, kv, self.d_model // self.n_heads)
        dev = self.device

        def zeros(shp, dtype):
            return torch.zeros(shp, dtype=dtype, device=dev)

        if kv_dtype == "int8":
            return [(zeros(shape, torch.int8), zeros(shape, torch.int8),
                     zeros((n_pages, kv), torch.float32),
                     zeros((n_pages, kv), torch.float32))
                    for _ in range(self.n_layers)]
        dtype = self.module.embed.weight.dtype
        return [(zeros(shape, dtype), zeros(shape, dtype))
                for _ in range(self.n_layers)]

    def serve_fns_spec(self, slots: int, cache_len: int, page_len: int,
                       n_pages: int, spec_k: int, temperature: float,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None,
                       kv_dtype: str = "bf16", module=None):
        """The speculative verify step of a paged session: one forward of
        this (target) model over the last accepted token and ``spec_k``
        draft tokens per stream, exact acceptance of a prefix of the
        drafts, and the correction or bonus token: up to ``spec_k + 1``
        tokens a stream.

        ``verify(pool, tok (slots, 1), drafts (slots, k), col (slots,),
        seeds (slots,), block_tables, limit (slots,))`` gives
        ``(emitted (slots, k + 1), n_acc (slots,))`` on the device; a
        stream's tokens are ``emitted[:n_acc + 1]``, at positions ``col +
        1 .. col + n_acc + 1``. ``tok``, ``col``, ``seeds`` and ``limit``
        are host arrays as in :meth:`serve_fns_paged`; ``drafts`` a host
        array or a device tensor. ``limit`` is each stream's last funded
        position: its appends past it go to trash page 0.

        The drafts are the draft model's greedy picks, a one-hot
        proposal, so the accept probability ``min(1, p/q)`` is
        ``p(draft)`` under this model's filtered distribution and the
        residual is that distribution without the draft token: every
        emitted position is distributed as a solo draw. Greedy sessions
        accept a draft iff it is the argmax, which gives solo decode's
        tokens. The acceptance uniform and the residual draw come from
        :func:`_acceptance_generator` at the position they decide; the
        bonus token after ``k`` accepted drafts is the solo schedule's
        draw at ``col + k + 1``. Rejected drafts leave KV rows past the
        new ``col``, masked until the next window overwrites them.
        ``slots``, ``cache_len``, ``page_len``, ``n_pages`` and
        ``kv_dtype`` keep the JAX package's signature: the step takes its
        shapes and the pool's dtype from its inputs."""
        self._require_built()
        module = self.module if module is None else module
        temperature = float(temperature)
        dev = self.device
        filter_logits, sample = self._filter_logits, self._sample

        def host(a):
            if torch.is_tensor(a):
                return a.to(dev, torch.long)
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        def sampled_choices(logits, drafts, col, seeds):
            """(accept (slots, k) bool, corr (slots, k + 1))."""
            filt = filter_logits(logits, temperature, top_k, top_p)
            probs = torch.softmax(filt, dim=-1)
            drafts_h = drafts.cpu().numpy()
            accept = torch.zeros((filt.shape[0], spec_k), dtype=torch.bool,
                                 device=dev)
            corr = torch.zeros((filt.shape[0], spec_k + 1),
                               dtype=torch.long, device=dev)
            for i in range(filt.shape[0]):
                for j in range(spec_k):
                    d = int(drafts_h[i, j])
                    g = _acceptance_generator(int(seeds[i]),
                                              int(col[i]) + j + 1, dev)
                    u = torch.rand((), device=dev, generator=g)
                    accept[i, j] = u < probs[i, j, d]
                    resid = filt[i, j].clone()
                    resid[d] = NEG_INF
                    noise = torch.rand(resid.shape, device=dev, generator=g)
                    corr[i, j] = torch.argmax(
                        resid - torch.log(-torch.log(noise)))
                corr[i, spec_k] = sample(
                    logits[i:i + 1, spec_k], temperature, top_k, top_p,
                    int(seeds[i]), int(col[i]) + spec_k + 1)[0]
            return accept, corr

        def verify(pool, tok, drafts, col, seeds, block_tables, limit):
            drafts = host(drafts)
            with torch.inference_mode():
                toks = torch.cat([host(tok), drafts], dim=1)
                logits = module(toks, cache=pool, decode_pos=host(col),
                                block_tables=block_tables,
                                verify_limit=host(limit))
                # logits[:, i] scores position col + i + 1, where draft i
                # (or the correction after a rejection) lands
                if temperature <= 0:
                    corr = torch.argmax(
                        filter_logits(logits, temperature), dim=-1)
                    accept = drafts == corr[:, :spec_k]
                else:
                    accept, corr = sampled_choices(logits, drafts, col,
                                                   seeds)
                n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)
                padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])],
                                   dim=1)
                idx = torch.arange(spec_k + 1, device=dev)[None, :]
                emitted = torch.where(
                    idx < n_acc[:, None], padded,
                    torch.where(idx == n_acc[:, None], corr,
                                torch.zeros_like(corr)))
            return emitted, n_acc

        return verify

    def serve_fns_draft(self, slots: int, cache_len: int, spec_k: int,
                        module=None):
        """The draft side of speculative decoding: ``propose(cache, tok
        (slots, 1), col (slots,))`` extends every slot greedily by
        ``spec_k`` tokens over this (draft) model's slot cache (its
        prompt KV comes through :meth:`serve_fns`' prefill and join) and
        gives them as a ``(slots, spec_k)`` device tensor. It runs
        ``spec_k + 1`` forwards: the last appends draft k's KV row, so
        the next window attends a whole prefix whatever was accepted.
        Positions past the cache (a window at the end of a stream, whose
        tokens the session discards) write its last row. ``slots`` keeps
        the JAX package's signature."""
        self._require_built()
        module = self.module if module is None else module
        dev = self.device

        def propose(cache, tok, col):
            tok_t = torch.from_numpy(np.asarray(tok, np.int64)).to(dev)
            col_t = torch.from_numpy(np.asarray(col, np.int64)).to(dev)
            drafts = []
            with torch.inference_mode():
                for j in range(spec_k + 1):
                    pos = torch.clamp(col_t + j, max=cache_len - 1)
                    logits = module(tok_t, cache=cache, decode_pos=pos)
                    tok_t = torch.argmax(
                        self._filter_logits(logits[:, 0], 0.0), dim=-1,
                        keepdim=True)
                    drafts.append(tok_t)
            return torch.cat(drafts[:spec_k], dim=1)

        return propose

    def serving_module(self, weights: str = "bf16") -> nn.Module:
        """The module a serving session with ``weights`` runs
        (:func:`serving_module`)."""
        self._require_built()
        return serving_module(self.module, weights)

    # ------------------------------------------------------------------
    # artifact-store native protocol (catalog/artifacts.py)
    # ------------------------------------------------------------------
    def __lo_save__(self, path: str) -> None:
        save_native(self, path)

    @classmethod
    def __lo_load__(cls, path: str, device="cuda") -> "LanguageModel":
        return load_native(cls, path, device)


# ----------------------------------------------------------------------
# weights in the flax layout, and artifacts (catalog/artifacts.py)
# ----------------------------------------------------------------------
# the engine's checkpoint layout: params (and optimizer slots) as flax
# trees
FLAX_LAYOUT = (weights_lib.params_to_flax, weights_lib.flax_path)


def load_module(module: nn.Module, state_dict, device,
                frozen_base: bool = False) -> nn.Module:
    """``module`` (built on the meta device) on ``device`` with a copy of
    ``state_dict``; with ``frozen_base`` only LoRA adapters keep
    ``requires_grad``."""
    module = module.to_empty(device=device)
    module.load_state_dict(state_dict)
    if frozen_base:
        for name, p in module.named_parameters():
            p.requires_grad_(is_adapter(name))
    return module


def save_native(model, path: str) -> None:
    """``config.json`` and, once built, ``weights.msgpack``: the flax
    tree ``{"params": ...}`` as ``flax.serialization.to_bytes`` writes
    it, which the JAX package's ``__lo_load__`` reads."""
    config = {k: getattr(model, k) for k in model._CONFIG_KEYS}
    config.update(name=model.name, optimizer_spec=model.optimizer_spec,
                  seed=model.seed, history=model.history,
                  built=model.module is not None)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    if model.module is not None:
        ckpt_lib.save_pytree(
            {"params": weights_lib.params_to_flax(model.module.state_dict())},
            os.path.join(path, "weights.msgpack"))


def load_native(cls, path: str, device):
    """The model of a ``config.json`` and its weights: the flax tree of
    ``weights.msgpack`` (keys must match the model's), or the
    ``torch.save``d ``state_dict`` of a ``weights.pt`` that the port
    wrote before it wrote msgpack. Config values the port does not run
    raise here, as they do at construction."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    model = cls(**{k: config[k] for k in cls._CONFIG_KEYS if k in config},
                name=config["name"], device=device)
    # artifacts written before training was ported lack these three
    model.optimizer_spec = config.get("optimizer_spec",
                                      model.optimizer_spec)
    model.seed = config.get("seed", model.seed)
    model.history = config.get("history", model.history)
    if not config["built"]:
        return model
    msgpack_path = os.path.join(path, "weights.msgpack")
    if os.path.exists(msgpack_path):
        target = {"params": weights_lib.params_to_flax(
            model._new_module().state_dict(), leaf=lambda t, _: t)}
        tree = ckpt_lib.load_pytree(msgpack_path, target)["params"]
        state = weights_lib.params_from_flax(tree)
    else:
        state = torch.load(os.path.join(path, "weights.pt"),
                           map_location="cpu", weights_only=True)
    model.set_params(state)
    return model
