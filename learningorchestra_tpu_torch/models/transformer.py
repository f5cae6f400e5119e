"""Decoder-only transformer LM of the PyTorch port.

Counterpart of :mod:`learningorchestra_tpu.models.transformer` for the
serving and training paths: rotary position embeddings (half-split
rotation), RMSNorm as flax computes it, grouped-query attention with an
optional sliding window, a gated-SiLU MLP without bias, dropout, the
next-token loss (with the chunked lm-head form), and
:class:`LanguageModel` with ``fit``/``evaluate``/``predict``,
``generate`` and the continuous-batching serve functions.

Module and parameter names follow the flax tree (``layer_0.attn.q_proj``
for ``layer_0/attn/q_proj``) so :mod:`.weights` maps one onto the other.
The KV cache is a list of ``(k, v)`` tensors per layer, ``(b, cache_len,
kv_heads, head_dim)``, which the forward updates in place (JAX returns a
new cache; writing in place saves a copy of the whole cache per token).
"""

from __future__ import annotations

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
    History, build_optimizer, validation_tail_count)
from learningorchestra_tpu_torch.ops import attention as attn_ops
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


class Attention(nn.Module):
    """Multi-head attention with grouped-query KV heads (``n_kv_heads <
    n_heads``; 1 is MQA). Three branches, as in the JAX module: a
    prefill over the whole sequence, a single-token step at one scalar
    position for the whole batch (solo ``generate``), and a per-row
    step where every row sits at its own position (the serving slots,
    or a left-padded batch)."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int,
                 impl: str, causal: bool, n_kv_heads: int = 0,
                 window: int = 0, rope_base: float = 10000.0):
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
        self.q_proj = nn.Linear(d_model, proj, bias=False)
        self.k_proj = nn.Linear(d_model, self.kv_heads * head_dim,
                                bias=False)
        self.v_proj = nn.Linear(d_model, self.kv_heads * head_dim,
                                bias=False)
        self.o_proj = nn.Linear(proj, d_model, bias=False)

    def _angles(self, rel: torch.Tensor):
        freqs = _rope_freqs(self.head_dim, self.rope_base, rel.device)
        ang = rel.to(torch.float32)[..., None] * freqs
        return torch.cos(ang), torch.sin(ang)

    def forward(self, x, cache=None, decode_pos=None, pad_offset=None):
        b, s, _ = x.shape
        hd = self.head_dim
        q = self.q_proj(x).view(b, s, self.n_heads, hd)
        k = self.k_proj(x).view(b, s, self.kv_heads, hd)
        v = self.v_proj(x).view(b, s, self.kv_heads, hd)

        if decode_pos is not None:
            if s != 1:
                raise ValueError(
                    "multi-position decode (speculative verify) needs the "
                    "paged KV path, which is not yet ported")
            ck, cv = cache
            if isinstance(decode_pos, int) and pad_offset is None:
                # one position for the whole batch
                cos, sin = self._angles(torch.full(
                    (1,), decode_pos, device=x.device))
                c, si = cos[:, None, None, :], sin[:, None, None, :]
                q, k = _rotate(q, c, si), _rotate(k, c, si)
                ck[:, decode_pos] = k[:, 0]
                cv[:, decode_pos] = v[:, 0]
                col = torch.full((b,), decode_pos, device=x.device)
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


class MLP(nn.Module):
    """Gated SiLU, no bias (flax names ``gate``, ``up_proj``,
    ``down_proj``)."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.gate = nn.Linear(d_model, d_ff, bias=False)
        self.up_proj = nn.Linear(d_model, d_ff, bias=False)
        self.down_proj = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, d_model: int, n_heads: int, head_dim: int,
                 d_ff: int, attention: str, causal: bool,
                 n_kv_heads: int = 0, window: int = 0,
                 rope_base: float = 10000.0, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.attn_norm = RMSNorm(d_model)
        self.attn = Attention(d_model, n_heads, head_dim, attention, causal,
                              n_kv_heads=n_kv_heads, window=window,
                              rope_base=rope_base)
        self.mlp_norm = RMSNorm(d_model)
        self.mlp = MLP(d_model, d_ff)

    def forward(self, x, cache=None, decode_pos=None, pad_offset=None,
                train: bool = False, generator=None):
        h = self.attn(self.attn_norm(x), cache=cache,
                      decode_pos=decode_pos, pad_offset=pad_offset)
        if self.dropout and train:
            h = _dropout(h, self.dropout, generator)
        x = x + h
        h = self.mlp(self.mlp_norm(x))
        if self.dropout and train:
            h = _dropout(h, self.dropout, generator)
        return x + h


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
                 dropout: float = 0.0):
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
                rope_base=rope_base, dropout=dropout))
        self.final_norm = RMSNorm(d_model)
        self.lm_head = nn.Linear(d_model, vocab_size, bias=False)

    def forward(self, tokens, cache: Optional[Cache] = None,
                decode_pos=None, pad_offset=None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                fused_head: bool = False):
        """Logits (b, s, vocab) in the params' dtype. The train forward
        (``train``) applies dropout from ``generator``; with
        ``fused_head`` it returns :class:`FusedHeadOut` instead of
        logits, for the chunked loss."""
        x = self.embed(tokens)
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(
                x, cache=None if cache is None else cache[i],
                decode_pos=decode_pos, pad_offset=pad_offset, train=train,
                generator=generator)
        x = self.final_norm(x)
        if train and fused_head:
            return FusedHeadOut(hidden=x, kernel=self.lm_head.weight,
                                aux=torch.zeros((), dtype=torch.float32,
                                                device=x.device))
        return self.lm_head(x)


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
def _position_generator(seed: int, pos: int,
                        device: torch.device) -> torch.Generator:
    """The random stream for the token written at buffer position
    ``pos`` of a request seeded ``seed`` — the port's counterpart of
    ``fold_in(key, pos)``. Solo ``generate`` and a serving slot draw
    from the same stream at the same position."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) % 2 ** 32) << 31) | int(pos))
    return g


class LanguageModel:
    """Trainable LM artifact with the JAX package's configuration keys
    and method surface (``compile``, ``fit``, ``evaluate``, ``predict``,
    ``generate``).

    Covers dense MLP, GQA, sliding window, RoPE and dropout. Options of
    the JAX model that this package does not run yet (MoE, LoRA, fused
    projections, ring/Ulysses attention) raise at construction. Weights
    come in through :meth:`set_params` (see :mod:`.weights`), or from
    ``weights.init_params(seed)`` at the first ``fit``; they stay
    float32 and trainable. ``attention="auto"`` resolves to ``flash``."""

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
        if remat not in (None, "none", "dots", "full"):
            raise ValueError(f"unknown remat policy {remat!r} "
                             f"(none|dots|full)")
        if remat in ("dots", "full"):
            # recomputation needs the dropout generator replayed, which
            # torch.utils.checkpoint does not do
            raise ValueError(f"remat={remat!r} is not yet ported to the "
                             f"PyTorch package (none only)")
        self.remat = remat
        self.fused_proj = bool(fused_proj)
        self.lora_rank = int(lora_rank)
        self.lora_alpha = float(lora_alpha)
        self.sliding_window = int(sliding_window)
        if self.sliding_window < 0:
            raise ValueError(
                f"sliding_window must be >= 0, got {sliding_window}")
        self.rope_base = float(rope_base)
        if self.rope_base <= 1.0:
            raise ValueError(f"rope_base must be > 1, got {rope_base}")
        for key, off in (("n_experts", 0), ("fused_proj", False),
                         ("lora_rank", 0)):
            if getattr(self, key) != off:
                raise ValueError(f"{key}={getattr(self, key)!r} is not "
                                 f"ported to the PyTorch package yet")
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
        float32 logits dominate the step's memory."""
        if self.head_chunk is not None:
            return max(0, int(self.head_chunk))
        return 1024 if self.vocab_size >= 8192 else 0

    def set_params(self, state_dict) -> None:
        """Build the module on the model's device and load weights: the
        float32 master params that ``fit`` trains in place and serving
        reads (under ``inference_mode``)."""
        module = TransformerLM(
            self.vocab_size, d_model=self.d_model, n_layers=self.n_layers,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            d_ff=self.d_ff, attention=self._resolved_attention(),
            causal=True, sliding_window=self.sliding_window,
            rope_base=self.rope_base, dropout=self.dropout)
        module.load_state_dict(state_dict)
        self.module = module.to(self.device)

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
        out = torch.func.functional_call(
            self.module, params, (batch["x"],),
            {"train": train, "generator": generator,
             "fused_head": bool(self._head_chunk())})
        if isinstance(out, FusedHeadOut):
            return out
        return out, torch.zeros((), dtype=torch.float32, device=out.device)

    def _get_engine(self) -> engine_lib.Engine:
        if self._engine is None:
            dtype = torch.bfloat16 if Config().compute_dtype == "bfloat16" \
                else torch.float32
            self._engine = engine_lib.Engine(
                apply_fn=self._apply_fn,
                loss_fn=next_token_loss(
                    self.aux_coef, head_chunk=self._head_chunk() or 1024),
                optimizer=build_optimizer(self.optimizer_spec),
                metrics={"accuracy": token_accuracy},
                compute_dtype=dtype,
                predict_transform=lambda outputs: outputs[0],
                grad_accum=self._accum)
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
        if hasattr(x, "to_numpy"):  # a catalog DataFrame: no _id column
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
        Appends the epoch records to :attr:`history`."""
        if checkpointer is not None:
            raise NotImplementedError(
                "checkpointer= is not yet ported to the PyTorch package")
        self._set_grad_accum(grad_accum)
        val_x = None
        if validation_split:
            x = self._coerce_tokens(x)
            n_val = validation_tail_count(len(x), validation_split)
            val_x = x[-n_val:]
            x = x[:-n_val]
        batcher = self._batcher(x, batch_size, shuffle=shuffle)
        if self.module is None:
            config = {k: getattr(self, k) for k in self._CONFIG_KEYS}
            self.set_params(weights_lib.params_from_flax(
                weights_lib.init_params(config, self.seed)))
        eng = self._get_engine()
        state = eng.init_state(self._master_params())
        state, history = eng.fit(state, batcher, epochs=epochs,
                                 seed=self.seed, log_fn=log_fn)
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
                 top_p: Optional[float] = None) -> np.ndarray:
        """Greedy or sampled continuation with an incremental KV cache:
        the prompt runs once (prefill), then one single-position forward
        per new token. ``top_k``/``top_p`` apply only when
        ``temperature > 0``. Unequal-length prompts (list of lists) are
        left-padded with id 0 and the leading pads stay in the output.
        Returns (b, s + new) int32 tokens."""
        self._require_built()
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

    # ------------------------------------------------------------------
    # resident serving (services/serving.py)
    # ------------------------------------------------------------------
    def serve_fns(self, slots: int, cache_len: int, temperature: float,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None):
        """Continuous-batching functions for a serving session:
        ``(step, prefill_for, join)``.

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
        module, dev, sample = self.module, self.device, self._sample
        temperature = float(temperature)

        def step(cache, tok, col, seeds):
            col_t = torch.from_numpy(np.asarray(col, np.int64)).to(dev)
            tok_t = torch.from_numpy(np.asarray(tok, np.int64)).to(dev)
            with torch.inference_mode():
                logits = module(tok_t, cache=cache, decode_pos=col_t)[:, 0]
                if temperature <= 0:
                    return sample(logits, temperature, None, None, 0, 0)
                return torch.cat([
                    sample(logits[i:i + 1], temperature, top_k, top_p,
                           int(seeds[i]), int(col[i]) + 1)
                    for i in range(logits.shape[0])])

        def prefill_for(s: int):
            def prefill(tokens, seed: int):
                pcache = self._new_cache(1, cache_len)
                with torch.inference_mode():
                    logits = module(tokens, cache=pcache)
                    nxt = sample(logits[:, -1], temperature, top_k, top_p,
                                 seed, s)
                return nxt, pcache

            return prefill

        def join(cache, pcache, slot: int):
            with torch.inference_mode():
                for (ck, cv), (pk, pv) in zip(cache, pcache):
                    ck[slot].copy_(pk[0])
                    cv[slot].copy_(pv[0])
            return cache

        return step, prefill_for, join

    def serve_cache(self, slots: int, cache_len: int) -> Cache:
        """Zero-initialized per-layer KV cache for a serving session."""
        self._require_built()
        return self._new_cache(slots, cache_len)

    # ------------------------------------------------------------------
    # artifact-store native protocol (catalog/artifacts.py)
    # ------------------------------------------------------------------
    def __lo_save__(self, path: str) -> None:
        config = {k: getattr(self, k) for k in self._CONFIG_KEYS}
        config.update(name=self.name, optimizer_spec=self.optimizer_spec,
                      seed=self.seed, history=self.history,
                      built=self.module is not None)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)
        if self.module is not None:
            state = {k: t.detach().cpu()
                     for k, t in self.module.state_dict().items()}
            torch.save(state, os.path.join(path, "weights.pt"))

    @classmethod
    def __lo_load__(cls, path: str, device="cuda") -> "LanguageModel":
        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
        model = cls(**{k: config[k] for k in cls._CONFIG_KEYS
                       if k in config},
                    name=config["name"], device=device)
        # artifacts written before training was ported lack these three
        model.optimizer_spec = config.get("optimizer_spec",
                                          model.optimizer_spec)
        model.seed = config.get("seed", model.seed)
        model.history = config.get("history", model.history)
        if config["built"]:
            state = torch.load(os.path.join(path, "weights.pt"),
                               map_location="cpu", weights_only=True)
            model.set_params(state)
        return model
