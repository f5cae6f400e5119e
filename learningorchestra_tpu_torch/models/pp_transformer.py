"""Pipeline-parallel transformer LM of the port (GPipe or 1F1B over the
``pp`` axis).

Counterpart of :mod:`learningorchestra_tpu.models.pp_transformer`. The
decoder blocks are the pipelined middle (``n_layers / pp`` layers a
stage, the stacked ``(n_layers, ...)`` block tensors cut by stage,
:func:`..parallel.pipeline.stage_slice`); the embedding and the tied
output head run outside the pipeline, where the activation shapes
change. Blocks are plain functions of a parameter dict (pre-norm causal
attention and a SiLU MLP), so one stage function serves every stage.

The parameters are a plain dict, the JAX tree's layout: ``embed``
``(V, D)`` and ``blocks/{ln1, qkv, o, ln2, wi, wo}`` stacked on a
leading ``n_layers`` dimension, kernels ``(in, out)`` as flax keeps
them (:func:`..models.weights.pp_params_to_numpy` and
``pp_params_from_numpy`` carry it across, numpy both ways).

``attention``: ``"flash"`` runs the port's flash kernel on a stage's
microbatch (its plain version for CPU tensors), ``"dense"`` the
full-softmax reference; ``"auto"`` takes the port's LM rule on every
device: the flash kernel wherever it takes the head width
(``head_dim <= attention.MAX_HEAD_DIM``), the dense path above it (the
JAX package's ``"auto"`` runs the kernel on a TPU from 1024 tokens, its
crossover measured there, and the dense path elsewhere).

Over a mesh the batch lies over the data axes (this rank's rows) and is
replicated over ``pp``. :func:`forward` and :func:`next_token_loss` run
the GPipe schedule and are differentiable; :func:`value_and_grad_1f1b`
is the hand-scheduled pass; :func:`fit` trains with either, each rank
holding the embedding and its own stage's layers, and returns the whole
tree on every rank.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from learningorchestra_tpu_torch.models import weights as weights_lib
from learningorchestra_tpu_torch.models.neural import Optimizer
from learningorchestra_tpu_torch.ops import attention as attn_ops
from learningorchestra_tpu_torch.parallel import pipeline as pp_lib
from learningorchestra_tpu_torch.runtime import distributed as dist
from learningorchestra_tpu_torch.runtime import mesh as mesh_lib

BLOCK_KEYS = weights_lib.PP_BLOCK_KEYS


def init_params(seed: int, vocab_size: int, d_model: int, n_layers: int,
                d_ff: Optional[int] = None,
                device="cpu") -> Dict[str, Any]:
    """Random params at the JAX package's scales (normal, standard
    deviation ``1/sqrt(fan_in)``; norms at one), drawn with numpy from
    ``seed``, float32."""
    d_ff = d_ff or 4 * d_model
    rng = np.random.default_rng(seed)
    s_in = 1.0 / math.sqrt(d_model)
    s_ff = 1.0 / math.sqrt(d_ff)

    def normal(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(x).to(device)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    return {
        "embed": normal((vocab_size, d_model), s_in),
        "blocks": {
            "ln1": ones((n_layers, d_model)),
            "qkv": normal((n_layers, d_model, 3 * d_model), s_in),
            "o": normal((n_layers, d_model, d_model), s_in),
            "ln2": ones((n_layers, d_model)),
            "wi": normal((n_layers, d_model, d_ff), s_in),
            "wo": normal((n_layers, d_ff, d_model), s_ff),
        },
    }


def resolve_attention(attention: str, d_model: int, n_heads: int) -> str:
    """``"flash"`` or ``"dense"`` for ``attention`` (see the module
    docstring for ``"auto"``)."""
    if attention not in ("auto", "flash", "dense"):
        raise ValueError(f"unknown attention impl: {attention!r} "
                         f"(auto|flash|dense)")
    if attention != "auto":
        return attention
    return "flash" if d_model // n_heads <= attn_ops.MAX_HEAD_DIM \
        else "dense"


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * scale


def _block(p: Dict[str, torch.Tensor], x: torch.Tensor, n_heads: int,
           attention: str = "auto", window: int = 0) -> torch.Tensor:
    """One decoder block, ``(b, s, d) -> (b, s, d)``."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    b, s, d = x.shape
    impl = resolve_attention(attention, d, n_heads)
    h = _rms_norm(x, p["ln1"])
    q, k, v = (h @ p["qkv"]).chunk(3, dim=-1)
    q, k, v = (t.reshape(b, s, n_heads, d // n_heads).contiguous()
               for t in (q, k, v))
    scale = 1.0 / math.sqrt(d // n_heads)
    if impl == "flash":
        attn = attn_ops.flash_attention(q, k, v, causal=True, scale=scale,
                                        window=window)
    else:
        attn = attn_ops.full_attention_reference(
            q, k, v, causal=True, scale=scale, window=window)
    x = x + attn.reshape(b, s, d) @ p["o"]
    h = _rms_norm(x, p["ln2"])
    return x + F.silu(h @ p["wi"]) @ p["wo"]


def _stage_fn_for(n_heads: int, attention: str = "auto", window: int = 0):
    """The stage body: this stage's layers (the leading dimension of its
    tree), in order."""
    def stage_fn(stage_params: Dict[str, torch.Tensor], x: torch.Tensor):
        for i in range(stage_params["qkv"].shape[0]):
            x = _block({k: v[i] for k, v in stage_params.items()}, x,
                       n_heads, attention, window)
        return x

    return stage_fn


def _embed_in(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The lookup plus fixed sinusoidal positions (no parameters, so the
    stages stay uniform)."""
    x = F.embedding(tokens, embed)
    d = x.shape[-1]
    pos = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)
    freqs = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d
                      * math.log(10000.0))
    ang = pos[:, None] * freqs[None, :]
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None]
    return x + pe.to(x.dtype)


def _stages(mesh) -> Optional[pp_lib.Stages]:
    if mesh is None or mesh.shape.get(mesh_lib.PP, 1) <= 1:
        return None
    return pp_lib.Stages(mesh)


def _tokens(tokens, like: torch.Tensor) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.ascontiguousarray(tokens))
    return tokens.to(like.device).long()


def _layers(params: Dict[str, Any]) -> int:
    return params["blocks"]["qkv"].shape[0]


def _check_layers(params: Dict[str, Any], stages) -> None:
    n = stages.n if stages is not None else 1
    if _layers(params) % n:
        raise ValueError(f"{_layers(params)} layers not divisible by "
                         f"pp={n}")


def forward(params: Dict[str, Any], tokens, mesh, n_heads: int,
            num_microbatches: int = 4, attention: str = "auto",
            window: int = 0) -> torch.Tensor:
    """tokens ``(b, s)`` -> logits ``(b, s, V)`` of this rank's rows
    (all of them off a mesh), the blocks pipelined over ``pp`` (GPipe;
    differentiable), the embedding and the tied head outside."""
    stages = _stages(mesh)
    _check_layers(params, stages)
    embed = params["embed"]
    tokens = _tokens(tokens, embed)
    if stages is not None:
        tokens = stages.rows(tokens)
    x = _embed_in(embed, tokens)
    stage_fn = _stage_fn_for(n_heads, attention, window)
    if stages is not None:
        x = pp_lib.pipeline_apply(
            stage_fn, pp_lib.stage_slice(params["blocks"], stages), x,
            stages, num_microbatches=num_microbatches)
    else:
        x = stage_fn(params["blocks"], x)
    return x @ embed.t()


def _masked_sums(logits: torch.Tensor, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cross-entropy sum, unpadded target count) of the next tokens."""
    tgt = tokens[:, 1:]
    lg = logits[:, :-1].float()
    per_tok = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                              tgt.reshape(-1), reduction="none")
    mask = (tgt != 0).float().reshape(-1)
    return (per_tok * mask).sum(), mask.sum()


def next_token_loss(params: Dict[str, Any], tokens, mesh, n_heads: int,
                    num_microbatches: int = 4, attention: str = "auto",
                    window: int = 0) -> torch.Tensor:
    """The mean next-token cross-entropy over the global batch (GPipe),
    the same on every rank. Over data blocks the sums cross ranks in
    the forward only: each rank's gradient is its block's part, which
    the caller sums over the data axes (:func:`fit` does)."""
    stages = _stages(mesh)
    local = forward(params, tokens, mesh, n_heads, num_microbatches,
                    attention, window)
    toks = _tokens(tokens, local)
    if stages is not None:
        toks = stages.rows(toks)
    total, count = _masked_sums(local, toks)
    if stages is not None and stages.data_group is not None:
        both = dist.reduce_from(torch.stack([total, count.detach()]),
                                stages.data_group)
        total, count = both[0], both[1]
    return total / count.clamp_min(1e-9)


def _head_loss(head: Dict[str, torch.Tensor], out: torch.Tensor,
               y_mb: torch.Tensor) -> torch.Tensor:
    """The tied head's next-token loss of one microbatch (the mean over
    its unpadded tokens)."""
    total, count = _masked_sums(out @ head["embed"].t(), y_mb)
    return total / count.clamp_min(1e-9)


def _lookup_grad(embed: torch.Tensor, tokens: torch.Tensor,
                 dx: torch.Tensor) -> torch.Tensor:
    """The lookup's gradient of ``embed``: ``dx`` rows scattered onto
    their tokens' rows."""
    d = embed.shape[-1]
    return torch.zeros_like(embed, dtype=torch.float32).index_add(
        0, tokens.reshape(-1), dx.reshape(-1, d).float())


def _1f1b_local(embed: torch.Tensor, stage: Dict[str, torch.Tensor],
                tokens: torch.Tensor, stages: pp_lib.Stages, n_heads: int,
                num_microbatches: int, attention: str, window: int):
    """``(loss, dembed, dstage)`` of one 1F1B pass over this rank's rows
    (``dembed`` summed over the data blocks, ``dstage`` this stage's)."""
    with torch.no_grad():
        x = _embed_in(embed, tokens)
    loss, dstage, dhead, dx = pp_lib.pipeline_value_and_grad_1f1b(
        _stage_fn_for(n_heads, attention, window), _head_loss, stage,
        {"embed": embed}, x, tokens, stages,
        num_microbatches=num_microbatches)
    lookup = _lookup_grad(embed, tokens, dx)
    if stages.data_group is not None:
        # the lookup's rows are this block's: the other blocks' add in
        lookup = dist.all_reduce(lookup, stages.data_group)
    return loss, dhead["embed"] + lookup, dstage


def _whole_blocks(stage: Dict[str, torch.Tensor],
                  stages: pp_lib.Stages) -> Dict[str, torch.Tensor]:
    """The stacked blocks from every stage's slice (every stage calls
    this together)."""
    return {k: torch.cat(dist.all_gather(stage[k].detach().contiguous(),
                                         stages.group), dim=0)
            for k in BLOCK_KEYS}


def value_and_grad_1f1b(params: Dict[str, Any], tokens, mesh,
                        n_heads: int, num_microbatches: int = 4,
                        attention: str = "auto", window: int = 0):
    """The hand-scheduled 1F1B pass: ``(loss, grads)``, ``grads`` the
    whole tree (the stages' gradients gathered over ``pp``), the same
    on every rank. The embedding's gradient is the tied head's plus the
    lookup's."""
    stages = _stages(mesh)
    if stages is None:
        raise ValueError("1F1B needs a pp axis of size >= 2")
    _check_layers(params, stages)
    embed = params["embed"]
    tokens = stages.rows(_tokens(tokens, embed))
    stage = pp_lib.stage_slice(params["blocks"], stages)
    loss, dembed, dstage = _1f1b_local(embed, stage, tokens, stages,
                                       n_heads, num_microbatches,
                                       attention, window)
    return loss, {"embed": dembed.to(embed.dtype),
                  "blocks": _whole_blocks(dstage, stages)}


def _gpipe_local(embed: torch.Tensor, stage: Dict[str, torch.Tensor],
                 tokens: torch.Tensor, stages: Optional[pp_lib.Stages],
                 n_heads: int, num_microbatches: int, attention: str,
                 window: int):
    """``(loss, dembed, dstage)`` by autograd through the GPipe schedule
    (both gradients summed over the data blocks)."""
    embed = embed.detach().requires_grad_(True)
    stage = {k: v.detach().requires_grad_(True) for k, v in stage.items()}
    stage_fn = _stage_fn_for(n_heads, attention, window)
    x = _embed_in(embed, tokens)
    if stages is not None:
        x = pp_lib.pipeline_apply(stage_fn, stage, x, stages,
                                  num_microbatches=num_microbatches)
    else:
        x = stage_fn(stage, x)
    total, count = _masked_sums(x @ embed.t(), tokens)
    group = stages.data_group if stages is not None else None
    if group is not None:
        both = dist.reduce_from(torch.stack([total, count.detach()]),
                                group)
        total, count = both[0], both[1]
    loss = total / count.clamp_min(1e-9)
    names = sorted(stage)
    grads = torch.autograd.grad(loss, [embed] + [stage[k] for k in names])
    dembed, dstage = grads[0], dict(zip(names, grads[1:]))
    if group is not None:
        flat = torch.cat([g.reshape(-1) for g in grads])
        flat = dist.all_reduce(flat, group)
        at = 0
        out = []
        for g in grads:
            out.append(flat[at:at + g.numel()].view(g.shape))
            at += g.numel()
        dembed, dstage = out[0], dict(zip(names, out[1:]))
    return loss.detach(), dembed, dstage


def fit(params: Dict[str, Any], tokens, mesh, n_heads: int, steps: int = 4,
        batch_size: Optional[int] = None, learning_rate: float = 1e-3,
        num_microbatches: int = 4, schedule: str = "gpipe",
        attention: str = "auto", window: int = 0,
        ) -> Tuple[Dict[str, Any], List[float]]:
    """A minimal training loop (Adam) over the pipelined LM: each rank
    keeps the embedding and its stage's layers, with their Adam slots;
    ``schedule`` ``"gpipe"`` (autograd through the fill and drain) or
    ``"1f1b"``. Returns the whole trained tree (on every rank) and the
    step losses."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r} (gpipe|1f1b)")
    stages = _stages(mesh)
    _check_layers(params, stages)
    if schedule == "1f1b" and stages is None:
        raise ValueError("1F1B needs a pp axis of size >= 2")
    embed = params["embed"].detach().clone()
    blocks = params["blocks"]
    stage = (pp_lib.stage_slice(blocks, stages) if stages is not None
             else blocks)
    local = {"embed": embed}
    local.update({"blocks." + k: v.detach().clone()
                  for k, v in stage.items()})
    opt = Optimizer({"kind": "adam", "learning_rate": learning_rate})
    opt_state = opt.init(local)
    all_tokens = _tokens(tokens, embed)
    bs = batch_size or all_tokens.shape[0]
    losses: List[float] = []
    for i in range(steps):
        start = (i * bs) % max(1, all_tokens.shape[0] - bs + 1)
        batch = all_tokens[start:start + bs]
        if stages is not None:
            batch = stages.rows(batch)
        stage_now = {k[len("blocks."):]: v for k, v in local.items()
                     if k.startswith("blocks.")}
        if schedule == "1f1b":
            loss, dembed, dstage = _1f1b_local(
                local["embed"], stage_now, batch, stages, n_heads,
                num_microbatches, attention, window)
        else:
            loss, dembed, dstage = _gpipe_local(
                local["embed"], stage_now, batch, stages, n_heads,
                num_microbatches, attention, window)
        grads = {"embed": dembed}
        grads.update({"blocks." + k: g for k, g in dstage.items()})
        opt.update(local, grads, opt_state)
        losses.append(float(loss))
    stage_now = {k[len("blocks."):]: v for k, v in local.items()
                 if k.startswith("blocks.")}
    whole = (_whole_blocks(stage_now, stages) if stages is not None
             else stage_now)
    return {"embed": local["embed"], "blocks": whole}, losses
