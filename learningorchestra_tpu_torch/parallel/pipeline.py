"""Pipeline parallelism over the ``pp`` axis: GPipe and 1F1B.

Counterpart of :mod:`learningorchestra_tpu.parallel.pipeline`. The JAX
package runs one SPMD program over the ``pp`` devices (``shard_map``,
activations handed on by ``ppermute`` each tick); the port runs one
process per stage, and the same tick schedules pass microbatches from
stage to stage by point-to-point send and receive
(:func:`~..runtime.distributed.pipeline_exchange`: one exchange a tick,
posted by every stage at the same tick, so the pairs always meet):

- **GPipe** (:func:`pipeline_apply`): forward fill and drain over
  ``M + n - 1`` ticks, each stage keeping the graph of every microbatch
  it ran; the backward (one autograd node) runs the same ticks in
  reverse, each stage taking its output gradients from the next stage
  and handing its input gradients to the previous one. It composes
  with any loss outside the pipeline: the last stage's output is
  broadcast over ``pp``, so every stage returns it.
- **1F1B** (:func:`pipeline_value_and_grad_1f1b`): each tick a stage
  runs one microbatch forward and one backward; microbatch ``j``'s
  backward starts the tick its forward leaves the last stage, where the
  loss head runs inline. A stage holds at most ``2(n - 1 - s) + 1``
  microbatches in flight (the JAX schedule's bound, which its ring
  stash of depth ``2n - 1`` keeps): the port keeps their graphs rather
  than their inputs, so each microbatch runs its stage forward once
  (the JAX schedule recomputes it in the backward's ``vjp``). Returns
  ``(loss, dstage, dhead, dx)``.

A stage's parameters are a dict of tensors holding its own layers (the
caller slices them from the stacked ``(n_stages, ...)`` tree,
:func:`stage_slice`). The batch lies over the data axes and is
replicated over ``pp``; the 1F1B gradients are averaged over the data
axes, as the JAX function's ``pmean``. A batch that the microbatches do
not divide raises, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from learningorchestra_tpu_torch.runtime import distributed as dist
from learningorchestra_tpu_torch.runtime import mesh as mesh_lib

Params = Dict[str, torch.Tensor]


class Stages:
    """This rank's place on the pipeline of ``mesh``: stage ``index`` of
    ``n``, the global ranks of its neighbours, and the ``pp`` and data
    groups."""

    def __init__(self, mesh: mesh_lib.Mesh, rank: Optional[int] = None):
        if mesh_lib.PP not in mesh.axis_names:
            raise ValueError("mesh has no 'pp' axis")
        rank = dist.rank() if rank is None else int(rank)
        self.shard = mesh_lib.Shard(mesh, rank, seq_parallel=False)
        self.n = self.shard.pp_size
        self.index = self.shard.pp_index
        ranks = self.shard.pp_ranks
        self.prev = ranks[self.index - 1] if self.index > 0 else None
        self.next = ranks[self.index + 1] if self.index < self.n - 1 \
            else None
        self.last = ranks[-1]
        self.group = self.shard.pp_group
        self.data_group = self.shard.row_group
        self.data_size = self.shard.data_size

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global batch's rows."""
        if x.shape[0] % self.data_size:
            raise ValueError(f"batch {x.shape[0]} not divisible by the "
                             f"{self.data_size} data-parallel blocks")
        return x[self.shard.rows(x.shape[0])]


def stage_slice(stacked: Params, stages: Stages) -> Params:
    """This stage's layers of a ``(n_layers, ...)``-stacked tree (its
    ``n_layers / n`` rows)."""
    n_layers = next(iter(stacked.values())).shape[0]
    if n_layers % stages.n:
        raise ValueError(f"{n_layers} layers not divisible by "
                         f"pp={stages.n}")
    per = n_layers // stages.n
    return {k: v[stages.index * per:(stages.index + 1) * per]
            for k, v in stacked.items()}


def _microbatches(x: torch.Tensor, m: int) -> List[torch.Tensor]:
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"microbatches {m}")
    return list(x.chunk(m, dim=0))


def _grads_of(outputs, inputs: List[torch.Tensor], grad_outputs=None):
    """``torch.autograd.grad`` with a zero for an input the outputs do
    not reach."""
    want = [t for t in inputs if t.requires_grad]
    got = torch.autograd.grad(outputs, want, grad_outputs,
                              allow_unused=True)
    it = iter(got)
    out = []
    for t in inputs:
        g = next(it) if t.requires_grad else None
        out.append(torch.zeros_like(t) if g is None else g)
    return out


class _GPipe(torch.autograd.Function):
    """The GPipe schedule as one autograd node: ``x`` (this rank's rows,
    replicated over ``pp``) and this stage's parameter tensors in, the
    last stage's output (on every stage) out."""

    @staticmethod
    def forward(ctx, run, x, *params):
        stage_fn, names, stages, m = run
        micro = _microbatches(x, m)
        leaves = [p.detach().requires_grad_(p.requires_grad)
                  for p in params]
        tree = dict(zip(names, leaves))
        n, s = stages.n, stages.index
        graphs: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        received = None
        outs = []
        for t in range(m + n - 1):
            f = t - s
            sends = []
            if 0 <= f < m:
                inp = micro[f] if s == 0 else received
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    out = stage_fn(tree, inp)
                graphs[f] = (inp, out)
                if stages.next is not None:
                    sends.append((out.detach(), stages.next))
                else:
                    outs.append(out.detach())
            recvs = []
            if stages.prev is not None and 0 <= t + 1 - s < m:
                recvs.append((micro[0], stages.prev))
            got = dist.pipeline_exchange(sends, recvs, stages.group)
            received = got[0] if got else None
        like = torch.empty((x.shape[0],) + tuple(micro[0].shape[1:]),
                           dtype=x.dtype, device=x.device)
        y = torch.cat(outs) if outs else like
        dist.broadcast(y, src=stages.last, group=stages.group)
        ctx.run, ctx.graphs, ctx.leaves = run, graphs, leaves
        ctx.like = micro[0]
        return y

    @staticmethod
    def backward(ctx, grad):
        stage_fn, names, stages, m = ctx.run
        n, s = stages.n, stages.index
        gouts = list(grad.chunk(m, dim=0))
        dparams = [torch.zeros_like(p) for p in ctx.leaves]
        dx = [torch.zeros_like(ctx.like) for _ in range(m)]
        received = None
        for t in reversed(range(m + n - 1)):
            f = t - s
            sends = []
            if 0 <= f < m:
                inp, out = ctx.graphs.pop(f)
                gout = gouts[f] if stages.next is None else received
                got = _grads_of(out, [inp] + ctx.leaves, gout)
                for acc, g in zip(dparams, got[1:]):
                    acc.add_(g)
                if stages.prev is not None:
                    sends.append((got[0], stages.prev))
                else:
                    dx[f] = got[0]
            recvs = []
            if stages.next is not None and 0 <= t - 1 - s < m:
                recvs.append((ctx.like, stages.next))
            got = dist.pipeline_exchange(sends, recvs, stages.group)
            received = got[0] if got else None
        # x is replicated over pp: its gradient is the stages' sum (the
        # first stage's alone is not zero)
        dx = dist.all_reduce(torch.cat(dx), stages.group)
        return (None, dx) + tuple(dparams)


def pipeline_apply(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   stage_params: Params, x: torch.Tensor, mesh,
                   num_microbatches: int = 4) -> torch.Tensor:
    """GPipe: ``stage_{n-1}(...stage_0(x))`` over the ``pp`` ranks of
    ``mesh`` (a Mesh, or this rank's :class:`Stages`), differentiable.
    ``stage_params`` is this stage's tree, ``x`` this rank's rows (the
    same on every stage); every stage returns the last stage's
    output."""
    stages = mesh if isinstance(mesh, Stages) else Stages(mesh)
    names = sorted(stage_params)
    return _GPipe.apply((stage_fn, names, stages, num_microbatches), x,
                        *(stage_params[k] for k in names))


def pipeline_value_and_grad_1f1b(
        stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
        head_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
        stage_params: Params, head_params: Params, x: torch.Tensor,
        y: torch.Tensor, mesh, num_microbatches: int = 4,
        ) -> Tuple[torch.Tensor, Params, Params, torch.Tensor]:
    """One 1F1B training pass: ``(loss, dstage_params, dhead_params,
    dx)``, every one on every stage (``dstage_params`` this stage's).
    ``head_fn(head_params, out_mb, y_mb)`` is a microbatch's loss (its
    mean); the loss is the mean over microbatches, and over the data
    blocks, as are the gradients (``dx`` is this block's rows, scaled by
    the same ``1 / data blocks``). ``x`` and ``y`` are this rank's
    rows."""
    stages = mesh if isinstance(mesh, Stages) else Stages(mesh)
    m = num_microbatches
    micro_x, micro_y = _microbatches(x, m), _microbatches(y, m)
    n, s = stages.n, stages.index
    names = sorted(stage_params)
    heads = sorted(head_params)
    leaves = [stage_params[k].detach().requires_grad_(True) for k in names]
    head_leaves = [head_params[k].detach().requires_grad_(True)
                   for k in heads]
    tree = dict(zip(names, leaves))
    head_tree = dict(zip(heads, head_leaves))
    dparams = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    dhead = [torch.zeros_like(p, dtype=torch.float32) for p in head_leaves]
    dx = [torch.zeros_like(micro_x[0], dtype=torch.float32)
          for _ in range(m)]
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    # the microbatches in flight: forward done, backward not yet
    stash: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    act = grad_in = None
    for t in range(m + 2 * (n - 1)):
        sends = []
        f = t - s
        if 0 <= f < m:
            inp = (micro_x[f] if s == 0 else act).detach() \
                .requires_grad_(True)
            with torch.enable_grad():
                out = stage_fn(tree, inp)
            stash[f] = (inp, out)
            if stages.next is not None:
                sends.append((out.detach(), stages.next))
        b = t - 2 * (n - 1) + s
        if 0 <= b < m:
            inp, out = stash.pop(b)
            if stages.next is None:
                with torch.enable_grad():
                    loss_b = head_fn(head_tree, out, micro_y[b]) / m
                got = _grads_of(loss_b, [inp] + leaves + head_leaves)
                loss = loss + loss_b.detach().float()
                for acc, g in zip(dhead, got[1 + len(leaves):]):
                    acc.add_(g.float())
            else:
                got = _grads_of(out, [inp] + leaves, grad_in)
            for acc, g in zip(dparams, got[1:1 + len(leaves)]):
                acc.add_(g.float())
            if stages.prev is not None:
                sends.append((got[0].to(micro_x[0].dtype), stages.prev))
            else:
                dx[b] = got[0].float()
        recvs = []
        if stages.prev is not None and 0 <= t + 1 - s < m:
            recvs.append((micro_x[0], stages.prev))
        want_grad = stages.next is not None and \
            0 <= t + 1 - 2 * (n - 1) + s < m
        if want_grad:
            recvs.append((micro_x[0], stages.next))
        got = dist.pipeline_exchange(sends, recvs, stages.group)
        act = got[0] if stages.prev is not None and \
            0 <= t + 1 - s < m else None
        grad_in = got[-1] if want_grad else None
    # the loss and the head's gradients live on the last stage, dx on
    # the first: one sum over pp puts them on every stage
    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in dhead]
                     + [g.reshape(-1) for g in dx])
    flat = dist.all_reduce(flat, stages.group)
    n_head = 1 + sum(g.numel() for g in dhead)
    shared, dxs = flat[:n_head], flat[n_head:]
    if stages.data_group is not None:
        # the mean over the data blocks (each block's loss is its own
        # mean); dx rows are the block's own, scaled by the same 1 /
        # blocks the global loss carries
        both = torch.cat([shared] + [g.reshape(-1) for g in dparams])
        both = dist.all_reduce(both, stages.data_group) / stages.data_size
        shared = both[:n_head]
        at = n_head
        for i, g in enumerate(dparams):
            dparams[i] = both[at:at + g.numel()].view(g.shape)
            at += g.numel()
        dxs = dxs / stages.data_size
    out_head, at = {}, 1
    for k, g in zip(heads, dhead):
        out_head[k] = shared[at:at + g.numel()].view(g.shape)
        at += g.numel()
    dxs = dxs.view((x.shape[0],) + tuple(micro_x[0].shape[1:]))
    return shared[0], dict(zip(names, dparams)), out_head, dxs
