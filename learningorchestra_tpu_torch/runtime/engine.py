"""Training, evaluation and prediction engine of the port.

Counterpart of :mod:`learningorchestra_tpu.runtime.engine` on one card:
float32 master params, a forward and backward in the compute dtype
(bfloat16 by default), the gradients of ``grad_accum`` micro-batches
weighted by their sample weight totals, one optimizer update per step,
and epoch records with
``loss``, the metrics, ``epoch``, ``epochSeconds`` and
``samplesPerSecond``. Metric sums stay on the device until the epoch
ends.

How batches reach the card (the JAX package's ``_should_scan`` rule): a
fit whose training arrays take at most ``LO_SCAN_FIT_MAX_BYTES`` over
more than one step an epoch stages ``batcher.padded_arrays()`` on the
card once, and each step gathers its rows there (``index_select`` on the
epoch's order followed by the pad rows), so every batch equals the
per-step feed's bit for bit. A batcher with a ``cache_token`` takes the
staged tensors from the device arena (``runtime/arena.py``) under
``("fit_arrays", token, steps, batch_size, shuffles, device)`` and holds
the pin until the fit ends, however it ends. Any other fit of more
than one step an epoch is fed by ``runtime/data.py``'s
``prefetch_to_device``, which copies the next batches on a side stream
while the current step runs (``LO_PREFETCH_BUFFER=0`` turns it off); a
one-step epoch, and a fit with the prefetch feed off, copy each batch
in the step.

The model supplies ``apply_fn(params, batch, train, rng) -> outputs``
and ``loss_fn(outputs, batch, weights) -> loss`` (or ``(loss,
{metric: (sum, count)})`` for metrics the loss already computed), as in
the JAX package. A ``stateful`` engine carries a mutable model state
beside the params (batch norm's ``batch_stats``: a dict of float32
tensors, never differentiated) and calls ``apply_fn(params,
model_state, batch, train, rng) -> (outputs, new_model_state)``, as
the JAX engine always does; a training step threads the state through
its micro-batches and writes the last one into the train state in
place. ``rng`` is an integer seed for the step's random draws
(dropout), derived from the fit's seed, the step and the micro-batch.
Only params with ``requires_grad`` get gradients (a LoRA fine-tune
freezes its base weights).

With a checkpointer (a :class:`~.checkpoint.Checkpointer` or the
asynchronous :class:`~.async_ckpt.AsyncCheckpointManager`), ``fit``
follows the JAX package's per-step path: it restores the newest verified
step before training (a step of another state layout resumes its params
alone, with a fresh optimizer state, where they still match), treats
``epochs`` as the total budget on a real resume (the epochs done come
from the checkpointer's ``progress.json`` when it describes the restored
step, else from the step count), and saves the train state after every
epoch. The saved form is ``{"step", "params", "opt_state"}`` with the
params (and every per-param optimizer slot) in the model's layout
(``param_layout``: the flax tree for the port's models); a stateful
engine adds ``"model_state"`` as the JAX engine saves it (``{}``, or
``{"batch_stats": ...}`` nested by the state's dotted names). Because the
shuffle is ``default_rng(seed + epoch)``, dropout draws from ``(seed,
step, micro)`` and the optimizer's count is saved, a resumed fit equals
an uninterrupted one bit for bit.

Inside a job (a trace open on the thread) each epoch feeds the
observability plane, as the JAX engine's ``_observe_window`` does: an
``epoch`` span under the thread's current span, one timeline window, and
the roofline of the window (``tflopsPerSecPerChip``, and ``mfu`` against
the card's peak), which also lands in the epoch's record. The FLOPs of a
step are counted once per batch shape, by running that step under
``torch.utils.flop_counter.FlopCounterMode``'s counting (as it stands,
the counter would change the step: :func:`_counted`), and raised to the
model's analytic floor (``flops_floor_fn``): the hand-written attention
kernels are as opaque to the counter as ``pallas_call`` is to XLA's
cost analysis. torch has no bytes-accessed count, so a train window's
roofline carries no bandwidth fields. The train state is ledgered under
the X-ray owner ``train-state`` for the fit.

A sharded fit (``fit(..., shard=...)``, a :class:`~.mesh.Shard` of the
process group's mesh) runs the same program on every rank of the mesh,
as the JAX engine runs one program over its mesh: the batcher pads
every global batch to a multiple of the data-parallel size, each rank
takes its block of rows of every step (and, through the model's
``columns`` function, its block of the sequence, which the staged
epoch holds alone), and after the backward the weighted gradients and
the metric sums are summed over the mesh in one all-reduce. Each rank's
weight is its loss count, so the step is the gradient of the global
mean; a loss normalized over the mesh already (the LM's, whose
gradients cross ranks inside the step) emits ``_gradWeight`` and the
ranks' gradients are summed as they are. Every rank steps the same
optimizer on the same gradients. The
health word is computed after the reduction, so every rank skips or
rolls back together; each rank's random draws fold in its block index.
Checkpoints commit on the mesh's first rank behind a barrier, and every
rank restores. With a parameter layout (``init_state(layout=...)``, a
:class:`~..parallel.sharding.ParamLayout` that shards leaves over
``tp``, ``ep`` or ``fsdp``) each rank keeps only its shard of each
param and of each optimizer slot; the gradients are summed over the
rank's row group only (its (data, sequence) blocks), an fsdp-sharded
leaf's after the reduce-scatter of its gather; the health word's
gradient norm counts every shard once; a checkpoint is gathered whole
on every rank (the saved tree never changes with the mesh) and a
restore slices the whole tree again. Evaluation and prediction run
replicated (every rank the whole batch). Each epoch record of a sharded fit carries
``launchesByRank``: every mesh rank's flash-kernel launches in the epoch
(one small all-gather), so the coordinator's record shows what each
rank ran.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from learningorchestra_tpu_torch.observability import perf as obs_perf
from learningorchestra_tpu_torch.observability import timeline as obs_timeline
from learningorchestra_tpu_torch.observability import trace as obs_trace
from learningorchestra_tpu_torch.observability import xray as obs_xray
from learningorchestra_tpu_torch.ops import attention as attn_ops
from learningorchestra_tpu_torch.parallel import sharding as sharding_lib
from learningorchestra_tpu_torch.runtime import arena as arena_lib
from learningorchestra_tpu_torch.runtime import distributed as dist
from learningorchestra_tpu_torch.runtime import health as health_lib
from learningorchestra_tpu_torch.runtime import mesh as mesh_lib
from learningorchestra_tpu_torch.runtime import preempt
from learningorchestra_tpu_torch.runtime.data import (MASK_KEY, ArrayBatcher,
                                                      prefetch_to_device)
from learningorchestra_tpu_torch.runtime.health import (HealthPolicy,
                                                        NumericalDivergence)

Params = Dict[str, torch.Tensor]
Metrics = Dict[str, Tuple[torch.Tensor, torch.Tensor]]  # name -> (sum, count)

# measured FLOPs per step, by (the model's flops_key, batch shapes): a
# repeat fit of the same model and shapes (a new engine per REST job)
# skips the counted step
_FLOPS_CACHE: Dict[Any, float] = {}


@dataclasses.dataclass
class TrainState:
    step: int
    # float32 master params, updated in place by the optimizer
    params: Params
    opt_state: Dict[str, Any]
    # a stateful model's mutable state (batch statistics), float32
    model_state: Params = dataclasses.field(default_factory=dict)
    # a sharded fit's placement of the params (and of every optimizer
    # slot keyed like them): None while every rank holds them whole
    layout: Optional[sharding_lib.ParamLayout] = None


def default_grad_accum() -> int:
    """Process-wide microbatch-count default (LO_GRAD_ACCUM env)."""
    return max(1, int(os.environ.get("LO_GRAD_ACCUM", "1")))


def resolve_grad_accum(requested: Optional[int],
                       current: int) -> Tuple[int, bool]:
    """Clamp a fit-time ``grad_accum`` override and report whether the
    effective value changed."""
    if requested is None:
        return current, False
    value = max(1, int(requested))
    return value, value != current


def to_host(x: torch.Tensor) -> np.ndarray:
    """A device tensor as a host numpy array."""
    return x.detach().cpu().numpy()


def _total(weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return torch.ones((), dtype=torch.float32)
    return weights.sum().float()


def _weighted_mean(values: torch.Tensor,
                   weights: Optional[torch.Tensor]) -> torch.Tensor:
    values = values.float()
    if weights is None:
        return values.mean()
    weights = weights.float()
    return (values * weights).sum() / weights.sum().clamp_min(1e-9)


def sparse_softmax_loss(outputs, batch, weights):
    """Softmax cross-entropy of float32 logits against integer labels
    ``batch["y"]``, the weighted mean over samples."""
    losses = torch.nn.functional.cross_entropy(
        outputs.float(), batch["y"].long(), reduction="none")
    return _weighted_mean(losses, weights)


def sigmoid_binary_loss(outputs, batch, weights):
    """optax's ``sigmoid_binary_cross_entropy`` of float32 logits (a
    trailing unit axis dropped) against 0/1 labels, the weighted mean."""
    labels = batch["y"].float()
    logits = outputs.float()
    if logits.ndim == labels.ndim + 1 and logits.shape[-1] == 1:
        logits = logits[..., 0]
    losses = torch.nn.functional.binary_cross_entropy_with_logits(
        logits, labels, reduction="none")
    return _weighted_mean(losses, weights)


def mse_loss(outputs, batch, weights):
    """Each sample's mean squared error, the weighted mean."""
    preds = outputs.float()
    y = batch["y"].float()
    if preds.ndim == y.ndim + 1 and preds.shape[-1] == 1:
        preds = preds[..., 0]
    losses = torch.square(preds - y).reshape(preds.shape[0], -1).mean(-1)
    return _weighted_mean(losses, weights)


def _hard_predictions(outputs, batch):
    """(pred, y) as float32 class ids: argmax of a multi-class head, a
    single logit thresholded at 0."""
    logits = outputs.float()
    y = batch["y"]
    if logits.ndim >= 2 and logits.shape[-1] > 1:
        pred = logits.argmax(dim=-1).float()
    else:
        if logits.ndim == y.ndim + 1:
            logits = logits[..., 0]
        pred = (logits > 0).float()
    return pred, y.float()


def accuracy_metric(outputs, batch, weights):
    """(correct, count): argmax of a multi-class head, or a single
    logit thresholded at 0, against ``batch["y"]``."""
    pred, y = _hard_predictions(outputs, batch)
    correct = (pred == y).float()
    if weights is None:
        return correct.sum(), torch.tensor(float(correct.numel()),
                                           device=correct.device)
    w = weights.float()
    return (correct * w).sum(), w.sum()


def _require_binary_head(outputs, metric: str) -> None:
    if outputs.ndim >= 2 and outputs.shape[-1] > 2:
        raise ValueError(
            f"metric {metric!r} is binary (positive = class 1); the "
            f"model head has {outputs.shape[-1]} classes — use "
            f"'accuracy' or a custom metric for multi-class")


def precision_metric(outputs, batch, weights):
    """(true positives, predicted positives), positive = class 1."""
    _require_binary_head(outputs, "precision")
    pred, y = _hard_predictions(outputs, batch)
    w = torch.ones_like(pred) if weights is None else weights.float()
    pred_pos = (pred == 1.0).float() * w
    return (pred_pos * (y == 1.0).float()).sum(), pred_pos.sum()


def recall_metric(outputs, batch, weights):
    """(true positives, actual positives), positive = class 1."""
    _require_binary_head(outputs, "recall")
    pred, y = _hard_predictions(outputs, batch)
    w = torch.ones_like(pred) if weights is None else weights.float()
    actual_pos = (y == 1.0).float() * w
    return (actual_pos * (pred == 1.0).float()).sum(), actual_pos.sum()


def _nest(flat: Params, leaf: Callable) -> Dict[str, Any]:
    """A dict keyed by dotted names as nested dicts of ``leaf(tensor,
    False)``."""
    tree: Dict[str, Any] = {}
    for name, t in flat.items():
        *mods, last = name.split(".")
        node = tree
        for mod in mods:
            node = node.setdefault(mod, {})
        node[last] = leaf(t, False)
    return tree


def _lead(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` of shape (N,) viewed to broadcast over a config-axis
    ``like``; a 0-d ``t`` (one config) as it is."""
    return t if t.ndim == 0 else t.view((-1,) + (1,) * (like.ndim - 1))


def _meta_leaf(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    """A shape-only leaf of ``t`` in the saved layout."""
    return torch.empty(tuple(t.shape[::-1]) if transposed
                       else tuple(t.shape), device="meta")


def _same_structure(live: Any, saved: Any) -> bool:
    """Whether two nested dicts have the same keys throughout and their
    leaves the same shapes."""
    if isinstance(live, dict) or isinstance(saved, dict):
        if not (isinstance(live, dict) and isinstance(saved, dict)) or \
                set(map(str, live)) != set(map(str, saved)):
            return False
        return all(_same_structure(live[k], saved[str(k)]) for k in live)
    return tuple(getattr(live, "shape", ())) == \
        tuple(getattr(saved, "shape", ()))


# domain tags of a rollback's replay: its dropout stream is keyed by the
# rollback count and its shuffle cursor jumps by a prime stride per
# rollback (the JAX engine's _HEALTH_TAG and _ROLLBACK_STRIDE)
_HEALTH_TAG = 0x4845_4C54
_ROLLBACK_STRIDE = 100003


def _nan_key(batch: Dict[str, torch.Tensor]) -> Optional[str]:
    """Which array an armed ``engine_step:nan`` fault poisons: ``x`` if
    floating, else the first floating non-mask array (none in a batch of
    token ids)."""
    keys = [k for k, v in batch.items()
            if k != MASK_KEY and v.is_floating_point()]
    if "x" in keys:
        return "x"
    return keys[0] if keys else None


def _poison_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch with its :func:`_nan_key` array turned to NaN."""
    key = _nan_key(batch)
    if key is None:
        return batch
    out = dict(batch)
    out[key] = out[key] * float("nan")
    return out


def _armed_nan() -> bool:
    """An armed ``engine_step:*:nan`` fault (``services/faults.py``)?"""
    from learningorchestra_tpu_torch.services import faults

    return faults.maybe_nan("engine_step")


_COUNT_MODE: list = []


def _count_mode():
    """``FlopCounterMode``'s dispatch mode, counting each op as it runs
    and changing none. As it stands the counter would change the step:
    its module tracker's gradient hooks reorder the backward's
    accumulation (and trip ``autograd.grad`` on leaf inputs), and it runs
    the decomposition of every op it has no formula for (``silu``'s
    backward among them) in place of the op's kernel. So the tracker is
    left out and nothing is decomposed: the counted step is bit-equal to
    an uncounted one."""
    if not _COUNT_MODE:
        from torch.utils import flop_counter

        class CountMode(flop_counter._FlopCounterMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if isinstance(func, torch._ops.HigherOrderOperator):
                    return super().__torch_dispatch__(func, types, args,
                                                      kwargs)
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                try:
                    self.counter._count_flops(func._overloadpacket, out,
                                              args, kwargs)
                except Exception:  # noqa: BLE001 — a formula that cannot
                    pass  # take this call (bmm's out_dtype) counts 0
                return out

        _COUNT_MODE.append(CountMode)
    return _COUNT_MODE[0]


def _counted(fn: Callable[[], Any]) -> Tuple[Any, float]:
    """``(fn(), FLOPs it ran)`` (:func:`_count_mode`). A counter that
    cannot start or finish counts 0; ``fn`` runs either way."""
    try:
        from torch.utils import flop_counter

        counter = flop_counter.FlopCounterMode(display=False)
        mode = _count_mode()(counter)
        mode.__enter__()
    except Exception:  # noqa: BLE001 — accounting never sinks a fit
        return fn(), 0.0
    flops = 0.0
    try:
        out = fn()
    finally:
        try:
            mode.__exit__(None, None, None)
            flops = float(counter.get_total_flops())
        except Exception:  # noqa: BLE001
            flops = 0.0
    return out, flops


def _step_seed(seed: int, step: int, micro: int, block: int = 0) -> int:
    """The random stream of one micro-batch of one step: the port's
    counterpart of ``fold_in(fold_in(PRNGKey(seed), step), micro)``. A
    sharded step's rank folds in the index of its (data, sequence)
    block, so blocks draw apart (block 0 draws the unsharded stream)."""
    entropy = [seed, step, micro] + ([block] if block else [])
    state = np.random.SeedSequence(entropy).generate_state(1)
    return int(state[0]) & (2 ** 63 - 1)


def _rows(shard: mesh_lib.Shard, batch: Dict[str, torch.Tensor]
          ) -> Dict[str, torch.Tensor]:
    """``shard``'s block of the batch's rows."""
    n = next(iter(batch.values())).shape[0]
    if n % shard.data_size:
        raise ValueError(f"batch of {n} rows does not divide into "
                         f"{shard.data_size} data-parallel blocks")
    rows = shard.rows(n)
    return {k: v[rows] for k, v in batch.items()}


def _grad_weight(metrics: Metrics) -> torch.Tensor:
    """A (micro-)batch's gradient weight: its loss count, or the weight
    the loss emitted (``_gradWeight``)."""
    return metrics.get("_gradWeight", metrics["loss"])[1].float()


def _launches_by_rank(shard: mesh_lib.Shard, since: Dict[str, int],
                      device: torch.device) -> List[Dict[str, int]]:
    """Every mesh rank's kernel launches since ``since`` (its own
    counts), in mesh rank order."""
    now = attn_ops.launch_counts()
    names = sorted(now)
    mine = torch.tensor([now[k] - since.get(k, 0) for k in names],
                        dtype=torch.int64, device=device)
    return [dict(zip(names, (int(v) for v in t.tolist())))
            for t in dist.all_gather(mine, shard.group)]


def _reduce_over(shard: mesh_lib.Shard, grads: Params, metrics: Metrics,
                 layout: Optional[sharding_lib.ParamLayout] = None,
                 ) -> Tuple[Params, Metrics]:
    """The mesh's step from this rank's: ``sum(w_r g_r) / sum(w_r)``
    over the rank's row group (every (data, sequence) block, at this
    rank's model coordinates) with ``w_r`` the rank's loss count, or,
    for a loss normalized over the mesh already (it emits
    ``_gradWeight``), the plain sum of the blocks' gradients; and every
    metric's sum and count summed. One all-reduce over ``row_group``;
    a leaf that fsdp shards had its fsdp sum in the backward's
    reduce-scatter and takes a second one over the other data axes.
    Ranks of one block along ``tp``, ``ep`` or ``pp`` are not summed:
    they hold the same gradient, or each its own shard's."""
    summed = metrics.pop("_gradWeight", None) is not None
    w = 1.0 if summed else metrics["loss"][1].float()
    fsdp = layout.fsdp_dims() if layout is not None else {}
    names = sorted(k for k in grads if k not in fsdp)
    rest = sorted(k for k in grads if k in fsdp)
    keys = sorted(metrics)
    parts = [(grads[k].float() * w).reshape(-1) for k in names]
    for k in keys:
        s, c = metrics[k]
        parts += [s.float().reshape(1), c.float().reshape(1)]
    buf = torch.cat(parts)
    if shard.row_group is not None:
        buf = dist.all_reduce(buf, shard.row_group)
    at = 0
    reduced: Dict[str, torch.Tensor] = {}
    for k in names:
        n = grads[k].numel()
        reduced[k] = buf[at:at + n].view(grads[k].shape)
        at += n
    sums: Metrics = {}
    for k in keys:
        sums[k] = (buf[at], buf[at + 1])
        at += 2
    if rest:
        buf = torch.cat([(grads[k].float() * w).reshape(-1) for k in rest])
        if shard.rest_group is not None:
            buf = dist.all_reduce(buf, shard.rest_group)
        at = 0
        for k in rest:
            n = grads[k].numel()
            reduced[k] = buf[at:at + n].view(grads[k].shape)
            at += n
    total = 1.0 if summed else sums["loss"][1].clamp_min(1e-9)
    return ({k: (g / total).to(grads[k].dtype) for k, g in reduced.items()},
            sums)


class Engine:
    """Training engine over ``(apply_fn, loss_fn, optimizer)``.

    ``metrics`` maps names to ``fn(outputs, batch, weights) -> (sum,
    count)``; a metric the loss already emitted is not recomputed.
    """

    def __init__(self, apply_fn: Callable, loss_fn: Callable, optimizer,
                 metrics: Optional[Dict[str, Callable]] = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 predict_transform: Optional[Callable] = None,
                 grad_accum: int = 1,
                 param_layout: Optional[Tuple[Callable, Callable]] = None,
                 stateful: bool = False,
                 flops_floor_fn: Optional[Callable] = None,
                 flops_key: Any = None):
        """``param_layout`` is ``(to_tree(params, leaf), path(name))``:
        the saved layout of a dict of params (``leaf(tensor,
        transposed)`` makes each value) and the saved path of one
        param with whether it is stored transposed; by default the
        params are saved by name as they are. ``flops_floor_fn(batch)``
        is the model's analytic FLOPs of one train step, the floor of
        the counted ones; ``flops_key`` (hashable) names the model's
        configuration in the process-wide FLOPs cache."""
        self._apply_fn = apply_fn
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._metrics = metrics or {}
        self._compute_dtype = compute_dtype
        self._predict_transform = predict_transform
        self._grad_accum = max(1, int(grad_accum))
        self._layout = param_layout
        self._stateful = stateful
        # the health sentinel of the running fit (fit(health_policy=...))
        self._health_on = False
        self._health_skip = False
        self._skip_buffers: Optional[List[torch.Tensor]] = None
        self._flops_floor_fn = flops_floor_fn
        self._flops_id = flops_key
        # FLOPs of one train step and the batch shapes they were
        # measured at
        self._step_flops: Optional[float] = None
        self._flops_shape: Any = None
        # the running fit's place in the mesh (fit(shard=...))
        self._shard: Optional[mesh_lib.Shard] = None
        self._columns: Optional[Callable] = None

    def init_state(self, params: Params,
                   model_state: Optional[Params] = None,
                   layout: Optional[sharding_lib.ParamLayout] = None,
                   ) -> TrainState:
        """The train state of ``params``; with a ``layout`` that shards
        any leaf, of this rank's shard of each (the whole params are
        sliced, so a sharded fit starts where the one-rank fit starts),
        and the optimizer's slots of the shards."""
        if layout is not None and any(
                sharding_lib.is_sharded(p) for p in layout.specs.values()):
            params = {k: layout.local(k, p.detach()).clone()
                      .requires_grad_(p.requires_grad)
                      for k, p in params.items()}
        else:
            layout = None
        return TrainState(step=0, params=params,
                          opt_state=self._optimizer.init(params),
                          model_state=dict(model_state or {}),
                          layout=layout)

    def whole_params(self, state: TrainState) -> Params:
        """The whole params of ``state`` (a sharded state's gathered:
        every rank of the mesh calls this together)."""
        if state.layout is None:
            return state.params
        return state.layout.gather(state.params)

    def _whole(self, state: TrainState) -> TrainState:
        """``state`` with whole params and optimizer slots (gathered on
        every rank of a sharded state)."""
        if state.layout is None:
            return state
        opt = {k: state.layout.gather(v) if isinstance(v, dict) else v
               for k, v in state.opt_state.items()}
        return TrainState(step=state.step,
                          params=state.layout.gather(state.params),
                          opt_state=opt, model_state=state.model_state)

    @staticmethod
    def _whole_meta(state: TrainState) -> TrainState:
        """``state``'s whole shapes, on the meta device."""
        layout = state.layout
        if layout is None:
            return state

        def meta(tensors):
            return {k: torch.empty(layout.full_shape(k, tuple(t.shape)),
                                   device="meta")
                    for k, t in tensors.items()}

        opt = {k: meta(v) if isinstance(v, dict) else v
               for k, v in state.opt_state.items()}
        return TrainState(step=state.step, params=meta(state.params),
                          opt_state=opt, model_state=state.model_state)

    def _cast(self, params: Params) -> Params:
        """The compute-dtype copy of the master params. Autograd carries
        gradients back through the cast to the float32 leaves."""
        return {k: v.to(self._compute_dtype) if v.is_floating_point() else v
                for k, v in params.items()}

    @staticmethod
    def _to_device(batch: Dict[str, Any],
                   device: torch.device) -> Dict[str, torch.Tensor]:
        """The batch's host arrays as tensors on ``device`` (tensors the
        prefetch feed already placed pass through)."""
        return {k: v if isinstance(v, torch.Tensor) else
                torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    # the feed: staged whole epoch, the prefetch thread, or a copy a step
    # ------------------------------------------------------------------
    @staticmethod
    def _should_stage(batcher: ArrayBatcher) -> bool:
        from learningorchestra_tpu_torch.config import Config

        limit = Config().scan_fit_max_bytes
        return limit > 0 and batcher.total_bytes() <= limit and \
            batcher.steps_per_epoch > 1

    @classmethod
    def _stage(cls, batcher: ArrayBatcher, device: torch.device,
               columns: Optional[Callable] = None,
               ) -> Tuple[Optional[arena_lib.ArenaEntry],
                          Dict[str, torch.Tensor]]:
        """``(pin or None, the padded epoch on device)``: from the device
        arena when the batcher carries a content token. ``columns`` (a
        sharded fit's) cuts the epoch to the rank's block first, and
        such an epoch stays out of the arena."""
        def build() -> Dict[str, torch.Tensor]:
            arrays = batcher.padded_arrays()
            if columns is not None:
                arrays = columns(arrays)
            return cls._to_device(arrays, device)

        if batcher.cache_token is None or columns is not None:
            return None, build()
        entry = arena_lib.get_default_arena().get_or_put(
            ("fit_arrays", batcher.cache_token, batcher.steps_per_epoch,
             batcher.batch_size, batcher.shuffles, str(device)),
            build, tags=batcher.cache_tags)
        return entry, entry.arrays

    @staticmethod
    def _host_feed(batcher: ArrayBatcher, epoch_key: int,
                   device: torch.device, columns: Optional[Callable] = None):
        """The batches of an epoch that is not staged: through the
        prefetch thread when the epoch takes more than one step and
        ``LO_PREFETCH_BUFFER`` is above 0, else the host batches, which
        the step copies (a thread and a side stream for one batch would
        only add their start)."""
        from learningorchestra_tpu_torch.config import Config

        batches = batcher.epoch(epoch_key)
        if columns is not None:
            batches = (columns(b) for b in batches)
        if batcher.steps_per_epoch > 1 and Config().prefetch_buffer > 0:
            return prefetch_to_device(batches, device)
        return batches

    @staticmethod
    def _staged_batches(batcher: ArrayBatcher,
                        staged: Dict[str, torch.Tensor], epoch_key: int,
                        device: torch.device):
        """The batches of ``batcher.epoch(epoch_key)``, gathered from the
        staged epoch: the epoch's order, then the pad rows."""
        steps, bs = batcher.steps_per_epoch, batcher.batch_size
        order = torch.from_numpy(np.concatenate([
            batcher.epoch_order(epoch_key),
            np.arange(batcher.num_samples, steps * bs)])).to(device)
        for j in range(steps):
            idx = order[j * bs:(j + 1) * bs]
            yield {k: v.index_select(0, idx) for k, v in staged.items()}

    # ------------------------------------------------------------------
    def _apply(self, params: Params, model_state: Optional[Params], batch,
               train: bool, rng: Optional[int]):
        """``(outputs, new_model_state)``."""
        if self._stateful:
            return self._apply_fn(params, model_state or {}, batch, train,
                                  rng)
        return self._apply_fn(params, batch, train, rng), model_state

    def _loss(self, params: Params, batch, train: bool,
              rng: Optional[int], model_state: Optional[Params] = None):
        """``(loss, outputs, extra, new_model_state)``: a loss_fn may
        return ``(loss, {metric: (sum, count)})`` to emit metrics it
        already computed (the fused lm-head loss computes accuracy in
        its chunked pass)."""
        outputs, new_state = self._apply(params, model_state, batch, train,
                                         rng)
        res = self._loss_fn(outputs, batch, batch.get(MASK_KEY))
        loss, extra = res if isinstance(res, tuple) else (res, {})
        return loss.float(), outputs, extra, new_state

    @torch.no_grad()
    def _metric_sums(self, loss, outputs, extra, batch) -> Metrics:
        weights = batch.get(MASK_KEY)
        total = _total(weights).to(loss.device)
        metrics = {"loss": (loss.detach() * total, total)}
        metrics.update({k: (s.detach(), c.detach())
                        for k, (s, c) in extra.items()})
        for name, fn in self._metrics.items():
            if name not in extra:  # the loss already emitted this metric
                metrics[name] = fn(outputs, batch, weights)
        return metrics

    def _micro_step(self, params: Params, model_state: Params, batch,
                    rng: int) -> Tuple[Params, Params, Metrics]:
        """Gradients, the new model state and metric sums for one
        (micro)batch."""
        names = [k for k, p in params.items() if p.requires_grad]
        with torch.enable_grad():
            loss, outputs, extra, new_state = self._loss(
                self._cast(params), batch, True, rng, model_state)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        return (dict(zip(names, grads)), new_state,
                self._metric_sums(loss, outputs, extra, batch))

    def _micro_grads(self, params: Params, batch, rng: int,
                     ) -> Tuple[Params, Metrics]:
        """Gradients and metric sums for one (micro)batch of a stateless
        model."""
        grads, _, metrics = self._micro_step(params, {}, batch, rng)
        return grads, metrics

    def _accum_grads(self, params: Params, batch, seed: int, step: int,
                     ) -> Tuple[Params, Metrics]:
        """:meth:`_accum_step` of a stateless model."""
        grads, _, metrics = self._accum_step(params, {}, batch, seed, step)
        return grads, metrics

    def _accum_step(self, params: Params, model_state: Params, batch,
                    seed: int, step: int, micro_step: Optional[Callable] = None,
                    ) -> Tuple[Params, Params, Metrics]:
        """Sequential micro-batch gradient accumulation: each micro
        gradient is the gradient of that micro's weighted-mean loss, so
        it is weighted by the micro's weight total and the sum
        normalized by the grand total — the single-batch step for any
        mask (a micro of padding only adds nothing). The model state
        passes from each micro to the next. ``micro_step`` (default
        :meth:`_micro_step`) may give one weight total per config, each
        weighting its config's gradients."""
        micro_step = micro_step or self._micro_step
        accum = self._grad_accum
        b = batch["x"].shape[0]
        if b % accum:
            raise ValueError(f"batch size {b} is not divisible by "
                             f"grad_accum={accum}")
        m = b // accum
        g_sum: Params = {}
        sums: Metrics = {}
        for i in range(accum):
            micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            grads, model_state, metrics = micro_step(
                params, model_state, micro, self._seed(seed, step, i))
            w = _grad_weight(metrics)
            for k, g in grads.items():
                g = g.float() * _lead(w, g)
                g_sum[k] = g if k not in g_sum else g_sum[k] + g
            for k, (s, c) in metrics.items():
                if k in sums:
                    s, c = sums[k][0] + s, sums[k][1] + c
                sums[k] = (s, c)
        w_total = _grad_weight(sums).clamp_min(1e-9)
        return ({k: g / _lead(w_total, g) for k, g in g_sum.items()},
                model_state, sums)

    def _seed(self, seed: int, step: int, micro: int) -> int:
        block = self._shard.row_index if self._shard is not None else 0
        return _step_seed(seed, step, micro, block)

    def _step_grads(self, state: TrainState, batch, seed: int,
                    ) -> Tuple[Params, Params, Metrics]:
        """The step's gradients, new model state and metric sums: of the
        whole batch, or under a shard of the global batch (this rank's
        block, summed over the mesh)."""
        if self._grad_accum > 1:
            grads, new_state, metrics = self._accum_step(
                state.params, state.model_state, batch, seed, state.step)
        else:
            grads, new_state, metrics = self._micro_step(
                state.params, state.model_state, batch,
                self._seed(seed, state.step, 0))
        if self._shard is not None:
            grads, metrics = _reduce_over(self._shard, grads, metrics,
                                          state.layout)
        return grads, new_state, metrics

    def sharded_grads(self, state: TrainState, batch, seed: int,
                      shard: mesh_lib.Shard, columns: Optional[Callable]
                      = None) -> Tuple[Params, Metrics]:
        """Gradients and metric sums of one step on the global ``batch``
        (host arrays) under ``shard``, the optimizer untouched: what a
        sharded fit's first step computes."""
        if columns is not None:
            batch = columns(batch)
        device = next(iter(state.params.values())).device
        batch = _rows(shard, self._to_device(batch, device))
        self._shard = shard
        self._publish_layout(shard, state)
        try:
            with mesh_lib.sharded(shard):
                grads, _, metrics = self._step_grads(state, batch, seed)
        finally:
            self._shard = None
        return grads, metrics

    @staticmethod
    def _publish_layout(shard: Optional[mesh_lib.Shard],
                        state: TrainState) -> None:
        """Tells the model, through the step's shard, which leaves fsdp
        shards (it gathers them just before use)."""
        if shard is not None:
            shard.fsdp_dims = (state.layout.fsdp_dims()
                               if state.layout is not None else {})

    def _train_step_body(self, state: TrainState, batch,
                         seed: int) -> Metrics:
        """One optimizer step on ``batch``; ``state`` changes in place."""
        grads, new_state, metrics = self._step_grads(state, batch, seed)
        bad = self._health_word(metrics, grads, state) \
            if self._health_on else None
        kept = self._keep(state) if bad is not None and self._health_skip \
            else None
        self._optimizer.update(state.params, grads, state.opt_state)
        with torch.no_grad():
            for k, v in (new_state or {}).items():
                state.model_state[k].copy_(v)
        if bad is not None:
            if kept is not None:
                metrics = self._drop_update(state, kept, bad, metrics)
            metrics["_health_bad"] = (bad.float(),
                                      torch.ones((), device=bad.device))
        state.step += 1
        return metrics

    # ------------------------------------------------------------------
    # the observability plane
    @staticmethod
    def _shape_key(batch) -> Any:
        return tuple(sorted((k, tuple(v.shape)) for k, v in batch.items()))

    def _needs_count(self, batch) -> bool:
        """Whether the next step of ``batch``'s shapes has no FLOPs yet
        (a process-wide cache hit fills them here)."""
        key = self._shape_key(batch)
        if self._step_flops is not None and key == self._flops_shape:
            return False
        cached = (_FLOPS_CACHE.get((self._flops_id, key))
                  if self._flops_id is not None else None)
        if cached is not None:
            self._step_flops, self._flops_shape = cached, key
            return False
        return True

    def _counted_step(self, state: TrainState, batch, seed: int) -> Metrics:
        """:meth:`_train_step_body`, counted (:func:`_counted`): the
        step's FLOPs (forward and backward, every micro-batch) raised to
        the analytic floor."""
        key = self._shape_key(batch)
        metrics, counted = _counted(
            lambda: self._train_step_body(state, batch, seed))
        floor = 0.0
        if self._flops_floor_fn is not None:
            try:
                floor = float(self._flops_floor_fn(batch))
            except Exception:  # noqa: BLE001
                floor = 0.0
        self._step_flops = max(counted, floor)
        self._flops_shape = key
        if self._flops_id is not None:
            _FLOPS_CACHE[(self._flops_id, key)] = self._step_flops
        return metrics

    def _observe_window(self, t0: float, dt: float, steps: int,
                        record: Dict[str, Any], bad_steps: int, *,
                        step: int, epoch: int) -> None:
        """Feed the observability plane once per epoch: the roofline
        block into ``record``, and inside a job an ``epoch`` span under
        the thread's current span, one timeline window and the job's
        perf report. Best-effort: it must never sink a fit."""
        try:
            if self._step_flops and steps > 0 and dt > 0:
                record.update(obs_perf.roofline(
                    self._step_flops, 0.0, steps, dt, 1))
            cur = obs_trace.current()
            if cur is None:
                return
            trace_id, parent = cur
            attrs: Dict[str, Any] = {"epoch": epoch}
            if record.get("loss") is not None:
                attrs["loss"] = round(float(record["loss"]), 6)
            obs_trace.add("epoch", trace_id, t0, t0 + dt, parent=parent,
                          **attrs)
            perf_block = {k: record[k] for k in (
                "mfu", "tflopsPerSecPerChip", "gbPerSecPerChip",
                "arithmeticIntensity", "hbmBwUtil", "boundBy")
                if k in record}
            obs_timeline.record(
                trace_id, step=step, dt=dt,
                examples_per_second=record.get("samplesPerSecond", 0.0),
                loss=record.get("loss"),
                bad_steps=bad_steps if bad_steps else None,
                retrace=False, **perf_block)
            if perf_block:
                obs_perf.record_job(trace_id, dict(
                    perf_block, kind="train", epoch=epoch))
        except Exception:  # noqa: BLE001 — observability is advisory
            pass

    def _ledger_state(self, state: TrainState) -> None:
        """Register the train state (params, optimizer slots, model
        state) in the X-ray ledger under ``train-state``; ``fit``
        releases it."""
        try:
            tensors = list(state.params.values()) + \
                list(state.model_state.values())

            def walk(value) -> None:
                if isinstance(value, torch.Tensor):
                    tensors.append(value)
                elif isinstance(value, dict):
                    for v in value.values():
                        walk(v)
                elif isinstance(value, (list, tuple)):
                    for v in value:
                        walk(v)

            walk(state.opt_state)
            cur = obs_trace.current()
            obs_xray.register(
                "train-state", id(self),
                sum(t.numel() * t.element_size() for t in tensors),
                name=cur[0] if cur else None)
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------------
    # the health sentinel
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _health_word(self, metrics: Metrics, grads: Params,
                     state: TrainState) -> torch.Tensor:
        """True on the card when the step's mean loss or its global
        gradient norm is not finite. A sharded state's norm is taken
        over the shards, each replicated leaf counted once (one scalar
        all-reduce over the mesh), so every rank skips the same step."""
        loss_sum, loss_count = metrics["loss"]
        mean = loss_sum.float() / loss_count.float().clamp_min(1e-9)
        names = list(grads)
        norms = torch._foreach_norm([grads[k].float() for k in names])
        layout = state.layout
        if layout is None:
            gnorm = torch.linalg.vector_norm(torch.stack(norms))
        else:
            # a leaf of s shards is held by size/s ranks each: weigh
            # its squared norm so the mesh's sum counts it once
            size = float(layout.mesh.size)
            square = sum(n.float() ** 2 * (layout.shards(k) / size)
                         for k, n in zip(names, norms))
            gnorm = dist.all_reduce(square.reshape(1),
                                    self._shard.group)[0].sqrt()
        return ~torch.isfinite(mean) | ~torch.isfinite(gnorm)

    @staticmethod
    def _skip_tensors(state: TrainState) -> List[torch.Tensor]:
        """What a skipped step keeps: params, every optimizer slot and
        the model state."""
        tensors = list(state.params.values())
        for value in state.opt_state.values():
            if isinstance(value, dict):
                tensors.extend(value.values())
        tensors.extend(state.model_state.values())
        return tensors

    def _keep(self, state: TrainState) -> Dict[str, Any]:
        """A copy of what the step may change, into the fit's buffers."""
        tensors = self._skip_tensors(state)
        buffers = self._skip_buffers
        if buffers is None or len(buffers) != len(tensors):
            buffers = self._skip_buffers = [torch.empty_like(t)
                                            for t in tensors]
        with torch.no_grad():
            torch._foreach_copy_(buffers, tensors)
        return {"tensors": buffers, "count": state.opt_state.get("count")}

    @staticmethod
    @torch.no_grad()
    def _drop_update(state: TrainState, kept: Dict[str, Any],
                     bad: torch.Tensor, metrics: Metrics) -> Metrics:
        """Puts back what a bad step changed (``where``, since 0 * NaN is
        NaN) and zeroes its metric contributions."""
        for t, old in zip(Engine._skip_tensors(state), kept["tensors"]):
            torch.where(bad, old, t, out=t)
        if kept["count"] is not None:
            state.opt_state["count"] = torch.where(
                bad, kept["count"], state.opt_state["count"])
        return {k: (torch.where(bad, 0.0, s.float()),
                    torch.where(bad, 0.0, c.float()))
                for k, (s, c) in metrics.items()}

    def _set_health(self, policy: Optional[HealthPolicy],
                    state: TrainState, device: torch.device) -> None:
        """Arms the sentinel for a fit. Under ``skip`` the optimizer's
        count moves onto the card, where a bad step can keep it."""
        self._health_on = policy is not None
        self._health_skip = policy is not None and policy.action == "skip"
        self._skip_buffers = None
        count = state.opt_state.get("count")
        if self._health_skip and isinstance(count, int):
            state.opt_state["count"] = torch.tensor(count, dtype=torch.int64,
                                                    device=device)

    @staticmethod
    def _host_count(state: TrainState) -> None:
        count = state.opt_state.get("count")
        if isinstance(count, torch.Tensor):
            state.opt_state["count"] = int(count)

    @staticmethod
    def _new_sentinel() -> Dict[str, Any]:
        """The fit's host-side sentinel state: the EMA of the epoch loss,
        the rollbacks taken, the spike check's cooldown left."""
        return {"ema": None, "rollbacks": 0, "cooldown": 0}

    @staticmethod
    def _snapshot(state: TrainState) -> Dict[str, Any]:
        """A host copy of the train state (rollback without a
        checkpointer)."""
        def host(value):
            if isinstance(value, torch.Tensor):
                return value.detach().to("cpu", copy=True)
            if isinstance(value, dict):
                return {k: host(v) for k, v in value.items()}
            return value

        return {"step": state.step, "params": host(state.params),
                "opt_state": host(state.opt_state),
                "model_state": host(state.model_state)}

    @staticmethod
    @torch.no_grad()
    def _restore_snapshot(state: TrainState, snap: Dict[str, Any]) -> None:
        def fill(live: Dict[str, Any], saved: Dict[str, Any]) -> None:
            for k, v in saved.items():
                if isinstance(v, dict):
                    fill(live[k], v)
                elif isinstance(v, torch.Tensor):
                    live[k].copy_(v)
                else:  # the optimizer's count
                    live[k] = v

        fill(state.params, snap["params"])
        fill(state.opt_state, snap["opt_state"])
        fill(state.model_state, snap["model_state"])
        state.step = snap["step"]

    def _health_epoch_end(self, policy: HealthPolicy, sent: Dict[str, Any],
                          epoch: int, bad_steps: int, loss: float,
                          state: Optional[TrainState], checkpointer,
                          snapshot, log_fn) -> Tuple[bool, Optional[Dict]]:
        """The epoch-boundary policy check, before the epoch's checkpoint
        (a bad epoch never becomes the last good one). ``(proceed,
        event)``: proceed False means re-run the same epoch from the
        restored state; a verdict the policy cannot absorb raises
        :class:`NumericalDivergence`."""
        verdict = None
        if bad_steps > 0 or not np.isfinite(loss):
            verdict = "nonfinite"
        elif sent["cooldown"] > 0:
            # the EMA is stale against freshly restored params
            sent["cooldown"] -= 1
        elif sent["ema"] is not None and \
                loss > policy.spike_factor * max(sent["ema"], 1e-9):
            verdict = "spike"
        if verdict is None:
            sent["ema"] = (loss if sent["ema"] is None else
                           policy.ema_alpha * loss +
                           (1.0 - policy.ema_alpha) * sent["ema"])
            return True, None
        if verdict == "nonfinite":
            health_lib.record("nonfiniteSteps", max(bad_steps, 1))
        else:
            health_lib.record("lossSpikes")
        event = {"kind": verdict, "epoch": epoch, "action": policy.action,
                 "badSteps": bad_steps,
                 "loss": loss if np.isfinite(loss) else None,
                 "ema": sent["ema"], "rollbacks": sent["rollbacks"]}
        restored = None
        if policy.action == "rollback" and \
                sent["rollbacks"] < policy.max_rollbacks:
            # a verified restore: a corrupt newest step is quarantined
            # inside the checkpointer, which falls back to the one before
            if checkpointer is not None and \
                    self._maybe_restore(state, checkpointer):
                restored = state.step
            elif snapshot is not None:
                self._restore_snapshot(state, snapshot)
                restored = state.step
            if restored is not None:
                sent["rollbacks"] += 1
                sent["cooldown"] = policy.cooldown_epochs
                health_lib.record("rollbacks")
                event["rollbacks"] = sent["rollbacks"]
                event["restoredStep"] = int(restored)
        if log_fn is not None:
            try:
                log_fn({"healthEvent": dict(event)})
            except Exception:  # noqa: BLE001 — telemetry must not sink a fit
                pass
        if restored is not None:
            return False, event
        if policy.action == "skip":
            # the updates were dropped on the card; a spike cannot be
            # skipped after the fact, so it joins the EMA
            if np.isfinite(loss):
                sent["ema"] = (loss if sent["ema"] is None else
                               policy.ema_alpha * loss +
                               (1.0 - policy.ema_alpha) * sent["ema"])
            return True, event
        suffix = (f" after {sent['rollbacks']} rollbacks"
                  if policy.action == "rollback" else "")
        raise NumericalDivergence(
            f"epoch {epoch}: {verdict} (badSteps={bad_steps}, "
            f"loss={loss}) under healthPolicy action "
            f"{policy.action!r}{suffix}")

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _tree(self, params: Params, leaf: Callable) -> Any:
        if self._layout is None:
            return {k: leaf(v, False) for k, v in params.items()}
        return self._layout[0](params, leaf)

    def _saved_form(self, state: TrainState, leaf: Callable) -> Dict[str, Any]:
        """``{"step", "params", "opt_state"}`` in the saved layout; an
        optimizer slot keyed by param names takes the params' layout."""
        opt = {}
        for key, value in state.opt_state.items():
            if isinstance(value, dict):
                opt[key] = self._tree(value, leaf)
            else:
                opt[key] = np.int64(int(value))
        saved = {"step": np.int64(state.step),
                 "params": self._tree(state.params, leaf),
                 "opt_state": opt}
        if self._stateful:
            saved["model_state"] = _nest(state.model_state, leaf)
        return saved

    def _save_checkpoint(self, checkpointer, state: TrainState,
                         epoch: int) -> None:
        """Saves the train state; in a sharded fit the mesh's first rank
        commits and every rank waits for it (each holds the same
        state)."""
        shard = self._shard
        # a sharded state is gathered whole on every rank: the saved
        # tree never changes with the mesh
        whole = self._whole(state)
        if shard is None or shard.rank == int(shard.mesh.ranks.flat[0]):
            self._commit(checkpointer, whole, epoch)
        if shard is not None:
            dist.barrier(shard.group)

    def _commit(self, checkpointer, state: TrainState, epoch: int) -> None:
        saved = self._saved_form(
            state, lambda t, transposed: (t.detach().t() if transposed
                                          else t.detach()))
        checkpointer.save(int(state.step), saved)
        # the sidecar names the step it describes: resume trusts it only
        # when that step is the one restored
        if hasattr(checkpointer, "save_meta"):
            checkpointer.save_meta({"step": int(state.step),
                                    "epochs_done": epoch + 1})

    def _fill(self, live: Params, tree: Any,
              layout: Optional[sharding_lib.ParamLayout] = None) -> None:
        """Copies a saved tree in the model's layout into ``live`` (with
        a ``layout``, this rank's shard of each whole saved leaf)."""
        for name, t in live.items():
            if self._layout is None:
                path, transposed = (name,), False
            else:
                path, transposed = self._layout[1](name)
            node = tree
            for part in path:
                node = node[part]
            value = node.T if transposed else node
            with warnings.catch_warnings():
                # the codec's arrays view the file's bytes (read-only)
                warnings.simplefilter("ignore", UserWarning)
                src = torch.as_tensor(value) if not isinstance(
                    value, torch.Tensor) else value
            if layout is not None:
                src = layout.local(name, src)
            with torch.no_grad():
                t.copy_(src)

    @staticmethod
    def _fill_model_state(live: Params, tree: Any) -> None:
        for name, t in live.items():
            node = tree
            for part in name.split("."):
                node = node[part]
            with torch.no_grad():
                t.copy_(torch.as_tensor(np.array(node)))

    def _load_saved(self, state: TrainState, raw: Dict[str, Any]) -> None:
        """Copies a restored saved form into ``state`` in place."""
        self._fill(state.params, raw["params"], state.layout)
        if self._stateful:
            self._fill_model_state(state.model_state, raw["model_state"])
        for key, value in state.opt_state.items():
            if isinstance(value, dict):
                self._fill(value, raw["opt_state"][key], state.layout)
            else:
                state.opt_state[key] = int(raw["opt_state"][key])
        state.step = int(raw["step"])

    def _maybe_restore(self, state: TrainState, checkpointer) -> bool:
        """Restores the newest verified checkpoint into ``state``; True
        on a real resume. A checkpoint of another state layout resumes
        its params alone where they still match (the params-only
        migration, :meth:`_restore_params_only`, warning "rebuilt
        optimizer state fresh"); where they do not, the fit trains from
        scratch with a warning; where the checkpoint cannot be read, the
        restore's error is raised."""
        if checkpointer is None or checkpointer.latest_step() is None:
            return False
        target = self._saved_form(self._whole_meta(state), _meta_leaf)
        try:
            raw = checkpointer.restore(target)
        except (ValueError, KeyError, TypeError) as exc:
            reason = self._restore_params_only(state, checkpointer)
            if reason == "ok":
                warnings.warn(
                    f"checkpoint state layout changed "
                    f"({type(exc).__name__}: {exc}); resumed params at "
                    f"step {state.step} and rebuilt optimizer state fresh",
                    stacklevel=2)
                return True
            if reason == "unreadable":
                # corruption, not drift: training from scratch could
                # overwrite the last good step at the next save
                raise
            warnings.warn(
                f"checkpoint restore failed ({type(exc).__name__}: {exc}); "
                f"state layout changed and params could not be migrated — "
                f"training from scratch instead of resuming", stacklevel=2)
            return False
        if raw is None:
            return False
        self._load_saved(state, raw)
        return True

    def _restore_params_only(self, state: TrainState, checkpointer) -> str:
        """The layout-drift migration: grafts the checkpoint's params,
        its step and (where its structure still matches) its model
        state onto ``state``, and builds the optimizer state fresh. Only
        those subtrees are read (:meth:`Checkpointer.restore_partial`),
        so a drifted optimizer state is never decoded. ``"ok"``;
        ``"mismatch"`` (the params themselves drifted: training from
        scratch is legitimate); ``"unreadable"`` (the checkpoint could
        not be read: the caller re-raises); ``"unsupported"``."""
        if not (hasattr(checkpointer, "saved_metadata") and
                hasattr(checkpointer, "restore_partial")):
            return "unsupported"
        meta = checkpointer.saved_metadata()
        if not isinstance(meta, dict) or "params" not in meta:
            return "mismatch"
        live = self._tree(self._whole_meta(state).params, _meta_leaf)
        if not _same_structure(live, meta["params"]):
            return "mismatch"
        target: Dict[str, Any] = {"params": live}
        if "step" in meta:
            target["step"] = np.int64(0)
        graft_state = False
        if self._stateful and state.model_state and "model_state" in meta:
            live_state = _nest(state.model_state, _meta_leaf)
            graft_state = _same_structure(live_state, meta["model_state"])
            if graft_state:
                target["model_state"] = live_state
        raw = checkpointer.restore_partial(target)
        if raw is None:
            return "unreadable"
        self._fill(state.params, raw["params"], state.layout)
        if graft_state:
            self._fill_model_state(state.model_state, raw["model_state"])
        state.opt_state = self._optimizer.init(state.params)
        if "step" in raw:
            state.step = int(raw["step"])
        return "ok"

    # ------------------------------------------------------------------
    def fit(self, state: TrainState, batcher: ArrayBatcher,
            epochs: int = 1, seed: int = 0, checkpointer=None,
            log_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
            health_policy=None, scan_batches: Optional[bool] = None,
            shard: Optional[mesh_lib.Shard] = None,
            columns: Optional[Callable] = None,
            ) -> Tuple[TrainState, List[Dict[str, Any]]]:
        """Train ``epochs`` over ``batcher`` one step per batch (the
        total budget on a resume from ``checkpointer``) under
        ``health_policy`` (None, an action, a request dict or a
        :class:`HealthPolicy`). ``scan_batches`` forces the staged epoch
        (True) or the host feed (False, :meth:`_host_feed`); None takes
        :meth:`_should_stage`'s rule. ``shard`` makes the fit this
        rank's part of a sharded fit over its mesh, ``columns`` (host
        arrays to host arrays) the rank's block of the sequence."""
        policy = health_lib.coerce_policy(health_policy)
        device = next(iter(state.params.values())).device
        history: List[Dict[str, Any]] = []
        start_epoch = 0
        if self._maybe_restore(state, checkpointer):
            meta = (checkpointer.load_meta()
                    if hasattr(checkpointer, "load_meta") else None)
            if meta and "epochs_done" in meta and \
                    int(meta.get("step", -1)) == state.step:
                start_epoch = min(epochs, int(meta["epochs_done"]))
            else:
                start_epoch = min(
                    epochs, state.step // max(1, batcher.steps_per_epoch))
            if start_epoch >= epochs:
                return state, []
        self._set_health(policy, state, device)
        self._ledger_state(state)
        stage = (self._should_stage(batcher) if scan_batches is None
                 else bool(scan_batches))
        entry = None
        self._shard = shard
        self._columns = columns
        self._publish_layout(shard, state)
        try:
            staged = None
            if stage:
                entry, staged = self._stage(batcher, device, columns)
            with mesh_lib.sharded(shard):
                self._fit_epochs(state, batcher, start_epoch, epochs, seed,
                                 checkpointer, log_fn, policy, device,
                                 history, staged)
        finally:
            self._shard = self._columns = None
            # the pin drops on every exit (a cancel, a timeout, a
            # divergence), or the entry could never be evicted
            if entry is not None:
                entry.release()
            obs_xray.release("train-state", id(self))
            self._health_on = self._health_skip = False
            self._skip_buffers = None
            self._host_count(state)
        if checkpointer is not None and \
                hasattr(checkpointer, "wait_until_finished"):
            checkpointer.wait_until_finished()
        return state, history

    def _fit_epochs(self, state: TrainState, batcher: ArrayBatcher,
                    start_epoch: int, epochs: int, seed: int,
                    checkpointer, log_fn, policy: Optional[HealthPolicy],
                    device: torch.device,
                    history: List[Dict[str, Any]],
                    staged: Optional[Dict[str, torch.Tensor]] = None,
                    ) -> None:
        sent = self._new_sentinel()
        # a rollback without a checkpointer goes back to this copy,
        # renewed after each good epoch
        snapshot = (self._snapshot(state) if policy is not None
                    and policy.action == "rollback" else None)
        epoch = start_epoch
        while epoch < epochs:
            t0 = time.perf_counter()
            mono0 = time.monotonic()
            steps = 0
            guarded = obs_xray.transfer_guard_mode() == "log"
            sums: Dict[str, torch.Tensor] = {}
            counts: Dict[str, torch.Tensor] = {}
            rb = sent["rollbacks"]
            # a rollback's replay re-keys dropout and moves the shuffle
            # cursor, so it does not replay the draws that diverged
            step_seed = seed if rb == 0 else _step_seed(
                seed, _HEALTH_TAG + rb, 0)
            poison = _armed_nan()
            epoch_key = epoch + rb * _ROLLBACK_STRIDE
            launched = attn_ops.launch_counts()
            feed = (self._staged_batches(batcher, staged, epoch_key, device)
                    if staged is not None else
                    self._host_feed(batcher, epoch_key, device,
                                    self._columns))
            with contextlib.closing(feed):
                for batch in feed:
                    # a cancelled or expired job stops here, between
                    # steps
                    preempt.check_cancel()
                    preempt.heartbeat(epoch=epoch, step=state.step,
                                      rollbacks=rb)
                    batch = self._to_device(batch, device)
                    if self._shard is not None:
                        batch = _rows(self._shard, batch)
                    if poison:
                        # a copy: the staged (arena) tensors stay clean
                        batch = _poison_batch(batch)
                        poison = False
                    if steps == 0 and self._needs_count(batch):
                        metrics = self._counted_step(state, batch,
                                                     step_seed)
                    elif guarded:
                        metrics = obs_xray.guarded_call(
                            self._train_step_body, state, batch, step_seed)
                    else:
                        metrics = self._train_step_body(state, batch,
                                                        step_seed)
                    steps += 1
                    for k, (s, c) in metrics.items():
                        sums[k] = sums[k] + s if k in sums else s
                        counts[k] = counts[k] + c if k in counts else c
            # the prefetch feed ends early for a cancelled or expired job:
            # no record of a cut epoch
            preempt.check_cancel()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            bad = sums.pop("_health_bad", None)
            counts.pop("_health_bad", None)
            bad_steps = int(float(bad)) if bad is not None else 0
            record = {k: float(sums[k]) / max(float(counts[k]), 1e-9)
                      for k in sums}
            if policy is not None:
                proceed, event = self._health_epoch_end(
                    policy, sent, epoch, bad_steps,
                    record.get("loss", float("nan")), state, checkpointer,
                    snapshot, log_fn)
                if not proceed:
                    continue  # the same epoch again, from the restore
                if event is not None and bad_steps:
                    record["nonfiniteSteps"] = bad_steps
                if checkpointer is None and policy.action == "rollback":
                    snapshot = self._snapshot(state)
            record.update(epoch=epoch, epochSeconds=round(dt, 4),
                          samplesPerSecond=round(batcher.num_samples / dt,
                                                 2))
            if self._shard is not None:
                record["launchesByRank"] = _launches_by_rank(
                    self._shard, launched, device)
            self._observe_window(mono0, dt, steps, record, bad_steps,
                                 step=state.step, epoch=epoch)
            history.append(record)
            if checkpointer is not None:
                self._save_checkpoint(checkpointer, state, epoch)
            if log_fn is not None:
                log_fn(record)
            epoch += 1
            if epoch < epochs:
                preempt.maybe_yield()

    @torch.inference_mode()
    def evaluate(self, params: Params, batcher: ArrayBatcher,
                 model_state: Optional[Params] = None) -> Dict[str, float]:
        device = next(iter(params.values())).device
        cast = self._cast(params)
        sums: Dict[str, Any] = {}
        counts: Dict[str, Any] = {}
        for step, batch in enumerate(batcher.epoch(0)):
            preempt.check_cancel()
            preempt.heartbeat(phase="evaluate", step=step)
            batch = self._to_device(batch, device)
            loss, outputs, extra, _ = self._loss(cast, batch, False, None,
                                                 model_state)
            metrics = self._metric_sums(loss, outputs, extra, batch)
            for k, (s, c) in metrics.items():
                sums[k] = sums.get(k, 0) + s
                counts[k] = counts.get(k, 0) + c
        return {k: float(sums[k]) / max(float(counts[k]), 1e-9)
                for k in sums}

    @torch.inference_mode()
    def predict(self, params: Params, batcher: ArrayBatcher,
                model_state: Optional[Params] = None) -> np.ndarray:
        """Outputs for every sample, float32 on the host (padding
        dropped)."""
        device = next(iter(params.values())).device
        cast = self._cast(params)
        outs = []
        for step, batch in enumerate(batcher.epoch(0)):
            preempt.check_cancel()
            preempt.heartbeat(phase="predict", step=step)
            outputs, _ = self._apply(cast, model_state,
                                     self._to_device(batch, device), False,
                                     None)
            if self._predict_transform is not None:
                outputs = self._predict_transform(outputs)
            outs.append(to_host(outputs.float()))
        return np.concatenate(outs, axis=0)[:batcher.num_samples]


# ----------------------------------------------------------------------
# sweep fusion: N configs of one architecture that differ only in
# optimizer scalars train as one program over a leading config axis
# ----------------------------------------------------------------------
_FUSED_STATS = {"epochTraces": 0}


def fused_epoch_traces() -> int:
    """How many fused train steps were built process-wide: one per
    cohort (and batch layout). torch traces no program, so this counts
    what the JAX package's counter counts, the fused program's builds."""
    return _FUSED_STATS["epochTraces"]


class FusedSweepUnsupported(RuntimeError):
    """The fused sweep path cannot serve this cohort (the data exceeds
    the staging budget, an unfusable hyperparameter): the sweep runs the
    cohort's points as independent trials."""



class FusedEngine(Engine):
    """The engine's config-axis mode for a fused sweep cohort: params,
    optimizer state and model state stacked on a leading axis of
    ``n_configs``, one value per config of each scalar in ``hyper``
    (``optimizer_factory(hyper)`` builds the stacked update rule).

    A step runs the model of one config under ``torch.func.vmap`` over
    the stacked params and model state (the batch is shared, so every
    config sees the batches its own trial would), with
    ``randomness="same"``: dropout draws from the step's generator once,
    the draws each trial makes. Gradients come from ordinary autograd
    through the vmapped forward, of the sum of the configs' losses (each
    config's params reach only its own loss). ``apply_fn`` is the
    model's forward of one config (recurrent layers run folded over the
    configs). An ``active`` mask freezes early-stopped configs: after the
    update their params, optimizer slots and model state are put back
    with ``torch.where`` and their metric sums zeroed.

    The cohort's padded training arrays are staged on the device once
    (one copy for every config) when they take at most
    ``LO_SCAN_FIT_MAX_BYTES`` and the epoch has more than one step, the
    JAX package's scan-path rule; else :class:`FusedSweepUnsupported`.
    Batches are gathered on the device in the order of
    ``default_rng(seed + epoch)``, the port's own shuffle."""

    def __init__(self, *, apply_fn: Callable, loss_fn: Callable,
                 optimizer_factory: Callable[[Dict[str, Any]], Any],
                 hyper: Dict[str, Any],
                 metrics: Optional[Dict[str, Callable]] = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 grad_accum: int = 1):
        names = tuple(sorted(hyper))
        if not names:
            raise ValueError("fused engine needs hyperparameter arrays")
        self._hyper = {k: np.asarray(hyper[k], np.float64).reshape(-1)
                       for k in names}
        sizes = {len(v) for v in self._hyper.values()}
        if len(sizes) != 1:
            raise ValueError(
                f"hyperparameter arrays disagree on config count: "
                f"{sorted(sizes)}")
        self._n_configs = sizes.pop()
        super().__init__(apply_fn=apply_fn, loss_fn=loss_fn,
                         optimizer=optimizer_factory(self._hyper),
                         metrics=metrics, compute_dtype=compute_dtype,
                         grad_accum=grad_accum, stateful=True)
        self._built: set = set()

    @property
    def n_configs(self) -> int:
        return self._n_configs

    def init_fused_state(self, params: Params,
                         model_state: Optional[Params] = None) -> TrainState:
        """One set of initial params (and model state) copied ``n``
        ways: every config starts from the init its own trial would."""
        n = self._n_configs

        def tile(t: torch.Tensor) -> torch.Tensor:
            return t.detach().unsqueeze(0).repeat(
                (n,) + (1,) * t.ndim).contiguous()

        stacked = {k: tile(p).requires_grad_(p.requires_grad)
                   for k, p in params.items()}
        return TrainState(step=0, params=stacked,
                          opt_state=self._optimizer.init(stacked),
                          model_state={k: tile(v) for k, v in
                                       (model_state or {}).items()})

    # ------------------------------------------------------------------
    def _vmapped(self, params: Params, model_state: Params, batch,
                 train: bool, rng: Optional[int]):
        """``(loss (N,), {metric: (sum (N,), count (N,))}, new model
        state)`` of every config on the shared ``batch``."""
        def one(p, ms):
            loss, outputs, extra, new_ms = self._loss(
                self._cast(p), batch, train, rng, ms)
            return loss, self._metric_sums(loss, outputs, extra, batch), \
                new_ms

        return torch.func.vmap(one, randomness="same")(params, model_state)

    def _fused_micro(self, params: Params, model_state: Params, batch,
                     rng: int) -> Tuple[Params, Params, Metrics]:
        names = [k for k, p in params.items() if p.requires_grad]
        with torch.enable_grad():
            loss, metrics, new_state = self._vmapped(params, model_state,
                                                     batch, True, rng)
            grads = torch.autograd.grad(loss.sum(),
                                        [params[k] for k in names])
        return dict(zip(names, grads)), new_state, metrics

    def _fused_step(self, state: TrainState, batch, seed: int,
                    stop: Optional[torch.Tensor]) -> Metrics:
        """One optimizer step of every config on ``batch``; ``state``
        changes in place. ``stop`` (bool (N,), or None when every config
        is active) freezes configs."""
        if self._grad_accum > 1:
            grads, new_state, metrics = self._accum_step(
                state.params, state.model_state, batch, seed, state.step,
                self._fused_micro)
        else:
            grads, new_state, metrics = self._fused_micro(
                state.params, state.model_state, batch,
                _step_seed(seed, state.step, 0))
        kept = self._keep(state) if stop is not None else None
        self._optimizer.update(state.params, grads, state.opt_state)
        with torch.no_grad():
            for k, v in (new_state or {}).items():
                state.model_state[k].copy_(v)
            if kept is not None:
                for t, old in zip(self._skip_tensors(state),
                                  kept["tensors"]):
                    torch.where(_lead(stop, t), old, t, out=t)
                metrics = {k: (torch.where(stop, 0.0, s.float()),
                               torch.where(stop, 0.0, c.float()))
                           for k, (s, c) in metrics.items()}
        state.step += 1
        return metrics

    # ------------------------------------------------------------------
    def fit_fused(self, state: TrainState, batcher: ArrayBatcher,
                  epochs: int = 1, seed: int = 0, eval_batcher=None,
                  score_fn=None, earlystop: Optional[Dict[str, Any]] = None,
                  log_fn: Optional[Callable] = None,
                  ) -> Tuple[TrainState, List[Dict[str, Any]], np.ndarray,
                             List[Optional[int]]]:
        """``(state, history, active, stopped_epochs)``, the stacked
        state ledgered as ``train-state`` for the fit. History records
        hold one value per config of each metric. Early stop needs
        ``eval_batcher`` and ``score_fn``: a config whose EMA validation
        score trails the cohort's best by more than
        ``earlystop["margin"]`` stops (``active[i]`` False,
        ``stopped_epochs[i]`` the epoch its params froze at)."""
        self._ledger_state(state)
        entry = None
        try:
            if not self._should_stage(batcher):
                raise FusedSweepUnsupported(
                    "dataset exceeds the fused staging budget "
                    "(LO_SCAN_FIT_MAX_BYTES), or an epoch has one step")
            device = next(iter(state.params.values())).device
            entry, staged = self._stage(batcher, device)
            return self._fit_fused_impl(state, batcher, staged, epochs,
                                        seed, eval_batcher, score_fn,
                                        earlystop, log_fn)
        finally:
            if entry is not None:
                entry.release()
            obs_xray.release("train-state", id(self))

    def _fit_fused_impl(self, state, batcher, staged, epochs, seed,
                        eval_batcher, score_fn, earlystop, log_fn):
        n = self._n_configs
        device = next(iter(state.params.values())).device
        steps, bs = batcher.steps_per_epoch, batcher.batch_size
        key = (steps, bs, batcher.shuffles)
        if key not in self._built:
            self._built.add(key)
            _FUSED_STATS["epochTraces"] += 1
        active = np.ones(n, bool)
        stopped: List[Optional[int]] = [None] * n
        ema: List[Optional[float]] = [None] * n
        es = dict(earlystop or {})
        es_margin = float(es.get("margin", 0.0) or 0.0)
        es_armed = (es_margin > 0.0 and eval_batcher is not None
                    and score_fn is not None)
        es_min_epochs = max(1, int(es.get("min_epochs", 2)))
        es_alpha = float(es.get("alpha", 0.5))
        history: List[Dict[str, Any]] = []
        for epoch in range(epochs):
            preempt.check_cancel()
            preempt.heartbeat(epoch=epoch, fusedConfigs=n)
            t0 = time.perf_counter()
            mono0 = time.monotonic()
            stop = None if active.all() else \
                torch.from_numpy(~active).to(device)
            sums: Dict[str, torch.Tensor] = {}
            counts: Dict[str, torch.Tensor] = {}
            for batch in self._staged_batches(batcher, staged, epoch,
                                              device):
                preempt.check_cancel()
                preempt.heartbeat(epoch=epoch, step=state.step,
                                  fusedConfigs=n)
                metrics = self._fused_step(state, batch, seed, stop)
                for k, (s, c) in metrics.items():
                    sums[k] = sums[k] + s if k in sums else s
                    counts[k] = counts[k] + c if k in counts else c
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            record: Dict[str, Any] = {
                k: (to_host(sums[k]).astype(np.float64) / np.maximum(
                    to_host(counts[k]).astype(np.float64), 1e-9)
                    ).round(6).tolist() for k in sums}
            record.update(epoch=epoch, epochSeconds=round(dt, 4))
            self._observe_window(mono0, dt, steps, {"epoch": epoch}, 0,
                                 step=state.step, epoch=epoch)
            history.append(record)
            if log_fn is not None:
                log_fn(record)
            if es_armed and epoch + 1 < epochs:
                vals = self.evaluate_fused(state, eval_batcher)
                for i in range(n):
                    if not active[i]:
                        continue
                    score = score_fn({k: float(v[i])
                                      for k, v in vals.items()})
                    ema[i] = (score if ema[i] is None else
                              es_alpha * score + (1.0 - es_alpha) * ema[i])
                live = [ema[i] for i in range(n) if active[i]]
                best = max(v for v in live if v is not None)
                if epoch + 1 >= es_min_epochs:
                    for i in range(n):
                        if active[i] and ema[i] is not None and \
                                best - ema[i] > es_margin:
                            active[i] = False
                            stopped[i] = epoch + 1
            if epoch + 1 < epochs:
                preempt.maybe_yield()
        return state, history, active, stopped

    @torch.inference_mode()
    def evaluate_fused(self, state: TrainState,
                       batcher: ArrayBatcher) -> Dict[str, np.ndarray]:
        """Per-config metric means: name -> array (N,)."""
        device = next(iter(state.params.values())).device
        sums: Dict[str, Any] = {}
        counts: Dict[str, Any] = {}
        for step, batch in enumerate(batcher.epoch(0)):
            preempt.check_cancel()
            preempt.heartbeat(phase="evaluate_fused", step=step)
            _, metrics, _ = self._vmapped(
                state.params, state.model_state,
                self._to_device(batch, device), False, None)
            for k, (s, c) in metrics.items():
                sums[k] = sums.get(k, 0) + s
                counts[k] = counts.get(k, 0) + c
        return {k: to_host(sums[k]).astype(np.float64) / np.maximum(
            to_host(counts[k]).astype(np.float64), 1e-9) for k in sums}
