"""Training, evaluation and prediction engine of the port.

Counterpart of :mod:`learningorchestra_tpu.runtime.engine` on one card,
for the per-step path of ``Engine.fit``: float32 master params, a
forward and backward in the compute dtype (bfloat16 by default), the
gradients of ``grad_accum`` micro-batches weighted by their sample
weight totals, one optimizer update per step, and epoch records with
``loss``, the metrics, ``epoch``, ``epochSeconds`` and
``samplesPerSecond``. Metric sums stay on the device until the epoch
ends.

The model supplies ``apply_fn(params, batch, train, rng) -> outputs``
and ``loss_fn(outputs, batch, weights) -> loss`` (or ``(loss,
{metric: (sum, count)})`` for metrics the loss already computed), as in
the JAX package. ``rng`` is an integer seed for the step's random draws
(dropout), derived from the fit's seed, the step and the micro-batch.
Only params with ``requires_grad`` get gradients (a LoRA fine-tune
freezes its base weights).

With a checkpointer, ``fit`` follows the JAX package's per-step path:
it restores the newest verified step before training, treats
``epochs`` as the total budget on a real resume (the epochs done come
from the checkpointer's ``progress.json`` when it describes the restored
step, else from the step count), and saves the train state after every
epoch. The saved form is ``{"step", "params", "opt_state"}`` with the
params (and every per-param optimizer slot) in the model's layout
(``param_layout``: the flax tree for the port's models). Because the
shuffle is ``default_rng(seed + epoch)``, dropout draws from ``(seed,
step, micro)`` and the optimizer's count is saved, a resumed fit equals
an uninterrupted one bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from learningorchestra_tpu_torch.runtime.data import MASK_KEY, ArrayBatcher

Params = Dict[str, torch.Tensor]
Metrics = Dict[str, Tuple[torch.Tensor, torch.Tensor]]  # name -> (sum, count)


@dataclasses.dataclass
class TrainState:
    step: int
    # float32 master params, updated in place by the optimizer
    params: Params
    opt_state: Dict[str, Any]


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


def accuracy_metric(outputs, batch, weights):
    """(correct, count): argmax of a multi-class head, or a single
    logit thresholded at 0, against ``batch["y"]``."""
    logits = outputs.float()
    y = batch["y"]
    if logits.ndim >= 2 and logits.shape[-1] > 1:
        pred = logits.argmax(dim=-1).float()
    else:
        if logits.ndim == y.ndim + 1:
            logits = logits[..., 0]
        pred = (logits > 0).float()
    correct = (pred == y.float()).float()
    if weights is None:
        return correct.sum(), torch.tensor(float(correct.numel()),
                                           device=correct.device)
    w = weights.float()
    return (correct * w).sum(), w.sum()


def _step_seed(seed: int, step: int, micro: int) -> int:
    """The random stream of one micro-batch of one step: the port's
    counterpart of ``fold_in(fold_in(PRNGKey(seed), step), micro)``."""
    state = np.random.SeedSequence([seed, step, micro]).generate_state(1)
    return int(state[0]) & (2 ** 63 - 1)


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
                 param_layout: Optional[Tuple[Callable, Callable]] = None):
        """``param_layout`` is ``(to_tree(params, leaf), path(name))``:
        the saved layout of a dict of params (``leaf(tensor,
        transposed)`` makes each value) and the saved path of one
        param with whether it is stored transposed; by default the
        params are saved by name as they are."""
        self._apply_fn = apply_fn
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._metrics = metrics or {}
        self._compute_dtype = compute_dtype
        self._predict_transform = predict_transform
        self._grad_accum = max(1, int(grad_accum))
        self._layout = param_layout

    def init_state(self, params: Params) -> TrainState:
        return TrainState(step=0, params=params,
                          opt_state=self._optimizer.init(params))

    def _cast(self, params: Params) -> Params:
        """The compute-dtype copy of the master params. Autograd carries
        gradients back through the cast to the float32 leaves."""
        return {k: v.to(self._compute_dtype) if v.is_floating_point() else v
                for k, v in params.items()}

    @staticmethod
    def _to_device(batch: Dict[str, np.ndarray],
                   device: torch.device) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    def _loss(self, params: Params, batch, train: bool,
              rng: Optional[int]):
        """``(loss, outputs, extra)``: a loss_fn may return ``(loss,
        {metric: (sum, count)})`` to emit metrics it already computed
        (the fused lm-head loss computes accuracy in its chunked pass)."""
        outputs = self._apply_fn(params, batch, train, rng)
        res = self._loss_fn(outputs, batch, batch.get(MASK_KEY))
        loss, extra = res if isinstance(res, tuple) else (res, {})
        return loss.float(), outputs, extra

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

    def _micro_grads(self, params: Params, batch, rng: int,
                     ) -> Tuple[Params, Metrics]:
        """Gradients and metric sums for one (micro)batch."""
        names = [k for k, p in params.items() if p.requires_grad]
        with torch.enable_grad():
            loss, outputs, extra = self._loss(self._cast(params), batch,
                                              True, rng)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        return (dict(zip(names, grads)),
                self._metric_sums(loss, outputs, extra, batch))

    def _accum_grads(self, params: Params, batch, seed: int, step: int,
                     ) -> Tuple[Params, Metrics]:
        """Sequential micro-batch gradient accumulation: each micro
        gradient is the gradient of that micro's weighted-mean loss, so
        it is weighted by the micro's weight total and the sum
        normalized by the grand total — the single-batch step for any
        mask (a micro of padding only adds nothing)."""
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
            grads, metrics = self._micro_grads(params, micro,
                                               _step_seed(seed, step, i))
            w = metrics["loss"][1].float()
            for k, g in grads.items():
                g = g.float() * w
                g_sum[k] = g if k not in g_sum else g_sum[k] + g
            for k, (s, c) in metrics.items():
                if k in sums:
                    s, c = sums[k][0] + s, sums[k][1] + c
                sums[k] = (s, c)
        w_total = sums["loss"][1].float().clamp_min(1e-9)
        return {k: g / w_total for k, g in g_sum.items()}, sums

    def _train_step_body(self, state: TrainState, batch,
                         seed: int) -> Metrics:
        """One optimizer step on ``batch``; ``state`` changes in place."""
        if self._grad_accum > 1:
            grads, metrics = self._accum_grads(state.params, batch, seed,
                                               state.step)
        else:
            grads, metrics = self._micro_grads(
                state.params, batch, _step_seed(seed, state.step, 0))
        self._optimizer.update(state.params, grads, state.opt_state)
        state.step += 1
        return metrics

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
                opt[key] = np.int64(value)
        return {"step": np.int64(state.step),
                "params": self._tree(state.params, leaf),
                "opt_state": opt}

    def _save_checkpoint(self, checkpointer, state: TrainState,
                         epoch: int) -> None:
        saved = self._saved_form(
            state, lambda t, transposed: (t.detach().t() if transposed
                                          else t.detach()))
        checkpointer.save(int(state.step), saved)
        # the sidecar names the step it describes: resume trusts it only
        # when that step is the one restored
        if hasattr(checkpointer, "save_meta"):
            checkpointer.save_meta({"step": int(state.step),
                                    "epochs_done": epoch + 1})

    def _load_saved(self, state: TrainState, raw: Dict[str, Any]) -> None:
        """Copies a restored saved form into ``state`` in place."""

        def fill(live: Params, tree: Any) -> None:
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
                with torch.no_grad():
                    t.copy_(src)

        fill(state.params, raw["params"])
        for key, value in state.opt_state.items():
            if isinstance(value, dict):
                fill(value, raw["opt_state"][key])
            else:
                state.opt_state[key] = int(raw["opt_state"][key])
        state.step = int(raw["step"])

    def _maybe_restore(self, state: TrainState, checkpointer) -> bool:
        """Restores the newest verified checkpoint into ``state``; True
        on a real resume. A checkpoint of another layout raises: the
        JAX package's params-only migration is not ported."""
        if checkpointer is None or checkpointer.latest_step() is None:
            return False
        target = self._saved_form(state, lambda t, transposed: torch.empty(
            tuple(t.shape[::-1]) if transposed else tuple(t.shape),
            device="meta"))
        try:
            raw = checkpointer.restore(target)
        except (ValueError, KeyError, TypeError) as exc:
            raise ValueError(
                f"the checkpoint's state layout differs from the live "
                f"train state ({type(exc).__name__}: {exc}); resuming its "
                f"params alone (the params-only migration) is not yet "
                f"ported to the PyTorch package") from exc
        if raw is None:
            return False
        self._load_saved(state, raw)
        return True

    # ------------------------------------------------------------------
    def fit(self, state: TrainState, batcher: ArrayBatcher,
            epochs: int = 1, seed: int = 0, checkpointer=None,
            log_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
            ) -> Tuple[TrainState, List[Dict[str, Any]]]:
        """Train ``epochs`` over ``batcher`` one step per batch (the
        total budget on a resume from ``checkpointer``)."""
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
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            sums: Dict[str, torch.Tensor] = {}
            counts: Dict[str, torch.Tensor] = {}
            for batch in batcher.epoch(epoch):
                metrics = self._train_step_body(
                    state, self._to_device(batch, device), seed)
                for k, (s, c) in metrics.items():
                    sums[k] = sums[k] + s if k in sums else s
                    counts[k] = counts[k] + c if k in counts else c
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            record = {k: float(sums[k]) / max(float(counts[k]), 1e-9)
                      for k in sums}
            record.update(epoch=epoch, epochSeconds=round(dt, 4),
                          samplesPerSecond=round(batcher.num_samples / dt,
                                                 2))
            history.append(record)
            if checkpointer is not None:
                self._save_checkpoint(checkpointer, state, epoch)
            if log_fn is not None:
                log_fn(record)
        if checkpointer is not None and \
                hasattr(checkpointer, "wait_until_finished"):
            checkpointer.wait_until_finished()
        return state, history

    @torch.inference_mode()
    def evaluate(self, params: Params,
                 batcher: ArrayBatcher) -> Dict[str, float]:
        device = next(iter(params.values())).device
        cast = self._cast(params)
        sums: Dict[str, Any] = {}
        counts: Dict[str, Any] = {}
        for batch in batcher.epoch(0):
            batch = self._to_device(batch, device)
            loss, outputs, extra = self._loss(cast, batch, False, None)
            metrics = self._metric_sums(loss, outputs, extra, batch)
            for k, (s, c) in metrics.items():
                sums[k] = sums.get(k, 0) + s
                counts[k] = counts.get(k, 0) + c
        return {k: float(sums[k]) / max(float(counts[k]), 1e-9)
                for k in sums}

    @torch.inference_mode()
    def predict(self, params: Params, batcher: ArrayBatcher) -> np.ndarray:
        """Outputs for every sample, float32 on the host (padding
        dropped)."""
        device = next(iter(params.values())).device
        cast = self._cast(params)
        outs = []
        for batch in batcher.epoch(0):
            outputs = self._apply_fn(cast, self._to_device(batch, device),
                                     False, None)
            if self._predict_transform is not None:
                outputs = self._predict_transform(outputs)
            outs.append(to_host(outputs.float()))
        return np.concatenate(outs, axis=0)[:batcher.num_samples]
