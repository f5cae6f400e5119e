"""The port's ``NeuralModel`` (the JAX package's keras-shaped model over
:mod:`.sequential_module`) and the training surface the port's language
model shares with it: the optimizer specs, the keras-shaped ``History``
and the validation tail split.

:func:`build_optimizer` writes out in PyTorch the five optax update
rules the JAX package builds from an optimizer spec, with optax's
formulas and defaults kept where ``torch.optim`` differs:

- ``adam``: ``beta_1``, ``beta_2`` from the spec, eps 1e-8 outside the
  root, bias-corrected moments;
- ``adamw``: adam at its default betas (the spec's ``beta_1``/``beta_2``
  are not read), then weight decay (``weight_decay``, default 1e-4)
  added to the update of tensors with ``ndim >= 2`` only;
- ``sgd``: optax's ``trace`` momentum (``momentum``, ``nesterov``);
- ``rmsprop``: ``g * rsqrt(nu + 1e-8)`` (eps inside the root), decay
  ``rho``, then ``trace`` momentum after the learning rate;
- ``adagrad``: the squared-gradient sum starts at 0.1, ``rsqrt(sum +
  1e-7)``.

:class:`FrozenBaseOptimizer` is the JAX package's LoRA optimizer
(``optax.multi_transform`` of the update rule over ``lora_*`` leaves and
``set_to_zero`` over the rest): only the adapters get updates and
optimizer state.

:class:`NeuralModel` keeps the JAX class's methods and semantics:
``add``, ``compile`` (strings, spec dicts, objects with a ``spec``),
``fit`` with ``validation_data``, the tail ``validation_split``,
keras's ``sample_weight`` and ``class_weight``, ``grad_accum``,
``shuffle``, a ``checkpointer`` and a ``health_policy`` (the engine's
training health sentinel; the language model and the classifier take
none, as in the JAX package); ``evaluate``; ``predict`` (the
output softmax or sigmoid applied on the host); ``summary``,
``num_params``, ``save_weights``/``load_weights`` (``.npz``, and a
keras ``.h5``/``.weights.h5``); the keras import and export
(``from_keras``, ``from_savedmodel``, ``from_legacy_h5``, ``to_keras``,
``save_keras``, through :mod:`.weights_io`); and the artifact protocol,
``config.json`` and ``weights.msgpack`` of ``{"params", "model_state"}``
in flax's bytes, so an artifact of either package loads in the other.
An ``embedding`` first layer takes int64 token ids, and ids outside
``[0, vocab)`` raise ``ValueError`` before anything reaches the card
(the JAX package takes them). Batch norm's statistics are the engine's
model state. Mesh placement is not ported.

Sweep fusion: :meth:`NeuralModel.fit_sweep_fused` trains a cohort of
sweep points that differ only in the optimizer scalars of
:data:`_FUSABLE_BY_KIND` as one program over a leading config axis
(:class:`~learningorchestra_tpu_torch.runtime.engine.FusedEngine`);
:class:`Optimizer` takes those scalars as one value per config.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from learningorchestra_tpu_torch.config import Config, resolve_device
from learningorchestra_tpu_torch.models import sequential_module as seq_lib
from learningorchestra_tpu_torch.models import weights as weights_lib
from learningorchestra_tpu_torch.runtime import checkpoint as ckpt_lib
from learningorchestra_tpu_torch.runtime import data as data_lib
from learningorchestra_tpu_torch.runtime import engine as engine_lib

Params = Dict[str, torch.Tensor]

_KINDS = ("adam", "adamw", "sgd", "rmsprop", "adagrad")


class Optimizer:
    """One optax update rule over a dict of float32 tensors, which
    :meth:`update` changes in place (optax returns new arrays; updating
    in place saves a copy of every parameter per step).

    With ``hyper`` (a fused sweep: the spec's fusable scalars as arrays
    of one value per config) every tensor carries a leading config axis
    and each of those scalars is a float32 tensor of shape (N,) broadcast
    over its leaf, with the values the unstacked rule would use: the
    Python float each config's own spec gives, cast to float32."""

    def __init__(self, spec: Dict[str, Any],
                 hyper: Optional[Dict[str, Any]] = None):
        self.kind = spec.get("kind", "adam").lower()
        if self.kind not in _KINDS:
            raise ValueError(f"unknown optimizer: {self.kind!r}")
        self.spec = dict(spec)
        self.hyper = None if hyper is None else {
            k: np.asarray(v, np.float64).reshape(-1) for k, v in hyper.items()}

        def value(key: str, default):
            if self.hyper is not None and key in self.hyper:
                return self.hyper[key]
            return float(spec.get(key, default))

        self.lr = value("learning_rate",
                        spec.get("lr", _FUSABLE_DEFAULTS["learning_rate"]))
        if self.kind == "adam":
            self.b1 = value("beta_1", 0.9)
            self.b2 = value("beta_2", 0.999)
        else:
            self.b1, self.b2 = 0.9, 0.999
        self.weight_decay = value("weight_decay", 1e-4)
        self.momentum = value("momentum", 0.0)
        self.nesterov = bool(spec.get("nesterov", False))
        self.rho = value("rho", 0.9)
        # the scalars of the update, each a float or one value per config
        self._consts = {
            "-lr": -self.lr, "b1": self.b1, "1-b1": 1 - self.b1,
            "b2": self.b2, "1-b2": 1 - self.b2, "wd": self.weight_decay,
            "momentum": self.momentum, "rho": self.rho, "1-rho": 1 - self.rho}
        self._lead = 0 if self.hyper is None else 1
        self._on_device: Dict[Any, torch.Tensor] = {}

    def _c(self, name: str, p: torch.Tensor, value=None):
        """Scalar ``name`` for leaf ``p``: a float, or a config-axis
        float32 tensor shaped to broadcast over ``p``."""
        value = self._consts[name] if value is None else value
        if not isinstance(value, np.ndarray):
            return value
        key = (name, p.device, p.ndim)
        t = self._on_device.get(key)
        if t is None:
            t = torch.tensor(value, dtype=torch.float32, device=p.device)
            t = t.view((-1,) + (1,) * (p.ndim - 1))
            if name not in ("bc1", "bc2"):  # these change every step
                self._on_device[key] = t
        return t

    @staticmethod
    def _bias_correction(beta, count):
        # optax raises the float32 decay to the int32 count
        if isinstance(beta, np.ndarray):
            return np.asarray([float(1 - np.float32(b) ** count)
                               for b in beta])
        return float(1 - np.float32(beta) ** count)

    def init(self, params: Params) -> Dict[str, Any]:
        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}

        if self.kind in ("adam", "adamw"):
            return {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.kind == "sgd":
            return {"trace": zeros()}
        if self.kind == "rmsprop":
            return {"nu": zeros(), "trace": zeros()}
        return {"sum_of_squares": {k: torch.full_like(p, 0.1)
                                   for k, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Params, grads: Params,
               state: Dict[str, Any]) -> None:
        """One step: ``params`` and ``state`` change in place."""
        c = self._c
        if self.kind in ("adam", "adamw"):
            count = state["count"] + 1
            state["count"] = count
            if isinstance(count, torch.Tensor):
                # a skip-guarded fit keeps the count on the card (the
                # engine selects it with the rest of a bad step's state)
                count = count.float()
                bc1 = 1 - torch.pow(self.b1, count)
                bc2 = 1 - torch.pow(self.b2, count)
            else:
                count = np.float32(count)
                bc1 = self._bias_correction(self.b1, count)
                bc2 = self._bias_correction(self.b2, count)
        for name, p in params.items():
            g = grads[name].float()
            if self.kind in ("adam", "adamw"):
                mu, nu = state["mu"][name], state["nu"][name]
                mu.copy_(c("1-b1", p) * g + c("b1", p) * mu)
                nu.copy_(c("1-b2", p) * (g * g) + c("b2", p) * nu)
                u = (mu / c("bc1", p, bc1)) / (
                    torch.sqrt(nu / c("bc2", p, bc2)) + 1e-8)
                if self.kind == "adamw" and p.ndim - self._lead >= 2:
                    u = u + c("wd", p) * p
                u = c("-lr", p) * u
            elif self.kind == "sgd":
                trace = state["trace"][name]
                trace.copy_(g + c("momentum", p) * trace)
                u = g + c("momentum", p) * trace if self.nesterov else trace
                u = c("-lr", p) * u
            elif self.kind == "rmsprop":
                nu, trace = state["nu"][name], state["trace"][name]
                nu.copy_(c("1-rho", p) * (g * g) + c("rho", p) * nu)
                u = c("-lr", p) * (torch.rsqrt(nu + 1e-8) * g)
                trace.copy_(u + c("momentum", p) * trace)
                u = trace
            else:
                ss = state["sum_of_squares"][name]
                ss.add_(g * g)
                u = torch.where(ss > 0, torch.rsqrt(ss + 1e-7), 0.0) * g
                u = c("-lr", p) * u
            p.add_(u.to(p.dtype))


def is_adapter(name: str) -> bool:
    """Whether a param (``layer_0.attn.q_proj.lora_a``) is a LoRA
    adapter, the only leaves a fine-tune trains."""
    return name.rsplit(".", 1)[-1].startswith("lora_")


class FrozenBaseOptimizer:
    """An :class:`Optimizer` over the adapters alone: frozen params get
    neither updates nor optimizer state (and the model gives them no
    gradients). The weight-decay mask stays the update rule's own."""

    def __init__(self, base: Optimizer):
        self.base = base
        self.spec = base.spec

    def init(self, params: Params) -> Dict[str, Any]:
        return self.base.init({k: p for k, p in params.items()
                               if is_adapter(k)})

    def update(self, params: Params, grads: Params,
               state: Dict[str, Any]) -> None:
        self.base.update({k: p for k, p in params.items()
                          if is_adapter(k)}, grads, state)


def build_optimizer(spec: Dict[str, Any], frozen_base: bool = False):
    """The update rule of ``spec``; with ``frozen_base`` over the LoRA
    adapters only."""
    opt = Optimizer(spec)
    return FrozenBaseOptimizer(opt) if frozen_base else opt


# Which hyperparameters of each optimizer kind are pure scalar inputs to
# the update, so a fused sweep may vary them per config without changing
# the optimizer state's structure. Everything else (the kind, nesterov,
# batch_size, epochs) changes the program and keeps that sweep point an
# independent trial.
_FUSABLE_BY_KIND = {
    "adam": ("learning_rate", "beta_1", "beta_2"),
    "adamw": ("learning_rate", "weight_decay", "beta_1", "beta_2"),
    "sgd": ("learning_rate", "momentum"),
    "rmsprop": ("learning_rate", "rho", "momentum"),
    "adagrad": ("learning_rate",),
}

# the defaults of the update rules, for grid points that vary a key some
# sibling point omits
_FUSABLE_DEFAULTS = {"learning_rate": 1e-3, "beta_1": 0.9,
                     "beta_2": 0.999, "weight_decay": 1e-4,
                     "momentum": 0.0, "rho": 0.9}


def fusable_hyperparams(spec: Dict[str, Any]) -> Tuple[str, ...]:
    """The optimizer-spec keys a fused sweep may vary for this kind."""
    return _FUSABLE_BY_KIND.get(spec.get("kind", "adam").lower(), ())


def build_optimizer_factory(spec: Dict[str, Any]):
    """``factory(hyper)``: the update rule of ``spec`` over tensors with
    a leading config axis, ``hyper`` (name -> one value per config)
    layered over the spec's own scalars."""
    base = dict(spec)

    def factory(hyper: Dict[str, Any]) -> Optimizer:
        return Optimizer(base, hyper=hyper)

    return factory


def validation_tail_count(n: int, split: float) -> int:
    """Validated keras-style tail-split size: 0 < split < 1 and at
    least one training row must remain."""
    split = float(split)
    if not 0.0 < split < 1.0:
        raise ValueError(
            f"validation_split must be in (0, 1), got {split}")
    n_val = max(1, int(n * split))
    if n_val >= n:
        raise ValueError(
            f"validation_split={split} leaves no training data")
    return n_val


class History:
    """keras-compatible fit() return value."""

    def __init__(self, records: List[Dict[str, Any]]):
        self.history: Dict[str, List[Any]] = {}
        for rec in records:
            for k, v in rec.items():
                self.history.setdefault(k, []).append(v)


_LOSSES = {
    "sparse_categorical_crossentropy": engine_lib.sparse_softmax_loss,
    "categorical_crossentropy": engine_lib.sparse_softmax_loss,
    "binary_crossentropy": engine_lib.sigmoid_binary_loss,
    "mse": engine_lib.mse_loss,
    "mean_squared_error": engine_lib.mse_loss,
}

_METRICS = {
    "accuracy": engine_lib.accuracy_metric,
    "acc": engine_lib.accuracy_metric,
    "precision": engine_lib.precision_metric,
    "recall": engine_lib.recall_metric,
}

# the flax collection of batch norm's statistics: model-state keys are
# "batch_stats.<module buffer name>"
_STATS = "batch_stats."
_LAYOUT = (lambda sd, leaf: weights_lib.params_to_flax(sd, leaf,
                                                       sequential=True),
           weights_lib.sequential_path)


class NeuralModel:
    """Config-driven model with a keras-shaped method surface, on
    ``device`` (the card unless ``"cpu"`` is asked for)."""

    def __init__(self, layer_configs: Sequence[Dict[str, Any]],
                 name: str = "neural_model", device="cuda"):
        self.name = name
        self.layer_configs: List[Dict[str, Any]] = [
            dict(c) for c in layer_configs]
        self.optimizer_spec: Dict[str, Any] = {"kind": "adam",
                                               "learning_rate": 1e-3}
        self.loss_name: str = "sparse_categorical_crossentropy"
        self.metric_names: List[str] = ["accuracy"]
        self.module: Optional[seq_lib.SequentialModule] = None
        self.input_shape: Optional[List[int]] = None  # without batch dim
        self.input_dtype: str = "float32"
        self.history: List[Dict[str, Any]] = []
        self.seed: int = 0
        self.device = resolve_device(device)
        self._engine: Optional[engine_lib.Engine] = None
        self._compute = torch.float32
        self._accum = engine_lib.default_grad_accum()

    # ------------------------------------------------------------------
    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The float32 master params by flax path (``dense_0.kernel``),
        or None before the model is built."""
        if self.module is None:
            return None
        return dict(self.module.named_parameters())

    @property
    def model_state(self) -> Dict[str, torch.Tensor]:
        """Batch norm's running statistics,
        ``batch_stats.<layer>.mean``/``.var`` (empty without batch
        norm)."""
        if self.module is None:
            return {}
        return {_STATS + k: v for k, v in self.module.named_buffers()}

    @property
    def output_activation(self) -> str:
        return seq_lib.output_activation_of(self.layer_configs)

    def _embedding_first(self) -> bool:
        return bool(self.layer_configs) and \
            self.layer_configs[0].get("kind") == "embedding"

    def add(self, layer_config: Dict[str, Any]) -> None:
        self.layer_configs.append(dict(layer_config))
        self.module = None  # built params are stale
        self._engine = None

    def compile(self, optimizer: Any = "adam", loss: Any = None,
                metrics: Optional[Sequence[Any]] = None, **_: Any) -> None:
        """keras-compatible compile; accepts strings, spec dicts, or
        objects carrying a ``spec`` attribute."""
        if isinstance(optimizer, str):
            self.optimizer_spec = {"kind": optimizer}
        elif isinstance(optimizer, dict):
            self.optimizer_spec = dict(optimizer)
        elif hasattr(optimizer, "spec"):
            self.optimizer_spec = dict(optimizer.spec)
        else:
            raise TypeError(f"unsupported optimizer: {optimizer!r}")
        if loss is not None:
            if hasattr(loss, "spec"):
                loss = loss.spec
            if loss not in _LOSSES:
                raise ValueError(f"unknown loss: {loss!r}")
            self.loss_name = loss
        if metrics is not None:
            names = []
            for m in metrics:
                m = getattr(m, "spec", m)
                if m not in _METRICS:
                    raise ValueError(f"unknown metric: {m!r}")
                names.append(m)
            self.metric_names = names
        self._engine = None

    # ------------------------------------------------------------------
    def _new_module(self) -> seq_lib.SequentialModule:
        with torch.device("meta"):
            return seq_lib.SequentialModule(self.layer_configs,
                                            self.input_shape)

    def _load(self, state: Dict[str, torch.Tensor]) -> None:
        module = self._new_module().to_empty(device=self.device)
        module.load_state_dict(state)
        self.module = module
        self.input_dtype = "int32" if self._embedding_first() \
            else "float32"
        self._engine = None

    def set_params(self, params: Dict[str, torch.Tensor],
                   model_state: Optional[Dict[str, torch.Tensor]] = None,
                   input_shape: Optional[Sequence[int]] = None) -> None:
        """Builds the module on the model's device with a copy of
        ``params`` (``weights.params_from_flax(tree, sequential=True)``)
        and ``model_state`` (``batch_stats.``-prefixed, or the module's
        buffer names); statistics not given start at mean 0, var 1."""
        if input_shape is not None:
            self.input_shape = [int(d) for d in input_shape]
        if self.input_shape is None:
            raise ValueError("model has no input shape yet; pass "
                             "input_shape= so it can be built")
        state = {k: torch.zeros(b.shape) if k.endswith("mean")
                 else torch.ones(b.shape)
                 for k, b in self._new_module().named_buffers()}
        state.update(params)
        for key, value in (model_state or {}).items():
            state[key[len(_STATS):] if key.startswith(_STATS) else key] = \
                value
        self._load(state)

    def _build_params(self, sample_x: np.ndarray) -> None:
        self.input_shape = list(sample_x.shape[1:])
        self._load(seq_lib.init_state(self._new_module(), self.seed))

    def _apply_fn(self, params, model_state, batch, train: bool,
                  rng: Optional[int]):
        """``(outputs, new_model_state)``: float inputs in the compute
        dtype; in training the batch statistics are the new state."""
        return self._forward(params, model_state, batch, train, rng, False)

    def _fused_apply_fn(self, params, model_state, batch, train: bool,
                        rng: Optional[int]):
        """:meth:`_apply_fn` of one config under the fused sweep's
        ``vmap``: recurrent layers run every config in one call."""
        return self._forward(params, model_state, batch, train, rng, True)

    def _forward(self, params, model_state, batch, train: bool,
                 rng: Optional[int], config_axis: bool):
        x = batch["x"]
        if x.is_floating_point():
            x = x.to(self._compute)
        generator = None
        if train and rng is not None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(rng)
        buffers = {k[len(_STATS):]: v for k, v in model_state.items()}
        updates: Optional[Dict[str, torch.Tensor]] = {} if train else None
        out = torch.func.functional_call(
            self.module, {**params, **buffers}, (x,),
            {"train": train, "generator": generator, "updates": updates,
             "config_axis": config_axis})
        if updates:
            new_state = dict(model_state)
            new_state.update({_STATS + k: v for k, v in updates.items()})
            return out, new_state
        return out, model_state

    def _get_engine(self) -> engine_lib.Engine:
        if self._engine is None:
            self._compute = torch.bfloat16 \
                if Config().compute_dtype == "bfloat16" else torch.float32
            self._engine = engine_lib.Engine(
                apply_fn=self._apply_fn,
                loss_fn=_LOSSES[self.loss_name],
                optimizer=build_optimizer(self.optimizer_spec),
                metrics={n: _METRICS[n] for n in self.metric_names},
                compute_dtype=self._compute, grad_accum=self._accum,
                param_layout=_LAYOUT, stateful=True)
        return self._engine

    def _set_grad_accum(self, grad_accum: Optional[int]) -> None:
        self._accum, changed = engine_lib.resolve_grad_accum(
            grad_accum, self._accum)
        if changed:
            self._engine = None

    # ------------------------------------------------------------------
    def _coerce_x(self, x) -> np.ndarray:
        if hasattr(x, "to_numpy"):  # a catalog Table from the $ DSL
            x = data_lib.dataframe_to_arrays(x)["x"]
        x = np.asarray(x)
        if not self._embedding_first():
            return x.astype(np.float32)
        cfg = self.layer_configs[0]
        vocab = int(cfg.get("vocab", cfg.get("input_dim")))
        ids = x.astype(np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= vocab):
            raise ValueError(f"token ids must be in [0, {vocab}), got "
                             f"[{ids.min()}, {ids.max()}]")
        return ids

    def _coerce_y(self, y) -> np.ndarray:
        if hasattr(y, "to_numpy"):
            y = y.to_numpy()
        y = np.asarray(y)
        if y.ndim > 1 and y.shape[-1] > 1 and \
                self.loss_name in ("categorical_crossentropy",):
            y = np.argmax(y, axis=-1)  # one-hot -> sparse
        return np.squeeze(y) if y.ndim > 1 and y.shape[-1] == 1 else y

    def _batcher(self, x, y=None, batch_size: Optional[int] = None,
                 shuffle: bool = False,
                 sample_weight=None) -> data_lib.ArrayBatcher:
        arrays = {"x": self._coerce_x(x)}
        if y is not None:
            arrays["y"] = self._coerce_y(y)
        return data_lib.ArrayBatcher(
            arrays, batch_size or Config().default_batch_size,
            shuffle=shuffle, seed=self.seed, sample_weight=sample_weight)

    # ------------------------------------------------------------------
    def fit(self, x=None, y=None, batch_size: Optional[int] = None,
            epochs: int = 1, verbose: int = 0,
            validation_data: Optional[Tuple] = None,
            validation_split: float = 0.0,
            shuffle: bool = True, checkpointer=None,
            log_fn=None, grad_accum: Optional[int] = None,
            sample_weight=None, class_weight=None, health_policy=None,
            **_: Any) -> History:
        self._set_grad_accum(grad_accum)
        if class_weight is not None and y is None:
            raise ValueError("class_weight requires labels y")
        val_weight = None
        if validation_split and validation_data is None:
            # keras: hold out the TAIL fraction, before any shuffle
            x = self._coerce_x(x)
            y = self._coerce_y(y) if y is not None else None
            n_val = validation_tail_count(len(x), validation_split)
            validation_data = (x[-n_val:],
                               y[-n_val:] if y is not None else None)
            x = x[:-n_val]
            if y is not None:
                y = y[:-n_val]
            if sample_weight is not None:
                # the tail slice of the weights weights the validation
                sample_weight = np.asarray(sample_weight,
                                           np.float32).reshape(-1)
                val_weight = sample_weight[-n_val:]
                sample_weight = sample_weight[:-n_val]
        if class_weight is not None:
            # keras: per-class training loss weights, after the split,
            # multiplied onto sample_weight
            y = self._coerce_y(y)
            cw = np.ones(len(y), np.float32)
            for cls, wt in dict(class_weight).items():
                cw[y == int(cls)] = float(wt)
            if sample_weight is not None:
                sw = np.asarray(sample_weight, np.float32).reshape(-1)
                if len(sw) != len(cw):
                    raise ValueError(
                        f"sample_weight has {len(sw)} entries for "
                        f"{len(cw)} samples")
                cw = cw * sw
            sample_weight = cw
        x = self._coerce_x(x)
        batcher = self._batcher(x, y, batch_size, shuffle=shuffle,
                                sample_weight=sample_weight)
        if self.module is None:
            self._build_params(x)
        eng = self._get_engine()
        state = eng.init_state(self.params, self.model_state)
        state, history = eng.fit(state, batcher, epochs=epochs,
                                 seed=self.seed, checkpointer=checkpointer,
                                 log_fn=log_fn, health_policy=health_policy)
        if validation_data is not None:
            vx, vy = validation_data[0], validation_data[1]
            val = eng.evaluate(state.params, self._batcher(
                vx, vy, batch_size, sample_weight=val_weight),
                state.model_state)
            if not history:
                history.append({})
            for k, v in val.items():
                history[-1][f"val_{k}"] = v
        self.history.extend(history)
        return History(history)

    # ------------------------------------------------------------------
    # sweep fusion (models/sweep.py's cohort planner calls these)
    # ------------------------------------------------------------------
    def supports_sweep_fusion(self) -> bool:
        """True when this instance trains through the stock NeuralModel
        path: a subclass overriding the forward, ``fit`` or the engine
        opts out, and its sweep points run as independent trials."""
        cls = type(self)
        return (cls._apply_fn is NeuralModel._apply_fn
                and cls.fit is NeuralModel.fit
                and cls._get_engine is NeuralModel._get_engine)

    def fit_sweep_fused(self, x, y, hyper_overrides, *,
                        batch_size: Optional[int] = None, epochs: int = 1,
                        validation_data: Optional[Tuple] = None,
                        shuffle: bool = True, score_fn=None,
                        earlystop: Optional[Dict[str, Any]] = None,
                        grad_accum: Optional[int] = None,
                        ) -> Tuple[List[Dict[str, float]],
                                   List[Optional[int]]]:
        """Trains ``len(hyper_overrides)`` optimizer variants of this
        model as one stacked program (:class:`~learningorchestra_tpu_torch.
        runtime.engine.FusedEngine`): every config starts from this
        model's init and sees the batches and dropout draws its own trial
        would, ``grad_accum`` as ``fit`` takes it. ``(per-config
        metrics, stopped epochs)``: the metrics of ``validation_data``
        when given, else of the last epoch."""
        self._set_grad_accum(grad_accum)
        overrides = [dict(o) for o in hyper_overrides]
        names = sorted({k for o in overrides for k in o})
        allowed = set(fusable_hyperparams(self.optimizer_spec))
        bad = [k for k in names if k not in allowed]
        if bad or not names:
            raise engine_lib.FusedSweepUnsupported(
                f"hyperparameters {bad or names} are not fusable for "
                f"optimizer kind "
                f"{self.optimizer_spec.get('kind', 'adam')!r}")
        # float64, so each config's scalars are its own spec's floats
        hyper = {k: np.asarray(
            [float(o.get(k, self.optimizer_spec.get(
                k, _FUSABLE_DEFAULTS[k]))) for o in overrides], np.float64)
            for k in names}
        x = self._coerce_x(x)
        batcher = self._batcher(x, y, batch_size, shuffle=shuffle)
        if self.module is None:
            self._build_params(x)
        self._get_engine()  # resolves the compute dtype
        feng = engine_lib.FusedEngine(
            apply_fn=self._fused_apply_fn,
            loss_fn=_LOSSES[self.loss_name],
            optimizer_factory=build_optimizer_factory(self.optimizer_spec),
            hyper=hyper,
            metrics={n: _METRICS[n] for n in self.metric_names},
            compute_dtype=self._compute, grad_accum=self._accum)
        eval_batcher = None
        if validation_data is not None:
            eval_batcher = self._batcher(
                validation_data[0], validation_data[1], batch_size)
        state = feng.init_fused_state(self.params, self.model_state)
        state, history, _active, stopped = feng.fit_fused(
            state, batcher, epochs=epochs, seed=self.seed,
            eval_batcher=eval_batcher, score_fn=score_fn,
            earlystop=earlystop)
        if eval_batcher is not None:
            final = feng.evaluate_fused(state, eval_batcher)
            per_config = [{k: float(v[i]) for k, v in final.items()}
                          for i in range(feng.n_configs)]
        else:
            last = history[-1] if history else {}
            per_config = [{k: float(v[i]) for k, v in last.items()
                           if isinstance(v, list)}
                          for i in range(feng.n_configs)]
        return per_config, stopped

    def evaluate(self, x=None, y=None, batch_size: Optional[int] = None,
                 sample_weight=None, **_: Any) -> Dict[str, float]:
        self._require_built()
        return self._get_engine().evaluate(
            self.params, self._batcher(x, y, batch_size,
                                       sample_weight=sample_weight),
            self.model_state)

    def predict(self, x=None, batch_size: Optional[int] = None,
                **_: Any) -> np.ndarray:
        self._require_built()
        logits = self._get_engine().predict(
            self.params, self._batcher(x, None, batch_size),
            self.model_state)
        act = self.output_activation
        if act == "softmax":
            e = np.exp(logits - logits.max(axis=-1, keepdims=True))
            return e / e.sum(axis=-1, keepdims=True)
        if act == "sigmoid":
            return 1.0 / (1.0 + np.exp(-logits))
        return logits

    def _require_built(self) -> None:
        if self.module is None:
            raise RuntimeError(
                "model has no parameters yet — call fit() first "
                "(or load a trained artifact)")

    # ------------------------------------------------------------------
    def _trees(self, leaf=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(params, model_state)`` as flax trees (of numpy arrays, or of
        ``leaf(tensor, transposed)``)."""
        params = weights_lib.params_to_flax(self.params, leaf,
                                            sequential=True)
        stats = {k[len(_STATS):]: v for k, v in self.model_state.items()}
        state = {"batch_stats": weights_lib.params_to_flax(
            stats, leaf, sequential=True)} if stats else {}
        return params, state

    def save_weights(self, path: str) -> None:
        """Weights (and batch statistics) to an ``.npz`` file, keyed as
        the JAX package writes them (``dense_0/kernel``,
        ``__state__/batch_stats/...``)."""
        self._require_built()
        flat = {k.replace(".", "/"): weights_lib._host(v, False)
                for k, v in self.params.items()}
        flat.update({"__state__/" + k.replace(".", "/"):
                     weights_lib._host(v, False)
                     for k, v in self.model_state.items()})
        np.savez(path, **flat)

    def _set_trees(self, params: Dict[str, Any],
                   state: Dict[str, Any]) -> None:
        """Inverse of :meth:`_trees` (flax trees of numpy arrays)."""
        self.set_params(
            weights_lib.params_from_flax(params, sequential=True),
            weights_lib.params_from_flax(state.get("batch_stats", {}),
                                         sequential=True))

    def _build_for(self, shape: Sequence[int]) -> None:
        """Params from the seed for inputs of ``shape`` (without the
        batch dim): int ids for an embedding-first stack."""
        dtype = np.int64 if self._embedding_first() else np.float32
        self._build_params(np.zeros((1, *shape), dtype))

    def load_weights(self, path: str,
                     input_shape: Optional[Sequence[int]] = None) -> None:
        """Weights from an ``.npz`` of :meth:`save_weights` (either
        package's) or a real keras ``.h5`` / ``.weights.h5`` Sequential
        weights file (layers matched kind by kind; needs h5py),
        shape-checked; builds the model first when needed
        (``input_shape`` without the batch dim)."""
        if self.module is None:
            shape = list(input_shape or self.input_shape or [])
            if not shape:
                raise ValueError(
                    "model has no parameters yet; pass input_shape= so "
                    "they can be built")
            self._build_for(shape)
        if not path.endswith(".npz"):
            from learningorchestra_tpu_torch.models import weights_io

            params, state = self._trees()
            self._set_trees(*weights_io.load_keras_h5_into_sequential(
                self.layer_configs, params, state, path))
            return
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        live = dict(self.params)
        live.update({"__state__." + k: v
                     for k, v in self.model_state.items()})
        for name, t in live.items():
            key = name.replace(".", "/")
            if key not in flat:
                raise ValueError(f"weights file is missing {key}")
            if tuple(flat[key].shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch at {key}: file has "
                                 f"{flat[key].shape}, model needs "
                                 f"{tuple(t.shape)}")
        with torch.no_grad():
            for name, t in live.items():
                t.copy_(torch.from_numpy(
                    np.array(flat[name.replace(".", "/")], np.float32)))

    @classmethod
    def from_keras(cls, path: str, name: Optional[str] = None,
                   input_shape: Optional[Sequence[int]] = None,
                   device="cuda") -> "NeuralModel":
        """A model from a keras-3 ``.keras`` archive: architecture
        (``config.json``) and weights (``model.weights.h5``) in one call,
        the reference's load-a-real-Keras-artifact flow
        (binary_executor_image/utils.py:195-221). Sequential topologies
        only; unmapped layer classes fail loudly. Needs h5py."""
        import tempfile

        from learningorchestra_tpu_torch.models import weights_io

        configs, archive_shape, h5_bytes = \
            weights_io.read_keras_archive(path)
        input_shape = list(input_shape or archive_shape or []) or None
        model = cls(configs, name=name or
                    os.path.splitext(os.path.basename(path))[0],
                    device=device)
        if input_shape:
            model.input_shape = list(input_shape)
        fd, tmp = tempfile.mkstemp(suffix=".weights.h5")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(h5_bytes)
            model.load_weights(tmp, input_shape=input_shape)
        finally:
            os.unlink(tmp)
        return model

    @classmethod
    def from_savedmodel(cls, path: str, name: Optional[str] = None,
                        input_shape: Optional[Sequence[int]] = None,
                        device="cuda") -> "NeuralModel":
        """A model from a TF SavedModel directory (stock
        ``tf.keras.models.save_model`` output, the reference's primary
        artifact format, binary_executor_image/utils.py:201-220) with
        numpy alone: architecture from ``keras_metadata.pb``, weights
        from the ``variables/`` bundle. Sequential topologies only."""
        from learningorchestra_tpu_torch.models import weights_io

        configs, sm_shape, layers = weights_io.read_savedmodel(path)
        return cls._from_parsed_keras(
            configs, layers, input_shape or sm_shape,
            name or os.path.basename(os.path.normpath(path)), device)

    @classmethod
    def from_legacy_h5(cls, path: str, name: Optional[str] = None,
                       input_shape: Optional[Sequence[int]] = None,
                       device="cuda") -> "NeuralModel":
        """A model from a legacy tf.keras whole-model ``.h5`` file
        (``model_config`` attr + ``model_weights`` group). Needs h5py."""
        from learningorchestra_tpu_torch.models import weights_io

        configs, h5_shape, layers = weights_io.read_legacy_h5_model(path)
        return cls._from_parsed_keras(
            configs, layers, input_shape or h5_shape,
            name or os.path.splitext(os.path.basename(path))[0], device)

    @classmethod
    def _from_parsed_keras(cls, configs, layers, input_shape, name,
                           device="cuda") -> "NeuralModel":
        from learningorchestra_tpu_torch.models import weights_io

        model = cls(configs, name=name, device=device)
        if not input_shape:
            raise ValueError(
                "the artifact records no input shape; pass "
                "input_shape= so parameters can be built")
        model._build_for(list(input_shape))
        params, state = model._trees()
        model._set_trees(*weights_io.load_keras_h5_into_sequential(
            model.layer_configs, params, state, h5_layers=layers))
        return model

    def to_keras(self, input_shape: Optional[Sequence[int]] = None):
        """A REAL keras model with this model's weights (inverse gate
        packing); needs the ``keras`` package. The returned model
        predicts identically and serializes with ``.save()``."""
        from learningorchestra_tpu_torch.models import weights_io

        self._require_built()
        shape = list(input_shape or self.input_shape or [])
        if not shape:
            raise ValueError("pass input_shape= (the model never saw "
                             "a sample to record it)")
        params, state = self._trees()
        return weights_io.build_keras_model(self.layer_configs, params,
                                            state, shape)

    def save_keras(self, path: str,
                   input_shape: Optional[Sequence[int]] = None) -> None:
        """A real ``.keras`` archive that stock keras loads: the reverse
        of :meth:`from_keras` (the reference ships real Keras artifacts
        between services, utils.py:195-221). Needs ``keras``."""
        self.to_keras(input_shape=input_shape).save(path)

    def summary(self) -> str:
        lines = [f"NeuralModel '{self.name}'"]
        for i, cfg in enumerate(self.layer_configs):
            lines.append(f"  [{i}] {json.dumps(cfg)}")
        if self.module is not None:
            lines.append(f"  params: {self.num_params():,}")
        return "\n".join(lines)

    def num_params(self) -> int:
        if self.module is None:
            return 0
        return sum(p.numel() for p in self.module.parameters())

    # ------------------------------------------------------------------
    # artifact-store native protocol (catalog/artifacts.py)
    # ------------------------------------------------------------------
    def __lo_save__(self, path: str) -> None:
        config = {
            "name": self.name,
            "layer_configs": self.layer_configs,
            "optimizer_spec": self.optimizer_spec,
            "loss_name": self.loss_name,
            "metric_names": self.metric_names,
            "input_shape": self.input_shape,
            "input_dtype": self.input_dtype,
            "seed": self.seed,
            "history": self.history,
            "built": self.module is not None,
        }
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)
        if self.module is not None:
            params, state = self._trees()
            ckpt_lib.save_pytree({"params": params, "model_state": state},
                                 os.path.join(path, "weights.msgpack"))

    @classmethod
    def __lo_load__(cls, path: str, device="cuda") -> "NeuralModel":
        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
        model = cls(config["layer_configs"], name=config["name"],
                    device=device)
        model.optimizer_spec = config["optimizer_spec"]
        model.loss_name = config["loss_name"]
        model.metric_names = config["metric_names"]
        model.input_shape = config["input_shape"]
        model.input_dtype = config["input_dtype"]
        model.seed = config["seed"]
        model.history = config["history"]
        if config["built"]:
            # the target's structure from the module on the meta device
            model.module = model._new_module()
            params, state = model._trees(leaf=lambda t, _: t)
            model.module = None
            tree = ckpt_lib.load_pytree(
                os.path.join(path, "weights.msgpack"),
                {"params": params, "model_state": state})
            model.set_params(
                weights_lib.params_from_flax(tree["params"], sequential=True),
                weights_lib.params_from_flax(
                    tree["model_state"].get("batch_stats", {}),
                    sequential=True))
        return model
