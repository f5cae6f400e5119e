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
``shuffle`` and a ``checkpointer``; ``evaluate``; ``predict`` (the
output softmax or sigmoid applied on the host); ``summary``,
``num_params``, ``save_weights``/``load_weights`` (``.npz``); and the
artifact protocol, ``config.json`` and ``weights.msgpack`` of
``{"params", "model_state"}`` in flax's bytes, so an artifact of either
package loads in the other. An ``embedding`` first layer takes int64
token ids, and ids outside ``[0, vocab)`` raise ``ValueError`` before
anything reaches the card (the JAX package takes them). Batch norm's
statistics are the engine's model state. Mesh placement, the keras
import and export (``from_keras``, ``to_keras``, the ``.h5`` weights)
and sweep fusion are not ported.
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
    in place saves a copy of every parameter per step)."""

    def __init__(self, spec: Dict[str, Any]):
        self.kind = spec.get("kind", "adam").lower()
        if self.kind not in _KINDS:
            raise ValueError(f"unknown optimizer: {self.kind!r}")
        self.spec = dict(spec)
        self.lr = float(spec.get("learning_rate", spec.get("lr", 1e-3)))
        if self.kind == "adam":
            self.b1 = float(spec.get("beta_1", 0.9))
            self.b2 = float(spec.get("beta_2", 0.999))
        else:
            self.b1, self.b2 = 0.9, 0.999
        self.weight_decay = float(spec.get("weight_decay", 1e-4))
        self.momentum = float(spec.get("momentum", 0.0))
        self.nesterov = bool(spec.get("nesterov", False))
        self.rho = float(spec.get("rho", 0.9))

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
        lr = self.lr
        if self.kind in ("adam", "adamw"):
            state["count"] += 1
            # optax raises the float32 decay to the int32 count
            count = np.float32(state["count"])
            bc1 = float(1 - np.float32(self.b1) ** count)
            bc2 = float(1 - np.float32(self.b2) ** count)
        for name, p in params.items():
            g = grads[name].float()
            if self.kind in ("adam", "adamw"):
                mu, nu = state["mu"][name], state["nu"][name]
                mu.copy_((1 - self.b1) * g + self.b1 * mu)
                nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)
                if self.kind == "adamw" and p.ndim >= 2:
                    u = u + self.weight_decay * p
                u = -lr * u
            elif self.kind == "sgd":
                trace = state["trace"][name]
                trace.copy_(g + self.momentum * trace)
                u = g + self.momentum * trace if self.nesterov else trace
                u = -lr * u
            elif self.kind == "rmsprop":
                nu, trace = state["nu"][name], state["trace"][name]
                nu.copy_((1 - self.rho) * (g * g) + self.rho * nu)
                u = -lr * (torch.rsqrt(nu + 1e-8) * g)
                trace.copy_(u + self.momentum * trace)
                u = trace
            else:
                ss = state["sum_of_squares"][name]
                ss.add_(g * g)
                u = torch.where(ss > 0, torch.rsqrt(ss + 1e-7), 0.0) * g
                u = -lr * u
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
            {"train": train, "generator": generator, "updates": updates})
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
            sample_weight=None, class_weight=None,
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
                                 log_fn=log_fn)
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

    def load_weights(self, path: str,
                     input_shape: Optional[Sequence[int]] = None) -> None:
        """Weights from an ``.npz`` of :meth:`save_weights` (either
        package's), shape-checked; builds the model first when needed
        (``input_shape`` without the batch dim). Keras ``.h5`` files
        are not ported."""
        if not path.endswith(".npz"):
            raise ValueError(
                f"loading {path!r}: keras .h5 weights are not yet ported "
                f"to the PyTorch package (use a .npz of save_weights)")
        if self.module is None:
            shape = list(input_shape or self.input_shape or [])
            if not shape:
                raise ValueError(
                    "model has no parameters yet; pass input_shape= so "
                    "they can be built")
            self._build_params(np.zeros((1, *shape), np.float32))
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
