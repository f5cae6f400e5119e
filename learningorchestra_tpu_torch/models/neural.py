"""The training surface the port's language model shares with the JAX
package's ``NeuralModel``: the optimizer specs, the keras-shaped
``History`` and the validation tail split.

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
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

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
