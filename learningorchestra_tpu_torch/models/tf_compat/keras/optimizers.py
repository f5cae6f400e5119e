"""``tensorflow.keras.optimizers`` shim -> the optimizer specs
:func:`~learningorchestra_tpu_torch.models.neural.build_optimizer`
builds (optax's update rules, written out in PyTorch)."""

from __future__ import annotations

from typing import Any


class _Optimizer:
    kind = "adam"

    def __init__(self, learning_rate: float = 0.001, **kwargs: Any):
        self.spec = {"kind": self.kind, "learning_rate": learning_rate}
        for key in ("beta_1", "beta_2", "momentum", "nesterov", "rho",
                    "weight_decay"):
            if key in kwargs:
                self.spec[key] = kwargs[key]


class Adam(_Optimizer):
    kind = "adam"


class AdamW(_Optimizer):
    kind = "adamw"


class SGD(_Optimizer):
    kind = "sgd"


class RMSprop(_Optimizer):
    kind = "rmsprop"


class Adagrad(_Optimizer):
    kind = "adagrad"
