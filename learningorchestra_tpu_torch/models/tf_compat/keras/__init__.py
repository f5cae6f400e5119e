"""``tensorflow.keras`` shim: layers, optimizers and losses as plain
descriptors; models and applications on the port's ``NeuralModel``,
imported on first use so that this package loads no torch."""

import importlib

from learningorchestra_tpu_torch.models.tf_compat.keras import (  # noqa: F401
    layers, losses, optimizers)

_LAZY_MODULES = ("models", "applications")
_LAZY_CLASSES = ("Model", "Sequential")


def __getattr__(name: str):
    if name in _LAZY_MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _LAZY_CLASSES:
        return getattr(importlib.import_module(f"{__name__}.models"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
