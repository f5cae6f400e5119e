"""Model layer of the port: the decoder-only language model, the
sequence classifier over the bidirectional encoder, the keras-shaped
``NeuralModel``, the hyperparameter sweeps over them and the
``tensorflow.keras`` shim (:mod:`.tf_compat`).

The classes load on first use (a module ``__getattr__``), so importing a
light submodule (the shim's layer, optimizer and loss descriptors in the
sandbox's child) loads no torch."""

import importlib

_CLASSES = {
    "TextClassifier": "encoder",
    "TransformerEncoder": "encoder",
    "NeuralModel": "neural",
    "GridSearch": "sweep",
    "RandomSearch": "sweep",
    "LanguageModel": "transformer",
    "TransformerLM": "transformer",
}
__all__ = sorted(_CLASSES)


def __getattr__(name: str):
    module = _CLASSES.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(set(globals()) | set(_CLASSES))
