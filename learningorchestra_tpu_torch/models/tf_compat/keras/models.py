"""``tensorflow.keras.models`` shim: Sequential / Model / load_model.

``Sequential`` IS the port's :class:`NeuralModel`, the object the Model
service instantiates and stores (reference model.py:158-162) and the
executors call ``fit``/``evaluate``/``predict`` on
(binary_execution.py:177-189), on ``device`` (the card unless the caller
asks for the CPU).
"""

from __future__ import annotations

import os
from typing import Any, Iterable, Optional

from learningorchestra_tpu_torch.models.neural import NeuralModel
from learningorchestra_tpu_torch.models.tf_compat.keras.layers import Layer


class Sequential(NeuralModel):
    def __init__(self, layers: Optional[Iterable[Any]] = None,
                 name: str = "sequential", device="cuda", **_: Any):
        configs = []
        for layer in layers or []:
            cfg = self._layer_config(layer)
            if cfg["kind"] == "input":
                continue  # shape hint only; NeuralModel builds lazily
            configs.append(cfg)
        super().__init__(configs, name=name, device=device)

    @staticmethod
    def _layer_config(layer: Any) -> dict:
        if isinstance(layer, Layer):
            return dict(layer.config)
        if isinstance(layer, dict) and "kind" in layer:
            return dict(layer)
        raise TypeError(f"unsupported layer: {layer!r}")

    def add(self, layer: Any) -> None:  # type: ignore[override]
        cfg = self._layer_config(layer)
        if cfg["kind"] != "input":
            super().add(cfg)


# Functional-API models are out of scope for the shim; the reference's
# pipelines drive Sequential/applications. Model aliases Sequential so
# `tensorflow.keras.models.Model` resolves to something usable.
Model = Sequential


def load_model(path: str, device="cuda") -> NeuralModel:
    """Load any real-keras artifact format the reference round-trips
    (binary_executor_image/utils.py:201-220) or the port's own saved
    artifact: ``.keras`` archives, TF SavedModel directories, legacy
    whole-model ``.h5`` files, all without importing tensorflow (the
    ``.keras`` and ``.h5`` readers need h5py)."""
    from learningorchestra_tpu_torch.models import weights_io

    p = str(path)
    if p.endswith(".keras"):
        return NeuralModel.from_keras(p, device=device)
    if os.path.isdir(p) and (
            os.path.exists(os.path.join(p, "saved_model.pb"))
            or os.path.exists(os.path.join(p, "keras_metadata.pb"))):
        return NeuralModel.from_savedmodel(p, device=device)
    if weights_io.is_legacy_h5_model(p):
        return NeuralModel.from_legacy_h5(p, device=device)
    return NeuralModel.__lo_load__(p, device=device)
