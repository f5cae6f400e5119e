"""``tensorflow.keras.applications`` shim.

The reference's north-star tune config loads
``tensorflow.keras.applications.ResNet50`` by module path
(BASELINE.md config 5). Here ResNet50 is the port's ResNet-50
(models/resnet.py) under a ``NeuralModel``. ``weights=`` accepts a
**file path** to an npz weight export (``model.save_weights(path)`` of
either package) so pretrained transfer is real; ``weights="imagenet"``
falls back to random init with a warning, as in the JAX package: the
canonical weights are not in the repository.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Optional, Sequence

from learningorchestra_tpu_torch.models.neural import NeuralModel


def ResNet50(include_top: bool = True, weights: Optional[str] = None,
             classes: int = 1000,
             input_shape: Optional[Sequence[int]] = None,
             stage_sizes: Optional[Sequence[int]] = None,
             device="cuda", **_: Any) -> NeuralModel:
    """``stage_sizes`` (default (3, 4, 6, 3)) is an extension over
    keras: shrunken variants (e.g. ``[1, 1, 1, 1]``) keep the exact
    bottleneck architecture at a fraction of the param cost, for fast
    tests and small-input transfer runs."""
    cfg = {"kind": "resnet50", "classes": int(classes),
           "include_top": bool(include_top)}
    if stage_sizes is not None:
        cfg["stages"] = [int(s) for s in stage_sizes]
    model = NeuralModel([cfg], name="resnet50", device=device)
    if input_shape:
        model.input_shape = list(input_shape)
    if weights == "imagenet":
        warnings.warn(
            "pretrained ImageNet weights are unavailable offline; "
            "ResNet50 initialized randomly", stacklevel=2)
    elif weights:
        if not os.path.exists(weights):
            raise FileNotFoundError(
                f"weights file not found: {weights!r} (pass a path to "
                "an npz export from model.save_weights())")
        model.load_weights(weights,
                           input_shape=input_shape or (224, 224, 3))
    return model
