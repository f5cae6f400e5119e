"""``tensorflow.keras.losses`` shim -> engine loss names."""

from __future__ import annotations

from typing import Any


class _Loss:
    spec = "mse"

    def __init__(self, **_: Any):
        pass


class SparseCategoricalCrossentropy(_Loss):
    spec = "sparse_categorical_crossentropy"


class CategoricalCrossentropy(_Loss):
    spec = "categorical_crossentropy"


class BinaryCrossentropy(_Loss):
    spec = "binary_crossentropy"


class MeanSquaredError(_Loss):
    spec = "mean_squared_error"
