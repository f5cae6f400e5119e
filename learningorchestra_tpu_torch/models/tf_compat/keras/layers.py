"""Keras layer shims: lightweight descriptors consumed by Sequential
(each carries a JSON layer config for models/sequential_module.py).
They import neither torch nor numpy, so a ``#`` expression that builds
one runs in the sandbox's child without loading torch."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence


class Layer:
    def __init__(self, config: Dict[str, Any]):
        self.config = config


def _pair(v):
    if v is None:
        return None
    if isinstance(v, int):
        return [v, v]
    return list(v)


class Dense(Layer):
    def __init__(self, units: int, activation: Optional[str] = None,
                 input_shape: Optional[Sequence[int]] = None, **_: Any):
        super().__init__({"kind": "dense", "units": int(units),
                          "activation": activation})
        self.input_shape = list(input_shape) if input_shape else None


class Conv2D(Layer):
    def __init__(self, filters: int, kernel_size=3, strides=1,
                 padding: str = "valid", activation: Optional[str] = None,
                 input_shape: Optional[Sequence[int]] = None, **_: Any):
        super().__init__({
            "kind": "conv2d", "filters": int(filters),
            "kernel": _pair(kernel_size), "strides": _pair(strides),
            "padding": padding.upper(), "activation": activation})
        self.input_shape = list(input_shape) if input_shape else None


class Conv1D(Layer):
    def __init__(self, filters: int, kernel_size=3, strides=1,
                 padding: str = "valid", activation: Optional[str] = None,
                 input_shape: Optional[Sequence[int]] = None, **_: Any):
        super().__init__({
            "kind": "conv1d", "filters": int(filters),
            "kernel": int(kernel_size) if not isinstance(
                kernel_size, (list, tuple)) else int(kernel_size[0]),
            "strides": int(strides) if not isinstance(
                strides, (list, tuple)) else int(strides[0]),
            "padding": padding.upper(), "activation": activation})
        self.input_shape = list(input_shape) if input_shape else None


class MaxPooling1D(Layer):
    def __init__(self, pool_size=2, strides=None, **_: Any):
        super().__init__({"kind": "maxpool1d", "pool": int(pool_size),
                          "strides": int(strides or pool_size)})


class MaxPooling2D(Layer):
    def __init__(self, pool_size=2, strides=None, **_: Any):
        super().__init__({"kind": "maxpool2d", "pool": _pair(pool_size),
                          "strides": _pair(strides) or _pair(pool_size)})


class AveragePooling2D(Layer):
    def __init__(self, pool_size=2, strides=None, **_: Any):
        super().__init__({"kind": "avgpool2d", "pool": _pair(pool_size),
                          "strides": _pair(strides) or _pair(pool_size)})


class GlobalAveragePooling2D(Layer):
    def __init__(self, **_: Any):
        super().__init__({"kind": "globalavgpool2d"})


class GlobalAveragePooling1D(Layer):
    def __init__(self, **_: Any):
        super().__init__({"kind": "globalavgpool1d"})


class GlobalMaxPooling1D(Layer):
    def __init__(self, **_: Any):
        super().__init__({"kind": "globalmaxpool1d"})


class GlobalMaxPooling2D(Layer):
    def __init__(self, **_: Any):
        super().__init__({"kind": "globalmaxpool2d"})


class Conv2DTranspose(Layer):
    def __init__(self, filters: int, kernel_size=3, strides=1,
                 padding: str = "valid", activation: Optional[str] = None,
                 input_shape: Optional[Sequence[int]] = None, **_: Any):
        super().__init__({
            "kind": "conv2d_transpose", "filters": int(filters),
            "kernel": _pair(kernel_size), "strides": _pair(strides),
            "padding": padding.upper(), "activation": activation})
        self.input_shape = list(input_shape) if input_shape else None


class Flatten(Layer):
    def __init__(self, **_: Any):
        super().__init__({"kind": "flatten"})


class Reshape(Layer):
    def __init__(self, target_shape, **_: Any):
        super().__init__({"kind": "reshape", "shape": list(target_shape)})


class Dropout(Layer):
    def __init__(self, rate: float, **_: Any):
        super().__init__({"kind": "dropout", "rate": float(rate)})


class BatchNormalization(Layer):
    def __init__(self, momentum: float = 0.99, epsilon: float = 1e-3,
                 **_: Any):
        super().__init__({"kind": "batchnorm", "momentum": momentum,
                          "epsilon": epsilon})


class LayerNormalization(Layer):
    def __init__(self, epsilon: float = 1e-3, **_: Any):
        # keras's default epsilon is 1e-3 (flax's is 1e-6) — carry it
        # in the config so imported models normalize identically
        super().__init__({"kind": "layernorm",
                          "epsilon": float(epsilon)})


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int, **_: Any):
        super().__init__({"kind": "embedding", "vocab": int(input_dim),
                          "dim": int(output_dim)})


def _require_default_gates(kind: str, activation: str,
                           recurrent_activation: str) -> None:
    """The recurrent cells (flax's {OptimizedLSTM,GRU}Cell, and torch's
    RNN op that runs them here) hard-code tanh/sigmoid gates; fail
    loudly instead of silently computing different math."""
    if activation != "tanh" or recurrent_activation != "sigmoid":
        raise ValueError(
            f"{kind}: only activation='tanh' with recurrent_activation="
            f"'sigmoid' is supported (got {activation!r}/"
            f"{recurrent_activation!r})")


class LSTM(Layer):
    def __init__(self, units: int, return_sequences: bool = False,
                 activation: str = "tanh",
                 recurrent_activation: str = "sigmoid", **_: Any):
        _require_default_gates("LSTM", activation, recurrent_activation)
        super().__init__({"kind": "lstm", "units": int(units),
                          "return_sequences": bool(return_sequences)})


class GRU(Layer):
    def __init__(self, units: int, return_sequences: bool = False,
                 activation: str = "tanh",
                 recurrent_activation: str = "sigmoid", **_: Any):
        _require_default_gates("GRU", activation, recurrent_activation)
        super().__init__({"kind": "gru", "units": int(units),
                          "return_sequences": bool(return_sequences)})


class SimpleRNN(Layer):
    def __init__(self, units: int, return_sequences: bool = False,
                 activation: str = "tanh", **_: Any):
        super().__init__({"kind": "simple_rnn", "units": int(units),
                          "activation": activation,
                          "return_sequences": bool(return_sequences)})


class Bidirectional(Layer):
    """``Bidirectional(LSTM(n))`` — wraps an LSTM/GRU shim."""

    def __init__(self, layer: Layer, **_: Any):
        inner = dict(layer.config)
        if inner["kind"] not in ("lstm", "gru"):
            raise ValueError("Bidirectional supports LSTM/GRU only")
        super().__init__({"kind": f"bidirectional_{inner['kind']}",
                          "units": inner["units"],
                          "return_sequences": inner["return_sequences"]})


class Activation(Layer):
    def __init__(self, activation: str, **_: Any):
        super().__init__({"kind": "activation", "fn": activation})


class ReLU(Layer):
    def __init__(self, **_: Any):
        super().__init__({"kind": "activation", "fn": "relu"})


class InputLayer(Layer):
    def __init__(self, input_shape=None, shape=None, **_: Any):
        super().__init__({"kind": "input"})
        self.input_shape = list(input_shape or shape or [])


class Input(InputLayer):
    pass
