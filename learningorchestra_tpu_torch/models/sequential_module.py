"""The layer stack of the port's ``NeuralModel``, built from the same JSON
layer configs as :mod:`learningorchestra_tpu.models.sequential_module`.

Every kind of the JAX module runs here: ``dense``, ``conv2d``,
``conv1d``, ``conv2d_transpose``, the max, average and global pools,
``flatten``, ``reshape``, ``dropout``, ``batchnorm``, ``layernorm``,
``embedding`` (keras's ``input_dim``/``output_dim`` too), ``lstm``,
``gru``, ``simple_rnn``, ``bidirectional_lstm``, ``bidirectional_gru``,
``activation``, ``input`` and ``resnet50`` (:mod:`.resnet`). An unknown
kind raises with the JAX package's words.

Layout. Activations are channels-last at every layer boundary, as in
flax, so ``flatten`` before a ``dense`` flattens in NHWC order. A
convolution or pool views its input as NCHW with ``movedim`` (for a
contiguous NHWC tensor that is the ``channels_last`` memory format, no
copy) and its output back. Params keep flax's names and layouts, so a
flax tree maps onto the module by name alone
(:func:`~.weights.params_from_flax` with ``sequential=True``): a Dense
``kernel`` is ``(in, out)``, a conv ``kernel`` HWIO (``(k, in, out)`` in
1-D), a transposed conv's ``(kh, kw, out, in)`` (``transpose_kernel``,
TF semantics), each converted inside the forward. ``"SAME"`` padding
is flax's: total ``max((ceil(n/s)-1)·s + k - n, 0)``, the larger half at
the end, applied with ``F.pad`` when the halves differ (``-inf`` for a
max pool). A transposed conv's VALID output is ``(i-1)·s + k`` (what
the JAX layer crops to) and its SAME output ``i·s``, cut from the full
output ``max(k - s, 0) // 2`` in.

``batchnorm`` follows flax: normalized by the batch's mean and biased
variance in training (torch's ``native_batch_norm``, cuDNN on the card,
float32 statistics and affine), running statistics updated as ``m·ra +
(1 - m)·batch`` (momentum 0.99, epsilon 1e-3 by default; torch's own
running update would take the unbiased variance and the opposite
momentum, so it is not used) and written to the ``updates`` dict of the
forward (keyed by the buffer's name) rather than in place; the running
``mean``/``var`` are the module's buffers, the ``batch_stats``
collection. ``layernorm`` has epsilon 1e-6.

Recurrent layers. flax names a cell by its class and a counter in the
module's scope (``OptimizedLSTMCell_0``, ``GRUCell_0``, ``SimpleCell_0``,
the bidirectional kinds' forward cell before their backward one), not
by the layer; the port's cells keep those names and flax's gate
kernels (LSTM ``ii/if/ig/io`` without bias and ``hi/hf/hg/ho`` with;
GRU ``ir/iz/in`` with bias, ``hr/hz`` without, ``hn`` with; simple
``i`` with bias, ``h`` without). By rule, :func:`rnn_route`: ``lstm``,
``gru``, the bidirectional kinds and a ``simple_rnn`` with ``tanh`` or
``relu`` run as one call of torch's RNN op (``torch.lstm``, cuDNN on the
card) over weights packed from the gate kernels in each forward (torch
has flax's gate order, i f g o and r z n, and the same GRU ``n`` form;
the bias flax lacks is zero); a ``simple_rnn`` with any other activation
runs a loop over the time steps. The carries start at zero and
``return_sequences: false`` takes position -1, pads included; the
bidirectional kinds concatenate forward ``[:, -1]`` with backward
``[:, 0]``. ``LO_LSTM_HOIST=1`` gives an ``lstm`` the JAX package's
``HoistedLSTM`` tree (keras's packed ``kernel``, ``recurrent_kernel``,
``bias``, named by the layer); it runs through the same RNN op, whose
input projection is already one product over every time step.
``LO_RNN_UNROLL`` is a knob of XLA's scan and is not read here. Under a
fused sweep's ``vmap`` (``config_axis``) torch's RNN op, which ``vmap``
cannot batch, runs as the custom op ``lo_torch::folded_rnn``
(:data:`folded_rnn`): one call for every config, the config axis folded
block-diagonally into the hidden axis.
"""

from __future__ import annotations

import math
import os
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# keras semantics where flax's defaults differ: gelu is exact and
# leaky_relu's slope is 0.2
_ACTIVATIONS = {
    "relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
    "gelu": F.gelu, "elu": F.elu, "softplus": F.softplus,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
    "silu": F.silu, "swish": F.silu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "linear": lambda x: x, None: lambda x: x,
}

# output-layer activations the loss consumes as logits: skipped on the
# final dense/activation layer and applied by NeuralModel.predict
OUTPUT_ACTIVATIONS = ("softmax", "sigmoid")


def activation(name, is_output: bool = False):
    if is_output and name in OUTPUT_ACTIVATIONS:
        return lambda x: x
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation: {name!r}")
    return _ACTIVATIONS[name]


def _output_layer_index(layer_configs) -> int:
    """Index of the layer whose activation is the model's output
    activation (the last dense/activation layer)."""
    for i in range(len(layer_configs) - 1, -1, -1):
        if layer_configs[i].get("kind") in ("dense", "activation"):
            return i
    return -1


def output_activation_of(layer_configs: Sequence[Dict[str, Any]]) -> str:
    """The activation NeuralModel applies at predict time."""
    for cfg in reversed(layer_configs):
        act = cfg.get("activation") if cfg.get("kind") == "dense" else (
            cfg.get("fn") if cfg.get("kind") == "activation" else None)
        if act is not None:
            return act if act in OUTPUT_ACTIVATIONS else "linear"
        if cfg.get("kind") in ("dense", "activation"):
            return "linear"
    return "linear"


def _dropout(x: torch.Tensor, rate: float,
             generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scaled by
    1 / (1 - rate), from the step's own generator."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, 0.0)


def lstm_hoist() -> bool:
    return os.environ.get("LO_LSTM_HOIST", "").lower() in (
        "1", "true", "yes")


_RNN_CELLS = {"lstm": "OptimizedLSTMCell", "gru": "GRUCell",
              "simple_rnn": "SimpleCell"}
_BIDIRECTIONAL = {"bidirectional_lstm": "lstm", "bidirectional_gru": "gru"}
_RNN_OPS = {"lstm": torch.lstm, "gru": torch.gru, "tanh": torch.rnn_tanh,
            "relu": torch.rnn_relu}


def rnn_route(kind: str, act: Optional[str] = None) -> str:
    """``"fused"`` (torch's RNN op over the whole sequence) or
    ``"loop"`` (one step at a time) for a recurrent layer."""
    if kind == "simple_rnn" and (act or "tanh") not in ("tanh", "relu"):
        return "loop"
    return "fused"


# ----------------------------------------------------------------------
# padding and shapes
# ----------------------------------------------------------------------
def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"``: the total pad and its split, larger half at
    the end."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pads(padding, sizes, kernel, strides) -> List[Tuple[int, int]]:
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "SAME":
            return [same_pads(n, k, s)
                    for n, k, s in zip(sizes, kernel, strides)]
        if mode == "VALID":
            return [(0, 0)] * len(sizes)
        raise ValueError(f"unsupported padding: {padding!r}")
    if isinstance(padding, int):
        return [(padding, padding)] * len(sizes)
    return [(int(lo), int(hi)) for lo, hi in padding]


def _flat_pads(pads) -> List[int]:
    """``F.pad``'s order: the last spatial dim first."""
    out: List[int] = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _tuple(value, nd: int) -> Tuple[int, ...]:
    if isinstance(value, (list, tuple)):
        return tuple(int(v) for v in value)
    return (int(value),) * nd


def _ncw(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _nwc(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


# ----------------------------------------------------------------------
# layers with parameters (flax names and layouts)
# ----------------------------------------------------------------------
class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out), ``bias`` (out)."""

    def __init__(self, fan_in: int, units: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fan_in, units))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(units))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.linear(x, self.kernel.t(), self.bias)


class Conv(nn.Module):
    """flax ``nn.Conv`` over channels-last input, 1-D or 2-D."""

    def __init__(self, in_ch: int, filters: int, kernel, strides, padding,
                 sizes, use_bias: bool = True):
        super().__init__()
        self.nd = len(kernel)
        self.strides = tuple(strides)
        self.kernel = nn.Parameter(torch.empty(*kernel, in_ch, filters))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(filters))
        else:
            self.register_parameter("bias", None)
        pads = _pads(padding, sizes, kernel, strides)
        self.out_sizes = tuple((n + lo + hi - k) // s + 1 for n, k, s, (
            lo, hi) in zip(sizes, kernel, strides, pads))
        if any(o < 1 for o in self.out_sizes):
            raise ValueError(f"conv kernel {tuple(kernel)} does not fit "
                             f"input {tuple(sizes)}")
        self._symmetric = all(lo == hi for lo, hi in pads)
        self._pads = pads

    def forward(self, x):
        xc = _ncw(x)
        if self._symmetric:
            padding = tuple(lo for lo, _ in self._pads)
        else:
            xc = F.pad(xc, _flat_pads(self._pads))
            padding = 0
        w = self.kernel.permute(self.nd + 1, self.nd, *range(self.nd))
        conv = F.conv1d if self.nd == 1 else F.conv2d
        return _nwc(conv(xc, w, self.bias, self.strides, padding))


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(transpose_kernel=True)`` (TF's
    conv2d_transpose): ``kernel`` (kh, kw, out, in)."""

    def __init__(self, in_ch: int, filters: int, kernel, strides, padding,
                 sizes):
        super().__init__()
        self.strides = tuple(strides)
        self.kernel = nn.Parameter(torch.empty(*kernel, filters, in_ch))
        self.bias = nn.Parameter(torch.empty(filters))
        mode = str(padding).upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"unsupported padding: {padding!r}")
        full = [(n - 1) * s + k for n, k, s in zip(sizes, kernel, strides)]
        if mode == "VALID":
            self.out_sizes, self._start = tuple(full), (0,) * len(full)
        else:
            self.out_sizes = tuple(n * s for n, s in zip(sizes, strides))
            self._start = tuple(max(k - s, 0) // 2
                                for k, s in zip(kernel, strides))
        self._full = tuple(full)

    def forward(self, x):
        w = self.kernel.permute(3, 2, 0, 1)  # (in, out, kh, kw)
        y = F.conv_transpose2d(_ncw(x), w, None, self.strides)
        short = [max(st + o - f, 0) for st, o, f in
                 zip(self._start, self.out_sizes, self._full)]
        if any(short):
            y = F.pad(y, _flat_pads([(0, s) for s in short]))
        (h0, w0), (h, w_) = self._start, self.out_sizes
        y = y[:, :, h0:h0 + h, w0:w0 + w_]
        return _nwc(y) + self.bias


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis. ``path`` is the
    buffers' prefix in the owning module, set by :class:`SequentialModule`
    (``updates`` keys)."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-3):
        super().__init__()
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.path = ""

    def forward(self, x, train: bool = False,
                updates: Optional[Dict[str, torch.Tensor]] = None):
        # torch's batch norm over the channels of an NCHW view (for NHWC
        # data the channels_last format), float32 statistics and affine
        xc = _ncw(x) if x.ndim > 2 else x
        scale, bias = self.scale.float(), self.bias.float()
        # (the output in the input's dtype: batch norm under a fused
        # sweep's vmap computes in float32 and returns float32, and with
        # running statistics takes float32 input only)
        if not train:
            xs = xc.float() if getattr(_CONFIG_AXIS, "on", False) else xc
            y = torch.native_batch_norm(xs, scale, bias, self.mean.float(),
                                        self.var.float(), False, 0.0,
                                        self.epsilon)[0].to(x.dtype)
            return _nwc(y) if x.ndim > 2 else y
        y, mean, invstd = torch.native_batch_norm(xc, scale, bias, None,
                                                  None, True, 0.0,
                                                  self.epsilon)
        y = y.to(x.dtype)
        if updates is not None:
            # the biased batch variance, from 1 / sqrt(var + eps)
            var = (invstd.detach().pow(-2) - self.epsilon).clamp_min(0.0)
            m = self.momentum
            updates[f"{self.path}mean"] = m * self.mean + (1 - m) * \
                mean.detach()
            updates[f"{self.path}var"] = m * self.var + (1 - m) * var
        return _nwc(y) if x.ndim > 2 else y


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis (epsilon 1e-6)."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = float(epsilon)
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


class Embedding(nn.Module):
    """flax ``nn.Embed``: ``embedding`` (vocab, dim)."""

    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, dim))

    def forward(self, x):
        return F.embedding(x.long(), self.embedding)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``'s params."""

    def __init__(self, fan_in: int, units: int):
        super().__init__()
        for gate in "ifgo":
            self.add_module(f"i{gate}", Dense(fan_in, units, use_bias=False))
        for gate in "ifgo":
            self.add_module(f"h{gate}", Dense(units, units))

    def packed(self) -> List[torch.Tensor]:
        """``[w_ih, w_hh, b_ih, b_hh]`` in torch's layout."""
        cells = [getattr(self, f"i{g}") for g in "ifgo"]
        rec = [getattr(self, f"h{g}") for g in "ifgo"]
        b_hh = torch.cat([c.bias for c in rec])
        return [torch.cat([c.kernel for c in cells], 1).t(),
                torch.cat([c.kernel for c in rec], 1).t(),
                torch.zeros_like(b_hh), b_hh]


class GRUCell(nn.Module):
    """flax ``GRUCell``'s params."""

    def __init__(self, fan_in: int, units: int):
        super().__init__()
        for gate in "rzn":
            self.add_module(f"i{gate}", Dense(fan_in, units))
        self.add_module("hr", Dense(units, units, use_bias=False))
        self.add_module("hz", Dense(units, units, use_bias=False))
        self.add_module("hn", Dense(units, units))

    def packed(self) -> List[torch.Tensor]:
        cells = [getattr(self, f"i{g}") for g in "rzn"]
        rec = [getattr(self, f"h{g}") for g in "rzn"]
        hn = rec[2].bias
        zero = torch.zeros_like(hn)
        return [torch.cat([c.kernel for c in cells], 1).t(),
                torch.cat([c.kernel for c in rec], 1).t(),
                torch.cat([c.bias for c in cells]),
                torch.cat([zero, zero, hn])]


class SimpleCell(nn.Module):
    """flax ``SimpleCell``'s params."""

    def __init__(self, fan_in: int, units: int):
        super().__init__()
        self.add_module("i", Dense(fan_in, units))
        self.add_module("h", Dense(units, units, use_bias=False))

    def packed(self) -> List[torch.Tensor]:
        return [self.i.kernel.t(), self.h.kernel.t(), self.i.bias,
                torch.zeros_like(self.i.bias)]


class HoistedLSTM(nn.Module):
    """The JAX package's ``HoistedLSTM`` params: keras's packed
    ``kernel`` (in, 4H), ``recurrent_kernel`` (H, 4H) and ``bias``, gate
    columns i, f, g, o."""

    def __init__(self, fan_in: int, units: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fan_in, 4 * units))
        self.recurrent_kernel = nn.Parameter(torch.empty(units, 4 * units))
        self.bias = nn.Parameter(torch.empty(4 * units))

    def packed(self) -> List[torch.Tensor]:
        return [self.kernel.t(), self.recurrent_kernel.t(), self.bias,
                torch.zeros_like(self.bias)]


_CELL_CLASSES = {"OptimizedLSTMCell": LSTMCell, "GRUCell": GRUCell,
                 "SimpleCell": SimpleCell}


def _run_rnn(op_name: str, x: torch.Tensor, weights: List[torch.Tensor],
             units: int, bidirectional: bool = False) -> torch.Tensor:
    """Outputs ``(b, t, units · directions)`` of torch's RNN op from zero
    carries."""
    h0 = x.new_zeros(2 if bidirectional else 1, x.shape[0], units)
    hx = (h0, h0) if op_name == "lstm" else h0
    w = [t.to(x.dtype).contiguous() for t in weights]
    with warnings.catch_warnings():
        # weights packed in the forward are never cuDNN's one flat
        # buffer: it compacts them at each call (a copy of the layer's
        # weights), which is what its warning says
        warnings.filterwarnings("ignore", "RNN module weights")
        return _RNN_OPS[op_name](x, hx, w, True, 1, 0.0,
                                 torch.is_grad_enabled(), bidirectional,
                                 True)[0]


def _fold_configs(op_name: str, x: torch.Tensor, weights: List[torch.Tensor],
                  units: int, bidirectional: bool) -> torch.Tensor:
    """Every config of a fused sweep in ONE call of torch's RNN op: ``x``
    ``(n, b, t, in)`` and each weight with a leading config axis ``n``.
    The config axis folds into the feature axes: inputs side by side
    ``(b, t, n·in)``, each gate's weights block-diagonal over the configs
    (a product with the identity, so every block is exact and the rest
    0) and the biases side by side, so hidden unit ``c·units + j`` of the
    folded layer is unit ``j`` of config ``c``. Outputs ``(n, b, t,
    units · directions)``."""
    n, b, t, fan_in = x.shape
    gates = weights[0].shape[1] // units
    eye = torch.eye(n, dtype=weights[0].dtype, device=x.device)

    def block(w: torch.Tensor) -> torch.Tensor:
        cols = w.shape[-1]
        w = w.reshape(n, gates, units, cols).permute(1, 0, 2, 3)
        folded = w[:, :, :, None, :] * eye[None, :, None, :, None]
        return folded.reshape(gates * n * units, n * cols)

    def side(bias: torch.Tensor) -> torch.Tensor:
        return bias.reshape(n, gates, units).permute(1, 0, 2).reshape(-1)

    dirs = 2 if bidirectional else 1
    folded = []
    for d in range(dirs):
        w_ih, w_hh, b_ih, b_hh = weights[4 * d:4 * d + 4]
        folded += [block(w_ih), block(w_hh), side(b_ih), side(b_hh)]
    xf = x.permute(1, 2, 0, 3).reshape(b, t, n * fan_in)
    y = _run_rnn(op_name, xf, folded, n * units, bidirectional)
    return y.reshape(b, t, dirs, n, units).permute(3, 0, 1, 2, 4).reshape(
        n, b, t, dirs * units)


# set on the thread while a forward runs under a fused sweep's vmap
_CONFIG_AXIS = threading.local()


def _folded_rnn_plain(x, weights, op_name, units, bidirectional):
    return _run_rnn(op_name, x, list(weights), units, bidirectional)


def _folded_rnn_rule(info, in_dims, x, weights, op_name, units,
                     bidirectional):
    n = info.batch_size

    def lead(t, dim):
        return t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)

    x = lead(x, in_dims[0])
    weights = [lead(w, d) for w, d in zip(weights, in_dims[1])]
    return _fold_configs(op_name, x, weights, units, bidirectional), 0


# torch's RNN op of one config, whose vmap rule runs every config of the
# vmapped axis in one call (_fold_configs). Only the fused sweep calls it,
# under vmap; gradients flow through the ops the rule runs.
folded_rnn = torch.library.custom_op(
    "lo_torch::folded_rnn", _folded_rnn_plain, mutates_args=(),
    schema="(Tensor x, Tensor[] weights, str op_name, int units, "
           "bool bidirectional) -> Tensor")
folded_rnn.register_vmap(_folded_rnn_rule)


def _rnn(op_name: str, x: torch.Tensor, weights: List[torch.Tensor],
         units: int, bidirectional: bool, config_axis: bool) -> torch.Tensor:
    if config_axis:
        return folded_rnn(x, weights, op_name, units, bidirectional)
    return _run_rnn(op_name, x, weights, units, bidirectional)


def _run_loop(cell: SimpleCell, x: torch.Tensor, act) -> torch.Tensor:
    xw = cell.i(x)
    h = x.new_zeros(x.shape[0], xw.shape[-1])
    outs = []
    for t in range(x.shape[1]):
        h = act(xw[:, t] + cell.h(h))
        outs.append(h)
    return torch.stack(outs, dim=1)


# ----------------------------------------------------------------------
# the stack
# ----------------------------------------------------------------------
class SequentialModule(nn.Module):
    """The layer configs in order over inputs of shape ``input_shape``
    (without the batch dim). Submodules are named as flax names them."""

    def __init__(self, layer_configs: Sequence[Dict[str, Any]],
                 input_shape: Sequence[int]):
        super().__init__()
        self.layer_configs = [dict(c) for c in layer_configs]
        self._plan: List[Tuple[str, Dict[str, Any], Optional[str], Any]] = []
        counters: Dict[str, int] = {}
        out_idx = _output_layer_index(self.layer_configs)
        shape = tuple(int(d) for d in input_shape)
        for i, cfg in enumerate(self.layer_configs):
            kind = cfg.get("kind")
            name = f"{kind}_{i}"
            shape, owner, info = self._build(kind, cfg, name, i == out_idx,
                                             shape, counters)
            self._plan.append((kind, cfg, owner, info))
        self.output_shape = shape
        for path, module in self.named_modules():
            if isinstance(module, BatchNorm):
                module.path = f"{path}." if path else ""

    def _cell(self, counters, cls: str, fan_in: int, units: int) -> str:
        n = counters.get(cls, 0)
        counters[cls] = n + 1
        name = f"{cls}_{n}"
        self.add_module(name, _CELL_CLASSES[cls](fan_in, units))
        return name

    def _build(self, kind, cfg, name, is_output, shape, counters):
        """(output shape, name of the module holding the params or None,
        static info) of one layer."""
        if kind == "dense":
            self.add_module(name, Dense(shape[-1], int(cfg["units"])))
            return (shape[:-1] + (int(cfg["units"]),), name,
                    activation(cfg.get("activation"), is_output=is_output))
        if kind in ("conv2d", "conv1d"):
            nd = 2 if kind == "conv2d" else 1
            default = (3, 3) if nd == 2 else 3
            kernel = _tuple(cfg.get("kernel", default), nd)[:nd]
            strides = _tuple(cfg.get("strides", 1), nd)
            conv = Conv(shape[-1], int(cfg["filters"]), kernel, strides,
                        cfg.get("padding", "SAME"), shape[:-1])
            self.add_module(name, conv)
            return (conv.out_sizes + (int(cfg["filters"]),), name,
                    activation(cfg.get("activation")))
        if kind == "conv2d_transpose":
            conv = ConvTranspose(
                shape[-1], int(cfg["filters"]),
                _tuple(cfg.get("kernel", (3, 3)), 2),
                _tuple(cfg.get("strides", (1, 1)), 2),
                cfg.get("padding", "SAME"), shape[:-1])
            self.add_module(name, conv)
            return (conv.out_sizes + (int(cfg["filters"]),), name,
                    activation(cfg.get("activation")))
        if kind in ("maxpool1d", "maxpool2d", "avgpool2d"):
            nd = 1 if kind == "maxpool1d" else 2
            pool = _tuple(cfg.get("pool", 2 if nd == 1 else (2, 2)), nd)
            strides = _tuple(cfg.get("strides", pool), nd)
            sizes = tuple((n - k) // s + 1 for n, k, s in
                          zip(shape[:-1], pool, strides))
            return sizes + shape[-1:], None, (pool, strides)
        if kind in ("globalavgpool2d", "globalmaxpool2d", "globalavgpool1d",
                    "globalmaxpool1d"):
            return shape[-1:], None, None
        if kind == "flatten":
            return (int(np.prod(shape)),), None, None
        if kind == "reshape":
            target = tuple(int(d) for d in cfg["shape"])
            if int(np.prod(target)) != int(np.prod(shape)):
                raise ValueError(f"cannot reshape {shape} to {target}")
            return target, None, None
        if kind == "dropout":
            return shape, None, float(cfg.get("rate", 0.5))
        if kind == "batchnorm":
            self.add_module(name, BatchNorm(shape[-1],
                                            cfg.get("momentum", 0.99),
                                            cfg.get("epsilon", 1e-3)))
            return shape, name, None
        if kind == "layernorm":
            self.add_module(name, LayerNorm(shape[-1],
                                            cfg.get("epsilon", 1e-6)))
            return shape, name, None
        if kind == "embedding":
            vocab = cfg.get("vocab", cfg.get("input_dim"))
            dim = cfg.get("dim", cfg.get("output_dim"))
            if vocab is None or dim is None:
                raise ValueError(
                    "embedding layer needs vocab/dim (or keras "
                    f"input_dim/output_dim); got {dict(cfg)}")
            self.add_module(name, Embedding(int(vocab), int(dim)))
            return shape + (int(dim),), name, int(vocab)
        if kind in _RNN_CELLS:
            units = int(cfg["units"])
            seq = bool(cfg.get("return_sequences", False))
            out = shape[:-1] + (units,) if seq else (units,)
            if kind == "lstm" and lstm_hoist():
                self.add_module(name, HoistedLSTM(shape[-1], units))
                return out, name, ("lstm", None)
            owner = self._cell(counters, _RNN_CELLS[kind], shape[-1], units)
            if kind == "simple_rnn":
                act = cfg.get("activation", "tanh")
                fn = activation(act)
                if rnn_route(kind, act) == "loop":
                    return out, owner, ("loop", fn)
                return out, owner, (act, None)
            return out, owner, (kind, None)
        if kind in _BIDIRECTIONAL:
            base = _BIDIRECTIONAL[kind]
            units = int(cfg["units"])
            fwd = self._cell(counters, _RNN_CELLS[base], shape[-1], units)
            bwd = self._cell(counters, _RNN_CELLS[base], shape[-1], units)
            seq = bool(cfg.get("return_sequences", False))
            out = shape[:-1] + (2 * units,) if seq else (2 * units,)
            return out, None, (base, fwd, bwd)
        if kind == "activation":
            return shape, None, activation(cfg.get("fn"), is_output=is_output)
        if kind == "input":
            return shape, None, None
        if kind == "resnet50":
            from learningorchestra_tpu_torch.models.resnet import ResNet50

            net = ResNet50(num_classes=int(cfg.get("classes", 1000)),
                           include_top=bool(cfg.get("include_top", True)),
                           stage_sizes=tuple(cfg.get("stages")
                                             or (3, 4, 6, 3)),
                           in_channels=shape[-1], sizes=tuple(shape[:2]))
            self.add_module(name, net)
            return (net.out_features,), name, None
        raise ValueError(f"unknown layer kind: {kind!r}")

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None,
                updates: Optional[Dict[str, torch.Tensor]] = None,
                config_axis: bool = False):
        """``config_axis``: the forward runs under a fused sweep's
        ``vmap``, whose recurrent layers go through :data:`folded_rnn`."""
        if config_axis:
            _CONFIG_AXIS.on = True
            try:
                return self._layers(x, train, generator, updates, True)
            finally:
                _CONFIG_AXIS.on = False
        return self._layers(x, train, generator, updates, False)

    def _layers(self, x, train, generator, updates, config_axis):
        for kind, cfg, owner, info in self._plan:
            mod = getattr(self, owner) if owner is not None else None
            if kind in ("dense", "conv2d", "conv1d", "conv2d_transpose"):
                x = info(mod(x))
            elif kind in ("maxpool1d", "maxpool2d", "avgpool2d"):
                pool, strides = info
                xc = _ncw(x)
                if kind == "maxpool1d":
                    xc = F.max_pool1d(xc, pool, strides)
                elif kind == "maxpool2d":
                    xc = F.max_pool2d(xc, pool, strides)
                else:
                    xc = F.avg_pool2d(xc, pool, strides)
                x = _nwc(xc)
            elif kind == "globalavgpool2d":
                x = x.mean(dim=(1, 2))
            elif kind == "globalavgpool1d":
                x = x.mean(dim=1)
            elif kind == "globalmaxpool2d":
                x = x.amax(dim=(1, 2))
            elif kind == "globalmaxpool1d":
                x = x.amax(dim=1)
            elif kind == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif kind == "reshape":
                x = x.reshape((x.shape[0],) + tuple(cfg["shape"]))
            elif kind == "dropout":
                if train and info > 0 and generator is not None:
                    x = _dropout(x, info, generator)
            elif kind == "batchnorm":
                x = mod(x, train=train, updates=updates)
            elif kind in ("layernorm", "embedding"):
                x = mod(x)
            elif kind in _RNN_CELLS:
                op, fn = info
                units = int(cfg["units"])
                if op == "loop":
                    x = _run_loop(mod, x, fn)
                else:
                    x = _rnn(op, x, mod.packed(), units, False, config_axis)
                if not cfg.get("return_sequences", False):
                    x = x[:, -1, :]
            elif kind in _BIDIRECTIONAL:
                base, fwd, bwd = info
                units = int(cfg["units"])
                both = getattr(self, fwd).packed() + \
                    getattr(self, bwd).packed()
                x = _rnn(base, x, both, units, True, config_axis)
                if not cfg.get("return_sequences", False):
                    x = torch.cat([x[:, -1, :units], x[:, 0, units:]],
                                  dim=-1)
            elif kind == "activation":
                x = info(x)
            elif kind == "resnet50":
                x = mod(x, train=train, updates=updates)
        return x


# ----------------------------------------------------------------------
# initialization (flax's initializers, drawn with numpy)
# ----------------------------------------------------------------------
_TRUNCATED_STD = 0.87962566103423978
_RECURRENT = ("hi", "hf", "hg", "ho", "hr", "hz", "hn", "h")


def _truncated_normal(rng, shape) -> np.ndarray:
    x = rng.standard_normal(shape, dtype=np.float32)
    out = np.abs(x) > 2.0
    while out.any():
        x[out] = rng.standard_normal(int(out.sum()), dtype=np.float32)
        out = np.abs(x) > 2.0
    return x


def _orthogonal(rng, shape) -> np.ndarray:
    rows, cols = int(np.prod(shape[:-1])), int(shape[-1])
    a = rng.standard_normal((max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if rows < cols:
        q = q.T
    return q.reshape(shape).astype(np.float32)


def _init_leaf(path: Tuple[str, ...], shape, rng) -> np.ndarray:
    leaf = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if leaf in ("bias", "mean"):
        return np.zeros(shape, np.float32)
    if leaf in ("scale", "var"):
        return np.ones(shape, np.float32)
    if leaf == "embedding":
        return (rng.standard_normal(shape, dtype=np.float32)
                / np.float32(math.sqrt(shape[-1])))
    if leaf == "recurrent_kernel" or (leaf == "kernel"
                                      and parent in _RECURRENT):
        return _orthogonal(rng, shape)
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return _truncated_normal(rng, shape) * np.float32(
            1.0 / math.sqrt(fan_in) / _TRUNCATED_STD)
    raise ValueError(f"no initializer for {'.'.join(path)}")


def init_state(module: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """A fresh ``state_dict`` (params and batch statistics) for
    ``module``, drawn with numpy from ``seed`` with flax's defaults:
    kernels ``lecun_normal``, recurrent kernels ``orthogonal``,
    embeddings ``normal(1/sqrt(dim))``, biases and means 0, scales and
    variances 1."""
    rng = np.random.default_rng(seed)
    return {name: torch.from_numpy(_init_leaf(
        tuple(name.split(".")), tuple(t.shape), rng))
        for name, t in module.state_dict().items()}
