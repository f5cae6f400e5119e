"""The bidirectional transformer encoder and the sequence classifier of
the port: the JAX package's ``TransformerEncoder`` and ``TextClassifier``
(``learningorchestra_tpu/models/transformer.py``).

The encoder embeds the tokens, runs ``n_layers`` non-causal blocks (the
LM's blocks with RoPE, no window), the final RMSNorm, a mean pool over
the tokens that are not padding (id 0), then ``cls_head``, a dense layer
with a bias, in float32. Pads are attended, as in the JAX package, and
only left out of the pool: no per-row mask reaches the attention, so
``attention="flash"`` runs the flash kernels, non-causal.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from learningorchestra_tpu_torch.config import Config, resolve_device
from learningorchestra_tpu_torch.models import weights as weights_lib
from learningorchestra_tpu_torch.models.neural import History, build_optimizer
from learningorchestra_tpu_torch.models.transformer import (
    ATTENTION_IMPLS, FLAX_LAYOUT, Block, RMSNorm, load_module, load_native,
    save_native)
from learningorchestra_tpu_torch.ops import attention as attn_ops
from learningorchestra_tpu_torch.runtime import data as data_lib
from learningorchestra_tpu_torch.runtime import engine as engine_lib


class TransformerEncoder(nn.Module):
    """tokens (b, s) -> class logits (b, n_classes), float32."""

    def __init__(self, vocab_size: int, n_classes: int, d_model: int = 256,
                 n_layers: int = 4, n_heads: int = 4, n_kv_heads: int = 0,
                 d_ff: int = 0, attention: str = "dot",
                 dropout: float = 0.0):
        super().__init__()
        if attention not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention impl: {attention!r}")
        d_ff = d_ff or 4 * d_model
        self.n_layers = n_layers
        self.embed = nn.Embedding(vocab_size, d_model)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", Block(
                d_model, n_heads, d_model // n_heads, d_ff, attention,
                causal=False, n_kv_heads=n_kv_heads, dropout=dropout))
        self.final_norm = RMSNorm(d_model)
        self.cls_head = nn.Linear(d_model, n_classes, bias=True)

    def forward(self, tokens, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.embed(tokens)
        for i in range(self.n_layers):
            x, _ = getattr(self, f"layer_{i}")(x, train=train,
                                               generator=generator)
        x = self.final_norm(x)
        mask = (tokens != 0).float()[..., None]
        pooled = (x * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1e-9)
        return F.linear(pooled, self.cls_head.weight.to(pooled.dtype),
                        self.cls_head.bias.to(pooled.dtype))


class TextClassifier:
    """Sequence classifier over :class:`TransformerEncoder` with the JAX
    package's configuration keys and methods (``compile``, ``fit``,
    ``evaluate``, ``predict``, ``num_params``). ``predict`` gives class
    probabilities. ``attention="auto"`` follows the port's language
    model: ``flash`` unless the head_dim is above the kernels' 128."""

    _CONFIG_KEYS = ("vocab_size", "n_classes", "d_model", "n_layers",
                    "n_heads", "n_kv_heads", "d_ff", "max_len",
                    "attention", "dropout")

    def __init__(self, vocab_size: int, n_classes: int,
                 d_model: int = 256, n_layers: int = 4,
                 n_heads: int = 4, n_kv_heads: int = 0, d_ff: int = 0,
                 max_len: int = 512, attention: str = "dot",
                 dropout: float = 0.0, name: str = "text_classifier",
                 device="cuda"):
        self.name = name
        self.vocab_size = int(vocab_size)
        self.n_classes = int(n_classes)
        self.d_model = int(d_model)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.n_kv_heads = int(n_kv_heads)
        self.d_ff = int(d_ff)
        self.max_len = int(max_len)
        if attention not in ATTENTION_IMPLS + ("auto",):
            raise ValueError(f"unknown attention impl: {attention!r}")
        self.attention = attention
        if self.n_kv_heads < 0 or (
                self.n_kv_heads and self.n_heads % self.n_kv_heads):
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} must be a positive "
                f"divisor of n_heads={self.n_heads} (or 0 for MHA)")
        self.dropout = float(dropout)
        self.device = resolve_device(device)
        self.module: Optional[TransformerEncoder] = None
        self.optimizer_spec: Dict[str, Any] = {"kind": "adamw",
                                               "learning_rate": 3e-4}
        self.history: List[Dict[str, Any]] = []
        self.seed = 0
        self._engine: Optional[engine_lib.Engine] = None
        self._accum = engine_lib.default_grad_accum()

    # ------------------------------------------------------------------
    def _resolved_attention(self) -> str:
        if self.attention != "auto":
            return self.attention
        if self.d_model // self.n_heads > attn_ops.MAX_HEAD_DIM:
            return "dot"
        return "flash"

    def _new_module(self) -> TransformerEncoder:
        with torch.device("meta"):
            return TransformerEncoder(
                self.vocab_size, self.n_classes, d_model=self.d_model,
                n_layers=self.n_layers, n_heads=self.n_heads,
                n_kv_heads=self.n_kv_heads, d_ff=self.d_ff,
                attention=self._resolved_attention(), dropout=self.dropout)

    def set_params(self, state_dict) -> None:
        """Builds the module on the model's device with a copy of
        ``state_dict`` (``weights.params_from_flax`` of a flax tree)."""
        self.module = load_module(self._new_module(), state_dict,
                                  self.device)

    @property
    def params(self):
        return None if self.module is None else self.module.state_dict()

    def num_params(self) -> int:
        if self.module is None:
            return 0
        return sum(p.numel() for p in self.module.parameters())

    def _require_built(self) -> None:
        if self.module is None:
            raise RuntimeError("model has no parameters yet — call fit() "
                               "first (or load a trained artifact)")

    def compile(self, optimizer: Any = "adamw", **_: Any) -> None:
        if isinstance(optimizer, str):
            self.optimizer_spec = {"kind": optimizer}
        elif isinstance(optimizer, dict):
            self.optimizer_spec = dict(optimizer)
        else:
            raise TypeError(f"unsupported optimizer: {optimizer!r}")
        self._engine = None

    def _apply_fn(self, params, batch, train: bool, rng: Optional[int]):
        generator = None
        if train and self.dropout and rng is not None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(rng)
        return torch.func.functional_call(
            self.module, params, (batch["x"],),
            {"train": train, "generator": generator})

    def _get_engine(self) -> engine_lib.Engine:
        if self._engine is None:
            dtype = torch.bfloat16 if Config().compute_dtype == "bfloat16" \
                else torch.float32
            self._engine = engine_lib.Engine(
                apply_fn=self._apply_fn,
                loss_fn=engine_lib.sparse_softmax_loss,
                optimizer=build_optimizer(self.optimizer_spec),
                metrics={"accuracy": engine_lib.accuracy_metric},
                compute_dtype=dtype, grad_accum=self._accum,
                param_layout=FLAX_LAYOUT)
        return self._engine

    def _coerce(self, x) -> np.ndarray:
        """(n, seq) int32 tokens, rows cut to ``max_len``; ids outside
        ``[0, vocab)`` raise before anything reaches the card."""
        if hasattr(x, "to_numpy"):
            x = data_lib.dataframe_to_arrays(x)["x"]
        x = np.atleast_2d(np.asarray(x))
        if x.shape[1] > self.max_len:
            x = x[:, :self.max_len]
        if x.size == 0:
            raise ValueError(f"tokens must be a non-empty (n, seq) array, "
                             f"got shape {x.shape}")
        if x.min() < 0 or x.max() >= self.vocab_size:
            raise ValueError(f"token ids must be in [0, {self.vocab_size})"
                             f", got [{x.min()}, {x.max()}]")
        return x.astype(np.int32)

    def _batcher(self, x, y=None, batch_size=None, shuffle=False):
        arrays = {"x": self._coerce(x)}
        if y is not None:
            arrays["y"] = np.asarray(y).astype(np.int32).reshape(-1)
        return data_lib.ArrayBatcher(
            arrays, batch_size or Config().default_batch_size,
            shuffle=shuffle, seed=self.seed)

    def fit(self, x=None, y=None, batch_size: Optional[int] = None,
            epochs: int = 1, shuffle: bool = True, checkpointer=None,
            log_fn=None, grad_accum: Optional[int] = None,
            **_: Any) -> History:
        """Softmax cross-entropy training on token rows ``x`` and labels
        ``y``; weights from ``weights.init_params(seed)`` when the model
        has none. ``checkpointer`` as in ``LanguageModel.fit``."""
        self._accum, changed = engine_lib.resolve_grad_accum(
            grad_accum, self._accum)
        if changed:
            self._engine = None
        batcher = self._batcher(x, y, batch_size, shuffle=shuffle)
        if self.module is None:
            config = {k: getattr(self, k) for k in self._CONFIG_KEYS}
            self.set_params(weights_lib.params_from_flax(
                weights_lib.init_params(config, self.seed)))
        eng = self._get_engine()
        state = eng.init_state(dict(self.module.named_parameters()))
        state, history = eng.fit(state, batcher, epochs=epochs,
                                 seed=self.seed, checkpointer=checkpointer,
                                 log_fn=log_fn)
        self.history.extend(history)
        return History(history)

    def evaluate(self, x=None, y=None, batch_size: Optional[int] = None,
                 **_: Any) -> Dict[str, float]:
        self._require_built()
        return self._get_engine().evaluate(
            dict(self.module.named_parameters()),
            self._batcher(x, y, batch_size))

    def predict(self, x=None, batch_size: Optional[int] = None,
                **_: Any) -> np.ndarray:
        """Class probabilities (n, n_classes), float32."""
        self._require_built()
        logits = self._get_engine().predict(
            dict(self.module.named_parameters()),
            self._batcher(x, None, batch_size))
        return torch.softmax(torch.from_numpy(logits), dim=-1).numpy()

    # ------------------------------------------------------------------
    # artifact-store native protocol (catalog/artifacts.py)
    # ------------------------------------------------------------------
    def __lo_save__(self, path: str) -> None:
        save_native(self, path)

    @classmethod
    def __lo_load__(cls, path: str, device="cuda") -> "TextClassifier":
        return load_native(cls, path, device)
