"""Weights between the JAX package's flax tree and the port's
``state_dict``.

The flax tree of ``LanguageModel.params`` (nested dicts of arrays) and
the port's module share their names: ``layer_0/attn/q_proj/kernel`` is
``layer_0.attn.q_proj.weight``. A flax ``kernel`` is ``(in, out)`` and a
``torch.nn.Linear.weight`` is ``(out, in)``, so kernels are transposed;
``embed/embedding``, the norms' ``scale``, a Dense ``bias`` (the
classifier's ``cls_head``), the LoRA adapters ``lora_a`` ``(in, rank)``
and ``lora_b`` ``(rank, out)``, and the mixture of experts' raw
parameters ``moe/gate`` ``(d_model, n_experts)`` and
``moe/experts/{wi,wo}`` carry over as they are. The MoE router
``layer_0.moe.gate`` is a parameter of its own and the MLP's
``layer_0.mlp.gate.weight`` a Dense kernel, so the two never meet. The
fused projections ``attn/qkv_proj`` and ``mlp/gate_up`` are Dense
kernels like the others.

A ``NeuralModel``'s tree (``sequential=True``) maps by name alone: its
module (:mod:`.sequential_module`) keeps flax's leaf names and layouts
(Dense and conv kernels, the recurrent cells' gate kernels, batch
norm's ``scale``/``bias``), so ``dense_0/kernel`` is ``dense_0.kernel``
as it is. The ``batch_stats`` collection maps the same way onto the
module's buffers (``batchnorm_1/mean`` is ``batchnorm_1.mean``).

The Builder's estimators carry their fitted numpy state across as it is
(:func:`estimator_from_jax`).

The pipelined LM (:mod:`.pp_transformer`) keeps a plain dict in the JAX
layout, ``embed`` and ``blocks/{ln1, qkv, o, ln2, wi, wo}`` stacked on
the layer dimension, kernels ``(in, out)``; :func:`pp_params_to_numpy`
and :func:`pp_params_from_numpy` carry it across, numpy both ways.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

# standard deviation of a unit normal cut at +-2 (flax/jax
# ``variance_scaling(..., "truncated_normal")``)
_TRUNCATED_STD = 0.87962566103423978


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if hasattr(value, "items"):
            yield from _flatten(value, path)
        else:
            yield path, value


# leaves stored as they are; "gate", "wi" and "wo" are the MoE's raw
# parameters (a Dense kernel's leaf is always "kernel")
_AS_IS = ("scale", "bias", "lora_a", "lora_b", "gate", "wi", "wo")


def flax_path(key: str) -> Tuple[Tuple[str, ...], bool]:
    """The flax path of ``state_dict`` key ``key`` and whether its value
    is stored transposed there."""
    *mods, name = key.split(".")
    if name in _AS_IS:
        return tuple(mods) + (name,), False
    if name == "weight" and mods and mods[-1] == "embed":
        return tuple(mods) + ("embedding",), False
    if name == "weight":
        return tuple(mods) + ("kernel",), True
    raise ValueError(f"unexpected parameter {key}")


def _as_tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else \
        torch.from_numpy(np.array(value))


def params_from_flax(tree, sequential: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax ``LanguageModel.params`` (or
    ``TextClassifier.params``) tree given as nested dicts of numpy (or
    array-like, or torch) values; with ``sequential`` a
    ``NeuralModel``'s ``params`` or ``batch_stats`` tree, by name."""
    if sequential:
        return {".".join(path): _as_tensor(value).contiguous()
                for path, value in _flatten(tree)}
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        *mods, leaf = path
        if leaf == "kernel":
            name = "weight"
        elif leaf == "embedding":
            name = "weight"
        elif leaf in _AS_IS:
            name = leaf
        else:
            raise ValueError(f"parameter {'/'.join(path)} has no "
                             f"counterpart in the PyTorch package yet")
        t = _as_tensor(value)
        if leaf == "kernel":
            if t.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D kernel,"
                                 f" got shape {tuple(t.shape)}")
            t = t.t()
        out[".".join(mods + [name])] = t.contiguous()
    return out


def estimator_from_jax(est, device="cuda"):
    """The port's estimator (:mod:`.estimators`) with the fitted state of
    a JAX ``LogisticRegressionJAX`` (``w``, ``b`` and ``classes_``, the
    hyperparameters and the history) or ``GaussianNBJAX`` (``theta_``,
    ``var_``, ``class_prior_``, ``classes_`` and ``var_smoothing``).
    ``est`` is the JAX object or its attribute dict (what its pickle
    holds); either carries only numpy state, so nothing of JAX is read.
    ``device`` places the next fit (None: not placed yet)."""
    from learningorchestra_tpu_torch.models import estimators

    state = est if isinstance(est, dict) else vars(est)
    if "theta_" in state:
        port = estimators.GaussianNBJAX(
            var_smoothing=state.get("var_smoothing", 1e-9), device=device)
        for key in ("theta_", "var_", "class_prior_"):
            if state.get(key) is not None:
                setattr(port, key, np.array(state[key], np.float64))
    else:
        port = estimators.LogisticRegressionJAX(
            epochs=state.get("epochs", 12),
            batch_size=state.get("batch_size", 4096),
            learning_rate=state.get("learning_rate", 0.05),
            seed=state.get("seed", 0), device=device)
        if state.get("params") is not None:
            port.params = {k: np.array(state["params"][k], np.float32)
                           for k in ("w", "b")}
        port.history = list(state.get("history") or [])
    if state.get("classes_") is not None:
        port.classes_ = np.array(state["classes_"])
    return port


def _host(tensor: torch.Tensor, transposed: bool) -> np.ndarray:
    arr = tensor.detach().cpu().numpy()
    return np.ascontiguousarray(arr.T) if transposed else arr


def sequential_path(key: str) -> Tuple[Tuple[str, ...], bool]:
    """:func:`flax_path` of a ``NeuralModel`` module's key."""
    return tuple(key.split(".")), False


def params_to_flax(state_dict, leaf: Optional[Callable] = None,
                   sequential: bool = False) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: nested dicts in the flax
    layout, of numpy arrays (or of ``leaf(tensor, transposed)``)."""
    leaf = leaf or _host
    to_path = sequential_path if sequential else flax_path
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        path, transposed = to_path(key)
        node = tree
        for mod in path[:-1]:
            node = node.setdefault(mod, {})
        node[path[-1]] = leaf(tensor, transposed)
    return tree


def _lecun_normal(rng, fan_in: int, fan_out: int) -> np.ndarray:
    """flax's ``lecun_normal``: a normal truncated to [-2, 2] by
    redrawing what falls outside, scaled by 1/0.8796..., the standard
    deviation of that cut, to variance 1/fan_in."""
    x = rng.standard_normal((fan_in, fan_out), dtype=np.float32)
    out = np.abs(x) > 2.0
    while out.any():
        x[out] = rng.standard_normal(int(out.sum()), dtype=np.float32)
        out = np.abs(x) > 2.0
    return x * np.float32(1.0 / np.sqrt(fan_in) / _TRUNCATED_STD)


def lora_adapters(config: Dict[str, Any], seed: int,
                  rank: int) -> Dict[str, torch.Tensor]:
    """Fresh rank-``rank`` adapters of every attention projection, as
    ``state_dict`` entries: ``lora_a`` from ``lecun_normal``, ``lora_b``
    at zero (so the adapted model starts as the base), drawn with numpy
    from ``seed``."""
    rng = np.random.default_rng([seed, 1])
    d = int(config["d_model"])
    heads = int(config["n_heads"])
    kv = int(config.get("n_kv_heads") or 0) or heads
    hd = d // heads
    if config.get("fused_proj") and kv == heads:
        widths = {"qkv_proj": (d, 3 * heads * hd), "o_proj": (heads * hd, d)}
    else:
        widths = {"q_proj": (d, heads * hd), "k_proj": (d, kv * hd),
                  "v_proj": (d, kv * hd), "o_proj": (heads * hd, d)}
    out: Dict[str, torch.Tensor] = {}
    for i in range(int(config["n_layers"])):
        for proj, (fan_in, fan_out) in widths.items():
            key = f"layer_{i}.attn.{proj}"
            out[f"{key}.lora_a"] = torch.from_numpy(
                _lecun_normal(rng, fan_in, rank))
            out[f"{key}.lora_b"] = torch.zeros(rank, fan_out)
    return out


def init_params(config: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """A full random flax-layout tree for a ``LanguageModel`` config
    (its ``vocab_size``, ``d_model``, ``n_layers``, ``n_heads``,
    ``n_kv_heads``, ``d_ff``, ``n_experts``, ``fused_proj``,
    ``lora_rank``) or, where the config has
    ``n_classes``, a ``TextClassifier``'s (a ``cls_head`` with bias in
    place of ``lm_head``), made with numpy from ``seed`` with flax's
    initializers: Dense kernels from ``lecun_normal`` (a normal cut at
    two standard deviations and rescaled to variance 1/fan_in), the
    embedding from ``default_embed_init`` (a plain normal, variance
    1/d_model), norm scales at one, biases at zero, the MoE's router and
    experts from ``normal(1/sqrt(fan_in))``; adapters as
    :func:`lora_adapters` makes them. Under ``fused_proj`` the MLP has
    ``gate_up`` and, without GQA, the attention ``qkv_proj``."""
    rng = np.random.default_rng(seed)
    vocab = int(config["vocab_size"])
    d = int(config["d_model"])
    heads = int(config["n_heads"])
    kv = int(config.get("n_kv_heads") or 0) or heads
    d_ff = int(config.get("d_ff") or 0) or 4 * d
    hd = d // heads

    def normal(fan_in: int, shape):
        return (rng.standard_normal(shape, dtype=np.float32)
                / np.float32(np.sqrt(fan_in)))

    def dense(fan_in: int, fan_out: int):
        return {"kernel": _lecun_normal(rng, fan_in, fan_out)}

    def ones():
        return {"scale": np.ones((d,), np.float32)}

    experts = int(config.get("n_experts") or 0)
    fused = bool(config.get("fused_proj"))

    def attn():
        if fused and kv == heads:
            return {"qkv_proj": dense(d, 3 * heads * hd),
                    "o_proj": dense(heads * hd, d)}
        return {"q_proj": dense(d, heads * hd), "k_proj": dense(d, kv * hd),
                "v_proj": dense(d, kv * hd), "o_proj": dense(heads * hd, d)}

    def ffn():
        if experts > 0:
            return "moe", {"gate": normal(d, (d, experts)),
                           "experts": {"wi": normal(d, (experts, d, d_ff)),
                                       "wo": normal(d_ff,
                                                    (experts, d_ff, d))}}
        if fused:
            return "mlp", {"gate_up": dense(d, 2 * d_ff),
                           "down_proj": dense(d_ff, d)}
        return "mlp", {"gate": dense(d, d_ff), "up_proj": dense(d, d_ff),
                       "down_proj": dense(d_ff, d)}

    tree: Dict[str, Any] = {"embed": {"embedding": normal(d, (vocab, d))}}
    for i in range(int(config["n_layers"])):
        layer = {"attn_norm": ones(), "attn": attn(), "mlp_norm": ones()}
        name, value = ffn()
        layer[name] = value
        tree[f"layer_{i}"] = layer
    tree["final_norm"] = ones()
    if "n_classes" in config:
        n_classes = int(config["n_classes"])
        tree["cls_head"] = dict(dense(d, n_classes),
                                bias=np.zeros((n_classes,), np.float32))
        return tree
    tree["lm_head"] = dense(d, vocab)
    rank = int(config.get("lora_rank") or 0)
    if rank > 0:
        for key, value in lora_adapters(config, seed, rank).items():
            path, _ = flax_path(key)
            node = tree
            for mod in path[:-1]:
                node = node[mod]
            node[path[-1]] = value.numpy()
    return tree


PP_BLOCK_KEYS = ("ln1", "qkv", "o", "ln2", "wi", "wo")


def pp_params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The pipelined LM's params as float32 numpy arrays, the same tree
    (the JAX package's ``pp_transformer`` layout)."""
    def host(t):
        if isinstance(t, torch.Tensor):
            return t.detach().float().cpu().numpy().copy()
        return np.asarray(t, np.float32).copy()

    return {"embed": host(params["embed"]),
            "blocks": {k: host(params["blocks"][k]) for k in PP_BLOCK_KEYS}}


def pp_params_from_numpy(tree: Dict[str, Any],
                         device="cpu") -> Dict[str, Any]:
    """The pipelined LM's params from a numpy (or JAX) tree: float32
    tensors on ``device``, the same layout."""
    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return {"embed": tensor(tree["embed"]),
            "blocks": {k: tensor(tree["blocks"][k]) for k in PP_BLOCK_KEYS}}
