"""Weights between the JAX package's flax tree and the port's
``state_dict``.

The flax tree of ``LanguageModel.params`` (nested dicts of arrays) and
the port's module share their names: ``layer_0/attn/q_proj/kernel`` is
``layer_0.attn.q_proj.weight``. A flax ``kernel`` is ``(in, out)`` and a
``torch.nn.Linear.weight`` is ``(out, in)``, so kernels are transposed;
``embed/embedding`` and the norms' ``scale`` carry over as they are.
"""

from __future__ import annotations

from typing import Any, Dict

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


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax ``LanguageModel.params``
    tree given as nested dicts of numpy (or array-like) values."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        *mods, leaf = path
        arr = np.asarray(value)
        if leaf == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D kernel,"
                                 f" got shape {arr.shape}")
            name, arr = "weight", arr.T
        elif leaf == "embedding":
            name = "weight"
        elif leaf == "scale":
            name = "scale"
        else:
            raise ValueError(f"parameter {'/'.join(path)} has no "
                             f"counterpart in the PyTorch package yet")
        out[".".join(mods + [name])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def params_to_flax(state_dict) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: nested dicts of numpy
    arrays in the flax layout."""
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        *mods, name = key.split(".")
        arr = tensor.detach().cpu().numpy()
        if name == "scale":
            leaf = "scale"
        elif name == "weight" and mods[-1] == "embed":
            leaf = "embedding"
        elif name == "weight":
            leaf, arr = "kernel", np.ascontiguousarray(arr.T)
        else:
            raise ValueError(f"unexpected parameter {key}")
        node = tree
        for mod in mods:
            node = node.setdefault(mod, {})
        node[leaf] = arr
    return tree


def init_params(config: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """A full random flax-layout tree for a ``LanguageModel`` config
    (its ``vocab_size``, ``d_model``, ``n_layers``, ``n_heads``,
    ``n_kv_heads``, ``d_ff``), made with numpy from ``seed`` with flax's
    initializers: Dense kernels from ``lecun_normal`` (a normal cut at
    two standard deviations and rescaled to variance 1/fan_in), the
    embedding from ``default_embed_init`` (a plain normal, variance
    1/d_model), norm scales at one."""
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
        # truncated to [-2, 2] by redrawing what falls outside, then
        # scaled by 1/0.8796..., the standard deviation of that cut
        x = rng.standard_normal((fan_in, fan_out), dtype=np.float32)
        out = np.abs(x) > 2.0
        while out.any():
            x[out] = rng.standard_normal(int(out.sum()), dtype=np.float32)
            out = np.abs(x) > 2.0
        return {"kernel": x * np.float32(
            1.0 / np.sqrt(fan_in) / _TRUNCATED_STD)}

    def ones():
        return {"scale": np.ones((d,), np.float32)}

    tree: Dict[str, Any] = {"embed": {"embedding": normal(d, (vocab, d))}}
    for i in range(int(config["n_layers"])):
        tree[f"layer_{i}"] = {
            "attn_norm": ones(),
            "attn": {"q_proj": dense(d, heads * hd),
                     "k_proj": dense(d, kv * hd),
                     "v_proj": dense(d, kv * hd),
                     "o_proj": dense(heads * hd, d)},
            "mlp_norm": ones(),
            "mlp": {"gate": dense(d, d_ff), "up_proj": dense(d, d_ff),
                    "down_proj": dense(d_ff, d)},
        }
    tree["final_norm"] = ones()
    tree["lm_head"] = dense(d, vocab)
    return tree
