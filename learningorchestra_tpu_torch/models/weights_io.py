"""Real keras artifacts in and out of the port's ``NeuralModel``: the
port's copy of the JAX package's ``models/weights_io.py`` (its keras
half; the ``.npz`` export is ``NeuralModel.save_weights``).

The reference persists real Keras artifacts and reloads them across
services (binary_executor_image/utils.py:195-221). Read here:

- **Keras ``.h5`` / ``.weights.h5``** weights (Keras 3 layout
  ``/layers/<name>/vars/<i>``, or the legacy per-layer groups), matched
  onto the model's layers kind by kind and shape-checked;
- **``.keras``** archives (``config.json`` + ``model.weights.h5``);
- **TF SavedModel directories** (``keras_metadata.pb`` + the variables
  bundle, :mod:`.tf_bundle`), with numpy alone;
- **legacy whole-model ``.h5``** files (``model_config`` + ``model_weights``).

:func:`build_keras_model` goes the other way, to a live keras model
(``save_keras`` writes it as a ``.keras`` archive).

The fillers work on the flax layout of the model's params (nested dicts
of numpy arrays, ``weights.params_to_flax(..., sequential=True)``), whose
names the port's module keeps (``dense_0/kernel``,
``OptimizedLSTMCell_0/hi/bias``), so one mapping serves both packages and
the gate packing is the module's (models/sequential_module.py). Keras's
kernel layouts for Dense/Conv/Embedding/BatchNorm coincide with flax's
(no transposes); unsupported layer kinds and configs fail loudly rather
than load garbage.

No tensorflow import happens here. ``h5py`` (the ``.h5`` and ``.keras``
readers) and ``keras`` (:func:`build_keras_model`) are imported inside
the functions that need them, never when this module is: where one is
absent, the call raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import importlib
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _require(module: str, what: str):
    """``module`` imported, or an ``ImportError`` naming it."""
    try:
        return importlib.import_module(module)
    except ImportError as exc:
        raise ImportError(f"{what} needs the {module!r} package, which is "
                          f"not installed", name=module) from exc


def _copy_tree(tree: Any) -> Any:
    """A copy of a nested dict's structure (the leaves shared): the
    fillers replace leaves, never write into them."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# our sequential layer kinds that own parameters, in the order their
# keras twins enumerate their variables
_KERAS_VAR_ORDERS = {
    "dense": ("kernel", "bias"),
    "conv2d": ("kernel", "bias"),
    "conv1d": ("kernel", "bias"),
    # keras stores (kh, kw, out, in) == flax ConvTranspose with
    # transpose_kernel=True (sequential_module builds it that way)
    "conv2d_transpose": ("kernel", "bias"),
    "embedding": ("embedding",),
    "batchnorm": ("scale", "bias", "mean", "var"),  # gamma/beta/mm/mv
    "layernorm": ("scale", "bias"),  # gamma/beta; flax names coincide
    # keras packs the 4 gates column-wise in (i, f, c, o) order
    "lstm": ("kernel", "recurrent_kernel", "bias"),
    # keras packs the 3 gates column-wise in (z, r, h) order; bias is
    # (2, 3u) when reset_after=True (input row + recurrent row)
    "gru": ("kernel", "recurrent_kernel", "bias"),
    "simple_rnn": ("kernel", "recurrent_kernel", "bias"),
    # keras h5 nests backward_layer then forward_layer (alphabetical):
    # 6 vars = backward (k, r, b) + forward (k, r, b)
    "bidirectional_lstm": ("kernel", "recurrent_kernel", "bias") * 2,
    "bidirectional_gru": ("kernel", "recurrent_kernel", "bias") * 2,
}

# our layer kind -> the group-name prefix keras auto-assigns the twin
# layer ("dense", "dense_1", ... in MODEL order within a kind). h5
# group iteration is alphabetical with no order attribute, so layers
# are matched kind-by-kind, not positionally across kinds.
_KERAS_NAME_PREFIX = {
    "dense": "dense",
    "conv2d": "conv2d",
    "conv1d": "conv1d",
    "conv2d_transpose": "conv2d_transpose",
    "embedding": "embedding",
    "batchnorm": "batch_normalization",
    "layernorm": "layer_normalization",
    "lstm": "lstm",
    "gru": "gru",
    "simple_rnn": "simple_rnn",
    "bidirectional_lstm": "bidirectional",
    "bidirectional_gru": "bidirectional",
}

# flax OptimizedLSTMCell gate order matching keras's (i, f, c->g, o)
_LSTM_GATES = ("i", "f", "g", "o")

# flax scope-name prefix per recurrent kind (activation parity note:
# gelu/leaky_relu are pinned keras-exact in
# sequential_module._ACTIVATIONS, so activation strings round-trip)
_CELL_SCOPE_PREFIXES = {"lstm": "OptimizedLSTMCell", "gru": "GRUCell",
                        "simple_rnn": "SimpleCell"}


def _recurrent_cell_pools(params):
    """Per-kind iterators over recurrent cell scopes in creation order
    (cells scope under <CellClass>_<k>; the nn.RNN wrapper does not
    add a name level)."""
    return {kind: iter(sorted(
        (k for k in params if k.startswith(prefix)), key=_natural_key))
        for kind, prefix in _CELL_SCOPE_PREFIXES.items()}


def _take_cell(params, pools, kind, name):
    try:
        return params[next(pools[kind])]
    except StopIteration:
        raise ValueError(f"{name}: model has no {kind.upper()} "
                         f"cell params left to fill") from None


# ----------------------------------------------------------------------
# Keras h5 import
# ----------------------------------------------------------------------
def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def read_keras_h5(path: str, root_key: Optional[str] = None,
                  ) -> List[Tuple[str, List[np.ndarray]]]:
    """(group_name, variable list) pairs from a Keras 3 weights file
    (``/layers/<name>/vars/<i>``; legacy tf.keras files use per-layer
    top groups with ``<name>/<var>:0`` datasets), natural-sorted by
    group name. Parameter-free layers (flatten, pooling) are dropped.
    ``root_key`` overrides the group scan root (legacy whole-model
    files keep weights under ``model_weights``)."""
    h5py = _require("h5py", "reading a keras .h5 file")

    layers: List[Tuple[str, List[np.ndarray]]] = []
    with h5py.File(path, "r") as f:
        if root_key is not None:
            root = f[root_key]
        else:
            root = f["layers"] if "layers" in f else f
        for lname in sorted(root, key=_natural_key):
            grp = root[lname]
            if not isinstance(grp, h5py.Group):
                continue
            vals: List[np.ndarray] = []
            # legacy tf.keras groups record variable order explicitly
            # (alphabetical dataset iteration would put bias:0 before
            # kernel:0); keras-3 vars/<i> groups sort correctly
            weight_names = grp.attrs.get("weight_names")
            if weight_names is not None and len(weight_names):
                names = [wn.decode("utf-8") if isinstance(wn, bytes)
                         else str(wn) for wn in weight_names]
                # the loader's Bidirectional convention is BACKWARD
                # cell first (keras-3 h5 groups sort that way);
                # legacy weight_names list forward first — reorder
                names.sort(key=lambda n: 0 if "backward" in n else 1)
                for wn in names:
                    vals.append(np.asarray(grp[wn]))
                layers.append((lname, vals))
                continue

            def collect(g):
                for k in sorted(g, key=_natural_key):
                    item = g[k]
                    if hasattr(item, "shape") and item.shape is not None \
                            and not isinstance(item, h5py.Group):
                        vals.append(np.asarray(item))
                    elif isinstance(item, h5py.Group):
                        collect(item)

            collect(grp)
            if vals:
                layers.append((lname, vals))
    return layers


def load_keras_h5_into_sequential(layer_configs, params: Dict[str, Any],
                                  model_state: Dict[str, Any],
                                  path: Optional[str] = None,
                                  h5_layers: Optional[List[Tuple[
                                      str, List[np.ndarray]]]] = None,
                                  ) -> Tuple[Dict[str, Any],
                                             Dict[str, Any]]:
    """Map a real Keras Sequential weights file onto the tf_compat
    Sequential's flax params. h5 groups sort ALPHABETICALLY (keras
    writes no order attribute), so layers are matched by KIND: within
    a kind keras numbers groups in model order (``conv2d``,
    ``conv2d_1``, ...), which natural sort preserves — each of our
    parameterized layers consumes the next unused group of its kind's
    keras name prefix. ``h5_layers`` supplies pre-extracted
    (group_name, vals) pairs instead of a file (the SavedModel and
    legacy-h5 importers use this). Returns new (params, model_state)."""
    if h5_layers is None:
        if path is None:
            raise ValueError("pass either path or h5_layers")
        h5_layers = read_keras_h5(path)
    # bucket by the keras GROUP PREFIX (not our kind): two kinds can
    # share one keras prefix (bidirectional lstm/gru both serialize
    # under "bidirectional"), and groups consume in natural-sort ==
    # model order either way
    by_prefix: Dict[str, List[List[np.ndarray]]] = {}
    matched = 0
    prefixes = sorted(set(_KERAS_NAME_PREFIX.values()))
    for gname, vals in h5_layers:
        for prefix in prefixes:
            if re.fullmatch(re.escape(prefix) + r"(_\d+)?", gname):
                by_prefix.setdefault(prefix, []).append(vals)
                break
    params = _copy_tree(params)
    state = _copy_tree(dict(model_state or {}))
    taken: Dict[str, int] = {}
    cell_pools = _recurrent_cell_pools(params)

    def _next_cell(kind, name):
        return _take_cell(params, cell_pools, kind, name)
    for i, cfg in enumerate(layer_configs):
        kind = cfg["kind"]
        name = f"{kind}_{i}"
        if name not in params and kind not in (
                "batchnorm", "lstm", "gru", "simple_rnn",
                "bidirectional_lstm", "bidirectional_gru"):
            continue  # parameter-free layer
        if kind not in _KERAS_VAR_ORDERS:
            raise ValueError(
                f"h5 import does not support layer kind {kind!r} "
                f"(layer {i}); export/import via npz instead")
        prefix = _KERAS_NAME_PREFIX[kind]
        pool = by_prefix.get(prefix, [])
        pos = taken.get(prefix, 0)
        if pos >= len(pool):
            raise ValueError(
                f"h5 file has {len(pool)} {prefix!r} layer(s) but the "
                f"model needs more (at {name})")
        vals = pool[pos]
        taken[prefix] = pos + 1
        matched += 1
        order = _KERAS_VAR_ORDERS[kind]
        if len(vals) != len(order):
            raise ValueError(
                f"{name}: h5 layer has {len(vals)} variables, "
                f"expected {len(order)} ({order})")
        # HoistedLSTM (LO_LSTM_HOIST=1) stores the keras packed layout
        # directly under the layer name, so it takes the generic copy
        # branch below; only cell-scoped recurrent layers (name absent
        # from params) go through the gate-splitting fillers
        if kind in ("lstm", "gru", "simple_rnn") \
                and name not in params:
            _FILL_CELL[kind](name, _next_cell(kind, name), *vals)
        elif kind in ("bidirectional_lstm", "bidirectional_gru"):
            base = kind.split("_", 1)[1]
            # keras h5 nests backward_layer before forward_layer
            # (alphabetical); our fwd cell was created first, so it
            # holds the LOWER cell index in the pool
            fwd_cell = _next_cell(base, name)
            bwd_cell = _next_cell(base, name)
            _FILL_CELL[base](f"{name}/backward", bwd_cell, *vals[:3])
            _FILL_CELL[base](f"{name}/forward", fwd_cell, *vals[3:])
        elif kind == "batchnorm":
            gamma, beta, mean, var = vals
            params[name]["scale"] = _check(name, "scale",
                                           params[name]["scale"], gamma)
            params[name]["bias"] = _check(name, "bias",
                                          params[name]["bias"], beta)
            bn_state = state.setdefault("batch_stats", {}).setdefault(
                name, {})
            bn_state["mean"] = mean
            bn_state["var"] = var
        else:
            for pname, arr in zip(order, vals):
                if pname in params[name]:
                    params[name][pname] = _check(
                        name, pname, params[name][pname], arr)
    total = sum(len(v) for v in by_prefix.values())
    if matched != total:
        raise ValueError(
            f"h5 file has {total - matched} parameterized layer(s) the "
            f"model does not declare")
    if matched != len(h5_layers):
        unknown = [g for g, _ in h5_layers
                   if not any(re.fullmatch(re.escape(p) + r"(_\d+)?", g)
                              for p in _KERAS_NAME_PREFIX.values())]
        raise ValueError(
            f"h5 file has unsupported keras layer group(s): {unknown}")
    return params, state


def _check(layer: str, pname: str, target, arr: np.ndarray) -> np.ndarray:
    if tuple(arr.shape) != tuple(np.shape(target)):
        raise ValueError(
            f"{layer}/{pname}: h5 has shape {tuple(arr.shape)}, model "
            f"needs {tuple(np.shape(target))}")
    return np.asarray(arr, dtype=np.asarray(target).dtype)


def _fill_lstm_cell(name, cell, kern, rec, bias) -> None:
    u = rec.shape[0]
    if kern.shape[1] != 4 * u or bias.shape[0] != 4 * u:
        raise ValueError(
            f"{name}: keras LSTM vars have shapes "
            f"{kern.shape}/{rec.shape}/{bias.shape}, expected "
            f"(in,4u)/(u,4u)/(4u,)")
    for gi, g in enumerate(_LSTM_GATES):
        cell[f"i{g}"]["kernel"] = _check(
            name, f"i{g}/kernel", cell[f"i{g}"]["kernel"],
            kern[:, gi * u:(gi + 1) * u])
        cell[f"h{g}"]["kernel"] = _check(
            name, f"h{g}/kernel", cell[f"h{g}"]["kernel"],
            rec[:, gi * u:(gi + 1) * u])
        cell[f"h{g}"]["bias"] = _check(
            name, f"h{g}/bias", cell[f"h{g}"]["bias"],
            bias[gi * u:(gi + 1) * u])


def _fill_gru_cell(name, cell, kern, rec, bias) -> None:
    u = rec.shape[0]
    if kern.shape[1] != 3 * u:
        raise ValueError(
            f"{name}: keras GRU vars have shapes "
            f"{kern.shape}/{rec.shape}, expected (in,3u)/(u,3u)")
    if bias.ndim != 2 or bias.shape != (2, 3 * u):
        raise ValueError(
            f"{name}: keras GRU bias has shape {bias.shape}; only "
            "reset_after=True ((2, 3u) bias) maps onto flax GRUCell, "
            "which applies the reset gate after the recurrent matmul")
    b_in, b_rec = bias[0], bias[1]
    # keras packs (z, r, h) columns; flax scopes iz/ir/in + hz/hr/hn.
    # Input and recurrent gate biases collapse into the single flax
    # i{z,r} bias (the sums are what the math adds anyway); hn keeps
    # its own bias because the reset gate multiplies it:
    # n = tanh(in(x) + r * (hn(h) + b)).
    for col, g in enumerate(("z", "r", "n")):
        lo, hi = col * u, (col + 1) * u
        ik = "in" if g == "n" else f"i{g}"
        cell[ik]["kernel"] = _check(
            name, f"{ik}/kernel", cell[ik]["kernel"], kern[:, lo:hi])
        cell[f"h{g}"]["kernel"] = _check(
            name, f"h{g}/kernel", cell[f"h{g}"]["kernel"],
            rec[:, lo:hi])
        if g == "n":
            cell["in"]["bias"] = _check(
                name, "in/bias", cell["in"]["bias"], b_in[lo:hi])
            cell["hn"]["bias"] = _check(
                name, "hn/bias", cell["hn"]["bias"], b_rec[lo:hi])
        else:
            cell[ik]["bias"] = _check(
                name, f"{ik}/bias", cell[ik]["bias"],
                b_in[lo:hi] + b_rec[lo:hi])


def _fill_simple_cell(name, cell, kern, rec, bias) -> None:
    # keras h' = act(x@W + b + h@U) == flax i(x) + h(h)
    cell["i"]["kernel"] = _check(name, "i/kernel",
                                 cell["i"]["kernel"], kern)
    cell["i"]["bias"] = _check(name, "i/bias", cell["i"]["bias"], bias)
    cell["h"]["kernel"] = _check(name, "h/kernel",
                                 cell["h"]["kernel"], rec)


_FILL_CELL = {"lstm": _fill_lstm_cell, "gru": _fill_gru_cell,
              "simple_rnn": _fill_simple_cell}


# ----------------------------------------------------------------------
# full .keras archive import (architecture + weights)
# ----------------------------------------------------------------------
# keras-3 class name -> the tf_compat shim class that already encodes
# the keras-arg -> layer-config mapping (tf_compat/keras/layers.py).
# Instantiating shim(**layer_config) and taking its .config keeps ONE
# conversion path; shim constructors swallow cosmetic keras keys
# (initializers, regularizers, names) via **_, so semantics-changing
# keys the shims do NOT model are explicitly rejected below instead of
# silently producing different math. The reference passes whole Keras
# artifacts between services (binary_executor_image/utils.py:195-221);
# this is the equivalent: one call re-creates the model AND weights.
_KERAS_SHIM_CLASS_NAMES = (
    "Dense", "Conv2D", "Conv1D", "Conv2DTranspose", "MaxPooling2D",
    "AveragePooling2D", "MaxPooling1D", "GlobalAveragePooling2D",
    "GlobalAveragePooling1D", "GlobalMaxPooling1D",
    "GlobalMaxPooling2D", "Flatten", "Reshape", "Dropout",
    "BatchNormalization", "LayerNormalization", "Embedding", "LSTM",
    "GRU", "SimpleRNN", "Activation", "Bidirectional",
)

# keras config keys whose NON-default values change layer math the
# shims/module do not model -> loading would silently diverge from
# the keras original ("fail loudly rather than load garbage")
_DEFAULT_ONLY_KEYS = {
    "dilation_rate": lambda v: v in (1, [1, 1], (1, 1), [1], (1,)),
    "groups": lambda v: v in (1, None),
    "go_backwards": lambda v: not v,
    "stateful": lambda v: not v,
    "use_bias": lambda v: v in (True, None),
    "data_format": lambda v: v in (None, "channels_last"),
    "reset_after": lambda v: v in (True, None),
    # norm layers without a learned scale/offset change the param set
    "center": lambda v: v in (True, None),
    "scale": lambda v: v in (True, None),
}
# pooling layers: the module pools without padding, so only "valid"
_POOL_CLASS_NAMES = ("MaxPooling1D", "MaxPooling2D",
                     "AveragePooling2D")


def _reject_non_defaults(cls_name: str, lcfg: Dict[str, Any]) -> None:
    for key, is_default in _DEFAULT_ONLY_KEYS.items():
        if key in lcfg and lcfg[key] is not None \
                and not is_default(lcfg[key]):
            raise ValueError(
                f"{cls_name}: unsupported non-default "
                f"{key}={lcfg[key]!r} — importing would silently "
                f"change the layer math")
    if cls_name in _POOL_CLASS_NAMES and \
            str(lcfg.get("padding") or "valid").lower() != "valid":
        raise ValueError(
            f"{cls_name}: only padding='valid' pooling is supported")


def parse_sequential_config(cfg: Dict[str, Any]):
    """A serialized keras Sequential model config (keras-3
    ``config.json`` or tf_keras SavedModel / legacy-h5
    ``model_config`` dialect) -> ``(layer_configs, input_shape)`` in
    this framework's layer-config vocabulary. Unsupported topologies
    and math-changing non-default options fail loudly."""
    from learningorchestra_tpu_torch.models.tf_compat.keras import (
        layers as shim_layers)

    if cfg.get("class_name") != "Sequential":
        raise ValueError(
            f"only Sequential keras models are supported, got "
            f"{cfg.get('class_name')!r}")
    seq_cfg = cfg["config"]
    input_shape = None
    build_shape = seq_cfg.get("build_input_shape")
    if build_shape:
        # recorded when the model was built without an explicit
        # InputLayer in the serialized layer list
        input_shape = list(build_shape[1:])
    configs: List[Dict[str, Any]] = []
    for layer in seq_cfg["layers"]:
        cls = layer["class_name"]
        lcfg = layer.get("config", {})
        if cls == "InputLayer":
            shape = lcfg.get("batch_shape") or lcfg.get(
                "batch_input_shape")
            if shape:
                input_shape = list(shape[1:])
            continue
        if cls == "Bidirectional":
            # keras nests the wrapped RNN layer's own serialization
            merge = lcfg.get("merge_mode", "concat")
            if merge != "concat":
                raise ValueError(
                    f"Bidirectional: only merge_mode='concat' is "
                    f"supported, got {merge!r} — importing would "
                    f"silently change the layer math")
            inner = lcfg.get("layer", {})
            bwd = lcfg.get("backward_layer")
            if bwd is not None:
                # keras serializes the auto-mirrored backward layer
                # too; only a genuinely CUSTOM one changes the math

                def _strip_ids(obj):
                    if isinstance(obj, dict):
                        return {k: _strip_ids(v) for k, v in obj.items()
                                if k not in ("shared_object_id", "name")}
                    if isinstance(obj, list):
                        return [_strip_ids(v) for v in obj]
                    return obj

                def _mirror_key(layer_dict):
                    c = _strip_ids(layer_dict.get("config", {}))
                    c.pop("go_backwards", None)
                    return (layer_dict.get("class_name"), c)

                if _mirror_key(bwd) != _mirror_key(inner):
                    raise ValueError(
                        "Bidirectional: a custom backward_layer is "
                        "not supported (the import mirrors the "
                        "forward layer)")
            _reject_non_defaults(inner.get("class_name", "?"),
                                 inner.get("config", {}))
            inner_shim = getattr(shim_layers,
                                 inner.get("class_name", ""), None)
            if inner_shim is None:
                raise ValueError(
                    f"Bidirectional wraps unsupported layer "
                    f"{inner.get('class_name')!r}")
            configs.append(shim_layers.Bidirectional(
                inner_shim(**inner.get("config", {}))).config)
            continue
        if cls not in _KERAS_SHIM_CLASS_NAMES:
            raise ValueError(
                f"keras layer {cls!r} has no layer-config mapping "
                f"(supported: {sorted(_KERAS_SHIM_CLASS_NAMES)})")
        _reject_non_defaults(cls, lcfg)
        configs.append(getattr(shim_layers, cls)(**lcfg).config)
    return configs, input_shape


def read_keras_archive(path: str):
    """Parse a keras-3 ``.keras`` archive (zip of config.json +
    model.weights.h5) into ``(layer_configs, input_shape,
    weights_h5_bytes)``. Only Sequential topologies map onto the
    layer-config vocabulary; anything else fails loudly."""
    import json
    import zipfile

    with zipfile.ZipFile(path) as z:
        cfg = json.loads(z.read("config.json"))
        weights = z.read("model.weights.h5")
    configs, input_shape = parse_sequential_config(cfg)
    return configs, input_shape, weights


# ----------------------------------------------------------------------
# TF SavedModel-directory import (reference utils.py:201-220 stores
# Keras models exactly this way; read with zero tensorflow imports)
# ----------------------------------------------------------------------
# object-graph child paths per layer kind, ordered to match
# _KERAS_VAR_ORDERS (bidirectional: backward first, the h5 convention)
_CKPT_LAYER_PATHS = {
    "dense": ("kernel", "bias"),
    "conv2d": ("kernel", "bias"),
    "conv1d": ("kernel", "bias"),
    "conv2d_transpose": ("kernel", "bias"),
    "embedding": ("embeddings",),
    "batchnorm": ("gamma", "beta", "moving_mean", "moving_variance"),
    "layernorm": ("gamma", "beta"),
    "lstm": ("cell/kernel", "cell/recurrent_kernel", "cell/bias"),
    "gru": ("cell/kernel", "cell/recurrent_kernel", "cell/bias"),
    "simple_rnn": ("cell/kernel", "cell/recurrent_kernel",
                   "cell/bias"),
    "bidirectional_lstm": tuple(
        f"{d}_layer/cell/{v}" for d in ("backward", "forward")
        for v in ("kernel", "recurrent_kernel", "bias")),
    "bidirectional_gru": tuple(
        f"{d}_layer/cell/{v}" for d in ("backward", "forward")
        for v in ("kernel", "recurrent_kernel", "bias")),
}


def read_savedmodel(path: str):
    """Parse a Keras SavedModel DIRECTORY (stock
    ``tf.keras.models.save_model`` output) into ``(layer_configs,
    input_shape, h5_style_layers)`` without importing tensorflow —
    the architecture comes from ``keras_metadata.pb`` and the weights
    from the ``variables/`` TensorBundle, resolved through the
    checkpoint object graph (the saver dedupes shared variables under
    canonical keys, so literal name joins do not work)."""
    import os as _os

    from learningorchestra_tpu_torch.models import tf_bundle

    cfg = tf_bundle.read_saved_model_config(path)
    configs, input_shape = parse_sequential_config(cfg)
    prefix = _os.path.join(path, "variables", "variables")
    # one index parse, then decode ONLY the resolved model variables
    # (a trained checkpoint also holds optimizer slots ~2x the model)
    entries = tf_bundle.read_index(prefix + ".index")
    nodes = tf_bundle.read_object_graph(prefix, entries=entries)
    layer_keys: List[Tuple[str, List[str]]] = []
    counts: Dict[str, int] = {}
    wi = 0
    for c in configs:
        kind = c["kind"]
        if kind not in _CKPT_LAYER_PATHS:
            continue  # parameter-free layer
        keys = [tf_bundle.resolve_variable(
            nodes, f"layer_with_weights-{wi}/{p}")
            for p in _CKPT_LAYER_PATHS[kind]]
        # synthesize keras-convention group names so the h5 loader's
        # kind-by-kind prefix matching applies unchanged
        kname = _KERAS_NAME_PREFIX[kind]
        n = counts.get(kname, 0)
        counts[kname] = n + 1
        layer_keys.append((kname if n == 0 else f"{kname}_{n}", keys))
        wi += 1
    tensors = tf_bundle.read_tensors(
        prefix, [k for _, ks in layer_keys for k in ks],
        entries=entries)
    layers = [(name, [tensors[k] for k in keys])
              for name, keys in layer_keys]
    return configs, input_shape, layers


def read_legacy_h5_model(path: str):
    """Parse a legacy tf.keras WHOLE-MODEL ``.h5`` file (root attrs
    carry ``model_config`` JSON; weights live under the
    ``model_weights`` group) into ``(layer_configs, input_shape,
    h5_style_layers)``."""
    import json

    from learningorchestra_tpu_torch.models import tf_bundle

    h5py = _require("h5py", "reading a legacy keras .h5 model")
    with h5py.File(path, "r") as f:
        raw = f.attrs.get("model_config")
        if raw is None:
            raise ValueError(
                f"{path}: no model_config attr — not a whole-model "
                f"keras h5 file (weights-only files load via "
                f"load_weights)")
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8")
        cfg = tf_bundle._untuple(json.loads(raw))
    configs, input_shape = parse_sequential_config(cfg)
    layers = read_keras_h5(path, root_key="model_weights")
    return configs, input_shape, layers


def is_legacy_h5_model(path: str) -> bool:
    """True when ``path`` is an HDF5 file carrying a whole keras model
    (``model_config`` attr), as written by tf.keras ``model.save``."""
    import os

    if not (str(path).endswith((".h5", ".hdf5"))
            and os.path.isfile(path)):
        return False
    h5py = _require("h5py", "reading a keras .h5 file")
    try:
        with h5py.File(path, "r") as f:
            return "model_config" in f.attrs
    except OSError:
        return False


# ----------------------------------------------------------------------
# export TO real keras (.keras archive / live keras model)
# ----------------------------------------------------------------------
def build_keras_model(layer_configs, params, model_state,
                      input_shape):
    """Construct a REAL keras model mirroring the Sequential layer
    configs and copy this framework's weights into it (inverse of the
    h5 import's gate packing). Requires the ``keras`` package (any
    backend); raises ImportError otherwise. Keras then owns the
    serialization — ``.save(path)`` writes a loadable ``.keras``
    archive, so the export format can never drift from keras itself."""
    keras = _require("keras", "exporting to keras")
    kl = keras.layers

    if not input_shape:
        raise ValueError("input_shape is required to build the keras "
                         "twin (weights are shape-checked per layer)")

    def dense_like(cfg, cls, **kw):
        act = cfg.get("activation")
        return cls(activation=None if act in (None, "linear") else act,
                   **kw)

    built = [kl.Input(tuple(input_shape))]
    makers = []
    for i, cfg in enumerate(layer_configs):
        kind = cfg["kind"]
        name = f"{kind}_{i}"
        if kind == "dense":
            layer = dense_like(cfg, kl.Dense, units=cfg["units"])
        elif kind == "conv2d":
            layer = dense_like(
                cfg, kl.Conv2D, filters=cfg["filters"],
                kernel_size=tuple(cfg.get("kernel", (3, 3))),
                strides=tuple(cfg.get("strides", (1, 1))),
                padding=str(cfg.get("padding", "SAME")).lower())
        elif kind == "conv1d":
            k1 = cfg.get("kernel", 3)
            s1 = cfg.get("strides", 1)
            layer = dense_like(
                cfg, kl.Conv1D, filters=cfg["filters"],
                kernel_size=int(k1[0]) if isinstance(
                    k1, (list, tuple)) else int(k1),
                strides=int(s1[0]) if isinstance(
                    s1, (list, tuple)) else int(s1),
                padding=str(cfg.get("padding", "SAME")).lower())
        elif kind == "conv2d_transpose":
            layer = dense_like(
                cfg, kl.Conv2DTranspose, filters=cfg["filters"],
                kernel_size=tuple(cfg.get("kernel", (3, 3))),
                strides=tuple(cfg.get("strides", (1, 1))),
                padding=str(cfg.get("padding", "SAME")).lower())
        elif kind == "maxpool1d":
            layer = kl.MaxPooling1D(cfg.get("pool", 2),
                                    strides=cfg.get("strides"))
        elif kind == "maxpool2d":
            layer = kl.MaxPooling2D(tuple(cfg.get("pool", (2, 2))),
                                    strides=tuple(cfg.get(
                                        "strides", cfg.get("pool",
                                                           (2, 2)))))
        elif kind == "avgpool2d":
            layer = kl.AveragePooling2D(
                tuple(cfg.get("pool", (2, 2))),
                strides=tuple(cfg.get("strides",
                                      cfg.get("pool", (2, 2)))))
        elif kind == "globalavgpool2d":
            layer = kl.GlobalAveragePooling2D()
        elif kind == "globalavgpool1d":
            layer = kl.GlobalAveragePooling1D()
        elif kind == "globalmaxpool1d":
            layer = kl.GlobalMaxPooling1D()
        elif kind == "globalmaxpool2d":
            layer = kl.GlobalMaxPooling2D()
        elif kind == "flatten":
            layer = kl.Flatten()
        elif kind == "reshape":
            layer = kl.Reshape(tuple(cfg["shape"]))
        elif kind == "dropout":
            layer = kl.Dropout(cfg.get("rate", 0.5))
        elif kind == "batchnorm":
            layer = kl.BatchNormalization(
                momentum=cfg.get("momentum", 0.99),
                epsilon=cfg.get("epsilon", 1e-3))
        elif kind == "layernorm":
            layer = kl.LayerNormalization(
                epsilon=cfg.get("epsilon", 1e-6))
        elif kind == "embedding":
            layer = kl.Embedding(cfg.get("vocab", cfg.get("input_dim")),
                                 cfg.get("dim", cfg.get("output_dim")))
        elif kind == "lstm":
            layer = kl.LSTM(cfg["units"], return_sequences=cfg.get(
                "return_sequences", False))
        elif kind == "gru":
            layer = kl.GRU(cfg["units"], return_sequences=cfg.get(
                "return_sequences", False))
        elif kind in ("bidirectional_lstm", "bidirectional_gru"):
            inner = (kl.GRU if kind.endswith("gru") else kl.LSTM)(
                cfg["units"],
                return_sequences=cfg.get("return_sequences", False))
            layer = kl.Bidirectional(inner)
        elif kind == "simple_rnn":
            layer = kl.SimpleRNN(
                cfg["units"],
                activation=cfg.get("activation", "tanh"),
                return_sequences=cfg.get("return_sequences", False))
        elif kind == "activation":
            layer = kl.Activation(cfg.get("fn", "linear"))
        elif kind == "input":
            continue
        else:
            raise ValueError(
                f"layer kind {kind!r} has no keras export mapping")
        built.append(layer)
        makers.append((kind, name, layer))
    km = keras.Sequential(built)
    km.build((None, *input_shape))

    params = _copy_tree(params)
    state = _copy_tree(dict(model_state or {}))
    cell_pools = _recurrent_cell_pools(params)
    for kind, name, layer in makers:
        w = _export_layer_weights(kind, name, params, state,
                                  cell_pools)
        if w is not None:
            layer.set_weights(w)
    return km


def _export_layer_weights(kind, name, params, state, cell_pools):
    """keras set_weights list for one layer, or None if weight-free."""
    if kind == "lstm" and name in params:  # HoistedLSTM packed layout
        p = params[name]
        return [p["kernel"], p["recurrent_kernel"], p["bias"]]
    if kind in ("bidirectional_lstm", "bidirectional_gru"):
        base = kind.split("_", 1)[1]
        # our fwd cell was created first (lower scope index); keras
        # Bidirectional orders weights forward then backward
        fwd = _take_cell(params, cell_pools, base, f"{name}/forward")
        bwd = _take_cell(params, cell_pools, base, f"{name}/backward")
        return (_cell_keras_weights(base, fwd)
                + _cell_keras_weights(base, bwd))
    if kind in ("lstm", "gru", "simple_rnn"):
        cell = _take_cell(params, cell_pools, kind, name)
        return _cell_keras_weights(kind, cell)
    if name not in params and kind != "batchnorm":
        return None
    p = params.get(name, {})
    if kind in ("dense", "conv2d", "conv1d", "conv2d_transpose"):
        return [p["kernel"], p["bias"]]
    if kind == "embedding":
        return [p["embedding"]]
    if kind == "layernorm":
        return [p["scale"], p["bias"]]
    if kind == "batchnorm":
        bn = state.get("batch_stats", {}).get(name, {})
        return [p["scale"], p["bias"],
                bn.get("mean", np.zeros_like(p["bias"])),
                bn.get("var", np.ones_like(p["bias"]))]
    return None


def _cell_keras_weights(kind, cell):
    """[kernel, recurrent_kernel, bias] in keras packing for one
    recurrent cell's params."""
    if kind == "lstm":
        kern = np.concatenate(
            [cell[f"i{g}"]["kernel"] for g in _LSTM_GATES], axis=1)
        rec = np.concatenate(
            [cell[f"h{g}"]["kernel"] for g in _LSTM_GATES], axis=1)
        bias = np.concatenate(
            [cell[f"h{g}"]["bias"] for g in _LSTM_GATES])
        return [kern, rec, bias]
    if kind == "gru":
        order = (("z", "iz", "hz"), ("r", "ir", "hr"),
                 ("n", "in", "hn"))
        kern = np.concatenate([cell[ik]["kernel"]
                               for _, ik, _h in order], axis=1)
        rec = np.concatenate([cell[hk]["kernel"]
                              for _, _ik, hk in order], axis=1)
        u = rec.shape[0]
        # our i{z,r} bias holds keras's input+recurrent rows summed;
        # splitting as (input=ours, recurrent=0) is the same math.
        # n keeps separate rows (reset_after).
        b_in = np.concatenate([cell["iz"]["bias"],
                               cell["ir"]["bias"],
                               cell["in"]["bias"]])
        b_rec = np.concatenate([np.zeros(u, b_in.dtype),
                                np.zeros(u, b_in.dtype),
                                cell["hn"]["bias"]])
        return [kern, rec, np.stack([b_in, b_rec])]
    return [cell["i"]["kernel"], cell["h"]["kernel"],
            cell["i"]["bias"]]  # simple_rnn
