"""Typed artifact store of the PyTorch port.

The layout of the JAX package's store (``<root>/<service>/<tool>/<name>``
with a ``meta.json``) and its native protocol: an object with
``__lo_save__(dir)`` and a classmethod ``__lo_load__(dir, device)``. The
port's ``LanguageModel``, ``TextClassifier``, ``NeuralModel`` and
sweeps write what the JAX package's write: ``config.json`` and
``weights.msgpack``, the flax tree as ``flax.serialization`` packs it
(through the port's own codec; a sweep nests its estimators' dirs). So
a native artifact of either package loads in the other: the JAX
package's ``LanguageModel``, ``TextClassifier``, ``NeuralModel``, the
tensorflow shim's ``Sequential``, ``GridSearch`` and ``RandomSearch`` map
by name to the port's classes (:data:`JAX_NATIVE_CLASSES`); any other
JAX class raises "not yet ported".

Results of evaluate, predict and generate, and a function's
``response``, are stored without pickle where they can be:

- a numpy array is ``value.npy`` (kind ``array``);
- a dict, list or tuple of JSON scalars and arrays is ``value.json``
  with each array leaf in its own ``.npy`` (kind ``json``; tuples come
  back as lists, numpy scalars as Python numbers);
- a ``History`` is its lists (kind ``history``).

Raw bytes (an explore plot's PNG, a ``dataset/generic`` download) are
kept as they came, with a file name and a content type
(:meth:`ArtifactStore.save_bytes`, kind ``bytes``; ``load`` returns the
bytes).

Any other object (a fitted sklearn estimator, a DataFrame, a function's
tuple of live objects: what the JAX package stores with ``dill``) is
``object.pkl``, written by the standard ``pickle`` (kind ``pickle``); an
object pickle cannot write raises ``TypeError``. A JAX ``dill`` artifact
is read with the standard unpickler and dill's array reducer: what dill
wrote as plain pickle and arrays (sklearn estimators, dicts of arrays)
loads without dill, and anything else (a function dill pickled by
value) raises, where dill is absent, an error that names dill. A JAX
``LogisticRegressionJAX`` or ``GaussianNBJAX`` loads as the port's
class of that name (:data:`JAX_PICKLED_CLASSES`), placed on the store's
device, and a spec of the JAX tensorflow shim (a layer, optimizer or
loss, which its store writes with dill) as the port's shim class of the
same name.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_PACKAGE = "learningorchestra_tpu_torch"
# native classes of the JAX package that the port loads, each to the
# port's (module, class); the JAX module is never imported
JAX_NATIVE_CLASSES = {
    ("learningorchestra_tpu.models.transformer", "LanguageModel"):
        ("learningorchestra_tpu_torch.models.transformer", "LanguageModel"),
    ("learningorchestra_tpu.models.transformer", "TextClassifier"):
        ("learningorchestra_tpu_torch.models.encoder", "TextClassifier"),
    ("learningorchestra_tpu.models.neural", "NeuralModel"):
        ("learningorchestra_tpu_torch.models.neural", "NeuralModel"),
    ("learningorchestra_tpu.models.tf_compat.keras.models", "Sequential"):
        ("learningorchestra_tpu_torch.models.tf_compat.keras.models",
         "Sequential"),
    ("learningorchestra_tpu.models.sweep", "GridSearch"):
        ("learningorchestra_tpu_torch.models.sweep", "GridSearch"),
    ("learningorchestra_tpu.models.sweep", "RandomSearch"):
        ("learningorchestra_tpu_torch.models.sweep", "RandomSearch"),
}
# the JAX package's pickled estimators (its store writes them with dill),
# each read as the port's class of the same name
JAX_PICKLED_CLASSES = {
    ("learningorchestra_tpu.models.estimators", name):
        ("learningorchestra_tpu_torch.models.estimators", name)
    for name in ("LogisticRegressionJAX", "GaussianNBJAX")}
_JAX_PACKAGE = "learningorchestra_tpu"
# the JAX tensorflow shim's modules, each to the port's module of the
# same path (a dill artifact names its spec classes there)
_JAX_SHIM, _PORT_SHIM = ("learningorchestra_tpu.models.tf_compat",
                         "learningorchestra_tpu_torch.models.tf_compat")
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._ -]*$")
# the JSON stand-in for an array leaf of a stored result
_LEAF_KEY = "__npy__"


class ArtifactNotFound(Exception):
    pass


def _is_safe_name(name: Any) -> bool:
    return (isinstance(name, str) and bool(_NAME_RE.match(name))
            and ".." not in name and "/" not in name and "\\" not in name)


def validate_safe_name(name: str) -> str:
    """Reject path traversal in artifact names (they arrive from the
    REST API)."""
    if not _is_safe_name(name):
        raise ValueError(f"invalid artifact name: {name!r}")
    return name


def _validate_type(type_string: str) -> str:
    parts = type_string.split("/")
    if len(parts) != 2 or not all(_NAME_RE.match(p) for p in parts):
        raise ValueError(f"invalid artifact type: {type_string!r}")
    return type_string


def _check_array(value: np.ndarray) -> np.ndarray:
    if value.dtype.hasobject:
        raise TypeError("cannot store an object array without pickle")
    return value


def _to_json(value: Any, d: str, leaves: List[int]) -> Any:
    """``value`` as JSON, each array leaf saved beside it as a .npy."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, np.generic) and value.dtype.kind in "biuf":
        return value.item()
    if isinstance(value, np.ndarray):
        leaf = f"leaf{len(leaves)}.npy"
        leaves.append(len(leaves))
        np.save(os.path.join(d, leaf), _check_array(value),
                allow_pickle=False)
        return {_LEAF_KEY: leaf}
    if isinstance(value, (list, tuple)):
        return [_to_json(v, d, leaves) for v in value]
    if isinstance(value, dict):
        if not all(isinstance(k, str) for k in value) or _LEAF_KEY in value:
            raise TypeError(f"a stored dict needs str keys other than "
                            f"{_LEAF_KEY!r}")
        return {k: _to_json(v, d, leaves) for k, v in value.items()}
    raise TypeError(f"cannot store a {type(value).__name__} (the PyTorch "
                    f"store keeps native artifacts, numpy arrays and JSON "
                    f"values of them)")


def _from_json(value: Any, d: str) -> Any:
    if isinstance(value, list):
        return [_from_json(v, d) for v in value]
    if isinstance(value, dict):
        if set(value) == {_LEAF_KEY}:
            return np.load(os.path.join(d, value[_LEAF_KEY]),
                           allow_pickle=False)
        return {k: _from_json(v, d) for k, v in value.items()}
    return value


def _save_pickle(obj: Any, d: str) -> None:
    """``obj`` as ``object.pkl``; what pickle cannot write (a lambda, a
    lock) raises TypeError, as the other kinds do. The ``.npy`` leaves a
    failed JSON attempt left behind go."""
    for leaf in os.listdir(d):
        os.remove(os.path.join(d, leaf))
    try:
        data = pickle.dumps(obj)
    except (pickle.PicklingError, TypeError, AttributeError) as e:
        raise TypeError(f"cannot store a {type(obj).__name__}: {e}") \
            from None
    with open(os.path.join(d, "object.pkl"), "wb") as f:
        f.write(data)


def _dill_create_array(f, args, state, npdict=None):
    """dill's reducer of a numpy array (``dill._dill._create_array``):
    the array numpy's own reducer builds, with its state set."""
    array = f(*args)
    array.__setstate__(state)
    if npdict is not None:
        array.__dict__.update(npdict)
    return array


class _DillUnpickler(pickle.Unpickler):
    """The standard unpickler, plus dill's array reducer: dill writes
    every numpy array through it, so the arrays of an sklearn estimator
    or of a dict load without dill. The JAX package's estimators map to
    the port's classes (:data:`JAX_PICKLED_CLASSES`), which take the
    JAX attributes in ``__setstate__``."""

    def find_class(self, module: str, name: str):
        if (module, name) == ("dill._dill", "_create_array"):
            return _dill_create_array
        mapped = JAX_PICKLED_CLASSES.get((module, name))
        if mapped is not None:
            return getattr(importlib.import_module(mapped[0]), mapped[1])
        if module == _JAX_SHIM or module.startswith(_JAX_SHIM + "."):
            cls = getattr(importlib.import_module(
                _PORT_SHIM + module[len(_JAX_SHIM):]), name, None)
            if isinstance(cls, type):
                return cls
        return super().find_class(module, name)


def _load_dill(path: str, label: str) -> Any:
    """A JAX ``dill`` artifact, read with the standard pickle."""
    try:
        with open(path, "rb") as f:
            return _DillUnpickler(f).load()
    except Exception as e:  # noqa: BLE001 — say which format failed
        raise ValueError(
            f"artifact {label} was written by dill in a form the standard "
            f"pickle cannot read ({type(e).__name__}: {e}); dill is not a "
            f"dependency of the PyTorch package") from None


def _is_history(obj: Any) -> bool:
    from learningorchestra_tpu_torch.models.neural import History

    return isinstance(obj, History)


class ArtifactStore:
    def __init__(self, root: str, device="cuda"):
        self._root = root
        self.device = device
        os.makedirs(root, exist_ok=True)

    def _dir(self, name: str, type_string: str) -> str:
        return os.path.join(self._root, _validate_type(type_string),
                            validate_safe_name(name))

    def exists(self, name: str, type_string: str) -> bool:
        return os.path.exists(
            os.path.join(self._dir(name, type_string), "meta.json"))

    def find(self, name: str) -> Optional[str]:
        """The type string of artifact ``name``, or None."""
        if not _is_safe_name(name):
            return None
        for service_dir in sorted(os.listdir(self._root)):
            service_path = os.path.join(self._root, service_dir)
            if not os.path.isdir(service_path):
                continue
            for tool_dir in sorted(os.listdir(service_path)):
                candidate = os.path.join(service_path, tool_dir, name)
                if os.path.exists(os.path.join(candidate, "meta.json")):
                    return f"{service_dir}/{tool_dir}"
        return None

    def save(self, obj: Any, name: str, type_string: str) -> str:
        d = self._dir(name, type_string)
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.makedirs(d)
        meta: Dict[str, Any] = {"name": name, "type": type_string}
        try:
            if hasattr(obj, "__lo_save__"):
                payload_dir = os.path.join(d, "native")
                os.makedirs(payload_dir)
                obj.__lo_save__(payload_dir)
                meta.update(kind="native", module=type(obj).__module__,
                            **{"class": type(obj).__qualname__})
            elif isinstance(obj, np.ndarray) and not obj.dtype.hasobject:
                np.save(os.path.join(d, "value.npy"), _check_array(obj),
                        allow_pickle=False)
                meta["kind"] = "array"
            elif _is_history(obj):
                with open(os.path.join(d, "value.json"), "w") as f:
                    json.dump(_to_json(obj.history, d, []), f)
                meta["kind"] = "history"
            else:
                try:
                    value = _to_json(obj, d, [])
                except TypeError:
                    _save_pickle(obj, d)
                    meta["kind"] = "pickle"
                else:
                    with open(os.path.join(d, "value.json"), "w") as f:
                        json.dump(value, f)
                    meta["kind"] = "json"
        except BaseException:
            shutil.rmtree(d, ignore_errors=True)
            raise
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump(meta, f)
        return d

    def save_bytes(self, data: bytes, name: str, type_string: str,
                   filename: str = "payload.bin",
                   content_type: str = "application/octet-stream") -> str:
        """Stores raw bytes as ``filename``; the file's path."""
        d = self._dir(name, type_string)
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.makedirs(d)
        filename = os.path.basename(filename) or "payload.bin"
        with open(os.path.join(d, filename), "wb") as f:
            f.write(data)
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump({"name": name, "type": type_string, "kind": "bytes",
                       "filename": filename,
                       "content_type": content_type}, f)
        return os.path.join(d, filename)

    def bytes_path(self, name: str, type_string: str) -> Tuple[str, str]:
        """``(path, content type)`` of a bytes artifact."""
        d, _, meta = self._meta(name, type_string)
        if meta.get("kind") != "bytes":
            raise ValueError(f"artifact {name} is not a bytes artifact")
        return os.path.join(d, meta["filename"]), meta.get(
            "content_type", "application/octet-stream")

    def _meta(self, name: str, type_string: Optional[str]):
        if type_string is None:
            type_string = self.find(name)
            if type_string is None:
                raise ArtifactNotFound(name)
        d = self._dir(name, type_string)
        meta_path = os.path.join(d, "meta.json")
        if not os.path.exists(meta_path):
            raise ArtifactNotFound(f"{type_string}/{name}")
        with open(meta_path) as f:
            return d, type_string, json.load(f)

    @staticmethod
    def _native_class(meta: Dict[str, Any], label: str):
        module_name = meta.get("module", "")
        class_name = meta.get("class", "")
        mapped = JAX_NATIVE_CLASSES.get((module_name, class_name))
        if mapped is not None:
            module_name, class_name = mapped
        elif module_name == _JAX_PACKAGE or \
                module_name.startswith(_JAX_PACKAGE + "."):
            raise ValueError(
                f"artifact {label}: class {module_name}.{class_name} of the "
                f"JAX package is not yet ported to the PyTorch package")
        if not (module_name == _PACKAGE
                or module_name.startswith(_PACKAGE + ".")):
            raise ValueError(
                f"artifact {label} was not written by the PyTorch package "
                f"(kind {meta.get('kind')!r}, module {module_name!r})")
        cls = importlib.import_module(module_name)
        for part in class_name.split("."):
            cls = getattr(cls, part)
        return cls

    def stored_class(self, name: str, type_string: str):
        """The class of a stored native artifact, from its meta.json
        without loading the weights; None for a stored value."""
        _, type_string, meta = self._meta(name, type_string)
        if meta.get("kind") != "native":
            return None
        return self._native_class(meta, f"{type_string}/{name}")

    def load(self, name: str, type_string: Optional[str] = None) -> Any:
        d, type_string, meta = self._meta(name, type_string)
        kind = meta.get("kind")
        if kind == "native":
            cls = self._native_class(meta, f"{type_string}/{name}")
            return cls.__lo_load__(os.path.join(d, "native"),
                                   device=self.device)
        if kind == "array":
            return np.load(os.path.join(d, "value.npy"), allow_pickle=False)
        if kind in ("json", "history"):
            with open(os.path.join(d, "value.json")) as f:
                value = _from_json(json.load(f), d)
            if kind == "json":
                return value
            from learningorchestra_tpu_torch.models.neural import History

            history = History([])
            history.history = value
            return history
        if kind == "pickle":
            with open(os.path.join(d, "object.pkl"), "rb") as f:
                return pickle.load(f)
        if kind == "dill":
            value = _load_dill(os.path.join(d, "object.dill"),
                               f"{type_string}/{name}")
            if hasattr(value, "set_device") and \
                    getattr(value, "device", 0) is None:
                value.set_device(self.device)  # a JAX estimator
            return value
        if kind == "bytes":
            with open(os.path.join(d, meta["filename"]), "rb") as f:
                return f.read()
        raise ValueError(
            f"artifact {type_string}/{name} was not written by the PyTorch "
            f"package (kind {kind!r})")

    def delete(self, name: str, type_string: Optional[str] = None) -> bool:
        if type_string is None:
            type_string = self.find(name)
            if type_string is None:
                return False
        d = self._dir(name, type_string)
        if os.path.isdir(d):
            shutil.rmtree(d)
            return True
        return False

    def list(self, type_string: Optional[str] = None) -> List[str]:
        """Names of one type's artifacts, or ``service/tool/name`` of
        every artifact."""
        if type_string is not None:
            d = os.path.join(self._root, _validate_type(type_string))
            if not os.path.isdir(d):
                return []
            return sorted(n for n in os.listdir(d) if os.path.exists(
                os.path.join(d, n, "meta.json")))
        out = []
        for service_dir in sorted(os.listdir(self._root)):
            sp = os.path.join(self._root, service_dir)
            if not os.path.isdir(sp):
                continue
            for tool_dir in sorted(os.listdir(sp)):
                if os.path.isdir(os.path.join(sp, tool_dir)):
                    out.extend(f"{service_dir}/{tool_dir}/{n}" for n in
                               self.list(f"{service_dir}/{tool_dir}"))
        return out
