"""Typed artifact store of the PyTorch port.

The layout of the JAX package's store (``<root>/<service>/<tool>/<name>``
with a ``meta.json``) and its native protocol: an object with
``__lo_save__(dir)`` and a classmethod ``__lo_load__(dir, device)``. The
port's ``LanguageModel`` writes ``config.json`` and a ``torch.save``d
``state_dict``. Only classes of this package load; reading the JAX
package's flax-msgpack weights is not ported yet.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import shutil
from typing import Any, Optional

_PACKAGE = "learningorchestra_tpu_torch"
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._ -]*$")


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


class ArtifactStore:
    def __init__(self, root: str, device="cuda"):
        self._root = root
        self.device = device
        os.makedirs(root, exist_ok=True)

    def _dir(self, name: str, type_string: str) -> str:
        return os.path.join(self._root, _validate_type(type_string),
                            validate_safe_name(name))

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
        if not hasattr(obj, "__lo_save__"):
            raise TypeError(f"{type(obj).__name__} has no __lo_save__; the "
                            f"PyTorch store keeps native artifacts only")
        d = self._dir(name, type_string)
        if os.path.isdir(d):
            shutil.rmtree(d)
        payload_dir = os.path.join(d, "native")
        os.makedirs(payload_dir)
        obj.__lo_save__(payload_dir)
        meta = {"name": name, "type": type_string, "kind": "native",
                "module": type(obj).__module__,
                "class": type(obj).__qualname__}
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump(meta, f)
        return d

    def load(self, name: str, type_string: Optional[str] = None) -> Any:
        if type_string is None:
            type_string = self.find(name)
            if type_string is None:
                raise ArtifactNotFound(name)
        d = self._dir(name, type_string)
        meta_path = os.path.join(d, "meta.json")
        if not os.path.exists(meta_path):
            raise ArtifactNotFound(f"{type_string}/{name}")
        with open(meta_path) as f:
            meta = json.load(f)
        module_name = meta.get("module", "")
        if meta.get("kind") != "native" or not (
                module_name == _PACKAGE
                or module_name.startswith(_PACKAGE + ".")):
            raise ValueError(
                f"artifact {type_string}/{name} was not written by the "
                f"PyTorch package (kind {meta.get('kind')!r}, module "
                f"{module_name!r})")
        cls = importlib.import_module(module_name)
        for part in meta["class"].split("."):
            cls = getattr(cls, part)
        return cls.__lo_load__(os.path.join(d, "native"),
                               device=self.device)
