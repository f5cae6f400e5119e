"""The ``$`` parameter DSL of the JAX package's ``services/params.py``.

- ``"$name"`` loads artifact ``name``: a tabular collection becomes a
  :class:`~learningorchestra_tpu_torch.catalog.store.Table` (the JAX
  package gives a pandas DataFrame), an object type the stored object.
- ``"$name.key"`` loads the object and indexes it: ``object["key"]``.
- Lists resolve element by element.

As in the reference, any string that contains ``$`` is a reference.
The ``#`` expressions need the sandbox, which is not ported: the model
and execution services refuse them before a job is submitted
(:func:`refuse_hash_expressions`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from learningorchestra_tpu_torch.services import validators as V

# types whose "$name" is the stored object rather than the rows
_OBJECT_TYPE_PREFIXES = ("model/", "tune/", "train/", "evaluate/",
                         "predict/")
_OBJECT_TYPES = ("function/python", "transform/scikitlearn",
                 "transform/tensorflow", "transform/jax")


def is_object_type(type_string: str) -> bool:
    return (type_string.startswith(_OBJECT_TYPE_PREFIXES)
            or type_string in _OBJECT_TYPES)


def _is_hash(value: Any) -> bool:
    # '$' takes precedence over '#', as in resolve_value
    return isinstance(value, str) and "$" not in value and "#" in value


def refuse_hash_expressions(parameters: Optional[Dict[str, Any]]) -> None:
    """406 for a ``#`` expression among ``parameters`` (or in one of
    their lists)."""
    for name, value in (parameters or {}).items():
        values = value if isinstance(value, list) else [value]
        if any(_is_hash(v) for v in values):
            raise V.not_ported(f"the '#' expression of {name!r}")


class ParameterResolver:
    def __init__(self, context: "ServiceContext"):  # noqa: F821
        self._ctx = context

    def treat(self, method_parameters: Optional[Dict[str, Any]],
              ) -> Dict[str, Any]:
        """The parameters with every ``$`` reference resolved."""
        if not method_parameters:
            return {}
        return {name: [self.resolve_value(v) for v in value]
                if isinstance(value, list) else self.resolve_value(value)
                for name, value in method_parameters.items()}

    def resolve_value(self, value: Any) -> Any:
        if not isinstance(value, str) or "$" not in value:
            return value
        ref = value.replace("$", "")
        if "." in ref:
            artifact_name, key = ref.split(".", 1)
            return self.load_object(artifact_name)[key]
        return self.load_artifact(ref)

    def artifact_type(self, name: str) -> Optional[str]:
        """The type string of ``name`` in the catalog, else in the
        artifact store, else None."""
        return self._ctx.catalog.get_type(name) or \
            self._ctx.artifacts.find(name)

    def load_artifact(self, name: str) -> Any:
        """``$name``: the stored object of an object type, else the
        collection's rows as a Table."""
        t = self.artifact_type(name)
        if t is None:
            raise KeyError(f"unknown artifact: {name}")
        if is_object_type(t):
            return self._ctx.artifacts.load(name, t)
        return self._ctx.catalog.read_table(name)

    def load_object(self, name: str) -> Any:
        """The stored object of ``name`` (``$name.key`` indexes it)."""
        t = self.artifact_type(name)
        if t is None:
            raise KeyError(f"unknown artifact: {name}")
        return self._ctx.artifacts.load(name, t)
