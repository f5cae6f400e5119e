"""The ``$`` / ``#`` parameter DSL of the JAX package's
``services/params.py``.

- ``"$name"`` loads artifact ``name``: a tabular collection becomes a
  :class:`~learningorchestra_tpu_torch.catalog.store.Table` (the JAX
  package gives a pandas DataFrame; the function route hands user code a
  DataFrame where pandas is importable, ``services/function_service.py``),
  an object type the stored object.
- ``"$name.key"`` loads the object and indexes it: ``object["key"]``.
- ``"#expr"`` evaluates a Python expression in the sandbox
  (``Config.sandbox_mode``), where ``tensorflow`` is the port's shim
  (``#tensorflow.keras.layers.Dense(16)``), and passes the value on; all
  of a request's ``#`` expressions, those of lists included, run in one
  sandbox pass.
- Lists resolve element by element.

As in the reference, any string that contains ``$`` is a reference, and
any other string that contains ``#`` is code: ``$`` takes precedence.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from learningorchestra_tpu_torch.services import sandbox

# types whose "$name" is the stored object rather than the rows
_OBJECT_TYPE_PREFIXES = ("model/", "tune/", "train/", "evaluate/",
                         "predict/")
_OBJECT_TYPES = ("function/python", "transform/scikitlearn",
                 "transform/tensorflow", "transform/jax")


def is_object_type(type_string: str) -> bool:
    return (type_string.startswith(_OBJECT_TYPE_PREFIXES)
            or type_string in _OBJECT_TYPES)


def is_hash(value: Any) -> bool:
    # '$' takes precedence over '#', as in resolve_value
    return isinstance(value, str) and "$" not in value and "#" in value


class ParameterResolver:
    def __init__(self, context: "ServiceContext"):  # noqa: F821
        self._ctx = context

    def treat(self, method_parameters: Optional[Dict[str, Any]],
              ) -> Dict[str, Any]:
        """The parameters with every ``$`` reference and ``#``
        expression resolved; the ``#`` expressions, in the order of the
        parameters and their lists, go to the sandbox in one batch."""
        if not method_parameters:
            return {}
        exprs = []
        for value in method_parameters.values():
            values = value if isinstance(value, list) else [value]
            exprs.extend(v for v in values if is_hash(v))
        config = self._ctx.config
        results = iter(sandbox.eval_hash_expressions(
            exprs, mode=config.sandbox_mode, config=config))

        def resolve(v):
            return next(results) if is_hash(v) else self.resolve_value(v)

        return {name: [resolve(v) for v in value]
                if isinstance(value, list) else resolve(value)
                for name, value in method_parameters.items()}

    def resolve_value(self, value: Any) -> Any:
        if not isinstance(value, str):
            return value
        if "$" in value:
            ref = value.replace("$", "")
            if "." in ref:
                artifact_name, key = ref.split(".", 1)
                return self.load_object(artifact_name)[key]
            return self.load_artifact(ref)
        if "#" in value:
            config = self._ctx.config
            return sandbox.eval_hash_expression(
                value, mode=config.sandbox_mode, config=config)
        return value

    def artifact_type(self, name: str) -> Optional[str]:
        """The type string of ``name`` in the catalog, else in the
        artifact store, else None."""
        return self._ctx.catalog.get_type(name) or \
            self._ctx.artifacts.find(name)

    def load_artifact(self, name: str) -> Any:
        """``$name``: the stored object of an object type, else the
        collection's rows as a Table, read through the feature cache's
        host tier (so a pipeline's train, evaluate and predict steps and
        the builder share one read); the caller gets its own Table."""
        t = self.artifact_type(name)
        if t is None:
            raise KeyError(f"unknown artifact: {name}")
        if is_object_type(t):
            return self._ctx.artifacts.load(name, t)
        return self._ctx.features.table(name)

    def load_object(self, name: str) -> Any:
        """The stored object of ``name`` (``$name.key`` indexes it)."""
        t = self.artifact_type(name)
        if t is None:
            raise KeyError(f"unknown artifact: {name}")
        return self._ctx.artifacts.load(name, t)
