"""Model service: instantiate a class of the port and store the instance
as the root of every later train, evaluate and predict lineage, as the
JAX package's ``services/model_service.py`` does.

``POST /model/{tool}`` with ``modelName``, ``modulePath``, ``class``,
``classParameters`` (and ``description``) is validated on the request
thread; a job then resolves the ``$`` parameters and builds the
instance on the context's device (``device=ctx.device`` for a class
that takes a device, as the port's models do and the JAX ones do not).
``PATCH`` rebuilds it with new ``classParameters``. Constructor options
the JAX models take and the port does not run yet (ring and Ulysses
attention) answer 406 "not yet ported" before any document exists, as
does an unknown ``scoring`` of a ``GridSearch``/``RandomSearch`` (in
the JAX package's words). The JAX package's preflight analysis is not
ported, so the metadata carries no ``analysis`` field.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Tuple

from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.services import validators as V
from learningorchestra_tpu_torch.services.params import \
    refuse_hash_expressions

MODEL_NAME_FIELD = "modelName"
DESCRIPTION_FIELD = "description"
MODULE_PATH_FIELD = "modulePath"
CLASS_FIELD = "class"
CLASS_PARAMETERS_FIELD = "classParameters"

# constructor options of the JAX package's models that the port does not
# run yet: class -> (keyword, refused value, what the 406 names)
_UNPORTED_OPTIONS = {
    "LanguageModel": (
        ("attention", lambda v: v in ("ring", "ulysses"),
         "ring and Ulysses attention"),),
}


def _valid_sweep_scoring(cls, class_parameters: Dict[str, Any]) -> None:
    """Submit-time 406 for an unknown sweep ``scoring`` metric."""
    from learningorchestra_tpu_torch.models.sweep import GridSearch

    if isinstance(cls, type) and issubclass(cls, GridSearch):
        V.valid_scoring(class_parameters.get(V.SCORING_FIELD))


def _refuse_unported_options(cls, parameters: Dict[str, Any]) -> None:
    for key, refused, what in _UNPORTED_OPTIONS.get(
            getattr(cls, "__name__", ""), ()):
        value = parameters.get(key)
        if isinstance(value, str) and value.startswith("$"):
            continue  # resolved in the job
        if key in parameters and refused(value):
            raise V.not_ported(what)


class ModelService:
    def __init__(self, context):
        self._ctx = context
        self._validator = V.RequestValidator(context)

    def create(self, body: Dict[str, Any], tool: str,
               ) -> Tuple[int, Dict[str, Any]]:
        self._validator.required_fields(
            body, [MODEL_NAME_FIELD, MODULE_PATH_FIELD, CLASS_FIELD,
                   CLASS_PARAMETERS_FIELD])
        name = self._validator.safe_name(body[MODEL_NAME_FIELD])
        module_path = body[MODULE_PATH_FIELD]
        class_name = body[CLASS_FIELD]
        class_parameters = body[CLASS_PARAMETERS_FIELD] or {}
        description = body.get(DESCRIPTION_FIELD, "")
        self._validator.not_duplicate(name)
        cls = self._validator.valid_class(module_path, class_name)
        self._validator.valid_class_parameters(cls, class_parameters)
        _valid_sweep_scoring(cls, class_parameters)
        refuse_hash_expressions(class_parameters)
        _refuse_unported_options(cls, class_parameters)
        type_string = D.normalize_type(f"model/{tool}")
        self._ctx.catalog.create_collection(name, type_string, {
            D.MODULE_PATH_FIELD: module_path,
            D.CLASS_FIELD: class_name,
            D.CLASS_PARAMETERS_FIELD: class_parameters,
            D.DESCRIPTION_FIELD: description,
        })
        self._submit(name, type_string, cls, class_parameters, description)
        return V.HTTP_CREATED, {
            "result": f"/api/learningOrchestra/v1/model/{tool}/{name}"}

    def update(self, name: str, body: Dict[str, Any], tool: str,
               ) -> Tuple[int, Dict[str, Any]]:
        meta = self._validator.existing(name)
        class_parameters = body.get(
            CLASS_PARAMETERS_FIELD, meta.get(D.CLASS_PARAMETERS_FIELD)) or {}
        description = body.get(DESCRIPTION_FIELD, "")
        cls = self._validator.valid_class(
            meta[D.MODULE_PATH_FIELD], meta[D.CLASS_FIELD])
        self._validator.valid_class_parameters(cls, class_parameters)
        _valid_sweep_scoring(cls, class_parameters)
        refuse_hash_expressions(class_parameters)
        _refuse_unported_options(cls, class_parameters)
        self._ctx.catalog.update_metadata(
            name, {D.CLASS_PARAMETERS_FIELD: class_parameters,
                   D.FINISHED_FIELD: False})
        self._submit(name, meta[D.TYPE_FIELD], cls, class_parameters,
                     description)
        return V.HTTP_SUCCESS, {
            "result": f"/api/learningOrchestra/v1/model/{tool}/{name}"}

    def delete(self, name: str, tool: str) -> Tuple[int, Dict[str, Any]]:
        meta = self._validator.existing(name)
        self._ctx.catalog.delete_collection(name)
        self._ctx.artifacts.delete(name, meta.get(D.TYPE_FIELD))
        return V.HTTP_SUCCESS, {"result": f"deleted model {name}"}

    def _submit(self, name: str, type_string: str, cls,
                class_parameters: Dict[str, Any], description: str) -> None:
        try:
            takes_device = "device" in inspect.signature(cls).parameters
        except (TypeError, ValueError):
            takes_device = False

        def run():
            treated = self._ctx.params.treat(class_parameters)
            if takes_device:
                treated["device"] = self._ctx.device
            instance = cls(**treated)
            self._ctx.artifacts.save(instance, name, type_string)
            return instance

        self._ctx.jobs.submit(
            name, run, description=description, parameters=class_parameters,
            needs_card=type_string.endswith(("/tensorflow", "/jax")))
