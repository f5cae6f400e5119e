"""Model service: instantiate a class of the port and store the instance
as the root of every later train, evaluate and predict lineage, as the
JAX package's ``services/model_service.py`` does.

``POST /model/{tool}`` with ``modelName``, ``modulePath``, ``class``,
``classParameters`` (and ``description``) is validated on the request
thread; a job then resolves the ``$`` parameters and builds the
instance on the context's device (``device=ctx.device`` for a class
that takes a device, as the port's models do and the JAX ones do not).
``PATCH`` rebuilds it with new ``classParameters``. An unknown
``scoring`` of a ``GridSearch``/``RandomSearch`` answers 406 before any
document exists (in the JAX package's words). ``modulePath`` may name any importable module
(``sklearn.linear_model``, whose classes run their own methods on the
host and hold no card), as in the JAX package, and the reference's
``tensorflow.keras.*`` paths, which are the port's shim
(``tensorflow.keras.models``' ``Sequential`` of ``#`` layer specs and
``load_model`` of a real keras artifact,
``tensorflow.keras.applications``' ``ResNet50``). With ``LO_PREFLIGHT``
(on by default) create and PATCH run the preflight
(:func:`~learningorchestra_tpu_torch.analysis.preflight.check_model`):
``#`` expressions among the ``classParameters`` are linted, and a
``NeuralModel`` whose ``input`` layer declares its shape is built on the
meta device; a provable failure is a 406 with the findings under
``analysis`` and leaves no document, and warnings are kept as
``analysis`` on the metadata. The job evaluates ``#`` expressions in the
sandbox.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Tuple

from learningorchestra_tpu_torch import analysis as A
from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.services import validators as V

MODEL_NAME_FIELD = "modelName"
DESCRIPTION_FIELD = "description"
MODULE_PATH_FIELD = "modulePath"
CLASS_FIELD = "class"
CLASS_PARAMETERS_FIELD = "classParameters"

def _valid_sweep_scoring(cls, class_parameters: Dict[str, Any]) -> None:
    """Submit-time 406 for an unknown sweep ``scoring`` metric."""
    from learningorchestra_tpu_torch.models.sweep import GridSearch

    if isinstance(cls, type) and issubclass(cls, GridSearch):
        V.valid_scoring(class_parameters.get(V.SCORING_FIELD))


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
        analysis = self._preflight(module_path, class_name,
                                   class_parameters)
        type_string = D.normalize_type(f"model/{tool}")
        extra = {
            D.MODULE_PATH_FIELD: module_path,
            D.CLASS_FIELD: class_name,
            D.CLASS_PARAMETERS_FIELD: class_parameters,
            D.DESCRIPTION_FIELD: description,
        }
        if analysis:
            extra[V.ANALYSIS_FIELD] = analysis
        self._ctx.catalog.create_collection(name, type_string, extra)
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
        analysis = self._preflight(meta[D.MODULE_PATH_FIELD],
                                   meta[D.CLASS_FIELD], class_parameters)
        self._ctx.catalog.update_metadata(
            name, {D.CLASS_PARAMETERS_FIELD: class_parameters,
                   V.ANALYSIS_FIELD: analysis,
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

    def _preflight(self, module_path, class_name, class_parameters) -> list:
        """The preflight of a spec (406 on a provable failure); returns
        the advisory findings to store on the document."""
        if not self._ctx.config.preflight:
            return []
        findings = A.check_model(module_path, class_name,
                                 class_parameters,
                                 mode=self._ctx.config.sandbox_mode)
        return V.run_preflight(findings)

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
            needs_card=type_string.endswith(("/tensorflow", "/jax")),
            pool=type_string.split("/", 1)[0])
