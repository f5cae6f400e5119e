"""Execution service: train, tune, evaluate and predict, as the JAX
package's ``services/execution.py`` runs them.

One executor calls method ``method`` of a stored object with
``methodParameters`` (``$`` references resolved). The POST body has
``name``, ``modelName`` (or ``parentName``), ``method``,
``methodParameters`` and ``description``. Validation walks the
``parentName`` chain to the root ``model/*`` document, whose class
defines the methods; train and tune store the mutated instance, evaluate
and predict the method's result, with a JSON view of it appended as a
``{"result": ...}`` document. A method that takes ``log_fn`` (``fit``)
streams each epoch's record into the job's documents. PATCH re-runs a
finished execution with new parameters.

``"checkpoint": true`` in a train execution's ``methodParameters``
checkpoints the fit after every epoch under
``<home>/checkpoints/<name>`` (:class:`~learningorchestra_tpu_torch.
runtime.checkpoint.Checkpointer`); a PATCH re-run of the same execution
resumes from its newest verified step, and DELETE removes the directory.
The commits' seconds go to the metadata as ``checkpointCommitSeconds``
(their sum, the JAX package's key) and ``checkpointCommits`` (each
commit's step, seconds and bytes), a resume's as ``checkpointRestores``
(step and seconds). A tune of a ``GridSearch``/``RandomSearch`` records
``sweepFusion`` (the sweep's ``fusion_info_``) and, where points
failed, ``trialErrors`` on its metadata; ``"checkpoint": true`` is
ignored there, as in the JAX package.

Refused with 406 before any document exists, because the port does not
run them yet: ``#`` expressions and the body fields ``timeout``,
``sliceDevices`` and ``healthPolicy``.
"""

from __future__ import annotations

import inspect
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np

from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.runtime.checkpoint import Checkpointer
from learningorchestra_tpu_torch.services import validators as V
from learningorchestra_tpu_torch.services.params import \
    refuse_hash_expressions

NAME_FIELD = "name"
MODEL_NAME_FIELD = "modelName"
PARENT_NAME_FIELD = "parentName"
DESCRIPTION_FIELD = "description"
METHOD_FIELD = "method"
METHOD_PARAMETERS_FIELD = "methodParameters"

# verbs whose result is the mutated parent instance
_INSTANCE_RESULT_PREFIXES = ("train/", "tune/")
# request fields of the JAX package's job lifecycle the port lacks
_UNPORTED_FIELDS = ("timeout", "sliceDevices", "healthPolicy")


def _refuse_unported(body: Dict[str, Any],
                     method_parameters: Dict[str, Any]) -> None:
    for field in _UNPORTED_FIELDS:
        if body.get(field) is not None:
            raise V.not_ported(f"the {field} field")
    refuse_hash_expressions(method_parameters)


class ExecutionService:
    def __init__(self, context):
        self._ctx = context
        self._validator = V.RequestValidator(context)

    # ------------------------------------------------------------------
    def root_model_metadata(self, name: str) -> Dict[str, Any]:
        """Follow the parentName chain to the ``model/*`` collection whose
        class defines the callable methods."""
        seen = set()
        meta = self._validator.existing(name)
        while not meta[D.TYPE_FIELD].startswith("model/"):
            parent = meta.get(D.PARENT_NAME_FIELD)
            if not parent or parent in seen:
                raise V.HttpError(V.HTTP_NOT_ACCEPTABLE,
                                  f"no model root in lineage of: {name}")
            seen.add(parent)
            meta = self._validator.existing(parent)
        return meta

    def _validate_method(self, root_meta: Dict[str, Any], method: str,
                         method_parameters: Dict[str, Any]) -> None:
        cls = self._validator.valid_class(
            root_meta[D.MODULE_PATH_FIELD], root_meta[D.CLASS_FIELD])
        self._validator.valid_method(cls, method)
        self._validator.valid_method_parameters(cls, method,
                                                method_parameters)

    # ------------------------------------------------------------------
    def create(self, body: Dict[str, Any], verb: str, tool: str,
               ) -> Tuple[int, Dict[str, Any]]:
        self._validator.required_fields(
            body, [NAME_FIELD, MODEL_NAME_FIELD, METHOD_FIELD,
                   METHOD_PARAMETERS_FIELD])
        name = self._validator.safe_name(body[NAME_FIELD])
        parent_name = body.get(PARENT_NAME_FIELD) or body[MODEL_NAME_FIELD]
        method = body[METHOD_FIELD]
        method_parameters = body[METHOD_PARAMETERS_FIELD] or {}
        description = body.get(DESCRIPTION_FIELD, "")
        _refuse_unported(body, method_parameters)
        self._validator.not_duplicate(name)
        self._validator.existing_finished(parent_name)
        root_meta = self.root_model_metadata(parent_name)
        self._validate_method(root_meta, method, method_parameters)
        type_string = D.normalize_type(f"{verb}/{tool}")
        self._ctx.catalog.create_collection(name, type_string, {
            D.PARENT_NAME_FIELD: parent_name,
            D.METHOD_FIELD: method,
            D.METHOD_PARAMETERS_FIELD: method_parameters,
            D.DESCRIPTION_FIELD: description,
        })
        self._submit(name, type_string, parent_name, method,
                     method_parameters, description)
        return V.HTTP_CREATED, {
            "result": f"/api/learningOrchestra/v1/{verb}/{tool}/{name}"}

    def update(self, name: str, body: Dict[str, Any], verb: str, tool: str,
               ) -> Tuple[int, Dict[str, Any]]:
        meta = self._validator.existing(name)
        method = meta[D.METHOD_FIELD]
        method_parameters = body.get(
            METHOD_PARAMETERS_FIELD, meta.get(D.METHOD_PARAMETERS_FIELD)) \
            or {}
        description = body.get(DESCRIPTION_FIELD, "")
        _refuse_unported(body, method_parameters)
        parent_name = meta[D.PARENT_NAME_FIELD]
        root_meta = self.root_model_metadata(parent_name)
        self._validate_method(root_meta, method, method_parameters)
        self._ctx.catalog.update_metadata(
            name, {D.METHOD_PARAMETERS_FIELD: method_parameters,
                   D.FINISHED_FIELD: False})
        self._submit(name, meta[D.TYPE_FIELD], parent_name, method,
                     method_parameters, description)
        return V.HTTP_SUCCESS, {
            "result": f"/api/learningOrchestra/v1/{verb}/{tool}/{name}"}

    def delete(self, name: str, verb: str, tool: str,
               ) -> Tuple[int, Dict[str, Any]]:
        meta = self._validator.existing(name)
        self._ctx.catalog.delete_collection(name)
        self._ctx.artifacts.delete(name, meta.get(D.TYPE_FIELD))
        # a stale checkpoint dir would make a later execution of this
        # name resume from the deleted run
        shutil.rmtree(checkpoint_dir_for(self._ctx, name),
                      ignore_errors=True)
        return V.HTTP_SUCCESS, {"result": f"deleted {name}"}

    # ------------------------------------------------------------------
    def _submit(self, name: str, type_string: str, parent_name: str,
                method: str, method_parameters: Dict[str, Any],
                description: str) -> None:
        def run():
            parent_type = self._ctx.params.artifact_type(parent_name)
            instance = self._ctx.artifacts.load(parent_name, parent_type)
            treated = self._ctx.params.treat(method_parameters)
            ckpt = _prepare_checkpointer(self._ctx, name, type_string,
                                         treated)
            _inject_epoch_log(self._ctx, name, instance, method, treated)
            try:
                result = getattr(instance, method)(**treated)
            finally:
                if ckpt is not None:
                    ckpt.close()
            if ckpt is not None and (ckpt.commits or ckpt.restores):
                self._ctx.catalog.update_metadata(name, {
                    "checkpointCommitSeconds": sum(
                        c["seconds"] for c in ckpt.commits),
                    "checkpointCommits": ckpt.commits,
                    "checkpointRestores": ckpt.restores})
            if type_string.startswith(_INSTANCE_RESULT_PREFIXES):
                result = instance  # the fitted object is the artifact
            self._ctx.artifacts.save(result, name, type_string)
            _record_sweep_fusion(self._ctx, name, result)
            summary = summarize_result(result)
            if summary is not None:
                self._ctx.catalog.append_document(name, {"result": summary})
            return result

        self._ctx.jobs.submit(name, run, description=description,
                              parameters=method_parameters, needs_card=True)


def _record_sweep_fusion(ctx, name: str, result: Any) -> None:
    """A finished sweep's ``fusion_info_`` as ``sweepFusion`` and its
    failed points' errors as ``trialErrors`` on the job's metadata."""
    updates: Dict[str, Any] = {}
    info = getattr(result, "fusion_info_", None)
    if info:
        updates["sweepFusion"] = dict(info)
    errors = (getattr(result, "cv_results_", None) or {}).get("error")
    if errors:
        updates["trialErrors"] = [e for e in errors if e]
    if updates:
        ctx.catalog.update_metadata(name, updates)


def checkpoint_dir_for(ctx, name: str) -> str:
    return os.path.join(ctx.config.checkpoints_dir, name)


def _prepare_checkpointer(ctx, name: str, type_string: str,
                          treated: Dict[str, Any]):
    """``"checkpoint": true`` in a train execution's parameters becomes
    a :class:`Checkpointer` under the execution's name, passed to the
    method as ``checkpointer``; the engine restores before training, so
    a PATCH re-run resumes. Train executions only: the trials of a tune
    would collide in one directory."""
    enabled = treated.pop("checkpoint", False)
    if not type_string.startswith("train/") or not enabled:
        return None
    ckpt = Checkpointer(checkpoint_dir_for(ctx, name))
    treated["checkpointer"] = ckpt
    return ckpt


def _inject_epoch_log(ctx, name: str, instance: Any, method: str,
                      treated: Dict[str, Any]) -> None:
    """Streams each epoch's record (loss, metrics, epoch, epochSeconds,
    samplesPerSecond) into the execution's documents as
    ``{"epochRecord": ...}`` when the method takes ``log_fn``: every
    epoch up to 512, then every 16th."""
    if "log_fn" in treated:
        return
    try:
        params = inspect.signature(getattr(instance, method)).parameters
    except (TypeError, ValueError):
        return
    if "log_fn" not in params:
        return
    seen = {"n": 0}

    def log_record(record: Dict[str, Any]) -> None:
        i = seen["n"]
        seen["n"] = i + 1
        if i >= 512 and i % 16 != 0:
            return
        try:
            ctx.catalog.append_document(name, {"epochRecord": record})
        except Exception:  # noqa: BLE001 — logging must never sink a fit
            pass

    treated["log_fn"] = log_record


def summarize_result(result: Any) -> Optional[Any]:
    """A JSON view of a result for the universal GET reader: lists and
    arrays past 1000 entries keep their first 1000."""
    if result is None or isinstance(result, (bool, int, float, str)):
        return result
    if isinstance(result, dict):
        return {str(k): summarize_result(v) for k, v in result.items()}
    if isinstance(result, (list, tuple)):
        return [summarize_result(v) for v in result[:1000]]
    if isinstance(result, np.ndarray):
        flat = result.tolist()
        return flat[:1000] if isinstance(flat, list) else flat
    if hasattr(result, "history") and isinstance(
            getattr(result, "history"), (dict, list)):
        return summarize_result(result.history)
    return None
