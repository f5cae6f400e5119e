"""Execution service: train, tune, evaluate and predict, as the JAX
package's ``services/execution.py`` runs them.

One executor calls method ``method`` of a stored object with
``methodParameters`` (``$`` references resolved). The POST body has
``name``, ``modelName`` (or ``parentName``), ``method``,
``methodParameters`` and ``description``. Validation walks the
``parentName`` chain to the root ``model/*`` document, whose class
defines the methods (for a root a factory made, such as the tensorflow
shim's ``load_model`` or ``ResNet50``, the stored instance's class, read
from the artifact's ``meta.json``); train and tune store the mutated
instance, evaluate
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
(step and seconds). With ``LO_CKPT_ASYNC=1`` the checkpointer is wrapped
(:func:`~learningorchestra_tpu_torch.runtime.async_ckpt.wrap_checkpointer`):
commits run on a background worker, the training thread's stall per
save is recorded as ``checkpointSnapshots`` (and their sum
``checkpointSnapshotSeconds``), and a failed commit fails the job with
an ``AsyncCheckpointError``. A tune of a ``GridSearch``/``RandomSearch`` records
``sweepFusion`` (the sweep's ``fusion_info_``) and, where points
failed, ``trialErrors`` on its metadata; ``"checkpoint": true`` is
ignored there, as in the JAX package.

With ``LO_PREFLIGHT`` (on by default) create and PATCH run the
preflight (:func:`~learningorchestra_tpu_torch.analysis.preflight.
check_execution`) before any document exists: ``#`` expressions among
the ``methodParameters`` are linted, and a ``NeuralModel`` root's layer
stack is built on the meta device over the recorded shapes of its
``$`` x and y; a provable failure is a 406 with the findings under
``analysis``, and warnings are kept as ``analysis`` on the metadata.
The job document also records the ``footprint`` estimate (``hbmBytes``,
``paramBytes``, ``estimator: "heuristic"``) where the preflight can
make one, calibrated against an earlier run's measured peak under
``LO_FOOTPRINT_CALIBRATE``. A create opens the job's trace with the
``submit``, ``validate`` and ``preflight`` spans; the job adds
``dataLoad`` and ``artifactSave``. The job evaluates ``#`` expressions in the sandbox. A parent
of another module (a fitted sklearn estimator) runs its own methods on
the host.

``timeout`` (seconds) is the job's deadline and ``healthPolicy`` (an
action or an object, :mod:`~learningorchestra_tpu_torch.runtime.health`)
arms the training health sentinel of a method that takes
``health_policy`` (``NeuralModel.fit``), merged over the ``LO_HEALTH_*``
defaults. Both are stored on the metadata, so a PATCH and a requeue at
boot replay them. Sentinel events reach the job's documents as
``{"healthEvent": ...}`` and its metadata as ``rollbacks``,
``nonfiniteSteps``, ``lossSpikes`` and the newest 32 ``healthEvents``.
A transient failure re-runs up to ``LO_JOB_RETRIES`` times. The body
field ``sliceDevices`` is refused with 406 before any document exists:
one card has no slices.
"""

from __future__ import annotations

import inspect
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np

from learningorchestra_tpu_torch import analysis as A
from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.observability import trace as obs_trace
from learningorchestra_tpu_torch.runtime import distributed as dist
from learningorchestra_tpu_torch.runtime import health as health_lib
from learningorchestra_tpu_torch.runtime import mesh as mesh_lib
from learningorchestra_tpu_torch.runtime.async_ckpt import wrap_checkpointer
from learningorchestra_tpu_torch.runtime.checkpoint import Checkpointer
from learningorchestra_tpu_torch.services import validators as V

NAME_FIELD = "name"
MODEL_NAME_FIELD = "modelName"
PARENT_NAME_FIELD = "parentName"
DESCRIPTION_FIELD = "description"
METHOD_FIELD = "method"
METHOD_PARAMETERS_FIELD = "methodParameters"

# verbs whose result is the mutated parent instance
_INSTANCE_RESULT_PREFIXES = ("train/", "tune/")
# request fields of the JAX package's job lifecycle the port lacks
_UNPORTED_FIELDS = ("sliceDevices",)


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
        if not isinstance(cls, type):
            # a root made by a factory (tensorflow.keras.models'
            # load_model, tensorflow.keras.applications' ResNet50): the
            # methods are the stored instance's class's, read from the
            # artifact's meta.json (a pickled object is loaded)
            try:
                cls = self._ctx.artifacts.stored_class(
                    root_meta[D.NAME_FIELD], root_meta[D.TYPE_FIELD])
                if cls is None:
                    cls = self._ctx.artifacts.load(
                        root_meta[D.NAME_FIELD], root_meta[D.TYPE_FIELD])
            except Exception as exc:  # noqa: BLE001 — a 406, not a 500
                raise V.HttpError(
                    V.HTTP_NOT_ACCEPTABLE,
                    f"cannot resolve stored model "
                    f"{root_meta[D.NAME_FIELD]!r}: {exc!r}") from exc
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
        timeout = V.valid_timeout(body.get(V.TIMEOUT_FIELD))
        V.refuse_unported_fields(body, _UNPORTED_FIELDS)
        health_policy = V.valid_health_policy(
            body.get(V.HEALTH_POLICY_FIELD))
        # the trace (id == collection name) starts HERE, on the HTTP
        # thread: submit/validate/preflight spans precede the job root
        # span the worker thread opens later
        with obs_trace.span("submit", trace=name, verb=verb, tool=tool):
            with obs_trace.span("validate"):
                self._validator.not_duplicate(name)
                self._validator.existing_finished(parent_name)
                root_meta = self.root_model_metadata(parent_name)
                self._validate_method(root_meta, method, method_parameters)
            with obs_trace.span("preflight"):
                analysis = self._preflight(root_meta, method,
                                           method_parameters)
                footprint = self._footprint(root_meta, method,
                                            method_parameters)
        type_string = D.normalize_type(f"{verb}/{tool}")
        extra = {
            D.PARENT_NAME_FIELD: parent_name,
            D.METHOD_FIELD: method,
            D.METHOD_PARAMETERS_FIELD: method_parameters,
            D.DESCRIPTION_FIELD: description,
        }
        if timeout is not None:
            # replayed by a PATCH and by the requeue at boot
            extra[V.TIMEOUT_FIELD] = timeout
        if health_policy is not None:
            extra[V.HEALTH_POLICY_FIELD] = health_policy
        if analysis:
            extra[V.ANALYSIS_FIELD] = analysis
        if footprint:
            extra[A.FOOTPRINT_FIELD] = footprint
        self._ctx.catalog.create_collection(name, type_string, extra)
        self._submit(name, type_string, parent_name, method,
                     method_parameters, description, timeout=timeout,
                     health_policy=health_policy, footprint=footprint)
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
        timeout = V.valid_timeout(
            body.get(V.TIMEOUT_FIELD, meta.get(V.TIMEOUT_FIELD)))
        V.refuse_unported_fields(body, _UNPORTED_FIELDS)
        health_policy = V.valid_health_policy(
            body.get(V.HEALTH_POLICY_FIELD,
                     meta.get(V.HEALTH_POLICY_FIELD)))
        parent_name = meta[D.PARENT_NAME_FIELD]
        root_meta = self.root_model_metadata(parent_name)
        self._validate_method(root_meta, method, method_parameters)
        analysis = self._preflight(root_meta, method, method_parameters)
        footprint = self._footprint(root_meta, method, method_parameters)
        self._ctx.catalog.update_metadata(
            name, {D.METHOD_PARAMETERS_FIELD: method_parameters,
                   V.ANALYSIS_FIELD: analysis,
                   A.FOOTPRINT_FIELD: footprint,
                   V.TIMEOUT_FIELD: timeout,
                   V.HEALTH_POLICY_FIELD: health_policy,
                   D.FINISHED_FIELD: False})
        self._submit(name, meta[D.TYPE_FIELD], parent_name, method,
                     method_parameters, description, timeout=timeout,
                     health_policy=health_policy, footprint=footprint)
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
    def _preflight(self, root_meta: Dict[str, Any], method: str,
                   method_parameters: Dict[str, Any]) -> list:
        """The shape preflight and the ``#`` lint, before the job
        document exists: a provably broken spec is a 406 and leaves no
        ``finished: False`` document. Returns the advisory findings."""
        if not self._ctx.config.preflight:
            return []
        findings = A.check_execution(
            self._ctx.catalog, root_meta, method, method_parameters,
            mode=self._ctx.config.sandbox_mode)
        return V.run_preflight(findings)

    def _footprint(self, root_meta: Dict[str, Any], method: str,
                   method_parameters: Dict[str, Any],
                   ) -> Optional[Dict[str, Any]]:
        """The preflight's footprint estimate, calibrated against a
        measured peak under ``LO_FOOTPRINT_CALIBRATE``
        (:func:`~learningorchestra_tpu_torch.analysis.preflight.
        calibrate_footprint`), or None (no claim)."""
        estimate = None
        if self._ctx.config.preflight:
            estimate = A.estimate_footprint(
                self._ctx.catalog, root_meta, method, method_parameters)
        footprint = dict(estimate) if estimate else {}
        A.calibrate_footprint(footprint, root_meta, method,
                              self._ctx.config)
        return footprint or None

    def _submit(self, name: str, type_string: str, parent_name: str,
                method: str, method_parameters: Dict[str, Any],
                description: str, timeout: Optional[float] = None,
                health_policy: Optional[Any] = None,
                footprint: Optional[Dict[str, Any]] = None) -> None:
        def run():
            _broadcast_to_workers(name, type_string, parent_name, method,
                                  method_parameters, health_policy)
            with obs_trace.span("dataLoad"):
                parent_type = self._ctx.params.artifact_type(parent_name)
                instance = self._ctx.artifacts.load(parent_name,
                                                    parent_type)
                treated = self._ctx.params.treat(method_parameters)
            ckpt = _prepare_checkpointer(self._ctx, name, type_string,
                                         treated)
            _inject_epoch_log(self._ctx, name, instance, method, treated)
            _inject_health_policy(self._ctx, instance, method, treated,
                                  health_policy)
            try:
                result = getattr(instance, method)(**treated)
            finally:
                if ckpt is not None:
                    ckpt.close()
            if ckpt is not None and (ckpt.commits or ckpt.restores):
                updates = {
                    "checkpointCommitSeconds": sum(
                        c["seconds"] for c in ckpt.commits),
                    "checkpointCommits": ckpt.commits,
                    "checkpointRestores": ckpt.restores}
                snapshots = getattr(ckpt, "snapshots", None)
                if snapshots is not None:
                    updates["checkpointSnapshotSeconds"] = sum(
                        c["seconds"] for c in snapshots)
                    updates["checkpointSnapshots"] = snapshots
                self._ctx.catalog.update_metadata(name, updates)
            if type_string.startswith(_INSTANCE_RESULT_PREFIXES):
                result = instance  # the fitted object is the artifact
            with obs_trace.span("artifactSave"):
                self._ctx.artifacts.save(result, name, type_string)
            _record_sweep_fusion(self._ctx, name, result)
            summary = summarize_result(result)
            if summary is not None:
                self._ctx.catalog.append_document(name, {"result": summary})
            return result

        self._ctx.jobs.submit(name, run, description=description,
                              parameters=method_parameters, needs_card=True,
                              max_retries=self._ctx.config.job_max_retries,
                              timeout=timeout, footprint=footprint,
                              pool=type_string.split("/", 1)[0])


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
    # LO_CKPT_ASYNC=1 moves each commit (encode, hash, fsync) off the
    # training thread, which pays a host snapshot instead
    ckpt = wrap_checkpointer(Checkpointer(checkpoint_dir_for(ctx, name)),
                             config=ctx.config)
    treated["checkpointer"] = ckpt
    return ckpt


def _inject_epoch_log(ctx, name: str, instance: Any, method: str,
                      treated: Dict[str, Any]) -> None:
    """Streams each epoch's record (loss, metrics, epoch, epochSeconds,
    samplesPerSecond) into the execution's documents as
    ``{"epochRecord": ...}`` when the method takes ``log_fn``: every
    epoch up to 512, then every 16th. A health sentinel's event is
    appended as ``{"healthEvent": ...}`` whatever its number, and sums
    into the metadata's ``rollbacks``, ``nonfiniteSteps``,
    ``lossSpikes`` and ``healthEvents`` (the newest 32)."""
    if "log_fn" in treated:
        return
    try:
        params = inspect.signature(getattr(instance, method)).parameters
    except (TypeError, ValueError):
        return
    if "log_fn" not in params:
        return
    seen = {"n": 0}
    health = {"rollbacks": 0, "nonfiniteSteps": 0, "lossSpikes": 0,
              "events": []}

    def log_record(record: Dict[str, Any]) -> None:
        event = record.get("healthEvent")
        if event is not None:
            health["events"].append(event)
            del health["events"][:-32]
            if "restoredStep" in event:
                health["rollbacks"] += 1
            if event.get("kind") == "spike":
                health["lossSpikes"] += 1
            else:
                health["nonfiniteSteps"] += max(
                    int(event.get("badSteps") or 0), 1)
            try:
                ctx.catalog.append_document(name, {"healthEvent": event})
                ctx.catalog.update_metadata(name, {
                    "rollbacks": health["rollbacks"],
                    "nonfiniteSteps": health["nonfiniteSteps"],
                    "lossSpikes": health["lossSpikes"],
                    "healthEvents": list(health["events"])})
            except Exception:  # noqa: BLE001 — must never sink a fit
                pass
            return
        i = seen["n"]
        seen["n"] = i + 1
        if i >= 512 and i % 16 != 0:
            return
        try:
            ctx.catalog.append_document(name, {"epochRecord": record})
        except Exception:  # noqa: BLE001 — logging must never sink a fit
            pass

    treated["log_fn"] = log_record


def _inject_health_policy(ctx, instance: Any, method: str,
                          treated: Dict[str, Any],
                          requested: Optional[Any]) -> None:
    """Arms the health sentinel where the method takes ``health_policy``
    (``NeuralModel.fit``; not the language model, the classifier or an
    sklearn method): the request's ``healthPolicy`` merged over the
    ``LO_HEALTH_*`` defaults. Nothing when both are off."""
    if "health_policy" in treated:
        return
    try:
        params = inspect.signature(getattr(instance, method)).parameters
    except (TypeError, ValueError):
        return
    if "health_policy" not in params:
        return
    policy = health_lib.resolve_policy(requested, ctx.config)
    if policy is not None:
        treated["health_policy"] = policy


# ----------------------------------------------------------------------
# the pod: one REST call, every rank
# ----------------------------------------------------------------------
def _broadcast_to_workers(name: str, type_string: str, parent_name: str,
                          method: str,
                          method_parameters: Dict[str, Any],
                          health_policy: Optional[Any] = None) -> None:
    """In a pod of several ranks the coordinator publishes every method
    call before it runs it: a sharded fit's collectives need every rank
    of the mesh in the same program. The followers replay it from the
    shared artifact store (:func:`replay_method_call`); the health
    policy rides along, since it changes what the step computes. Every
    rank then forms the default mesh's groups, before any step of the
    call can ask for one."""
    if dist.world_size() <= 1:
        return
    dist.HostBridge().publish({
        "op": "run",
        "target": "learningorchestra_tpu_torch.services.execution:"
                  "replay_method_call",
        "kwargs": {"name": name, "type_string": type_string,
                   "parent_name": parent_name, "method": method,
                   "method_parameters": method_parameters,
                   "health_policy": health_policy}})
    mesh_lib.get_default_mesh().form_groups()


_worker_ctx = None


def set_worker_context(ctx) -> None:
    """The context a follower replays in (its entry point's)."""
    global _worker_ctx
    _worker_ctx = ctx


def replay_method_call(name: str, type_string: str, parent_name: str,
                       method: str, method_parameters: Dict[str, Any],
                       health_policy: Optional[Any] = None) -> None:
    """The follower's twin of the coordinator's job: the same artifact
    from the shared store, the same parameters, the same method, so the
    rank takes its part in every collective. Catalog and artifact writes
    stay with the coordinator (the engine commits checkpoints on the
    mesh's first rank); the follower's result is dropped. A rank outside
    the default mesh has no part and returns."""
    global _worker_ctx
    if _worker_ctx is None:
        from learningorchestra_tpu_torch.services.context import \
            ServiceContext

        _worker_ctx = ServiceContext()
    ctx = _worker_ctx
    mesh = mesh_lib.get_default_mesh()
    mesh.form_groups()
    if mesh.coords(dist.rank()) is None:
        return
    instance = ctx.artifacts.load(parent_name,
                                  ctx.params.artifact_type(parent_name))
    treated = ctx.params.treat(method_parameters)
    ckpt = _prepare_checkpointer(ctx, name, type_string, treated)
    _inject_health_policy(ctx, instance, method, treated, health_policy)
    try:
        getattr(instance, method)(**treated)
    finally:
        if ckpt is not None:
            ckpt.close()


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
