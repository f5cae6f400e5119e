"""Synchronous request validation with the reference's status codes
(the serving and pipeline parts of the JAX package's
``services/validators.py``; messages are kept word for word so 406
bodies match)."""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Dict, Optional, Sequence

from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.catalog.artifacts import _NAME_RE

HTTP_SUCCESS = 200
HTTP_CREATED = 201
HTTP_CONFLICT = 409
HTTP_NOT_ACCEPTABLE = 406
HTTP_NOT_FOUND = 404
# serving-plane admission control: 429 = the session's bounded request
# queue is full (back off and retry), 503 = the session exists but
# cannot take traffic right now
HTTP_TOO_MANY_REQUESTS = 429
HTTP_UNAVAILABLE = 503

MESSAGE_DUPLICATE_FILE = "duplicated name"
MESSAGE_INVALID_NAME = "invalid name"
MESSAGE_INVALID_MODULE_PATH = "invalid module path name"
MESSAGE_INVALID_CLASS = "invalid class name"
MESSAGE_INVALID_CLASS_PARAMETER = "invalid class parameter"
MESSAGE_INVALID_METHOD = "invalid method name"
MESSAGE_INVALID_METHOD_PARAMETER = "invalid method parameter"
MESSAGE_NONEXISTENT_FILE = "nonexistent file"
MESSAGE_UNFINISHED_PARENT = "unfinished parent"
MESSAGE_INVALID_FIELD = "invalid field"
MESSAGE_MISSING_FIELD = "missing required field"


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


TIMEOUT_FIELD = "timeout"


def valid_timeout(value: Any) -> Optional[float]:
    """Optional deadline request field: a positive number of seconds,
    or None. Bools are rejected explicitly (bool is an int subclass)."""
    if value is None:
        return None
    if isinstance(value, bool) or not isinstance(value, (int, float)) \
            or value <= 0:
        raise HttpError(
            HTTP_NOT_ACCEPTABLE,
            f"{MESSAGE_INVALID_FIELD}: timeout must be a positive "
            f"number of seconds, got {value!r}")
    return float(value)


def valid_positive_int(value: Any, field: str,
                       default: Optional[int] = None) -> Optional[int]:
    """Serving-session sizing field (maxSlots, maxNewTokens, cacheLen):
    a positive integer, or None -> ``default``. Bools rejected."""
    if value is None:
        return default
    if isinstance(value, bool) or not isinstance(value, int) or value <= 0:
        raise HttpError(
            HTTP_NOT_ACCEPTABLE,
            f"{MESSAGE_INVALID_FIELD}: {field} must be a positive "
            f"integer, got {value!r}")
    return int(value)


def valid_choice(value: Any, field: str, allowed,
                 default: Optional[str] = None) -> Optional[str]:
    """Closed-enum request field: one of ``allowed``, or None ->
    ``default``."""
    if value is None:
        return default
    if not isinstance(value, str) or value not in allowed:
        raise HttpError(
            HTTP_NOT_ACCEPTABLE,
            f"{MESSAGE_INVALID_FIELD}: {field} must be one of "
            f"{sorted(allowed)}, got {value!r}")
    return value


def valid_sampling(body: Dict[str, Any]):
    """Serving-session sampling triple (``temperature``/``topK``/
    ``topP``), normalized exactly as ``LanguageModel.generate`` resolves
    them."""
    temperature = body.get("temperature", 0.0)
    if isinstance(temperature, bool) or \
            not isinstance(temperature, (int, float)):
        raise HttpError(
            HTTP_NOT_ACCEPTABLE,
            f"{MESSAGE_INVALID_FIELD}: temperature must be a number, "
            f"got {temperature!r}")
    top_k = body.get("topK")
    if top_k is not None and (isinstance(top_k, bool)
                              or not isinstance(top_k, int) or top_k < 1):
        raise HttpError(
            HTTP_NOT_ACCEPTABLE,
            f"{MESSAGE_INVALID_FIELD}: topK must be a positive integer, "
            f"got {top_k!r}")
    top_p = body.get("topP")
    if top_p is not None and (isinstance(top_p, bool)
                              or not isinstance(top_p, (int, float))
                              or not 0.0 < float(top_p) <= 1.0):
        raise HttpError(
            HTTP_NOT_ACCEPTABLE,
            f"{MESSAGE_INVALID_FIELD}: topP must be in (0, 1], "
            f"got {top_p!r}")
    if float(temperature) <= 0:
        top_k = top_p = None  # greedy ignores the filters
    if top_p is not None and float(top_p) == 1.0:
        top_p = None
    return float(temperature), top_k, (None if top_p is None
                                       else float(top_p))


def valid_slice_devices(value: Any):
    """A device-footprint field (``prefillDevices`` of a disaggregated
    session), checked as the JAX package checks ``sliceDevices``: a
    positive integer count, a ``{"min": m, "max": M}`` bounds object, or
    None. Returns the normalized int or dict. On one card the value
    places nothing."""
    if value is None:
        return None
    if isinstance(value, dict):
        unknown = set(value) - {"min", "max"}
        if unknown:
            raise HttpError(
                HTTP_NOT_ACCEPTABLE,
                f"{MESSAGE_INVALID_FIELD}: sliceDevices has unknown "
                f"keys {sorted(unknown)} (want {{'min', 'max'}})")
        lo, hi = value.get("min"), value.get("max")
        for name, bound in (("min", lo), ("max", hi)):
            if isinstance(bound, bool) or not isinstance(bound, int) \
                    or bound <= 0:
                raise HttpError(
                    HTTP_NOT_ACCEPTABLE,
                    f"{MESSAGE_INVALID_FIELD}: sliceDevices.{name} must "
                    f"be a positive integer device count, got {bound!r}")
        if lo > hi:
            raise HttpError(
                HTTP_NOT_ACCEPTABLE,
                f"{MESSAGE_INVALID_FIELD}: sliceDevices.min ({lo}) must "
                f"not exceed sliceDevices.max ({hi})")
        return {"min": int(lo), "max": int(hi)}
    if isinstance(value, bool) or not isinstance(value, int) or value <= 0:
        raise HttpError(
            HTTP_NOT_ACCEPTABLE,
            f"{MESSAGE_INVALID_FIELD}: sliceDevices must be a positive "
            f"integer device count or {{'min', 'max'}} bounds object, "
            f"got {value!r}")
    return int(value)


NOT_PORTED = "is not yet ported to the PyTorch package"


def not_ported(what: str) -> HttpError:
    """The 406 for a request the JAX package takes and the port does not
    run yet."""
    return HttpError(HTTP_NOT_ACCEPTABLE,
                     f"{MESSAGE_INVALID_FIELD}: {what} {NOT_PORTED}")


# module paths a request may name, each to the port's module that takes
# its place; the JAX package's path maps by name and is never imported
PORT_MODULES = {
    "learningorchestra_tpu_torch.models": "learningorchestra_tpu_torch.models",
    "learningorchestra_tpu.models": "learningorchestra_tpu_torch.models",
}
# keyword arguments the services supply themselves, never the request
_SERVICE_KWARGS = ("device",)
# public methods of learningorchestra_tpu.models classes that the port
# does not have yet: a static copy, since the port never imports the JAX
# package
JAX_ONLY_METHODS = {
    "LanguageModel": ("set_mesh",),
    "TextClassifier": ("set_mesh",),
    "NeuralModel": ("set_mesh", "from_keras", "from_savedmodel",
                    "from_legacy_h5", "to_keras", "save_keras",
                    "fit_sweep_fused", "supports_sweep_fusion"),
}

SCORING_FIELD = "scoring"


def valid_scoring(value: Any) -> Optional[str]:
    """A sweep's ``scoring`` class parameter (GridSearch/RandomSearch):
    ``"auto"``, ``"loss"`` or a metric name ``evaluate`` can report,
    checked at submit rather than after every trial trained."""
    if value is None:
        return None
    from learningorchestra_tpu_torch.models import neural as neural_lib

    allowed = sorted({"auto", "loss"} | set(neural_lib._METRICS))
    if not isinstance(value, str) or value not in allowed:
        raise HttpError(
            HTTP_NOT_ACCEPTABLE,
            f"{MESSAGE_INVALID_FIELD}: scoring must be one of "
            f"{allowed}, got {value!r}")
    return value


def resolve_module(module_path: str):
    """The port's module for ``module_path`` (a key of
    :data:`PORT_MODULES`), or None."""
    target = PORT_MODULES.get(module_path) \
        if isinstance(module_path, str) else None
    return None if target is None else importlib.import_module(target)


class RequestValidator:
    """Reflection checks of a request against the port's classes, with
    the JAX package's status codes and messages."""

    def __init__(self, context: "ServiceContext"):  # noqa: F821
        self._ctx = context

    # -- names ----------------------------------------------------------
    def safe_name(self, name: Any) -> str:
        if not isinstance(name, str) or not _NAME_RE.match(name) \
                or ".." in name or "/" in name or "\\" in name:
            raise HttpError(HTTP_NOT_ACCEPTABLE,
                            f"{MESSAGE_INVALID_NAME}: {name!r}")
        return name

    def not_duplicate(self, name: str) -> None:
        if self._ctx.catalog.exists(name):
            raise HttpError(HTTP_CONFLICT,
                            f"{MESSAGE_DUPLICATE_FILE}: {name}")

    def existing(self, name: str) -> Dict[str, Any]:
        meta = self._ctx.catalog.get_metadata(name)
        if meta is None:
            raise HttpError(HTTP_NOT_FOUND,
                            f"{MESSAGE_NONEXISTENT_FILE}: {name}")
        return meta

    def existing_finished(self, name: str) -> Dict[str, Any]:
        """A parent must exist and be finished before a job that reads
        it is accepted."""
        meta = self._ctx.catalog.get_metadata(name)
        if meta is None:
            raise HttpError(HTTP_NOT_ACCEPTABLE,
                            f"{MESSAGE_NONEXISTENT_FILE}: {name}")
        if not meta.get(D.FINISHED_FIELD, False):
            raise HttpError(HTTP_NOT_ACCEPTABLE,
                            f"{MESSAGE_UNFINISHED_PARENT}: {name}")
        return meta

    def required_fields(self, body: Dict[str, Any],
                        fields: Sequence[str]) -> None:
        for f in fields:
            if f not in body:
                raise HttpError(HTTP_NOT_ACCEPTABLE,
                                f"{MESSAGE_MISSING_FIELD}: {f}")

    # -- reflection targets --------------------------------------------
    def valid_module(self, module_path: str):
        module = resolve_module(module_path)
        if module is None:
            raise HttpError(
                HTTP_NOT_ACCEPTABLE,
                f"{MESSAGE_INVALID_MODULE_PATH}: {module_path!r} "
                f"{NOT_PORTED} (module paths: {', '.join(PORT_MODULES)})")
        return module

    def valid_class(self, module_path: str, class_name: str):
        module = self.valid_module(module_path)
        cls = getattr(module, class_name, None)
        if cls is None:
            raise HttpError(HTTP_NOT_ACCEPTABLE,
                            f"{MESSAGE_INVALID_CLASS}: {class_name}")
        return cls

    def valid_class_parameters(self, cls,
                               parameters: Dict[str, Any]) -> None:
        """The request's keywords against ``cls.__init__``; ``$``/``#``
        values are checked by name only."""
        self._check_kwargs(cls.__init__, parameters, skip_first=True,
                           message=MESSAGE_INVALID_CLASS_PARAMETER)

    def valid_method(self, target, method_name: str):
        method = getattr(target, method_name, None)
        if method is None and method_name in JAX_ONLY_METHODS.get(
                getattr(target, "__name__", ""), ()):
            raise HttpError(HTTP_NOT_ACCEPTABLE,
                            f"{MESSAGE_INVALID_METHOD}: {method_name} "
                            f"{NOT_PORTED}")
        if method is None or not callable(method):
            raise HttpError(HTTP_NOT_ACCEPTABLE,
                            f"{MESSAGE_INVALID_METHOD}: {method_name}")
        return method

    def valid_method_parameters(self, target, method_name: str,
                                parameters: Dict[str, Any]) -> None:
        self._check_kwargs(getattr(target, method_name), parameters,
                           skip_first=False,
                           message=MESSAGE_INVALID_METHOD_PARAMETER)

    def _check_kwargs(self, fn, parameters: Optional[Dict[str, Any]],
                      skip_first: bool, message: str) -> None:
        if not parameters:
            return
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            return  # a callable implemented in C: accepted unchecked
        names = [n for n in sig.parameters if n not in _SERVICE_KWARGS]
        if skip_first and names and names[0] in ("self", "cls"):
            names = names[1:]
        if any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values()):
            return
        for key in parameters:
            if key not in names:
                raise HttpError(
                    HTTP_NOT_ACCEPTABLE,
                    f"{message}: {key} (accepted: {', '.join(names)})")
