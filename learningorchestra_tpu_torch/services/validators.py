"""Synchronous request validation with the reference's status codes
(the serving subset of the JAX package's ``services/validators.py``;
messages are kept word for word so 406 bodies match)."""

from __future__ import annotations

from typing import Any, Dict, Optional

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
