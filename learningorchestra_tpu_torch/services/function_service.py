"""Function service: the Python step of a pipeline, as the JAX package's
``services/function_service.py`` runs it.

``POST /function/python`` takes ``name``, ``description``, ``function``
(code, a ``file://`` path to it, or an ``http(s)://`` URL fetched with
``urllib``) and ``functionParameters``. The parameters go through the
``$``/``#`` DSL; a dataset reaches the code as a pandas DataFrame where
pandas is importable in the process that runs it, else as a catalog
``Table``. The code runs in the sandbox (``services/sandbox.py``) and
leaves its result in a ``response`` variable, which is stored as the
artifact; its stdout is appended as ``functionMessage`` and the
result's array shapes go on the metadata as ``resultShapes``.

A request may raise its trust level with ``sandboxMode`` up to the
operator's ceiling (``LO_SANDBOX_MAX``; 406 above it). Inline code and
``#`` parameters are linted at submit (406 with the findings, stored on
the metadata as ``analysis`` otherwise). ``timeout`` (seconds) is the
job's deadline: past it, or on a ``DELETE .../{name}/run``, the sandbox
kills the jailed child and the job ends ``timedOut`` or ``cancelled``.
The metadata keeps the request (mode and timeout too), so the server's
boot requeues an unfinished function. DELETE is the dataset service's,
as in the JAX package's server. Function jobs do not hold the card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from learningorchestra_tpu_torch import analysis as A
from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.config import API_PREFIX
from learningorchestra_tpu_torch.services import sandbox
from learningorchestra_tpu_torch.services import validators as V

NAME_FIELD = "name"
DESCRIPTION_FIELD = "description"
FUNCTION_FIELD = "function"
FUNCTION_PARAMETERS_FIELD = "functionParameters"
SANDBOX_MODE_FIELD = "sandboxMode"
RESPONSE_VARIABLE = "response"

# trust order for a request's escalation (config.sandbox_max_mode is the
# ceiling, config.sandbox_mode the default)
_TRUST_ORDER = {"subprocess": 0, "restricted": 1, "trusted": 2}


def resolve_sandbox_mode(config, requested: Optional[str]) -> str:
    """The mode a request runs under: the config's default, or the one it
    asks for where that stays at or below the ceiling (406 otherwise).
    With no ``sandbox_max_mode`` the ceiling is ``sandbox_mode``."""
    if not requested:
        return config.sandbox_mode
    if requested not in _TRUST_ORDER:
        raise V.HttpError(
            V.HTTP_NOT_ACCEPTABLE,
            f"invalid sandboxMode {requested!r} (one of "
            f"{sorted(_TRUST_ORDER)})")
    base = _TRUST_ORDER.get(config.sandbox_mode, 0)
    ceiling = max(_TRUST_ORDER.get(config.sandbox_max_mode, base), base)
    if _TRUST_ORDER[requested] > ceiling:
        raise V.HttpError(
            V.HTTP_NOT_ACCEPTABLE,
            f"sandboxMode {requested!r} exceeds this server's ceiling "
            f"(sandbox_max_mode={config.sandbox_max_mode or 'unset'}); "
            f"set LO_SANDBOX_MAX to allow it")
    return requested


def fetch_function_code(function: str) -> str:
    """``function`` is code, or a URL or ``file://`` path to it."""
    if function.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(function, timeout=60) as resp:
            charset = resp.headers.get_content_charset() or "utf-8"
            return resp.read().decode(charset)
    if function.startswith("file://"):
        with open(function[len("file://"):]) as f:
            return f.read()
    return function


class FunctionService:
    def __init__(self, context):
        self._ctx = context
        self._validator = V.RequestValidator(context)

    def create(self, body: Dict[str, Any], tool: str = "python",
               ) -> Tuple[int, Dict[str, Any]]:
        self._validator.required_fields(
            body, [NAME_FIELD, FUNCTION_FIELD, FUNCTION_PARAMETERS_FIELD])
        name = self._validator.safe_name(body[NAME_FIELD])
        self._validator.not_duplicate(name)
        function = body[FUNCTION_FIELD]
        parameters = body[FUNCTION_PARAMETERS_FIELD] or {}
        description = body.get(DESCRIPTION_FIELD, "")
        timeout = V.valid_timeout(body.get(V.TIMEOUT_FIELD))
        mode = resolve_sandbox_mode(self._ctx.config,
                                    body.get(SANDBOX_MODE_FIELD))
        analysis = self._preflight(function, parameters, mode)
        type_string = f"function/{tool}"
        extra = {
            D.FUNCTION_FIELD: function,
            D.FUNCTION_PARAMETERS_FIELD: parameters,
            D.DESCRIPTION_FIELD: description,
            SANDBOX_MODE_FIELD: mode,
        }
        if timeout is not None:
            extra[V.TIMEOUT_FIELD] = timeout  # requeues replay it too
        if analysis:
            extra[V.ANALYSIS_FIELD] = analysis
        self._ctx.catalog.create_collection(name, type_string, extra)
        self._submit(name, type_string, function, parameters, description,
                     mode, timeout=timeout)
        return V.HTTP_CREATED, {
            "result": f"{API_PREFIX}/function/{tool}/{name}"}

    def update(self, name: str, body: Dict[str, Any],
               tool: str = "python") -> Tuple[int, Dict[str, Any]]:
        meta = self._validator.existing(name)
        function = body.get(FUNCTION_FIELD, meta.get(D.FUNCTION_FIELD))
        parameters = body.get(
            FUNCTION_PARAMETERS_FIELD,
            meta.get(D.FUNCTION_PARAMETERS_FIELD)) or {}
        description = body.get(DESCRIPTION_FIELD, "")
        timeout = V.valid_timeout(
            body.get(V.TIMEOUT_FIELD, meta.get(V.TIMEOUT_FIELD)))
        mode = resolve_sandbox_mode(self._ctx.config,
                                    body.get(SANDBOX_MODE_FIELD))
        analysis = self._preflight(function, parameters, mode)
        self._ctx.catalog.update_metadata(
            name, {D.FUNCTION_FIELD: function,
                   D.FUNCTION_PARAMETERS_FIELD: parameters,
                   SANDBOX_MODE_FIELD: mode,
                   V.ANALYSIS_FIELD: analysis,
                   V.TIMEOUT_FIELD: timeout,
                   D.FINISHED_FIELD: False})
        self._submit(name, meta[D.TYPE_FIELD], function, parameters,
                     description, mode, timeout=timeout)
        return V.HTTP_SUCCESS, {
            "result": f"{API_PREFIX}/function/{tool}/{name}"}

    def _preflight(self, function: str, parameters: Dict[str, Any],
                   mode: str) -> list:
        """The submit-time lint of inline code and ``#`` parameters
        (code behind a URL or path is linted by the sandbox when it
        runs); 406 with the findings on an error."""
        if not self._ctx.config.preflight:
            return []
        findings = []
        if isinstance(function, str) and not function.startswith(
                ("http://", "https://", "file://")):
            findings.extend(A.lint_code(function, mode=mode,
                                        filename="<function>"))
        findings.extend(A.lint_parameter_code(parameters, mode))
        return V.run_preflight(findings)

    def _submit(self, name: str, type_string: str, function: str,
                parameters: Dict[str, Any], description: str,
                mode: str, timeout: Optional[float] = None) -> None:
        def run():
            code = fetch_function_code(function)
            treated = self._ctx.params.treat(parameters)
            ctx_vars, stdout = sandbox.run_user_code(
                code, treated, mode=mode, config=self._ctx.config,
                dataframes=True)
            if RESPONSE_VARIABLE not in ctx_vars:
                raise sandbox.missing_variable_error(
                    ctx_vars, RESPONSE_VARIABLE,
                    f"function must assign a {RESPONSE_VARIABLE!r} "
                    "variable")
            result = ctx_vars[RESPONSE_VARIABLE]
            self._ctx.artifacts.save(result, name, type_string)
            shapes = A.result_shapes(result)
            if shapes:
                self._ctx.catalog.update_metadata(
                    name, {A.RESULT_SHAPES_FIELD: shapes})
            self._ctx.catalog.append_document(
                name, {D.FUNCTION_MESSAGE_FIELD: stdout})
            return result

        self._ctx.jobs.submit(name, run, description=description,
                              parameters=parameters,
                              max_retries=self._ctx.config.job_max_retries,
                              timeout=timeout)

