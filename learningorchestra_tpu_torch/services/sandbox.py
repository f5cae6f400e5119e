"""The jail of user code: Function bodies and ``#`` expressions, as the
JAX package's ``services/sandbox.py`` runs them, in three trust levels
(``Config.sandbox_mode``):

- ``"subprocess"`` (default): the code runs in a child interpreter under
  rlimits (CPU seconds, address space, file size), with its cwd in a
  scratch dir and an audit hook that denies reads outside the
  interpreter's tree and the scratch dir (and always inside the store,
  ``Config.home``), writes outside the scratch dir, process spawns,
  sockets and foreign calls through ``ctypes``; the namespace jail below
  comes on top. The child sees no card (``CUDA_VISIBLE_DEVICES=""``).
  Values come back in a typed encoding (primitives, numpy arrays as
  dtype, shape and bytes, tables and DataFrames as named columns), so
  the server never unpickles an object graph the child chose.
- ``"restricted"``: in process, with safe builtins (no ``open``,
  ``eval``, ``exec``, ``__import__``), imports through a whitelist, and
  guarded ``getattr``/``setattr``/``vars``. Faster, but escapable.
- ``"trusted"``: plain ``exec``.

In every mode ``tensorflow``, ``tensorflow.keras`` and ``keras`` resolve
to the port's shim (:mod:`learningorchestra_tpu_torch.models.tf_compat`),
as imports and as module paths, and ``tensorflow`` is a global of the
code, so ``#tensorflow.keras.optimizers.Adam(0.001)`` evaluates as in the
reference. A ``#`` spec object (a shim layer, optimizer or loss) crosses
back from the child pickled, and the result unpickler resolves classes
under the shim and nothing else, so a forged envelope reaches no
callable. The shim's layers, optimizers and losses import no torch.

Where the port differs from the JAX package:

- the whitelist has ``torch`` and ``learningorchestra_tpu_torch`` where
  the JAX one has ``jax``, ``flax``, ``optax``, ``chex`` and
  ``learningorchestra_tpu``;
- the child's boot imports this module alone, which imports neither
  torch nor pandas at module level, so a function job pays no torch
  import unless its code asks for one; the child imports numpy (and with
  it ``ctypes``) before its audit hook goes on, and the hook lets
  ``ctypes`` load a shared library from the interpreter's tree by
  absolute path, which ``import torch`` does; every other ``ctypes``
  event and every foreign call stays denied;
- the parent's wait checks only the wall deadline (no cancel token);
- tables and DataFrames cross the boundary as named numpy columns with a
  tag, not as Arrow IPC.
"""

from __future__ import annotations

import builtins as _builtins
import importlib
import io
import os
import pickle
import sys
from contextlib import redirect_stdout
from typing import Any, Dict, List, Optional, Sequence, Tuple

_ALLOWED_MODULE_PREFIXES = (
    "numpy", "pandas", "sklearn", "scipy", "math", "random", "json", "re",
    "itertools", "functools", "collections", "statistics", "string",
    "datetime", "time", "torch", "einops", "learningorchestra_tpu_torch",
    "pyarrow", "dataclasses", "typing",
)

# modules emulated by the port (import name -> real module path)
_SHIMMED_MODULES = {
    "tensorflow": "learningorchestra_tpu_torch.models.tf_compat",
    "tensorflow.keras": "learningorchestra_tpu_torch.models.tf_compat.keras",
    "keras": "learningorchestra_tpu_torch.models.tf_compat.keras",
}

# Dunders that reach interpreter internals from any object: the steps of
# every namespace-jail escape (object -> __class__ -> __subclasses__ ->
# ... -> __globals__['__builtins__']). The one list behind both the AST
# lint (analysis/code_lint.py) and the guarded builtins below.
DANGEROUS_DUNDERS = frozenset({
    "__class__", "__bases__", "__base__", "__mro__", "__subclasses__",
    "__globals__", "__closure__", "__code__", "__func__", "__self__",
    "__dict__", "__getattribute__", "__getattr__", "__setattr__",
    "__delattr__", "__init_subclass__", "__reduce__", "__reduce_ex__",
    "__builtins__", "__import__", "__loader__", "__spec__",
    "__subclasshook__", "__new__", "__getstate__", "__setstate__",
})

_SAFE_BUILTIN_NAMES = [
    "abs", "all", "any", "bool", "bytes", "callable", "chr", "dict",
    "divmod", "enumerate", "filter", "float", "format", "frozenset",
    "getattr", "hasattr", "hash", "hex", "int", "isinstance", "issubclass",
    "iter", "len", "list", "map", "max", "min", "next", "object", "oct",
    "ord", "pow", "print", "range", "repr", "reversed", "round", "set",
    "setattr", "slice", "sorted", "str", "sum", "tuple", "type", "zip",
    "ValueError", "TypeError", "KeyError", "IndexError", "AttributeError",
    "RuntimeError", "StopIteration", "ArithmeticError", "ZeroDivisionError",
    "Exception", "BaseException", "NotImplementedError", "OverflowError",
    "FloatingPointError", "AssertionError", "True", "False", "None",
    "__build_class__", "__name__", "staticmethod", "classmethod", "property",
    "super", "vars", "id", "NameError", "LookupError",
]


def module_allowed(name: str) -> bool:
    """Whether sandboxed code may import ``name``."""
    root = name.split(".")[0]
    return root in _SHIMMED_MODULES or root in _ALLOWED_MODULE_PREFIXES


class ModuleNotPorted(ImportError):
    """A module the port does not have yet."""


def resolve_module(name: str):
    """Imports ``name`` through the shim table (a request's
    ``modulePath`` ``tensorflow.keras.layers`` is the port's shim)."""
    target = _SHIMMED_MODULES.get(name)
    if target is not None:
        return importlib.import_module(target)
    shim_roots = [k for k in _SHIMMED_MODULES if name.startswith(k + ".")]
    if shim_roots:
        root = max(shim_roots, key=len)
        return importlib.import_module(_SHIMMED_MODULES[root]
                                       + name[len(root):])
    return importlib.import_module(name)


def _restricted_import(name: str, globals=None, locals=None, fromlist=(),
                       level: int = 0):
    if level != 0:
        raise ImportError("relative imports are not allowed in sandbox")
    root = name.split(".")[0]
    if root in _SHIMMED_MODULES:
        module = resolve_module(root)
        # "import a.b" binds a; "from a.b import c" takes c from a.b
        full = resolve_module(name)
        return full if fromlist else module
    if not module_allowed(name):
        raise ImportError(
            f"module {name!r} is not allowed in sandboxed code")
    return _builtins.__import__(name, globals, locals, fromlist, level)


def _with_tensorflow(g: Dict[str, Any]) -> Dict[str, Any]:
    """``tensorflow`` as a global of user code (the reference's ``#``
    DSL names it without an import)."""
    if "tensorflow" not in g:
        g["tensorflow"] = resolve_module("tensorflow")
    return g


def _guarded_getattr(obj, name, *default):
    """getattr that refuses dunder names built at run time
    (``getattr(o, "__cl" + "ass__")``); the lint catches constant ones."""
    if isinstance(name, str) and name in DANGEROUS_DUNDERS:
        raise AttributeError(
            f"attribute {name!r} is blocked in sandboxed code")
    return getattr(obj, name, *default)


def _guarded_setattr(obj, name, value):
    if isinstance(name, str) and name in DANGEROUS_DUNDERS:
        raise AttributeError(
            f"attribute {name!r} is blocked in sandboxed code")
    return setattr(obj, name, value)


def _guarded_vars(*obj):
    # vars(x) is x.__dict__ by another name; vars() with no argument only
    # shows the sandbox's own namespace
    if obj:
        raise TypeError(
            "vars(object) is blocked in sandboxed code (it is "
            "__dict__ access); use dataclasses.asdict or explicit "
            "attributes")
    import inspect

    frame = inspect.currentframe().f_back
    return frame.f_locals if frame is not None else {}


def make_sandbox_globals(extra: Optional[Dict[str, Any]] = None,
                         trusted: bool = False) -> Dict[str, Any]:
    if trusted:
        g: Dict[str, Any] = {"__builtins__": _builtins}
    else:
        safe = {n: getattr(_builtins, n) for n in _SAFE_BUILTIN_NAMES
                if hasattr(_builtins, n)}
        safe["__import__"] = _restricted_import
        safe["getattr"] = _guarded_getattr
        safe["setattr"] = _guarded_setattr
        safe["vars"] = _guarded_vars
        g = {"__builtins__": safe}
    g["__name__"] = "__lo_sandbox__"
    if extra:
        g.update(extra)
    return g


def _default_config():
    # the parent's config; imported here because the child never needs it
    from learningorchestra_tpu_torch.config import Config

    return Config()


def _is_table(value: Any) -> bool:
    # by name: the child imports the catalog only when a table crosses
    cls = type(value)
    return (cls.__name__, cls.__module__) == (
        "Table", "learningorchestra_tpu_torch.catalog.store")


def _own_table(value: Any) -> Any:
    """A catalog ``Table`` over writable copies of its columns (the
    feature cache shares its arrays, read-only, among readers); any
    other value as it is."""
    if not _is_table(value):
        return value
    import numpy as np

    return type(value)({c: np.array(value[c]) for c in value.columns},
                       len(value))


def to_dataframe(value: Any) -> Any:
    """A catalog ``Table`` as a pandas DataFrame of copies of its columns
    where pandas is importable, else a ``Table`` of such copies; any
    other value as it is. The columns keep the Table's dtypes (int64,
    float64 with NaN for blanks, object for text), the dtypes the JAX
    package's DataFrame has."""
    if not _is_table(value):
        return value
    try:
        import pandas as pd
    except ImportError:
        return _own_table(value)
    import numpy as np

    return pd.DataFrame({c: np.array(value[c]) for c in value.columns},
                        index=pd.RangeIndex(len(value)))


def run_user_code(code: str,
                  parameters: Optional[Dict[str, Any]] = None,
                  mode: Optional[str] = None,
                  lint: bool = True,
                  config=None,
                  dataframes: bool = False,
                  ) -> Tuple[Dict[str, Any], str]:
    """Runs ``code`` with ``parameters`` as globals and returns (its
    variables, its captured stdout): the Function contract, where the
    result is left in ``response`` and stdout becomes
    ``functionMessage``. ``mode`` is ``subprocess``, ``restricted`` or
    ``trusted`` (default ``config.sandbox_mode``). ``dataframes`` hands
    each catalog ``Table`` among the parameters to the code as a
    DataFrame where pandas is importable in the process that runs it
    (the function route)."""
    config = config or _default_config()
    resolved = mode or config.sandbox_mode
    if lint and config.preflight:
        # the last screen: URL-fetched code and '#' expressions reach
        # only this one
        from learningorchestra_tpu_torch.analysis import code_lint

        code_lint.assert_code_safe(code, mode=resolved,
                                   filename="<lo-user-code>")
    if resolved == "subprocess":
        return _run_in_subprocess(code, parameters, config, dataframes)
    # in-process code gets copies of each table's columns it may write
    # to (the jail's child decodes copies of its own)
    parameters = {k: to_dataframe(v) if dataframes else _own_table(v)
                  for k, v in (parameters or {}).items()}
    g = _with_tensorflow(make_sandbox_globals(
        parameters, trusted=resolved == "trusted"))
    stdout = io.StringIO()
    with redirect_stdout(stdout):
        exec(compile(code, "<lo-user-code>", "exec"), g)  # noqa: S102
    return g, stdout.getvalue()


def eval_hash_expressions(exprs: List[str], mode: Optional[str] = None,
                          config=None) -> List[Any]:
    """Evaluates many ``#`` expressions in ONE sandbox pass: one child
    interpreter for a whole request in subprocess mode. Each expression
    binds its own variable, so equal texts still give distinct objects."""
    if not exprs:
        return []
    lines = [e.replace("#", f"__lo_hash_{i} = ", 1)
             for i, e in enumerate(exprs)]
    g, _ = run_user_code("\n".join(lines), mode=mode, config=config)
    out = []
    for i, expr in enumerate(exprs):
        var = f"__lo_hash_{i}"
        if var not in g:
            raise missing_variable_error(g, var, f"'#' expression {expr!r}")
        out.append(g[var])
    return out


def eval_hash_expression(class_code: str, mode: Optional[str] = None,
                         config=None) -> Any:
    """``"#<expr>"``: the value of ``<expr>``."""
    return eval_hash_expressions([class_code], mode=mode, config=config)[0]


# ======================================================================
# the subprocess jail
# ======================================================================
# Values cross as a typed encoding, never as free pickle: primitives as
# they are, numpy arrays as (tag, dtype, shape, bytes), tables and
# DataFrames as named columns. The envelope pickle therefore holds only
# containers of primitives and bytes, except the '#' DSL's spec objects
# (the shim's layers, optimizers and losses), pickled by class reference:
# _RestrictedUnpickler resolves classes under the shim and nothing else,
# so a child that overwrites its result file cannot reach a callable in
# the parent.

_ND_TAG = "__lo_nd.v1__"
_TUPLE_TAG = "__lo_tuple.v1__"
_TABLE_TAG = "__lo_table.v1__"
_DF_TAG = "__lo_df.v1__"
_SERIES_TAG = "__lo_series.v1__"
_TEXT_TAG = "__lo_text.v1__"
_PICKLE_TAG = "__lo_obj.v1__"

_PICKLE_CLASS_PREFIX = "learningorchestra_tpu_torch.models.tf_compat"


def _is_shim_module(module: str) -> bool:
    return module == _PICKLE_CLASS_PREFIX or \
        module.startswith(_PICKLE_CLASS_PREFIX + ".")


class _Unencodable(Exception):
    pass


# reserved key of a result listing the child's variables that did not
# cross the boundary, so a missing ``response`` can say why
DROPPED_KEY = "__lo_dropped__"


def missing_variable_error(ctx_vars: Dict[str, Any], var: str,
                           what: str) -> Exception:
    """The error for ``var`` missing from a sandbox result: names the
    variables the jail dropped and the way to return live objects."""
    dropped = ctx_vars.get(DROPPED_KEY) or []
    if var in dropped:
        return TypeError(
            f"{what}: variable {var!r} was assigned but could not "
            f"cross the subprocess-sandbox boundary (only primitives, "
            f"ndarrays, DataFrames and tf_compat specs do); set "
            f"sandbox_mode='restricted' or 'trusted' to return live "
            f"objects")
    hint = (f" (unrelated variable(s) {dropped} were dropped at the "
            f"sandbox boundary)" if dropped else "")
    return ValueError(f"{what}: variable {var!r} was never "
                      f"assigned{hint}")


def _encode_column(values: Any) -> Any:
    """One column: a numeric array as an ndarray, text (an object array)
    as a list of its scalars."""
    import numpy as np

    arr = np.asarray(values)
    if arr.dtype != object:
        return _encode_value(np.ascontiguousarray(arr))
    out = []
    for v in arr.tolist():
        if v is not None and not isinstance(v, (bool, int, float, str)):
            raise _Unencodable(f"a column holds a {type(v).__name__}")
        out.append(v)
    return [_TEXT_TAG, out]


def _decode_column(values: Any) -> Any:
    import numpy as np

    if values[0] == _TEXT_TAG:
        column = np.empty(len(values[1]), dtype=object)
        column[:] = values[1]
        return column
    return _decode_value(values)


def _column_name(name: Any) -> Any:
    if isinstance(name, bool) or not isinstance(name, (str, int)):
        raise _Unencodable(f"column name {name!r}")
    return name


def _encode_value(v: Any, depth: int = 0) -> Any:
    import numpy as np

    if depth > 32:
        raise _Unencodable("nesting too deep")
    if isinstance(v, np.generic):
        # before the primitives: np.float64 is a float, and would be
        # pickled by reference to numpy, which the parent refuses
        return [_ND_TAG, v.dtype.str, [], v.tobytes()]
    if v is None or type(v) in (bool, int, float, str, bytes):
        return v
    for kind in (bool, int, float, str, bytes):
        if isinstance(v, kind):  # a subclass (torch's TorchVersion is
            return kind(v)       # a str) crosses as its base type
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            raise _Unencodable("object-dtype array")
        c = np.ascontiguousarray(v)
        return [_ND_TAG, c.dtype.str, list(c.shape), c.tobytes()]
    if isinstance(v, tuple):
        return [_TUPLE_TAG, [_encode_value(x, depth + 1) for x in v]]
    if isinstance(v, list):
        return [_encode_value(x, depth + 1) for x in v]
    if isinstance(v, dict):
        out = {}
        for k, val in v.items():
            if not isinstance(k, (str, int, float, bool)):
                raise _Unencodable(f"non-primitive dict key {k!r}")
            out[k] = _encode_value(val, depth + 1)
        return out
    cls = type(v)
    if _is_table(v):
        return [_TABLE_TAG, [[_column_name(c), _encode_column(v[c])]
                             for c in v.columns], len(v)]
    if (cls.__module__ or "").split(".")[0] == "pandas":
        if cls.__name__ == "DataFrame":
            return [_DF_TAG,
                    [[_column_name(c), _encode_column(v[c].to_numpy())]
                     for c in v.columns],
                    _encode_column(v.index.to_numpy())]
        if cls.__name__ == "Series":
            name = None if v.name is None else _column_name(v.name)
            return [_SERIES_TAG, name, _encode_column(v.to_numpy()),
                    _encode_column(v.index.to_numpy())]
    if _is_shim_module(cls.__module__ or ""):
        return [_PICKLE_TAG, pickle.dumps(v)]
    raise _Unencodable(f"type {cls.__name__} does not cross the "
                       "sandbox boundary")


def _table(columns: Sequence, rows: int):
    from learningorchestra_tpu_torch.catalog.store import Table

    return Table(dict(columns), rows)


def _decode_value(v: Any, dataframes: bool = False) -> Any:
    """The value of an encoding. A table comes back as a ``Table``, or as
    a DataFrame where ``dataframes`` asks for one and pandas is
    importable; a DataFrame or Series as itself where pandas is
    importable, else as a ``Table``."""
    import numpy as np

    if isinstance(v, list) and v and v[0] == _ND_TAG:
        _, dtype, shape, buf = v
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if shape == [] else arr.copy()
    if isinstance(v, list) and v and v[0] == _TUPLE_TAG:
        return tuple(_decode_value(x, dataframes) for x in v[1])
    if isinstance(v, list) and v and v[0] == _TABLE_TAG:
        table = _table([(n, _decode_column(c)) for n, c in v[1]], v[2])
        return to_dataframe(table) if dataframes else table
    if isinstance(v, list) and v and v[0] in (_DF_TAG, _SERIES_TAG):
        if v[0] == _DF_TAG:
            columns = [(n, _decode_column(c)) for n, c in v[1]]
            index = _decode_column(v[2])
        else:
            columns = [(v[1], _decode_column(v[2]))]
            index = _decode_column(v[3])
        try:
            import pandas as pd
        except ImportError:
            return _table(columns, len(index))
        if v[0] == _SERIES_TAG:
            return pd.Series(columns[0][1], index=index, name=v[1])
        return pd.DataFrame(dict(columns), index=index)
    if isinstance(v, list) and v and v[0] == _PICKLE_TAG:
        return _RestrictedUnpickler(io.BytesIO(v[1])).load()
    if isinstance(v, list):
        return [_decode_value(x, dataframes) for x in v]
    if isinstance(v, dict):
        return {k: _decode_value(val, dataframes) for k, val in v.items()}
    return v


class _RestrictedUnpickler(pickle.Unpickler):
    """Resolves the builtins containers and classes under the tensorflow
    shim (the only live objects the ``#`` DSL hands back: layer,
    optimizer and loss specs), and nothing else: no function, not even
    one of the shim."""

    def find_class(self, module: str, name: str):
        import inspect

        if module == "builtins" and name in ("dict", "list", "tuple",
                                             "set", "frozenset"):
            return getattr(_builtins, name)
        if _is_shim_module(module):
            try:
                obj = getattr(importlib.import_module(module), name, None)
            except ImportError:
                obj = None
            if inspect.isclass(obj):
                return obj
        raise pickle.UnpicklingError(
            f"sandbox result may not reference {module}.{name}")


def _safe_load_envelope(raw: bytes) -> Dict[str, Any]:
    """The child's result envelope, read by :class:`_RestrictedUnpickler`
    against a child that wrote arbitrary bytes."""
    return _RestrictedUnpickler(io.BytesIO(raw)).load()


_RESULT_FILE = "__lo_result__.pkl"

# the child's boot: read the payload before any other import so that
# sys.path can be replicated first; then only this module
_CHILD_BOOT = (
    "import pickle,sys\n"
    "p = pickle.load(sys.stdin.buffer)\n"
    "sys.path[:0] = [q for q in p['sys_path'] if q not in sys.path]\n"
    "from learningorchestra_tpu_torch.services import sandbox\n"
    "sandbox._child_main(p)\n"
)


def _run_in_subprocess(code: str, parameters: Optional[Dict[str, Any]],
                       config, dataframes: bool,
                       ) -> Tuple[Dict[str, Any], str]:
    import shutil
    import subprocess
    import tempfile
    import time

    scratch = tempfile.mkdtemp(prefix="lo_sbx_")
    try:
        enc_params = {}
        dropped_in: List[str] = []
        for k, v in (parameters or {}).items():
            try:
                enc_params[k] = _encode_value(v)
            except _Unencodable:
                dropped_in.append(k)
        if dropped_in:
            raise TypeError(
                f"parameters {dropped_in} cannot cross into sandboxed "
                "code (use sandbox_mode=restricted/trusted for live-"
                "object parameters)")
        payload = {
            "code": code,
            "parameters": enc_params,
            "dataframes": dataframes,
            "scratch": scratch,
            # '' and other relative entries are the parent's cwd's:
            # resolve them, the child's cwd is the scratch dir
            "sys_path": [os.path.abspath(p or os.getcwd())
                         for p in sys.path],
            # never readable from the jail, even where sys.path covers it
            "denied": [config.home],
            "limits": {
                "cpu": config.sandbox_cpu_seconds,
                "mem": config.sandbox_memory_bytes,
                "fsize": config.sandbox_file_bytes,
            },
        }
        env = {
            "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "HOME": scratch,
            "TMPDIR": scratch,
            "PYTHONPATH": os.pathsep.join(payload["sys_path"]),
            # user code importing torch must not reach the parent's card
            "CUDA_VISIBLE_DEVICES": "",
            "LANG": os.environ.get("LANG", "C.UTF-8"),
        }
        wall = max(30.0, config.sandbox_cpu_seconds * 2.0)
        # Popen (fork then exec: safe beside the parent's CUDA context)
        # and a wait loop against the wall deadline and the job's cancel
        # token: a deadline, a DELETE .../run or the stall watchdog
        # kills the child (user code has no cooperative check inside).
        # stderr goes to a file, not a pipe nobody drains while the loop
        # waits.
        from learningorchestra_tpu_torch.runtime import preempt

        token = preempt.current_cancel()
        stderr_path = os.path.join(scratch, "__lo_stderr__")
        with open(stderr_path, "wb") as stderr_f:
            proc = subprocess.Popen(
                [sys.executable, "-c", _CHILD_BOOT],
                stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                stderr=stderr_f, env=env, cwd=scratch)
            try:
                try:
                    proc.stdin.write(pickle.dumps(payload))
                    proc.stdin.close()
                except BrokenPipeError:
                    pass  # the child died early; its exit says why
                deadline = time.monotonic() + wall
                while True:
                    try:
                        proc.wait(timeout=0.1)
                        break
                    except subprocess.TimeoutExpired:
                        pass
                    if token is not None and token.cancelled():
                        raise preempt.JobCancelled(
                            token.reason or "cancelled",
                            "sandboxed code cancelled")
                    if time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"sandboxed code exceeded {wall:.0f}s "
                            f"wall clock")
            except BaseException:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                raise
        result_path = os.path.join(scratch, _RESULT_FILE)
        if not os.path.exists(result_path):
            with open(stderr_path, "rb") as f:
                detail = f.read()[-2000:].decode(errors="replace")
            raise RuntimeError(
                f"sandboxed code died (exit {proc.returncode}): {detail}")
        with open(result_path, "rb") as f:
            envelope = _safe_load_envelope(f.read())
        if "error" in envelope:
            err = envelope["error"]
            exc_cls = getattr(_builtins, str(err.get("type")), None)
            if not (isinstance(exc_cls, type)
                    and issubclass(exc_cls, BaseException)):
                exc_cls = RuntimeError
            raise exc_cls(
                f"{err.get('message')}\n[sandbox traceback]\n"
                f"{err.get('traceback', '')}")
        ctx_vars = {k: _decode_value(v)
                    for k, v in envelope.get("vars", {}).items()}
        if envelope.get("dropped"):
            ctx_vars[DROPPED_KEY] = sorted(envelope["dropped"])
        return ctx_vars, envelope.get("stdout", "")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


# -- the child ---------------------------------------------------------
_GUARD_DENIED_EVENTS = frozenset({
    "os.system", "os.exec", "os.posix_spawn", "os.spawn", "os.fork",
    "os.forkpty", "subprocess.Popen", "pty.spawn", "socket.__new__",
    "socket.bind", "socket.connect", "socket.getaddrinfo",
    "socket.gethostbyname", "os.kill", "os.killpg", "signal.pthread_kill",
    "resource.setrlimit", "webbrowser.open",
    # ctypes bypasses the jail (CDLL(None).system(...): raw libc calls
    # fire no audit events); see dlopen_allowed for the one load an
    # import of torch makes
    "ctypes.dlopen", "ctypes.dlsym", "ctypes.call_function",
    "ctypes.cdata", "ctypes.cdata_buffer", "ctypes.addressof",
    "ctypes.string_at", "ctypes.wstring_at",
})

_GUARD_WRITE_EVENTS = frozenset({
    "os.remove", "os.rename", "os.rmdir", "os.mkdir", "os.chmod",
    "os.chown", "os.link", "os.symlink", "os.truncate", "shutil.rmtree",
    "shutil.move", "os.utime",
})

_GUARD_READ_EVENTS = frozenset({"os.listdir", "os.scandir", "glob.glob"})

# /proc entries with no cross-process secrets (hardware and self only)
_PROC_ALLOWED = ("/proc/cpuinfo", "/proc/stat", "/proc/meminfo",
                 "/proc/sys/vm", "/proc/filesystems", "/proc/version")


def _install_guard(scratch: str, read_prefixes: Tuple[str, ...],
                   denied: Tuple[str, ...] = ()) -> None:
    scratch = os.path.realpath(scratch)
    reads = tuple(os.path.realpath(p) for p in read_prefixes)
    denied = tuple(os.path.realpath(p) for p in denied)
    # check_path realpaths user paths, which resolves the /proc/self
    # symlink to /proc/<pid>: allow the resolved form
    proc_allowed = _PROC_ALLOWED + (os.path.realpath("/proc/self"),)

    def under(path: str, prefix: str) -> bool:
        return path == prefix or path.startswith(prefix + os.sep)

    def check_path(raw, writing: bool) -> None:
        if raw is None or isinstance(raw, int):
            return
        try:
            p = os.path.realpath(os.fspath(raw))
        except (TypeError, ValueError):
            raise PermissionError(f"sandbox: bad path {raw!r}")
        if under(p, scratch):
            return
        if not writing and not any(under(p, d) for d in denied):
            if any(under(p, r) for r in reads):
                return
            if any(under(p, a) for a in proc_allowed):
                return
        raise PermissionError(
            f"sandbox: {'write' if writing else 'read'} access to "
            f"{p!r} denied")

    def dlopen_allowed(event: str, args) -> bool:
        """``import torch`` loads ``torch/lib/libtorch_global_deps.so``
        through ctypes by absolute path: a library of the interpreter's
        tree loads, and no symbol of it can be looked up or called."""
        name = args[0] if event == "ctypes.dlopen" and args else None
        if not isinstance(name, str) or not os.path.isabs(name):
            return False
        p = os.path.realpath(name)
        return (not under(p, scratch)
                and not any(under(p, d) for d in denied)
                and any(under(p, r) for r in reads))

    def hook(event: str, args) -> None:
        if event == "open":
            path, mode, flags = (list(args) + [None, None])[:3]
            if mode is None:
                writing = bool((flags or 0) & (os.O_WRONLY | os.O_RDWR
                                               | os.O_CREAT))
            else:
                writing = any(c in str(mode) for c in "wax+")
            check_path(path, writing)
        elif event in _GUARD_DENIED_EVENTS or \
                event.startswith(("socket.", "ftplib.", "smtplib.",
                                  "urllib.", "http.")):
            if not dlopen_allowed(event, args):
                raise PermissionError(f"sandbox: {event} denied")
        elif event in _GUARD_WRITE_EVENTS:
            # rename, link, symlink and move carry (src, dst, ...): every
            # path argument must stay in the jail, or a rename of a
            # scratch file onto an outside path is a write escape
            for a in (args or ()):
                if isinstance(a, (str, bytes, os.PathLike)):
                    check_path(a, True)
        elif event in _GUARD_READ_EVENTS:
            check_path(args[0] if args else None, False)

    sys.addaudithook(hook)


def _child_main(payload: Dict[str, Any]) -> None:  # pragma: no cover
    """The jailed interpreter's entry (see _CHILD_BOOT)."""
    import resource
    import traceback

    # before the hook: numpy imports ctypes, whose import opens the
    # interpreter's own symbols (dlopen(None)), which the hook denies;
    # and dill, outside the whitelist, is marked absent, or torch's
    # optional import of it opens /dev/null and looks up symbols
    import ctypes  # noqa: F401
    import numpy  # noqa: F401
    sys.modules["dill"] = None

    scratch = payload["scratch"]
    limits = payload["limits"]
    result_path = os.path.join(scratch, _RESULT_FILE)

    def write_result(obj: Dict[str, Any]) -> None:
        tmp = result_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(obj, f)
        os.replace(tmp, result_path)

    try:
        resource.setrlimit(resource.RLIMIT_CPU,
                           (limits["cpu"], limits["cpu"]))
        resource.setrlimit(resource.RLIMIT_AS,
                           (limits["mem"], limits["mem"]))
        resource.setrlimit(resource.RLIMIT_FSIZE,
                           (limits["fsize"], limits["fsize"]))
        resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
        os.chdir(scratch)
        # reads: the interpreter's tree and every sys.path root (imports)
        # and shared system data, but never the store
        read_prefixes = tuple(dict.fromkeys(
            [sys.prefix, sys.exec_prefix, "/usr", "/lib", "/lib64",
             "/opt"] + [p for p in sys.path if p]))
        _install_guard(scratch, read_prefixes,
                       tuple(payload.get("denied") or ()))

        parameters = {k: _decode_value(v, payload.get("dataframes", False))
                      for k, v in payload["parameters"].items()}
        g = _with_tensorflow(make_sandbox_globals(parameters,
                                                  trusted=False))
        stdout = io.StringIO()
        with redirect_stdout(stdout):
            exec(compile(payload["code"], "<lo-user-code>", "exec"), g)  # noqa: S102,E501

        out_vars: Dict[str, Any] = {}
        dropped: List[str] = []
        for k, v in g.items():
            if k in ("__builtins__", "__name__", "tensorflow") or \
                    k in parameters:
                continue
            if type(v).__name__ == "module" or callable(v):
                continue
            try:
                out_vars[k] = _encode_value(v)
            except Exception:  # noqa: BLE001 — best-effort var export
                dropped.append(k)
        write_result({"vars": out_vars, "stdout": stdout.getvalue(),
                      "dropped": dropped})
    except BaseException as e:  # noqa: BLE001 — report, then exit
        try:
            # the nearest builtin class, which the parent can raise
            builtin = next(c for c in type(e).__mro__
                           if getattr(_builtins, c.__name__, None) is c)
            write_result({"error": {
                "type": builtin.__name__, "message": str(e),
                "traceback": traceback.format_exc(limit=20)}})
        except Exception:  # noqa: BLE001
            os._exit(13)
    os._exit(0)
