"""The port's host-side C++ cores, one library per source in ``csrc/``:

- ``hgb_core``: its own copy of the JAX package's histogram booster
  (``csrc/locore.cpp`` ``lo_hgb_*``), bound by :mod:`.hgb`;
- ``csv_core``: CSV ingest, query masks, value counts and the batch
  gather (the rest of ``locore.cpp``, typed by the port's kinds), bound
  by :mod:`.ops`;
- ``tree_core``: scikit-learn's exact best-split tree (the Builder's DT,
  each tree of its RF and each stage of its GB) and GB's residuals, bound
  by :mod:`.trees`;
- ``sgd_core``: the per-row log-loss SGD epoch of the Builder's streaming
  LR, bound by :mod:`.sgd`.

Each source is compiled with ``g++ -O3`` at first use, never at import,
into ``build/native/`` beside the package, under a name that carries a
hash of the source and the flags, so an edited source never loads a
stale library. Each process compiles to a file of its own
(``<name>.<pid>.tmp.so``) and moves it into place with ``os.replace``,
so builds racing in several processes (test workers) leave one whole
library; threads of one process build under the ``native.registry``
lock, once. A library is bound over its plain C interface with
:mod:`ctypes` and checked against its ABI version.

:func:`get_lib` returns None with ``LO_NATIVE=0`` or where no ``g++``
exists (:func:`build_error` then says why); callers take their Python
path. Where ``g++`` exists, a build that fails raises
:class:`NativeBuildError`: it is a fault, not a switch to Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

from learningorchestra_tpu_torch.runtime import locks

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
HGB, CSV = "hgb_core", "csv_core"
TREE, SGD = "tree_core", "sgd_core"
_NO_COMPILER = "no g++ on PATH"


class NativeBuildError(RuntimeError):
    """``g++`` exists but could not build a core."""


def _bind_hgb(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.lo_hgb_train.restype = c.c_void_p
    lib.lo_hgb_train.argtypes = [
        c.c_void_p, c.c_int64, c.c_int, c.c_void_p, c.c_int, c.c_int,
        c.c_int, c.c_int, c.c_double, c.c_double, c.c_int64]
    lib.lo_hgb_predict.restype = None
    lib.lo_hgb_predict.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                   c.c_void_p]
    lib.lo_hgb_free.restype = None
    lib.lo_hgb_free.argtypes = [c.c_void_p]
    return lib


def _bind_csv(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i64, i32, ptr = c.c_int64, c.c_int32, c.c_void_p

    def sig(name, restype, *argtypes):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, list(argtypes)

    sig("lo_csv_cut", i64, ptr, i64, i64, i32, ptr)
    sig("lo_utf8_valid", i32, ptr, i64, i32)
    sig("lo_csv_parse", ptr, ptr, i64, i64, i64)
    sig("lo_csv_free", None, ptr)
    for name in ("lo_csv_rows", "lo_csv_cols", "lo_csv_bad_row",
                 "lo_csv_bad_width"):
        sig(name, i64, ptr)
    sig("lo_csv_status", i32, ptr)
    sig("lo_csv_data", ptr, ptr)
    sig("lo_csv_offsets", ptr, ptr)
    sig("lo_csv_infer", i64, ptr, i64, ptr, ptr, ptr)
    sig("lo_csv_convert", i64, ptr, i64, i32, ptr, ptr, ptr, ptr)
    sig("lo_csv_text_width", i64, ptr, i64)
    sig("lo_csv_text", None, ptr, i64, i64, ptr, ptr)
    sig("lo_value_counts", ptr, ptr, i64, i64, i32, ptr)
    sig("lo_counts_free", None, ptr)
    sig("lo_counts_n", i64, ptr)
    sig("lo_counts_first", ptr, ptr)
    sig("lo_counts_counts", ptr, ptr)
    sig("lo_filter", None, ptr, i64, i32, ptr, i32, i32, i64, c.c_double,
        ptr)
    sig("lo_filter_text_eq", None, ptr, i64, i64, ptr, ptr, i64, i32, ptr)
    sig("lo_gather_rows", None, ptr, i64, ptr, i64, ptr)
    return lib


def _bind_tree(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i64, ptr = c.c_int64, c.c_void_p
    lib.lo_tree_fit.restype = ptr
    lib.lo_tree_fit.argtypes = [ptr, i64, i64, ptr, ptr, ptr, c.c_int32,
                                i64, i64, i64, c.c_uint32]
    lib.lo_tree_node_count.restype = i64
    lib.lo_tree_node_count.argtypes = [ptr]
    lib.lo_tree_export.restype = None
    lib.lo_tree_export.argtypes = [ptr] * 6
    lib.lo_tree_free.restype = None
    lib.lo_tree_free.argtypes = [ptr]
    lib.lo_tree_predict.restype = None
    lib.lo_tree_predict.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, ptr]
    lib.lo_gb_residuals.restype = None
    lib.lo_gb_residuals.argtypes = [ptr, i64, i64, ptr, ptr]
    return lib


def _bind_sgd(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.lo_sgd_partial_fit.restype = c.c_int32
    lib.lo_sgd_partial_fit.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_int64,
        c.c_void_p, c.c_void_p, c.c_double, c.c_double]
    return lib


# name -> (ABI version, its symbol, binder)
_CORES: Dict[str, tuple] = {
    HGB: (1, "lo_hgb_abi_version", _bind_hgb),
    CSV: (1, "lo_csv_abi_version", _bind_csv),
    TREE: (1, "lo_tree_abi_version", _bind_tree),
    SGD: (1, "lo_sgd_abi_version", _bind_sgd),
}

_lock = locks.make_lock("native.registry")
_lib: Dict[str, ctypes.CDLL] = {}
_tried: Dict[str, bool] = {}
# the compiler's output of a failed build, per core
_errors: Dict[str, Optional[str]] = {}
# the cores' path counters (native/ops.py): op -> path -> [calls, rows]
_counts: Dict[str, Dict[str, list]] = {}


def source(name: str = HGB) -> Path:
    return CSRC / f"{name}.cpp"


def library_path(name: str = HGB) -> Path:
    digest = hashlib.sha256(source(name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_error(name: str = HGB) -> Optional[str]:
    """Why the core did not build, or None."""
    return _errors.get(name)


def build(name: str = HGB) -> Optional[Path]:
    """The compiled library, built first if it is not there; None (and
    :func:`build_error`) when the compiler is missing or fails."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                               str(source(name))], capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        _errors[name] = f"cannot run g++: {exc}"
        return None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        _errors[name] = f"g++ exited {proc.returncode}\n{proc.stderr}"
        return None
    os.replace(tmp, out)
    return out


def _load(name: str) -> Optional[ctypes.CDLL]:
    if shutil.which("g++") is None and not library_path(name).exists():
        _errors[name] = _NO_COMPILER
        return None
    path = build(name)
    if path is None:
        return None
    abi, symbol, bind = _CORES[name]
    try:
        lib = bind(ctypes.CDLL(str(path)))
        version = getattr(lib, symbol)()
    except (OSError, AttributeError) as exc:
        _errors[name] = f"cannot load {path}: {exc}"
        return None
    if version != abi:
        _errors[name] = f"{path}: ABI {version}, expected {abi}"
        return None
    _errors[name] = None
    return lib


def get_lib(name: str = HGB) -> Optional[ctypes.CDLL]:
    """The loaded core, built on the first call; None where it is turned
    off (``LO_NATIVE=0``) or no ``g++`` exists. Raises
    :class:`NativeBuildError` where ``g++`` exists and the core does not
    build or load. ``LO_NATIVE`` is read at every call."""
    if os.environ.get("LO_NATIVE", "1") == "0":
        return None
    if name not in _tried:
        with _lock:
            if name not in _tried:
                loaded = _load(name)
                if loaded is not None:
                    _lib[name] = loaded
                _tried[name] = True
    lib = _lib.get(name)
    error = _errors.get(name)
    if lib is None and error is not None and error != _NO_COMPILER:
        raise NativeBuildError(f"{name}: {error}")
    return lib


def count(op: str, path: str, rows: int) -> None:
    """One call of ``op`` over ``rows`` rows on ``path`` (``native`` or
    ``python``)."""
    with _lock:
        entry = _counts.setdefault(op, {}).setdefault(path, [0, 0])
        entry[0] += 1
        entry[1] += int(rows)


def counts() -> Dict[str, Dict[str, Dict[str, int]]]:
    """``{op: {path: {"calls", "rows"}}}`` since the last reset."""
    with _lock:
        return {op: {path: {"calls": c, "rows": r}
                     for path, (c, r) in paths.items()}
                for op, paths in _counts.items()}


def reset_counts() -> None:
    with _lock:
        _counts.clear()
