"""The port's host-side C++ core: ``csrc/hgb_core.cpp``, its own copy of
the JAX package's histogram booster (``csrc/locore.cpp`` ``lo_hgb_*``).

The source is compiled with ``g++ -O3`` at first use, never at import,
into ``build/native/`` beside the package, under a name that carries a
hash of the source and the flags, so an edited source never loads a
stale library. Each process compiles to a file of its own
(``<name>.<pid>.tmp.so``) and moves it into place with ``os.replace``,
so builds racing in several processes (test workers) leave one whole
library. It is bound over its plain C interface with :mod:`ctypes`.
:func:`get_lib` returns None where no compiler exists or with
``LO_NATIVE=0``; callers then take their numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

from learningorchestra_tpu_torch.runtime import locks

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "hgb_core.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_ABI_VERSION = 1

_lock = locks.make_lock("native.registry")
_lib: Optional[ctypes.CDLL] = None
_tried = False
# the compiler's output of a failed build, for the caller that must know
BUILD_ERROR: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"hgb_core-{digest.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """The compiled library, built first if it is not there; None (and
    :data:`BUILD_ERROR`) when the compiler is missing or fails."""
    global BUILD_ERROR
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        BUILD_ERROR = f"cannot run g++: {exc}"
        return None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        BUILD_ERROR = f"g++ exited {proc.returncode}\n{proc.stderr}"
        return None
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.lo_hgb_abi_version.restype = c.c_int32
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


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded core, built on the first call; None where it cannot be
    built or is turned off (``LO_NATIVE=0``)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("LO_NATIVE", "1") == "0":
            return None
        path = build()
        if path is None:
            return None
        try:
            lib = _bind(ctypes.CDLL(str(path)))
        except (OSError, AttributeError):
            return None
        if lib.lo_hgb_abi_version() != _ABI_VERSION:
            return None
        _lib = lib
    return _lib
