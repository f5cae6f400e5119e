"""Builds the port's CUDA sources (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/kernels/`` (beside the package),
named by a hash of the source, every header under ``csrc/`` and the
flags so an edited source or header never loads a stale library, and is
loaded with :mod:`ctypes`. A source that
does not include PyTorch's headers builds in seconds; binding through
``torch.utils.cpp_extension`` would take minutes per build.

Nothing here runs at import: the CPU tests import every module of the
port, and the machine they run on has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -Xptxas=-v makes nvcc report each kernel's registers, shared memory
# and spills; build() keeps that report in BUILD_LOG
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

BUILD_LOG: Dict[str, str] = {}
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names (file stems) of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source (default: all) that has no library
    yet, one ``nvcc`` per source, all started together. Raises
    :class:`RuntimeError` with nvcc's stderr if any build fails."""
    names = list(names) if names is not None else sources()
    with _lock:
        running = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            try:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
            except OSError as exc:
                raise RuntimeError(
                    f"cannot run nvcc to build {name}: {exc}") from exc
            running[name] = (proc, tmp, out)
        errors = []
        for name, (proc, tmp, out) in running.items():
            stdout, stderr = proc.communicate()
            BUILD_LOG[name] = stdout + stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"{name}: nvcc exited {proc.returncode}\n"
                              f"{stderr}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build([name])[name]
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib
