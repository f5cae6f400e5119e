"""The two parts of the JAX package's ``analysis/preflight.py`` that the
function route needs: the lint of ``#`` expressions inside a parameter
tree (:func:`lint_parameter_code`) and the shape record a function job
leaves on its metadata (:func:`result_shapes`). The shape engine and the
footprint estimate are not ported."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from learningorchestra_tpu_torch.analysis import code_lint
from learningorchestra_tpu_torch.analysis.findings import Finding

# metadata key under which a job records its result's array shapes
RESULT_SHAPES_FIELD = "resultShapes"


def result_shapes(obj: Any) -> Optional[Dict[str, Any]]:
    """``{key: {"shape": [...], "dtype": "float32"}}`` for a dict of
    arrays, ``{"": {...}}`` for a bare array, or None when the result has
    no static array shape. Values without one are skipped."""

    def one(v: Any) -> Optional[Dict[str, Any]]:
        shape = getattr(v, "shape", None)
        dtype = getattr(v, "dtype", None)
        if shape is None or dtype is None:
            return None
        try:
            return {"shape": [int(s) for s in shape],
                    "dtype": str(np.dtype(dtype))}
        except (TypeError, ValueError):
            return None

    if isinstance(obj, dict):
        out = {k: e for k, e in ((str(k), one(v))
                                 for k, v in obj.items()) if e}
        return out or None
    entry = one(obj)
    return {"": entry} if entry else None


def _is_hash_expr(value: Any) -> bool:
    # as ParameterResolver decides: '$' takes precedence over '#'
    return isinstance(value, str) and "$" not in value and "#" in value


def lint_parameter_code(parameters: Optional[Dict[str, Any]],
                        mode: str) -> List[Finding]:
    """The lint of every ``#`` expression in a parameter tree; each
    finding's location is the parameter's path."""
    findings: List[Finding] = []
    if not isinstance(parameters, dict):
        return findings

    def visit(value: Any, path: str) -> None:
        if isinstance(value, dict):
            for k, v in value.items():
                visit(v, f"{path}.{k}" if path else str(k))
        elif isinstance(value, list):
            for i, v in enumerate(value):
                visit(v, f"{path}[{i}]")
        elif _is_hash_expr(value):
            code = value.replace("#", "")
            for f in code_lint.lint_code(code, mode=mode,
                                         filename=f"<#{path}>"):
                findings.append(Finding(
                    f.severity, f.rule, path or f.location, f.message))

    visit(parameters, "")
    return findings
