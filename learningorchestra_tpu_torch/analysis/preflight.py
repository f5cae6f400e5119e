"""Pipeline preflight, as the JAX package's ``analysis/preflight.py``
runs it: before a model, execution or builder spec gets a job document
and the card lease, walk what the catalog knows about its parents and
try to *prove* the job would fail.

The shape engine is the port's own ``NeuralModel`` build at batch 1 on
``torch.device("meta")``: the layer stack the runtime builds
(``NeuralModel._new_module``) over the recorded input shape, and one
forward of a meta sample through it. Meta tensors carry shapes and
dtypes and no storage, so the check touches no card memory, and a
rejection is the job's own failure at submit time.

Prime rule: **no false rejections**. Whatever the engine cannot model
(an unknown artifact, no recorded shapes, a class other than
``NeuralModel``, an op without a meta kernel) is bypassed. Advisory
findings are stored on the job document.

Rules emitted here (the JAX package's ids):

- ``shape-mismatch``: error. The build fails on the recorded input
  shapes, a declared ``input`` layer contradicts the data, x and y
  sample counts disagree, or a layer config has no ``kind``.
- ``unknown-layer``: error. ``layer_configs`` names a layer kind the
  runtime refuses (proved by the build, not by a list).
- ``mesh-divisibility``: warning. A ``LanguageModel`` fit on the
  process group's mesh whose ``batch_size`` does not divide the mesh's
  data-parallel extent (the feed pads each step: wasted card work), or,
  with ring or Ulysses attention, whose windows' length does not divide
  ``sp`` (the fit then runs the whole sequence on every ``sp`` rank).
  The JAX package checks the batch of a ``NeuralModel`` fit, which it
  shards; the port shards the language model's fits alone.
- every code-lint rule, applied to ``#`` expressions among class and
  method parameters.

The footprint (:func:`estimate_footprint`) is the JAX heuristic: param
bytes times the optimizer multiplier plus two staged batches; XLA's
``memory_analysis`` has no counterpart here, so the static ``estimator``
is always ``"heuristic"``. Under ``LO_FOOTPRINT_CALIBRATE``
(:func:`calibrate_footprint`) a repeat execution prefers the peak device
bytes an earlier one measured (``torch.cuda.max_memory_allocated``,
``estimator: "measured-peak"``).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from learningorchestra_tpu_torch.analysis import code_lint
from learningorchestra_tpu_torch.analysis.findings import (
    Finding,
    SEVERITY_ERROR,
    SEVERITY_WARNING,
)
from learningorchestra_tpu_torch.catalog import documents as D

# metadata key under which a job records its result's array shapes
RESULT_SHAPES_FIELD = "resultShapes"

# metadata key under which an execution's estimated device footprint is
# recorded at submit time
FOOTPRINT_FIELD = "footprint"

# the module paths that name the keras-shaped model: the JAX package's
# maps by name to the port's (services/validators.py PORT_MODULES)
_NEURAL_MODULES = ("learningorchestra_tpu.models",
                   "learningorchestra_tpu_torch.models")
_NEURAL_CLASSES = ("NeuralModel",)
_DATA_METHODS = ("fit", "evaluate", "predict", "score")


class ShapeStruct(NamedTuple):
    """A recorded array's shape and dtype (``jax.ShapeDtypeStruct`` in
    the JAX package)."""

    shape: Tuple[int, ...]
    dtype: np.dtype


# ----------------------------------------------------------------------
# recording side: turn a live result into storable shape metadata
# ----------------------------------------------------------------------
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


def _ref_struct(catalog: Any, value: Any) -> Optional[ShapeStruct]:
    """``"$name"``/``"$name.key"`` -> the artifact's recorded shape and
    dtype (``resultShapes``), else None (bypass)."""
    if not isinstance(value, str) or "$" not in value:
        return None
    ref = value.replace("$", "")
    name, key = (ref.split(".", 1) if "." in ref else (ref, ""))
    try:
        meta = catalog.get_metadata(name)
    except Exception:  # noqa: BLE001 — catalog unavailable: bypass
        return None
    shapes = (meta or {}).get(RESULT_SHAPES_FIELD)
    if not isinstance(shapes, dict):
        return None
    entry = shapes.get(key)
    if not isinstance(entry, dict):
        return None
    try:
        return ShapeStruct(tuple(int(s) for s in entry["shape"]),
                           np.dtype(entry["dtype"]))
    except Exception:  # noqa: BLE001 — malformed record: bypass
        return None


# ----------------------------------------------------------------------
# '#' expressions in parameter trees
# ----------------------------------------------------------------------
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


# ----------------------------------------------------------------------
# shape engine
# ----------------------------------------------------------------------
def _neural_spec(module_path: Any, class_name: Any,
                 class_parameters: Any) -> Optional[List[Any]]:
    """The layer_configs list iff this spec is a modelable
    NeuralModel; None -> bypass."""
    if module_path not in _NEURAL_MODULES or \
            class_name not in _NEURAL_CLASSES:
        return None
    if not isinstance(class_parameters, dict):
        return None
    configs = class_parameters.get("layer_configs")
    if not isinstance(configs, list) or not configs:
        return None
    return configs


def _config_findings(configs: List[Any]) -> List[Finding]:
    """Structural checks that need no shape: every layer config must be
    a dict with a string ``kind`` (the runtime reads it
    unconditionally)."""
    findings = []
    for i, cfg in enumerate(configs):
        loc = f"classParameters.layer_configs[{i}]"
        if not isinstance(cfg, dict):
            findings.append(Finding(
                SEVERITY_ERROR, "shape-mismatch", loc,
                f"layer config must be a dict, got "
                f"{type(cfg).__name__}"))
        elif not isinstance(cfg.get("kind"), str):
            findings.append(Finding(
                SEVERITY_ERROR, "shape-mismatch", loc,
                "layer config has no 'kind' string"))
    return findings


def _declared_input_shape(configs: List[Any]) -> Optional[Tuple[int, ...]]:
    first = configs[0] if isinstance(configs[0], dict) else {}
    if first.get("kind") == "input":
        shape = first.get("shape") or first.get("input_shape")
        if isinstance(shape, (list, tuple)) and shape and \
                all(isinstance(s, int) for s in shape):
            return tuple(shape)
    return None


def _trace_init(configs: List[Any], x_struct: ShapeStruct,
                ) -> Tuple[Optional[Dict[str, Tuple]], Optional[str]]:
    """Builds the runtime's layer stack on the meta device over
    ``x_struct``'s per-sample shape and runs one batch-1 forward: returns
    ``({name: (shape, dtype)} of every param and statistic, None)`` or
    ``(None, error message)``. ``(None, None)`` means "could not model"
    (bypass)."""
    import torch

    from learningorchestra_tpu_torch.models import \
        sequential_module as seq_lib

    first = configs[0] if isinstance(configs[0], dict) else {}
    # the input dtype NeuralModel._coerce_x feeds the stack
    dtype = torch.int64 if first.get("kind") == "embedding" \
        else torch.float32
    per_sample = tuple(x_struct.shape[1:])
    try:
        with torch.device("meta"):
            module = seq_lib.SequentialModule(list(configs), per_sample)
            module(torch.empty((1,) + per_sample, dtype=dtype),
                   train=False)
    except NotImplementedError:
        return None, None  # an op without a meta kernel: bypass
    except (ValueError, TypeError, KeyError, IndexError,
            RuntimeError) as e:
        if "meta" in str(e).lower():
            return None, None  # the engine's own limit, not the job's
        # the stack the runtime builds fails on this input: this
        # failure IS the job's failure, surfaced at submit time
        return None, str(e)
    except Exception:  # noqa: BLE001 — analyzer limitation: bypass
        return None, None
    return {name: (tuple(t.shape), t.dtype)
            for name, t in module.state_dict().items()}, None


def check_model(module_path: Any, class_name: Any,
                class_parameters: Any,
                mode: str = "subprocess") -> List[Finding]:
    """Preflight a model spec at registration: lint embedded ``#`` code
    and, for NeuralModel specs, validate the layer stack (fully, by the
    meta build, when an ``input`` layer declares the feature shape)."""
    findings = lint_parameter_code(
        class_parameters if isinstance(class_parameters, dict) else None,
        mode)
    configs = _neural_spec(module_path, class_name, class_parameters)
    if configs is None:
        return findings
    findings.extend(_config_findings(configs))
    if any(f.severity == SEVERITY_ERROR for f in findings):
        return findings
    declared = _declared_input_shape(configs)
    if declared is not None:
        x_struct = ShapeStruct((1,) + declared, np.dtype(np.float32))
        _, err = _trace_init(configs, x_struct)
        if err is not None:
            rule = ("unknown-layer" if "unknown layer kind" in err
                    else "shape-mismatch")
            findings.append(Finding(
                SEVERITY_ERROR, rule, "classParameters.layer_configs",
                f"layer stack cannot initialize on declared input "
                f"shape {declared}: {err}"))
    return findings


def check_execution(catalog: Any, root_meta: Optional[Dict[str, Any]],
                    method: Any, method_parameters: Any,
                    mode: str = "subprocess") -> List[Finding]:
    """Preflight an execution spec at submit time.

    ``root_meta`` is the root model's metadata document. Shape checks
    fire only for NeuralModel roots whose x/y parameters resolve to
    artifacts with recorded ``resultShapes``; everything else bypasses.
    """
    findings = lint_parameter_code(
        method_parameters if isinstance(method_parameters, dict) else None,
        mode)
    if not isinstance(method_parameters, dict) or \
            not isinstance(root_meta, dict) or method not in _DATA_METHODS:
        return findings
    if method == "fit":
        findings += _mesh_findings(catalog, root_meta, method_parameters)
    configs = _neural_spec(root_meta.get(D.MODULE_PATH_FIELD),
                           root_meta.get(D.CLASS_FIELD),
                           root_meta.get(D.CLASS_PARAMETERS_FIELD))
    if configs is None:
        return findings
    struct_errs = _config_findings(configs)
    if struct_errs:
        # the model document exists already; stop the execution too,
        # before its job document does
        return findings + struct_errs

    x_struct = _ref_struct(catalog, method_parameters.get("x"))
    y_struct = _ref_struct(catalog, method_parameters.get("y"))

    if method == "fit" and x_struct is not None and \
            y_struct is not None and x_struct.shape and y_struct.shape \
            and x_struct.shape[0] != y_struct.shape[0]:
        findings.append(Finding(
            SEVERITY_ERROR, "shape-mismatch", "methodParameters.y",
            f"x has {x_struct.shape[0]} samples but y has "
            f"{y_struct.shape[0]}"))

    if x_struct is not None and len(x_struct.shape) >= 2:
        declared = _declared_input_shape(configs)
        if declared is not None and tuple(x_struct.shape[1:]) != declared:
            findings.append(Finding(
                SEVERITY_ERROR, "shape-mismatch", "methodParameters.x",
                f"model declares input shape {declared} but x is "
                f"{tuple(x_struct.shape[1:])} per sample"))
        else:
            _, err = _trace_init(configs, x_struct)
            if err is not None:
                rule = ("unknown-layer" if "unknown layer kind" in err
                        else "shape-mismatch")
                findings.append(Finding(
                    SEVERITY_ERROR, rule, "methodParameters.x",
                    f"layer stack cannot initialize on x of shape "
                    f"{tuple(x_struct.shape)}: {err}"))
    return findings


def _mesh_findings(catalog: Any, root_meta: Dict[str, Any],
                   method_parameters: Dict[str, Any]) -> List[Finding]:
    """``mesh-divisibility`` of a ``LanguageModel`` fit on the default
    mesh (a process of its own has a mesh of one rank: nothing fires)."""
    if root_meta.get(D.CLASS_FIELD) != "LanguageModel":
        return []
    try:
        from learningorchestra_tpu_torch.runtime import mesh as mesh_lib

        mesh = mesh_lib.get_default_mesh()
    except Exception:  # noqa: BLE001 — no mesh formed: bypass
        return []
    out = []
    dp = mesh_lib.data_parallel_size(mesh)
    batch = method_parameters.get("batch_size")
    if isinstance(batch, int) and batch > 0 and batch % dp:
        out.append(Finding(
            SEVERITY_WARNING, "mesh-divisibility",
            "methodParameters.batch_size",
            f"batch_size={batch} is not a multiple of the mesh's "
            f"data-parallel extent {dp}; the feed will zero-pad each "
            f"step (wasted accelerator work)"))
    sp = mesh.shape.get(mesh_lib.SP, 1)
    params = root_meta.get(D.CLASS_PARAMETERS_FIELD) or {}
    x_struct = _ref_struct(catalog, method_parameters.get("x"))
    if sp > 1 and params.get("attention") in ("ring", "ulysses") and \
            x_struct is not None and len(x_struct.shape) == 2 and \
            x_struct.shape[1] % sp:
        out.append(Finding(
            SEVERITY_WARNING, "mesh-divisibility", "methodParameters.x",
            f"windows of {x_struct.shape[1]} tokens do not divide into "
            f"sp={sp} blocks; {params['attention']} attention falls back "
            f"to the whole sequence on every sp rank"))
    return out


# ----------------------------------------------------------------------
# footprint estimation
# ----------------------------------------------------------------------
# params + grads + two adam moments all live on the device during a fit
_OPTIMIZER_MULTIPLIER = 4


def estimate_footprint(catalog: Any,
                       root_meta: Optional[Dict[str, Any]],
                       method: Any,
                       method_parameters: Any) -> Optional[Dict[str, Any]]:
    """Best-effort device footprint of a NeuralModel data method:
    ``{"hbmBytes", "paramBytes", "estimator": "heuristic"}``, param
    bytes times the optimizer multiplier plus two staged batches. None
    for anything unmodelable; never wrong, possibly absent."""
    if method not in _DATA_METHODS or \
            not isinstance(method_parameters, dict) or \
            not isinstance(root_meta, dict):
        return None
    configs = _neural_spec(root_meta.get(D.MODULE_PATH_FIELD),
                           root_meta.get(D.CLASS_FIELD),
                           root_meta.get(D.CLASS_PARAMETERS_FIELD))
    if configs is None:
        return None
    x_struct = _ref_struct(catalog, method_parameters.get("x"))
    if x_struct is None or len(x_struct.shape) < 2:
        return None
    shapes, _ = _trace_init(configs, x_struct)
    if shapes is None:
        return None
    param_bytes = sum(int(np.prod(shape) or 1) * dtype.itemsize
                      for shape, dtype in shapes.values())
    batch = method_parameters.get("batch_size")
    if not isinstance(batch, int) or batch <= 0:
        from learningorchestra_tpu_torch.config import Config

        batch = Config().default_batch_size
    feature_bytes = int(np.prod(x_struct.shape[1:]) or 1) * \
        x_struct.dtype.itemsize
    estimate = param_bytes * _OPTIMIZER_MULTIPLIER \
        + 2 * batch * feature_bytes
    return {"hbmBytes": int(estimate), "paramBytes": int(param_bytes),
            "estimator": "heuristic"}


def calibrate_footprint(footprint: Dict[str, Any],
                        root_meta: Optional[Dict[str, Any]], method: Any,
                        config: Any) -> None:
    """Closed-loop footprint calibration (``LO_FOOTPRINT_CALIBRATE``, the
    JAX package's ``ExecutionService._calibrate``): stamps the footprint's
    ``calibrationKey`` (``{model}:{method}``, where the job records its
    measured peak device bytes) and, when an earlier execution of the
    same key measured one, prefers it — padded by
    ``LO_FOOTPRINT_MARGIN``, clamped to one order of magnitude around
    the static estimate — over the heuristic (``estimator:
    "measured-peak"``, the estimate kept as ``estimatedHbmBytes``)."""
    if not getattr(config, "footprint_calibrate", False) or \
            not isinstance(root_meta, dict):
        return
    from learningorchestra_tpu_torch.observability import monitor

    key = f"{root_meta.get(D.NAME_FIELD)}:{method}"
    footprint["calibrationKey"] = key
    estimate = footprint.get("hbmBytes")
    measured = monitor.measured_peak(key)
    if not measured or not estimate:
        return
    footprint["estimatedHbmBytes"] = int(estimate)
    footprint["hbmBytes"] = monitor.calibrated_hbm_bytes(
        measured, int(estimate),
        float(getattr(config, "footprint_margin", 1.25)))
    footprint["estimator"] = "measured-peak"


def check_builder(modeling_code: Any,
                  mode: str = "subprocess") -> List[Finding]:
    """Preflight a builder spec: its ``modelingCode`` runs in the
    sandbox, so it gets the full code lint."""
    if not isinstance(modeling_code, str):
        return []
    return code_lint.lint_code(modeling_code, mode=mode,
                               filename="<modelingCode>")
