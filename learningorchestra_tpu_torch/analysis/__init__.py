"""Submit-time analysis, as the JAX package's ``analysis/`` runs it: the
AST lint the Function service runs at submit and the sandbox runs before
it executes code, the shape records (``resultShapes``) a function job
leaves on its metadata, and the preflight of model, execution and
builder specs (``check_model``, ``check_execution``, the footprint
estimate, its calibration and ``check_builder``, :mod:`.preflight`)."""

from learningorchestra_tpu_torch.analysis.findings import (  # noqa: F401
    Finding,
    LintRejected,
    SEVERITY_ERROR,
    SEVERITY_WARNING,
    error_findings,
    findings_to_dicts,
    warning_findings,
)
from learningorchestra_tpu_torch.analysis.code_lint import (  # noqa: F401
    DANGEROUS_DUNDERS,
    assert_code_safe,
    lint_code,
)
from learningorchestra_tpu_torch.analysis.preflight import (  # noqa: F401
    FOOTPRINT_FIELD,
    RESULT_SHAPES_FIELD,
    calibrate_footprint,
    check_builder,
    check_execution,
    check_model,
    estimate_footprint,
    lint_parameter_code,
    result_shapes,
)
