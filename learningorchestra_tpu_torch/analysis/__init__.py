"""Submit-time analysis of user code: the AST lint the Function service
runs at submit and the sandbox runs before it executes code, and the
shape records (``resultShapes``) a function job leaves on its metadata.
The JAX package's model preflight (``check_model``, the footprint
estimate) is not ported."""

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
    RESULT_SHAPES_FIELD,
    lint_parameter_code,
    result_shapes,
)
