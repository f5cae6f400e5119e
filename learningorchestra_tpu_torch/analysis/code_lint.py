"""AST safety lint of user code: Function bodies and ``#`` expressions,
screened before any ``exec`` (the JAX package's ``analysis/code_lint.py``
over the port's sandbox whitelist).

Rules (the JAX package's ids):

- ``syntax-error``: the code does not parse. An error in every mode.
- ``forbidden-import``: an import outside the sandbox's module
  whitelist (``tensorflow`` and ``keras`` are in it: the sandbox maps
  them to the port's shim), or a relative import. An error under
  ``subprocess`` and ``restricted``, where the runtime refuses it too; a
  warning under ``trusted``.
- ``forbidden-call``: a call of an exec-family builtin the sandbox
  withholds (``eval``, ``exec``, ``open``, ...). The same mode policy.
- ``dunder-attribute``: attribute traversal through an escape-capable
  dunder (``__class__``, ``__subclasses__``, ...). An error in every mode.
- ``dunder-string-smuggle``: the same dunders as constant strings given
  to ``getattr``/``setattr``/``delattr``. An error in every mode; names
  built at run time meet the sandbox's guarded builtins.

The JAX package's two rules about JAX code (``tpu-sync-in-loop`` on
``.block_until_ready()`` in a loop, ``tpu-traced-branch`` on a Python
branch over an argument of a jitted function) are left out: the port's
sandbox refuses ``import jax``, so they could never fire. Anything the
lint cannot model is let through, never refused.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from learningorchestra_tpu_torch.analysis.findings import (
    Finding,
    LintRejected,
    SEVERITY_ERROR,
    SEVERITY_WARNING,
    error_findings,
)
from learningorchestra_tpu_torch.services.sandbox import (
    DANGEROUS_DUNDERS,
    module_allowed,
)

# exec-family builtins the sandbox withholds
_FORBIDDEN_CALLS = frozenset({
    "eval", "exec", "__import__", "open", "compile", "globals",
    "locals", "breakpoint", "input",
})

# getattr/setattr/delattr can smuggle a dunder as a string
_ATTR_SMUGGLERS = frozenset({"getattr", "setattr", "delattr"})


def _refusal(name: str, verb: str) -> Optional[str]:
    """Why importing ``name`` is refused, or None when it is allowed."""
    if module_allowed(name):
        return None
    return f"{verb} {name!r} is outside the sandbox module whitelist"


class _Walker(ast.NodeVisitor):
    def __init__(self, blocking_severity: str):
        self.findings: List[Finding] = []
        # severity of forbidden-import/forbidden-call in this mode
        self._blocking = blocking_severity

    def _add(self, severity: str, rule: str, node: ast.AST,
             message: str) -> None:
        loc = f"line {getattr(node, 'lineno', '?')}:" \
              f"{getattr(node, 'col_offset', '?')}"
        self.findings.append(Finding(severity, rule, loc, message))

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            why = _refusal(alias.name, "import of")
            if why:
                self._add(self._blocking, "forbidden-import", node, why)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level != 0:
            self._add(self._blocking, "forbidden-import", node,
                      "relative imports are not allowed in sandboxed "
                      "code")
        elif node.module:
            why = _refusal(node.module, "import from")
            if why:
                self._add(self._blocking, "forbidden-import", node, why)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Name):
            if func.id in _FORBIDDEN_CALLS:
                self._add(self._blocking, "forbidden-call", node,
                          f"call to {func.id}() is not available in "
                          f"sandboxed code")
            if func.id in _ATTR_SMUGGLERS and len(node.args) >= 2:
                name_arg = node.args[1]
                if isinstance(name_arg, ast.Constant) and \
                        isinstance(name_arg.value, str) and \
                        name_arg.value in DANGEROUS_DUNDERS:
                    self._add(SEVERITY_ERROR, "dunder-string-smuggle",
                              node, f"{func.id}(..., {name_arg.value!r}) "
                              f"smuggles an escape-capable dunder "
                              f"attribute by name")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr in DANGEROUS_DUNDERS:
            self._add(SEVERITY_ERROR, "dunder-attribute", node,
                      f"attribute access .{node.attr} reaches "
                      f"interpreter internals and is refused in user "
                      f"code")
        self.generic_visit(node)


def lint_code(code: str, mode: str = "subprocess",
              filename: str = "<user-code>") -> List[Finding]:
    """Every finding of ``code`` under sandbox trust level ``mode``
    (``subprocess``, ``restricted`` or ``trusted``); a parse failure is
    itself a finding, never an exception."""
    try:
        tree = ast.parse(code, filename=filename)
    except SyntaxError as e:
        loc = f"line {e.lineno or '?'}:{(e.offset or 1) - 1}"
        return [Finding(SEVERITY_ERROR, "syntax-error", loc,
                        f"code does not parse: {e.msg}")]
    # trusted mode imports and calls anything, so those only warn there;
    # dunder traversal stays an error in every mode
    blocking = SEVERITY_WARNING if mode == "trusted" else SEVERITY_ERROR
    walker = _Walker(blocking_severity=blocking)
    walker.visit(tree)
    return walker.findings


def assert_code_safe(code: str, mode: str,
                     filename: str = "<user-code>") -> List[Finding]:
    """Raises :class:`LintRejected` on any error finding; else returns
    the warnings."""
    findings = lint_code(code, mode=mode, filename=filename)
    if error_findings(findings):
        raise LintRejected(findings)
    return findings
