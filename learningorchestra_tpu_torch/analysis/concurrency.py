"""Concurrency static analysis over the port's own source (the port's
copy of the JAX package's ``analysis/concurrency.py``, with the same
rules and the same waiver syntax).

The code lint checks user code; this pass checks ours. It makes the
port's cross-thread invariants — "callback runs with the cv released",
"listeners called outside the lock" — machine-checked properties, the
static half of the lock witness in
:mod:`learningorchestra_tpu_torch.runtime.locks`:

- ``undeclared-lock`` — a module-level ``threading.Lock()`` /
  ``RLock()`` / ``Condition()`` created anonymously instead of through
  the named, ranked ``locks.make_*`` factories. Anonymous locks are
  invisible to both the hierarchy and the runtime witness.
- ``unregistered-lock`` — a ``locks.make_*`` call whose name is not a
  string literal or is missing from ``locks.HIERARCHY``.
- ``lock-order`` — a static acquisition edge (B acquired while A is
  held, via ``with`` nesting or a same-module call chain) that
  contradicts the declared ranks.
- ``lock-cycle`` — a cycle in the acquisition graph (the AB/BA
  deadlock shape) not already reported edge-by-edge as ``lock-order``.
- ``blocking-under-lock`` — a blocking operation inside a ``with``
  -lock body: ``cv.wait`` on a *different* lock than the one held,
  ``future.result``, queue get/join, ``time.sleep``, socket/HTTP
  calls, and the torch calls that wait on the card
  (``torch.cuda.synchronize``, a stream's or an event's
  ``synchronize``, ``.item()`` and ``.cpu()``).
- ``callback-under-lock`` — invoking a stored callable (a listener
  iterated out of an attribute collection, or an attribute named like
  a callback) while holding a lock — the invariants otherwise checked
  by hand.

Scope & honesty: the pass resolves ``with`` targets that are module
globals or ``self.<attr>`` locks of the same class, and follows call
edges within one module (bare-name functions and ``self.method``).
Cross-module acquisition orders (e.g. the SLO watchdog firing an
incident trigger under its alert lock) are the runtime witness's job.
Anything unresolvable is permitted, never guessed at.

Waivers: a finding is downgraded to an advisory warning when the
flagged line (or the line above it) carries
``# lo-conc: waive(<rule-id>) — <reason>``. A bare waiver with no
reason still waives, and says so in the finding.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from learningorchestra_tpu_torch.analysis.findings import (
    Finding,
    SEVERITY_ERROR,
    SEVERITY_WARNING,
)
from learningorchestra_tpu_torch.runtime.locks import HIERARCHY

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
PACKAGE = REPO / "learningorchestra_tpu_torch"

RULE_UNDECLARED = "undeclared-lock"
RULE_UNREGISTERED = "unregistered-lock"
RULE_ORDER = "lock-order"
RULE_CYCLE = "lock-cycle"
RULE_BLOCKING = "blocking-under-lock"
RULE_CALLBACK = "callback-under-lock"

_LOCK_CTORS = frozenset({"Lock", "RLock", "Condition"})
_LOCK_FACTORIES = frozenset({
    "make_lock", "make_rlock", "make_condition",
    "witness_lock", "witness_rlock", "witness_condition",
    "WitnessLock", "WitnessRLock", "WitnessCondition",
})
# methods that wait for the card: torch.cuda.synchronize(), a stream's
# or an event's .synchronize(), and the copies to the host that wait for
# every queued kernel
_DEVICE_WAITS = frozenset({"synchronize", "item", "cpu"})
# attribute names that read as a stored callback/listener
_CALLBACK_ATTR = re.compile(
    r"(^on_[a-z]|_cb$|callback|listener|hook)", re.IGNORECASE)
_WAIVE = re.compile(r"#\s*lo-conc:\s*waive\(([a-z-]+)\)(.*)")

_SOCKET_ROOTS = frozenset({"requests", "socket", "urllib", "http"})
_SOCKET_METHODS = frozenset({"recv", "accept", "connect", "sendall",
                             "urlopen"})


def _ctor_kind(call: ast.Call) -> Optional[str]:
    """'anonymous' for threading.Lock()/RLock()/Condition(), 'factory'
    for a locks.make_* call, None otherwise."""
    func = call.func
    if isinstance(func, ast.Attribute):
        if func.attr in _LOCK_CTORS and \
                isinstance(func.value, ast.Name) and \
                func.value.id == "threading":
            return "anonymous"
        if func.attr in _LOCK_FACTORIES:
            return "factory"
    elif isinstance(func, ast.Name):
        if func.id in _LOCK_FACTORIES:
            return "factory"
        if func.id in _LOCK_CTORS:
            # `from threading import Lock` style
            return "anonymous"
    return None


def _factory_name(call: ast.Call) -> Optional[str]:
    """The declared lock name of a factory call, if it is a string
    literal."""
    if call.args and isinstance(call.args[0], ast.Constant) and \
            isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def _root_name(node: ast.expr) -> Optional[str]:
    """Leftmost Name of an attribute chain (``a.b.c`` -> ``a``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _expr_key(node: ast.expr) -> Optional[str]:
    """Stable string for lock-receiver comparison: ``_lock``,
    ``self._cv`` — one attribute hop at most."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name):
        return f"{node.value.id}.{node.attr}"
    return None


class _ModuleAnalysis:
    """Single-module pass: lock bindings, per-function acquisition
    summaries, intra-module call edges, and the local findings."""

    def __init__(self, code: str, modname: str, path: str,
                 hierarchy: Dict[str, int]):
        self.modname = modname
        self.path = path
        self.hierarchy = hierarchy
        self.lines = code.splitlines()
        self.findings: List[Finding] = []
        # binding tables: "var" / "Class.attr" -> lock name
        self.module_locks: Dict[str, str] = {}
        self.class_locks: Dict[str, str] = {}
        # graph evidence: (held, acquired) -> first lineno
        self.edges: Dict[Tuple[str, str], int] = {}
        # interprocedural: function key -> summary
        self.fn_direct: Dict[str, Set[str]] = {}
        self.fn_calls: Dict[str, Set[str]] = {}
        # call sites under lock: (held tuple, callee key, lineno)
        self.locked_calls: List[Tuple[Tuple[str, ...], str, int]] = []
        try:
            self.tree: Optional[ast.AST] = ast.parse(
                code, filename=path)
        except SyntaxError as e:
            self.tree = None
            self._add(SEVERITY_ERROR, "syntax-error", e.lineno or 0,
                      f"does not parse: {e.msg}")

    # -- helpers -------------------------------------------------------
    def _add(self, severity: str, rule: str, lineno: int,
             message: str) -> None:
        severity, message = self._apply_waiver(severity, rule, lineno,
                                               message)
        self.findings.append(Finding(
            severity, rule, f"{self.path}:{lineno}", message))

    def _apply_waiver(self, severity: str, rule: str, lineno: int,
                      message: str) -> Tuple[str, str]:
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(self.lines):
                m = _WAIVE.search(self.lines[ln - 1])
                if m and m.group(1) == rule:
                    reason = m.group(2).strip(" —-")
                    return SEVERITY_WARNING, (
                        f"waived ({reason or 'no reason given'}): "
                        f"{message}")
        return severity, message

    def _synthetic(self, key: str) -> str:
        return f"{self.modname}:{key}"

    # -- pass 1: lock bindings ----------------------------------------
    def collect_bindings(self) -> None:
        if self.tree is None:
            return
        for node in self.tree.body:
            self._module_binding(node)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                self._class_bindings(node)

    def _bind_value(self, call: ast.Call, key: str, lineno: int,
                    module_level: bool) -> None:
        kind = _ctor_kind(call)
        if kind == "factory":
            name = _factory_name(call)
            if name is None:
                self._add(SEVERITY_ERROR, RULE_UNREGISTERED, lineno,
                          f"lock factory call binding {key!r} must "
                          f"pass a string-literal name")
                name = self._synthetic(key)
            elif name not in self.hierarchy:
                self._add(SEVERITY_ERROR, RULE_UNREGISTERED, lineno,
                          f"lock name {name!r} is not declared in "
                          f"runtime/locks.py HIERARCHY")
            self._register(key, name)
        elif kind == "anonymous":
            if module_level:
                self._add(SEVERITY_ERROR, RULE_UNDECLARED, lineno,
                          f"module-level lock {key!r} is anonymous — "
                          f"create it with locks.make_lock/"
                          f"make_rlock/make_condition so it carries a "
                          f"declared (name, rank)")
            self._register(key, self._synthetic(key))

    def _register(self, key: str, name: str) -> None:
        if "." in key:
            self.class_locks[key] = name
        else:
            self.module_locks[key] = name

    def _module_binding(self, node: ast.stmt) -> None:
        if not isinstance(node, ast.Assign) or \
                not isinstance(node.value, ast.Call):
            return
        for target in node.targets:
            if not isinstance(target, ast.Name):
                continue
            self._bind_value(node.value, target.id, node.lineno,
                             module_level=True)

    def _class_bindings(self, cls: ast.ClassDef) -> None:
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign) or \
                    not isinstance(node.value, ast.Call):
                continue
            for target in node.targets:
                if isinstance(target, ast.Attribute) and \
                        isinstance(target.value, ast.Name) and \
                        target.value.id == "self":
                    key = f"{cls.name}.{target.attr}"
                    self._bind_value(node.value, key, node.lineno,
                                     module_level=False)

    # -- pass 2: per-function walks -----------------------------------
    def walk_functions(self) -> None:
        if self.tree is None:
            return
        self._walk_body(self.tree.body, cls=None)

    def _walk_body(self, body: Iterable[ast.stmt],
                   cls: Optional[str]) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                self._walk_body(node.body, cls=node.name)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                key = f"{cls}.{node.name}" if cls else node.name
                walker = _FunctionWalker(self, cls, key)
                walker.walk(node)
                self.fn_direct[key] = walker.acquired
                self.fn_calls[key] = walker.callees

    def resolve_with_target(self, expr: ast.expr,
                            cls: Optional[str]) -> Optional[str]:
        """Lock name for a ``with`` target, or None if unresolvable."""
        if isinstance(expr, ast.Name):
            return self.module_locks.get(expr.id)
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and cls is not None:
            return self.class_locks.get(f"{cls}.{expr.attr}")
        return None

    # -- pass 3/4: interprocedural closure + rank/cycle checks ---------
    def close_over_calls(self) -> None:
        """Fixed point of transitively-acquired locks per function,
        then turn every locked call site into acquisition edges."""
        closure: Dict[str, Set[str]] = {
            k: set(v) for k, v in self.fn_direct.items()}
        changed = True
        while changed:
            changed = False
            for fn, callees in self.fn_calls.items():
                acc = closure.setdefault(fn, set())
                for callee in callees:
                    extra = closure.get(callee)
                    if extra and not extra <= acc:
                        acc |= extra
                        changed = True
        for held, callee, lineno in self.locked_calls:
            for inner in closure.get(callee, ()):
                for outer in held:
                    if outer != inner:
                        self.edges.setdefault((outer, inner), lineno)

    def check_edges(self) -> Set[Tuple[str, str]]:
        """Rank-check every acquisition edge; returns the flagged
        set so the cycle pass can skip already-reported pairs."""
        flagged: Set[Tuple[str, str]] = set()
        for (outer, inner), lineno in sorted(
                self.edges.items(), key=lambda kv: kv[1]):
            r_out = self.hierarchy.get(outer)
            r_in = self.hierarchy.get(inner)
            if r_out is None or r_in is None:
                continue
            if r_in <= r_out:
                flagged.add((outer, inner))
                self._add(
                    SEVERITY_ERROR, RULE_ORDER, lineno,
                    f"acquires {inner!r} (rank {r_in}) while holding "
                    f"{outer!r} (rank {r_out}) — contradicts the "
                    f"declared hierarchy (runtime/locks.py)")
        return flagged


class _FunctionWalker(ast.NodeVisitor):
    """One function/method: tracks the ``with``-lock stack, records
    acquisition edges, locked call sites, and the blocking/callback
    findings."""

    def __init__(self, mod: _ModuleAnalysis, cls: Optional[str],
                 fn_key: str):
        self.mod = mod
        self.cls = cls
        self.fn_key = fn_key
        self.held: List[str] = []          # lock names, outer->inner
        self.held_exprs: List[str] = []    # matching receiver keys
        self.acquired: Set[str] = set()
        self.callees: Set[str] = set()
        # loop vars iterating attribute collections (stored callables)
        self.iter_vars: Set[str] = set()

    def walk(self, node: ast.AST) -> None:
        for stmt in getattr(node, "body", []):
            self.visit(stmt)

    # nested defs get their own summaries via _walk_body? No — nested
    # functions are rare and close over the enclosing state; analyze
    # them inline under the current held stack (conservative for
    # immediately-invoked helpers, silent for stored closures).

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            name = self.mod.resolve_with_target(item.context_expr,
                                                self.cls)
            if name is None:
                continue
            for outer in self.held:
                if outer != name:
                    self.mod.edges.setdefault((outer, name),
                                              node.lineno)
            self.held.append(name)
            self.held_exprs.append(
                _expr_key(item.context_expr) or "")
            self.acquired.add(name)
            pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.held.pop()
            self.held_exprs.pop()

    def visit_For(self, node: ast.For) -> None:
        if isinstance(node.target, ast.Name) and \
                self._iters_stored_callables(node.iter):
            self.iter_vars.add(node.target.id)
        self.generic_visit(node)

    @staticmethod
    def _iters_stored_callables(expr: ast.expr) -> bool:
        # `for cb in self._listeners:` / `for cb in list(_hooks):`
        if isinstance(expr, ast.Call) and expr.args:
            expr = expr.args[0]
        return isinstance(expr, (ast.Attribute, ast.Name)) and \
            bool(_CALLBACK_ATTR.search(
                expr.attr if isinstance(expr, ast.Attribute)
                else expr.id))

    def visit_Call(self, node: ast.Call) -> None:
        if self.held:
            self._check_blocking(node)
            self._check_callback(node)
            self._note_callee(node)
        self.generic_visit(node)

    def _flag(self, rule: str, node: ast.Call, what: str) -> None:
        self.mod._add(
            SEVERITY_ERROR, rule, node.lineno,
            f"{what} while holding {self.held[-1]!r}"
            + (f" (held: {self.held})" if len(self.held) > 1 else ""))

    # -- blocking-under-lock -------------------------------------------
    def _check_blocking(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Name):
            if func.id in ("sleep", "urlopen"):
                self._flag(RULE_BLOCKING, node,
                           f"blocking {func.id}() call")
            return
        if not isinstance(func, ast.Attribute):
            return
        attr, recv = func.attr, func.value
        recv_key = _expr_key(recv)
        root = _root_name(recv)
        if attr == "sleep" and root == "time":
            self._flag(RULE_BLOCKING, node, "time.sleep()")
        elif attr in ("wait", "wait_for"):
            # waiting on the innermost held cv RELEASES it — the one
            # legal pattern, but only when no OTHER lock is held
            if recv_key and recv_key == self.held_exprs[-1]:
                if len(self.held) > 1:
                    self.mod._add(
                        SEVERITY_ERROR, RULE_BLOCKING, node.lineno,
                        f"cv.wait on {recv_key!r} releases only the "
                        f"innermost lock; outer "
                        f"{self.held[:-1]} stay held across the wait")
            else:
                self._flag(RULE_BLOCKING, node,
                           f"blocking .{attr}() on {recv_key or '?'}")
        elif attr == "result":
            self._flag(RULE_BLOCKING, node,
                       "future .result() blocks until completion")
        elif attr in _DEVICE_WAITS and not node.args:
            self._flag(RULE_BLOCKING, node,
                       f".{attr}() waits for the card")
        elif attr in ("get", "join") and recv_key and \
                "queue" in recv_key.lower():
            self._flag(RULE_BLOCKING, node,
                       f"queue .{attr}() can block indefinitely")
        elif attr == "join" and recv_key and any(
                h in recv_key.lower() for h in ("thread", "worker")):
            self._flag(RULE_BLOCKING, node,
                       f"thread join on {recv_key!r}")
        elif root in _SOCKET_ROOTS or attr in _SOCKET_METHODS:
            self._flag(RULE_BLOCKING, node,
                       f"network/socket call .{attr}()")

    # -- callback-under-lock -------------------------------------------
    def _check_callback(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Name) and func.id in self.iter_vars:
            self._flag(RULE_CALLBACK, node,
                       f"invoking stored callable {func.id!r} "
                       f"(iterated from a listener collection)")
        elif isinstance(func, ast.Attribute) and \
                _CALLBACK_ATTR.search(func.attr):
            self._flag(RULE_CALLBACK, node,
                       f"invoking stored callback .{func.attr}()")

    # -- call-graph edges ----------------------------------------------
    def _note_callee(self, node: ast.Call) -> None:
        func = node.func
        key: Optional[str] = None
        if isinstance(func, ast.Name):
            key = func.id
        elif isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and \
                func.value.id == "self" and self.cls:
            key = f"{self.cls}.{func.attr}"
        if key is not None:
            self.callees.add(key)
            self.mod.locked_calls.append(
                (tuple(self.held), key, node.lineno))


# ----------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------
def analyze_source(code: str, modname: str = "<module>",
                   path: str = "<memory>",
                   hierarchy: Optional[Dict[str, int]] = None,
                   ) -> List[Finding]:
    """Analyze one module's source. ``hierarchy`` defaults to the port's
    registry; tests pass their own to exercise rank rules."""
    mod = _ModuleAnalysis(code, modname, path,
                          HIERARCHY if hierarchy is None else hierarchy)
    mod.collect_bindings()
    mod.walk_functions()
    mod.close_over_calls()
    flagged = mod.check_edges()
    _report_cycles([mod], flagged, mod.findings)
    return mod.findings


def _report_cycles(mods: List[_ModuleAnalysis],
                   flagged: Set[Tuple[str, str]],
                   findings: List[Finding]) -> None:
    """DFS cycle detection over the merged acquisition graph; cycles
    whose every edge already fired ``lock-order`` are skipped."""
    graph: Dict[str, Set[str]] = {}
    where: Dict[Tuple[str, str], str] = {}
    for mod in mods:
        for (a, b), lineno in mod.edges.items():
            graph.setdefault(a, set()).add(b)
            where.setdefault((a, b), f"{mod.path}:{lineno}")
    seen_cycles: Set[Tuple[str, ...]] = set()
    color: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(node: str) -> None:
        color[node] = 1
        stack.append(node)
        for nxt in sorted(graph.get(node, ())):
            if color.get(nxt, 0) == 1:
                cycle = tuple(stack[stack.index(nxt):]) + (nxt,)
                lo = min(range(len(cycle) - 1),
                         key=lambda i: cycle[i])
                canon = cycle[lo:-1] + cycle[:lo]
                if canon in seen_cycles:
                    continue
                seen_cycles.add(canon)
                edges = list(zip(cycle[:-1], cycle[1:]))
                if all(e in flagged for e in edges):
                    continue
                loc = where.get(edges[0], "")
                findings.append(Finding(
                    SEVERITY_ERROR, RULE_CYCLE, loc,
                    f"lock acquisition cycle: "
                    f"{' -> '.join(cycle)} — two threads taking "
                    f"these in opposite orders deadlock"))
            elif color.get(nxt, 0) == 0:
                dfs(nxt)
        stack.pop()
        color[node] = 2

    for node in sorted(graph):
        if color.get(node, 0) == 0:
            dfs(node)


def analyze_files(paths: Iterable[pathlib.Path],
                  root: Optional[pathlib.Path] = None,
                  hierarchy: Optional[Dict[str, int]] = None,
                  ) -> List[Finding]:
    """Analyze many files and cycle-check the merged graph."""
    root = root or REPO
    hierarchy = HIERARCHY if hierarchy is None else hierarchy
    findings: List[Finding] = []
    mods: List[_ModuleAnalysis] = []
    flagged: Set[Tuple[str, str]] = set()
    for path in sorted(paths):
        try:
            rel = str(path.relative_to(root))
        except ValueError:
            rel = str(path)
        modname = rel[:-3].replace("/", ".")
        mod = _ModuleAnalysis(path.read_text(), modname, rel,
                              hierarchy)
        mod.collect_bindings()
        mod.walk_functions()
        mod.close_over_calls()
        flagged |= mod.check_edges()
        findings.extend(mod.findings)
        mods.append(mod)
    _report_cycles(mods, flagged, findings)
    return findings


def analyze_package(package: Optional[pathlib.Path] = None,
                    ) -> List[Finding]:
    package = package or PACKAGE
    return analyze_files(package.rglob("*.py"), root=REPO)


def lock_graph(package: Optional[pathlib.Path] = None,
               ) -> Dict[str, List[str]]:
    """The merged static acquisition graph (outer -> inners), for
    documentation and debugging."""
    package = package or PACKAGE
    graph: Dict[str, Set[str]] = {}
    for path in sorted(package.rglob("*.py")):
        rel = str(path.relative_to(REPO))
        mod = _ModuleAnalysis(path.read_text(),
                              rel[:-3].replace("/", "."), rel,
                              HIERARCHY)
        mod.collect_bindings()
        mod.walk_functions()
        mod.close_over_calls()
        for (a, b) in mod.edges:
            graph.setdefault(a, set()).add(b)
    return {k: sorted(v) for k, v in sorted(graph.items())}
