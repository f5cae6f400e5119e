"""Named, ranked locks and a FreeBSD-``witness``-style runtime
lock-order validator (the port's copy of the JAX package's
``runtime/locks.py``).

- :data:`HIERARCHY` ranks every named lock of the port: a thread
  acquires a lock only while every lock it holds has a **strictly
  lower** rank (re-entering the same :class:`WitnessRLock` object is
  exempt). Low ranks are outermost, high ranks are leaves. The ranks are
  the JAX package's (the process group's ``distributed.publish`` and
  ``distributed.state`` too); ``attention.launches`` (the kernels'
  launch counters, at 385 beside them) and ``kernels.build`` (their
  build) are the port's own leaves.
- :func:`make_lock` / :func:`make_rlock` / :func:`make_condition` are
  the only way the port creates a lock. They reject names that are not
  declared, and return plain ``threading`` primitives unless
  ``LO_LOCK_WITNESS=1``; then they return witness wrappers, which record
  each thread's acquisition order and raise :class:`LockOrderViolation`
  (``LO_LOCK_WITNESS_MODE=raise``, the default) or count it
  (``=count``) on a hierarchy violation.

The static half is :mod:`learningorchestra_tpu_torch.analysis.concurrency`,
which checks the same hierarchy from the AST; the witness catches the
orders the static pass cannot see (callbacks, cross-module calls,
data-dependent paths).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "HIERARCHY", "LockOrderViolation",
    "make_lock", "make_rlock", "make_condition",
    "WitnessLock", "WitnessRLock", "WitnessCondition",
    "witness_enabled", "witness_mode", "witness_stats",
    "witness_edges", "reset_witness",
]

# name -> rank; LOWER rank = acquired FIRST (outermost). Same ranks as
# the JAX package.
HIERARCHY: Dict[str, int] = {
    # the incident capture worker freezes every other subsystem's state
    # while holding the commit lock, so it ranks below them all
    "incidents.commit": 10,
    "jobs.manager": 30,            # job registry
    "serving.manager": 50,         # session registry
    "serving.session": 60,         # per-session request cv
    "serving.handoff": 65,         # disagg prefill -> decode ready
                                   # queue (popped under it, pages
                                   # released after)
    "scheduler.servinglease": 70,  # releases into the fair queue while
                                   # holding it (maybe_yield)
    "serving.prefix": 75,          # prefix-cache index; eviction
                                   # decrefs the pool under it
    "scheduler.fair": 80,          # the SliceLease cv: the fair queue
    "serving.kvpool": 90,          # paged-KV free list / refcounts
    "serving.latency": 100,        # per-session latency ring
    "async_ckpt.error": 120,       # latched commit-worker error
    "preempt.token": 130,          # per-job cancel token
    "health.counters": 140,        # sentinel counters (listeners are
                                   # called outside it)
    "arena.default": 150,          # default-arena singleton guard
    "arena.entries": 160,          # the device arena's LRU (X-ray's
                                   # ledger nests inside it)
    "feature_cache.store": 170,    # the feature cache's host tier
    "cache.lru": 180,              # the GET response cache
    "catalog.change": 190,         # catalog change-feed condition
    # observability
    "monitor.rings": 200,
    "monitor.calibration": 210,
    "slo.alerts": 220,             # fires incident triggers under it
    "incidents.queue": 230,        # trigger cooldown + counters
    "incidents.profiler": 240,     # profiler singleton gate
    "incidents.buildinfo": 250,
    "incidents.registry": 260,     # process-wide recorder registry
    "trace.registry": 270,
    "timeline.registry": 280,
    "hist.registry": 290,
    "hist.buckets": 300,
    "perf.registry": 310,
    "xray.ledger": 320,
    "export.log": 330,             # event-log file lock
    "slo.gauges": 335,             # pushed-gauge registry (leaf: set
                                   # from serving under its session
                                   # lock, read by the watchdog)
    "server.metrics": 340,         # REST request counters
    "server.gateway": 350,         # timed-dispatch accounting
    "faults.spec": 360,            # fault-injection budget (leaf)
    "distributed.publish": 370,    # the bridge's (length, payload) pair
    "distributed.state": 380,      # heartbeats seen, bytes staged (leaf)
    "attention.launches": 385,     # the kernels' launch counters (leaf)
    "sweep.fusion": 390,           # the sweeps' fusion counters (leaf)
    "native.registry": 400,        # the C++ core's one-time build
    "kernels.build": 405,          # the CUDA kernels' build and load
                                   # (leaf: nvcc runs under it)
}


class LockOrderViolation(RuntimeError):
    """Acquisition order contradicts :data:`HIERARCHY`."""


# ----------------------------------------------------------------------
# Witness state: per-thread held stack + process-wide evidence.
# ----------------------------------------------------------------------
_tls = threading.local()

_MAX_SAMPLES = 64
_violation_count = 0
_violation_samples: List[Dict[str, object]] = []
# observed (held-name, acquired-name) pairs while enabled; dict used
# as a set — CPython item assignment is atomic, no extra lock needed
_edges: Dict[Tuple[str, str], bool] = {}
# the witness cannot witness itself — a leaf guard for its own samples
_evidence_lock = threading.Lock()  # lo-conc: waive(undeclared-lock) — witness-internal


def witness_enabled() -> bool:
    return os.environ.get("LO_LOCK_WITNESS", "0") not in (
        "0", "", "false", "no")


def witness_mode() -> str:
    """``raise`` (default: a violation raises at the acquire site,
    before blocking) or ``count`` (production: record and continue)."""
    mode = os.environ.get("LO_LOCK_WITNESS_MODE", "raise")
    return mode if mode in ("raise", "count") else "raise"


def _stack() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _rank_of(name: str) -> int:
    try:
        return HIERARCHY[name]
    except KeyError:
        raise KeyError(
            f"lock name {name!r} is not declared in "
            f"learningorchestra_tpu_torch.runtime.locks.HIERARCHY — add "
            f"a ranked row") from None


def _violate(lock: "_WitnessBase", held: list, reentry: bool) -> None:
    global _violation_count
    worst = max(held, key=lambda e: e.rank)
    if reentry:
        detail = (f"re-acquiring non-reentrant lock {lock.name!r} "
                  f"(rank {lock.rank}) already held by this thread")
    else:
        detail = (f"acquiring {lock.name!r} (rank {lock.rank}) while "
                  f"holding {worst.name!r} (rank {worst.rank})")
    msg = (f"lock-order violation: {detail}; held="
           f"{[e.name for e in held]} "
           f"(declared order: see runtime/locks.py HIERARCHY)")
    with _evidence_lock:
        _violation_count += 1
        if len(_violation_samples) < _MAX_SAMPLES:
            _violation_samples.append({
                "thread": threading.current_thread().name,
                "acquiring": lock.name,
                "held": [e.name for e in held],
                "message": msg})
    if witness_mode() == "raise":
        raise LockOrderViolation(msg)


def _check_and_note(lock: "_WitnessBase") -> None:
    """Order check, run BEFORE blocking on the underlying primitive so
    a would-be deadlock raises instead of hanging."""
    held = _stack()
    if not held:
        return
    if any(e is lock for e in held):
        if not lock.reentrant:
            _violate(lock, held, reentry=True)
        return
    top = max(e.rank for e in held)
    _edges[(max(held, key=lambda e: e.rank).name, lock.name)] = True
    if lock.rank <= top:
        _violate(lock, held, reentry=False)


def _push(lock: "_WitnessBase") -> None:
    _stack().append(lock)


def _pop(lock: "_WitnessBase") -> None:
    held = _stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i] is lock:
            del held[i]
            return
    # releasing a lock the witness never saw acquired: tolerated (an
    # acquire(False) race or a release on another thread's behalf)


def witness_stats() -> Dict[str, object]:
    with _evidence_lock:
        return {"enabled": witness_enabled(), "mode": witness_mode(),
                "violations": _violation_count,
                "samples": [dict(s) for s in _violation_samples]}


def witness_edges() -> List[Tuple[str, str]]:
    """Observed (outer, inner) acquisition pairs — evidence for rank
    assignment and for the docs table."""
    return sorted(_edges.keys())


def reset_witness() -> None:
    global _violation_count
    with _evidence_lock:
        _violation_count = 0
        del _violation_samples[:]
        _edges.clear()


# ----------------------------------------------------------------------
# Wrappers. Composition, not inheritance: threading.Condition's
# internal _is_owned fallback probes acquire(0) on foreign lock
# objects, which would feed the witness phantom acquisitions.
# ----------------------------------------------------------------------
class _WitnessBase:
    reentrant = False

    __slots__ = ("name", "rank")

    def __init__(self, name: str):
        self.name = name
        self.rank = _rank_of(name)


class WitnessLock(_WitnessBase):
    """``threading.Lock`` carrying ``(name, rank)`` under the witness."""

    __slots__ = ("_lock",)

    def __init__(self, name: str):
        super().__init__(name)
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        if blocking:
            _check_and_note(self)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _push(self)
        return ok

    def release(self) -> None:
        _pop(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return (f"<WitnessLock {self.name!r} rank={self.rank} "
                f"locked={self._lock.locked()}>")


class WitnessRLock(_WitnessBase):
    """``threading.RLock`` under the witness; same-object re-entry is
    legal and skips the rank check."""

    reentrant = True

    __slots__ = ("_lock",)

    def __init__(self, name: str):
        super().__init__(name)
        self._lock = threading.RLock()

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        if blocking:
            _check_and_note(self)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _push(self)
        return ok

    def release(self) -> None:
        _pop(self)
        self._lock.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessRLock {self.name!r} rank={self.rank}>"


class WitnessCondition(_WitnessBase):
    """``threading.Condition`` under the witness. ``wait`` releases the
    underlying lock, so the witness pops the rank for the duration and
    re-checks order on wake — waiting never poisons the thread's held
    stack, and an out-of-order re-acquire (waiting while holding a
    higher-ranked lock) is itself flagged."""

    __slots__ = ("_cond",)

    def __init__(self, name: str):
        super().__init__(name)
        self._cond = threading.Condition()

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        if blocking:
            _check_and_note(self)
        ok = self._cond.acquire(blocking, timeout)
        if ok:
            _push(self)
        return ok

    def release(self) -> None:
        _pop(self)
        self._cond.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        _pop(self)
        try:
            return self._cond.wait(timeout)
        finally:
            _check_and_note(self)
            _push(self)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _pop(self)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            _check_and_note(self)
            _push(self)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self) -> str:
        return f"<WitnessCondition {self.name!r} rank={self.rank}>"


# ----------------------------------------------------------------------
# Factories — the package-wide entry points. Always validate the name
# against the hierarchy (a typo fails fast even in production); only
# pay for bookkeeping when the witness is armed.
# ----------------------------------------------------------------------
def make_lock(name: str):
    _rank_of(name)
    if witness_enabled():
        return WitnessLock(name)
    return threading.Lock()


def make_rlock(name: str):
    _rank_of(name)
    if witness_enabled():
        return WitnessRLock(name)
    return threading.RLock()


def make_condition(name: str):
    _rank_of(name)
    if witness_enabled():
        return WitnessCondition(name)
    return threading.Condition()
