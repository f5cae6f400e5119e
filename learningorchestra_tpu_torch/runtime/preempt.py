"""Cooperative cancellation of long card jobs and the epoch-boundary
yield point (the JAX package's ``runtime/preempt.py`` less its migrate
half).

The job manager installs a :class:`CancelToken` in each job's thread;
the engine's step loops, the sandbox's wait loop and the card lease's
queue call :func:`check_cancel` and :func:`heartbeat`. A deadline that
expires, a ``DELETE .../{name}/run`` or the stall watchdog's escalation
then surfaces as :class:`JobCancelled` at the next step boundary, the
job records its terminal document and the card lease goes back, so no
request can hold the card for good.

The card lease (:meth:`~learningorchestra_tpu_torch.services.scheduler.
SliceLease.lease`) installs a yield point in the holder's thread
(:func:`install`); the engine calls :func:`maybe_yield` between epochs,
which honours a cancel and then hands the card to a waiting job of
another pool. With nothing installed (direct library use, tests) every
call here is a no-op. Live migration and elastic resizes of the JAX
package need a mesh of several devices and are not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from learningorchestra_tpu_torch.runtime import locks

_tls = threading.local()


class JobCancelled(Exception):
    """Cooperative cancellation. ``reason`` is the terminal status it
    produces: ``"timedOut"`` (the deadline expired), ``"cancelled"``
    (``DELETE .../run``) or ``"stalled"`` (the watchdog escalated)."""

    def __init__(self, reason: str, message: str = ""):
        super().__init__(message or f"job {reason}")
        self.reason = reason


class CancelToken:
    """One job's cancellation and progress record.

    - ``cancel(reason)`` latches the token; the first reason stands (a
      user cancel that races the deadline keeps its attribution);
    - ``deadline`` (``time.monotonic`` basis) is checked at every
      :meth:`cancelled`, so an expired job cancels itself at its next
      check with no timer thread;
    - ``beat(**progress)`` publishes a heartbeat that the stall watchdog
      reads through :meth:`heartbeat_age`.
    """

    def __init__(self, deadline: Optional[float] = None):
        self._event = threading.Event()
        self._lock = locks.make_lock("preempt.token")
        self.deadline = deadline
        self.reason: Optional[str] = None
        self.progress: Dict[str, Any] = {}
        self.last_beat: Optional[float] = None
        self.started: Optional[float] = None

    def cancel(self, reason: str = "cancelled") -> bool:
        """Latches the token; True if this call set the reason."""
        with self._lock:
            if self.reason is None:
                self.reason = reason
                self._event.set()
                return True
            return False

    def cancelled(self) -> bool:
        if self._event.is_set():
            return True
        if self.deadline is not None and time.monotonic() >= self.deadline:
            self.cancel("timedOut")
            return True
        return False

    def check(self) -> None:
        if self.cancelled():
            raise JobCancelled(self.reason or "cancelled")

    def wait(self, seconds: float) -> bool:
        """A cancel-aware sleep (the retry backoff): True as soon as the
        token cancels, False after the whole wait. The wait never
        outlasts the deadline."""
        end = time.monotonic() + max(0.0, seconds)
        while True:
            if self.cancelled():
                return True
            now = time.monotonic()
            if now >= end:
                return False
            step = end - now
            if self.deadline is not None:
                step = min(step, max(0.0, self.deadline - now))
            if self._event.wait(min(step, 0.5) or 0.001):
                return True

    def remaining(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - time.monotonic())

    def beat(self, **progress: Any) -> None:
        with self._lock:
            self.last_beat = time.monotonic()
            self.progress.update(progress)

    def heartbeat_age(self) -> Optional[float]:
        """Seconds since the last beat; None before the first (jobs that
        never publish progress are exempt from stall detection)."""
        last = self.last_beat
        return None if last is None else time.monotonic() - last

    def progress_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self.progress)


# ----------------------------------------------------------------------
# thread-local install points: the lease owns the yield slot, the job
# manager the cancel slot
# ----------------------------------------------------------------------
def install(fn: Callable[[], None],
            contended_fn: Optional[Callable[[], bool]] = None) -> None:
    """Registers ``fn`` as this thread's between-epochs yield point (the
    card lease, when a job thread takes it). ``contended_fn`` lets a long
    job ASK whether a yield is wanted without performing one."""
    _tls.fn = fn
    _tls.contended = contended_fn


def clear() -> None:
    _tls.fn = None
    _tls.contended = None


def current() -> Optional[Callable[[], None]]:
    return getattr(_tls, "fn", None)


def contended() -> bool:
    """True when another job waits for this thread's lease (a yield at
    the next safe point would hand it over); False outside the service
    layer."""
    fn = getattr(_tls, "contended", None)
    return bool(fn()) if fn is not None else False


def snapshot() -> Tuple[Optional[Callable[[], None]],
                        Optional[Callable[[], bool]]]:
    """``(yield_fn, contended_fn)``, for the lease to restore its
    predecessor on exit."""
    return getattr(_tls, "fn", None), getattr(_tls, "contended", None)


def restore(snap) -> None:
    _tls.fn, _tls.contended = snap


def install_cancel(token: Optional[CancelToken]) -> None:
    """Binds ``token`` to this thread (the job manager, around a job)."""
    _tls.cancel = token


def clear_cancel() -> None:
    _tls.cancel = None


def current_cancel() -> Optional[CancelToken]:
    return getattr(_tls, "cancel", None)


def check_cancel() -> None:
    """Raises :class:`JobCancelled` if this thread's job was cancelled or
    ran past its deadline; a no-op with no token installed."""
    token = current_cancel()
    if token is not None:
        token.check()


def heartbeat(**progress: Any) -> None:
    """Publishes step or epoch progress for the stall watchdog; a no-op
    with no token installed."""
    token = current_cancel()
    if token is not None:
        token.beat(**progress)


def maybe_yield() -> None:
    """The engine's epoch boundary: honours a pending cancellation, then
    hands the card lease to a waiting job of another pool (if any) and
    takes it back through the fair queue."""
    check_cancel()
    fn = current()
    if fn is not None:
        fn()
