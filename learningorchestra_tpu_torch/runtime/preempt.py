"""Cooperative cancellation of long card jobs (the cancel half of the JAX
package's ``runtime/preempt.py``).

The job manager installs a :class:`CancelToken` in each job's thread;
the engine's step loops, the sandbox's wait loop and the card lease's
queue call :func:`check_cancel` and :func:`heartbeat`. A deadline that
expires, a ``DELETE .../{name}/run`` or the stall watchdog's escalation
then surfaces as :class:`JobCancelled` at the next step boundary, the
job records its terminal document and the card lease goes back, so no
request can hold the card for good. With no token installed (direct
library use, tests) every call here is a no-op.

The lease yield between epochs, live migration and elastic resizes of
the JAX package need a mesh of several devices and are not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

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
    """The engine's epoch boundary: honours a pending cancellation. (The
    JAX package also hands its mesh lease to a waiting job here; one
    card has no lease to share mid-fit.)"""
    check_cancel()
