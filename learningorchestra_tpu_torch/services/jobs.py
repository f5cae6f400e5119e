"""Asynchronous jobs under the reference's finished-flag contract.

A POST handler validates, writes a metadata document with ``finished:
False`` and submits the pipeline here; the client polls ``finished``.
On success the flag flips and an execution document is appended; on
failure the flag stays False and the execution document records
``repr(exception)`` and the error class.

This is the part of the JAX package's ``services/jobs.py`` that contract
needs, for one card: a thread pool of ``max_workers``, the metadata
``status`` queued -> running -> finished (or deadLettered), and one
card lease, a FIFO lock that every job touching the card holds while
it runs (the JAX ``mesh_lease`` at ``mesh_leases=1``). Cancellation,
timeouts, retries, the stall watchdog, slices and migration are not
ported.
"""

from __future__ import annotations

import contextlib
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional

from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.catalog.store import Catalog
from learningorchestra_tpu_torch.runtime import locks

TRANSIENT = "transient"
PERMANENT = "permanent"

# message substrings that mark an otherwise unclassified exception as
# worth a retry (device out of memory, unavailable services, errors that
# call themselves transient)
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "OUT OF MEMORY",
                      "UNAVAILABLE", "DATA_LOSS", "CONNECTION RESET",
                      "TRANSIENT")


def classify_error(exception: BaseException) -> str:
    """``transient`` (a re-run of the same code may succeed) or
    ``permanent`` (validation and user-code errors a re-run repeats)."""
    if isinstance(exception, (OSError, MemoryError, InterruptedError,
                              TimeoutError, ConnectionError)):
        return TRANSIENT
    text = f"{type(exception).__name__}: {exception}".upper()
    if any(marker in text for marker in _TRANSIENT_MARKERS):
        return TRANSIENT
    return PERMANENT


class CardLease:
    """First come, first served access to the card: one holder at a
    time, granted in the order of asking."""

    def __init__(self):
        self._cv = locks.make_condition("scheduler.fair")
        self._next_ticket = 0
        self._now_serving = 0

    @contextlib.contextmanager
    def hold(self) -> Iterator[float]:
        """Holds the card for the ``with`` body; yields the seconds
        spent waiting for it."""
        t0 = time.monotonic()
        with self._cv:
            ticket = self._next_ticket
            self._next_ticket += 1
            while ticket != self._now_serving:
                self._cv.wait()
        try:
            yield time.monotonic() - t0
        finally:
            with self._cv:
                self._now_serving += 1
                self._cv.notify_all()


class JobManager:
    def __init__(self, catalog: Catalog, max_workers: int = 8):
        self._catalog = catalog
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="lo-job")
        self._lease = CardLease()
        self._futures: Dict[str, Future] = {}
        self._info: Dict[str, Dict[str, Any]] = {}
        self._lock = locks.make_lock("jobs.manager")

    def _set_status(self, name: str, status: str) -> None:
        # advisory state on the metadata document; a collection deleted
        # while its job runs must not sink the job's thread
        try:
            self._catalog.update_metadata(name, {D.STATUS_FIELD: status})
        except Exception:  # noqa: BLE001
            pass

    def submit(self, name: str, fn: Callable[[], Any], *,
               description: str = "",
               parameters: Optional[Dict[str, Any]] = None,
               needs_card: bool = False) -> Future:
        """Runs ``fn`` on a worker thread for collection ``name``, which
        must exist with ``finished: False``. ``needs_card`` jobs hold the
        card lease while ``fn`` runs."""

        def run() -> Any:
            submitted = time.monotonic()
            lease = (self._lease.hold() if needs_card
                     else contextlib.nullcontext(0.0))
            with lease as lease_wait:
                queue_wait = time.monotonic() - submitted
                self._set_status(name, D.STATUS_RUNNING)
                if needs_card:
                    try:
                        self._catalog.update_metadata(name, {
                            "leaseWaitSeconds": round(lease_wait, 6)})
                    except Exception:  # noqa: BLE001
                        pass
                start = time.monotonic()

                def timing(extra: Dict[str, Any]) -> Dict[str, Any]:
                    extra = dict(extra, elapsedSeconds=round(
                        time.monotonic() - start, 6))
                    if needs_card:
                        extra["leaseWaitSeconds"] = round(lease_wait, 6)
                    return extra

                try:
                    result = fn()
                except Exception as exception:  # noqa: BLE001 — recorded
                    traceback.print_exc()
                    # no retries: every failure is terminal
                    extra = timing({"attempt": 1,
                                    "errorKind": classify_error(exception),
                                    D.STATUS_FIELD: D.STATUS_DEAD_LETTERED,
                                    "deadLettered": True})
                    self._catalog.append_document(name, D.execution_document(
                        description, parameters, exception=repr(exception),
                        extra=extra))
                    self._set_status(name, D.STATUS_DEAD_LETTERED)
                    return None
                self._catalog.mark_finished(name)
                self._set_status(name, D.STATUS_FINISHED)
                self._catalog.append_document(name, D.execution_document(
                    description, parameters, extra=timing({
                        "queueWaitSeconds": round(queue_wait, 6),
                        "attempt": 1})))
                return result

        with self._lock:
            # queued before the pool can start run(), which sets running
            self._set_status(name, D.STATUS_QUEUED)
            future = self._pool.submit(run)
            # forget finished jobs (their results live in the catalog)
            for k in [k for k, f in self._futures.items()
                      if f.done() and k != name]:
                del self._futures[k]
                self._info.pop(k, None)
            self._futures[name] = future
            self._info[name] = {"description": description,
                                "parameters": parameters}
        return future

    def wait(self, name: str, timeout: Optional[float] = None) -> Any:
        """Blocks until job ``name`` ends (REST clients poll
        ``finished`` instead); the job's result, or None."""
        with self._lock:
            future = self._futures.get(name)
        return None if future is None else future.result(timeout=timeout)

    def running(self) -> int:
        with self._lock:
            return sum(1 for f in self._futures.values() if not f.done())

    def active_job(self) -> Optional[str]:
        """The name of one live job, or None when idle."""
        with self._lock:
            for name, future in self._futures.items():
                if not future.done():
                    return name
        return None

    def shutdown(self) -> None:
        """Stops taking jobs and drops the ones still queued, each with a
        terminal ``shutdownAborted`` document, so no client polls a flag
        that never flips."""
        self._pool.shutdown(wait=False, cancel_futures=True)
        with self._lock:
            aborted = [(k, self._info.get(k) or {})
                       for k, f in self._futures.items() if f.cancelled()]
        for name, info in aborted:
            try:
                self._catalog.append_document(name, D.execution_document(
                    info.get("description", ""), info.get("parameters"),
                    exception="ShutdownAborted('server shut down before "
                              "this queued job started')",
                    extra={D.STATUS_FIELD: D.STATUS_SHUTDOWN_ABORTED,
                           "shutdownAborted": True}))
                self._set_status(name, D.STATUS_SHUTDOWN_ABORTED)
            except Exception:  # noqa: BLE001 — teardown is best effort
                pass
