"""Asynchronous jobs under the reference's finished-flag contract.

A POST handler validates, writes a metadata document with ``finished:
False`` and submits the pipeline here; the client polls ``finished``.
On success the flag flips and an execution document is appended; on
failure the flag stays False and the execution document records
``repr(exception)`` and the error class.

This is the JAX package's ``services/jobs.py`` for one card:

- a thread pool of ``max_workers`` and one card lease, the weighted-fair
  :class:`~learningorchestra_tpu_torch.services.scheduler.SliceLease`
  that every job touching the card holds while it runs (the JAX
  ``mesh_lease`` at ``mesh_leases=1``): each job names its ``pool``, the
  card goes to the least served pool (``LO_POOL_WEIGHTS``,
  ``LO_FAIR_SERVED_HALF_LIFE``), and a fit hands it to a waiting job of
  another pool at an epoch boundary (``LO_MESH_YIELD``). Serving
  sessions queue on the same lease (:attr:`JobManager.slice_lease`). A
  job leaves the card only once its tensors are gone and the launches it
  queued have run, so the next holder starts on an idle card with the
  memory back; a job that yielded keeps its tensors on the card while
  the other job runs;
- each job's :class:`~learningorchestra_tpu_torch.runtime.preempt.
  CancelToken`: a deadline (the request's ``timeout``, else
  ``LO_JOB_TIMEOUT``), :meth:`JobManager.cancel` (``DELETE
  .../{name}/run``, also for a job still waiting for the card) and the
  stall watchdog (``LO_STALL_SECONDS``), which marks a job whose
  heartbeat went quiet ``stalled`` and, with ``LO_STALL_ESCALATE``,
  cancels it. A cancelled job ends ``timedOut``, ``cancelled`` or
  ``stalled`` with a typed document;
- classified retries: a transient error re-runs the job after an
  exponential backoff with jitter, up to ``max_retries`` times; a
  numerical one (``NumericalDivergence`` of the health sentinel) has its
  own budget (``LO_HEALTH_RETRIES``): a checkpointed fit's re-run
  resumes from its last good step; a permanent error, or a spent
  budget, ends ``deadLettered``. Each attempt appends its document;
- the metadata ``status``: queued -> running -> finished, timedOut,
  cancelled, stalled, deadLettered or shutdownAborted, and monotonic
  counters (:meth:`JobManager.lifecycle_counters`).

Each job is a trace keyed by its collection name (the JAX package's
observability hooks): a ``job`` root span with retro ``queueWait`` and
``leaseWait`` spans and an ``attempt`` span around the work, the
``lo_lease_wait_seconds`` histogram, ``queued``/``start``/``finished``/
``failed``/``cancelled`` events in the event log, flight-recorder
triggers on ``timedOut``, ``deadLettered`` and ``stalled``, and on the
terminal metadata the job's peak device bytes (``peakHbmBytes``, the
card's ``max_memory_allocated`` since the job took it, also recorded
under the footprint's ``calibrationKey``) and its last ``perf`` window.

Device slices, migration and multi-host pod guards are not ported.
"""

from __future__ import annotations

import contextlib
import gc
import random
import sys
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.catalog.store import Catalog
from learningorchestra_tpu_torch.observability import export as obs_export
from learningorchestra_tpu_torch.observability import incidents as obs_incidents
from learningorchestra_tpu_torch.observability import monitor as obs_monitor
from learningorchestra_tpu_torch.observability import perf as obs_perf
from learningorchestra_tpu_torch.observability import trace as obs_trace
from learningorchestra_tpu_torch.runtime import distributed as dist
from learningorchestra_tpu_torch.runtime import locks, preempt
from learningorchestra_tpu_torch.runtime.health import NumericalDivergence
from learningorchestra_tpu_torch.services import faults
from learningorchestra_tpu_torch.services.scheduler import (
    LeaseToken, SliceLease, parse_pool_weights)

TRANSIENT = "transient"
PERMANENT = "permanent"
# training diverged past its health policy: neither a plain re-run (the
# same divergence replays) nor dead-lettering at once, but a bounded
# number of re-runs, each resuming from the last good checkpoint
NUMERICAL = "numerical"

# message substrings that mark an otherwise unclassified exception as
# worth a retry (device out of memory, unavailable services, errors that
# call themselves transient)
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "OUT OF MEMORY",
                      "UNAVAILABLE", "DATA_LOSS", "CONNECTION RESET",
                      "TRANSIENT")


def classify_error(exception: BaseException) -> str:
    """``transient`` (a re-run of the same code may succeed),
    ``numerical`` (training diverged: a re-run resumes from the last good
    checkpoint, budgeted apart) or ``permanent`` (validation and
    user-code errors a re-run repeats). :class:`faults.InjectedFault` is
    an ``IOError``, so injected faults take the transient path."""
    if isinstance(exception, NumericalDivergence):
        return NUMERICAL
    if isinstance(exception, (OSError, MemoryError, InterruptedError,
                              TimeoutError, ConnectionError)):
        return TRANSIENT
    text = f"{type(exception).__name__}: {exception}".upper()
    if any(marker in text for marker in _TRANSIENT_MARKERS):
        return TRANSIENT
    return PERMANENT


def _settle_card(collect: bool) -> None:
    """Before the card lease goes back: with ``collect``, frees what a
    failed job's frames kept alive (model objects hold reference
    cycles), then waits for the launches the job queued."""
    if collect:
        gc.collect()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _drop_traceback(exception: BaseException) -> None:
    """Clears the frames of ``exception``'s traceback (a fit's state,
    gradients and batches on the card) and detaches it."""
    tb = exception.__traceback__
    if tb is not None:
        traceback.clear_frames(tb)
    exception.__traceback__ = None


class JobManager:
    def __init__(self, catalog: Catalog, max_workers: int = 8,
                 config=None, default_timeout: float = 0.0,
                 stall_seconds: float = 0.0, stall_escalate: bool = True,
                 retry_backoff: float = 0.5,
                 retry_backoff_max: float = 30.0,
                 numerical_retries: int = 1,
                 pool_weights: Optional[Dict[str, float]] = None,
                 served_half_life_seconds: float = 600.0,
                 mesh_yield: bool = True):
        """``config`` is the fault spec of the job's sites (``job_run``
        here; ``engine_step`` and ``ckpt_write`` through
        :func:`faults.use_config`); None reads ``LO_FAULT_INJECT``.
        ``pool_weights``, ``served_half_life_seconds`` and
        ``mesh_yield`` configure the card lease. While the process
        group has lost a worker (:func:`.distributed.pod_failure`) card
        jobs are refused with a typed ``WorkerLost`` document instead of
        entering a collective that cannot complete."""
        self._catalog = catalog
        self._config = config
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="lo-job")
        self._lease = SliceLease(
            weights=pool_weights,
            served_half_life_seconds=served_half_life_seconds,
            mesh_yield=mesh_yield)
        self._futures: Dict[str, Future] = {}
        # name -> {description, parameters, needs_card, token}
        self._info: Dict[str, Dict[str, Any]] = {}
        self._lock = locks.make_lock("jobs.manager")
        self._default_timeout = max(0.0, float(default_timeout or 0.0))
        self._stall_seconds = max(0.0, float(stall_seconds or 0.0))
        self._stall_escalate = bool(stall_escalate)
        self._retry_backoff = max(0.0, float(retry_backoff))
        self._retry_backoff_max = max(self._retry_backoff,
                                      float(retry_backoff_max))
        self._numerical_retries = max(0, int(numerical_retries))
        self._counters: Dict[str, int] = {"retries": 0, "cancelled": 0,
                                          "timedOut": 0,
                                          "numericalRetries": 0,
                                          "deadLettered": 0}
        self._stalled: set = set()
        self._watchdog_stop = threading.Event()
        if self._stall_seconds > 0:
            threading.Thread(target=self._watch_stalls, daemon=True,
                             name="lo-stall-watchdog").start()

    @classmethod
    def from_config(cls, catalog: Catalog, config) -> "JobManager":
        """The manager ``config`` describes. In a pod of several ranks
        the lease never yields and a stall never escalates to a cancel:
        the followers replay each card job whole and in order, so the
        coordinator must run it the same way."""
        single = dist.world_size() <= 1
        return cls(catalog, max_workers=config.max_workers, config=config,
                   default_timeout=config.job_timeout_seconds,
                   stall_seconds=config.stall_seconds,
                   stall_escalate=config.stall_escalate and single,
                   retry_backoff=config.retry_backoff_seconds,
                   retry_backoff_max=config.retry_backoff_max_seconds,
                   numerical_retries=config.health_retries,
                   pool_weights=parse_pool_weights(config.pool_weights),
                   served_half_life_seconds=(
                       config.fair_served_half_life_seconds),
                   mesh_yield=config.mesh_yield and single)

    def mesh_lease(self, pool: str = "default", cancel=None):
        """The card, through the fair queue (``with jobs.mesh_lease():``);
        yields a :class:`LeaseToken`."""
        return self._lease.lease(pool, cancel=cancel)

    @property
    def slice_lease(self) -> SliceLease:
        """The shared lease: serving sessions wrap it in a
        ``ServingLease``, so sessions and jobs contend through ONE fair
        queue."""
        return self._lease

    def mesh_served(self) -> Dict[str, float]:
        """Recent card seconds per pool (observability)."""
        return self._lease.served()

    def scheduler_stats(self) -> Dict[str, Any]:
        """The lease's occupancy, grant and wait aggregates (the
        ``meshScheduler`` block and the ``lo_mesh_*`` series)."""
        return self._lease.stats()

    def lifecycle_counters(self) -> Dict[str, int]:
        """Monotonic lifecycle counters and the jobs stalled now."""
        with self._lock:
            out = dict(self._counters)
            out["stalled"] = sum(
                1 for k in self._stalled
                if k in self._futures and not self._futures[k].done())
        return out

    def queue_stats(self) -> Dict[str, int]:
        """Live job-queue depth for the cluster monitor: submitted jobs
        split into started-on-a-worker (``running``) and still waiting
        for a thread (``queued``), plus the monotonic dead-letter
        counter the SLO watchdog rates."""
        with self._lock:
            live = [k for k, f in self._futures.items() if not f.done()]
            started = sum(1 for k in live if getattr(
                (self._info.get(k) or {}).get("token"), "started", None))
            dead = self._counters.get("deadLettered", 0)
        return {"running": started, "queued": len(live) - started,
                "deadLettered": dead}

    def _record_attribution(self, name: str,
                            footprint: Optional[Dict[str, Any]],
                            measure_hbm: bool) -> None:
        """The terminal metadata's ``peakHbmBytes`` (card jobs: the
        card's peak allocation since the job took it, also recorded
        under the footprint's ``calibrationKey``) and ``perf`` (the
        job's last roofline window). Best-effort."""
        try:
            meta: Dict[str, Any] = {}
            if measure_hbm:
                peak = obs_monitor.peak_hbm_bytes()
                if peak:
                    meta["peakHbmBytes"] = int(peak)
                    key = (footprint.get("calibrationKey")
                           if isinstance(footprint, dict) else None)
                    obs_monitor.record_peak(key or name, peak)
            perf_report = obs_perf.job_report(name)
            if perf_report:
                meta["perf"] = {k: perf_report[k] for k in (
                    "mfu", "tflopsPerSecPerChip", "gbPerSecPerChip",
                    "arithmeticIntensity", "hbmBwUtil", "boundBy")
                    if k in perf_report}
            if meta:
                self._catalog.update_metadata(name, meta)
        except Exception:  # noqa: BLE001 — attribution is advisory
            pass

    def _set_status(self, name: str, status: str) -> None:
        # advisory state on the metadata document; a collection deleted
        # while its job runs must not sink the job's thread
        try:
            self._catalog.update_metadata(name, {D.STATUS_FIELD: status})
        except Exception:  # noqa: BLE001
            pass

    def _count(self, key: str, delta: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + delta

    def _backoff_seconds(self, attempt: int) -> float:
        """base * 2^attempt, capped, times a uniform [0.5, 1.5) jitter
        (so jobs felled by one transient do not retry in step)."""
        if self._retry_backoff <= 0:
            return 0.0
        base = min(self._retry_backoff * (2 ** attempt),
                   self._retry_backoff_max)
        return base * (0.5 + random.random())

    # ------------------------------------------------------------------
    def submit(self, name: str, fn: Callable[[], Any], *,
               description: str = "",
               parameters: Optional[Dict[str, Any]] = None,
               needs_card: bool = False, max_retries: int = 0,
               timeout: Optional[float] = None,
               mark_finished: bool = True,
               failure_names: Optional[list] = None,
               footprint: Optional[Dict[str, Any]] = None,
               pool: str = "default") -> Future:
        """Runs ``fn`` on a worker thread for collection ``name``, which
        must exist with ``finished: False``. ``needs_card`` jobs hold the
        card lease while ``fn`` runs. ``timeout`` (seconds) is the job's
        deadline; None takes the manager's default, 0 none.

        A job with several outputs (the Builder: one collection per
        classifier) passes them as ``failure_names``, so a terminal
        failure documents every output that has not finished (and
        ``name`` always), and ``mark_finished=False`` where ``fn`` marks
        each output itself. ``footprint`` (the preflight's) names the
        ``calibrationKey`` the job's measured peak is recorded under.
        ``pool`` is the job's fair-share pool on the card lease (the
        callers pass the JAX callers' pools: the route's prefix,
        ``builder``, else ``default``)."""
        effective = (self._default_timeout if timeout is None
                     else max(0.0, float(timeout)))
        token = preempt.CancelToken(
            deadline=time.monotonic() + effective if effective > 0
            else None)
        doc_names = list(failure_names) if failure_names else [name]

        def fail_all(document: Dict[str, Any]) -> None:
            for n in doc_names:
                if n != name:
                    # outputs that finished before a sibling's failure
                    # sank the job keep their clean record
                    meta = self._catalog.get_metadata(n)
                    if meta is None or meta.get(D.FINISHED_FIELD):
                        continue
                self._catalog.append_document(n, dict(document))

        def record_cancel(exc: preempt.JobCancelled, attempt: int,
                          extra: Dict[str, Any]) -> None:
            status = exc.reason or D.STATUS_CANCELLED
            extra = dict(extra, **{D.STATUS_FIELD: status,
                                   "cancelReason": status,
                                   "attempt": attempt})
            fail_all(D.execution_document(
                description, parameters,
                exception=f"JobCancelled({status!r}: {exc})", extra=extra))
            self._set_status(name, status)
            self._count("timedOut" if status == D.STATUS_TIMED_OUT
                        else "cancelled")
            obs_export.log_event("job", "cancelled", trace_id=name,
                                 reason=status)
            if status == D.STATUS_TIMED_OUT:
                obs_incidents.trigger("job:timedOut", job=name)

        def attempt_once(attempt: int, submitted: float,
                         failures: Dict[str, int], job_span) -> tuple:
            """One attempt under the lease: ``(done, result)``; done
            False means retry after the backoff it recorded."""
            lease = (self._lease.lease(pool, cancel=token) if needs_card
                     else contextlib.nullcontext(LeaseToken()))
            with lease as lease_token:
                lease_wait = lease_token.wait_seconds
                granted = time.monotonic()
                queue_wait = granted - submitted
                # retro spans: the worker-pool wait, then the card lease
                # wait (the tail of it)
                leased = granted - min(max(lease_wait, 0.0), queue_wait)
                obs_trace.add("queueWait", name, submitted, leased,
                              parent=job_span.span_id, attempt=attempt)
                if needs_card:
                    # the lease-wait histogram is observed at the grant
                    obs_trace.add("leaseWait", name, leased, granted,
                                  parent=job_span.span_id, pool=pool)
                    # the job's peak device bytes count from here
                    obs_monitor.reset_peak_hbm()
                self._set_status(name, D.STATUS_RUNNING)
                if needs_card:
                    try:
                        self._catalog.update_metadata(name, {
                            "leaseWaitSeconds": round(lease_wait, 6)})
                    except Exception:  # noqa: BLE001
                        pass
                start = time.monotonic()

                def timing(extra: Dict[str, Any]) -> Dict[str, Any]:
                    # the job's own run time: seconds spent yielded to
                    # another pool are reported apart
                    preempted = lease_token.preempted_seconds
                    extra = dict(extra, elapsedSeconds=round(
                        time.monotonic() - start - preempted, 6))
                    if preempted > 0:
                        extra["preemptedSeconds"] = round(preempted, 6)
                        extra["leaseYields"] = lease_token.yields
                    if needs_card:
                        extra["leaseWaitSeconds"] = round(lease_wait, 6)
                    return extra

                failure = None
                try:
                    # with the lease held: "hang" is a wedged job holding
                    # the card, "raise" a transient attempt failure
                    faults.maybe_inject("job_run", self._config)
                    with obs_trace.span("attempt", attempt=attempt):
                        result = fn()
                except preempt.JobCancelled as exc:
                    # deadline, DELETE or stall escalation at a
                    # cooperative check: terminal; a checkpointed fit
                    # stays resumable by PATCH
                    _drop_traceback(exc)
                    failure = exc
                except Exception as exc:  # noqa: BLE001 — recorded
                    traceback.print_exc()
                    _drop_traceback(exc)
                    failure = exc
                if needs_card:
                    _settle_card(collect=failure is not None)
                if failure is not None and needs_card and \
                        dist.world_size() > 1 and \
                        dist.is_collective_error(failure):
                    self._await_pod_verdict()
                if isinstance(failure, preempt.JobCancelled):
                    record_cancel(failure, attempt, timing(
                        {"queueWaitSeconds": round(queue_wait, 6)}))
                    return True, None
                if failure is not None:
                    terminal = self._record_failure(
                        name, description, parameters, failure, attempt,
                        max_retries, failures, timing, fail_all,
                        needs_card)
                    if terminal:
                        self._record_attribution(name, footprint,
                                                 needs_card)
                        obs_export.log_event(
                            "job", "failed", trace_id=name,
                            errorKind=classify_error(failure),
                            error=repr(failure))
                        obs_incidents.trigger(
                            "job:deadLettered", job=name,
                            errorKind=classify_error(failure),
                            error=repr(failure))
                    return terminal, None
                if mark_finished:
                    self._catalog.mark_finished(name)
                self._set_status(name, D.STATUS_FINISHED)
                self._catalog.append_document(name, D.execution_document(
                    description, parameters, extra=timing({
                        "queueWaitSeconds": round(queue_wait, 6),
                        "attempt": attempt})))
                self._record_attribution(name, footprint, needs_card)
                obs_export.log_event("job", "finished", trace_id=name,
                                     elapsedSeconds=round(
                                         time.monotonic() - granted, 6))
                return True, result

        def run() -> Any:
            submitted = time.monotonic()
            token.started = submitted
            failures = {"transient": 0, "numerical": 0}
            attempt = 0
            preempt.install_cancel(token)
            # root span of this job's trace (trace id == collection
            # name); every nested span — lease, dataLoad, epochs,
            # checkpoint commits — attaches under it through the
            # thread-local stack
            job_span = obs_trace.span("job", trace=name, pool=pool,
                                      needsCard=needs_card)
            obs_export.log_event("job", "start", trace_id=name, pool=pool)
            try:
                with job_span, faults.use_config(self._config):
                    while True:
                        attempt += 1
                        failure = dist.pod_failure() if needs_card \
                            else None
                        if failure:
                            # a degraded pod cannot run a sharded step:
                            # a terminal typed failure, not a collective
                            # that waits out its timeout
                            fail_all(D.execution_document(
                                description, parameters,
                                exception=f"WorkerLost({failure!r})",
                                extra={"workerLost": True,
                                       "attempt": attempt}))
                            return None
                        try:
                            # cancelled or expired while queued, or in
                            # the backoff: terminal, no lease taken
                            token.check()
                            done, result = attempt_once(attempt, submitted,
                                                        failures, job_span)
                        except preempt.JobCancelled as exc:
                            _drop_traceback(exc)
                            record_cancel(exc, attempt, {
                                "elapsedSeconds": round(
                                    time.monotonic() - submitted, 6),
                                "queuedOnly": True})
                            return None
                        if done:
                            return result
                        # cancel-aware: a DELETE or the deadline ends the
                        # wait and the next token.check() records it
                        token.wait(failures["backoff"])
            finally:
                preempt.clear_cancel()

        with self._lock:
            # queued before the pool can start run(), which sets running
            self._set_status(name, D.STATUS_QUEUED)
            future = self._pool.submit(run)
            # forget finished jobs (their results live in the catalog)
            for k in [k for k, f in self._futures.items()
                      if f.done() and k != name]:
                del self._futures[k]
                self._info.pop(k, None)
                self._stalled.discard(k)
            self._futures[name] = future
            self._info[name] = {"description": description,
                                "parameters": parameters,
                                "needs_card": needs_card, "token": token}
        obs_export.log_event("job", "queued", trace_id=name, pool=pool)
        return future

    def _record_failure(self, name: str, description: str, parameters,
                        exception: Exception, attempt: int,
                        max_retries: int, failures: Dict[str, Any],
                        timing: Callable, fail_all: Callable,
                        needs_card: bool = False) -> bool:
        """Documents a failed attempt (a terminal one through
        ``fail_all``, on every output); True when it is terminal, else
        the retry's backoff goes to ``failures["backoff"]``. A card job
        failing while the pod has lost a worker is flagged
        ``workerLost`` (a collective erred under it) and is never
        dead-lettered: the pod failed, not the job."""
        kind = classify_error(exception)
        if kind == PERMANENT:
            terminal = True
        elif kind == NUMERICAL:
            terminal = failures["numerical"] >= self._numerical_retries
        else:
            terminal = failures["transient"] + 1 >= max_retries + 1
        extra = timing({"attempt": attempt, "errorKind": kind})
        if kind == NUMERICAL:
            extra["numericalRetriesUsed"] = failures["numerical"]
        error = repr(exception)
        lost = dist.pod_failure() if needs_card else None
        if lost:
            # typed as the loss, the collective's own error beside it
            extra["workerLost"] = True
            extra["collectiveError"] = error
            error = f"WorkerLost({lost!r})"
        if terminal and not lost:
            extra[D.STATUS_FIELD] = D.STATUS_DEAD_LETTERED
            extra["deadLettered"] = True
            self._count("deadLettered")
            if kind == PERMANENT and max_retries > 0:
                extra["retriesSkipped"] = "permanent error class"
            elif kind == NUMERICAL:
                extra["retriesSkipped"] = \
                    "numerical rollback-retry budget exhausted"
        if terminal:
            fail_all(D.execution_document(
                description, parameters, exception=error, extra=extra))
            # finished stays False (reference parity)
            self._set_status(name, D.STATUS_DEAD_LETTERED)
            return True
        backoff = self._backoff_seconds(attempt - 1)
        extra["nextRetryInSeconds"] = round(backoff, 3)
        self._catalog.append_document(name, D.execution_document(
            description, parameters, exception=error, extra=extra))
        if kind == NUMERICAL:
            failures["numerical"] += 1
            self._count("numericalRetries")
        else:
            failures["transient"] += 1
            self._count("retries")
        failures["backoff"] = backoff
        self._set_status(name, D.STATUS_QUEUED)
        return False

    def _await_pod_verdict(self) -> None:
        """In a pod a lost worker fails a collective at once (its socket
        closes) but shows in the heartbeats only after their timeout:
        a card job that a collective failed waits that long for the
        verdict, so the loss is told apart from a peer's own error. Any
        other failure is the job's and is recorded at once."""
        deadline = time.monotonic() + dist.HEARTBEAT_TIMEOUT + \
            2 * dist.HEARTBEAT_INTERVAL
        while not dist.pod_failure() and \
                time.monotonic() < deadline:
            time.sleep(0.1)

    def fail_running_card_jobs(self, reason: str) -> int:
        """Appends a terminal ``WorkerLost`` execution document to every
        running card job (their threads wait in collectives a dead
        worker will never join); returns the count."""
        with self._lock:
            stuck = [(k, dict(v)) for k, v in self._info.items()
                     if v.get("needs_card") and k in self._futures
                     and not self._futures[k].done()]
        for name, info in stuck:
            self._catalog.append_document(
                name, D.execution_document(
                    info["description"], info["parameters"],
                    exception=f"WorkerLost({reason!r})",
                    extra={"workerLost": True}))
        return len(stuck)

    # ------------------------------------------------------------------
    def cancel(self, name: str, reason: str = D.STATUS_CANCELLED) -> bool:
        """Cooperative cancellation of job ``name`` (the ``DELETE
        .../{name}/run`` backend). A job the pool has not started is
        cancelled outright, with its document written here; a running
        job (or one waiting for the card) records its own at its next
        check. False when no live job has that name."""
        with self._lock:
            future = self._futures.get(name)
            info = self._info.get(name)
        if future is None or info is None or future.done():
            return False
        token: preempt.CancelToken = info["token"]
        if future.cancel():
            token.cancel(reason)
            try:
                self._catalog.append_document(name, D.execution_document(
                    info.get("description", ""), info.get("parameters"),
                    exception=f"JobCancelled({reason!r}: cancelled "
                              f"before the job started)",
                    extra={D.STATUS_FIELD: reason, "cancelReason": reason,
                           "attempt": 0, "queuedOnly": True}))
            except Exception:  # noqa: BLE001 — the collection may be gone
                pass
            self._set_status(name, reason)
            self._count("timedOut" if reason == D.STATUS_TIMED_OUT
                        else "cancelled")
            return True
        token.cancel(reason)
        return True

    # ------------------------------------------------------------------
    def _watch_stalls(self) -> None:
        """The stall watchdog: a live job whose heartbeat
        (:func:`preempt.heartbeat`) went quiet for more than
        ``stall_seconds`` is marked ``stalled`` and, with escalation,
        cancelled through its token. Jobs that never beat are exempt.
        It also publishes each job's progress to its metadata
        (``progress``, with ``heartbeatAgeSeconds``)."""
        interval = min(max(self._stall_seconds / 4.0, 0.05), 5.0)
        while not self._watchdog_stop.wait(interval):
            with self._lock:
                live = [(k, v["token"]) for k, v in self._info.items()
                        if k in self._futures
                        and not self._futures[k].done()]
            for name, token in live:
                age = token.heartbeat_age()
                if age is None:
                    continue
                progress = token.progress_snapshot()
                if progress:
                    try:
                        self._catalog.update_metadata(name, {
                            D.PROGRESS_FIELD: dict(
                                progress,
                                heartbeatAgeSeconds=round(age, 3))})
                    except Exception:  # noqa: BLE001
                        pass
                if token.cancelled():
                    continue
                if age > self._stall_seconds:
                    with self._lock:
                        newly = name not in self._stalled
                        self._stalled.add(name)
                    if newly:
                        self._set_status(name, D.STATUS_STALLED)
                        self._count("stalledSeen")
                        obs_incidents.trigger(
                            "job:stalled", job=name,
                            heartbeatAgeSeconds=round(age, 3))
                        if self._stall_escalate:
                            token.cancel(D.STATUS_STALLED)
                else:
                    with self._lock:
                        was = name in self._stalled
                        self._stalled.discard(name)
                    if was:
                        # heartbeats resumed (a long first step): un-flag
                        self._set_status(name, D.STATUS_RUNNING)

    # ------------------------------------------------------------------
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
        that never flips (the next boot's ``recover_unfinished``
        requeues the executions and functions among them)."""
        self._watchdog_stop.set()
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
