"""Cluster resource sampler of the port (the counterpart of the JAX
package's ``observability/monitor.py``, docs/OBSERVABILITY.md "Cluster
monitor").

A single daemon thread samples, every ``LO_MONITOR_INTERVAL_MS``
milliseconds, the resources the rest of the stack only reads at isolated
points: per-card memory (``torch.cuda.memory_stats(i)`` and
``torch.cuda.mem_get_info(i)``), the device arena's occupancy and
evictions (:mod:`runtime.arena`), the card lease's occupancy and
fragmentation (:meth:`services.scheduler.SliceLease.stats`; on one card
``devicesBusy`` counts the busy lease, 0 or 1, and fragmentation is 0),
serving queue depth and batch fill (:mod:`services.serving`), job-queue
depth, and host RSS. Each scalar lands in a bounded time-series ring
(``LO_MONITOR_RING`` samples), readable as one JSON document through
``GET /observability/cluster``; the latest structured sample also backs
the ``lo_hbm_bytes_in_use`` / ``lo_slice_fragmentation`` /
``lo_host_rss_bytes`` Prometheus gauges.

The sampler is strictly best-effort — a failing collector is recorded
as a ``sampleErrors`` count, never raised — and does not touch the card
when CUDA was never initialized in the process.

This module also hosts the **footprint-calibration registry**: jobs
record their measured peak device bytes
(``torch.cuda.max_memory_allocated``, reset when the job takes the card)
under the footprint's ``calibrationKey`` and, behind
``LO_FOOTPRINT_CALIBRATE``, the preflight prefers that measurement
(safety-margined, clamped to the static estimate's order of magnitude)
over its heuristic for repeat executions.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional
from learningorchestra_tpu_torch.runtime import locks

# scalar series kept as (ts, value) rings; everything else only in the
# latest structured sample
_SCALAR_SERIES = (
    "hbmBytesInUse", "hbmPeakBytesInUse", "hbmHeadroomFrac",
    # the device arena (runtime/arena.py): resident bytes and the LRU's
    # evictions
    "arenaBytesInUse", "arenaEvictions",
    "sliceDevicesBusy", "sliceFragmentation",
    "servingQueueDepth", "servingBatchFill",
    # paged-KV serving (services/serving.py PagedLMServingSession):
    # pool free-page headroom and cross-stream prefix sharing
    "servingKvPagesFree", "servingKvPagesShared",
    "jobsRunning", "jobQueueDepth", "deadLettered",
    "hostRssBytes",
    # X-ray HBM attribution (observability/xray): ledger total and the
    # unattributed remainder the leak-detector SLO differences
    "xrayAttributedBytes", "xrayUnattributedBytes",
)


def device_memory_stats() -> List[Dict[str, Any]]:
    """Per-card memory, best-effort: ``bytesInUse`` and
    ``peakBytesInUse`` from the caching allocator
    (``torch.cuda.memory_stats(i)``'s ``allocated_bytes.all``),
    ``bytesLimit`` the card's total from ``torch.cuda.mem_get_info(i)``
    and ``bytesFree`` its free bytes. No card (or CUDA never
    initialized in this process): no entries."""
    try:
        import torch

        if not torch.cuda.is_available() or \
                not torch.cuda.is_initialized():
            return []
        n = torch.cuda.device_count()
    except Exception:
        return []
    out: List[Dict[str, Any]] = []
    for i in range(n):
        entry: Dict[str, Any] = {
            "device": i, "platform": "cuda",
            "bytesInUse": None, "peakBytesInUse": None,
            "bytesLimit": None, "bytesFree": None,
        }
        try:
            ms = torch.cuda.memory_stats(i) or {}
            entry["bytesInUse"] = ms.get("allocated_bytes.all.current")
            entry["peakBytesInUse"] = ms.get("allocated_bytes.all.peak")
            free, total = torch.cuda.mem_get_info(i)
            entry["bytesLimit"] = int(total)
            entry["bytesFree"] = int(free)
        except Exception:
            pass
        out.append(entry)
    return out


def peak_hbm_bytes() -> Optional[int]:
    """Max ``torch.cuda.max_memory_allocated`` across the cards since
    the last peak reset (the job manager resets it when a job takes the
    card), or None without a card."""
    try:
        import torch

        if not torch.cuda.is_available() or \
                not torch.cuda.is_initialized():
            return None
        peaks = [int(torch.cuda.max_memory_allocated(i))
                 for i in range(torch.cuda.device_count())]
    except Exception:
        return None
    peaks = [p for p in peaks if p]
    return max(peaks) if peaks else None


def reset_peak_hbm() -> None:
    """Restart the peak count (the job manager calls it when a job
    takes the card)."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                torch.cuda.reset_peak_memory_stats(i)
    except Exception:
        pass


def host_rss_bytes() -> Optional[int]:
    """Resident set size of this process (stdlib only)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource

        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is KiB on Linux, bytes on macOS
        return rss_kb * 1024 if os.uname().sysname == "Linux" else rss_kb
    except Exception:
        return None


class ClusterMonitor:
    """Background sampler + ring store. Collectors are injected as
    zero-arg callables so the monitor has no import-time dependency on
    the service layer (and tests can feed it fakes)."""

    def __init__(self,
                 interval_seconds: float = 1.0,
                 ring: int = 600,
                 scheduler_stats: Optional[Callable[[], dict]] = None,
                 serving_stats: Optional[Callable[[], dict]] = None,
                 job_stats: Optional[Callable[[], dict]] = None,
                 arena_stats: Optional[Callable[[], dict]] = None,
                 device_stats: Callable[
                     [], List[Dict[str, Any]]] = device_memory_stats,
                 watchdog: Optional[Any] = None):
        self.interval_seconds = max(0.01, float(interval_seconds))
        self._ring = max(8, int(ring))
        self._scheduler_stats = scheduler_stats
        self._serving_stats = serving_stats
        self._job_stats = job_stats
        self._arena_stats = arena_stats
        self._device_stats = device_stats
        self.watchdog = watchdog
        self._lock = locks.make_lock("monitor.rings")
        self._series: Dict[str, "collections.deque"] = {
            name: collections.deque(maxlen=self._ring)
            for name in _SCALAR_SERIES}
        self._latest: Optional[Dict[str, Any]] = None
        self._samples = 0
        self._sample_errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "ClusterMonitor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="lo-monitor", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_seconds):
            try:
                self.sample_once()
            except Exception:
                with self._lock:
                    self._sample_errors += 1

    # -- sampling -----------------------------------------------------

    def _call(self, fn: Optional[Callable[[], Any]]) -> Any:
        if fn is None:
            return None
        try:
            return fn()
        except Exception:
            self._sample_errors += 1
            return None

    def sample_once(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Collect one structured sample, append the scalar rings, and
        run the SLO watchdog. Synchronously callable from tests."""
        now = time.time() if now is None else now
        sample: Dict[str, Any] = {"ts": round(now, 3)}

        devices = self._call(self._device_stats) or []
        sample["devices"] = devices
        in_use = sum(d.get("bytesInUse") or 0 for d in devices)
        peak = sum(d.get("peakBytesInUse") or 0 for d in devices)
        limit = sum(d.get("bytesLimit") or 0 for d in devices)
        sample["hbm"] = {
            "bytesInUse": in_use, "peakBytesInUse": peak,
            "bytesLimit": limit,
            "headroomFrac": (round(1.0 - in_use / limit, 6)
                             if limit else None)}

        arena = self._call(self._arena_stats)
        sample["arena"] = arena
        sched = self._call(self._scheduler_stats)
        sample["scheduler"] = sched
        serving = self._call(self._serving_stats)
        sample["serving"] = serving
        jobs = self._call(self._job_stats)
        sample["jobs"] = jobs
        sample["hostRssBytes"] = host_rss_bytes()

        scalars: Dict[str, Any] = {
            "hbmBytesInUse": in_use or None,
            "hbmPeakBytesInUse": peak or None,
            "hbmHeadroomFrac": sample["hbm"]["headroomFrac"],
            "hostRssBytes": sample["hostRssBytes"],
        }
        if arena:
            scalars["arenaBytesInUse"] = arena.get("bytesInUse")
            scalars["arenaEvictions"] = arena.get("evictions")
        if sched:
            scalars["sliceDevicesBusy"] = sched.get("devicesBusy")
            scalars["sliceFragmentation"] = sched.get("fragmentation")
        if serving:
            scalars["servingQueueDepth"] = serving.get("queueDepth")
            scalars["servingBatchFill"] = serving.get("batchFill")
            scalars["servingKvPagesFree"] = serving.get("kvPagesFree")
            scalars["servingKvPagesShared"] = serving.get(
                "kvPagesShared")
        if jobs:
            scalars["jobsRunning"] = jobs.get("running")
            scalars["jobQueueDepth"] = jobs.get("queued")
            scalars["deadLettered"] = jobs.get("deadLettered")
        try:
            from learningorchestra_tpu_torch.observability import xray

            attributed, unattributed = xray.ring_sample()
            scalars["xrayAttributedBytes"] = attributed
            scalars["xrayUnattributedBytes"] = unattributed
            sample["xray"] = {"attributedBytes": attributed,
                              "unattributedBytes": unattributed,
                              "owners": xray.by_owner()}
        except Exception:  # noqa: BLE001 — sampler is best-effort
            self._sample_errors += 1

        with self._lock:
            for name, value in scalars.items():
                if value is not None and name in self._series:
                    self._series[name].append((round(now, 3), value))
            self._latest = sample
            self._samples += 1

        if self.watchdog is not None:
            try:
                self.watchdog.evaluate(now=now, monitor=self)
            except Exception:
                with self._lock:
                    self._sample_errors += 1
        return sample

    # -- read side ----------------------------------------------------

    def latest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._latest) if self._latest else None

    def series(self, name: str) -> List[Any]:
        with self._lock:
            ring = self._series.get(name)
            return [list(p) for p in ring] if ring else []

    def series_window(self, name: str, window: float,
                      now: Optional[float] = None) -> List[Any]:
        """Samples of one series newer than ``now - window``."""
        now = time.time() if now is None else now
        cutoff = now - window
        return [p for p in self.series(name) if p[0] >= cutoff]

    def snapshot(self) -> Dict[str, Any]:
        """The `/observability/cluster` document."""
        with self._lock:
            series = {name: [list(p) for p in ring]
                      for name, ring in self._series.items() if ring}
            latest = dict(self._latest) if self._latest else None
            samples, errors = self._samples, self._sample_errors
        return {"intervalSeconds": self.interval_seconds,
                "ring": self._ring, "samples": samples,
                "sampleErrors": errors, "latest": latest,
                "series": series}


# -- footprint-calibration registry ----------------------------------
#
# Measured peak device bytes per calibration key ("{root}:{method}" —
# the repeat-execution cache key). In-process and best-effort by design:
# the durable copy is the `peakHbmBytes` field on the job's terminal
# metadata.

_cal_lock = locks.make_lock("monitor.calibration")
_measured_peaks: Dict[str, int] = {}


def record_peak(key: Optional[str], nbytes: Optional[int]) -> None:
    if not key or not nbytes or nbytes <= 0:
        return
    with _cal_lock:
        # keep the high-water mark: a job's footprint must cover its
        # worst observed epoch, not its last
        prior = _measured_peaks.get(key, 0)
        _measured_peaks[key] = max(prior, int(nbytes))


def measured_peak(key: Optional[str]) -> Optional[int]:
    if not key:
        return None
    with _cal_lock:
        return _measured_peaks.get(key)


def calibrated_hbm_bytes(measured: int, estimate: int,
                         margin: float) -> int:
    """Safety-margined measured peak, clamped to within one order of
    magnitude of the static estimate (a wild measurement — e.g. a
    prior run that shared devices — cannot collapse or explode the
    grant)."""
    cal = int(measured * max(1.0, margin))
    if estimate > 0:
        cal = max(cal, estimate // 10)
        cal = min(cal, estimate * 10)
    return cal


def reset_calibration() -> None:
    with _cal_lock:
        _measured_peaks.clear()
