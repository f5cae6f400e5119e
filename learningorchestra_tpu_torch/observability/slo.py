"""SLO watchdog of the port (the JAX package's
``observability/slo.py``; docs/OBSERVABILITY.md "Cluster monitor, SLOs
& alerts").

Declarative objectives — serving p99 latency, lease queue wait, HBM
headroom, dead-letter rate — are evaluated every monitor tick over a
**fast** and a **slow** burn-rate window (``LO_SLO_FAST_WINDOW_S`` /
``LO_SLO_SLOW_WINDOW_S``): an objective fires only when it is
breached in BOTH windows (acute *and* sustained), and resolves as
soon as the fast window clears, so a transient spike neither pages
nor flaps.

Latency objectives are computed from the cumulative histograms
(:mod:`.hist`) by differencing bucket snapshots taken at window
boundaries — a windowed p99 from counters that only ever grow.
Resource objectives read the sampler rings
(:class:`.monitor.ClusterMonitor`).

Firing → resolved transitions are appended to the ``LO_EVENT_LOG``
JSONL (:func:`.export.log_event`) with the active job/serving trace
name attached, so an alert correlates with the trace that caused it
in one file. A firing **page**-severity alert flips ``GET /healthz``
to 503 (services/server.py).
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional

from learningorchestra_tpu_torch.observability import export as obs_export
from learningorchestra_tpu_torch.observability import hist as obs_hist
from learningorchestra_tpu_torch.observability import incidents as obs_incidents
from learningorchestra_tpu_torch.runtime import locks

_HISTORY = 256

# per-tenant serving latency series emitted by the paged serving
# session (services/serving.py); each discovered tenant gets its own
# page-severity servingP99 objective so one tenant breaching cannot
# hide behind (or be blamed on) the aggregate
_TENANT_HIST_PREFIX = "lo_serving_request_seconds_tenant_"

# per-role serving latency series (prefill/decode/draft — a CLOSED
# set, services/serving.py) emitted by the disaggregated/speculative
# serving path; each role gets a ticket-severity p99 objective so a
# prefill-side regression is attributed to the prefill worker instead
# of smearing across the aggregate
_ROLE_HIST_PREFIX = "lo_serving_request_seconds_role_"

# ----------------------------------------------------------------------
# producer-pushed gauges: latest value + timestamp, for signals that
# have no histogram or sampler ring behind them (the quantized-serving
# drift probe pushes ``servingDrift`` here). The watchdog reads them in
# _measure with the window as a freshness bound, so a gauge whose
# producer stopped updating (session degraded/closed) ages out and the
# alert resolves instead of firing on stale data forever.
# ----------------------------------------------------------------------
_gauge_lock = locks.make_lock("slo.gauges")
_gauges: Dict[str, tuple] = {}


def set_gauge(name: str, value: float,
              now: Optional[float] = None) -> None:
    """Record the latest value of a pushed gauge (thread-safe)."""
    with _gauge_lock:
        _gauges[name] = (float(value),
                         time.time() if now is None else now)


def get_gauge(name: str, max_age: Optional[float] = None,
              now: Optional[float] = None) -> Optional[float]:
    """Latest value of ``name``, or None when unset or older than
    ``max_age`` seconds."""
    with _gauge_lock:
        entry = _gauges.get(name)
    if entry is None:
        return None
    value, ts = entry
    if max_age is not None:
        now = time.time() if now is None else now
        if now - ts > max_age:
            return None
    return value


def gauges() -> Dict[str, float]:
    """All pushed gauges (latest values), for /metrics export."""
    with _gauge_lock:
        return {name: entry[0] for name, entry in _gauges.items()}


def reset_gauges() -> None:
    """Test isolation."""
    with _gauge_lock:
        _gauges.clear()


class _HistWindow:
    """Bounded ring of (ts, cumulative-bucket-snapshot) pairs for one
    histogram, supporting windowed quantiles by snapshot diffing."""

    def __init__(self, name: str, keep: int = 512):
        self.name = name
        self._samples: "collections.deque" = collections.deque(
            maxlen=keep)

    def observe(self, now: float) -> None:
        snap = obs_hist.get(self.name).snapshot()
        self._samples.append((now, snap["buckets"]))

    def quantile_over(self, q: float, window: float,
                      now: float) -> Optional[float]:
        """q-quantile (bucket upper bound, seconds) of observations in
        ``[now - window, now]``, or None when the window saw no
        traffic."""
        if not self._samples:
            return None
        latest = self._samples[-1][1]
        cutoff = now - window
        baseline: Optional[Dict[str, int]] = None
        for ts, buckets in reversed(self._samples):
            if ts <= cutoff:
                baseline = buckets
                break
        # no snapshot predates the window: the whole history IS the
        # window (monitor younger than the window)
        get_base = baseline.get if baseline else (lambda _k, _d=0: 0)
        deltas = []
        for le, cum in latest.items():
            ub = float("inf") if le == "+Inf" else float(le)
            deltas.append((ub, cum - get_base(le, 0)))
        deltas.sort(key=lambda p: p[0])
        total = deltas[-1][1] if deltas else 0
        if total <= 0:
            return None
        target = q * total
        for ub, cum in deltas:
            if cum >= target:
                return ub
        return deltas[-1][0]


class Alert:
    """One objective's alert state."""

    __slots__ = ("name", "severity", "threshold", "state", "since",
                 "value", "trace")

    def __init__(self, name: str, severity: str, threshold: float):
        self.name = name
        self.severity = severity
        self.threshold = threshold
        self.state = "ok"
        self.since: Optional[float] = None
        self.value: Optional[float] = None
        self.trace: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "severity": self.severity,
                "state": self.state, "sinceUnixSeconds": self.since,
                "value": self.value, "threshold": self.threshold,
                "trace": self.trace}


class SloWatchdog:
    """Evaluates the configured objectives; owns alert state."""

    def __init__(self,
                 active_trace: Optional[Callable[
                     [], Optional[str]]] = None):
        self._active_trace = active_trace
        self._lock = locks.make_lock("slo.alerts")
        self._alerts: Dict[str, Alert] = {}
        self._history: "collections.deque" = collections.deque(
            maxlen=_HISTORY)
        self._serving = _HistWindow("lo_serving_request_seconds")
        self._lease = _HistWindow("lo_lease_wait_seconds")
        # tenant -> window, discovered lazily from the hist registry
        self._tenant_serving: Dict[str, _HistWindow] = {}
        # role -> window (prefill/decode/draft), same discovery path
        self._role_serving: Dict[str, _HistWindow] = {}

    # -- config -------------------------------------------------------

    @staticmethod
    def _cfg():
        from learningorchestra_tpu_torch.observability import get_config

        return get_config()

    def objectives(self) -> Dict[str, Dict[str, Any]]:
        cfg = self._cfg()
        out: Dict[str, Dict[str, Any]] = {
            "servingP99": {
                "severity": "page",
                "threshold": float(cfg.slo_serving_p99_ms),
                "unit": "ms"},
            "queueWait": {
                "severity": "ticket",
                "threshold": float(cfg.slo_queue_wait_s),
                "unit": "s"},
            "hbmHeadroom": {
                "severity": "page",
                "threshold": float(cfg.slo_hbm_headroom_frac),
                "unit": "frac"},
            "deadLetterRate": {
                "severity": "ticket",
                "threshold": float(cfg.slo_deadletter_rate),
                "unit": "perMin"},
            # leak detector (observability/xray): sustained growth of
            # device bytes NOBODY in the ledger owns — temporaries are
            # sawtooth, a leak (or an unledgered allocation site) is
            # monotone across both windows
            "unattributedGrowth": {
                "severity": "page",
                "threshold": float(getattr(
                    cfg, "slo_unattributed_growth_bytes", 0.0)),
                "unit": "bytes"},
            # quantized-serving quality gate: the drift probe
            # (services/serving.py) pushes its latest relative error
            # here; the session degrades itself to bf16 on breach, this
            # objective is the paper trail that it happened
            "servingDrift": {
                "severity": "ticket",
                "threshold": float(getattr(
                    cfg, "serve_drift_max", 0.0)),
                "unit": "frac"},
        }
        thr = float(cfg.slo_serving_p99_ms)
        for tenant in sorted(list(self._tenant_serving)):
            out[f"servingP99:{tenant}"] = {
                "severity": "page", "threshold": thr, "unit": "ms"}
        for role in sorted(list(self._role_serving)):
            out[f"servingRoleP99:{role}"] = {
                "severity": "ticket", "threshold": thr, "unit": "ms"}
        return out

    # -- evaluation ---------------------------------------------------

    def evaluate(self, now: Optional[float] = None,
                 monitor: Optional[Any] = None) -> None:
        """One watchdog tick. ``monitor`` supplies the resource rings;
        latency objectives need only the histograms."""
        now = time.time() if now is None else now
        cfg = self._cfg()
        fast = max(0.1, float(cfg.slo_fast_window_s))
        slow = max(fast, float(cfg.slo_slow_window_s))
        self._serving.observe(now)
        self._lease.observe(now)
        for name in obs_hist.names():
            if name.startswith(_TENANT_HIST_PREFIX):
                tenant = name[len(_TENANT_HIST_PREFIX):]
                if tenant not in self._tenant_serving:
                    self._tenant_serving[tenant] = _HistWindow(name)
            elif name.startswith(_ROLE_HIST_PREFIX):
                role = name[len(_ROLE_HIST_PREFIX):]
                if role not in self._role_serving:
                    self._role_serving[role] = _HistWindow(name)
        for win in self._tenant_serving.values():
            win.observe(now)
        for win in self._role_serving.values():
            win.observe(now)
        objectives = self.objectives()

        for name, spec in objectives.items():
            thr = spec["threshold"]
            if not thr or thr <= 0:
                self._retire(name, now)
                continue
            fast_val = self._measure(name, monitor, fast, now)
            fast_breach = fast_val is not None and self._breached(
                name, fast_val, thr)
            if fast_breach:
                slow_val = self._measure(name, monitor, slow, now)
                slow_breach = slow_val is not None and self._breached(
                    name, slow_val, thr)
            else:
                slow_val, slow_breach = None, False
            self._transition(name, spec, fast_breach and slow_breach,
                             fast_breach,
                             fast_val if fast_val is not None
                             else slow_val, now)

    def _measure(self, name: str, monitor: Optional[Any],
                 window: float, now: float) -> Optional[float]:
        if name == "servingP99":
            p99 = self._serving.quantile_over(0.99, window, now)
            return None if p99 is None else p99 * 1000.0
        if name.startswith("servingP99:"):
            win = self._tenant_serving.get(name.split(":", 1)[1])
            if win is None:
                return None
            p99 = win.quantile_over(0.99, window, now)
            return None if p99 is None else p99 * 1000.0
        if name.startswith("servingRoleP99:"):
            win = self._role_serving.get(name.split(":", 1)[1])
            if win is None:
                return None
            p99 = win.quantile_over(0.99, window, now)
            return None if p99 is None else p99 * 1000.0
        if name == "queueWait":
            return self._lease.quantile_over(0.99, window, now)
        if name == "hbmHeadroom":
            if monitor is None:
                return None
            pts = monitor.series_window("hbmHeadroomFrac", window, now)
            return min((p[1] for p in pts), default=None)
        if name == "deadLetterRate":
            if monitor is None:
                return None
            pts = monitor.series_window("deadLettered", window, now)
            if len(pts) < 2:
                return None
            span = max(pts[-1][0] - pts[0][0], 1e-9)
            return (pts[-1][1] - pts[0][1]) / span * 60.0
        if name == "servingDrift":
            # pushed gauge; the window doubles as the freshness bound
            return get_gauge("servingDrift", max_age=window, now=now)
        if name == "unattributedGrowth":
            if monitor is None:
                return None
            pts = monitor.series_window("xrayUnattributedBytes",
                                        window, now)
            if len(pts) < 2:
                return None
            return float(pts[-1][1] - pts[0][1])
        return None

    @staticmethod
    def _breached(name: str, value: float, threshold: float) -> bool:
        # headroom is a floor (too LITTLE memory breaches); the other
        # objectives are ceilings
        if name == "hbmHeadroom":
            return value < threshold
        return value > threshold

    # -- state transitions --------------------------------------------

    def _transition(self, name: str, spec: Dict[str, Any],
                    fire: bool, fast_breach: bool,
                    value: Optional[float], now: float) -> None:
        with self._lock:
            alert = self._alerts.get(name)
            if alert is None:
                alert = self._alerts[name] = Alert(
                    name, spec["severity"], spec["threshold"])
            alert.threshold = spec["threshold"]
            if value is not None:
                alert.value = round(value, 6)
            was_firing = alert.state == "firing"
            if not was_firing and fire:
                alert.state = "firing"
                alert.since = now
                alert.trace = self._trace()
                self._record(alert, "firing", now)
            elif was_firing and not fast_breach:
                alert.state = "ok"
                self._record(alert, "resolved", now)
                alert.since = None

    def _retire(self, name: str, now: float) -> None:
        """Objective disabled (threshold 0): resolve if firing."""
        with self._lock:
            alert = self._alerts.get(name)
            if alert is not None and alert.state == "firing":
                alert.state = "ok"
                self._record(alert, "resolved", now)
                alert.since = None

    def _trace(self) -> Optional[str]:
        if self._active_trace is None:
            return None
        try:
            return self._active_trace()
        except Exception:
            return None

    def _record(self, alert: Alert, transition: str,
                now: float) -> None:
        """Caller holds ``self._lock``. Event-log write is strictly
        best-effort (log_event already swallows)."""
        entry = dict(alert.to_dict(), transition=transition,
                     atUnixSeconds=round(now, 3))
        self._history.append(entry)
        obs_export.log_event(
            "alert", f"{alert.name}.{transition}",
            trace_id=alert.trace, severity=alert.severity,
            value=alert.value, threshold=alert.threshold)
        if transition == "firing":
            # flight-recorder hook. MUST stay a cheap enqueue: we hold
            # the watchdog's non-reentrant lock here, and the capture
            # worker will call snapshot() on this very watchdog
            obs_incidents.trigger(
                f"slo:{alert.name}", trace=alert.trace,
                alert=entry)

    # -- read side ----------------------------------------------------

    def firing(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [a.to_dict() for a in self._alerts.values()
                    if a.state == "firing"]

    def firing_count(self) -> int:
        return len(self.firing())

    def page_firing(self) -> bool:
        return any(a["severity"] == "page" for a in self.firing())

    def snapshot(self) -> Dict[str, Any]:
        """The `/observability/alerts` document."""
        with self._lock:
            alerts = [a.to_dict() for a in self._alerts.values()]
            history = list(self._history)
        return {"objectives": self.objectives(), "alerts": alerts,
                "firing": [a for a in alerts
                           if a["state"] == "firing"],
                "history": history}
