"""Per-step-window training telemetry (the port's copy of the JAX
package's ``observability/timeline.py``).

A fixed-size host-side ring per job, fed by the engine once per
step-window (one epoch) with values the fit loop already pulled to the
host — step index, wall dt, examples/s, loss, health word, and the
roofline block. No extra device syncs: recording is a dict append under
a lock. The port compiles nothing, so ``retrace`` stays False.

Read back over ``GET /observability/timeline/{jobName}`` with summary
percentiles (:func:`summary`).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional
from learningorchestra_tpu_torch.runtime import locks

_MAX_JOBS = 128

_lock = locks.make_lock("timeline.registry")
_rings: "collections.OrderedDict[str, collections.deque]" = \
    collections.OrderedDict()


def _enabled() -> bool:
    from learningorchestra_tpu_torch.observability import get_config

    return bool(getattr(get_config(), "trace", True))


def _ring_size() -> int:
    from learningorchestra_tpu_torch.observability import get_config

    return max(8, int(getattr(get_config(), "timeline_ring", 4096)))


def record(job: str, *, step: int, dt: float,
           examples_per_second: float = 0.0,
           loss: Optional[float] = None,
           grad_norm: Optional[float] = None,
           healthy_steps: Optional[int] = None,
           bad_steps: Optional[int] = None,
           retrace: bool = False, **extra: Any) -> None:
    """Append one step-window entry to ``job``'s ring. Best-effort
    and cheap; silently a no-op when tracing is off."""
    if not _enabled():
        return
    entry: Dict[str, Any] = {
        "step": int(step), "dtSeconds": round(float(dt), 6),
        "examplesPerSecond": round(float(examples_per_second), 3),
        "retrace": bool(retrace)}
    if loss is not None:
        entry["loss"] = float(loss)
    if grad_norm is not None:
        entry["gradNorm"] = float(grad_norm)
    if healthy_steps is not None:
        entry["healthySteps"] = int(healthy_steps)
    if bad_steps is not None:
        entry["badSteps"] = int(bad_steps)
    entry.update(extra)
    with _lock:
        ring = _rings.get(job)
        if ring is None:
            ring = _rings[job] = collections.deque(
                maxlen=_ring_size())
            while len(_rings) > _MAX_JOBS:
                _rings.popitem(last=False)
        else:
            _rings.move_to_end(job)
        ring.append(entry)


def entries(job: str) -> List[Dict[str, Any]]:
    with _lock:
        ring = _rings.get(job)
        return list(ring) if ring else []


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def summary(job: str) -> Optional[Dict[str, Any]]:
    """p50/p90/p99 over dt and examples/s (the ring itself is read
    with :func:`entries`), or None for an unknown job."""
    rows = entries(job)
    if not rows:
        return None
    dts = sorted(r["dtSeconds"] for r in rows)
    eps = sorted(r["examplesPerSecond"] for r in rows)
    out: Dict[str, Any] = {
        "job": job, "windows": len(rows),
        "steps": max(r["step"] for r in rows),
        "retraces": sum(1 for r in rows if r["retrace"]),
        "dtSeconds": {"p50": _percentile(dts, 0.50),
                      "p90": _percentile(dts, 0.90),
                      "p99": _percentile(dts, 0.99),
                      "sum": round(sum(dts), 6)},
        "examplesPerSecond": {"p50": _percentile(eps, 0.50),
                              "p90": _percentile(eps, 0.90),
                              "p99": _percentile(eps, 0.99)}}
    losses = [r["loss"] for r in rows if "loss" in r]
    if losses:
        out["lastLoss"] = losses[-1]
    bad = sum(r.get("badSteps", 0) for r in rows)
    if bad:
        out["badSteps"] = bad
    # roofline block (observability/perf): present only on windows
    # that carry it, so summarize over those
    perf: Dict[str, Any] = {}
    for key in ("mfu", "tflopsPerSecPerChip", "gbPerSecPerChip",
                "hbmBwUtil"):
        vals = sorted(float(r[key]) for r in rows if key in r)
        if vals:
            perf[key] = {"p50": _percentile(vals, 0.50),
                         "p90": _percentile(vals, 0.90),
                         "max": vals[-1]}
    bounds = [r["boundBy"] for r in rows if "boundBy" in r]
    if bounds:
        perf["boundBy"] = bounds[-1]
    if perf:
        out["perf"] = perf
    return out


def known_jobs() -> List[str]:
    with _lock:
        return list(_rings.keys())


def reset() -> None:
    with _lock:
        _rings.clear()
