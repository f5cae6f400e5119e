"""Fixed-bucket latency histograms (the port's copy of the JAX
package's ``observability/hist.py``: the same bucket edges and series).

Prometheus-shaped cumulative-bucket histograms replacing the
sum/count-only summaries: scrapers (and the CI gates) can compute
p50/p99 from ``_bucket``/``le`` series. Stdlib-only, thread-safe,
process-global registry; the server exports every registered
histogram in both the JSON ``/metrics`` block and the Prometheus
text format.

Registered series (docs/OBSERVABILITY.md):

- ``lo_dispatch_seconds`` — REST dispatch latency per request;
- ``lo_lease_wait_seconds`` — slice-lease queue wait per grant;
- ``lo_serving_request_seconds`` — serving request latency
  (submit → respond);
- ``lo_compile_seconds`` — engine compile/lowering wall clock (the
  port compiles nothing: it never observes this series);
- ``lo_checkpoint_commit_seconds`` — checkpoint commit wall clock.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple
from learningorchestra_tpu_torch.runtime import locks

# le-style upper bounds (seconds); +Inf is implicit
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

_lock = locks.make_lock("hist.registry")
_registry: Dict[str, "Histogram"] = {}


class Histogram:
    """One fixed-bucket histogram. Counts are per-bucket (NOT
    cumulative internally); snapshots emit the cumulative form the
    exposition format wants."""

    __slots__ = ("name", "buckets", "_counts", "_sum", "_count",
                 "_lock")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = locks.make_lock("hist.buckets")

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return
        idx = len(self.buckets)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Dict[str, object]:
        """JSON form: cumulative counts keyed by ``le`` (stringified
        bound, ``+Inf`` last), plus sum/count."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cumulative: List[Tuple[str, int]] = []
        running = 0
        for ub, c in zip(self.buckets, counts):
            running += c
            cumulative.append((_fmt_le(ub), running))
        cumulative.append(("+Inf", running + counts[-1]))
        return {"buckets": {le: n for le, n in cumulative},
                "sum": round(s, 6), "count": total}

    def quantile(self, q: float) -> float:
        """Prometheus-style linear-interpolated quantile estimate
        from the buckets (upper-bound of the target bucket, no
        intra-bucket interpolation — good enough for gates)."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return 0.0
        target = q * total
        running = 0
        for ub, c in zip(self.buckets, counts):
            running += c
            if running >= target:
                return ub
        return float("inf")


def _fmt_le(ub: float) -> str:
    # Prometheus renders bounds as shortest repr: 0.005, 1.0 -> "1.0"
    return repr(float(ub))


def get(name: str,
        buckets: Optional[Sequence[float]] = None) -> Histogram:
    with _lock:
        h = _registry.get(name)
        if h is None:
            h = _registry[name] = Histogram(
                name, buckets or DEFAULT_BUCKETS)
        return h


def observe(name: str, value: float) -> None:
    """Record into the named histogram, creating it on first use.
    Never raises (observability is best-effort)."""
    try:
        get(name).observe(value)
    except Exception:  # noqa: BLE001
        pass


def names() -> List[str]:
    """Registered histogram names (the SLO watchdog scans these to
    discover per-tenant serving series)."""
    with _lock:
        return list(_registry)


def snapshot_all() -> Dict[str, Dict[str, object]]:
    with _lock:
        hists = list(_registry.values())
    return {h.name: h.snapshot() for h in hists}


def prometheus_lines(esc) -> List[str]:
    """Exposition-format lines for every registered histogram.
    ``esc`` is the server's label-value escaper (single source of
    truth for escaping rules)."""
    out: List[str] = []
    for name, snap in sorted(snapshot_all().items()):
        out.append(f"# TYPE {name} histogram")
        for le, n in snap["buckets"].items():  # type: ignore[union-attr]
            out.append(f'{name}_bucket{{le="{esc(le)}"}} {n}')
        out.append(f"{name}_sum {snap['sum']}")
        out.append(f"{name}_count {snap['count']}")
    return out


def reset() -> None:
    with _lock:
        _registry.clear()
