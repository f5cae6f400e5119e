"""Named, ranked locks (the serving, job, lifecycle, cache, gateway,
catalog, fault-injection, async checkpoint, sweep fusion and
observability rows of the JAX package's
``runtime/locks.py`` hierarchy).

:data:`HIERARCHY` ranks every named lock of the port: a thread acquires
a lock only while every lock it holds has a strictly lower rank. The
factories reject names that are not declared. The runtime witness that
checks the order while the program runs is not ported yet; the factories
return plain ``threading`` primitives.
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["HIERARCHY", "make_lock", "make_condition"]

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
    "serving.prefix": 75,          # prefix-cache index; eviction
                                   # decrefs the pool under it
    "scheduler.fair": 80,          # the card lease's FIFO queue
    "serving.kvpool": 90,          # paged-KV free list / refcounts
    "serving.latency": 100,        # per-session latency ring
    "async_ckpt.error": 120,       # latched commit-worker error
    "preempt.token": 130,          # per-job cancel token
    "health.counters": 140,        # sentinel counters (listeners are
                                   # called outside it)
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
    "attention.launches": 370,     # the kernels' launch counters (leaf)
    "sweep.fusion": 390,           # the sweeps' fusion counters (leaf)
}


def _rank_of(name: str) -> int:
    try:
        return HIERARCHY[name]
    except KeyError:
        raise KeyError(
            f"lock name {name!r} is not declared in "
            f"learningorchestra_tpu_torch.runtime.locks.HIERARCHY — add "
            f"a ranked row") from None


def make_lock(name: str):
    _rank_of(name)
    return threading.Lock()


def make_condition(name: str):
    _rank_of(name)
    return threading.Condition()
