"""Named, ranked locks (the serving, job and fault-injection rows of the
JAX package's ``runtime/locks.py`` hierarchy).

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
    "faults.spec": 360,            # fault-injection budget (leaf)
    "attention.launches": 370,     # the kernels' launch counters (leaf)
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
