"""Weighted-fair access to the card: pools, the epoch-boundary yield and
the serving lease (the one-card half of the JAX package's
``services/scheduler.py``, its counting mode at ``LO_MESH_LEASES=1``).

:class:`SliceLease` is the lease every card job and every serving
session goes through:

- **Pools** — each job class (``train``, ``tune``, ``evaluate``,
  ``predict``, ``builder``, ``serving``, …) is a pool. The card goes to
  the pool with the LOWEST served seconds over weight among the pools
  with waiters (weighted fair queuing), FIFO within a pool, so a burst
  of tunes cannot starve a train and the other way round. Served
  seconds decay with the half-life ``LO_FAIR_SERVED_HALF_LIFE``, so
  fairness follows recent use; ``LO_POOL_WEIGHTS="train=2,tune=1"``
  biases the share (unlisted pools weigh 1).
- **Epoch-boundary yield** — a granted lease installs a thread-local
  yield point (:mod:`runtime.preempt`); the engine's epoch loops call
  it between epochs. If a job of ANOTHER pool waits, the holder
  releases, the waiter runs, and the holder queues again through the
  same fair policy. ``LO_MESH_YIELD=0`` turns this off: the lease is
  then the strict fair queue with no hand-off inside a job.
- **Serving lease** — a resident session holds a :class:`ServingLease`
  (pool ``serving``) for its lifetime and, under the default
  ``preempt`` policy (``LO_SERVE_LEASE_POLICY``), offers the card back
  between decode iterations to ANY waiter; ``hold`` keeps it until the
  session is deleted.

One card is the JAX lease's counting mode: capacity 1, no device plane,
every grant is the whole card. Device slices, aging, defragmentation and
migration need several devices and are not here.

Caveat (as in the JAX package): a yielded job's tensors stay on the card
while the job it yielded to runs, so two jobs whose combined footprint
exceeds the card's memory can run out where strict serialization would
not. ``LO_MESH_YIELD=0`` is the setting for such deployments.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional

from learningorchestra_tpu_torch.observability import hist as obs_hist
from learningorchestra_tpu_torch.runtime import locks, preempt


def parse_pool_weights(spec: str) -> Dict[str, float]:
    """``"train=2,tune=1"`` -> ``{"train": 2.0, "tune": 1.0}``."""
    weights: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, value = part.partition("=")
        try:
            weights[name.strip()] = float(value)
        except ValueError as exc:
            raise ValueError(
                f"bad pool weight {part!r} (want name=number)") from exc
    return weights


class Grant:
    """A claimed (or reserved) hold of the card, always the whole
    card."""

    __slots__ = ("seq", "pool", "wait_seconds")

    def __init__(self, seq: int, pool: str):
        self.seq = seq
        self.pool = pool
        self.wait_seconds = 0.0


class _Waiter:
    __slots__ = ("seq", "pool", "enqueued")

    def __init__(self, seq: int, pool: str, enqueued: float):
        self.seq = seq
        self.pool = pool
        self.enqueued = enqueued


class SliceLease:
    """Weighted-fair lease of the card: one holder at a time."""

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 served_half_life_seconds: float = 600.0,
                 mesh_yield: bool = True):
        self._weights = dict(weights or {})
        self._cv = locks.make_condition("scheduler.fair")
        # pool -> held card seconds, decayed with the half-life below so
        # the fair-share order follows RECENT use (0 = no decay)
        self._served: Dict[str, float] = {}
        self._served_half_life = max(
            0.0, float(served_half_life_seconds or 0.0))
        self._served_decayed_at = time.monotonic()
        self._yield = bool(mesh_yield)
        self._waiters: list = []              # [_Waiter] arrival order
        self._granted: Dict[int, Grant] = {}  # reserved, not yet claimed
        self._holders: Dict[int, Grant] = {}  # claimed
        self._seq = 0
        self._grants_by_pool: Dict[str, int] = {}
        self._wait_sum = 0.0
        self._wait_count = 0
        self._wait_max = 0.0

    # -- policy --------------------------------------------------------
    def _weight(self, pool: str) -> float:
        w = float(self._weights.get(pool, 1.0))
        return w if w > 0 else 1.0

    def _decay_served_locked(self) -> None:
        """With the lock held: applies the half-life to every pool's
        served seconds (lazily, whenever the totals are read or
        written)."""
        if not self._served_half_life:
            return
        now = time.monotonic()
        elapsed = now - self._served_decayed_at
        if elapsed <= 0.0:
            return
        self._served_decayed_at = now
        if not self._served:
            return
        factor = 0.5 ** (elapsed / self._served_half_life)
        for pool in list(self._served):
            decayed = self._served[pool] * factor
            if decayed < 1e-6:
                del self._served[pool]  # a fully forgotten pool
            else:
                self._served[pool] = decayed

    def _grant_next(self) -> None:
        """With the lock held: gives a free card to the head waiter of
        the most deserving pool (least served over weight, then
        arrival)."""
        self._decay_served_locked()
        if not self._waiters or self._holders or self._granted:
            return
        heads = []
        seen: set = set()
        for w in self._waiters:
            if w.pool not in seen:
                seen.add(w.pool)
                heads.append(w)
        w = min(heads, key=lambda w: (
            self._served.get(w.pool, 0.0) / self._weight(w.pool), w.seq))
        self._waiters.remove(w)
        self._granted[w.seq] = Grant(w.seq, w.pool)
        self._cv.notify_all()

    # -- mechanics -----------------------------------------------------
    def acquire(self, pool: str = "default",
                cancel: Optional[preempt.CancelToken] = None) -> Grant:
        """Blocks until granted. With a ``cancel`` token the wait is
        cooperative: a cancelled or expired job raises
        :class:`preempt.JobCancelled` from the queue, and a grant that
        races the cancel is handed on to the next waiter."""
        t0 = time.monotonic()
        with self._cv:
            seq = self._seq
            self._seq += 1
            waiter = _Waiter(seq, pool, t0)
            self._waiters.append(waiter)
            self._grant_next()
            while seq not in self._granted:
                # a token does not notify the condition: poll it
                self._cv.wait(0.1 if cancel is not None else None)
                if cancel is not None and cancel.cancelled():
                    if self._granted.pop(seq, None) is None:
                        self._waiters.remove(waiter)
                    self._grant_next()
                    raise preempt.JobCancelled(
                        cancel.reason or "cancelled",
                        "cancelled while waiting for the mesh lease")
            grant = self._granted.pop(seq)
            self._holders[seq] = grant
            grant.wait_seconds = time.monotonic() - t0
            self._wait_sum += grant.wait_seconds
            self._wait_count += 1
            self._wait_max = max(self._wait_max, grant.wait_seconds)
            self._grants_by_pool[pool] = \
                self._grants_by_pool.get(pool, 0) + 1
            # every grant (a job's and a serving session's) feeds the
            # lease-wait histogram here, the one site
            obs_hist.observe("lo_lease_wait_seconds", grant.wait_seconds)
            return grant

    def release(self, pool: str, held_seconds: float,
                grant: Grant) -> None:
        with self._cv:
            self._holders.pop(grant.seq, None)
            self._decay_served_locked()
            self._served[pool] = self._served.get(pool, 0.0) \
                + max(0.0, held_seconds)
            self._grant_next()

    def contended(self) -> bool:
        """ANY waiter is queued (those still queued are exactly the ones
        that cannot be granted now). A serving session yields on this:
        it never finishes, so a same-pool waiter behind it would starve
        under the same-pool FIFO rule of :meth:`contended_by_other`."""
        with self._cv:
            return bool(self._waiters)

    def contended_by_other(self, pool: str) -> bool:
        """A waiter from a DIFFERENT pool exists: the only condition
        under which a job yields (same-pool waiters are served in order
        when the holder finishes)."""
        with self._cv:
            return any(w.pool != pool for w in self._waiters)

    def served(self) -> Dict[str, float]:
        """Recent card seconds per pool, decayed by the half-life."""
        with self._cv:
            self._decay_served_locked()
            return dict(self._served)

    def stats(self) -> Dict[str, Any]:
        """Occupancy, grant counts and lease-wait aggregates, in the JAX
        counting mode's shape: ``devicesBusy`` counts busy leases (0 or
        1), ``devicesTotal`` is None and nothing is sliced."""
        with self._cv:
            now = time.monotonic()
            oldest = max((now - w.enqueued for w in self._waiters),
                         default=0.0)
            return {
                "sliced": False,
                "capacity": 1,
                "devicesTotal": None,
                "devicesBusy": len(self._holders) + len(self._granted),
                "devicesFree": 0,
                "largestFreeRun": 0,
                "fragmentation": 0.0,
                "waiters": len(self._waiters),
                "agedWaiters": 0,
                "oldestWaitSeconds": round(oldest, 6),
                "defrags": 0,
                "grantsByPool": dict(self._grants_by_pool),
                "leaseWaitSum": self._wait_sum,
                "leaseWaitCount": self._wait_count,
                "leaseWaitMax": self._wait_max,
            }

    # -- job-facing surface --------------------------------------------
    @contextlib.contextmanager
    def lease(self, pool: str = "default",
              cancel: Optional[preempt.CancelToken] = None,
              ) -> Iterator["LeaseToken"]:
        """Holds the card fairly for the ``with`` body and installs the
        epoch-boundary yield point there, so an engine fit on this
        thread hands the card to a waiting pool between epochs. Yields a
        :class:`LeaseToken` (``wait_seconds``: the queue wait;
        ``preempted_seconds`` and ``yields``: the hand-offs). With a
        ``cancel`` token the first acquire and every re-acquire after a
        yield raise :class:`preempt.JobCancelled` once the job is
        cancelled or past its deadline."""
        grant = self.acquire(pool, cancel)
        token = LeaseToken()
        token.wait_seconds = grant.wait_seconds
        current = [grant]
        start = [time.monotonic()]
        held = [True]
        can_yield = self._yield

        def yield_point() -> None:
            if not can_yield or not self.contended_by_other(pool):
                return
            self.release(pool, time.monotonic() - start[0],
                         grant=current[0])
            held[0] = False
            t_wait = time.monotonic()
            current[0] = self.acquire(pool, cancel)
            held[0] = True
            start[0] = time.monotonic()
            token.preempted_seconds += start[0] - t_wait
            token.yields += 1

        previous = preempt.snapshot()
        preempt.install(
            yield_point,
            contended_fn=lambda: can_yield and self.contended_by_other(pool))
        try:
            yield token
        finally:
            preempt.restore(previous)
            if held[0]:
                self.release(pool, time.monotonic() - start[0],
                             grant=current[0])


class ServingLease:
    """The card for a resident serving session's lifetime, through the
    same fair queue as the jobs (pool ``serving``). Under ``"preempt"``
    the session calls :meth:`maybe_yield` between decode iterations and
    on each idle tick: with ANY waiter queued it releases, queues again
    and returns True once it holds the card again (the caller then
    re-pins what it keeps on the card). ``"hold"`` never yields: the
    session keeps the card until it is deleted, and every card job
    waits for that."""

    def __init__(self, slices: SliceLease, pool: str = "serving",
                 policy: str = "preempt"):
        self._slices = slices
        self._pool = pool
        self._policy = policy if policy in ("preempt", "hold") \
            else "preempt"
        self._grant: Optional[Grant] = None
        self._acquired = 0.0
        self._lock = locks.make_lock("scheduler.servinglease")
        self.yields = 0
        self.wait_seconds = 0.0

    def acquire(self) -> None:
        """Blocks until the session holds the card."""
        grant = self._slices.acquire(self._pool)
        with self._lock:
            self._grant = grant
            self._acquired = time.monotonic()
            self.wait_seconds += grant.wait_seconds

    def maybe_yield(self) -> bool:
        """Hands the card to the waiters and takes it back (``"preempt"``
        only); True when a hand-off happened."""
        if self._policy != "preempt":
            return False
        if not self._slices.contended():
            return False
        with self._lock:
            grant = self._grant
            if grant is None:
                return False
            self._slices.release(
                self._pool, time.monotonic() - self._acquired, grant=grant)
            self._grant = None
        # queue again outside the lock: the wait lasts as long as the job
        # it yielded to, and stats() must stay readable meanwhile
        grant = self._slices.acquire(self._pool)
        with self._lock:
            self._grant = grant
            self._acquired = time.monotonic()
            self.wait_seconds += grant.wait_seconds
            self.yields += 1
        return True

    def release(self) -> None:
        """Gives the card back for good (the session's delete); a second
        call does nothing."""
        with self._lock:
            grant = self._grant
            if grant is None:
                return
            self._grant = None
            held = time.monotonic() - self._acquired
        self._slices.release(self._pool, held, grant=grant)

    def stats(self) -> Dict[str, Any]:
        """The JAX serving lease's keys: one card has no prefill role
        and no device slice to name."""
        with self._lock:
            return {
                "pool": self._pool,
                "policy": self._policy,
                "role": "",
                "held": self._grant is not None,
                "devices": None,
                "yields": self.yields,
                "waitSeconds": round(self.wait_seconds, 6),
            }


class LeaseToken:
    """One hold's accounting: the queue wait, the seconds spent yielded
    to another pool, and the number of hand-offs."""

    def __init__(self) -> None:
        self.preempted_seconds = 0.0
        self.yields = 0
        self.wait_seconds = 0.0
