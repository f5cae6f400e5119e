"""Device-memory feature arena: the card tier of the feature-plane cache
(the port's copy of the JAX package's ``runtime/arena.py``).

A fit used to copy its dataset to the card on every job, even when the
same dataset version had been staged seconds earlier by another
classifier or pipeline step. The arena keeps staged tensors resident
between jobs:

- entries are dicts of ``torch.Tensor`` keyed by an opaque content token
  (dataset versions, projection, dtype policy) plus the device they were
  staged on;
- a byte budget (``LO_ARENA_BYTES``; by default a quarter of the card's
  memory as ``torch.cuda.mem_get_info`` reports it, 1 GiB for tensors on
  the CPU) bounds residency with LRU eviction;
- readers *pin* entries while a fit consumes them. Eviction only unlinks
  an entry from the table; the tensors stay alive until the last pin
  (Python reference) drops, so an in-flight fit never sees a freed
  batch. Pins are released in ``finally`` blocks, so cancelled and
  timed-out jobs release them on the ``JobCancelled`` unwind;
- write invalidation is driven by the catalog change feed through
  per-entry *tags* (collection names): ``invalidate(name)`` drops every
  entry staged from that collection.

Resident entries are mirrored into the X-ray ledger under owner
``arena``. The module imports torch only to size the budget, so the
``/metrics`` blocks can read :meth:`DeviceArena.stats` without touching a
card.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from learningorchestra_tpu_torch.runtime import locks


def _ledger(op: str, key: Any, nbytes: int = 0,
            tags: Tuple[str, ...] = ()) -> None:
    """Mirror a resident insert or drop into the X-ray ledger (owner
    ``arena``). Advisory: any failure is swallowed, so the arena never
    depends on observability."""
    try:
        from learningorchestra_tpu_torch.observability import xray

        if op == "register":
            xray.register("arena", key, nbytes,
                          name=tags[0] if tags else None)
        else:
            xray.release("arena", key)
    except Exception:  # noqa: BLE001
        pass


def _auto_budget(arrays: Dict[str, Any]) -> int:
    """A quarter of the card's memory when the first staged tensor lies
    on one; 1 GiB otherwise (CPU tensors, host arrays)."""
    try:
        import torch

        first = next(iter(arrays.values()), None)
        if isinstance(first, torch.Tensor) and first.device.type == "cuda":
            return int(torch.cuda.mem_get_info(first.device)[1]) // 4
    except Exception:  # noqa: BLE001 — budget sizing must never raise
        pass
    return 1 << 30


def _nbytes(value: Any) -> int:
    return int(getattr(value, "nbytes", 0))


class ArenaEntry:
    """A pinned handle on one resident dict of tensors. Use as a context
    manager (or call :meth:`release`) so the pin drops on any exit path,
    ``JobCancelled`` included."""

    __slots__ = ("key", "arrays", "nbytes", "tags", "_arena", "_released")

    def __init__(self, key: Any, arrays: Dict[str, Any], nbytes: int,
                 tags: Tuple[str, ...], arena: Optional["DeviceArena"]):
        self.key = key
        self.arrays = arrays
        self.nbytes = nbytes
        self.tags = tags
        self._arena = arena
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._arena is not None:
            self._arena._unpin(self.key)

    def __enter__(self) -> "ArenaEntry":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _Resident:
    __slots__ = ("arrays", "nbytes", "tags", "pins", "group")

    def __init__(self, arrays, nbytes, tags, group=None):
        self.arrays = arrays
        self.nbytes = nbytes
        self.tags = tags
        self.pins = 0
        self.group = group


class DeviceArena:
    """Byte-budgeted LRU of staged tensor dicts with reader pins and
    tag-based invalidation. Thread-safe: builder classifier threads and
    concurrent jobs share one arena."""

    def __init__(self, byte_budget: Optional[int] = None):
        # None = size from the first staged tensors' device; <= 0 = off
        self._budget = byte_budget
        self._entries: "collections.OrderedDict[Any, _Resident]" = \
            collections.OrderedDict()
        self._bytes = 0
        # per-group residency: entries staged under a group are also
        # bounded by budget * group_fraction (one card has one group,
        # the argument is kept for the multi-card port)
        self._group_bytes: Dict[Any, int] = {}
        self._lock = locks.make_lock("arena.entries")
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    # -- core ----------------------------------------------------------
    def get_or_put(self, key: Any, build: Callable[[], Dict[str, Any]],
                   tags: Iterable[str] = (), group: Any = None,
                   group_fraction: float = 1.0) -> ArenaEntry:
        """Pinned entry for ``key``, building (and staging) it on a miss.

        The build runs outside the lock; a concurrent miss on the same
        key may build twice, and then the first insert wins and the
        loser's tensors are freed: staging twice is cheaper than
        serializing every fit behind one copy.

        ``group`` partitions the budget: entries inserted under a group
        are also bounded by ``budget * group_fraction``, with eviction
        scoped to that group. ``group=None`` keeps the one global
        budget."""
        tags = tuple(tags)
        with self._lock:
            res = self._entries.get(key)
            if res is not None:
                self._entries.move_to_end(key)
                res.pins += 1
                self.hits += 1
                return ArenaEntry(key, res.arrays, res.nbytes, res.tags,
                                  self)
            self.misses += 1
        arrays = build()
        nbytes = sum(_nbytes(a) for a in arrays.values())
        with self._lock:
            if self._budget is None:
                self._budget = _auto_budget(arrays)
            if self._budget <= 0 or nbytes > self._budget:
                # uncacheable: an untracked entry whose release() does
                # nothing
                return ArenaEntry(key, arrays, nbytes, tags, None)
            res = self._entries.get(key)
            if res is not None:  # lost the build race: reuse the winner
                self._entries.move_to_end(key)
                res.pins += 1
                return ArenaEntry(key, res.arrays, res.nbytes, res.tags,
                                  self)
            res = _Resident(arrays, nbytes, tags, group)
            res.pins = 1
            self._entries[key] = res
            self._bytes += nbytes
            _ledger("register", key, nbytes, tags)
            if group is not None:
                self._group_bytes[group] = \
                    self._group_bytes.get(group, 0) + nbytes
                limit = int(self._budget * max(0.0, min(1.0,
                                                        group_fraction)))
                self._evict_group_locked(group, limit)
            self._evict_locked()
            return ArenaEntry(key, arrays, nbytes, tags, self)

    def _unpin(self, key: Any) -> None:
        with self._lock:
            res = self._entries.get(key)
            if res is not None and res.pins > 0:
                res.pins -= 1

    def _drop_locked(self, key: Any) -> "_Resident":
        res = self._entries.pop(key)
        self._bytes -= res.nbytes
        _ledger("release", key)
        if res.group is not None:
            remaining = self._group_bytes.get(res.group, 0) - res.nbytes
            if remaining > 0:
                self._group_bytes[res.group] = remaining
            else:
                self._group_bytes.pop(res.group, None)
        return res

    def _evict_locked(self) -> None:
        """LRU-evict unpinned entries until under budget. Pinned entries
        are skipped: an over-budget arena full of in-flight readers
        degrades to no caching rather than freeing their tensors; their
        bytes go when the pins drop and the next insert sweeps again."""
        if self._budget is None or self._budget <= 0:
            return
        while self._bytes > self._budget:
            victim = None
            for key, res in self._entries.items():  # oldest first
                if res.pins == 0:
                    victim = key
                    break
            if victim is None:
                return
            self._drop_locked(victim)
            self.evictions += 1

    def _evict_group_locked(self, group: Any, limit: int) -> None:
        """LRU-evict unpinned entries of ``group`` until its bytes fit
        ``limit``."""
        if limit <= 0:
            return
        while self._group_bytes.get(group, 0) > limit:
            victim = None
            for key, res in self._entries.items():  # oldest first
                if res.group == group and res.pins == 0:
                    victim = key
                    break
            if victim is None:
                return
            self._drop_locked(victim)
            self.evictions += 1

    # -- invalidation --------------------------------------------------
    def invalidate(self, collection: str) -> int:
        """Drop every entry tagged with ``collection`` (catalog change
        feed, version mismatch). Pinned entries leave the table too:
        their tensors survive for the in-flight reader, but no later
        reader can hit the stale version."""
        dropped = 0
        with self._lock:
            for key in [k for k, r in self._entries.items()
                        if collection in r.tags]:
                self._drop_locked(key)
                dropped += 1
            self.invalidations += dropped
        return dropped

    def discard(self, key: Any) -> bool:
        """Unlink one entry whatever its pins (a deleted serving
        session's params, which no later reader can key); its tensors
        live on while a reader holds them."""
        with self._lock:
            if key not in self._entries:
                return False
            self._drop_locked(key)
            return True

    def clear(self) -> None:
        with self._lock:
            for key in self._entries:
                _ledger("release", key)
            self._entries.clear()
            self._bytes = 0
            self._group_bytes.clear()

    # -- observability -------------------------------------------------
    @property
    def bytes_in_use(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytesInUse": self._bytes,
                "byteBudget": self._budget,
                "pins": sum(r.pins for r in self._entries.values()),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "groups": len(self._group_bytes),
            }


# ----------------------------------------------------------------------
# the process-wide default; installing or dropping the process-wide
# config (observability.set_config / reset_config) resets it
# ----------------------------------------------------------------------
_default_arena: Optional[DeviceArena] = None
_default_lock = locks.make_lock("arena.default")


def _configured_budget() -> Optional[int]:
    from learningorchestra_tpu_torch import observability

    raw = int(getattr(observability.get_config(), "arena_bytes", -1))
    return None if raw < 0 else raw  # None = size at the first insert


def get_default_arena() -> DeviceArena:
    global _default_arena
    with _default_lock:
        if _default_arena is None:
            _default_arena = DeviceArena(_configured_budget())
        return _default_arena


def reset_default_arena() -> None:
    """Drop the process arena (a config swap, a test's teardown): its
    entries were staged under the old config. Its residents leave the
    X-ray ledger; readers that hold entries keep their tensors."""
    global _default_arena
    with _default_lock:
        old, _default_arena = _default_arena, None
    if old is not None:
        old.clear()
