"""Feature-plane cache: the host tier every compute service reads
datasets through (the port's copy of the JAX package's
``services/feature_cache.py``).

The builder, the ``$name`` resolution of the execution verbs
(``services/params.py``) and the dataType transform each used to read and
convert every column of a dataset again. This cache keeps the port's own
read forms once per *content version* and hands staging on the card to
the device arena (``runtime/arena.py``):

- :meth:`FeatureCache.table` — the :class:`~..catalog.store.Table` of
  ``catalog.read_table`` (what ``$name`` resolves to);
- :meth:`FeatureCache.columns` — ``catalog.read_columns``' dict of
  ``(kind, data, null mask)`` (the dataType transform's read);
- :meth:`FeatureCache.arrays` — numpy column dicts under one dtype
  policy, staged through the arena when a device is given.

Keying: ``(form, collection, projection, dtype policy)``, each entry
holding the version it was read at: ``(catalog.collection_seq(name),
catalog.dataset_version(name))``. Both parts are needed: a dataset write
swaps its files without a change-feed entry, and a delete removes the
files whose stamp ``dataset_version`` reads.

Invalidation is belt and braces:

- *revalidate on read*: every hit re-checks the version, so a rewritten
  or deleted dataset never serves stale rows to the next job; a stale
  entry also drops the arena's tensors staged from the collection, whose
  token cannot hit again;
- *change-feed sweep*: each access drains ``changes_since(last_seq)`` and
  drops the touched collections from both tiers (the arena's tagged
  tensors too), so a deleted dataset frees its budget at once.

Reads use a bounded stable-version loop (read the version, read the data,
read the version again; retry on a mismatch), so a reader racing a
writer's directory swap caches the old version or the new one whole,
never a mix. Callers get their own ``Table`` and dict objects, so adding
or dropping a column never touches the cached copy; the cached column
arrays are read-only, so an in-place write raises instead of changing
every later read of the same version (in-process user code gets its own
writable copies from ``sandbox.run_user_code``).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from learningorchestra_tpu_torch.catalog.store import (CollectionNotFound,
                                                       Table)
from learningorchestra_tpu_torch.runtime import arena as arena_lib
from learningorchestra_tpu_torch.runtime import locks

# attempts at reading a dataset under one stable version before giving
# up on caching it (the data is still returned)
_STABLE_READ_ATTEMPTS = 3


class FeatureCache:
    """Version-keyed host tier of dataset reads, bounded by a byte budget
    with LRU eviction."""

    def __init__(self, catalog, host_bytes: int = 256 << 20,
                 arena: Optional[arena_lib.DeviceArena] = None):
        self._catalog = catalog
        self._limit = int(host_bytes)
        self._arena = arena
        self._entries: "collections.OrderedDict[Any, tuple]" = \
            collections.OrderedDict()  # key -> (version, value, nbytes)
        self._bytes = 0
        self._lock = locks.make_lock("feature_cache.store")
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self._last_seq = catalog.latest_seq()

    # -- identity ------------------------------------------------------
    @property
    def arena(self) -> arena_lib.DeviceArena:
        return self._arena or arena_lib.get_default_arena()

    def version(self, name: str) -> Tuple[Any, Any]:
        """Content version of a collection: its newest change-feed seq
        and its files' stamp (either alone misses a kind of write)."""
        return (self._catalog.collection_seq(name),
                self._catalog.dataset_version(name))

    def token(self, name: str, *extra: Any) -> Tuple[Any, ...]:
        """Hashable identity of this collection's current content (and
        the caller's qualifiers): the arena key part that makes device
        entries miss once the version changes."""
        return ("ds", name, self.version(name)) + extra

    # -- host tier -----------------------------------------------------
    def table(self, name: str) -> Table:
        """The whole dataset as a :class:`Table`, from the host tier. The
        caller gets its own ``Table`` over the cached column arrays."""
        cached = self._get(("table", name), name,
                           lambda: self._catalog.read_table(name))
        return Table({c: cached[c] for c in cached.columns}, len(cached))

    def columns(self, name: str, fields: Optional[Sequence[str]] = None,
                ) -> Dict[str, Tuple[str, np.ndarray,
                                     Optional[np.ndarray]]]:
        """``catalog.read_columns(name, fields)`` from the host tier, in a
        dict of the caller's own."""
        proj = tuple(fields) if fields else None
        return dict(self._get(
            ("columns", name, proj), name,
            lambda: self._catalog.read_columns(
                name, list(proj) if proj else None)))

    def arrays(self, name: str, columns: Sequence[str], dtype=np.float32,
               device=None):
        """``{column: numpy array}`` of ``columns`` under one dtype policy.
        With a ``device``, a pinned :class:`~..runtime.arena.ArenaEntry`
        of those arrays staged there instead (``entry.arrays``; release it,
        or use it as a context manager)."""
        cols = tuple(columns)
        dt = np.dtype(dtype)

        def build() -> Dict[str, np.ndarray]:
            t = self._catalog.read_table(name)
            return {c: np.asarray(t[c]).astype(dt) for c in cols}

        host = dict(self._get(("np", name, cols, dt.str), name, build))
        if device is None:
            return host
        import torch

        return self.arena.get_or_put(
            self.token(name, "arrays", cols, dt.str, str(device)),
            # copies: the cached arrays are read-only
            lambda: {c: torch.tensor(v, device=device)
                     for c, v in host.items()},
            tags=(name,))

    def _get(self, key: Any, name: str, build) -> Any:
        self._sweep()
        version = self.version(name)
        stale = False
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                if hit[0] == version:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return hit[1]
                # stale: the files changed without a change-feed entry
                self._drop_locked(key)
                self.invalidations += 1
                stale = True
            self.misses += 1
        if stale:
            # and so did the arena's tensors staged from the old version:
            # their token never hits again, so free their bytes now
            # (outside this lock: the arena's ranks below it)
            self.arena.invalidate(name)
        value, version = self._stable_read(name, version, build)
        if version is not None:
            self._insert(key, version, value)
        return value

    def _stable_read(self, name: str, version, build):
        """``(value, version or None)``: reads again until the version is
        the same before and after the read, so a read racing a writer
        returns one coherent snapshot. A read that fails inside a
        writer's swap (its files moved away) is retried too. None: the
        version never held still; the last read is returned uncached."""
        for attempt in range(_STABLE_READ_ATTEMPTS):
            try:
                value = build()
            except (OSError, CollectionNotFound):
                if attempt + 1 == _STABLE_READ_ATTEMPTS:
                    raise
                version = self.version(name)
                continue
            after = self.version(name)
            if after == version:
                return value, version
            version = after
        return value, None

    def _insert(self, key: Any, version, value) -> None:
        nbytes = _sizeof(value)
        if nbytes is None or nbytes <= 0 or nbytes > self._limit:
            return
        _freeze(value)
        with self._lock:
            self._drop_locked(key)
            while self._entries and self._bytes + nbytes > self._limit:
                _, (_, _, evicted) = self._entries.popitem(last=False)
                self._bytes -= evicted
            self._entries[key] = (version, value, nbytes)
            self._bytes += nbytes

    def _drop_locked(self, key: Any) -> None:
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= old[2]

    # -- invalidation --------------------------------------------------
    def _sweep(self) -> None:
        """Drain the catalog change feed and drop the touched collections
        from both tiers (one indexed sqlite query when idle)."""
        seq = self._catalog.latest_seq()
        if seq == self._last_seq:
            return
        with self._lock:
            if seq == self._last_seq:
                return
            last, self._last_seq = self._last_seq, seq
        touched = {c["collection"]
                   for c in self._catalog.changes_since(last)}
        for name in touched:
            self.invalidate(name)

    def invalidate(self, name: str) -> int:
        """Drop every host-tier entry of ``name`` and the arena's tensors
        staged from it."""
        dropped = 0
        with self._lock:
            for key in [k for k in self._entries if k[1] == name]:
                self._drop_locked(key)
                dropped += 1
            self.invalidations += dropped
        dropped += self.arena.invalidate(name)
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    # -- observability -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytesInUse": self._bytes,
                "byteBudget": self._limit,
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
            }


def _arrays_of(value: Any):
    """The numpy arrays a cached value holds."""
    if isinstance(value, Table):
        return [value[c] for c in value.columns]
    out = []
    for v in value.values():
        out.extend(a for a in (v[1:] if isinstance(v, tuple) else (v,))
                   if a is not None)
    return out


def _freeze(value: Any) -> None:
    """Marks a cached value's arrays read-only: every later reader of
    this version shares them."""
    for a in _arrays_of(value):
        if isinstance(a, np.ndarray):
            a.setflags(write=False)


def _sizeof(value: Any) -> Optional[int]:
    """Approximate host bytes of a cached value; None = unsizable (the
    value is not cached)."""
    try:
        return sum(int(np.asarray(a).nbytes) for a in _arrays_of(value))
    except Exception:  # noqa: BLE001
        return None
