"""Version-keyed response cache for the universal GET path (the port's
copy of the JAX package's ``services/cache.py``).

The reference's gateway fronts every backend with a 300 s response
cache and a proxy timeout (``"cache_ttl": "300s", "timeout": "10s"`` on
each endpoint). A blind TTL cache would serve stale ``finished`` flags
to pollers, so entries here are keyed by the collection's content
version (its newest change-feed seq and the stored rows' file stamp)
and revalidated on every hit — the TTL is only an upper bound on an
entry's lifetime, never a staleness window. Clients polling a finished
artifact's GET URI hit the cache; the first mutation (new document, new
rows, metadata update) misses it.

Values are stored JSON-encoded: a hit re-parses rather than aliasing
a live dict into handlers, so no caller can corrupt a cached body.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import Any, Optional, Tuple
from learningorchestra_tpu_torch.runtime import locks


class ReadCache:
    """LRU + TTL + version-revalidated cache of (status, payload)."""

    def __init__(self, ttl_seconds: float = 300.0,
                 max_entries: int = 256):
        self._ttl = float(ttl_seconds)
        self._max = int(max_entries)
        self._lock = locks.make_lock("cache.lru")
        self._entries: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @property
    def enabled(self) -> bool:
        return self._ttl > 0

    def get(self, key: Tuple, version: Any, now: float
            ) -> Optional[Tuple[int, Any]]:
        if not self.enabled:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            exp, ver, status, body_json = entry
            if now >= exp or ver != version:
                del self._entries[key]
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
        return status, json.loads(body_json)

    def put(self, key: Tuple, version: Any, now: float,
            status: int, payload: Any) -> None:
        if not self.enabled or status != 200:
            return
        try:
            body_json = json.dumps(payload)
        except (TypeError, ValueError):
            return  # non-JSON payloads (images) are never cached
        with self._lock:
            self._entries[key] = (now + self._ttl, version, status,
                                  body_json)
            self._entries.move_to_end(key)
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses}
