"""Resident LM serving with continuous batching (the slot and paged
sessions of the JAX package's ``services/serving.py``).

:class:`LMServingSession` keeps a fitted language model and a fixed slot
KV cache on the card. Every worker iteration admits queued requests into
free slots (a batch-1 prefill at the exact prompt length, copied into
the slot), runs ONE step that advances every active slot a token, and
retires finished requests. Per-slot position and sampling-stream
bookkeeping replays the schedule ``LanguageModel.generate`` uses, so a
slot's greedy tokens equal a solo decode of the same request.

:class:`PagedLMServingSession` (``kv: "paged"``) runs the same loop over
one shared pool of KV pages: :class:`PagedKVPool` (refcounted pages,
page 0 the trash page, per-tenant charges), :class:`PrefixCache` (prompt
pages shared between requests, a full hit skips the prefill), weighted-
fair tenant quotas, int8 KV pages (``kvDtype``), int8 or fp8 serving
weights (``weights``) under a drift gate, and the degrade ladder
(quantized -> exact -> slot). ``"bf16"`` in ``kvDtype`` and ``weights``
means exact: the model's own dtype.

Speculative decoding (``draft``, ``specK``): a small draft model
proposes ``specK`` greedy tokens a round over its own slot cache and the
target verifies them in one paged step with exact acceptance, so a
greedy stream still equals solo decode. :class:`DisaggLMServingSession`
(``disagg: true``) splits admission off to a prefill worker thread that
funds the pages, runs the prefill and publishes a handoff record; the
decode worker adopts it into a free slot by reference count. On one card
both workers share it (``mode: "colocated"``). :class:`BucketServingSession`
(``type: "predict"``) micro-batches the rows of concurrent requests
into the smallest bucket that holds them and serves each burst with one
``predict`` call.

Admission control: a full queue or an unfunded request rejects with
429, a closed session with 503. Not ported yet: the serving lease and
``sliceDevices`` (one card has no slice of a mesh to share, so the split
disaggregated mode is not either), and the observability hooks (X-ray
claims, histograms, per-tenant objectives, incident bundles).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from learningorchestra_tpu_torch.ops import attention as attn_ops
from learningorchestra_tpu_torch.runtime import locks
from learningorchestra_tpu_torch.services import faults
from learningorchestra_tpu_torch.services import validators as V

_IDLE_TICK_SECONDS = 0.05


class LatencyTracker:
    """Ring buffer of request latencies -> p50/p99 snapshot (the last
    2048 requests)."""

    def __init__(self, maxlen: int = 2048):
        self._lat: Deque[float] = collections.deque(maxlen=maxlen)
        self._lock = locks.make_lock("serving.latency")
        self.count = 0

    def record(self, seconds: float) -> None:
        with self._lock:
            self._lat.append(seconds)
            self.count += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._lat)
            count = self.count
        if not lat:
            return {"count": 0, "p50Ms": 0.0, "p99Ms": 0.0}
        p50 = lat[int(0.50 * (len(lat) - 1))]
        p99 = lat[int(0.99 * (len(lat) - 1))]
        return {"count": count, "p50Ms": round(p50 * 1e3, 3),
                "p99Ms": round(p99 * 1e3, 3)}


class _Request:
    __slots__ = ("payload", "event", "result", "error", "queued_at")

    def __init__(self, payload: Dict[str, Any]):
        self.payload = payload
        self.event = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[V.HttpError] = None
        self.queued_at = time.monotonic()

    def finish(self, result: Dict[str, Any]) -> None:
        self.result = result
        self.event.set()

    def fail(self, error: V.HttpError) -> None:
        self.error = error
        self.event.set()


class _SessionBase:
    """Bounded queue + worker thread. Subclasses implement
    :meth:`_serve_once` (drain some queued work)."""

    kind = "base"

    def __init__(self, name: str, ctx):
        self.name = name
        self._ctx = ctx
        self._queue: Deque[_Request] = collections.deque()
        self._depth = int(ctx.config.serve_queue_depth)
        self._cv = locks.make_condition("serving.session")
        self._closed = False
        self.latency = LatencyTracker()
        self.requests_total = 0
        self.rejected_total = 0
        self.created_at = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name=f"serving-{name}", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def submit(self, payload: Dict[str, Any],
               timeout: Optional[float] = None) -> Dict[str, Any]:
        req = _Request(payload)
        with self._cv:
            if self._closed:
                raise V.HttpError(V.HTTP_UNAVAILABLE,
                                  f"serving session {self.name} is "
                                  f"shutting down")
            if len(self._queue) >= self._depth:
                self.rejected_total += 1
                raise V.HttpError(
                    V.HTTP_TOO_MANY_REQUESTS,
                    f"serving queue full ({self._depth} requests "
                    f"queued) — retry with backoff")
            self.requests_total += 1
            self._queue.append(req)
            self._cv.notify_all()
        if timeout is None:
            # 0 = no deadline configured -> wait indefinitely
            timeout = self._ctx.config.request_timeout_seconds or None
        if not req.event.wait(timeout):
            raise V.HttpError(V.HTTP_UNAVAILABLE,
                              f"request timed out after {timeout}s "
                              f"(session overloaded or preempted)")
        if req.error is not None:
            raise req.error
        self.latency.record(time.monotonic() - req.queued_at)
        return req.result

    def _run(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    break
                if not self._have_work():
                    self._cv.wait(timeout=_IDLE_TICK_SECONDS)
                    if self._closed:
                        break
            try:
                self._serve_once()
            except Exception as exc:  # noqa: BLE001 — fail requests, not the thread
                self._fail_all(V.HttpError(
                    V.HTTP_UNAVAILABLE, f"serving step failed: {exc}"))

    def _have_work(self) -> bool:
        return bool(self._queue)

    def _serve_once(self) -> bool:
        raise NotImplementedError

    def _fail_all(self, error: V.HttpError) -> None:
        with self._cv:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            req.fail(error)

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=30.0)
        self._fail_all(V.HttpError(
            V.HTTP_UNAVAILABLE,
            f"serving session {self.name} was deleted"))

    def _batch_fill(self) -> Optional[float]:
        return None

    def perf_stats(self) -> Dict[str, Any]:
        return {}

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            depth = len(self._queue)
        return {
            "model": self.name,
            "kind": self.kind,
            "queueDepth": depth,
            "queueBound": self._depth,
            "batchFill": self._batch_fill(),
            "requestsTotal": self.requests_total,
            "rejectedTotal": self.rejected_total,
            "uptimeSeconds": round(time.monotonic() - self.created_at, 3),
            "latency": self.latency.snapshot(),
            "perf": self.perf_stats(),
        }


class LMServingSession(_SessionBase):
    """Iteration-level continuous batcher over a fixed slot cache."""

    kind = "lm"

    def __init__(self, name: str, ctx, model, slots: int, cache_len: int,
                 temperature: float, top_k: Optional[int],
                 top_p: Optional[float], weights_dtype: str = "bf16"):
        super().__init__(name, ctx)
        self._model = model
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        # the module the session runs: the model's own for "bf16" (its
        # exact dtype), else a copy with quantized matmul weights that
        # each layer dequantizes in its forward; the master params stay
        # untouched
        self.weights_dtype = str(weights_dtype or "bf16")
        self._serve_module = model.serving_module(self.weights_dtype)
        self._param_bytes = _weight_bytes(self._serve_module)
        self._init_decode_path()
        self.tokens_total = 0
        # decode goodput: every step advances ALL slots, only active
        # ones emit a useful token
        self.decode_steps = 0
        self.decode_tokens_total = 0
        self._decode_seconds = 0.0
        # the most streams one decode step has advanced
        self.peak_active = 0
        self._role_latency: Dict[str, LatencyTracker] = {}
        self._ttft = LatencyTracker()
        # host-side slot state (the device state is the KV cache)
        self._tok = np.zeros((self.slots, 1), np.int64)
        self._col = np.zeros((self.slots,), np.int64)
        self._seeds = np.zeros((self.slots,), np.int64)
        self._slot_req: List[Optional[_Request]] = [None] * self.slots
        self._slot_out: List[List[int]] = [[] for _ in range(self.slots)]
        self._slot_left = np.zeros((self.slots,), np.int64)
        self._slot_t0 = [0.0] * self.slots

    def _init_decode_path(self) -> None:
        """The slot cache and the functions over it (the paged session
        puts its page pool here instead)."""
        self._step, self._prefill_for, self._join = \
            self._model.serve_fns(self.slots, self.cache_len,
                                  self.temperature, self.top_k, self.top_p,
                                  module=self._serve_module)
        self._cache = self._model.serve_cache(self.slots, self.cache_len)
        self._cache_bytes = _tensor_bytes(self._cache)

    def _have_work(self) -> bool:
        return bool(self._queue) or any(
            r is not None for r in self._slot_req)

    def validate_request(self, payload: Dict[str, Any]) -> None:
        prompt = payload.get("prompt")
        if not isinstance(prompt, (list, tuple)) or not prompt or \
                not all(isinstance(t, int) and not isinstance(t, bool)
                        for t in prompt):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: prompt must be a non-empty "
                f"list of token ids")
        if not all(0 <= t < self._model.vocab_size for t in prompt):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: prompt token ids must be in "
                f"[0, {self._model.vocab_size})")
        new = V.valid_positive_int(payload.get("maxNewTokens"),
                                   "maxNewTokens", default=32)
        if new >= self.cache_len:
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: maxNewTokens={new} leaves "
                f"no prompt room in cacheLen={self.cache_len}")
        seed = payload.get("seed", 0)
        if isinstance(seed, bool) or not isinstance(seed, int):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: seed must be an integer, "
                f"got {seed!r}")

    def _admit(self, slot: int, req: _Request) -> None:
        admit_t0 = time.monotonic()
        payload = req.payload
        prompt = list(payload["prompt"])
        new = int(payload.get("maxNewTokens") or 32)
        seed = int(payload.get("seed", 0))
        # the sliding-window truncation generate() applies, bounded by
        # the session cache instead of max_len
        keep = self.cache_len - new
        if len(prompt) > keep:
            prompt = prompt[-keep:]
        s = len(prompt)
        tokens = torch.tensor([prompt], dtype=torch.long,
                              device=self._model.device)
        nxt, pcache = self._prefill_for(s)(tokens, seed)
        self._cache = self._join(self._cache, pcache, slot)
        first = int(nxt[0])  # device sync: the first token is ready
        now = time.monotonic()
        self._record_role("prefill", now - admit_t0)
        self._ttft.record(now - req.queued_at)
        self._slot_req[slot] = req
        self._slot_out[slot] = [first]
        self._slot_left[slot] = new - 1
        self._slot_t0[slot] = now
        self._tok[slot, 0] = first
        self._col[slot] = s  # the next step attends positions <= s
        self._seeds[slot] = seed
        self.tokens_total += 1
        if self._slot_left[slot] <= 0:
            self._retire(slot)

    def _record_role(self, role: str, seconds: float) -> None:
        tracker = self._role_latency.get(role)
        if tracker is None:
            tracker = self._role_latency.setdefault(role, LatencyTracker())
        tracker.record(seconds)

    def _retire(self, slot: int) -> None:
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        if req is None:
            return
        elapsed = time.monotonic() - self._slot_t0[slot]
        self._record_role("decode", elapsed)
        req.finish({
            "tokens": [int(t) for t in self._slot_out[slot]],
            "decodeSeconds": round(elapsed, 6),
        })
        self._slot_out[slot] = []

    def _pop_next(self) -> _Request:
        """The next queued request (the caller holds ``self._cv``): FIFO
        here; the paged session picks weighted-fair by tenant."""
        return self._queue.popleft()

    def _run_step(self) -> torch.Tensor:
        """One continuous-batch step: every slot's next token, on the
        device."""
        return self._step(self._cache, self._tok, self._col, self._seeds)

    def _admit_loop(self) -> bool:
        admitted = False
        while True:
            with self._cv:
                free = [i for i, r in enumerate(self._slot_req)
                        if r is None]
                if not free or not self._queue:
                    break
                req = self._pop_next()
            try:
                self._admit(free[0], req)
                admitted = True
            except V.HttpError as exc:
                req.fail(exc)
            except Exception as exc:  # noqa: BLE001
                req.fail(V.HttpError(V.HTTP_UNAVAILABLE,
                                     f"prefill failed: {exc}"))
        return admitted

    def _active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is not None]

    def _decode_round(self, active: List[int]) -> None:
        step_t0 = time.monotonic()
        nxt = self._run_step().cpu().numpy()  # device sync
        self._decode_seconds += time.monotonic() - step_t0
        self.decode_steps += 1
        self.decode_tokens_total += len(active)
        self.peak_active = max(self.peak_active, len(active))
        for slot in active:
            tok = int(nxt[slot])
            self._slot_out[slot].append(tok)
            self._slot_left[slot] -= 1
            self.tokens_total += 1
            self._tok[slot, 0] = tok
            self._col[slot] += 1
            if self._slot_left[slot] <= 0 or \
                    self._col[slot] >= self.cache_len - 1:
                self._retire(slot)

    def _serve_once(self) -> bool:
        admitted = self._admit_loop()
        active = self._active_slots()
        if not active:
            return admitted
        self._decode_round(active)
        return True

    def _batch_fill(self) -> Optional[float]:
        active = len(self._active_slots())
        if not active and not self.tokens_total:
            return None
        return round(active / self.slots, 4)

    def perf_stats(self) -> Dict[str, Any]:
        if not self.decode_steps or self._decode_seconds <= 0:
            return {}
        return {
            "decodeSteps": self.decode_steps,
            "decodeTokensPerSec": round(
                self.decode_tokens_total / self._decode_seconds, 2),
            "goodputFrac": round(
                self.decode_tokens_total /
                (self.decode_steps * self.slots), 4),
        }

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out.update({
            "slots": self.slots,
            "activeSlots": len(self._active_slots()),
            "peakActiveSlots": self.peak_active,
            "cacheLen": self.cache_len,
            "tokensTotal": self.tokens_total,
            "temperature": self.temperature,
            "weights": {"dtype": self.weights_dtype,
                        "bytes": self._param_bytes},
            "ttft": self._ttft.snapshot(),
            "roles": {r: t.snapshot() for r, t in
                      sorted(self._role_latency.items())},
        })
        return out


def _tensor_bytes(cache) -> int:
    """Bytes of a KV cache or page pool (a list of per-layer tuples)."""
    return int(sum(t.numel() * t.element_size()
                   for layer in cache for t in layer))


def _weight_bytes(module) -> int:
    """Bytes of the weights a serving module keeps: its parameters, and
    the values and scales of its quantized leaves."""
    total = 0
    for mod in module.modules():
        leaf = getattr(mod, "leaf", None)
        if isinstance(leaf, dict):
            total += sum(leaf[k].numel() * leaf[k].element_size()
                         for k in ("qvalue", "qscale"))
        total += sum(p.numel() * p.element_size()
                     for p in mod.parameters(recurse=False))
    return int(total)


class PoolExhausted(Exception):
    """Not enough free KV pages for an allocation (the session turns
    this into a 429 after trying prefix-cache eviction)."""


def parse_tenant_weights(spec: str) -> Dict[str, float]:
    """``LO_SERVE_TENANT_WEIGHTS="gold:3,free:1"`` -> weight map.
    Unlisted tenants weigh 1; malformed entries are skipped."""
    out: Dict[str, float] = {}
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        try:
            out[name.strip()] = max(float(w), 0.0) if w else 1.0
        except ValueError:
            continue
    return out


class PagedKVPool:
    """Host-side allocator over the shared device KV page pool.

    Page 0 is the trash page: the paged decode appends every lane's
    token KV unconditionally, so idle and retired lanes' block tables
    point at page 0, which is never handed out (what lands there is
    masked to an exact zero by the attention). Pages are refcounted:
    prefix-cache hits share prompt pages across streams and a page
    returns to the free list when its last reference drops. Every
    reference a tenant's stream holds counts against that tenant, so
    sharing cannot game the weighted-fair quota. The ``kv_page_alloc``
    fault site fires in :meth:`alloc`.

    Allocation is the worker thread's alone; ``stats`` may be read from
    REST threads, hence the lock.
    """

    def __init__(self, n_pages: int, page_len: int, dtype: str = "bf16",
                 config=None):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2, got {n_pages}")
        self.n_pages = int(n_pages)
        self.page_len = int(page_len)
        # value dtype of the device pool ("bf16" = the model's own, or
        # "int8" with a parallel scale pool)
        self.dtype = str(dtype or "bf16")
        self._config = config
        self._lock = locks.make_lock("serving.kvpool")
        self._free: Deque[int] = collections.deque(range(1, self.n_pages))
        self._refs: Dict[int, int] = {}
        self._tenant_pages: Dict[str, int] = {}
        self.alloc_total = 0
        self.alloc_failures = 0
        self.freed_total = 0

    @property
    def usable(self) -> int:
        return self.n_pages - 1  # page 0 is the trash page

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def alloc(self, n: int, tenant: Optional[str] = None) -> List[int]:
        """Take ``n`` pages off the free list (refcount 1 each). Raises
        :class:`PoolExhausted` (the pool never over-commits) or
        :class:`faults.InjectedFault` (site ``kv_page_alloc``)."""
        faults.maybe_inject("kv_page_alloc", self._config)
        with self._lock:
            if n > len(self._free):
                self.alloc_failures += 1
                raise PoolExhausted(
                    f"need {n} KV pages, {len(self._free)} free "
                    f"of {self.usable}")
            pages = [self._free.popleft() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
            self.alloc_total += n
            if tenant is not None:
                self._charge(tenant, n)
        return pages

    def incref(self, pages: List[int],
               tenant: Optional[str] = None) -> None:
        with self._lock:
            for p in pages:
                self._refs[p] += 1
            if tenant is not None:
                self._charge(tenant, len(pages))

    def decref(self, pages: List[int],
               tenant: Optional[str] = None) -> None:
        with self._lock:
            for p in pages:
                c = self._refs.get(p, 0) - 1
                if c <= 0:
                    self._refs.pop(p, None)
                    self._free.append(p)
                    self.freed_total += 1
                else:
                    self._refs[p] = c
            if tenant is not None:
                self._charge(tenant, -len(pages))

    def _charge(self, tenant: str, n: int) -> None:
        cur = self._tenant_pages.get(tenant, 0) + n
        if cur <= 0:
            self._tenant_pages.pop(tenant, None)
        else:
            self._tenant_pages[tenant] = cur

    def tenant_pages(self, tenant: str) -> int:
        with self._lock:
            return self._tenant_pages.get(tenant, 0)

    def tenants(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._tenant_pages)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "dtype": self.dtype,
                "pageLen": self.page_len,
                "pagesTotal": self.usable,
                "pagesFree": len(self._free),
                "pagesShared": sum(
                    1 for c in self._refs.values() if c > 1),
                "allocTotal": self.alloc_total,
                "allocFailures": self.alloc_failures,
                "freedTotal": self.freed_total,
            }


class PrefixCache:
    """Page-granular prompt-prefix cache over the refcounted pool.

    - A full hit (the exact prompt seen before) skips the prefill: the
      entry holds the prompt's full pages (shared read-only: a full
      page's positions are never written after the prefill), its
      partially filled tail page and the prefill's final logit row. The
      new stream increfs the full pages, copies the tail page (its
      donor's decode rows past the prompt are position-masked until
      overwritten) and samples its first token from the cached logits
      under its own stream, the draw the prefill would have made.
    - A partial hit (the longest cached run of full pages that prefixes
      the prompt) still runs the prefill, but the shared pages are
      increfed and the page write starts after them. Prefill KV at a
      position depends only on the tokens at or before it.

    Entries hold their own page references, so a donor's retirement
    never invalidates one; LRU entries are evicted under pool pressure
    before the session answers 429. Every mutation runs under the
    ``serving.prefix`` lock, below the pool's.
    """

    def __init__(self, pool: PagedKVPool, page_len: int,
                 max_entries: int = 64):
        self._pool = pool
        self._page_len = int(page_len)
        self._max = int(max_entries)
        self._lock = locks.make_lock("serving.prefix")
        # prompt tuple -> {fullPages, tailPage, logits, held}
        self._entries: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._chains: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
        self.hits_full = 0
        self.hits_partial = 0
        self.pages_reused = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup_full(self, prompt: List[int]) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._entries.get(tuple(prompt))
            if entry is not None:
                self._entries.move_to_end(tuple(prompt))
                self.hits_full += 1
                self.pages_reused += len(entry["fullPages"])
            return entry

    def lookup_partial(
            self, prompt: List[int]) -> Tuple[Optional[List[int]], int]:
        """Longest cached chain of full pages prefixing ``prompt`` ->
        (pages, n_pages); (None, 0) on a miss. No references are taken
        here: the caller increfs once it commits to the admission."""
        pl = self._page_len
        with self._lock:
            for k in range(len(prompt) // pl, 0, -1):
                key = self._chains.get(tuple(prompt[:k * pl]))
                if key is None:
                    continue
                entry = self._entries.get(key)
                if entry is None or len(entry["fullPages"]) < k:
                    continue
                self._entries.move_to_end(key)
                self.hits_partial += 1
                self.pages_reused += k
                return list(entry["fullPages"][:k]), k
            return None, 0

    def insert(self, prompt: List[int], full_pages: List[int],
               tail_page: Optional[int], logits: torch.Tensor) -> None:
        key = tuple(prompt)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return
            held = list(full_pages)
            if tail_page is not None:
                held.append(tail_page)
            self._pool.incref(held)  # the cache's own hold, no tenant
            self._entries[key] = {
                "fullPages": list(full_pages), "tailPage": tail_page,
                "logits": logits, "held": held}
            pl = self._page_len
            for k in range(1, len(full_pages) + 1):
                self._chains[key[:k * pl]] = key
            while len(self._entries) > self._max:
                self._evict_one_locked()

    def _evict_one_locked(self) -> bool:
        if not self._entries:
            return False
        key, entry = self._entries.popitem(last=False)
        pl = self._page_len
        for k in range(1, len(entry["fullPages"]) + 1):
            if self._chains.get(key[:k * pl]) == key:
                del self._chains[key[:k * pl]]
        self._pool.decref(entry["held"])
        return True

    def evict_one(self) -> bool:
        """Drop the LRU entry and release its page references. False
        when the cache is already empty."""
        with self._lock:
            return self._evict_one_locked()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"entries": len(self._entries),
                    "hitsFull": self.hits_full,
                    "hitsPartial": self.hits_partial,
                    "pagesReused": self.pages_reused}


class PagedLMServingSession(LMServingSession):
    """Paged-KV continuous batcher (``kv: "paged"``).

    The same iteration loop and token streams as the slot session, but
    the per-layer KV cache is one shared ``(pages, page_len, kv, d)``
    pool and each stream owns exactly ``ceil((prompt + maxNew) /
    page_len)`` pages through its block-table row, so concurrency is
    bounded by actual token demand, not ``slots x cacheLen``. The block
    tables live on the card and change only at admission and
    retirement. On top of the pool: prompt prefix caching
    (:class:`PrefixCache`) and weighted-fair per-tenant quotas over the
    page budget, with per-tenant latency trackers.

    Quantized sessions (``kvDtype: "int8"``, ``weights: "int8"|"fp8"``)
    measure their drift against the exact path at create and every
    ``serve_drift_every`` steps. The degrade ladder: a latched
    ``kv_quant`` fault or a drift breach rebuilds the session over exact
    pages and weights; a latched ``kv_page_alloc`` fault rebuilds it over
    the slot cache, and speculation ends there (the slot cache has no
    verify step). In-flight streams fail with 503 either way.

    With a draft model every decode round is speculative
    (:meth:`_spec_round`): the draft proposes ``spec_k`` greedy tokens a
    stream over its own slot cache, in its own dtype, and the target
    scores them in one verify step with exact acceptance, landing 1 to
    ``spec_k + 1`` tokens a stream.
    """

    _DEGRADE_AFTER = 3
    _MAX_TENANT_SERIES = 32

    def __init__(self, name: str, ctx, model, slots: int, cache_len: int,
                 temperature: float, top_k: Optional[int],
                 top_p: Optional[float], page_len: int, n_pages: int,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 kv_dtype: str = "bf16", weights_dtype: str = "bf16",
                 draft_model=None, draft_name: str = "", spec_k: int = 4):
        # read by _init_decode_path, which the base __init__ calls
        self._draft = draft_model
        self._draft_name = str(draft_name or "")
        self._spec_k = max(1, int(spec_k or 4))
        self.spec_steps = 0
        self.spec_slot_steps = 0
        self.spec_accepted_total = 0
        self.page_len = int(page_len)
        self.n_pages = int(n_pages)
        self.kv_dtype = str(kv_dtype or "bf16")
        self._tenant_weights = dict(tenant_weights or {})
        self._tenant_latency: Dict[str, LatencyTracker] = {}
        self._tenant_requests: Dict[str, int] = {}
        self._adhoc_tenants: set = set()
        # drift gate state (quantized sessions): the last measured
        # quantized-vs-exact drift, its parts, and the probe countdown
        self._last_drift: Optional[float] = None
        self._drift_parts: Dict[str, float] = {}
        self._drift_probes = 0
        self.quant_degrades = 0
        super().__init__(name, ctx, model, slots, cache_len, temperature,
                         top_k, top_p, weights_dtype=weights_dtype)
        if self._draft is not None:
            self._init_spec_state()
        # a quantized session measures its drift before it serves: a bad
        # quantization degrades at create, not in a user's stream
        self._maybe_probe_drift()

    def _init_decode_path(self) -> None:
        if self.cache_len % self.page_len:
            raise ValueError(
                f"cacheLen={self.cache_len} must be a multiple of "
                f"pageLen={self.page_len}")
        model = self._model
        (self._pstep, self._pprefill_for, self._pjoin, self._copy_page,
         self._sample_first) = model.serve_fns_paged(
            self.slots, self.cache_len, self.page_len, self.n_pages,
            self.temperature, self.top_k, self.top_p,
            kv_dtype=self.kv_dtype, module=self._serve_module)
        self._pool = model.serve_cache_paged(self.n_pages, self.page_len,
                                             kv_dtype=self.kv_dtype)
        # the verify step over this pool (rebuilt with it on a degrade to
        # exact pages)
        self._verify = None
        if self._draft is not None:
            self._verify = model.serve_fns_spec(
                self.slots, self.cache_len, self.page_len, self.n_pages,
                self._spec_k, self.temperature, self.top_k, self.top_p,
                kv_dtype=self.kv_dtype, module=self._serve_module)
        self._cache_bytes = _tensor_bytes(self._pool)
        self.pool = PagedKVPool(self.n_pages, self.page_len,
                                dtype=self.kv_dtype,
                                config=self._ctx.config)
        self.prefix = PrefixCache(self.pool, self.page_len)
        self._pages_per_slot = self.cache_len // self.page_len
        # block tables: the host copy, and the device copy the step reads
        # (written at admission and retirement only)
        self._bt = np.zeros((self.slots, self._pages_per_slot), np.int64)
        self._bt_dev = torch.zeros((self.slots, self._pages_per_slot),
                                   dtype=torch.long,
                                   device=self._model.device)
        self._slot_pages: List[List[int]] = [[] for _ in range(self.slots)]
        self._slot_tenant: List[Optional[str]] = [None] * self.slots
        self._alloc_fault_streak = 0
        self._quant_fault_streak = 0
        self._degraded = False
        self.prefills_skipped = 0
        self._steps_since_probe = 0

    # -- speculative decoding ------------------------------------------
    def _spec_on(self) -> bool:
        return self._draft is not None and not self._degraded

    def _init_spec_state(self) -> None:
        """The draft's side: its prefill and join (the draft shares the
        target's admission), its propose step and its slot cache. The
        draft serves exact, in its own dtype, over a slot cache: it is
        small, and a one-hot proposal keeps acceptance exact."""
        draft = self._draft
        _, self._draft_prefill_for, self._draft_join = draft.serve_fns(
            self.slots, self.cache_len, 0.0, None, None)
        self._draft_propose = draft.serve_fns_draft(
            self.slots, self.cache_len, self._spec_k)
        self._draft_cache = draft.serve_cache(self.slots, self.cache_len)

    def _release_spec_state(self) -> None:
        """Drop the draft and its cache (a degrade to slot, or close)."""
        self._draft = None
        self._draft_cache = None
        self._verify = None

    def close(self) -> None:
        super().close()
        self._release_spec_state()

    # -- disaggregation hooks (the disaggregated session overrides) -----
    def _publishes(self) -> bool:
        """Whether :meth:`_prepare` publishes a handoff record (the
        ``kv_page_handoff`` fault site and the publish hold). A fused
        session installs on the same thread: nothing to publish."""
        return False

    def _note_handoff_fault(self) -> None:
        """An injected ``kv_page_handoff`` fault was seen."""

    def _note_handoff_ok(self) -> None:
        """A publish passed the fault site."""

    def _set_table(self, slot: int, row: List[int]) -> None:
        self._bt[slot, :] = 0
        self._bt[slot, :len(row)] = row
        self._bt_dev[slot] = torch.from_numpy(self._bt[slot]).to(
            self._bt_dev.device)

    # -- tenants -------------------------------------------------------
    @staticmethod
    def _tenant_of(payload: Dict[str, Any]) -> str:
        return str(payload.get("tenant") or "default")

    def _weight(self, tenant: str) -> float:
        return max(1e-6, float(self._tenant_weights.get(tenant, 1.0)))

    def _tenant_series(self, tenant: str) -> str:
        """Bounded cardinality for a client-controlled field: tenants
        named in ``LO_SERVE_TENANT_WEIGHTS`` and the first
        ``_MAX_TENANT_SERIES`` other names get their own latency series;
        the rest share ``other``. Quotas keep the raw tenant."""
        if tenant in self._tenant_weights or \
                tenant in self._adhoc_tenants:
            return tenant
        if len(self._adhoc_tenants) < self._MAX_TENANT_SERIES:
            self._adhoc_tenants.add(tenant)
            return tenant
        return "other"

    def validate_request(self, payload: Dict[str, Any]) -> None:
        super().validate_request(payload)
        tenant = payload.get("tenant")
        if tenant is not None and (
                not isinstance(tenant, str) or not tenant
                or len(tenant) > 64):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: tenant must be a "
                f"non-empty string of <= 64 chars")

    def submit(self, payload: Dict[str, Any],
               timeout: Optional[float] = None) -> Dict[str, Any]:
        tenant = self._tenant_of(payload)
        t0 = time.monotonic()
        result = super().submit(payload, timeout=timeout)
        # REST threads share the tenant series
        with self._cv:
            series = self._tenant_series(tenant)
            tracker = self._tenant_latency.get(series)
            if tracker is None:
                tracker = self._tenant_latency[series] = LatencyTracker()
            self._tenant_requests[series] = \
                self._tenant_requests.get(series, 0) + 1
        tracker.record(time.monotonic() - t0)
        return result

    def _quota_check(self, tenant: str, need: int) -> None:
        """Weighted-fair admission over the page budget: with more than
        one live tenant, each may hold at most ``usable * w_t / sum(w)``
        pages, so an abusive tenant exhausts its own quota (429) and
        cannot starve another. A sole tenant may use the whole pool."""
        live = set(self.pool.tenants())
        live.add(tenant)
        if len(live) < 2:
            return
        total_w = sum(self._weight(t) for t in live)
        quota = int(self.pool.usable * self._weight(tenant) / total_w)
        used = self.pool.tenant_pages(tenant)
        if used + need > quota:
            self.rejected_total += 1
            raise V.HttpError(
                V.HTTP_TOO_MANY_REQUESTS,
                f"tenant {tenant!r} over its weighted page quota "
                f"({used}+{need} > {quota} of {self.pool.usable} "
                f"pages) — retry with backoff")

    def _pop_next(self) -> _Request:
        # weighted-fair pick: the queued request whose tenant holds the
        # fewest pages per unit weight goes first (FIFO within a tenant)
        if self._degraded or len(self._queue) <= 1:
            return self._queue.popleft()
        best_i = 0
        best_key: Optional[Tuple[float, int]] = None
        for i, req in enumerate(self._queue):
            tenant = self._tenant_of(req.payload)
            k = (self.pool.tenant_pages(tenant) / self._weight(tenant), i)
            if best_key is None or k < best_key:
                best_i, best_key = i, k
        req = self._queue[best_i]
        del self._queue[best_i]
        return req

    # -- paged admission -----------------------------------------------
    def _alloc_pages(self, need: int, tenant: str) -> List[int]:
        try:
            pages = self.pool.alloc(need, tenant)
            self._alloc_fault_streak = 0
            return pages
        except faults.InjectedFault as exc:
            self._alloc_fault_streak += 1
            if self._alloc_fault_streak >= self._DEGRADE_AFTER:
                self._degrade_to_slot()
            self.rejected_total += 1
            raise V.HttpError(
                V.HTTP_TOO_MANY_REQUESTS,
                f"KV page allocation failed ({exc}) — retry with "
                f"backoff")
        except PoolExhausted as exc:
            # prefix-cache holds are the reclaimable tier: drop LRU
            # entries before rejecting
            while self.prefix.evict_one():
                try:
                    pages = self.pool.alloc(need, tenant)
                    self._alloc_fault_streak = 0
                    return pages
                except PoolExhausted as retry_exc:
                    exc = retry_exc
            self.rejected_total += 1
            raise V.HttpError(
                V.HTTP_TOO_MANY_REQUESTS,
                f"KV page pool exhausted ({exc}) — retry with "
                f"backoff")

    def _admit(self, slot: int, req: _Request) -> None:
        if self._degraded:
            return super()._admit(slot, req)
        self._install(slot, self._prepare(req))

    def _prepare(self, req: _Request) -> Dict[str, Any]:
        """Funding and prefill compute of one admission, without
        touching the pool tensors or the draft cache: quota check, prefix
        lookup and page pins, page allocation, the prefill forward and,
        with a draft, the draft's prefill. Returns the record
        :meth:`_install` consumes. The disaggregated session runs this on
        its prefill worker and publishes the record with an extra
        reference on its pages (:meth:`_publishes`). On any failure every
        page reference this admission took is released before the error
        propagates."""
        if self.kv_dtype == "int8":
            # the quantized plane's fault site: a transient fault is a
            # retryable 429; a latched one walks the degrade ladder back
            # to exact pages and weights
            try:
                faults.maybe_inject("kv_quant", self._ctx.config)
                self._quant_fault_streak = 0
            except faults.InjectedFault as exc:
                self._quant_fault_streak += 1
                if self._quant_fault_streak >= self._DEGRADE_AFTER:
                    self._degrade_to_exact(
                        f"kv_quant fault latched ({exc})")
                self.rejected_total += 1
                raise V.HttpError(
                    V.HTTP_TOO_MANY_REQUESTS,
                    f"quantized KV path fault ({exc}) — retry with "
                    f"backoff")
        admit_t0 = time.monotonic()
        payload = req.payload
        prompt = list(payload["prompt"])
        new = int(payload.get("maxNewTokens") or 32)
        seed = int(payload.get("seed", 0))
        tenant = self._tenant_of(payload)
        keep = self.cache_len - new
        if len(prompt) > keep:
            prompt = prompt[-keep:]
        s = len(prompt)
        pl = self.page_len
        # exactly the tokens this request can touch
        total_pages = -(-(s + new) // pl)

        entry = self.prefix.lookup_full(prompt)
        if entry is not None:
            shared = list(entry["fullPages"])
            donor_tail = entry["tailPage"]
        else:
            shared, _ = self.prefix.lookup_partial(prompt)
            shared = shared or []
            donor_tail = None
        n_shared = len(shared)
        # pin the looked-up pages before quota and allocation: under
        # pressure _alloc_pages evicts prefix entries, maybe the one
        # backing this admission, and its pages must not come back as
        # fresh ones. The donor tail pin lasts until the copy and is
        # not charged to the tenant
        if shared:
            self.pool.incref(shared, tenant)
        if donor_tail is not None:
            self.pool.incref([donor_tail])
        fresh: List[int] = []
        published = False
        row: List[int] = []
        try:
            self._quota_check(tenant, total_pages - n_shared)
            fresh = self._alloc_pages(total_pages - n_shared, tenant)
            row = shared + fresh
            rec: Dict[str, Any] = {
                "req": req, "s": s, "new": new, "seed": seed,
                "tenant": tenant, "row": row, "fresh": fresh,
                "nShared": n_shared, "donorTail": donor_tail,
                "donorLogits": None, "admitT0": admit_t0, "first": None,
                "pcache": None, "dpcache": None, "writePages": [],
                "insert": None, "published": False}
            tokens = torch.tensor([prompt], dtype=torch.long,
                                  device=self._model.device)
            if entry is not None:
                # full hit: no prefill; the tail copy and the first
                # token's draw run in _install
                rec["donorLogits"] = entry["logits"]
                self.prefills_skipped += 1
            else:
                nxt, last_logits, pcache = self._pprefill_for(s)(tokens,
                                                                 seed)
                n_prefill_pages = -(-s // pl)
                rec["writePages"] = row[n_shared:n_prefill_pages]
                rec["pcache"] = pcache
                rec["first"] = int(nxt[0])
                n_full = s // pl
                tail_page = row[n_full] if s % pl else None
                rec["insert"] = (prompt, row[:n_full], tail_page,
                                 last_logits[0])
            if self._spec_on():
                # the draft's prompt KV, from its own prefill; it joins
                # the draft cache in _install (the decode thread's alone)
                _, rec["dpcache"] = self._draft_prefill_for(s)(tokens, seed)
            if self._publishes():
                # the handoff: its fault site, then the publish hold that
                # keeps every page alive until the decode worker adopts
                # the record (or a drain releases it)
                faults.maybe_inject("kv_page_handoff", self._ctx.config)
                self._note_handoff_ok()
                self.pool.incref(row)
                published = rec["published"] = True
            return rec
        except faults.InjectedFault as exc:
            # only kv_page_handoff arrives here (allocation faults are
            # HttpErrors by now): a retryable 429, every reference back
            self._note_handoff_fault()
            if shared or fresh:
                self.pool.decref(shared + fresh, tenant)
            if donor_tail is not None:
                self.pool.decref([donor_tail])
            self.rejected_total += 1
            raise V.HttpError(
                V.HTTP_TOO_MANY_REQUESTS,
                f"KV page handoff failed ({exc}) — retry with "
                f"backoff") from None
        except BaseException:
            # quota reject, allocation failure or a prefill error:
            # release every reference this admission took, or the pool
            # shrinks and the tenant's charge stays
            if published:
                self.pool.decref(row)
            if shared or fresh:
                self.pool.decref(shared + fresh, tenant)
            if donor_tail is not None:
                self.pool.decref([donor_tail])
            raise

    def _install(self, slot: int, rec: Dict[str, Any]) -> None:
        """Pool writes of an admission (the prefill's pages, or the
        tail-page copy of a full hit), the draft cache's join, the prefix
        insert, and the slot's state. Only the thread that writes the
        pool (the decode worker) calls this; an adopted record's publish
        hold is released here."""
        req = rec["req"]
        row, tenant = rec["row"], rec["tenant"]
        try:
            if rec["donorLogits"] is not None:
                if rec["donorTail"] is not None:
                    self._copy_page(self._pool, rec["donorTail"],
                                    rec["fresh"][0])
                first = int(self._sample_first(rec["donorLogits"],
                                               rec["seed"], rec["s"]))
            else:
                if rec["writePages"]:
                    self._pjoin(self._pool, rec["pcache"],
                                torch.tensor(rec["writePages"],
                                             dtype=torch.long,
                                             device=self._model.device),
                                rec["nShared"] * self.page_len)
                first = rec["first"]
                if rec["insert"] is not None:
                    # shareable only once its pages are written
                    self.prefix.insert(*rec["insert"])
            if rec["dpcache"] is not None and self._spec_on():
                self._draft_cache = self._draft_join(
                    self._draft_cache, rec["dpcache"], slot)
        except BaseException:
            if rec["published"]:
                self.pool.decref(row)
            self.pool.decref(row, tenant)
            if rec["donorTail"] is not None:
                self.pool.decref([rec["donorTail"]])
            raise
        if rec["donorTail"] is not None:
            self.pool.decref([rec["donorTail"]])
        if rec["published"]:
            # adopted: the stream's references own the pages now
            self.pool.decref(row)
        now = time.monotonic()
        self._record_role("prefill", now - rec["admitT0"])
        self._ttft.record(now - req.queued_at)
        self._slot_req[slot] = req
        self._slot_out[slot] = [first]
        self._slot_left[slot] = rec["new"] - 1
        self._slot_t0[slot] = now
        self._tok[slot, 0] = first
        self._col[slot] = rec["s"]
        self._seeds[slot] = rec["seed"]
        self._set_table(slot, row)
        self._slot_pages[slot] = row
        self._slot_tenant[slot] = tenant
        self.tokens_total += 1
        if self._slot_left[slot] <= 0:
            self._retire(slot)

    def _retire(self, slot: int) -> None:
        if not self._degraded:
            pages = self._slot_pages[slot]
            if pages:
                self.pool.decref(pages, self._slot_tenant[slot])
            self._slot_pages[slot] = []
            self._slot_tenant[slot] = None
            if self._bt[slot].any():
                self._set_table(slot, [])  # lane appends go to page 0
        super()._retire(slot)

    def _gather_width(self, extra: int = 0) -> int:
        """Pages each step gathers: the power-of-2 bucket that covers
        the longest live stream, so short streams never read long
        streams' pages. ``extra`` widens it for a verify window, which
        appends up to ``extra`` tokens past each stream's col."""
        need = 1
        for slot in range(self.slots):
            if self._slot_req[slot] is not None:
                need = max(need, (int(self._col[slot]) + extra)
                           // self.page_len + 1)
        width = 1
        while width < need:
            width *= 2
        return min(width, self._pages_per_slot)

    def _run_step(self) -> torch.Tensor:
        if self._degraded:
            return super()._run_step()
        # the periodic quality gate, before the step: a breach degrades
        # here and the step runs on the rebuilt exact path
        self._steps_since_probe += 1
        if self._steps_since_probe >= max(
                1, int(self._ctx.config.serve_drift_every)):
            self._maybe_probe_drift()
        width = self._gather_width()
        return self._pstep(self._pool, self._tok, self._col,
                           self._bt_dev[:, :width], self._seeds)

    def _decode_round(self, active: List[int]) -> None:
        if self._spec_on():
            return self._spec_round(active)
        return super()._decode_round(active)

    def _spec_round(self, active: List[int]) -> None:
        """One speculative iteration: the draft proposes ``spec_k``
        greedy tokens a stream, the target scores the window in one
        verify step, and exact acceptance keeps a prefix, so each round
        lands 1 to ``spec_k + 1`` tokens a stream."""
        draft_t0 = time.monotonic()
        drafts = self._draft_propose(self._draft_cache, self._tok,
                                     self._col)
        drafts = drafts.cpu().numpy()  # device sync: the draft's time
        self._record_role("draft", time.monotonic() - draft_t0)
        # the last funded position of each stream: the verify's appends
        # past it go to trash page 0, and the clamp below drops the
        # tokens scored there
        limit = np.zeros((self.slots,), np.int64)
        for slot in range(self.slots):
            limit[slot] = max(
                0, len(self._slot_pages[slot]) * self.page_len - 1)
        width = self._gather_width(extra=self._spec_k)
        emitted, n_acc = self._verify(
            self._pool, self._tok, drafts, self._col, self._seeds,
            self._bt_dev[:, :width], limit)
        emitted = emitted.cpu().numpy()
        n_acc = n_acc.cpu().numpy()
        self._decode_seconds += time.monotonic() - draft_t0
        self.decode_steps += 1
        self.spec_steps += 1
        self.spec_slot_steps += len(active)
        self.peak_active = max(self.peak_active, len(active))
        for slot in active:
            take = max(1, min(int(n_acc[slot]) + 1,
                              int(self._slot_left[slot]),
                              self.cache_len - 1 - int(self._col[slot])))
            toks = [int(t) for t in emitted[slot, :take]]
            self._slot_out[slot].extend(toks)
            self._slot_left[slot] -= take
            self.tokens_total += take
            self.decode_tokens_total += take
            self.spec_accepted_total += take - 1
            self._tok[slot, 0] = toks[-1]
            self._col[slot] += take
            if self._slot_left[slot] <= 0 or \
                    self._col[slot] >= self.cache_len - 1:
                self._retire(slot)

    # -- degrade ladder ------------------------------------------------
    def _fail_streams(self, why: str) -> None:
        for slot in range(self.slots):
            req = self._slot_req[slot]
            self._slot_req[slot] = None
            self._slot_out[slot] = []
            self._slot_pages[slot] = []
            self._slot_tenant[slot] = None
            if req is not None:
                req.fail(V.HttpError(V.HTTP_UNAVAILABLE, why))
        self._tok[:] = 0
        self._col[:] = 0
        self._seeds[:] = 0
        self._slot_left[:] = 0

    def _degrade_to_slot(self) -> None:
        """Latched ``kv_page_alloc``: fail the in-flight paged streams,
        drop the pool, and serve every later request on the slot cache
        (one rung down the ladder, never an outage)."""
        if self._degraded:
            return
        self._degraded = True
        # the slot cache has no verify step: speculation ends here
        self._release_spec_state()
        self._fail_streams("session degraded to the slot KV path "
                           "mid-stream (kv_page_alloc latched) — retry")
        self._pool = None  # free the pool before the slot cache
        LMServingSession._init_decode_path(self)

    def _degrade_to_exact(self, reason: str) -> None:
        """Latched ``kv_quant`` fault or drift breach: rebuild the same
        paged machinery over exact pages and weights (the model's own
        dtype). In-flight quantized streams fail with a retryable 503 and
        the pool, prefix cache and block tables start anew."""
        if self.kv_dtype == "bf16" and self.weights_dtype == "bf16":
            return
        self._fail_streams(f"session degraded to exact serving "
                           f"mid-stream ({reason}) — retry")
        self.kv_dtype = "bf16"
        self._pool = None  # free the int8 pool before the exact one
        if self.weights_dtype != "bf16":
            self.weights_dtype = "bf16"
            self._serve_module = self._model.serving_module("bf16")
            self._param_bytes = _weight_bytes(self._serve_module)
        PagedLMServingSession._init_decode_path(self)
        self.quant_degrades += 1

    # -- quantization quality gate -------------------------------------
    def _maybe_probe_drift(self) -> None:
        """Measure quantized-vs-exact drift and degrade on a breach.
        A no-op for exact sessions."""
        self._steps_since_probe = 0
        if self._degraded or (self.kv_dtype == "bf16"
                              and self.weights_dtype == "bf16"):
            return
        drift, parts = self._measure_drift()
        self._last_drift = drift
        self._drift_parts = parts
        self._drift_probes += 1
        limit = float(self._ctx.config.serve_drift_max or 0.0)
        if limit > 0 and drift > limit:
            self._degrade_to_exact(f"probe drift {drift:.4f} > "
                                   f"LO_SERVE_DRIFT_MAX={limit:g}")

    def _measure_drift(self) -> Tuple[float, Dict[str, float]]:
        """Relative L1 drift, quantized against exact, per part:

        - ``kv``: one paged decode-attention step over a held random KV
          probe, int8 pages with the dequantizing gather against the
          exact pages (no session state is touched);
        - ``weights``: the final logit row of a held probe prompt through
          the session's module against the model's own.

        The probes come from a fixed seed, so repeated probes measure the
        quantization, not sampling noise."""
        parts: Dict[str, float] = {}
        rng = np.random.default_rng(0)
        dev = self._model.device

        def rel(a, b):
            a, b = a.float(), b.float()
            return float((a - b).abs().mean() / (a.abs().mean() + 1e-9))

        with torch.inference_mode():
            if self.kv_dtype == "int8":
                _, pl, kv, d = self._pool[0][0].shape
                heads = int(self._model.n_heads)
                n_probe = 4

                def normal(*shape):
                    return torch.from_numpy(rng.normal(size=shape).astype(
                        np.float32)).to(dev)

                kp, vp = normal(n_probe, pl, kv, d), normal(n_probe, pl,
                                                            kv, d)
                bt = torch.arange(n_probe, device=dev)[None, :]
                col = torch.tensor([n_probe * pl - 1], device=dev)
                q = normal(1, 1, heads, d)
                exact = attn_ops.paged_decode_attention(q, kp, vp, bt, col)
                kq, ks = attn_ops.quantize_kv_pages(kp)
                vq, vs = attn_ops.quantize_kv_pages(vp)
                quant = attn_ops.quantized_paged_decode_attention(
                    q, kq, ks, vq, vs, bt, col)
                parts["kv"] = rel(exact, quant)
            if self.weights_dtype != "bf16":
                probe_len = max(1, min(8, self.cache_len - 1))
                prompt = torch.from_numpy(rng.integers(
                    1, int(self._model.vocab_size),
                    size=(1, probe_len))).to(dev)
                exact = self._model.module(prompt)[:, -1]
                quant = self._serve_module(prompt)[:, -1]
                parts["weights"] = rel(exact, quant)
        drift = max(parts.values()) if parts else 0.0
        return drift, parts

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        with self._cv:
            latency = dict(self._tenant_latency)
            requests = dict(self._tenant_requests)
        tenants: Dict[str, Any] = {}
        for t in sorted(set(self.pool.tenants()) | set(latency)):
            tracker = latency.get(t)
            tenants[t] = {
                "weight": self._weight(t),
                "pages": self.pool.tenant_pages(t),
                "requests": requests.get(t, 0),
                "latency": tracker.snapshot() if tracker else
                {"count": 0, "p50Ms": 0.0, "p99Ms": 0.0},
            }
        kv = self.pool.stats()
        kv["mode"] = "slot-degraded" if self._degraded else "paged"
        # bytes resident per token of KV capacity (int8 pages with their
        # scales, or the exact pool)
        denom = (self.slots * self.cache_len if self._degraded
                 else self.n_pages * self.page_len)
        kv["bytesPerToken"] = round(
            self._cache_bytes / float(max(1, denom)), 3)
        prefix = self.prefix.stats()
        prefix["prefillsSkipped"] = self.prefills_skipped
        kv["prefix"] = prefix
        kv["tenants"] = tenants
        out["kv"] = kv
        out["quant"] = {"degrades": self.quant_degrades,
                        "kv": self.kv_dtype,
                        "weights": self.weights_dtype}
        if self._last_drift is not None:
            out["drift"] = {
                "value": round(self._last_drift, 6),
                "parts": {k: round(v, 6)
                          for k, v in self._drift_parts.items()},
                "probes": self._drift_probes,
                "max": float(self._ctx.config.serve_drift_max or 0.0),
            }
        if self._draft_name:
            out["spec"] = {
                "draft": self._draft_name,
                "specK": self._spec_k,
                "steps": self.spec_steps,
                "acceptedTokensPerStep": round(
                    self.spec_accepted_total /
                    max(1, self.spec_slot_steps), 4),
                "acceptedTokensTotal": self.spec_accepted_total,
                "active": self._spec_on(),
            }
        return out

    def perf_stats(self) -> Dict[str, Any]:
        out = super().perf_stats()
        if out and self._draft_name and self.spec_slot_steps:
            out["acceptedTokensPerStep"] = round(
                self.spec_accepted_total / self.spec_slot_steps, 4)
        return out


class DisaggLMServingSession(PagedLMServingSession):
    """Disaggregated prefill and decode (``disagg: true``, or
    ``LO_SERVE_DISAGG=1``).

    A prefill worker thread pops admitted prompts off the queue, runs
    :meth:`_prepare` (quota, page funding, the prefill forward and the
    draft's) and publishes the record, its pages held by an extra
    reference, on a ready queue. The decode worker (the session thread)
    adopts records into free slots between decode rounds
    (:meth:`_install`), so a burst of long prompts does not stall the
    token streams in flight. Pages are handed over by reference count,
    never copied.

    On one card both workers share the device (``mode: "colocated"``)
    and issue to its one default stream, in the order they run; a record
    is published after its prefill's first token reached the host, so
    its KV rows are complete before the decode worker reads them. The
    GIL interleaves the two threads: they overlap only while one waits
    on the card. The JAX package's split mode, each worker on its own
    slice of a mesh, needs a second card.

    Thread contract: only the decode thread writes the pool tensors and
    the draft cache. The prefill worker touches the refcounts (the pool
    and the prefix cache lock themselves) and runs prefills into fresh
    caches. A degrade it triggers is only requested (``_degrade_pending``)
    and runs on the decode thread. A latched ``kv_page_handoff`` fault
    collapses the session to fused serving (``mode:
    "fused-degraded"``): in-flight streams fail with a retryable 503,
    published records are drained with every page reference restored,
    and later requests serve through the inherited fused loop.
    """

    def __init__(self, name: str, ctx, model, slots: int, cache_len: int,
                 temperature: float, top_k: Optional[int],
                 top_p: Optional[float], page_len: int, n_pages: int,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 kv_dtype: str = "bf16", weights_dtype: str = "bf16",
                 draft_model=None, draft_name: str = "", spec_k: int = 4):
        self._ready: Deque[Dict[str, Any]] = collections.deque()
        self._handoff_cv = locks.make_condition("serving.handoff")
        self._degrade_pending: Optional[Tuple[str, str]] = None
        self._handoff_fault_streak = 0
        self.handoffs_total = 0
        self.disagg_mode = "colocated"
        super().__init__(name, ctx, model, slots, cache_len, temperature,
                         top_k, top_p, page_len, n_pages, tenant_weights,
                         kv_dtype=kv_dtype, weights_dtype=weights_dtype,
                         draft_model=draft_model, draft_name=draft_name,
                         spec_k=spec_k)
        self._prefill_thread = threading.Thread(
            target=self._prefill_run, name=f"serving-{name}-prefill",
            daemon=True)

    def start(self) -> None:
        super().start()
        self._prefill_thread.start()

    # -- mode ----------------------------------------------------------
    def _fused(self) -> bool:
        return self._degraded or self.disagg_mode == "fused-degraded"

    def _publishes(self) -> bool:
        return not self._fused()

    def _note_handoff_fault(self) -> None:
        self._handoff_fault_streak += 1
        if self._handoff_fault_streak >= self._DEGRADE_AFTER and \
                self._degrade_pending is None and not self._fused():
            self._degrade_pending = ("fused",
                                     "kv_page_handoff fault latched")

    def _note_handoff_ok(self) -> None:
        self._handoff_fault_streak = 0

    # -- prefill worker ------------------------------------------------
    def _prefill_run(self) -> None:
        while True:
            with self._cv:
                if self._closed or self._fused():
                    break
                req = None
                if self._degrade_pending is None and self._queue and \
                        len(self._ready) < self.slots:
                    # backpressure: at most `slots` records in flight, so
                    # a prompt flood cannot fund pages faster than decode
                    # retires them
                    req = self._pop_next()
                if req is None:
                    self._cv.wait(timeout=_IDLE_TICK_SECONDS)
            if req is None:
                continue
            try:
                rec = self._prepare(req)
            except V.HttpError as exc:
                req.fail(exc)
                continue
            except Exception as exc:  # noqa: BLE001
                req.fail(V.HttpError(V.HTTP_UNAVAILABLE,
                                     f"prefill failed: {exc}"))
                continue
            with self._handoff_cv:
                # the mode is written under this lock by
                # _collapse_to_fused, so no record slips in after the
                # drain
                publish = not self._fused()
                if publish:
                    self._ready.append(rec)
                    self.handoffs_total += 1
            if not publish:
                self._discard_record(rec, V.HttpError(
                    V.HTTP_UNAVAILABLE,
                    "session collapsed to fused prefill+decode — retry"))
                continue
            with self._cv:
                self._cv.notify_all()

    # -- decode worker -------------------------------------------------
    def _have_work(self) -> bool:
        if self._fused():
            return super()._have_work()
        return (bool(self._ready) or self._degrade_pending is not None
                or any(r is not None for r in self._slot_req))

    def _serve_once(self) -> bool:
        pending = self._degrade_pending
        if pending is not None:
            self._degrade_pending = None
            kind, reason = pending
            if kind == "exact":
                PagedLMServingSession._degrade_to_exact(self, reason)
            else:
                if not self._fused():
                    self._collapse_to_fused(reason)
                if kind == "slot":
                    PagedLMServingSession._degrade_to_slot(self)
        if self._fused():
            return super()._serve_once()
        did = self._adopt_ready()
        active = self._active_slots()
        if not active:
            return did
        self._decode_round(active)
        return True

    def _adopt_ready(self) -> bool:
        """Move published records into free slots (decode thread). The
        adoption releases the publish hold: from here the stream owns its
        pages as a fused admission does."""
        did = False
        while True:
            with self._handoff_cv:
                if not self._ready:
                    break
                rec = self._ready.popleft()
            free = [i for i, r in enumerate(self._slot_req) if r is None]
            if not free:
                with self._handoff_cv:
                    self._ready.appendleft(rec)
                break
            try:
                self._install(free[0], rec)
                did = True
            except V.HttpError as exc:
                rec["req"].fail(exc)
            except Exception as exc:  # noqa: BLE001
                rec["req"].fail(V.HttpError(
                    V.HTTP_UNAVAILABLE, f"prefill install failed: {exc}"))
        return did

    # -- degrade -------------------------------------------------------
    def _degrade_to_slot(self) -> None:
        if threading.current_thread() is self._prefill_thread:
            if self._degrade_pending is None:
                self._degrade_pending = ("slot", "kv_page_alloc latched")
            return
        if not self._fused():
            self._collapse_to_fused("kv_page_alloc latched")
        super()._degrade_to_slot()

    def _degrade_to_exact(self, reason: str) -> None:
        if threading.current_thread() is self._prefill_thread:
            # the rebuild swaps the pool: decode-thread work; the
            # prefill worker pauses until it lands
            if self._degrade_pending is None:
                self._degrade_pending = ("exact", reason)
            return
        super()._degrade_to_exact(reason)

    def _collapse_to_fused(self, reason: str) -> None:
        """Stop disaggregating (a latched handoff fault, or a slot
        degrade beneath it). Decode thread only."""
        with self._handoff_cv:
            if self.disagg_mode == "fused-degraded":
                return
            self.disagg_mode = "fused-degraded"
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None:
                continue
            pages = self._slot_pages[slot]
            if pages:
                self.pool.decref(pages, self._slot_tenant[slot])
            self._slot_req[slot] = None
            self._slot_out[slot] = []
            self._slot_left[slot] = 0
            self._slot_pages[slot] = []
            self._slot_tenant[slot] = None
            self._set_table(slot, [])
            req.fail(V.HttpError(
                V.HTTP_UNAVAILABLE,
                f"session collapsed to fused prefill+decode mid-stream "
                f"({reason}) — retry"))
        self._drain_ready(V.HttpError(
            V.HTTP_UNAVAILABLE, f"prefill worker degraded ({reason}) — "
            f"retry"))

    def _drain_ready(self, error: V.HttpError) -> None:
        while True:
            with self._handoff_cv:
                if not self._ready:
                    return
                rec = self._ready.popleft()
            self._discard_record(rec, error)

    def _discard_record(self, rec: Dict[str, Any],
                        error: V.HttpError) -> None:
        """Release every page reference a published record owns (the
        publish hold and the stream's) and fail its request: the free
        count comes back to where an admit and retire would leave it."""
        if rec["published"]:
            self.pool.decref(rec["row"])
        if rec["row"]:
            self.pool.decref(rec["row"], rec["tenant"])
        if rec["donorTail"] is not None:
            self.pool.decref([rec["donorTail"]])
        rec["req"].fail(error)

    def close(self) -> None:
        super().close()
        if self._prefill_thread.is_alive():
            with self._cv:
                self._cv.notify_all()
            self._prefill_thread.join(timeout=30.0)
        self._drain_ready(V.HttpError(
            V.HTTP_UNAVAILABLE, f"serving session {self.name} was deleted"))

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        with self._handoff_cv:
            qlen = len(self._ready)
        out["disagg"] = {
            "mode": self.disagg_mode,
            "handoffsTotal": self.handoffs_total,
            "handoffQueue": qlen,
            "handoffFaultStreak": self._handoff_fault_streak,
        }
        return out


class BucketServingSession(_SessionBase):
    """Shape-bucketed micro-batcher for ``predict`` models (``type:
    "predict"``, the default for an artifact without ``serve_fns``, such
    as a fitted ``TextClassifier``).

    Queued requests gather for up to ``serve_max_wait_ms`` (or until the
    largest bucket fills); their stacked rows pad with row 0 to the
    smallest bucket that holds them, and one ``predict`` call with the
    bucket as its batch size serves the burst in one forward. Each
    request gets its own rows back, and the bucket."""

    kind = "predict"

    def __init__(self, name: str, ctx, instance):
        super().__init__(name, ctx)
        self._instance = instance
        buckets = sorted({int(b) for b in
                          str(ctx.config.serve_buckets).split(",") if b})
        self.buckets = [b for b in buckets if b > 0] or [1]
        self._max_wait = float(ctx.config.serve_max_wait_ms) / 1e3
        self.predicts_total = 0
        self.rows_total = 0
        self._last_fill: Optional[float] = None
        # fill-weighted goodput: useful rows against padded bucket rows,
        # and the time spent producing them
        self._predict_seconds = 0.0
        self._fill_bucket_sum = 0

    def validate_request(self, payload: Dict[str, Any]) -> None:
        x = payload.get("x")
        if not isinstance(x, (list, tuple)) or not x:
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: x must be a non-empty "
                f"list of feature rows")

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _gather(self) -> List[_Request]:
        """The next burst: the first request opens the window, which
        closes after ``serve_max_wait_ms`` or once the largest bucket is
        full."""
        limit = self.buckets[-1]
        batch: List[_Request] = []
        rows = 0
        deadline = None
        with self._cv:
            while True:
                while self._queue and rows < limit:
                    req = self._queue.popleft()
                    batch.append(req)
                    rows += len(req.payload["x"])
                if not batch or rows >= limit:
                    return batch
                if deadline is None:
                    deadline = time.monotonic() + self._max_wait
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return batch
                self._cv.wait(timeout=remaining)
                if not self._queue:
                    return batch

    def _serve_once(self) -> bool:
        batch = self._gather()
        if not batch:
            return False
        try:
            stacked = np.concatenate(
                [np.asarray(r.payload["x"]) for r in batch], axis=0)
        except ValueError as exc:
            for req in batch:
                req.fail(V.HttpError(
                    V.HTTP_NOT_ACCEPTABLE,
                    f"{V.MESSAGE_INVALID_FIELD}: rows do not stack "
                    f"({exc})"))
            return True
        n = stacked.shape[0]
        bucket = self._bucket_for(n)
        if bucket > n:
            # pad with row 0 to the bucket; the pad rows' outputs are
            # never returned
            pad = np.repeat(stacked[:1], bucket - n, axis=0)
            stacked = np.concatenate([stacked, pad], axis=0)
        predict_t0 = time.monotonic()
        try:
            out = np.asarray(self._instance.predict(
                stacked, batch_size=stacked.shape[0]))
        except Exception as exc:  # noqa: BLE001
            for req in batch:
                req.fail(V.HttpError(V.HTTP_UNAVAILABLE,
                                     f"predict failed: {exc}"))
            return True
        self._predict_seconds += time.monotonic() - predict_t0
        self.predicts_total += 1
        self.rows_total += n
        self._last_fill = round(n / bucket, 4)
        self._fill_bucket_sum += bucket
        offset = 0
        for req in batch:
            k = len(req.payload["x"])
            req.finish({"predictions": out[offset:offset + k].tolist(),
                        "bucket": bucket})
            offset += k
        return True

    def _batch_fill(self) -> Optional[float]:
        return self._last_fill

    def perf_stats(self) -> Dict[str, Any]:
        if not self.predicts_total or self._predict_seconds <= 0:
            return {}
        return {
            "predictsTotal": self.predicts_total,
            "rowsPerSec": round(self.rows_total / self._predict_seconds, 2),
            "goodputFrac": round(
                self.rows_total / max(1, self._fill_bucket_sum), 4),
        }

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out.update({"buckets": self.buckets,
                    "predictsTotal": self.predicts_total,
                    "rowsTotal": self.rows_total})
        return out


def _not_ported(what: str) -> V.HttpError:
    return V.HttpError(
        V.HTTP_NOT_ACCEPTABLE,
        f"{V.MESSAGE_INVALID_FIELD}: {what} is not yet ported to the "
        f"PyTorch serving plane (one card has no slice of a mesh to "
        f"lease)")


class ServingManager:
    """Session registry + REST verbs (create/predict/stats/delete); one
    session per model name."""

    def __init__(self, ctx):
        self._ctx = ctx
        self._sessions: Dict[str, _SessionBase] = {}
        self._lock = locks.make_lock("serving.manager")

    def create(self, model_name: str,
               body: Dict[str, Any]) -> Dict[str, Any]:
        body = body or {}
        with self._lock:
            if model_name in self._sessions:
                raise V.HttpError(
                    V.HTTP_CONFLICT,
                    f"{V.MESSAGE_DUPLICATE_FILE}: serving session for "
                    f"{model_name} already exists")
        type_string = self._ctx.params.artifact_type(model_name)
        if type_string is None:
            raise V.HttpError(V.HTTP_NOT_FOUND,
                              f"{V.MESSAGE_NONEXISTENT_FILE}: "
                              f"{model_name}")
        instance = self._ctx.artifacts.load(model_name, type_string)
        session = self._build_session(model_name, instance, body)
        session.start()
        with self._lock:
            if model_name in self._sessions:  # lost a create race
                session.close()
                raise V.HttpError(
                    V.HTTP_CONFLICT,
                    f"{V.MESSAGE_DUPLICATE_FILE}: serving session for "
                    f"{model_name} already exists")
            self._sessions[model_name] = session
        return session.stats()

    def _build_session(self, model_name: str, instance: Any,
                       body: Dict[str, Any]) -> _SessionBase:
        kind = body.get("type")
        if kind is None:
            kind = "lm" if hasattr(instance, "serve_fns") else "predict"
        if kind not in ("lm", "predict"):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: type must be 'lm' or "
                f"'predict', got {kind!r}")
        if body.get("sliceDevices") is not None:
            raise _not_ported("sliceDevices")
        if kind == "predict":
            if not hasattr(instance, "predict"):
                raise V.HttpError(
                    V.HTTP_NOT_ACCEPTABLE,
                    f"{V.MESSAGE_INVALID_FIELD}: {model_name} has no "
                    f"predict method")
            return BucketServingSession(model_name, self._ctx, instance)
        if not hasattr(instance, "serve_fns"):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: {model_name} is not a "
                f"language model (no decode cache support)")
        slots = V.valid_positive_int(
            body.get("maxSlots"), "maxSlots",
            default=self._ctx.config.serve_max_batch)
        cache_len = V.valid_positive_int(
            body.get("cacheLen"), "cacheLen", default=int(instance.max_len))
        cache_len = min(cache_len, int(instance.max_len))
        temperature, top_k, top_p = V.valid_sampling(body)
        if top_k is not None and top_k >= instance.vocab_size:
            top_k = None
        cfg = self._ctx.config
        kv_mode = str(body.get("kv") or cfg.serve_kv or "slot")
        if kv_mode not in ("slot", "paged"):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: kv must be 'slot' or "
                f"'paged', got {kv_mode!r}")
        # "bf16" means exact: the model's own dtype
        kv_dtype = V.valid_choice(body.get("kvDtype"), "kvDtype",
                                  ("bf16", "int8"),
                                  default=str(cfg.serve_kv_dtype or "bf16"))
        weights = V.valid_choice(body.get("weights"), "weights",
                                 ("bf16", "int8", "fp8"),
                                 default=str(cfg.serve_weights or "bf16"))
        if kv_mode != "paged" and kv_dtype != "bf16" and \
                body.get("kvDtype") is not None:
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: kvDtype={kv_dtype!r} "
                f"needs the paged KV path (kv='paged') — the slot "
                f"cache is bf16-only")
        if kv_mode == "paged":
            page_len = V.valid_positive_int(
                body.get("pageLen"), "pageLen",
                default=int(cfg.serve_page_len))
            # block tables hold whole pages
            cache_len = max(page_len, (cache_len // page_len) * page_len)
            pages_per = cache_len // page_len
            # 0 = the slot cache's bytes (slots x pages per stream) plus
            # the trash page
            n_pages = V.valid_positive_int(
                body.get("pages"), "pages",
                default=int(cfg.serve_pages) or slots * pages_per + 1)
            n_pages = max(n_pages, pages_per + 1)
            disagg = self._want_disagg(body)
            draft_model, draft_name, spec_k = self._load_draft(
                body, instance, cache_len)
            session_cls = PagedLMServingSession
            if disagg:
                # validated as the JAX package validates it; one card has
                # no second slice to give the prefill worker
                V.valid_slice_devices(body.get("prefillDevices"))
                session_cls = DisaggLMServingSession
            return session_cls(
                model_name, self._ctx, instance, slots, cache_len,
                temperature, top_k, top_p, page_len, n_pages,
                parse_tenant_weights(cfg.serve_tenant_weights),
                kv_dtype=kv_dtype, weights_dtype=weights,
                draft_model=draft_model, draft_name=draft_name,
                spec_k=spec_k)
        if body.get("disagg") or body.get("draft"):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: disagg/draft need the paged "
                f"KV path (kv='paged') — the slot cache has no page "
                f"handoff or verify step")
        return LMServingSession(model_name, self._ctx, instance, slots,
                                cache_len, temperature, top_k, top_p,
                                weights_dtype=weights)

    def _want_disagg(self, body: Dict[str, Any]) -> bool:
        """The request's ``disagg`` (a JSON bool), else
        ``LO_SERVE_DISAGG``."""
        raw = body.get("disagg")
        if raw is None:
            return str(self._ctx.config.serve_disagg or "0").strip() \
                .lower() in ("1", "true", "yes", "on")
        if not isinstance(raw, bool):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: disagg must be a "
                f"boolean, got {raw!r}")
        return raw

    def _load_draft(self, body: Dict[str, Any], instance: Any,
                    cache_len: int):
        """The draft model of speculative decoding (the request's
        ``draft``, else ``LO_SERVE_DRAFT``): a fitted LM artifact with
        the target's vocabulary whose ``max_len`` covers the session's
        cache. Returns ``(draft or None, draft_name, spec_k)``."""
        cfg = self._ctx.config
        raw = body.get("draft")
        if raw is None:
            raw = str(cfg.serve_draft or "")
        if not raw:
            return None, "", 4
        if not isinstance(raw, str):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: draft must be a model "
                f"name string, got {raw!r}")
        spec_k = V.valid_positive_int(
            body.get("specK"), "specK", default=int(cfg.serve_spec_k or 4))
        type_string = self._ctx.params.artifact_type(raw)
        if type_string is None:
            raise V.HttpError(
                V.HTTP_NOT_FOUND,
                f"{V.MESSAGE_NONEXISTENT_FILE}: draft model {raw}")
        draft = self._ctx.artifacts.load(raw, type_string)
        if not hasattr(draft, "serve_fns_draft"):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: draft {raw} is not a "
                f"language model (no propose support)")
        if int(draft.vocab_size) != int(instance.vocab_size):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: draft vocab "
                f"({draft.vocab_size}) must match the target's "
                f"({instance.vocab_size}) — acceptance sampling "
                f"compares their distributions token-for-token")
        if int(draft.max_len) < int(cache_len):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: draft maxLen "
                f"({draft.max_len}) must cover cacheLen "
                f"({cache_len})")
        return draft, raw, spec_k

    def predict(self, model_name: str,
                body: Dict[str, Any]) -> Dict[str, Any]:
        session = self._get(model_name)
        body = body or {}
        session.validate_request(body)
        timeout = V.valid_timeout(body.get(V.TIMEOUT_FIELD))
        return session.submit(body, timeout=timeout)

    def _get(self, model_name: str) -> _SessionBase:
        with self._lock:
            session = self._sessions.get(model_name)
        if session is None:
            raise V.HttpError(
                V.HTTP_NOT_FOUND,
                f"{V.MESSAGE_NONEXISTENT_FILE}: no serving session "
                f"for {model_name}")
        return session

    def session_stats(self, model_name: str) -> Dict[str, Any]:
        return self._get(model_name).stats()

    def list_sessions(self) -> List[Dict[str, Any]]:
        with self._lock:
            sessions = list(self._sessions.values())
        return [s.stats() for s in sessions]

    def delete(self, model_name: str) -> Dict[str, Any]:
        with self._lock:
            session = self._sessions.pop(model_name, None)
        if session is None:
            raise V.HttpError(
                V.HTTP_NOT_FOUND,
                f"{V.MESSAGE_NONEXISTENT_FILE}: no serving session "
                f"for {model_name}")
        final = session.stats()
        session.close()
        final["deleted"] = True
        return final

    def close(self) -> None:
        with self._lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for session in sessions:
            session.close()
