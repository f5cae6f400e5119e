"""Resident LM serving with slot continuous batching (the slot session
of the JAX package's ``services/serving.py``).

:class:`LMServingSession` keeps a fitted language model and a fixed slot
KV cache on the card. Every worker iteration admits queued requests into
free slots (a batch-1 prefill at the exact prompt length, copied into
the slot), runs ONE step that advances every active slot a token, and
retires finished requests. Per-slot position and sampling-stream
bookkeeping replays the schedule ``LanguageModel.generate`` uses, so a
slot's greedy tokens equal a solo decode of the same request.

Admission control: a full queue rejects with 429, a closed session with
503. Not ported yet: the paged, quantized, disaggregated and
speculative sessions, bucketed classifier serving, the serving lease
(one card has no slice to share), and the observability hooks.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from learningorchestra_tpu_torch.runtime import locks
from learningorchestra_tpu_torch.services import validators as V

_IDLE_TICK_SECONDS = 0.05

# create-body fields of JAX serving sessions this package does not run
_UNPORTED_FIELDS = ("pageLen", "pages", "disagg", "draft", "specK",
                    "prefillDevices", "sliceDevices")


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
                 top_p: Optional[float]):
        super().__init__(name, ctx)
        self._model = model
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self._step, self._prefill_for, self._join = model.serve_fns(
            self.slots, self.cache_len, self.temperature, top_k, top_p)
        self._cache = model.serve_cache(self.slots, self.cache_len)
        self._param_bytes = int(sum(
            p.numel() * p.element_size()
            for p in model.module.parameters()))
        self.tokens_total = 0
        # decode goodput: every step advances ALL slots, only active
        # ones emit a useful token
        self.decode_steps = 0
        self.decode_tokens_total = 0
        self._decode_seconds = 0.0
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

    def _admit_loop(self) -> bool:
        admitted = False
        while True:
            with self._cv:
                free = [i for i, r in enumerate(self._slot_req)
                        if r is None]
                if not free or not self._queue:
                    break
                req = self._queue.popleft()
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
        nxt = self._step(self._cache, self._tok, self._col,
                         self._seeds).cpu().numpy()  # device sync
        self._decode_seconds += time.monotonic() - step_t0
        self.decode_steps += 1
        self.decode_tokens_total += len(active)
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
            "cacheLen": self.cache_len,
            "tokensTotal": self.tokens_total,
            "temperature": self.temperature,
            "weights": {"dtype": "bf16",
                        "bytes": self._param_bytes},
            "ttft": self._ttft.snapshot(),
            "roles": {r: t.snapshot() for r, t in
                      sorted(self._role_latency.items())},
        })
        return out


def _not_ported(what: str) -> V.HttpError:
    return V.HttpError(
        V.HTTP_NOT_ACCEPTABLE,
        f"{V.MESSAGE_INVALID_FIELD}: {what} is not yet ported to the "
        f"PyTorch serving plane (slot KV with bf16 weights only)")


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
        if kind == "predict":
            raise _not_ported("type 'predict' (bucketed serving)")
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
        kv_mode = str(body.get("kv") or "slot")
        if kv_mode not in ("slot", "paged"):
            raise V.HttpError(
                V.HTTP_NOT_ACCEPTABLE,
                f"{V.MESSAGE_INVALID_FIELD}: kv must be 'slot' or "
                f"'paged', got {kv_mode!r}")
        kv_dtype = V.valid_choice(body.get("kvDtype"), "kvDtype",
                                  ("bf16", "int8"), default="bf16")
        weights = V.valid_choice(body.get("weights"), "weights",
                                 ("bf16", "int8", "fp8"), default="bf16")
        if kv_mode != "slot":
            raise _not_ported(f"kv={kv_mode!r}")
        if kv_dtype != "bf16":
            raise _not_ported(f"kvDtype={kv_dtype!r}")
        if weights != "bf16":
            raise _not_ported(f"weights={weights!r}")
        unported = [f for f in _UNPORTED_FIELDS if body.get(f) is not None]
        if unported:
            raise _not_ported(", ".join(unported))
        return LMServingSession(model_name, self._ctx, instance, slots,
                                cache_len, temperature, top_k, top_p)

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
