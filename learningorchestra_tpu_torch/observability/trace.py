"""Lightweight span tracer (the port's copy of the JAX package's
``observability/trace.py``).

A *trace* is the timing story of one job or one serving request,
keyed by a string id (the collection name for jobs,
``serve/{model}/{seq}`` for serving requests). Each trace holds a
bounded ring of spans — ``traceId``, integer ``spanId``, ``parentId``,
name, attrs, monotonic start/end — so a finished job's full path
(``submit → validate → preflight → queueWait/leaseWait → dataLoad →
epoch[i] → checkpointCommit → artifactSave``) can be read back as a tree
(:func:`tree`) or a Chrome ``trace_event`` file (:mod:`.export`). The
port compiles nothing, so its traces carry no ``compile`` span.

Nesting needs no plumbing: :func:`span` pushes onto a thread-local
stack, so code deep inside the engine attaches children to whatever
job span is open on its thread. Cross-thread continuation (the
serving batcher finishing a request admitted on an HTTP thread) uses
the explicit ``trace=`` / ``parent=`` arguments, or :func:`add` to
record an already-measured interval retroactively.

Thread-safe; bounded (``LO_TRACE_RING`` spans per trace, at most
``_MAX_TRACES`` traces, LRU-evicted); and when ``LO_TRACE=0`` every
call degrades to a shared no-op object — no allocation, no lock.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple
from learningorchestra_tpu_torch.runtime import locks

_MAX_TRACES = 256

_lock = locks.make_lock("trace.registry")
_traces: "collections.OrderedDict[str, _Trace]" = collections.OrderedDict()
_tls = threading.local()


def _enabled() -> bool:
    from learningorchestra_tpu_torch.observability import get_config

    return bool(getattr(get_config(), "trace", True))


def _ring_size() -> int:
    from learningorchestra_tpu_torch.observability import get_config

    return max(8, int(getattr(get_config(), "trace_ring", 512)))


class Span:
    """One recorded interval. Mutable until :meth:`finish`; ``attrs``
    may be extended at any point via :meth:`set` (e.g. the engine
    marking ``cacheHit`` on an open compile span)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "end", "attrs", "thread")

    def __init__(self, trace_id: str, span_id: int,
                 parent_id: Optional[int], name: str,
                 start: float, thread: str,
                 attrs: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.thread = thread

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None
                else time.monotonic()) - self.start

    def to_dict(self) -> Dict[str, Any]:
        return {"traceId": self.trace_id, "spanId": self.span_id,
                "parentId": self.parent_id, "name": self.name,
                "startSeconds": self.start,
                "durationSeconds": self.duration,
                "inFlight": self.end is None,
                "thread": self.thread, "attrs": dict(self.attrs)}


class _Trace:
    """Spans of one trace, insertion-ordered, ring-bounded."""

    __slots__ = ("trace_id", "spans", "next_id", "created_wall",
                 "created_mono", "ring")

    def __init__(self, trace_id: str, ring: int):
        self.trace_id = trace_id
        self.spans: "collections.OrderedDict[int, Span]" = \
            collections.OrderedDict()
        self.next_id = 1
        self.created_wall = time.time()
        self.created_mono = time.monotonic()
        self.ring = ring

    def new_span(self, name: str, parent_id: Optional[int],
                 start: float, attrs: Optional[Dict[str, Any]],
                 thread: str) -> Span:
        if start < self.created_mono:
            # keep the anchor at the earliest span start, so rebased
            # timestamps are never negative — retro spans (serving
            # requests replayed after the response) begin before the
            # trace record itself exists
            delta = self.created_mono - start
            self.created_mono = start
            self.created_wall -= delta
        sid = self.next_id
        self.next_id += 1
        sp = Span(self.trace_id, sid, parent_id, name, start, thread,
                  attrs)
        self.spans[sid] = sp
        while len(self.spans) > self.ring:
            # oldest finished span first; never drop an open span
            victim = next((k for k, s in self.spans.items()
                           if s.end is not None), None)
            if victim is None:
                victim = next(iter(self.spans))
            del self.spans[victim]
        return sp


def _get_trace(trace_id: str, create: bool) -> Optional[_Trace]:
    """Caller holds ``_lock``."""
    tr = _traces.get(trace_id)
    if tr is not None:
        _traces.move_to_end(trace_id)
        return tr
    if not create:
        return None
    tr = _traces[trace_id] = _Trace(trace_id, _ring_size())
    while len(_traces) > _MAX_TRACES:
        _traces.popitem(last=False)
    return tr


def _stack() -> List[Span]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _NoopSpan:
    """Shared do-nothing span + context manager for the disabled
    path and for spans whose trace cannot be resolved."""

    __slots__ = ()
    trace_id = ""
    span_id = 0
    attrs: Dict[str, Any] = {}

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


NOOP = _NoopSpan()


class _SpanCtx:
    """Context manager wrapping one live span: pushes/pops the
    thread-local stack and stamps ``end`` (plus ``error`` on an
    exception) on exit."""

    __slots__ = ("sp", "_pushed")

    def __init__(self, sp: Span, pushed: bool):
        self.sp = sp
        self._pushed = pushed

    # delegate the span surface so ``with span(...) as s: s.set(...)``
    def set(self, **attrs: Any) -> Span:
        return self.sp.set(**attrs)

    @property
    def trace_id(self) -> str:
        return self.sp.trace_id

    @property
    def span_id(self) -> int:
        return self.sp.span_id

    @property
    def attrs(self) -> Dict[str, Any]:
        return self.sp.attrs

    def __enter__(self) -> "_SpanCtx":
        return self

    def __exit__(self, etype: Any, exc: Any, tb: Any) -> None:
        if etype is not None:
            self.sp.attrs.setdefault("error", etype.__name__)
        self.sp.end = time.monotonic()
        if self._pushed:
            st = _stack()
            if st and st[-1] is self.sp:
                st.pop()
            else:  # unbalanced exit (thread reuse): best-effort scrub
                try:
                    st.remove(self.sp)
                except ValueError:
                    pass


def span(name: str, trace: Optional[str] = None,
         parent: Optional[int] = None, **attrs: Any):
    """Open a span as a context manager.

    - ``trace=`` starts/continues that trace explicitly (root span,
      or child of ``parent`` if given);
    - otherwise the span attaches under the thread's current span;
    - with neither, or with tracing disabled, returns the shared
      no-op (nothing recorded, nothing allocated).
    """
    if not _enabled():
        return NOOP
    cur = _stack()[-1] if _stack() else None
    if trace is None:
        if cur is None:
            return NOOP
        trace = cur.trace_id
        if parent is None:
            parent = cur.span_id
    elif parent is None and cur is not None and cur.trace_id == trace:
        parent = cur.span_id
    now = time.monotonic()
    tname = threading.current_thread().name
    with _lock:
        tr = _get_trace(trace, create=True)
        sp = tr.new_span(name, parent, now, attrs or None, tname)
    _stack().append(sp)
    return _SpanCtx(sp, pushed=True)


def add(name: str, trace: str, start: float, end: float,
        parent: Optional[int] = None, **attrs: Any) -> Optional[int]:
    """Record an already-measured interval (monotonic seconds) — the
    retro path for code that batches work across threads (serving)
    and only knows the boundaries after the fact. Returns the new
    span's id (for parenting follow-up spans), or None when
    disabled."""
    if not _enabled():
        return None
    tname = threading.current_thread().name
    with _lock:
        tr = _get_trace(trace, create=True)
        sp = tr.new_span(name, parent, start, attrs or None, tname)
        sp.end = end
        return sp.span_id


def current() -> Optional[Tuple[str, int]]:
    """(traceId, spanId) of this thread's open span, for handing to
    another thread as an explicit ``trace=``/``parent=``."""
    st = getattr(_tls, "stack", None)
    if not st:
        return None
    sp = st[-1]
    return sp.trace_id, sp.span_id


def annotate(**attrs: Any) -> None:
    """Attach attrs to this thread's current span (no-op without
    one)."""
    st = getattr(_tls, "stack", None)
    if st:
        st[-1].set(**attrs)


def spans_of(trace_id: str) -> List[Span]:
    with _lock:
        tr = _traces.get(trace_id)
        return list(tr.spans.values()) if tr else []


def anchor_of(trace_id: str) -> Optional[Tuple[float, float]]:
    """(created_wall, created_mono) time anchors of a trace."""
    with _lock:
        tr = _traces.get(trace_id)
        return (tr.created_wall, tr.created_mono) if tr else None


def tree(trace_id: str) -> Optional[Dict[str, Any]]:
    """The trace as a nested span tree (JSON-ready), or None if
    unknown. Spans whose parent fell off the ring surface as extra
    roots rather than vanishing."""
    with _lock:
        tr = _traces.get(trace_id)
        if tr is None:
            return None
        spans = [sp.to_dict() for sp in tr.spans.values()]
        created_wall, created_mono = tr.created_wall, tr.created_mono
    by_id: Dict[int, Dict[str, Any]] = {}
    for d in spans:
        d["children"] = []
        d["startSeconds"] = round(d["startSeconds"] - created_mono, 6)
        d["durationSeconds"] = round(d["durationSeconds"], 6)
        by_id[d["spanId"]] = d
    roots: List[Dict[str, Any]] = []
    for d in spans:
        parent = by_id.get(d["parentId"]) if d["parentId"] else None
        (parent["children"] if parent else roots).append(d)
    return {"traceId": trace_id, "createdUnixSeconds": created_wall,
            "spanCount": len(spans), "spans": roots}


def durations_by_name(trace_id: str) -> Dict[str, float]:
    """Summed duration (seconds) of finished spans, by span name —
    the attribution source for job metadata
    (``checkpointCommitSeconds``) and bench breakdowns."""
    totals: Dict[str, float] = {}
    for sp in spans_of(trace_id):
        if sp.end is not None:
            totals[sp.name] = totals.get(sp.name, 0.0) + sp.duration
    return {k: round(v, 6) for k, v in totals.items()}


def known_traces() -> List[str]:
    with _lock:
        return list(_traces.keys())


def discard(trace_id: str) -> None:
    with _lock:
        _traces.pop(trace_id, None)


def reset() -> None:
    """Drop all traces and this thread's stack (test isolation)."""
    with _lock:
        _traces.clear()
    _tls.stack = []
