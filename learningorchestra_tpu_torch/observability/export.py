"""Trace export: Chrome ``trace_event`` JSON + JSONL event log (the
port's copy of the JAX package's ``observability/export.py``).

:func:`chrome_trace` converts a trace's spans into the Chrome
tracing / Perfetto ``trace_event`` format (``ph:"X"`` complete
events, microsecond timestamps) so ``GET /observability/trace/{job}
?format=chrome`` downloads a file that drags straight into
https://ui.perfetto.dev.

:func:`log_event` appends one JSON object per job/serving lifecycle
event to the ``LO_EVENT_LOG`` path, carrying traceIds for offline
correlation. Export is STRICTLY best-effort: every failure (or an
armed ``trace_export`` fault, services/faults.py) is swallowed —
observability must never fail or stall the job it observes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from learningorchestra_tpu_torch.observability import trace as trace_lib
from learningorchestra_tpu_torch.runtime import locks

_log_lock = locks.make_lock("export.log")


def chrome_trace(trace_id: str) -> Optional[Dict[str, Any]]:
    """``{"traceEvents": [...], "displayTimeUnit": "ms"}`` for the
    given trace, or None if unknown. Span threads map to Chrome
    ``tid`` rows; metadata events name them."""
    spans = trace_lib.spans_of(trace_id)
    anchor = trace_lib.anchor_of(trace_id)
    if not spans or anchor is None:
        return None
    _, created_mono = anchor
    tids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
         "args": {"name": f"learningorchestra:{trace_id}"}}]
    now = time.monotonic()
    for sp in spans:
        tid = tids.setdefault(sp.thread, len(tids) + 1)
        args = {k: _jsonable(v) for k, v in sp.attrs.items()}
        args["spanId"] = sp.span_id
        if sp.parent_id:
            args["parentId"] = sp.parent_id
        events.append({
            "ph": "X", "pid": 1, "tid": tid, "name": sp.name,
            "cat": "span",
            "ts": round((sp.start - created_mono) * 1e6, 3),
            "dur": round(((sp.end if sp.end is not None else now)
                          - sp.start) * 1e6, 3),
            "args": args})
    for tname, tid in tids.items():
        events.append({"ph": "M", "pid": 1, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": tname}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def log_event(kind: str, name: str, trace_id: Optional[str] = None,
              **fields: Any) -> None:
    """Append one lifecycle event to the JSONL event log
    (``LO_EVENT_LOG``; empty = off). Bounded: once the file reaches
    ``LO_EVENT_LOG_MAX_BYTES`` it rolls to ``<path>.1`` (keep-1)
    before the append, so the log can never grow past roughly twice
    the bound. Never raises: a failing or slow sink (exercised by the
    ``trace_export`` fault site) must not touch the job's outcome."""
    try:
        from learningorchestra_tpu_torch.observability import get_config

        cfg = get_config()
        path = getattr(cfg, "event_log", "") or ""
        if not path:
            return
        max_bytes = int(getattr(cfg, "event_log_max_bytes", 0) or 0)
        from learningorchestra_tpu_torch.services import faults

        faults.maybe_inject("trace_export", cfg)
        entry: Dict[str, Any] = {
            "ts": round(time.time(), 6), "kind": kind, "name": name}
        if trace_id:
            entry["traceId"] = trace_id
        for k, v in fields.items():
            entry[k] = _jsonable(v)
        line = json.dumps(entry, separators=(",", ":")) + "\n"
        with _log_lock:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            if max_bytes > 0:
                try:
                    if os.path.getsize(path) >= max_bytes:
                        os.replace(path, path + ".1")
                except OSError:
                    pass  # no file yet — nothing to roll
            with open(path, "a", encoding="utf-8") as f:
                f.write(line)
    except Exception:  # noqa: BLE001 — strictly best-effort
        pass


def read_tail(max_bytes: int = 256 << 10) -> str:
    """The last ``max_bytes`` of the event log as COMPLETE lines,
    spliced across the ``.1`` rollover (incident bundles want the
    window straddling a rotation, not just the fresh file). Reads
    under the writer's lock, so it can never observe the torn instant
    between the ``os.replace`` roll and the re-append, and never
    returns a half-written last line. Empty string when the log is
    off or unreadable; never raises."""
    try:
        from learningorchestra_tpu_torch.observability import get_config

        path = getattr(get_config(), "event_log", "") or ""
        if not path:
            return ""
        chunks = []
        with _log_lock:
            for p in (path + ".1", path):
                try:
                    with open(p, "rb") as f:
                        f.seek(0, os.SEEK_END)
                        size = f.tell()
                        f.seek(max(0, size - max_bytes))
                        chunks.append((f.read(max_bytes),
                                       size > max_bytes))
                except OSError:
                    continue
        parts = []
        for data, truncated in chunks:
            text = data.decode("utf-8", "replace")
            if truncated:
                # drop the leading partial line the byte-offset seek
                # landed inside
                nl = text.find("\n")
                text = text[nl + 1:] if nl >= 0 else ""
            parts.append(text)
        merged = "".join(parts)
        if len(merged) > max_bytes:
            merged = merged[-max_bytes:]
            nl = merged.find("\n")
            merged = merged[nl + 1:] if nl >= 0 else ""
        # the writer appends whole lines under the lock, so merged
        # already ends at a line boundary (or is empty)
        return merged
    except Exception:  # noqa: BLE001 — strictly best-effort
        return ""
