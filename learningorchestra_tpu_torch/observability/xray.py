"""Device-memory attribution ledger of the port (the counterpart of the
JAX package's ``observability/xray.py``, docs/OBSERVABILITY.md "HBM
attribution & X-ray").

The roofline layer says whether a program is compute- or
bandwidth-bound; this module says *where device memory goes*. All
advisory (nothing here may ever raise into or stall the job it
observes):

- a **live ledger**: every allocation site that pins device bytes — the
  engine's train state, the device arena's staged tensors, a serving
  session's params and its KV cache —
  registers owner-tagged byte counts and releases them on drop.
  ``unattributed = bytes_in_use − Σledger`` surfaces temporaries,
  the caching allocator's slack and leaks (the SLO watchdog pages on
  sustained growth). ``bytes_in_use`` is the torch caching allocator's
  ``torch.cuda.memory_allocated`` summed over the cards, with
  ``memory_reserved`` reported beside it; the CPU has no allocator
  count, and the report says so;
- a **synchronization sentinel** (``LO_TRANSFER_GUARD=log``): the train
  step runs under ``torch.cuda.set_sync_debug_mode("warn")`` and each
  synchronizing call it makes is counted (``lo_implicit_transfers_total``)
  and logged. The mode is process-wide and cannot be confined to the
  engine's hot loop, so ``fail`` (raise) is refused at context creation.

No counterpart in the port (ROADMAP Queue 3 "Deliberate"): the
compiled-artifact registry (XLA's ``memory_analysis``/``cost_analysis``;
the port compiles nothing, so ``GET /observability/compile/{name}``
answers 404 as the JAX route does for a job with no capture) and the
retrace sentinel (the counter stays 0).

``LO_XRAY=0`` turns registration into a no-op (releases stay active so a
mid-process flip can never leak ledger entries); the switch is read per
call.
"""

from __future__ import annotations

import collections
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from learningorchestra_tpu_torch.runtime import locks

# canonical owner tags (the JAX label set): "arena" is the device
# arena's resident entries (runtime/arena.py), less the serving sessions'
# pins, which are re-tagged "serving-params"
OWNERS = ("arena", "train-state", "serving-params", "kv-cache",
          "snapshot")

_MAX_EVENTS = 64         # retained transfer events
_MAX_ENTRIES_LISTED = 256  # ledger rows returned per report

_lock = locks.make_lock("xray.ledger")
# (owner, key) -> {"bytes": int, "owner": str, "name": str|None, ...}
_ledger: "collections.OrderedDict[Tuple[str, Any], Dict[str, Any]]" = \
    collections.OrderedDict()
_transfers_total = 0
_transfer_events: "collections.deque" = collections.deque(
    maxlen=_MAX_EVENTS)


def enabled() -> bool:
    """Master switch for ledger registration (``LO_XRAY``, default on),
    read per call."""
    return os.environ.get("LO_XRAY", "1") not in ("0", "false", "no")


# ----------------------------------------------------------------------
# live device-memory ledger
# ----------------------------------------------------------------------
def register(owner: str, key: Any, nbytes: int,
             name: Optional[str] = None, **meta: Any) -> None:
    """Upsert one owner-tagged allocation. ``key`` must be hashable
    and stable until :func:`release` — allocation sites pass the same
    identity they free with (``id(session)`` tuples, the job's name).
    Re-registering a live key replaces its byte count."""
    if not enabled():
        return
    try:
        entry: Dict[str, Any] = {"owner": str(owner),
                                 "bytes": int(nbytes),
                                 "ts": time.time()}
        if name:
            entry["name"] = str(name)
        for k, v in meta.items():
            if isinstance(v, (str, int, float, bool)) or v is None:
                entry[k] = v
        with _lock:
            _ledger[(str(owner), key)] = entry
            _ledger.move_to_end((str(owner), key))
    except Exception:  # noqa: BLE001 — observability is advisory
        pass


def release(owner: str, key: Any) -> None:
    """Drop one ledger entry. Always active (even under ``LO_XRAY=0``)
    so flipping the switch mid-process can never strand bytes in the
    ledger; unknown keys are ignored."""
    try:
        with _lock:
            _ledger.pop((str(owner), key), None)
    except Exception:  # noqa: BLE001
        pass


def by_owner() -> Dict[str, int]:
    """Attributed bytes summed per owner tag. Every known owner is
    present (zero-filled) so the ``lo_hbm_attributed_bytes{owner=}``
    label set stays stable across scrapes — a vanishing series reads
    as a scrape failure on a dashboard, not as a release."""
    with _lock:
        out: Dict[str, int] = {o: 0 for o in OWNERS}
        for entry in _ledger.values():
            out[entry["owner"]] = out.get(entry["owner"], 0) \
                + entry["bytes"]
        return out


def attributed_bytes() -> int:
    with _lock:
        return sum(e["bytes"] for e in _ledger.values())


def device_bytes_in_use() -> Tuple[Optional[int], str]:
    """``(bytes, source)`` for the whole process: the torch caching
    allocator's ``memory_allocated`` summed over every card (source
    ``torchAllocator``), else ``(None, "unavailable")`` — the CPU has no
    allocator count."""
    try:
        import torch

        if not torch.cuda.is_available() or \
                not torch.cuda.is_initialized():
            return None, "unavailable"
        total = sum(int(torch.cuda.memory_allocated(i))
                    for i in range(torch.cuda.device_count()))
        return total, "torchAllocator"
    except Exception:  # noqa: BLE001 — no backend, no number
        return None, "unavailable"


def device_bytes_reserved() -> Optional[int]:
    """The caching allocator's ``memory_reserved`` summed over the
    cards (the card memory the allocator holds, its cached blocks
    included), or None."""
    try:
        import torch

        if not torch.cuda.is_available() or \
                not torch.cuda.is_initialized():
            return None
        return sum(int(torch.cuda.memory_reserved(i))
                   for i in range(torch.cuda.device_count()))
    except Exception:  # noqa: BLE001
        return None


def memory_report(name: Optional[str] = None) -> Dict[str, Any]:
    """The attribution report behind ``GET /observability/memory``:
    per-owner totals, bounded per-entry rows, bytes-in-use vs the
    ledger (``unattributedBytes`` = temporaries, allocator slack, leaks;
    ``bytesReserved`` beside it) and the sentinel counters. With
    ``name``, rows and totals are filtered to entries tagged with that
    job/session/model name (the process-wide unattributed remainder is
    omitted — it is not meaningful for a slice of the ledger)."""
    with _lock:
        rows = [dict(e, key=_key_str(k))
                for (o, k), e in _ledger.items()
                if name is None or e.get("name") == name]
        retraces, transfers = 0, _transfers_total
    rows = rows[-_MAX_ENTRIES_LISTED:]
    # bare report: zero-fill every known owner (stable dashboard
    # columns); a named slice lists only the owners it actually has
    owners: Dict[str, int] = (
        {} if name is not None else {o: 0 for o in OWNERS})
    for e in rows:
        owners[e["owner"]] = owners.get(e["owner"], 0) + e["bytes"]
    attributed = sum(owners.values())
    out: Dict[str, Any] = {
        "enabled": enabled(),
        "owners": owners,
        "attributedBytes": attributed,
        "entries": rows,
        "retracesTotal": retraces,
        "implicitTransfersTotal": transfers,
    }
    if name is not None:
        out["name"] = name
        return out
    # host-resident entries (host=True) attribute real bytes but not
    # DEVICE bytes — they stay out of the in-use subtraction
    device_attr = sum(e["bytes"] for e in rows if not e.get("host"))
    out["attributedDeviceBytes"] = device_attr
    in_use, source = device_bytes_in_use()
    out["bytesInUse"] = in_use
    out["bytesSource"] = source
    out["bytesReserved"] = device_bytes_reserved()
    if in_use is not None:
        out["unattributedBytes"] = max(0, in_use - device_attr)
    else:
        out["bytesNote"] = ("no allocator count on this backend (the "
                            "CPU): only the ledger is known")
    return out


def ring_sample() -> Tuple[Optional[int], Optional[int]]:
    """``(attributedBytes, unattributedBytes)`` for the monitor's
    per-tick rings — the cheap subset of :func:`memory_report` (the
    leak-detector SLO differences the unattributed series)."""
    try:
        with _lock:
            attributed = sum(e["bytes"] for e in _ledger.values())
            device_attr = sum(e["bytes"] for e in _ledger.values()
                              if not e.get("host"))
        in_use, _source = device_bytes_in_use()
        if in_use is None:
            return attributed, None
        return attributed, max(0, in_use - device_attr)
    except Exception:  # noqa: BLE001
        return None, None


def _key_str(key: Any) -> str:
    s = str(key)
    return s if len(s) <= 160 else s[:157] + "..."


# ----------------------------------------------------------------------
# compiled-artifact registry and retrace sentinel: no counterpart
# ----------------------------------------------------------------------
def compile_report(name: str) -> Optional[Dict[str, Any]]:
    """None: the port compiles nothing, so no name has a report (the
    JAX route's answer for a job with no capture)."""
    return None


def known_compiles() -> List[str]:
    return []


# ----------------------------------------------------------------------
# synchronization sentinel
# ----------------------------------------------------------------------
def transfer_guard_mode() -> str:
    """``LO_TRANSFER_GUARD``: "" (off, the default) or ``log``. (A
    context refuses ``fail``: :func:`check_transfer_guard`.)"""
    try:
        from learningorchestra_tpu_torch.observability import get_config

        mode = str(getattr(get_config(), "transfer_guard", "") or "")
    except Exception:  # noqa: BLE001
        mode = os.environ.get("LO_TRANSFER_GUARD", "")
    mode = mode.strip().lower()
    return mode if mode in ("log", "fail") else ""


def check_transfer_guard(config) -> None:
    """Refuses ``LO_TRANSFER_GUARD=fail``: its torch counterpart,
    ``torch.cuda.set_sync_debug_mode("error")``, is process-wide and
    would fail every thread's synchronizing call, not only the
    engine's hot loop."""
    mode = str(getattr(config, "transfer_guard", "") or "").strip().lower()
    if mode == "fail":
        raise ValueError(
            "LO_TRANSFER_GUARD=fail is not yet ported to the PyTorch "
            "package: torch.cuda.set_sync_debug_mode('error') is "
            "process-wide and cannot be confined to the engine's hot "
            "loop (use 'log')")


def guarded_call(fn: Callable, *args: Any,
                 name: Optional[str] = None, **kwargs: Any) -> Any:
    """Run one hot-loop call under the synchronization sentinel.

    Off (the default), or without a card, this is a plain call. Under
    ``log`` the call runs with ``torch.cuda.set_sync_debug_mode("warn")``;
    each synchronizing-operation warning it raises is counted
    (``lo_implicit_transfers_total``) and logged, and the call's result
    stands."""
    if transfer_guard_mode() != "log":
        return fn(*args, **kwargs)
    import torch

    if not torch.cuda.is_available():
        return fn(*args, **kwargs)
    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(previous)
    for w in caught:
        text = str(w.message)
        if "synchroniz" in text:
            note_transfer("sync", text.strip()[:200], name=name)
        else:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)
    return result


def note_transfer(direction: str, signature: str,
                  name: Optional[str] = None) -> None:
    """Count one synchronizing call and keep its signature."""
    global _transfers_total
    try:
        event = {"ts": time.time(), "direction": str(direction),
                 "signature": str(signature), "name": name}
        with _lock:
            _transfers_total += 1
            _transfer_events.append(event)
    except Exception:  # noqa: BLE001
        return
    _emit("implicitTransfer", name or "transfer", **{
        k: v for k, v in event.items() if k not in ("ts", "name")})


def transfer_events() -> List[Dict[str, Any]]:
    with _lock:
        return [dict(e) for e in _transfer_events]


# ----------------------------------------------------------------------
# counters / reset
# ----------------------------------------------------------------------
def counters() -> Dict[str, int]:
    """The sentinel counters behind ``lo_retraces_total`` (always 0: the
    port compiles nothing) and ``lo_implicit_transfers_total``."""
    with _lock:
        return {"retraces": 0, "implicitTransfers": _transfers_total}


def _emit(kind: str, name: str, **fields: Any) -> None:
    try:
        from learningorchestra_tpu_torch.observability import export

        export.log_event(kind, name, **fields)
    except Exception:  # noqa: BLE001
        pass


def reset() -> None:
    """Test/teardown hook: drop the ledger and the counters."""
    global _transfers_total
    with _lock:
        _ledger.clear()
        _transfers_total = 0
        _transfer_events.clear()
