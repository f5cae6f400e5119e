"""Deterministic fault injection (the port's copy of the JAX package's
``services/faults.py``, for the sites the port fires).

``Config.fault_inject`` (env ``LO_FAULT_INJECT``) names injection sites
with a budget, mode and argument — ``site[:count[:mode[:arg]]]``,
comma-separated:

- ``"kv_page_alloc:1"`` — the next paged-KV page allocation raises
  :class:`InjectedFault` (mode ``raise``, the default): the serving
  session answers 429; three consecutive failures (a large count) degrade
  the session to the slot KV path;
- ``"kv_quant:100"`` — every admission into an int8-paged session raises:
  429s, then the session rebuilds over exact pages and weights;
- ``"kv_page_handoff:1"`` — the next publish of a disaggregated
  session's prefill record raises: a 429 with every page reference
  restored; three in a row collapse the session to fused serving;
- ``"sweep_trial:1"`` — the next trial of a ``GridSearch`` or
  ``RandomSearch`` raises at its start: the sweep records the point's
  error and goes on (``trialErrors`` in the tune's metadata);
- ``"kv_page_alloc:3:latency:0.5"`` — three allocations sleep 0.5 s
  (default 0.1) and then proceed.

The port fires ``kv_page_alloc`` (inside :meth:`PagedKVPool.alloc`),
``kv_quant`` (at admission into an int8-paged session),
``kv_page_handoff`` (at the publish of a handoff record) and
``sweep_trial`` (at the start of each sweep trial). The other sites
of the JAX package, and its ``hang``, ``nan`` and ``corrupt`` modes, are
not ported yet: a spec that names them parses and never fires.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from learningorchestra_tpu_torch.runtime import locks

_lock = locks.make_lock("faults.spec")
_used: Dict[str, int] = {}
_parsed: Dict[str, Dict[str, "FaultSpec"]] = {}

_MODES = ("raise", "hang", "latency", "nan", "corrupt")
# modes maybe_inject() fires here
_INJECT_MODES = ("raise", "latency")
_DEFAULT_LATENCY_SECONDS = 0.1


class InjectedFault(IOError):
    pass


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    site: str
    count: int = 1
    mode: str = "raise"
    arg: Optional[float] = None


def reset() -> None:
    """Clear consumed budgets (each test arms its own spec against a
    fresh counter)."""
    with _lock:
        _used.clear()


def parse_spec(spec: str) -> Dict[str, FaultSpec]:
    """``"site[:count[:mode[:arg]]]"`` comma-separated -> ``{site:
    FaultSpec}``. Raises :class:`ValueError` on malformed entries (bad
    count or arg numbers, unknown modes, empty sites), with the JAX
    package's messages."""
    entries: Dict[str, FaultSpec] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) > 4:
            raise ValueError(
                f"bad fault entry {part!r}: want site[:count[:mode[:arg]]]")
        site = fields[0].strip()
        if not site:
            raise ValueError(f"bad fault entry {part!r}: empty site")
        count, mode, arg = 1, "raise", None
        if len(fields) > 1 and fields[1].strip():
            try:
                count = int(fields[1])
            except ValueError:
                raise ValueError(
                    f"bad fault count in {part!r}: {fields[1]!r} is not "
                    f"an integer") from None
        if len(fields) > 2:
            mode = fields[2].strip() or "raise"
            if mode not in _MODES:
                raise ValueError(
                    f"bad fault mode in {part!r}: {mode!r} (one of "
                    f"{_MODES})")
        if len(fields) > 3 and fields[3].strip():
            if mode == "nan":
                raise ValueError(
                    f"bad fault arg in {part!r}: mode 'nan' takes no "
                    f"arg, got {fields[3]!r}")
            try:
                arg = float(fields[3])
            except ValueError:
                raise ValueError(
                    f"bad fault arg in {part!r}: {fields[3]!r} is not a "
                    f"number") from None
            if mode == "corrupt" and (arg != int(arg) or arg <= 0):
                raise ValueError(
                    f"bad fault arg in {part!r}: mode 'corrupt' takes "
                    f"a positive integer byte count, got {fields[3]!r}")
        entries[site] = FaultSpec(site, count, mode, arg)
    return entries


def _consume(site: str, spec: str) -> Optional[FaultSpec]:
    """The armed entry for ``site`` in ``spec`` if its mode fires here
    and budget remains, consuming one firing."""
    if not spec:
        return None
    with _lock:
        parsed = _parsed.get(spec)
        if parsed is None:
            parsed = _parsed[spec] = parse_spec(spec)
    entry = parsed.get(site)
    if entry is None or entry.mode not in _INJECT_MODES:
        return None
    with _lock:
        used = _used.get(site, 0)
        if used >= entry.count:
            return None
        _used[site] = used + 1
    return entry


def maybe_inject(site: str, config) -> None:
    """Fire ``site``'s fault if ``config.fault_inject`` arms it and its
    budget remains: raise :class:`InjectedFault`, or sleep (``latency``).
    ``config`` is read at every call, so a spec set on a live config
    applies from the next call."""
    entry = _consume(site, getattr(config, "fault_inject", "") or "")
    if entry is None:
        return
    if entry.mode == "raise":
        with _lock:
            fired = _used.get(site, 0)
        raise InjectedFault(
            f"injected fault at {site} ({fired}/{entry.count})")
    time.sleep(entry.arg if entry.arg is not None
               else _DEFAULT_LATENCY_SECONDS)
