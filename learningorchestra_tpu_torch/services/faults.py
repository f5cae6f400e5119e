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
- ``"job_run:2"`` — the next two job attempts raise with the card lease
  held: a transient error, so the job retries with backoff;
- ``"job_run:1:hang"`` — the next job attempt blocks (an hour, or
  ``arg`` seconds) like a wedged job, while honouring its cancel token:
  its deadline, a ``DELETE .../run`` or the stall watchdog reclaims it;
- ``"engine_step:1:nan"`` — the next train step's batch is poisoned to
  NaN (its ``x``, else its first floating non-mask array; a batch of
  token ids only is left alone), so the health sentinel's detection
  runs for real;
- ``"ckpt_write:1:corrupt:4"`` — the next checkpoint payload gets its
  last 4 bytes (default 8) flipped after its sha256 was taken, so the
  next restore quarantines it and falls back;
- ``"ckpt_async_commit:1"`` — the next queued commit of an
  asynchronous checkpointer (``LO_CKPT_ASYNC=1``) raises on its worker:
  the error is latched and the fit's next save or barrier raises
  ``AsyncCheckpointError``, failing the job;
- ``"trace_export:1"`` — the next append to the event log
  (``LO_EVENT_LOG``) raises inside the best-effort writer, which
  swallows it: the job it describes never notices;
- ``"serving_step:1000:latency:0.25"`` — the next thousand serving
  worker iterations that find queued work sleep 0.25 s first (the SLO
  watchdog's servingP99 drill);
- ``"kv_page_alloc:3:latency:0.5"`` — three allocations sleep 0.5 s
  (default 0.1) and then proceed.

The port fires ``kv_page_alloc`` (inside :meth:`PagedKVPool.alloc`),
``kv_quant`` (at admission into an int8-paged session),
``kv_page_handoff`` (at the publish of a handoff record),
``sweep_trial`` (at the start of each sweep trial), ``job_run`` (at the
start of each job attempt), ``engine_step`` (at each train step),
``ckpt_write`` (after each payload's checksum), ``ckpt_async_commit``
(at each item of the asynchronous commit queue), ``trace_export`` (at each
event-log append) and ``serving_step`` (at each serving worker iteration
with queued work). ``raise``, ``hang`` and
``latency`` fire in :func:`maybe_inject`; ``nan`` and ``corrupt`` are
data faults whose budgets only :func:`maybe_nan` and
:func:`corrupt_nbytes` spend. A site with no config at hand (the engine,
the checkpointer) reads the one the job manager installed in its thread
(:func:`use_config`), else ``LO_FAULT_INJECT``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, Iterator, Optional

from learningorchestra_tpu_torch.runtime import locks

_lock = locks.make_lock("faults.spec")
_used: Dict[str, int] = {}
_parsed: Dict[str, Dict[str, "FaultSpec"]] = {}

_tls = threading.local()

_MODES = ("raise", "hang", "latency", "nan", "corrupt")
# modes maybe_inject() fires; "nan" and "corrupt" are data faults spent
# by maybe_nan() and corrupt_nbytes() at the sites that poison a batch
# or a written payload
_INJECT_MODES = ("raise", "hang", "latency")
_DEFAULT_HANG_SECONDS = 3600.0
_DEFAULT_LATENCY_SECONDS = 0.1
_DEFAULT_CORRUPT_BYTES = 8


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


@contextlib.contextmanager
def use_config(config) -> Iterator[None]:
    """Makes ``config`` the fault spec of sites that have no config at
    hand, in this thread, for the ``with`` body (the job manager wraps
    each job in it)."""
    previous = getattr(_tls, "config", None)
    _tls.config = config
    try:
        yield
    finally:
        _tls.config = previous


def _spec_text(config) -> str:
    if config is None:
        config = getattr(_tls, "config", None)
    if config is None:
        return os.environ.get("LO_FAULT_INJECT", "")
    return getattr(config, "fault_inject", "") or ""


def _consume(site: str, config, modes) -> Optional[FaultSpec]:
    """The armed entry for ``site`` if its mode is one of ``modes`` and
    budget remains, consuming one firing. The mode is checked before
    the budget, so a ``nan`` entry is never spent by
    :func:`maybe_inject` at the same site, nor the other way round."""
    spec = _spec_text(config)
    if not spec:
        return None
    with _lock:
        parsed = _parsed.get(spec)
        if parsed is None:
            parsed = _parsed[spec] = parse_spec(spec)
    entry = parsed.get(site)
    if entry is None or entry.mode not in modes:
        return None
    with _lock:
        used = _used.get(site, 0)
        if used >= entry.count:
            return None
        _used[site] = used + 1
    return entry


def _cooperative_hang(seconds: float) -> None:
    """Blocks as a wedged job would, but honours the job's cancel token,
    so the deadline, stall and cancel machinery can reclaim it."""
    from learningorchestra_tpu_torch.runtime import preempt

    end = time.monotonic() + seconds
    while time.monotonic() < end:
        preempt.check_cancel()
        time.sleep(0.05)


def maybe_nan(site: str, config=None) -> bool:
    """True when ``site`` carries an armed ``nan`` fault: the caller
    (the engine's train loop) poisons the next batch to NaN."""
    return _consume(site, config, ("nan",)) is not None


def corrupt_nbytes(site: str, config=None) -> int:
    """The byte count to flip when ``site`` carries an armed ``corrupt``
    fault, else 0. The caller (the checkpointer) flips that many bytes
    of the payload it just wrote, after its checksum was taken."""
    entry = _consume(site, config, ("corrupt",))
    if entry is None:
        return 0
    return int(entry.arg) if entry.arg else _DEFAULT_CORRUPT_BYTES


def maybe_inject(site: str, config=None) -> None:
    """Fire ``site``'s fault if ``config.fault_inject`` (or the config
    :func:`use_config` installed) arms it and its budget remains: raise
    :class:`InjectedFault`, hang cooperatively, or sleep (``latency``).
    ``config`` is read at every call, so a spec set on a live config
    applies from the next call."""
    entry = _consume(site, config, _INJECT_MODES)
    if entry is None:
        return
    if entry.mode == "raise":
        with _lock:
            fired = _used.get(site, 0)
        raise InjectedFault(
            f"injected fault at {site} ({fired}/{entry.count})")
    if entry.mode == "hang":
        _cooperative_hang(entry.arg if entry.arg is not None
                          else _DEFAULT_HANG_SECONDS)
    else:
        time.sleep(entry.arg if entry.arg is not None
                   else _DEFAULT_LATENCY_SECONDS)
