"""Incident flight recorder of the port (the JAX package's
``observability/incidents.py``; docs/OBSERVABILITY.md "Incidents &
flight recorder").

Every telemetry store this repo grew — span traces, timeline rings,
cluster-monitor series, SLO alert history, roofline reports, the HBM
X-ray ledger — is a bounded in-memory ring: by the time an operator
investigates a fired page or a dead-lettered job the evidence has
been overwritten. The :class:`FlightRecorder` closes that loop. On a
failure trigger — an SLO alert transitioning to firing (slo.py), a
job dead-lettering / stalling / timing out (services/jobs.py), a
health-sentinel rollback (runtime/health.py) — it freezes the
relevant rings into a durable **debug bundle** committed atomically
under ``home/incidents/<id>/`` (tmp + fsync + rename, the same
discipline the checkpoint layer follows) with a manifest, bounded
retention (``LO_INCIDENT_KEEP``) and a per-trigger cooldown
(``LO_INCIDENT_COOLDOWN_S``) so alert flapping cannot fill the disk.

Trigger sites call the module-level :func:`trigger`, which is cheap
and non-blocking: an enabled + cooldown check and a bounded-queue
enqueue. All evidence collection, disk IO and optional deep
profiling happen on the single ``lo-incidents`` worker thread —
critical because the SLO watchdog fires its trigger while holding
its own (non-reentrant) alert lock, and freezing the alert snapshot
re-takes that lock.

The :class:`ProfilerGate` is the owner of the one ``torch.profiler``
session a process runs (CPU activity, and CUDA activity on a card),
shared between the manual ``POST /profile`` surface and the recorder's
triggered deep-profiling window (``LO_INCIDENT_PROFILE_S``) so the two
can never double-start a trace. A session writes a Chrome trace
(``trace.json``, kernels included) into its directory when it stops; it
also carries the ``LO_PROFILE_MAX_SECONDS`` auto-stop watchdog a
forgotten manual start needs.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import queue
import re
import shutil
import tarfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from learningorchestra_tpu_torch.observability import export as obs_export
from learningorchestra_tpu_torch.observability import hist as obs_hist
from learningorchestra_tpu_torch.observability import perf as obs_perf
from learningorchestra_tpu_torch.observability import timeline as obs_timeline
from learningorchestra_tpu_torch.observability import trace as obs_trace
from learningorchestra_tpu_torch.observability import xray as obs_xray
from learningorchestra_tpu_torch.runtime import locks

# rings whose newest names ride along as implicated evidence even
# when the trigger context names nothing (manual captures)
_KNOWN_TAIL = 8
# hard ceiling on a triggered profiling window, whatever the knob
# says — the capture worker is serial and a runaway window would
# block every later bundle behind it
_PROFILE_CAP_S = 30.0
_EVENT_TAIL_BYTES = 256 << 10

_SLUG_RE = re.compile(r"[^A-Za-z0-9_.-]+")


def _slug(s: str) -> str:
    return _SLUG_RE.sub("-", s).strip("-") or "x"


def _safe(name: str) -> str:
    """Trace names may contain ``/`` (``serve/{model}/{seq}``); map
    them onto one flat filename inside the bundle."""
    return _SLUG_RE.sub("__", name)


def _cfg():
    from learningorchestra_tpu_torch.observability import get_config

    return get_config()


# ----------------------------------------------------------------------
# build info: what exactly was running (versions.json + lo_build_info)
# ----------------------------------------------------------------------
_build_info_lock = locks.make_lock("incidents.buildinfo")
_build_info_cache: Optional[Dict[str, str]] = None


def build_info() -> Dict[str, str]:
    """Pin of the running stack: package version, torch version, the
    CUDA toolkit torch was built with, the backend and the card's name.
    Cached forever — none of it changes within a process — and
    best-effort (a broken backend reports ``unknown`` rather than
    failing /metrics)."""
    global _build_info_cache
    with _build_info_lock:
        if _build_info_cache is not None:
            return dict(_build_info_cache)
    from learningorchestra_tpu_torch import __version__

    info = {"version": __version__, "torchVersion": "unknown",
            "cudaVersion": "unknown", "backend": "unknown",
            "deviceKind": "unknown"}
    try:
        import torch

        info["torchVersion"] = str(torch.__version__)
        info["cudaVersion"] = str(torch.version.cuda or "none")
        if torch.cuda.is_available():
            info["backend"] = "cuda"
            info["deviceKind"] = torch.cuda.get_device_name(0)
        else:
            info["backend"] = "cpu"
            info["deviceKind"] = "cpu"
    except Exception:  # noqa: BLE001 — version pin is best-effort
        pass
    with _build_info_lock:
        _build_info_cache = dict(info)
    return info


# ----------------------------------------------------------------------
# profiler gate
# ----------------------------------------------------------------------
class _Session:
    """One ``torch.profiler`` session on a thread of its own: the
    profiler is entered and left on the same thread whichever request
    thread starts and stops it, and its Chrome trace is written into
    ``trace_dir`` when it stops."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self._started = threading.Event()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lo-profiler")

    def start(self) -> None:
        self._thread.start()
        self._started.wait()
        if self._error is not None:
            self._thread.join()
            raise self._error

    def _run(self) -> None:
        try:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            kwargs = {}
            try:
                # the ops of every thread (the serving workers, the job
                # threads), not only this one's; torch builds without
                # the option record this thread's ops and the card's
                # kernels
                kwargs["experimental_config"] = \
                    torch.profiler._ExperimentalConfig(
                        profile_all_threads=True)
            except (AttributeError, TypeError):
                pass
            prof = torch.profiler.profile(activities=activities, **kwargs)
            prof.__enter__()
        except BaseException as exc:  # noqa: BLE001 — start answers it
            self._error = exc
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(
                os.path.join(self.trace_dir, "trace.json"))
        except BaseException as exc:  # noqa: BLE001 — stop answers it
            self._error = exc

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
        if self._error is not None:
            raise self._error


class ProfilerGate:
    """Owner of the process's one ``torch.profiler`` session.

    Both profiling surfaces go through one gate — manual ``POST
    /profile`` and the recorder's triggered window — so a second start
    never reaches the profiler while a session is live. ``max_seconds``
    arms an auto-stop timer (``LO_PROFILE_MAX_SECONDS``) so a forgotten
    start cannot record unbounded. A profiler that fails to start
    raises out of :meth:`try_start` (the route answers an error)."""

    def __init__(self) -> None:
        self._lock = locks.make_lock("incidents.profiler")
        self._active: Optional[str] = None
        self._session: Optional[_Session] = None
        self._timer: Optional[threading.Timer] = None
        self._last_auto_stop: Optional[Dict[str, Any]] = None

    def active(self) -> Optional[str]:
        with self._lock:
            return self._active

    def last_auto_stop(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._last_auto_stop) \
                if self._last_auto_stop else None

    def try_start(self, trace_dir: str,
                  max_seconds: float = 0.0) -> bool:
        """Start a trace into ``trace_dir``; False when a session is
        already live (caller decides whether that's a 406 or a
        skipped-profile note)."""
        with self._lock:
            if self._active is not None:
                return False
            os.makedirs(trace_dir, exist_ok=True)
            session = _Session(trace_dir)
            session.start()
            self._session = session
            self._active = trace_dir
            if max_seconds and max_seconds > 0:
                self._timer = threading.Timer(
                    max_seconds, self._auto_stop, args=(trace_dir,))
                self._timer.daemon = True
                self._timer.start()
            return True

    def stop(self) -> Optional[str]:
        """Stop the live session; returns its directory, or None when
        idle. The active marker clears even when the profiler's stop
        raises (the raise propagates) — otherwise every later start
        would refuse forever with no session behind it."""
        with self._lock:
            if self._active is None:
                return None
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            trace_dir, session = self._active, self._session
            try:
                session.stop()
            finally:
                self._active = None
                self._session = None
            return trace_dir

    def _auto_stop(self, expected: str) -> None:
        with self._lock:
            if self._active != expected:
                return  # stopped (and maybe restarted) before expiry
            self._timer = None
            try:
                self._session.stop()
            except Exception:  # noqa: BLE001 — watchdog must clear
                pass
            self._active = None
            self._session = None
            self._last_auto_stop = {
                "dir": expected,
                "atUnixSeconds": round(time.time(), 3)}


def prune_dirs(root: str, keep: int) -> int:
    """Bounded on-disk retention: delete the oldest non-hidden
    subdirectories of ``root`` beyond the ``keep`` newest. Both
    profile and incident ids lead with a UTC timestamp, so
    lexicographic name order IS age order. Returns how many were
    removed; never raises."""
    if keep <= 0 or not os.path.isdir(root):
        return 0
    try:
        entries = sorted(
            e for e in os.listdir(root)
            if not e.startswith(".")
            and os.path.isdir(os.path.join(root, e)))
    except OSError:
        return 0
    removed = 0
    for name in entries[:-keep] if len(entries) > keep else []:
        try:
            shutil.rmtree(os.path.join(root, name))
            removed += 1
        except OSError:
            pass
    return removed


# ----------------------------------------------------------------------
# flight recorder
# ----------------------------------------------------------------------
class FlightRecorder:
    """Captures debug bundles under ``<home>/incidents/<id>/``.

    Collectors that need live service objects (cluster monitor rings,
    watchdog alert state, job/serving/health counters, implicated
    names) are injected as callables, mirroring ClusterMonitor; the
    module-level registries (trace/timeline/xray/perf/hist/export)
    are read directly. Every section is individually best-effort: a
    failing collector becomes an ``errors`` entry in the manifest,
    never a lost bundle."""

    def __init__(self, home: str,
                 cluster_snapshot: Optional[Callable[[], Any]] = None,
                 alerts_snapshot: Optional[Callable[[], Any]] = None,
                 stats_snapshot: Optional[Callable[[], Any]] = None,
                 active_names: Optional[
                     Callable[[], List[str]]] = None,
                 profiler_gate: Optional[ProfilerGate] = None):
        self.root = os.path.join(home, "incidents")
        self._cluster = cluster_snapshot
        self._alerts = alerts_snapshot
        self._stats = stats_snapshot
        self._active_names = active_names
        self._gate = profiler_gate or get_profiler_gate()
        self._lock = locks.make_lock("incidents.queue")        # cooldown + counters
        self._commit_lock = locks.make_lock("incidents.commit")  # one bundle at a time
        self._last: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._dropped = 0
        self._errors = 0
        self._seq = 0
        self._queue: "queue.Queue" = queue.Queue(maxsize=16)
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._drain, daemon=True, name="lo-incidents")
        self._worker.start()

    # -- trigger side (cheap, callable under foreign locks) -----------

    def trigger(self, trigger: str, **context: Any) -> bool:
        """Non-blocking: enabled + per-trigger cooldown check, then a
        bounded enqueue. True = a capture was scheduled. Safe to call
        while holding any caller lock — no evidence is touched here."""
        cfg = _cfg()
        if not getattr(cfg, "incidents", True):
            return False
        now = time.time()
        cooldown = max(0.0, float(
            getattr(cfg, "incident_cooldown_s", 0.0) or 0.0))
        with self._lock:
            last = self._last.get(trigger)
            if last is not None and now - last < cooldown:
                return False
            # stamp at ENQUEUE so a storm is muted even while the
            # first capture is still being written
            self._last[trigger] = now
        try:
            self._queue.put_nowait((trigger, dict(context), now))
        except queue.Full:
            with self._lock:
                self._dropped += 1
            return False
        return True

    def capture(self, trigger: str = "manual",
                context: Optional[Dict[str, Any]] = None,
                ) -> Dict[str, Any]:
        """Synchronous on-demand capture (``POST
        /observability/incidents``). Bypasses the cooldown; serialized
        against auto captures by the commit lock."""
        return self._capture(trigger, dict(context or {}), time.time())

    def close(self) -> None:
        self._stop.set()
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        self._worker.join(timeout=10.0)

    def _drain(self) -> None:
        while True:
            try:
                item = self._queue.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:
                return
            trigger, context, ts = item
            try:
                self._capture(trigger, context, ts)
            except Exception:  # noqa: BLE001 — recorder never crashes
                with self._lock:
                    self._errors += 1
                traceback.print_exc()

    # -- capture ------------------------------------------------------

    def _capture(self, trigger: str, context: Dict[str, Any],
                 ts: float) -> Dict[str, Any]:
        with self._commit_lock:
            cfg = _cfg()
            with self._lock:
                self._seq += 1
                seq = self._seq
            iid = (f"{time.strftime('%Y%m%d-%H%M%S', time.gmtime(ts))}"
                   f"-{seq:04d}-{_slug(trigger)}")
            tmp = os.path.join(self.root, f".tmp-{iid}")
            final = os.path.join(self.root, iid)
            os.makedirs(tmp, exist_ok=True)
            files: Dict[str, int] = {}
            errors: Dict[str, str] = {}
            notes: Dict[str, Any] = {}

            def write(rel: str, data: bytes) -> None:
                path = os.path.join(tmp, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                files[rel] = len(data)

            def write_json(rel: str, doc: Any) -> None:
                write(rel, json.dumps(
                    doc, indent=1, sort_keys=True,
                    default=str).encode())

            def section(rel: str, collect: Callable[[], Any]) -> None:
                try:
                    doc = collect()
                    if doc is not None:
                        write_json(rel, doc)
                except Exception as exc:  # noqa: BLE001
                    errors[rel] = repr(exc)

            names = self._implicated(context)
            # per-name ring freezes: span trees and step timelines for
            # everything implicated (the port has no compiled-artifact
            # reports, so no compile/ files)
            for name in names["traces"]:
                section(f"trace/{_safe(name)}.json",
                        lambda n=name: obs_trace.tree(n))
            for name in names["jobs"]:
                def _timeline(n=name):
                    summary = obs_timeline.summary(n)
                    if summary is None:
                        return None
                    return {"job": n, "summary": summary,
                            "timeline": obs_timeline.entries(n)}
                section(f"timeline/{_safe(name)}.json", _timeline)
            for name in names["compiles"]:
                section(f"compile/{_safe(name)}.json",
                        lambda n=name: obs_xray.compile_report(n))
            section("cluster.json",
                    self._cluster if self._cluster else lambda: None)
            section("alerts.json",
                    self._alerts if self._alerts else lambda: None)
            section("memory.json", lambda: obs_xray.memory_report())
            section("perf.json", lambda: {
                "platform": obs_perf.platform_summary(),
                "jobs": obs_perf.latest()})

            def _metrics():
                doc = {"latencyHistograms": obs_hist.snapshot_all()}
                if self._stats is not None:
                    doc.update(self._stats() or {})
                return doc
            section("metrics.json", _metrics)
            try:
                write("eventlog.tail", obs_export.read_tail(
                    _EVENT_TAIL_BYTES).encode())
            except Exception as exc:  # noqa: BLE001
                errors["eventlog.tail"] = repr(exc)
            section("config.json",
                    lambda: dataclasses.asdict(cfg))
            section("versions.json", build_info)

            self._maybe_profile(cfg, trigger, context, tmp,
                                files, errors, notes)

            manifest = {
                "id": iid,
                "trigger": trigger,
                "context": {k: _jsonable(v)
                            for k, v in context.items()},
                "createdUnixSeconds": round(ts, 3),
                "implicated": names,
                "files": files,
                "totalBytes": sum(files.values()),
                "errors": errors,
                "notes": notes,
                "buildInfo": build_info(),
                "schema": 1,
            }
            write("manifest.json", json.dumps(
                manifest, indent=1, sort_keys=True,
                default=str).encode())
            # atomic publish: readers list only non-hidden dirs, so a
            # half-written bundle is never visible
            os.rename(tmp, final)
            with self._lock:
                self._counts[trigger] = \
                    self._counts.get(trigger, 0) + 1
            prune_dirs(self.root, int(
                getattr(cfg, "incident_keep", 0) or 0))
            obs_export.log_event("incident", "captured", trace_id=iid,
                                 trigger=trigger,
                                 totalBytes=manifest["totalBytes"])
            return manifest

    def _implicated(self, context: Dict[str, Any],
                    ) -> Dict[str, List[str]]:
        """Which ring names ride into the bundle: anything the trigger
        context points at, whatever is live right now, plus a bounded
        tail of each registry so a manual capture is never empty."""
        named: List[str] = []
        for key in ("job", "model", "trace", "name"):
            value = context.get(key)
            if isinstance(value, str) and value:
                named.append(value)
        if self._active_names is not None:
            try:
                named.extend(n for n in (self._active_names() or [])
                             if isinstance(n, str))
            except Exception:  # noqa: BLE001
                pass

        def merge(tail: List[str]) -> List[str]:
            out: List[str] = []
            for n in named + list(tail)[-_KNOWN_TAIL:]:
                if n not in out:
                    out.append(n)
            return out

        def known(fn) -> List[str]:
            try:
                return list(fn() or [])
            except Exception:  # noqa: BLE001
                return []

        return {"traces": merge(known(obs_trace.known_traces)),
                "jobs": merge(known(obs_timeline.known_jobs)),
                "compiles": merge(known(obs_xray.known_compiles))}

    def _maybe_profile(self, cfg, trigger: str,
                       context: Dict[str, Any], tmp: str,
                       files: Dict[str, int], errors: Dict[str, str],
                       notes: Dict[str, Any]) -> None:
        """Triggered deep profiling: a bounded ``torch.profiler`` window
        into the bundle, only for serving-latency pages (or a manual
        capture explicitly asking), and only when the gate is free —
        a live manual /profile session wins and the skip is noted."""
        window = float(getattr(cfg, "incident_profile_s", 0) or 0)
        wanted = trigger == "slo:servingP99" or bool(
            context.get("profile"))
        if window <= 0 or not wanted:
            return
        pdir = os.path.join(tmp, "profile")
        try:
            if not self._gate.try_start(pdir):
                notes["profileSkipped"] = \
                    "profiler busy (another session active)"
                return
            try:
                time.sleep(min(window, _PROFILE_CAP_S))
            finally:
                self._gate.stop()
        except Exception as exc:  # noqa: BLE001
            errors["profile"] = repr(exc)
            return
        total = 0
        for dirpath, _dirs, fnames in os.walk(pdir):
            for fname in fnames:
                rel = os.path.relpath(
                    os.path.join(dirpath, fname), tmp)
                try:
                    files[rel] = os.path.getsize(
                        os.path.join(dirpath, fname))
                    total += files[rel]
                except OSError:
                    pass
        notes["profileSeconds"] = min(window, _PROFILE_CAP_S)
        notes["profileBytes"] = total

    # -- read side ----------------------------------------------------

    def _ids(self) -> List[str]:
        try:
            return sorted(
                e for e in os.listdir(self.root)
                if not e.startswith(".")
                and os.path.isdir(os.path.join(self.root, e)))
        except OSError:
            return []

    def list(self) -> List[Dict[str, Any]]:
        out = []
        for iid in self._ids():
            doc = self.manifest(iid)
            if doc is None:
                continue
            out.append({"id": iid, "trigger": doc.get("trigger"),
                        "createdUnixSeconds":
                            doc.get("createdUnixSeconds"),
                        "totalBytes": doc.get("totalBytes"),
                        "files": len(doc.get("files") or {})})
        return out

    def manifest(self, iid: str) -> Optional[Dict[str, Any]]:
        if not iid or "/" in iid or iid.startswith("."):
            return None
        path = os.path.join(self.root, iid, "manifest.json")
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def tar_bytes(self, iid: str) -> Optional[bytes]:
        """The whole bundle as an uncompressed tar stream (bundles are
        retention-bounded, so in-memory assembly is fine)."""
        if self.manifest(iid) is None:
            return None
        bundle = os.path.join(self.root, iid)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            tar.add(bundle, arcname=iid)
        return buf.getvalue()

    def total_bytes(self) -> int:
        total = 0
        for iid in self._ids():
            for dirpath, _dirs, fnames in os.walk(
                    os.path.join(self.root, iid)):
                for fname in fnames:
                    try:
                        total += os.path.getsize(
                            os.path.join(dirpath, fname))
                    except OSError:
                        pass
        return total

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            by_trigger = dict(self._counts)
            dropped, errs = self._dropped, self._errors
        return {"captured": sum(by_trigger.values()),
                "byTrigger": by_trigger,
                "dropped": dropped,
                "captureErrors": errs,
                "bundles": len(self._ids()),
                "bytes": self.total_bytes()}


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


# ----------------------------------------------------------------------
# process-wide registry: trigger sites (slo.py, jobs.py, the health
# listener) reach the live recorder without holding a context ref
# ----------------------------------------------------------------------
_registry_lock = locks.make_lock("incidents.registry")
_recorder: Optional[FlightRecorder] = None
_profiler_gate: Optional[ProfilerGate] = None


def get_profiler_gate() -> ProfilerGate:
    global _profiler_gate
    with _registry_lock:
        if _profiler_gate is None:
            _profiler_gate = ProfilerGate()
        return _profiler_gate


def set_recorder(recorder: Optional[FlightRecorder]) -> None:
    global _recorder
    with _registry_lock:
        _recorder = recorder


def get_recorder() -> Optional[FlightRecorder]:
    with _registry_lock:
        return _recorder


def trigger(name: str, **context: Any) -> bool:
    """Best-effort forward to the live recorder (no-op when none).
    Cheap and exception-free by contract: trigger sites call this
    from failure paths and alert transitions, where a crashing
    recorder would be worse than no recorder."""
    recorder = get_recorder()
    if recorder is None:
        return False
    try:
        return recorder.trigger(name, **context)
    except Exception:  # noqa: BLE001
        return False
