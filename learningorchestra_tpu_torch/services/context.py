"""The services' shared state: config, catalog, artifact store, job
manager (with the card's fair lease, which serving sessions share), the
feature cache (``ctx.features``, the host tier every dataset read goes
through), the ``$`` resolver, the serving plane and the observability
plane's live parts — the cluster sampler with its SLO watchdog
(``LO_MONITOR``), the ``torch.profiler`` gate and the incident flight
recorder (``LO_INCIDENTS``), wired as the JAX package's
``services/context.py`` wires them. A context installs its config as the
plane's process-wide one. On the coordinator of a pod of several ranks
it also runs the pod guard (:func:`start_pod_guard`). A mesh the port
cannot run (``LO_MESH_SHAPE`` with ``tp``, ``fsdp``, ``ep`` or ``pp``
above 1) is refused here, at boot."""

from __future__ import annotations

import dataclasses
import importlib
import threading
from typing import Optional

from learningorchestra_tpu_torch import observability as obs
from learningorchestra_tpu_torch.catalog.artifacts import ArtifactStore
from learningorchestra_tpu_torch.catalog.store import Catalog
from learningorchestra_tpu_torch.config import Config, resolve_device
from learningorchestra_tpu_torch.observability import incidents as obs_incidents
from learningorchestra_tpu_torch.observability import xray as obs_xray
from learningorchestra_tpu_torch.runtime import arena as arena_lib
from learningorchestra_tpu_torch.runtime import distributed as dist
from learningorchestra_tpu_torch.runtime import health as health_lib
from learningorchestra_tpu_torch.runtime import mesh as mesh_lib
from learningorchestra_tpu_torch.services.feature_cache import FeatureCache
from learningorchestra_tpu_torch.services.jobs import JobManager
from learningorchestra_tpu_torch.services.params import ParameterResolver
from learningorchestra_tpu_torch.services.serving import ServingManager


class ServiceContext:
    def __init__(self, config: Optional[Config] = None,
                 device: Optional[str] = None):
        config = config or Config()
        if device is not None:
            config = dataclasses.replace(config, device=device)
        mesh_lib.check_spec(config.mesh_shape)
        obs_xray.check_transfer_guard(config)
        self.config = config
        self.device = resolve_device(config.device)
        obs.set_config(config)
        # the engine's FLOP counter is a dispatch mode, whose first use
        # imports torch._dynamo (seconds): a server takes that at start,
        # off its first job
        threading.Thread(target=importlib.import_module,
                         args=("torch._dynamo",), daemon=True,
                         name="lo-warm").start()
        self.catalog = Catalog(config.catalog_path, config.datasets_dir)
        self.artifacts = ArtifactStore(config.artifacts_dir,
                                       device=self.device)
        self.jobs = JobManager.from_config(self.catalog, config)
        # the feature plane's host tier; its device tier is the default
        # arena
        self.features = FeatureCache(self.catalog,
                                     host_bytes=config.param_cache_bytes)
        self.params = ParameterResolver(self)
        self.serving = ServingManager(self)
        # readiness: /healthz answers 503 while this is set (the server's
        # shutdown sets it before the listener stops accepting)
        self._draining = False
        self.monitor = _start_monitor(self)
        # the process's one torch.profiler session, shared between POST
        # /profile and the flight recorder's triggered windows
        self.profiler_gate = obs_incidents.ProfilerGate()
        # after the monitor, so the recorder's collectors resolve
        self.incidents, self._health_listener = _start_incidents(self)
        self._pod_guard = start_pod_guard(self)

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Flip /healthz to 503 so load balancers stop routing here
        before the listener goes away."""
        self._draining = True

    def close(self) -> None:
        self._draining = True
        if self._pod_guard is not None:
            self._pod_guard.set()
        if self.incidents is not None:
            if self._health_listener is not None:
                health_lib.remove_listener(self._health_listener)
            # unhook the process-wide trigger registry only if it still
            # points here (a later context may have replaced it)
            if obs_incidents.get_recorder() is self.incidents:
                obs_incidents.set_recorder(None)
            self.incidents.close()
        if self.monitor is not None:
            self.monitor.stop()
        self.jobs.shutdown()
        self.serving.close()
        self.catalog.close()


def start_pod_guard(ctx: ServiceContext):
    """The coordinator's pod guard: every heartbeat interval it asks
    :func:`.distributed.pod_failure`, and when a worker is lost it gives
    every running card job a terminal ``WorkerLost`` document (their
    threads wait in collectives that cannot complete). Returns the stop
    event, or None where no guard runs (a single process, a follower)."""
    if not (dist.is_initialized() and dist.world_size() > 1
            and dist.is_coordinator()):
        return None
    stop = threading.Event()

    def guard() -> None:
        reported = False
        while not stop.wait(dist.HEARTBEAT_INTERVAL):
            failure = dist.pod_failure()
            if failure and not reported:
                reported = True
                n = ctx.jobs.fail_running_card_jobs(failure)
                print(f"pod guard: {failure} — marked {n} running card "
                      f"job(s) failed", flush=True)
            elif not failure and reported:
                reported = False
                print("pod guard: heartbeats resumed, pod healthy again",
                      flush=True)

    threading.Thread(target=guard, daemon=True,
                     name="lo-pod-guard").start()
    return stop


def _start_monitor(ctx: ServiceContext):
    """The cluster resource sampler and its SLO watchdog; None when
    ``LO_MONITOR=0``. Collectors close over the context's live parts."""
    if not ctx.config.monitor:
        return None
    from learningorchestra_tpu_torch.observability.monitor import \
        ClusterMonitor
    from learningorchestra_tpu_torch.observability.slo import SloWatchdog

    def arena_stats():
        return arena_lib.get_default_arena().stats()

    def serving_stats():
        s = ctx.serving.stats()
        by = s.get("bySession") or []
        fills = [v["batchFill"] for v in by
                 if v.get("batchFill") is not None]
        out = {"queueDepth": sum(int(v.get("queueDepth") or 0)
                                 for v in by),
               "batchFill": (round(sum(fills) / len(fills), 4)
                             if fills else None),
               "sessions": len(by),
               "requestsTotal": s.get("requestsTotal"),
               "rejectedTotal": s.get("rejectedTotal")}
        kv = s.get("kv")
        if kv:
            out["kvPagesFree"] = kv.get("pagesFree")
            out["kvPagesShared"] = kv.get("pagesShared")
            out["kvPrefillsSkipped"] = kv.get("prefillsSkipped")
        return out

    def active_trace():
        name = ctx.jobs.active_job()
        if name:
            return name
        for session in ctx.serving.stats().get("bySession") or []:
            return f"serve/{session.get('model')}"
        return None

    monitor = ClusterMonitor(
        interval_seconds=max(
            0.01, float(ctx.config.monitor_interval_ms) / 1000.0),
        ring=ctx.config.monitor_ring,
        scheduler_stats=ctx.jobs.scheduler_stats,
        serving_stats=serving_stats,
        job_stats=ctx.jobs.queue_stats,
        arena_stats=arena_stats,
        watchdog=SloWatchdog(active_trace=active_trace))
    return monitor.start()


def _start_incidents(ctx: ServiceContext):
    """The incident flight recorder, published to the process-wide
    trigger registry the failure sites call, and the health listener
    that fires ``health:rollback``. ``(None, None)`` when
    ``LO_INCIDENTS=0``."""
    if not ctx.config.incidents:
        return None, None

    def cluster_snapshot():
        return ctx.monitor.snapshot() if ctx.monitor is not None else None

    def alerts_snapshot():
        watchdog = getattr(ctx.monitor, "watchdog", None)
        return watchdog.snapshot() if watchdog is not None else None

    def stats_snapshot():
        return {"jobLifecycle": ctx.jobs.lifecycle_counters(),
                "meshScheduler": ctx.jobs.scheduler_stats(),
                "jobQueue": ctx.jobs.queue_stats(),
                "serving": ctx.serving.stats(),
                "trainingHealth": health_lib.health_stats()}

    def active_names():
        names = []
        job = ctx.jobs.active_job()
        if job:
            names.append(job)
        for session in ctx.serving.stats().get("bySession") or []:
            names.append(f"serve/{session.get('model')}")
        return names

    recorder = obs_incidents.FlightRecorder(
        home=ctx.config.home,
        cluster_snapshot=cluster_snapshot,
        alerts_snapshot=alerts_snapshot,
        stats_snapshot=stats_snapshot,
        active_names=active_names,
        profiler_gate=ctx.profiler_gate)
    obs_incidents.set_recorder(recorder)

    def on_health_event(kind: str, n: int) -> None:
        # a rollback restored a fit's last good checkpoint: the moment
        # the in-memory evidence is about to be overwritten
        if kind == "rollbacks":
            obs_incidents.trigger("health:rollback")

    health_lib.add_listener(on_health_event)
    return recorder, on_health_event
