"""The REST plane of the port: the pipeline and serving routes of the
JAX package's server, with the same status codes and bodies.

====== ========================================= =======================
verb   path (under /api/learningOrchestra/v1)    handler
====== ========================================= =======================
POST   /dataset/{csv,generic}                    ingest (201 + URI)
POST   /model/{tool}                             build a model (201)
POST   /{train,tune,evaluate,predict}/{tool}     run a method (201)
POST   /explore/histogram                        value counts (201)
POST   /explore/{tool}                           reflection + PNG (201)
POST   /transform/projection                     column select (201)
POST   /transform/dataType                       in-place cast (200)
POST   /transform/{tool}                         reflection (201)
POST   /function/python                          run user code (201)
POST   /builder/sparkml                          train, compare, predict
                                                 (201 + one URI a
                                                 classifier)
PATCH  /{model,train,...,explore,transform,      re-run (200)
        function}/{tool}/{name}
DELETE /{service}/{tool}/{name}                  delete (200)
DELETE /{service}/{tool}/{name}/run              cancel the job (200)
GET    /{service}/{tool}                         list collections
GET    /{service}/{tool}/{name}?skip&limit&query paged read (an explore
                                                 plot without paging:
                                                 image/png)
GET    /observe                                  the newest change seq
GET    /observe/{name}?seq&timeout               long-poll change feed
POST   /serve/{model}                            create a session (201)
POST   /serve/{model}/predict                    synchronous inference
GET    /serve, /serve/{model}                    stats
DELETE /serve/{model}                            teardown
GET    /observability/trace[/{name}]             span tree (?format=chrome)
GET    /observability/timeline[/{name}]          per-epoch train telemetry
GET    /observability/perf[/{name}]              roofline report
GET    /observability/memory[/{name}]            device-memory ledger
GET    /observability/compile[/{name}]           compiled-artifact X-ray
                                                 (none: 404 for a name)
GET    /observability/cluster                    resource-sampler rings
GET    /observability/alerts                     SLO objectives + alerts
GET    /observability/incidents[/{id}[/download]] debug bundles
POST   /observability/incidents                  manual capture (201)
POST   /profile {action: start|stop}             torch.profiler trace
GET    /profile                                  profiler status + traces
====== ========================================= =======================

Outside the prefix: ``GET /metrics`` (JSON, or Prometheus text with
``?format=prometheus``), ``GET /health`` (liveness, ``deviceCount`` and
``devicePlatform`` from torch) and ``GET /healthz`` (503 while draining
or while a page-severity SLO alert fires).

A 406 of the submit-time lint carries its findings under ``analysis``.
Listings and paged reads are cached (:class:`~learningorchestra_tpu_torch.
services.cache.ReadCache`, ``LO_GET_CACHE_TTL``) against the catalog's
change seq and the rows' file stamp, so a poller never sees a stale
``finished``. With ``LO_REQUEST_TIMEOUT`` the gateway answers 504 to a
request past its deadline while the dispatch goes on, and 503 at once
when ``LO_GATEWAY_MAX_INFLIGHT`` timed dispatches are in flight. At
start, :meth:`Api.recover_unfinished` requeues the unfinished executions
and functions and gives every other unfinished job a typed failure.
``DELETE .../{name}/run`` cancels (404 unknown, 406 nothing to cancel).
A builder's outputs are read, listed and deleted as datasets are.
``POST .../{name}/migrate`` answers 406 "not yet ported", and
``/observability/autoscaler`` 404 until the autoscaler is ported.
``/metrics`` leaves out the blocks of modules not ported yet (the JAX
server's ``migrationStats``, ``autoscaler`` and ``executableCache``)
rather than faking them; ``meshScheduler`` and ``meshSecondsByPool`` are
the card lease's (:meth:`~learningorchestra_tpu_torch.services.jobs.
JobManager.scheduler_stats`, the ``lo_mesh_*`` and ``lo_slice_*``
series);
``sweepFusion`` is the process's sweep fusion counters
(:func:`~learningorchestra_tpu_torch.models.sweep.fusion_stats`, the
``lo_sweep_*`` series), ``featureCache`` the context's feature cache and
``arena`` the default device arena (the ``lo_feature_cache_*`` and
``lo_arena_*`` series).
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.config import API_PREFIX
from learningorchestra_tpu_torch.observability import export as obs_export
from learningorchestra_tpu_torch.observability import hist as obs_hist
from learningorchestra_tpu_torch.observability import incidents as obs_incidents
from learningorchestra_tpu_torch.observability import perf as obs_perf
from learningorchestra_tpu_torch.observability import timeline as obs_timeline
from learningorchestra_tpu_torch.observability import trace as obs_trace
from learningorchestra_tpu_torch.observability import xray as obs_xray
from learningorchestra_tpu_torch.runtime import arena as arena_lib
from learningorchestra_tpu_torch.runtime import health as health_lib
from learningorchestra_tpu_torch.runtime import locks
from learningorchestra_tpu_torch.services import function_service as fsvc
from learningorchestra_tpu_torch.services import validators as V
from learningorchestra_tpu_torch.services.builder_service import \
    BuilderService
from learningorchestra_tpu_torch.services.cache import ReadCache
from learningorchestra_tpu_torch.services.columnar import (
    DataTypeService,
    HistogramService,
    ProjectionService,
)
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.database_executor import \
    DatabaseExecutorService
from learningorchestra_tpu_torch.services.dataset import (
    DatasetService,
    parse_query_param,
)
from learningorchestra_tpu_torch.services.execution import ExecutionService
from learningorchestra_tpu_torch.services.model_service import ModelService

_JSON = "application/json"
SERVICES = ("dataset", "model", "transform", "explore", "tune", "train",
            "evaluate", "predict", "function", "builder")
EXECUTION_VERBS = ("train", "tune", "evaluate", "predict")
# the longest long-poll of GET /observe/{name}, seconds
OBSERVE_MAX_SECONDS = 120.0
_PROMETHEUS = "text/plain; version=0.0.4; charset=utf-8"


def escape_label_value(v: Any) -> str:
    """Prometheus exposition-format label-value escaping: backslash
    first (or the escapes introduced for ``"`` and newline would
    themselves be doubled), then the double quote, then line feeds."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


class Api:
    """Transport-independent dispatch (testable without sockets)."""

    def __init__(self, context: Optional[ServiceContext] = None,
                 device: Optional[str] = None):
        self.ctx = context or ServiceContext(device=device)
        self.dataset = DatasetService(self.ctx)
        self.model = ModelService(self.ctx)
        self.execution = ExecutionService(self.ctx)
        self.function = fsvc.FunctionService(self.ctx)
        self.builder = BuilderService(self.ctx)
        self.dbexec = DatabaseExecutorService(self.ctx)
        self.histogram = HistogramService(self.ctx)
        self.projection = ProjectionService(self.ctx)
        self.datatype = DataTypeService(self.ctx)
        self.read_cache = ReadCache(
            ttl_seconds=self.ctx.config.get_cache_ttl_seconds)
        # timed dispatches (the gateway in _Handler._respond): in flight,
        # abandoned after their 504, refused at the cap
        self.gateway_lock = locks.make_lock("server.gateway")
        self.gateway = {"inflight": 0, "abandonedInflight": 0,
                        "abandonedTotal": 0, "saturatedTotal": 0}
        # request counters behind /metrics
        self._metrics_lock = locks.make_lock("server.metrics")
        self._started = time.monotonic()
        self._requests: Dict[str, int] = {}
        self._statuses: Dict[str, int] = {}
        self._latency_sum = 0.0
        self._latency_count = 0
        self.recovered = self.recover_unfinished()

    # ------------------------------------------------------------------
    def recover_unfinished(self) -> Dict[str, list]:
        """Boot-time job durability: an unfinished execution or function
        stored its whole request in its metadata and is requeued (a
        checkpointed fit resumes from its newest step; its timeout and
        healthPolicy come along); every other unfinished job (an ingest,
        an explore or transform step, a model build) gets a typed
        ``InterruptedError`` document, so no client polls a flag that
        never flips. A job whose last document is an exception ended in
        failure and stays as it is, unless a shutdown dropped it
        (``shutdownAborted``): it never ran, so it is requeued."""
        requeued, failed = [], []
        catalog = self.ctx.catalog
        for meta in catalog.list_collections():
            if meta.get(D.FINISHED_FIELD):
                continue
            name = meta.get(D.NAME_FIELD)
            type_string = str(meta.get(D.TYPE_FIELD, ""))
            verb = type_string.split("/")[0]
            is_execution = verb in EXECUTION_VERBS and \
                meta.get(D.METHOD_FIELD) is not None
            is_function = verb == "function" and \
                meta.get(D.FUNCTION_FIELD) is not None
            docs = catalog.get_documents(name)
            if docs and docs[-1].get(D.EXCEPTION_FIELD) and not (
                    docs[-1].get("shutdownAborted")
                    and (is_execution or is_function)):
                continue
            try:
                if is_execution:
                    self.execution._submit(
                        name, type_string, meta[D.PARENT_NAME_FIELD],
                        meta[D.METHOD_FIELD],
                        meta.get(D.METHOD_PARAMETERS_FIELD) or {},
                        meta.get(D.DESCRIPTION_FIELD, ""),
                        timeout=meta.get(V.TIMEOUT_FIELD),
                        health_policy=meta.get(V.HEALTH_POLICY_FIELD))
                    requeued.append(name)
                elif is_function:
                    # the granted mode, under the current ceiling
                    mode = fsvc.resolve_sandbox_mode(
                        self.ctx.config, meta.get(fsvc.SANDBOX_MODE_FIELD))
                    self.function._submit(
                        name, type_string, meta[D.FUNCTION_FIELD],
                        meta.get(D.FUNCTION_PARAMETERS_FIELD) or {},
                        meta.get(D.DESCRIPTION_FIELD, ""), mode,
                        timeout=meta.get(V.TIMEOUT_FIELD))
                    requeued.append(name)
                else:
                    catalog.append_document(name, D.execution_document(
                        meta.get(D.DESCRIPTION_FIELD, ""), None,
                        exception="InterruptedError('job was in flight "
                                  "when the server stopped; resubmit "
                                  "it')"))
                    failed.append(name)
            except Exception as exc:  # noqa: BLE001 — boot must finish
                catalog.append_document(name, D.execution_document(
                    meta.get(D.DESCRIPTION_FIELD, ""), None,
                    exception=f"requeue-on-boot failed: {exc!r}"))
                failed.append(name)
        return {"requeued": requeued, "failed": failed}

    def dispatch(self, method: str, path: str, params: Dict[str, Any],
                 body: Optional[Dict[str, Any]],
                 record: bool = True) -> Tuple[int, Any, str]:
        """Returns (status, payload, content_type). ``record=False`` lets
        a deadline-bound caller own the metrics record (a timed-out
        request counts once, with the 504 the client saw)."""
        t0 = time.monotonic()
        try:
            out = self._route(method, path, params, body)
        except V.HttpError as e:
            payload = {"result": e.message}
            if e.findings:
                payload["analysis"] = e.findings
            out = e.status, payload, _JSON
        except Exception as e:  # noqa: BLE001 — the server must keep answering
            out = 500, {"result": f"internal error: {e!r}"}, _JSON
        if record:
            self.record_metrics(method, path, out[0], time.monotonic() - t0)
        return out

    def record_metrics(self, method: str, path: str, status: int,
                       seconds: float) -> None:
        parts = [p for p in path[len(API_PREFIX):].split("/") if p] \
            if path.startswith(API_PREFIX + "/") else []
        service = parts[0] if parts else \
            path.lstrip("/").split("/")[0] or "root"
        with self._metrics_lock:
            key = f"{method} {service}"
            self._requests[key] = self._requests.get(key, 0) + 1
            self._statuses[str(status)] = \
                self._statuses.get(str(status), 0) + 1
            self._latency_sum += seconds
            self._latency_count += 1
        obs_hist.observe("lo_dispatch_seconds", seconds)

    # ------------------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """The ``/metrics`` JSON document: the JAX server's keys, less
        the blocks of modules not ported yet."""
        with self._metrics_lock:
            n = self._latency_count
            out: Dict[str, Any] = {
                "uptimeSeconds": round(time.monotonic() - self._started, 3),
                "requestsTotal": n,
                "requestsByRoute": dict(sorted(self._requests.items())),
                "responsesByStatus": dict(sorted(self._statuses.items())),
                "meanDispatchSeconds": round(
                    self._latency_sum / n, 6) if n else None,
                "dispatchSecondsSum": round(self._latency_sum, 6),
            }
        out["jobsRunning"] = self.ctx.jobs.running()
        out["collections"] = len(self.ctx.catalog.list_collections())
        out["getCache"] = self.read_cache.stats()
        out["meshSecondsByPool"] = {
            pool: round(seconds, 3) for pool, seconds in
            sorted(self.ctx.jobs.mesh_served().items())}
        out["jobLifecycle"] = self.ctx.jobs.lifecycle_counters()
        out["meshScheduler"] = self.ctx.jobs.scheduler_stats()
        out["trainingHealth"] = health_lib.health_stats()
        out["serving"] = self.ctx.serving.stats()
        # the feature plane's two tiers
        out["featureCache"] = self.ctx.features.stats()
        out["arena"] = arena_lib.get_default_arena().stats()
        from learningorchestra_tpu_torch.models import sweep as sweep_lib
        out["sweepFusion"] = sweep_lib.fusion_stats()
        out["latencyHistograms"] = obs_hist.snapshot_all()
        with self.gateway_lock:
            out["gateway"] = dict(
                self.gateway,
                maxInflight=self.ctx.config.gateway_max_inflight)
        out["perf"] = {"platform": obs_perf.platform_summary(),
                       "jobs": obs_perf.latest()}
        out["xray"] = {"enabled": obs_xray.enabled(),
                       "owners": obs_xray.by_owner(),
                       "attributedBytes": obs_xray.attributed_bytes(),
                       "counters": obs_xray.counters()}
        monitor = self.ctx.monitor
        if monitor is not None:
            out["cluster"] = monitor.latest()
            if monitor.watchdog is not None:
                out["alerts"] = monitor.watchdog.firing()
                out["alertsFiring"] = len(out["alerts"])
        if self.ctx.incidents is not None:
            out["incidents"] = self.ctx.incidents.stats()
        return out

    def metrics_prometheus(self) -> bytes:
        """Prometheus text exposition of :meth:`metrics`: the JAX
        server's series, less those of modules not ported yet."""
        m = self.metrics()
        esc = escape_label_value
        info = obs_incidents.build_info()
        lines = [
            "# TYPE lo_build_info gauge",
            f'lo_build_info{{version="{esc(info["version"])}"'
            f',torch_version="{esc(info["torchVersion"])}"'
            f',cuda_version="{esc(info["cudaVersion"])}"'
            f',backend="{esc(info["backend"])}"'
            f',device_kind="{esc(info["deviceKind"])}"}} 1',
            "# TYPE lo_uptime_seconds gauge",
            f"lo_uptime_seconds {m['uptimeSeconds']}",
            "# TYPE lo_requests_total counter",
        ]
        for route, n in m["requestsByRoute"].items():
            lines.append(f'lo_requests_total{{route="{esc(route)}"}} {n}')
        lines.append("# TYPE lo_responses_total counter")
        for status, n in m["responsesByStatus"].items():
            lines.append(
                f'lo_responses_total{{status="{esc(status)}"}} {n}')
        cache = m["getCache"]
        lifecycle = m["jobLifecycle"]
        health = m["trainingHealth"]
        lines += [
            "# TYPE lo_jobs_running gauge",
            f"lo_jobs_running {m['jobsRunning']}",
            "# TYPE lo_collections gauge",
            f"lo_collections {m['collections']}",
            "# TYPE lo_mesh_seconds_total counter",
        ]
        for pool, seconds in m["meshSecondsByPool"].items():
            lines.append(
                f'lo_mesh_seconds_total{{pool="{esc(pool)}"}} {seconds}')
        lines += [
            "# TYPE lo_get_cache_hits_total counter",
            f"lo_get_cache_hits_total {cache['hits']}",
            "# TYPE lo_get_cache_misses_total counter",
            f"lo_get_cache_misses_total {cache['misses']}",
            "# TYPE lo_get_cache_entries gauge",
            f"lo_get_cache_entries {cache['entries']}",
            "# TYPE lo_job_retries_total counter",
            f"lo_job_retries_total {lifecycle.get('retries', 0)}",
            "# TYPE lo_jobs_cancelled_total counter",
            f"lo_jobs_cancelled_total {lifecycle.get('cancelled', 0)}",
            "# TYPE lo_jobs_timed_out_total counter",
            f"lo_jobs_timed_out_total {lifecycle.get('timedOut', 0)}",
            "# TYPE lo_jobs_stalled gauge",
            f"lo_jobs_stalled {lifecycle.get('stalled', 0)}",
        ]
        scheduler = m["meshScheduler"]
        lines += [
            "# TYPE lo_lease_wait_seconds_max gauge",
            f"lo_lease_wait_seconds_max "
            f"{scheduler.get('leaseWaitMax', 0.0)}",
            "# TYPE lo_mesh_devices_busy gauge",
            f"lo_mesh_devices_busy {scheduler.get('devicesBusy', 0)}",
            "# TYPE lo_slice_grants_total counter",
        ]
        for pool, n in sorted(
                (scheduler.get("grantsByPool") or {}).items()):
            lines.append(
                f'lo_slice_grants_total{{pool="{esc(pool)}"}} {n}')
        lines += [
            "# TYPE lo_job_numerical_retries_total counter",
            f"lo_job_numerical_retries_total "
            f"{lifecycle.get('numericalRetries', 0)}",
            "# TYPE lo_nonfinite_steps_total counter",
            f"lo_nonfinite_steps_total {health.get('nonfiniteSteps', 0)}",
            "# TYPE lo_rollbacks_total counter",
            f"lo_rollbacks_total {health.get('rollbacks', 0)}",
            "# TYPE lo_loss_spikes_total counter",
            f"lo_loss_spikes_total {health.get('lossSpikes', 0)}",
            "# TYPE lo_checkpoints_quarantined_total counter",
            f"lo_checkpoints_quarantined_total "
            f"{health.get('quarantined', 0)}",
            "# TYPE lo_serving_drift_breaches_total counter",
            f"lo_serving_drift_breaches_total "
            f"{health.get('driftBreaches', 0)}",
            "# TYPE lo_serving_quant_degrades_total counter",
            f"lo_serving_quant_degrades_total "
            f"{health.get('quantDegrades', 0)}",
        ]
        feature, arena = m["featureCache"], m["arena"]
        lines += [
            "# TYPE lo_feature_cache_hits_total counter",
            f"lo_feature_cache_hits_total {feature['hits']}",
            "# TYPE lo_feature_cache_misses_total counter",
            f"lo_feature_cache_misses_total {feature['misses']}",
            "# TYPE lo_feature_cache_bytes_in_use gauge",
            f"lo_feature_cache_bytes_in_use {feature['bytesInUse']}",
            "# TYPE lo_arena_bytes_in_use gauge",
            f"lo_arena_bytes_in_use {arena['bytesInUse']}",
            "# TYPE lo_arena_evictions_total counter",
            f"lo_arena_evictions_total {arena['evictions']}",
            "# TYPE lo_arena_hits_total counter",
            f"lo_arena_hits_total {arena['hits']}",
            "# TYPE lo_arena_misses_total counter",
            f"lo_arena_misses_total {arena['misses']}",
        ]
        sweep_fusion = m["sweepFusion"]
        lines += [
            "# TYPE lo_sweep_fused_trials_total counter",
            f"lo_sweep_fused_trials_total "
            f"{sweep_fusion.get('fusedTrials', 0)}",
            "# TYPE lo_sweep_cohorts_total counter",
            f"lo_sweep_cohorts_total {sweep_fusion.get('cohorts', 0)}",
            "# TYPE lo_sweep_fallback_trials_total counter",
            f"lo_sweep_fallback_trials_total "
            f"{sweep_fusion.get('fallbackTrials', 0)}",
            "# TYPE lo_sweep_early_stopped_total counter",
            f"lo_sweep_early_stopped_total "
            f"{sweep_fusion.get('earlyStopped', 0)}",
            "# TYPE lo_sweep_trial_errors_total counter",
            f"lo_sweep_trial_errors_total "
            f"{sweep_fusion.get('trialErrors', 0)}",
        ]
        lines += _serving_lines(m["serving"], esc)
        gateway = m["gateway"]
        lines += [
            "# TYPE lo_abandoned_dispatches gauge",
            f"lo_abandoned_dispatches {gateway['abandonedInflight']}",
            "# TYPE lo_abandoned_dispatches_total counter",
            f"lo_abandoned_dispatches_total {gateway['abandonedTotal']}",
            "# TYPE lo_gateway_inflight gauge",
            f"lo_gateway_inflight {gateway['inflight']}",
            "# TYPE lo_gateway_saturated_total counter",
            f"lo_gateway_saturated_total {gateway['saturatedTotal']}",
        ]
        # roofline gauges per train job; absent until a job records a
        # window
        perf_jobs = m["perf"]["jobs"]
        for metric, key in (("lo_mfu", "mfu"),
                            ("lo_tflops_per_chip", "tflopsPerSecPerChip"),
                            ("lo_hbm_bw_util_frac", "hbmBwUtil")):
            rows = [(job, rep[key]) for job, rep in perf_jobs.items()
                    if rep.get(key) is not None]
            if rows:
                lines.append(f"# TYPE {metric} gauge")
                for job, value in rows:
                    lines.append(f'{metric}{{job="{esc(job)}"}} {value}')
        xr = m["xray"]
        lines.append("# TYPE lo_hbm_attributed_bytes gauge")
        for owner, nbytes in sorted(xr["owners"].items()):
            lines.append(
                f'lo_hbm_attributed_bytes{{owner="{esc(owner)}"}} {nbytes}')
        lines += [
            "# TYPE lo_retraces_total counter",
            f"lo_retraces_total {xr['counters']['retraces']}",
            "# TYPE lo_implicit_transfers_total counter",
            f"lo_implicit_transfers_total "
            f"{xr['counters']['implicitTransfers']}",
        ]
        # cluster monitor + SLO watchdog gauges (absent with
        # LO_MONITOR=0, so scrapers see the series disappear)
        cluster = m.get("cluster")
        if cluster:
            hbm = cluster.get("hbm") or {}
            sched = cluster.get("scheduler") or {}
            serving_sample = cluster.get("serving") or {}
            xray_sample = cluster.get("xray") or {}
            for metric, value in (
                    ("lo_hbm_bytes_in_use", hbm.get("bytesInUse")),
                    ("lo_hbm_peak_bytes_in_use", hbm.get("peakBytesInUse")),
                    ("lo_hbm_headroom_frac", hbm.get("headroomFrac")),
                    ("lo_slice_fragmentation", sched.get("fragmentation")),
                    ("lo_serving_queue_depth_total",
                     serving_sample.get("queueDepth")),
                    ("lo_host_rss_bytes", cluster.get("hostRssBytes")),
                    ("lo_hbm_unattributed_bytes",
                     xray_sample.get("unattributedBytes"))):
                if value is not None:
                    lines.append(f"# TYPE {metric} gauge")
                    lines.append(f"{metric} {value}")
        if "alertsFiring" in m:
            lines += ["# TYPE lo_alerts_firing gauge",
                      f"lo_alerts_firing {m['alertsFiring']}"]
            if m.get("alerts"):
                lines.append("# TYPE lo_alert_firing gauge")
                for alert in m["alerts"]:
                    lines.append(
                        f'lo_alert_firing{{alert="{esc(alert["name"])}"'
                        f',severity="{esc(alert["severity"])}"}} 1')
        incidents = m.get("incidents")
        if incidents is not None:
            lines.append("# TYPE lo_incidents_total counter")
            for trig, n in sorted(
                    (incidents.get("byTrigger") or {}).items()):
                lines.append(
                    f'lo_incidents_total{{trigger="{esc(trig)}"}} {n}')
            lines += ["# TYPE lo_incident_bundles gauge",
                      f"lo_incident_bundles {incidents['bundles']}",
                      "# TYPE lo_incident_bytes gauge",
                      f"lo_incident_bytes {incidents['bytes']}"]
        lines.extend(obs_hist.prometheus_lines(esc))
        return ("\n".join(lines) + "\n").encode()

    def _route(self, method: str, path: str, params: Dict[str, Any],
               body: Optional[Dict[str, Any]]) -> Tuple[int, Any, str]:
        if path == "/health":
            return 200, self._health(), _JSON
        if path == "/healthz":
            return self._healthz()
        if path == "/metrics":
            if params.get("format") == "prometheus":
                return 200, self.metrics_prometheus(), _PROMETHEUS
            return 200, self.metrics(), _JSON
        if not path.startswith(API_PREFIX + "/"):
            return 404, {"result": "unknown route"}, _JSON
        parts = [p for p in path[len(API_PREFIX):].split("/") if p]
        if parts and parts[0] == "serve":
            return self._serve(method, parts, body or {})
        if parts and parts[0] == "observe" and method == "GET":
            return self._observe(parts, params)
        if parts and parts[0] == "profile":
            return self._profile(method, body or {})
        if parts and parts[0] == "observability":
            return self._observability(method, parts, params, body or {})
        if len(parts) < 2 or parts[0] not in SERVICES:
            return 404, {"result": "unknown route"}, _JSON
        service, tool = parts[0], parts[1]
        name = "/".join(parts[2:]) if len(parts) > 2 else None
        if method == "GET":
            return self._get(service, tool, name, params)
        if method == "POST":
            if name is not None:
                if name.endswith("/migrate") and len(name) > len("/migrate"):
                    raise V.not_ported("POST .../migrate (live migration)")
                raise V.HttpError(V.HTTP_NOT_ACCEPTABLE,
                                  "POST takes no name in the path")
            return self._post(service, tool, body or {})
        if method == "PATCH":
            if name is None:
                raise V.HttpError(V.HTTP_NOT_ACCEPTABLE, "missing name")
            return self._patch(service, tool, name, body or {})
        if method == "DELETE":
            if name is None:
                raise V.HttpError(V.HTTP_NOT_ACCEPTABLE, "missing name")
            return self._delete(service, tool, name)
        return 405, {"result": "unsupported method"}, _JSON

    def _post(self, service: str, tool: str,
              body: Dict[str, Any]) -> Tuple[int, Any, str]:
        if service == "dataset":
            status, payload = self.dataset.create(body, tool)
        elif service == "model":
            status, payload = self.model.create(body, tool)
        elif service == "function":
            status, payload = self.function.create(body, tool)
        elif service == "builder":
            status, payload = self.builder.create(body, tool)
        elif service == "explore" and tool == "histogram":
            status, payload = self.histogram.create(body, tool)
        elif service == "transform" and tool == "projection":
            status, payload = self.projection.create(body, tool)
        elif service == "transform" and tool == "dataType":
            status, payload = self.datatype.create(body, tool)
        elif service in ("explore", "transform"):
            status, payload = self.dbexec.create(body, service, tool)
        else:
            status, payload = self.execution.create(body, service, tool)
        return status, payload, _JSON

    def _patch(self, service: str, tool: str, name: str,
               body: Dict[str, Any]) -> Tuple[int, Any, str]:
        if service == "model":
            status, payload = self.model.update(name, body, tool)
        elif service in EXECUTION_VERBS:
            status, payload = self.execution.update(name, body, service,
                                                    tool)
        elif service in ("explore", "transform"):
            status, payload = self.dbexec.update(name, body, service, tool)
        elif service == "function":
            status, payload = self.function.update(name, body, tool)
        else:
            raise V.HttpError(V.HTTP_NOT_ACCEPTABLE,
                              f"PATCH unsupported for {service}")
        return status, payload, _JSON

    def _delete(self, service: str, tool: str,
                name: str) -> Tuple[int, Any, str]:
        # cancels the running job and keeps the collection (a safe name
        # has no "/", so no collection shadows the suffix)
        if name.endswith("/run") and len(name) > len("/run"):
            return self._cancel_run(name[:-len("/run")])
        if service in ("dataset", "function", "explore", "transform",
                       "builder"):
            status, payload = self.dataset.delete_file(name)
        elif service == "model":
            status, payload = self.model.delete(name, tool)
        else:
            status, payload = self.execution.delete(name, service, tool)
        return status, payload, _JSON

    def _cancel_run(self, name: str) -> Tuple[int, Any, str]:
        if self.ctx.catalog.get_metadata(name) is None:
            raise V.HttpError(V.HTTP_NOT_FOUND,
                              f"{V.MESSAGE_NONEXISTENT_FILE}: {name}")
        if not self.ctx.jobs.cancel(name):
            raise V.HttpError(V.HTTP_NOT_ACCEPTABLE,
                              f"no cancellable job for {name} (already "
                              f"finished or never submitted here)")
        return 200, {"result": f"cancellation requested for {name}"}, _JSON

    def _cached(self, key: tuple, version: Any, now: float,
                read) -> Tuple[int, Any, str]:
        """``read()``'s ``(status, payload)`` through the GET cache."""
        cache = self.read_cache
        if cache.enabled:
            hit = cache.get(key, version, now)
            if hit is not None:
                return hit[0], hit[1], _JSON
        status, payload = read()
        if cache.enabled:
            cache.put(key, version, now, status, payload)
        return status, payload, _JSON

    def _get(self, service: str, tool: str, name: Optional[str],
             params: Dict[str, Any]) -> Tuple[int, Any, str]:
        now = time.monotonic()
        catalog = self.ctx.catalog
        if name is None:
            # any create, update or delete moves the global seq
            return self._cached(
                ("list", service, tool), catalog.latest_seq(), now,
                lambda: self.dataset.list_files(
                    D.normalize_type(f"{service}/{tool}")))
        # an explore plot is a PNG; a paged or queried GET reads the
        # documents, so polling finished works
        has_paging = any(k in params for k in ("skip", "limit", "query"))
        if service == "explore" and tool != "histogram" and not has_paging:
            meta = catalog.get_metadata(name)
            if meta is not None and str(
                    meta.get(D.TYPE_FIELD, "")).startswith("explore/"):
                try:
                    png, content_type = self.dbexec.image_response(name)
                    return 200, png, content_type
                except Exception:  # noqa: BLE001 — no plot yet: the JSON
                    pass
        skip = int(params.get("skip", 0) or 0)
        limit = params.get("limit")
        limit = int(limit) if limit not in (None, "") else None
        query = parse_query_param(params.get("query"))
        # keyed on the collection's newest change (documents, metadata)
        # and its rows' file stamp (row writes bypass the change feed)
        return self._cached(
            ("read", name, skip, limit, params.get("query")),
            (catalog.collection_seq(name), catalog.dataset_version(name)),
            now, lambda: self.dataset.read_file(
                name, skip=skip, limit=limit, query=query))

    def _observe(self, parts: list,
                 params: Dict[str, Any]) -> Tuple[int, Any, str]:
        """``GET /observe/{name}?seq=N&timeout=S``: waits until collection
        ``name`` changes past sequence N (at most S seconds, default 25,
        clamped to 120), then returns the changes, the newest seq and the
        metadata. ``GET /observe`` returns the newest seq."""
        catalog = self.ctx.catalog
        if len(parts) < 2:
            return 200, {"result": {"seq": catalog.latest_seq()}}, _JSON
        name = parts[1]
        seq = int(params.get("seq", 0) or 0)
        timeout = min(float(params.get("timeout", 25) or 25),
                      OBSERVE_MAX_SECONDS)
        # inside a gateway deadline the poll ends just before it, with
        # an empty answer the client polls again
        gateway = self.ctx.config.request_timeout_seconds
        if gateway > 0:
            timeout = min(timeout, max(0.05, gateway - 0.1))
        changes = catalog.watch(seq, collection=name, timeout=timeout)
        return 200, {"result": {
            "changes": changes,
            "seq": catalog.latest_seq(),
            "metadata": catalog.get_metadata(name),
        }}, _JSON

    # ------------------------------------------------------------------
    def _observability(self, method: str, parts: list,
                       params: Dict[str, Any],
                       body: Dict[str, Any]) -> Tuple[int, Any, str]:
        """The read surface of the plane (docs/OBSERVABILITY.md), as the
        JAX server answers it: trace, timeline, perf, memory, compile,
        cluster, alerts and incidents. Trace names may contain ``/``
        (``serve/{model}/{seq}``), so the rest of the path joins back
        up."""
        kind = parts[1] if len(parts) > 1 else ""
        if kind == "incidents":
            return self._incidents(method, parts, body)
        if method != "GET":
            return 405, {"result": "unsupported method"}, _JSON
        name = "/".join(parts[2:])
        if kind == "trace":
            if not name:
                return 200, {"result": obs_trace.known_traces()}, _JSON
            doc = (obs_export.chrome_trace(name)
                   if params.get("format") == "chrome"
                   else obs_trace.tree(name))
            if doc is None:
                raise V.HttpError(
                    V.HTTP_NOT_FOUND,
                    f"no trace recorded for {name} (job never ran here, "
                    f"trace evicted, or LO_TRACE=0)")
            return 200, doc, _JSON
        if kind == "timeline":
            if not name:
                return 200, {"result": obs_timeline.known_jobs()}, _JSON
            summary = obs_timeline.summary(name)
            if summary is None:
                raise V.HttpError(V.HTTP_NOT_FOUND,
                                  f"no step telemetry recorded for {name}")
            return 200, {"job": name, "summary": summary,
                         "timeline": obs_timeline.entries(name)}, _JSON
        if kind == "perf":
            platform = obs_perf.platform_summary()
            if not name:
                return 200, {"platform": platform,
                             "jobs": obs_perf.known_jobs()}, _JSON
            # a live serving session, then the in-process train
            # registry, then the perf block on terminal train metadata
            report = self.ctx.serving.perf_report(name)
            if report is None:
                job = obs_perf.job_report(name)
                if job is not None:
                    report = {"kind": "train", "job": name, "perf": job}
            if report is None:
                stamped = (self.ctx.catalog.get_metadata(name) or {}).get(
                    "perf")
                if stamped:
                    report = {"kind": "train", "job": name,
                              "perf": stamped, "terminal": True}
            if report is None:
                raise V.HttpError(
                    V.HTTP_NOT_FOUND,
                    f"no perf report for {name} (job never recorded a "
                    f"steady-state window here, or LO_PERF=0)")
            report["platform"] = platform
            return 200, report, _JSON
        if kind == "memory":
            report = obs_xray.memory_report(name or None)
            if name and not report["entries"]:
                raise V.HttpError(
                    V.HTTP_NOT_FOUND,
                    f"no ledgered allocations tagged {name} (nothing "
                    f"resident for it right now, or LO_XRAY=0)")
            return 200, report, _JSON
        if kind == "compile":
            if not name:
                return 200, {"result": obs_xray.known_compiles()}, _JSON
            raise V.HttpError(
                V.HTTP_NOT_FOUND,
                f"no compiled-artifact report for {name} (job never "
                f"compiled a step here, report evicted, or LO_XRAY=0)")
        if kind == "cluster":
            if self.ctx.monitor is None:
                raise V.HttpError(V.HTTP_NOT_FOUND,
                                  "cluster monitor disabled (LO_MONITOR=0)")
            return 200, self.ctx.monitor.snapshot(), _JSON
        if kind == "alerts":
            watchdog = getattr(self.ctx.monitor, "watchdog", None)
            if watchdog is None:
                raise V.HttpError(V.HTTP_NOT_FOUND,
                                  "SLO watchdog disabled (LO_MONITOR=0)")
            return 200, watchdog.snapshot(), _JSON
        return 404, {"result": "unknown route"}, _JSON

    def _incidents(self, method: str, parts: list,
                   body: Dict[str, Any]) -> Tuple[int, Any, str]:
        """The flight recorder's surface: list, manifest, tar download,
        and the synchronous manual capture (which bypasses the
        cooldown)."""
        recorder = self.ctx.incidents
        if recorder is None:
            raise V.HttpError(V.HTTP_NOT_FOUND,
                              "incident recorder disabled (LO_INCIDENTS=0)")
        if method == "POST":
            if len(parts) != 2:
                return 404, {"result": "unknown route"}, _JSON
            return V.HTTP_CREATED, recorder.capture("manual", body), _JSON
        if method != "GET":
            return 405, {"result": "unsupported method"}, _JSON
        if len(parts) == 2:
            return 200, {"result": recorder.list()}, _JSON
        iid = parts[2]
        if len(parts) == 4 and parts[3] == "download":
            data = recorder.tar_bytes(iid)
            if data is None:
                raise V.HttpError(V.HTTP_NOT_FOUND,
                                  f"no incident bundle {iid}")
            return 200, data, "application/x-tar"
        if len(parts) == 3:
            manifest = recorder.manifest(iid)
            if manifest is None:
                raise V.HttpError(V.HTTP_NOT_FOUND,
                                  f"no incident bundle {iid}")
            return 200, manifest, _JSON
        return 404, {"result": "unknown route"}, _JSON

    def _health(self) -> Dict[str, Any]:
        """Liveness and topology: the pod's ranks (one a card), the card
        count and platform from torch, and ``podFailure`` with status
        ``degraded`` while the pod has lost a worker (asked first: a
        broken group is when the topology is likeliest to raise), and
        ``kernelLaunches``: this rank's launches of each flash kernel."""
        from learningorchestra_tpu_torch.ops import attention as attn_ops
        from learningorchestra_tpu_torch.runtime import distributed as dist

        info: Dict[str, Any] = {"status": "ok",
                                "jobsRunning": self.ctx.jobs.running()}
        failure = dist.pod_failure()
        if failure:
            info["status"] = "degraded"
            info["podFailure"] = failure
        try:
            info.update(dist.host_info(self.ctx.device.type))
            info["kernelLaunches"] = attn_ops.launch_counts()
            import torch

            on_card = self.ctx.device.type == "cuda"
            info["deviceCount"] = (torch.cuda.device_count() if on_card
                                   else 1)
            info["devicePlatform"] = self.ctx.device.type
            if on_card:
                info["deviceKind"] = torch.cuda.get_device_name(
                    self.ctx.device)
        except Exception as e:  # noqa: BLE001
            info["deviceError"] = repr(e)
        return info

    def _healthz(self) -> Tuple[int, Any, str]:
        """Readiness: 503 while the server drains or while any
        page-severity SLO alert fires; 200 otherwise."""
        watchdog = getattr(self.ctx.monitor, "watchdog", None)
        paging = [a for a in watchdog.firing()
                  if a["severity"] == "page"] if watchdog else []
        if self.ctx.draining:
            return 503, {"status": "draining"}, _JSON
        if paging:
            return 503, {"status": "failing", "alerts": paging}, _JSON
        return 200, {"status": "ok"}, _JSON

    def _profile(self, method: str,
                 body: Dict[str, Any]) -> Tuple[int, Any, str]:
        """``POST /profile {"action": "start"|"stop"}`` records a
        ``torch.profiler`` session (CPU ops, and the card's kernels) and
        writes its Chrome trace into ``home/profiles/<stamp>/``; ``GET
        /profile`` lists the captured dirs. The session is the context's
        :class:`~learningorchestra_tpu_torch.observability.incidents.
        ProfilerGate` (shared with the flight recorder), which stops a
        forgotten start after ``LO_PROFILE_MAX_SECONDS``; the newest
        ``LO_PROFILE_KEEP`` dirs are kept."""
        gate = self.ctx.profiler_gate
        root = os.path.join(self.ctx.config.home, "profiles")
        if method == "GET":
            traces = sorted(os.listdir(root)) if os.path.isdir(root) else []
            doc: Dict[str, Any] = {"active": gate.active() is not None,
                                   "traces": traces}
            auto_stop = gate.last_auto_stop()
            if auto_stop is not None:
                doc["lastAutoStop"] = auto_stop
            return 200, doc, _JSON
        if method != "POST":
            return 405, {"result": "unsupported method"}, _JSON
        action = (body.get("action") or "").lower()
        if action == "start":
            trace_dir = os.path.join(
                root, f"{time.strftime('%Y%m%d-%H%M%S')}-"
                      f"{time.time_ns() % 1_000_000:06d}")
            if not gate.try_start(
                    trace_dir,
                    max_seconds=float(self.ctx.config.profile_max_seconds
                                      or 0)):
                raise V.HttpError(V.HTTP_NOT_ACCEPTABLE,
                                  "a trace is already active")
            return V.HTTP_CREATED, {"result": trace_dir}, _JSON
        if action == "stop":
            # the gate clears its marker even when the stop raises (a
            # 500 here), so a failed stop never wedges later starts
            trace_dir = gate.stop()
            if trace_dir is None:
                raise V.HttpError(V.HTTP_NOT_ACCEPTABLE, "no active trace")
            n_files = sum(len(fs) for _, _, fs in os.walk(trace_dir))
            obs_incidents.prune_dirs(
                root, int(self.ctx.config.profile_keep or 0))
            return 200, {"result": trace_dir, "files": n_files}, _JSON
        raise V.HttpError(V.HTTP_NOT_ACCEPTABLE,
                          "action must be 'start' or 'stop'")

    def _serve(self, method: str, parts: list,
               body: Dict[str, Any]) -> Tuple[int, Any, str]:
        serving = self.ctx.serving
        if method == "GET":
            if len(parts) == 1:
                return 200, {"result": serving.list_sessions()}, _JSON
            if len(parts) == 2:
                return 200, serving.session_stats(parts[1]), _JSON
        elif method == "POST":
            if len(parts) == 2:
                return V.HTTP_CREATED, serving.create(parts[1], body), _JSON
            if len(parts) == 3 and parts[2] == "predict":
                return 200, serving.predict(parts[1], body), _JSON
        elif method == "DELETE":
            if len(parts) == 2:
                return 200, serving.delete(parts[1]), _JSON
        else:
            return 405, {"result": "unsupported method"}, _JSON
        return 404, {"result": "unknown route"}, _JSON


class _Handler(BaseHTTPRequestHandler):
    api: Api = None  # set by RestServer
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002
        pass

    def _read_body(self) -> Optional[Dict[str, Any]]:
        length = int(self.headers.get("Content-Length") or 0)
        if not length:
            return None
        try:
            body = json.loads(self.rfile.read(length))
        except json.JSONDecodeError:
            return None
        return body if isinstance(body, dict) else None

    def _respond(self, method: str) -> None:
        parsed = urlparse(self.path)
        params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        body = self._read_body() if method in ("POST", "PATCH") else None
        timeout = self.api.ctx.config.request_timeout_seconds
        if timeout > 0:
            # metrics are recorded here, with the status the client saw
            t0 = time.monotonic()
            status, payload, content_type = self._timed_dispatch(
                method, parsed.path, params, body, timeout)
            self.api.record_metrics(method, parsed.path, status,
                                    time.monotonic() - t0)
        else:
            status, payload, content_type = self.api.dispatch(
                method, parsed.path, params, body)
        self._send(status, payload, content_type)

    def _timed_dispatch(self, method: str, path: str,
                        params: Dict[str, Any], body, timeout: float,
                        ) -> Tuple[int, Any, str]:
        """The gateway's deadline: the dispatch runs on a thread of its
        own and the client gets 504 after ``timeout`` seconds while the
        work goes on (the reference gateway's proxy timeout). Abandoned
        dispatches count against ``gateway_max_inflight``: at the cap a
        timed request gets 503 at once."""
        api = self.api
        cap = api.ctx.config.gateway_max_inflight
        gateway = api.gateway
        with api.gateway_lock:
            saturated = cap > 0 and gateway["inflight"] >= cap
            if saturated:
                gateway["saturatedTotal"] += 1
            else:
                gateway["inflight"] += 1
        if saturated:
            return 503, {"result": f"gateway saturated ({cap} timed "
                                   f"dispatches in flight) — retry with "
                                   f"backoff"}, _JSON
        result: list = []
        done = threading.Event()
        state = {"finished": False, "abandoned": False}

        def run_dispatch() -> None:
            try:
                result.append(api.dispatch(method, path, params, body,
                                           record=False))
                done.set()
            finally:
                with api.gateway_lock:
                    gateway["inflight"] -= 1
                    state["finished"] = True
                    if state["abandoned"]:
                        gateway["abandonedInflight"] -= 1

        threading.Thread(target=run_dispatch, daemon=True,
                         name="lo-gateway").start()
        if done.wait(timeout):
            return result[0]
        with api.gateway_lock:
            # a dispatch that lands between the wait and this lock is not
            # abandoned
            if not state["finished"]:
                state["abandoned"] = True
                gateway["abandonedTotal"] += 1
                gateway["abandonedInflight"] += 1
        return 504, {"result": f"request timed out after {timeout:g}s"}, \
            _JSON

    def _send(self, status: int, payload: Any, content_type: str) -> None:
        if isinstance(payload, (bytes, bytearray)):
            data = bytes(payload)
        else:
            data = json.dumps(payload).encode()
            content_type = _JSON
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        self._respond("GET")

    def do_POST(self):  # noqa: N802
        self._respond("POST")

    def do_PATCH(self):  # noqa: N802
        self._respond("PATCH")

    def do_DELETE(self):  # noqa: N802
        self._respond("DELETE")


class _HTTPServer(ThreadingHTTPServer):
    # connections the kernel holds before accept: a paged session serves
    # tens of concurrent predicts, and past the socketserver default of
    # 5 a client's connect waits out its SYN retry (a second)
    request_queue_size = 128


class RestServer:
    """Owns the HTTP server and its ServiceContext."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5000,
                 device: Optional[str] = None,
                 context: Optional[ServiceContext] = None):
        self.api = Api(context, device=device)
        handler = type("BoundHandler", (_Handler,), {"api": self.api})
        self.httpd = _HTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    @property
    def base_url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "RestServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="lo-rest")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def stop(self) -> None:
        # flip /healthz to 503 while the listener still answers, so a
        # load balancer health-checking this node drains it first
        self.api.ctx.begin_drain()
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(timeout=30.0)
        self.httpd.server_close()
        self.api.ctx.close()


def _serving_lines(serving: Dict[str, Any], esc) -> list:
    """The serving plane's Prometheus series (the JAX server's)."""
    by = serving["bySession"]
    lines = [
        "# TYPE lo_serving_sessions gauge",
        f"lo_serving_sessions {serving['sessions']}",
        "# TYPE lo_serving_requests_total counter",
        f"lo_serving_requests_total {serving['requestsTotal']}",
        "# TYPE lo_serving_rejected_total counter",
        f"lo_serving_rejected_total {serving['rejectedTotal']}",
        "# TYPE lo_serving_tokens_total counter",
        f"lo_serving_tokens_total {serving['tokensTotal']}",
        "# TYPE lo_serving_lease_yields_total counter",
        f"lo_serving_lease_yields_total {serving['leaseYields']}",
    ]
    for metric, value_of in (
            ("lo_serving_latency_p50_ms", lambda s: s["latency"]["p50Ms"]),
            ("lo_serving_latency_p99_ms", lambda s: s["latency"]["p99Ms"]),
            ("lo_serving_queue_depth", lambda s: s["queueDepth"])):
        lines.append(f"# TYPE {metric} gauge")
        for sess in by:
            lines.append(f'{metric}{{model="{esc(sess["model"])}"}} '
                         f'{value_of(sess)}')
    # paged-KV pool state per session (the pool size is a gauge, so its
    # name must not end in _total, which drives the TYPE below)
    kv_rows = [sess for sess in by if sess.get("kv")]
    if kv_rows:
        for metric, kv_value in (
                ("lo_serving_kv_pages", lambda kv: kv["pagesTotal"]),
                ("lo_serving_kv_pages_free", lambda kv: kv["pagesFree"]),
                ("lo_serving_kv_pages_shared",
                 lambda kv: kv["pagesShared"]),
                ("lo_serving_kv_alloc_failures_total",
                 lambda kv: kv["allocFailures"]),
                ("lo_serving_kv_prefills_skipped_total",
                 lambda kv: kv["prefix"]["prefillsSkipped"]),
                ("lo_serving_kv_pages_reused_total",
                 lambda kv: kv["prefix"]["pagesReused"])):
            kind = "counter" if metric.endswith("_total") else "gauge"
            lines.append(f"# TYPE {metric} {kind}")
            for sess in kv_rows:
                lines.append(f'{metric}{{model="{esc(sess["model"])}"}} '
                             f'{kv_value(sess["kv"])}')
    tenant_rows = [(sess["model"], tenant, tstats["pages"])
                   for sess in by
                   for tenant, tstats in sorted(
                       ((sess.get("kv") or {}).get("tenants")
                        or {}).items())]
    if tenant_rows:
        lines.append("# TYPE lo_serving_tenant_pages gauge")
        for model, tenant, pages in tenant_rows:
            lines.append(f'lo_serving_tenant_pages{{model="{esc(model)}",'
                         f'tenant="{esc(tenant)}"}} {pages}')
    for metric, of_sess in (
            ("lo_serving_tokens_per_sec_per_chip",
             lambda s: (s.get("perf") or {}).get(
                 "decodeTokensPerSecPerChip")),
            ("lo_serving_kv_bytes_per_token",
             lambda s: (s.get("kv") or {}).get("bytesPerToken")),
            ("lo_serving_drift",
             lambda s: (s.get("drift") or {}).get("value"))):
        lines.append(f"# TYPE {metric} gauge")
        for sess in by:
            value = of_sess(sess)
            if value is not None:
                lines.append(f'{metric}{{model="{esc(sess["model"])}"}} '
                             f'{value}')
    for metric, of_sess in (
            ("lo_serving_ttft_p50_ms",
             lambda s: (s.get("ttft") or {}).get("p50Ms")),
            ("lo_serving_ttft_p99_ms",
             lambda s: (s.get("ttft") or {}).get("p99Ms")),
            ("lo_serving_accepted_tokens_per_step",
             lambda s: (s.get("spec") or {}).get("acceptedTokensPerStep")),
            ("lo_serving_handoff_queue",
             lambda s: (s.get("disagg") or {}).get("handoffQueue"))):
        rows = [(sess["model"], of_sess(sess)) for sess in by
                if of_sess(sess) is not None]
        if rows:
            lines.append(f"# TYPE {metric} gauge")
            for model, value in rows:
                lines.append(f'{metric}{{model="{esc(model)}"}} {value}')
    rows = [(sess["model"], sess["disagg"]["handoffsTotal"]) for sess in by
            if (sess.get("disagg") or {}).get("handoffsTotal") is not None]
    if rows:
        lines.append("# TYPE lo_serving_handoffs_total counter")
        for model, value in rows:
            lines.append(
                f'lo_serving_handoffs_total{{model="{esc(model)}"}} {value}')
    role_rows = [(sess["model"], role, tracker) for sess in by
                 for role, tracker in sorted(
                     (sess.get("roles") or {}).items())]
    if role_rows:
        for metric, pkey in (("lo_serving_role_latency_p50_ms", "p50Ms"),
                             ("lo_serving_role_latency_p99_ms", "p99Ms")):
            lines.append(f"# TYPE {metric} gauge")
            for model, role, tracker in role_rows:
                lines.append(f'{metric}{{model="{esc(model)}",'
                             f'role="{esc(role)}"}} {tracker[pkey]}')
    return lines
