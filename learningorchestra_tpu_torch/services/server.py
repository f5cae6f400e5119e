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
====== ========================================= =======================

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
``POST .../{name}/migrate`` answers 406 "not yet ported"; every other
service (observability, profile, /health, /metrics) answers 404 until it
is ported.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.config import API_PREFIX
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
                 body: Optional[Dict[str, Any]]) -> Tuple[int, Any, str]:
        """Returns (status, payload, content_type)."""
        try:
            return self._route(method, path, params, body)
        except V.HttpError as e:
            payload = {"result": e.message}
            if e.findings:
                payload["analysis"] = e.findings
            return e.status, payload, _JSON
        except Exception as e:  # noqa: BLE001 — the server must keep answering
            return 500, {"result": f"internal error: {e!r}"}, _JSON

    def _route(self, method: str, path: str, params: Dict[str, Any],
               body: Optional[Dict[str, Any]]) -> Tuple[int, Any, str]:
        if not path.startswith(API_PREFIX + "/"):
            return 404, {"result": "unknown route"}, _JSON
        parts = [p for p in path[len(API_PREFIX):].split("/") if p]
        if parts and parts[0] == "serve":
            return self._serve(method, parts, body or {})
        if parts and parts[0] == "observe" and method == "GET":
            return self._observe(parts, params)
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
            status, payload, content_type = self._timed_dispatch(
                method, parsed.path, params, body, timeout)
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
                result.append(api.dispatch(method, path, params, body))
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
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join(timeout=30.0)
        self.httpd.server_close()
        self.api.ctx.close()
