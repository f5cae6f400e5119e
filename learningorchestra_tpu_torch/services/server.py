"""The REST plane of the port: the pipeline and serving routes of the
JAX package's server, with the same status codes and bodies.

====== ========================================= =======================
verb   path (under /api/learningOrchestra/v1)    handler
====== ========================================= =======================
POST   /dataset/csv                              ingest (201 + URI)
POST   /model/{tool}                             build a model (201)
POST   /{train,tune,evaluate,predict}/{tool}     run a method (201)
PATCH  /{model,train,...}/{tool}/{name}          re-run (200)
DELETE /{service}/{tool}/{name}                  delete (200)
GET    /{service}/{tool}                         list collections
GET    /{service}/{tool}/{name}?skip&limit&query paged read
POST   /serve/{model}                            create a session (201)
POST   /serve/{model}/predict                    synchronous inference
GET    /serve, /serve/{model}                    stats
DELETE /serve/{model}                            teardown
====== ========================================= =======================

``DELETE .../{name}/run`` (cancel) and ``POST .../{name}/migrate``
answer 406 "not yet ported"; every other service (explore, transform,
function, builder, observe, observability, profile, /health, /metrics)
answers 404 until it is ported.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.config import API_PREFIX
from learningorchestra_tpu_torch.services import validators as V
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.dataset import (
    DatasetService,
    parse_query_param,
)
from learningorchestra_tpu_torch.services.execution import ExecutionService
from learningorchestra_tpu_torch.services.model_service import ModelService

_JSON = "application/json"
SERVICES = ("dataset", "model", "tune", "train", "evaluate", "predict")
EXECUTION_VERBS = ("train", "tune", "evaluate", "predict")


class Api:
    """Transport-independent dispatch (testable without sockets)."""

    def __init__(self, context: Optional[ServiceContext] = None,
                 device: Optional[str] = None):
        self.ctx = context or ServiceContext(device=device)
        self.dataset = DatasetService(self.ctx)
        self.model = ModelService(self.ctx)
        self.execution = ExecutionService(self.ctx)

    def dispatch(self, method: str, path: str, params: Dict[str, Any],
                 body: Optional[Dict[str, Any]]) -> Tuple[int, Any, str]:
        """Returns (status, payload, content_type)."""
        try:
            return self._route(method, path, params, body)
        except V.HttpError as e:
            return e.status, {"result": e.message}, _JSON
        except Exception as e:  # noqa: BLE001 — the server must keep answering
            return 500, {"result": f"internal error: {e!r}"}, _JSON

    def _route(self, method: str, path: str, params: Dict[str, Any],
               body: Optional[Dict[str, Any]]) -> Tuple[int, Any, str]:
        if not path.startswith(API_PREFIX + "/"):
            return 404, {"result": "unknown route"}, _JSON
        parts = [p for p in path[len(API_PREFIX):].split("/") if p]
        if parts and parts[0] == "serve":
            return self._serve(method, parts, body or {})
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
        else:
            raise V.HttpError(V.HTTP_NOT_ACCEPTABLE,
                              f"PATCH unsupported for {service}")
        return status, payload, _JSON

    def _delete(self, service: str, tool: str,
                name: str) -> Tuple[int, Any, str]:
        if name.endswith("/run") and len(name) > len("/run"):
            raise V.not_ported("DELETE .../run (job cancellation)")
        if service == "dataset":
            status, payload = self.dataset.delete_file(name)
        elif service == "model":
            status, payload = self.model.delete(name, tool)
        else:
            status, payload = self.execution.delete(name, service, tool)
        return status, payload, _JSON

    def _get(self, service: str, tool: str, name: Optional[str],
             params: Dict[str, Any]) -> Tuple[int, Any, str]:
        if name is None:
            status, payload = self.dataset.list_files(
                D.normalize_type(f"{service}/{tool}"))
            return status, payload, _JSON
        skip = int(params.get("skip", 0) or 0)
        limit = params.get("limit")
        limit = int(limit) if limit not in (None, "") else None
        status, payload = self.dataset.read_file(
            name, skip=skip, limit=limit,
            query=parse_query_param(params.get("query")))
        return status, payload, _JSON

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
        status, payload, content_type = self.api.dispatch(
            method, parsed.path, params, body)
        data = json.dumps(payload).encode()
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


class RestServer:
    """Owns the HTTP server and its ServiceContext."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5000,
                 device: Optional[str] = None,
                 context: Optional[ServiceContext] = None):
        self.api = Api(context, device=device)
        handler = type("BoundHandler", (_Handler,), {"api": self.api})
        self.httpd = ThreadingHTTPServer((host, port), handler)
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
