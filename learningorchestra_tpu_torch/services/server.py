"""The REST plane of the port: the serving routes of the JAX package's
server, with the same status codes and bodies.

====== ================================ ============================
verb   path (under /api/learningOrchestra/v1)  handler
====== ================================ ============================
POST   /serve/{model}                   create a session (201)
POST   /serve/{model}/predict           synchronous inference
GET    /serve, /serve/{model}           stats
DELETE /serve/{model}                   teardown
====== ================================ ============================

Every other route answers 404 until it is ported.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from learningorchestra_tpu_torch.config import API_PREFIX
from learningorchestra_tpu_torch.services import validators as V
from learningorchestra_tpu_torch.services.context import ServiceContext

_JSON = "application/json"


class Api:
    """Transport-independent dispatch (testable without sockets)."""

    def __init__(self, context: Optional[ServiceContext] = None,
                 device: Optional[str] = None):
        self.ctx = context or ServiceContext(device=device)

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
        return 404, {"result": "unknown route"}, _JSON

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
