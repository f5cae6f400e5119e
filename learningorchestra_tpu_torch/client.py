"""Python client of the REST API: the port's own copy of the JAX
package's ``client.py``. It needs the standard library (urllib) and the
port's ``config`` module, for the API prefix, and no torch.

One ``Context`` holds a tool handle per (service, tool) route; every
handle offers the verbs the API has:

    ctx = Context("http://127.0.0.1:5000")
    ctx.dataset_csv.insert("titanic", "/data/titanic.csv")
    ctx.wait("titanic")                       # observe long-poll
    ctx.model_tensorflow.create(model_name="cnn", module_path=...,
                                class_name=..., class_parameters={...})
    ctx.train_tensorflow.run(name="cnn_t", model_name="cnn",
                             method="fit", parameters={...})
    ctx.wait("cnn_t")
    ctx.evaluate_tensorflow.read("cnn_e")

Every method of the JAX client is here. A route the PyTorch server does
not have yet answers through the client as the server answers it: an
:class:`ApiError` with its 404 or 406.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from learningorchestra_tpu_torch.config import API_PREFIX


class ApiError(Exception):
    def __init__(self, status: int, message: Any):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class _Http:
    def __init__(self, base_url: str, timeout: float = 300.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def request(self, method: str, path: str,
                body: Optional[Dict[str, Any]] = None,
                params: Optional[Dict[str, Any]] = None,
                ) -> Tuple[int, Any]:
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(
                {k: v for k, v in params.items() if v is not None})
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        if data is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
                status = resp.status
                ctype = resp.headers.get("Content-Type", "")
        except urllib.error.HTTPError as e:
            raw = e.read()
            status = e.code
            ctype = e.headers.get("Content-Type", "")
        payload = json.loads(raw) if "json" in ctype else raw
        if status >= 400:
            raise ApiError(status, payload if isinstance(payload, bytes)
                           else payload.get("result", payload))
        return status, payload


class Tool:
    """Handle for one ``/{service}/{tool}`` route family."""

    def __init__(self, http: _Http, service: str, tool: str):
        self._http = http
        self.service = service
        self.tool = tool
        self._base = f"{API_PREFIX}/{service}/{tool}"

    # -- generic verbs --------------------------------------------------
    def post(self, body: Dict[str, Any]) -> Any:
        _, payload = self._http.request("POST", self._base, body)
        return payload["result"]

    def update(self, name: str, body: Dict[str, Any]) -> Any:
        _, payload = self._http.request("PATCH", f"{self._base}/{name}",
                                        body)
        return payload["result"]

    def search(self) -> List[Dict[str, Any]]:
        """All metadata documents of this type (catalog listing)."""
        _, payload = self._http.request("GET", self._base)
        return payload["result"]

    def read(self, name: str, skip: int = 0, limit: Optional[int] = None,
             query: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        params: Dict[str, Any] = {"skip": skip or None,
                                  "limit": limit}
        if query is not None:
            params["query"] = json.dumps(query)
        _, payload = self._http.request("GET", f"{self._base}/{name}",
                                        params=params)
        return payload

    def read_image(self, name: str) -> bytes:
        """Raw plot bytes for explore artifacts."""
        _, payload = self._http.request("GET", f"{self._base}/{name}")
        if not isinstance(payload, bytes):
            raise ApiError(406, f"{name} has no image payload")
        return payload

    def metadata(self, name: str) -> Dict[str, Any]:
        return self.read(name, limit=1)["metadata"]

    def delete(self, name: str) -> Any:
        _, payload = self._http.request("DELETE", f"{self._base}/{name}")
        return payload["result"]

    def cancel(self, name: str) -> Any:
        """Request cooperative cancellation of ``name``'s running job
        (``DELETE .../{name}/run``). The collection and its documents
        survive; the job records a terminal ``cancelled`` execution
        document at its next yield point (docs/LIFECYCLE.md)."""
        _, payload = self._http.request("DELETE",
                                        f"{self._base}/{name}/run")
        return payload["result"]

    def migrate(self, name: str) -> Any:
        """Ask ``name``'s running job to move to a fresh mesh-slice
        placement at its next epoch boundary
        (``POST .../{name}/migrate``, docs/SCALING.md §7). 406 when
        the job is not a live migratable mesh job."""
        _, payload = self._http.request("POST",
                                        f"{self._base}/{name}/migrate",
                                        body={})
        return payload["result"]

    def wait(self, name: str, timeout: float = 600.0,
             poll_interval: float = 0.25) -> Dict[str, Any]:
        """Block until ``finished`` is True (the platform's universal
        job-completion idiom). Raises on timeout; surfacing job
        exceptions is the caller's read of the execution documents.
        Monotonic deadline: an NTP step mid-wait must not hang or
        truncate the poll loop."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            meta = self.metadata(name)
            if meta.get("finished"):
                return meta
            time.sleep(poll_interval)
        raise TimeoutError(f"{self.service}/{self.tool}/{name} "
                           f"not finished after {timeout}s")

    # -- per-service sugar ---------------------------------------------
    def insert(self, dataset_name: str, url: str) -> Any:
        """dataset ingest (POST body field names per reference
        database_api constants.py:17-18)."""
        return self.post({"datasetName": dataset_name, "datasetURI": url})

    def create(self, model_name: str, module_path: str, class_name: str,
               class_parameters: Optional[Dict[str, Any]] = None,
               description: str = "") -> Any:
        return self.post({
            "modelName": model_name, "modulePath": module_path,
            "class": class_name,
            "classParameters": class_parameters or {},
            "description": description})

    def run(self, name: str, model_name: str, method: str,
            parameters: Optional[Dict[str, Any]] = None,
            description: str = "",
            timeout: Optional[float] = None,
            slice_devices: Any = None) -> Any:
        """train/tune/evaluate/predict method execution. ``timeout``
        is the job's server-side deadline in seconds (past it the job
        is cancelled with a terminal ``timedOut`` document).
        ``slice_devices`` pins the job's device footprint: an int
        device count, or elastic bounds ``{"min": m, "max": M}`` that
        opt the job into autoscaler resizes (docs/SCALING.md "Elastic
        autoscaling")."""
        body = {
            "name": name, "modelName": model_name, "method": method,
            "methodParameters": parameters or {},
            "description": description}
        if timeout is not None:
            body["timeout"] = timeout
        if slice_devices is not None:
            body["sliceDevices"] = slice_devices
        return self.post(body)

    def run_class(self, name: str, module_path: str, class_name: str,
                  class_parameters: Optional[Dict[str, Any]] = None,
                  method: str = "", parameters: Optional[Dict] = None,
                  description: str = "") -> Any:
        """explore/transform reflection execution."""
        return self.post({
            "name": name, "modulePath": module_path, "class": class_name,
            "classParameters": class_parameters or {},
            "method": method, "methodParameters": parameters or {},
            "description": description})

    def run_function(self, name: str, function: str,
                     parameters: Optional[Dict[str, Any]] = None,
                     description: str = "",
                     sandbox_mode: Optional[str] = None,
                     timeout: Optional[float] = None) -> Any:
        """``sandbox_mode`` escalates this request up to the server's
        ceiling (needed to pass live objects like stored models);
        ``timeout`` is the job's server-side deadline in seconds."""
        body = {"name": name, "function": function,
                "functionParameters": parameters or {},
                "description": description}
        if sandbox_mode:
            body["sandboxMode"] = sandbox_mode
        if timeout is not None:
            body["timeout"] = timeout
        return self.post(body)

    def run_projection(self, input_dataset: str, output_dataset: str,
                       fields: List[str]) -> Any:
        return self.post({"inputDatasetName": input_dataset,
                          "outputDatasetName": output_dataset,
                          "names": fields})

    run_histogram = run_projection

    def run_datatype(self, dataset_name: str,
                     types: Dict[str, str]) -> Any:
        return self.post({"datasetName": dataset_name, "types": types})

    def run_builder(self, train_dataset: str, test_dataset: str,
                    modeling_code: str, classifiers: List[str],
                    **extra: Any) -> Any:
        """``extra`` passes the out-of-core and placement knobs
        through: ``streaming=True``, ``meshParallel=True``,
        ``labelColumn=``, ``featureColumns=``,
        ``evaluationDatasetName=``, ``batchSize=``."""
        return self.post({
            "trainDatasetName": train_dataset,
            "testDatasetName": test_dataset,
            "modelingCode": modeling_code,
            "classifiersList": classifiers, **extra})


class Serve:
    """Handle for the resident serving plane (``/serve`` routes,
    docs/SERVING.md). Unlike :class:`Tool` verbs, ``predict`` here is
    SYNCHRONOUS — the response carries the tokens/predictions, no
    submit-then-poll. 429 (queue full) and 503 (session unavailable)
    surface as :class:`ApiError` with the matching status."""

    def __init__(self, http: _Http):
        self._http = http
        self._base = f"{API_PREFIX}/serve"

    def create(self, model_name: str, **options: Any) -> Dict[str, Any]:
        """Start a serving session for a fitted model. LM options:
        ``maxSlots``, ``cacheLen``, ``temperature``, ``topK``,
        ``topP``; both kinds: ``type`` ("lm"/"predict"),
        ``sliceDevices``."""
        _, payload = self._http.request(
            "POST", f"{self._base}/{model_name}", options)
        return payload

    def generate(self, model_name: str, prompt: List[int],
                 max_new_tokens: int = 32, seed: int = 0,
                 timeout: Optional[float] = None) -> Dict[str, Any]:
        body: Dict[str, Any] = {"prompt": list(prompt),
                                "maxNewTokens": max_new_tokens,
                                "seed": seed}
        if timeout is not None:
            body["timeout"] = timeout
        _, payload = self._http.request(
            "POST", f"{self._base}/{model_name}/predict", body)
        return payload

    def predict(self, model_name: str, x: Any,
                timeout: Optional[float] = None) -> List[Any]:
        body: Dict[str, Any] = {
            "x": x.tolist() if hasattr(x, "tolist") else list(x)}
        if timeout is not None:
            body["timeout"] = timeout
        _, payload = self._http.request(
            "POST", f"{self._base}/{model_name}/predict", body)
        return payload["predictions"]

    def stats(self, model_name: Optional[str] = None) -> Any:
        path = self._base if model_name is None \
            else f"{self._base}/{model_name}"
        _, payload = self._http.request("GET", path)
        return payload["result"] if model_name is None else payload

    def delete(self, model_name: str) -> Dict[str, Any]:
        _, payload = self._http.request(
            "DELETE", f"{self._base}/{model_name}")
        return payload


_TOOL_ROUTES = {
    "dataset_csv": ("dataset", "csv"),
    "dataset_generic": ("dataset", "generic"),
    "model_tensorflow": ("model", "tensorflow"),
    "model_scikitlearn": ("model", "scikitlearn"),
    "model_jax": ("model", "jax"),
    "train_tensorflow": ("train", "tensorflow"),
    "train_scikitlearn": ("train", "scikitlearn"),
    "train_jax": ("train", "jax"),
    "tune_tensorflow": ("tune", "tensorflow"),
    "tune_scikitlearn": ("tune", "scikitlearn"),
    "tune_jax": ("tune", "jax"),
    "evaluate_tensorflow": ("evaluate", "tensorflow"),
    "evaluate_scikitlearn": ("evaluate", "scikitlearn"),
    "evaluate_jax": ("evaluate", "jax"),
    "predict_tensorflow": ("predict", "tensorflow"),
    "predict_scikitlearn": ("predict", "scikitlearn"),
    "predict_jax": ("predict", "jax"),
    "explore_histogram": ("explore", "histogram"),
    "explore_tensorflow": ("explore", "tensorflow"),
    "explore_scikitlearn": ("explore", "scikitlearn"),
    "transform_projection": ("transform", "projection"),
    "transform_datatype": ("transform", "dataType"),
    "transform_tensorflow": ("transform", "tensorflow"),
    "transform_scikitlearn": ("transform", "scikitlearn"),
    "function_python": ("function", "python"),
    "builder_sparkml": ("builder", "sparkml"),
}


class Context:
    """Entry point, mirroring the reference client's
    ``Context(cluster_ip)`` (README.md:96-101). Accepts a full base URL
    or a bare host/IP (port 5000 assumed, like the reference's
    gateway-port convention)."""

    def __init__(self, cluster: str, timeout: float = 300.0):
        if not cluster.startswith("http"):
            cluster = f"http://{cluster}:5000"
        self._http = _Http(cluster, timeout=timeout)
        for attr, (service, tool) in _TOOL_ROUTES.items():
            setattr(self, attr, Tool(self._http, service, tool))
        self.serve = Serve(self._http)

    def tool(self, service: str, tool: str) -> Tool:
        return Tool(self._http, service, tool)

    def health(self) -> Dict[str, Any]:
        _, payload = self._http.request("GET", "/health")
        return payload

    def observe(self, name: str, seq: int = 0,
                timeout: float = 25.0) -> Dict[str, Any]:
        """Long-poll the change feed for one collection (the Observe
        service; reference README.md:81)."""
        _, payload = self._http.request(
            "GET", f"{API_PREFIX}/observe/{name}",
            params={"seq": seq, "timeout": timeout})
        return payload["result"]

    def trace(self, name: str, chrome: bool = False) -> Dict[str, Any]:
        """The server-side span tree of a job (or a
        ``serve/{model}/{seq}`` request). ``chrome=True`` returns
        Chrome/Perfetto ``trace_event`` JSON instead — dump it to a
        file and drag it into ui.perfetto.dev
        (docs/OBSERVABILITY.md)."""
        params = {"format": "chrome"} if chrome else None
        _, payload = self._http.request(
            "GET", f"{API_PREFIX}/observability/trace/{name}",
            params=params)
        return payload

    def timeline(self, name: str) -> Dict[str, Any]:
        """Per-step training telemetry of a job: the step-window ring
        (dt, examples/s, loss, retrace flags) plus p50/p90/p99
        summary (docs/OBSERVABILITY.md)."""
        _, payload = self._http.request(
            "GET", f"{API_PREFIX}/observability/timeline/{name}")
        return payload

    def cluster(self) -> Dict[str, Any]:
        """The cluster resource sampler's bounded time-series rings:
        per-device HBM watermarks, arena occupancy, slice
        fragmentation, queue depths and host RSS
        (docs/OBSERVABILITY.md "Cluster monitor")."""
        _, payload = self._http.request(
            "GET", f"{API_PREFIX}/observability/cluster")
        return payload

    def alerts(self) -> Dict[str, Any]:
        """SLO objectives plus currently-firing alerts and the recent
        firing/resolved transition history
        (docs/OBSERVABILITY.md "Cluster monitor")."""
        _, payload = self._http.request(
            "GET", f"{API_PREFIX}/observability/alerts")
        return payload

    def autoscaler(self) -> Dict[str, Any]:
        """Elastic slice-autoscaler state: resize/rollback counters,
        the last pressure signals it acted on, and the per-job
        backoff/dead-letter ledger (docs/SCALING.md "Elastic
        autoscaling")."""
        _, payload = self._http.request(
            "GET", f"{API_PREFIX}/observability/autoscaler")
        return payload

    def perf(self, name: Optional[str] = None) -> Dict[str, Any]:
        """Roofline perf report (docs/OBSERVABILITY.md "Roofline &
        perf reports"): without ``name``, the platform peaks and the
        jobs with reports; with ``name``, the job's or serving
        session's achieved-vs-peak block (mfu, TFLOPs/chip, GB/s/chip,
        boundBy)."""
        path = f"{API_PREFIX}/observability/perf"
        if name:
            path += f"/{name}"
        _, payload = self._http.request("GET", path)
        return payload

    def memory(self, name: Optional[str] = None) -> Dict[str, Any]:
        """HBM attribution ledger (docs/OBSERVABILITY.md "HBM
        attribution & X-ray"): without ``name``, per-owner byte totals
        (arena, train-state, serving-params, kv-cache, snapshot),
        device bytes-in-use and the unattributed remainder, plus the
        retrace/implicit-transfer sentinel counters; with ``name``,
        only the ledger rows tagged with that job / model / serving
        session."""
        path = f"{API_PREFIX}/observability/memory"
        if name:
            path += f"/{name}"
        _, payload = self._http.request("GET", path)
        return payload

    def compile_report(self, name: str) -> Dict[str, Any]:
        """Compiled-artifact X-ray of a job (docs/OBSERVABILITY.md
        "HBM attribution & X-ray"): per-program XLA
        ``memory_analysis()`` extracts (argument/output/temp/code
        bytes, peak estimate) and ``cost_analysis()`` flops/bytes,
        captured when the job's train step compiled in this
        process."""
        _, payload = self._http.request(
            "GET", f"{API_PREFIX}/observability/compile/{name}")
        return payload

    def incidents(self) -> list:
        """Captured incident debug bundles (docs/OBSERVABILITY.md
        "Incidents & flight recorder"): id, trigger, creation time
        and size of each bundle the flight recorder committed."""
        _, payload = self._http.request(
            "GET", f"{API_PREFIX}/observability/incidents")
        return payload["result"]

    def incident(self, incident_id: str) -> Dict[str, Any]:
        """One bundle's manifest: trigger, context, implicated
        job/trace names, the evidence files with their sizes, and
        the build pin of what was running."""
        _, payload = self._http.request(
            "GET",
            f"{API_PREFIX}/observability/incidents/{incident_id}")
        return payload

    def incident_download(self, incident_id: str) -> bytes:
        """The whole bundle as an uncompressed tar stream — feed it
        to ``scripts/incident_diff.py`` or untar it for postmortem
        reading."""
        _, payload = self._http.request(
            "GET",
            f"{API_PREFIX}/observability/incidents/{incident_id}"
            f"/download")
        return payload

    def capture_incident(self, **context: Any) -> Dict[str, Any]:
        """Manual on-demand capture (bypasses the trigger cooldown);
        returns the committed bundle's manifest. Keyword arguments
        become the manifest's ``context`` — pass ``job=``/``model=``
        to pull that name's trace/timeline/compile evidence in, or
        ``profile=True`` to request a deep-profiling window
        (``LO_INCIDENT_PROFILE_S``)."""
        _, payload = self._http.request(
            "POST", f"{API_PREFIX}/observability/incidents",
            body=dict(context))
        return payload

    def healthz(self) -> Dict[str, Any]:
        """Readiness probe: raises on 503 (draining or a
        page-severity SLO alert firing); returns the status body on
        200."""
        _, payload = self._http.request("GET", "/healthz")
        return payload

    def wait(self, name: str, timeout: float = 600.0) -> Dict[str, Any]:
        """Observe-driven wait on any collection's ``finished`` flag
        (event-driven; falls back to the poll in Tool.wait only through
        the observe timeout loop)."""
        deadline = time.monotonic() + timeout
        seq = 0
        while time.monotonic() < deadline:
            result = self.observe(
                name, seq=seq,
                timeout=min(25.0, deadline - time.monotonic()))
            meta = result.get("metadata")
            if meta and meta.get("finished"):
                return meta
            seq = result["seq"]
        raise TimeoutError(f"{name} not finished after {timeout}s")
