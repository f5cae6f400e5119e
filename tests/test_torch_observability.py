"""The port's observability plane against the JAX package's, on the CPU
(``learningorchestra_tpu_torch/observability``, docs/OBSERVABILITY.md).

The same inputs go through both packages' modules: histograms (bucket
counts and the Prometheus text, byte for byte), the span tracer's tree
and its Chrome ``trace_event`` export, the timeline's summary
percentiles, the event log and its rotation, and the label escaper. Over
REST, a small ``NeuralModel`` and a 2-layer LM train job in each package
give the same span-name tree (the JAX ``compile`` span aside: the port
compiles nothing) and the same timeline fields (the bytes-derived
roofline fields aside: torch has no bytes-accessed count); a serving
request gives the same request spans; ``/metrics`` has the JAX server's
keys and Prometheus series, less those of modules not ported yet (each
named below); a hostile route name is escaped; and a failing or slow
``trace_export`` never fails a job. Every comparison is exact: the
plane's arithmetic is the JAX package's.
"""

import json
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.observability import export as jax_export
from learningorchestra_tpu.observability import hist as jax_hist
from learningorchestra_tpu.observability import timeline as jax_timeline
from learningorchestra_tpu.observability import trace as jax_trace
from learningorchestra_tpu.services import server as jax_server
from learningorchestra_tpu_torch import observability as obs
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.models.transformer import LanguageModel
from learningorchestra_tpu_torch.observability import export, hist
from learningorchestra_tpu_torch.observability import timeline, trace
from learningorchestra_tpu_torch.services import faults
from learningorchestra_tpu_torch.services import server as port_server
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
LM_CFG = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, max_len=64)
DENSE = [{"kind": "dense", "units": 4, "activation": "relu"},
         {"kind": "dense", "units": 2, "activation": "softmax"}]
# /metrics blocks of modules the port has not ported yet: live
# migration, the autoscaler and the executable cache (the card lease's
# meshScheduler and meshSecondsByPool, sweep fusion's, the feature
# cache's and the device arena's blocks are ported)
UNPORTED_KEYS = {"migrationStats", "autoscaler", "executableCache"}
# their Prometheus series, and three that the port cannot have: the
# compile histogram (it compiles nothing), the bandwidth gauge (torch
# has no bytes-accessed count of a train step) and the unattributed
# bytes gauge on the CPU (no allocator count there; on a card it is
# emitted)
UNPORTED_SERIES = {
    "lo_executable_cache_hits_total", "lo_executable_cache_misses_total",
    "lo_autoscaler_resizes_total",
    "lo_autoscaler_rollbacks_total", "lo_autoscaler_dead_lettered_total",
    "lo_compile_seconds", "lo_hbm_bw_util_frac",
    "lo_hbm_unattributed_bytes"}
BYTES_FIELDS = {"gbPerSecPerChip", "arithmeticIntensity", "hbmBwUtil",
                "boundBy"}


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (trace, timeline, hist, jax_trace, jax_timeline, jax_hist):
        mod.reset()
    faults.reset()
    yield
    for mod in (trace, timeline, hist, jax_trace, jax_timeline, jax_hist):
        mod.reset()
    faults.reset()


@pytest.fixture()
def configs(tmp_path):
    """Both packages' plane configs, rooted in ``tmp_path``."""
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax")))
    obs.set_config(Config(home=str(tmp_path / "port")))
    yield
    jax_config.reset_config()
    obs.reset_config()


def _tree_shape(doc):
    """A span tree without its times and ids: (name, attrs, children)."""
    def one(span):
        return (span["name"], span["attrs"],
                [one(c) for c in span["children"]])
    return [one(s) for s in doc["spans"]]


def _pairs(doc, drop=()):
    """Sorted (span name, parent span name) pairs of a span tree."""
    out = []

    def walk(span, parent):
        if span["name"] not in drop:
            out.append((span["name"], parent))
        for child in span["children"]:
            walk(child, span["name"])

    for root in doc["spans"]:
        walk(root, None)
    return sorted(out, key=lambda p: (p[0], p[1] or ""))


# ----------------------------------------------------------------------
# histograms
# ----------------------------------------------------------------------
SAMPLES = {
    "edges": [0.001, 0.0025, 0.005, 1.0, 2.5, 300.0, 300.0001],
    "spread": list(np.random.default_rng(3).exponential(0.2, 200)),
    "outliers": [0.0, 1e-9, 7.5, 61.0, 1e6, float("nan"), 0.75],
}


@pytest.mark.parametrize("case", sorted(SAMPLES))
def test_histogram_buckets_and_prometheus_text_match_jax(case):
    for value in SAMPLES[case]:
        hist.observe("lo_dispatch_seconds", value)
        jax_hist.observe("lo_dispatch_seconds", value)
        hist.observe("lo_serving_request_seconds_tenant_a", value / 3)
        jax_hist.observe("lo_serving_request_seconds_tenant_a", value / 3)
    assert hist.snapshot_all() == jax_hist.snapshot_all()
    assert hist.DEFAULT_BUCKETS == jax_hist.DEFAULT_BUCKETS
    assert hist.prometheus_lines(port_server.escape_label_value) == \
        jax_hist.prometheus_lines(jax_server.escape_label_value)
    for q in (0.5, 0.9, 0.99):
        assert hist.get("lo_dispatch_seconds").quantile(q) == \
            jax_hist.get("lo_dispatch_seconds").quantile(q)


# ----------------------------------------------------------------------
# spans and their exports
# ----------------------------------------------------------------------
def _drive_tracer(lib):
    """One trace: nested spans, an error, retro spans parented by id."""
    with lib.span("job", trace="t1", pool="p"):
        with lib.span("dataLoad") as sp:
            sp.set(rows=3)
        with pytest.raises(ValueError):
            with lib.span("attempt", attempt=1):
                raise ValueError("x")
        now = time.monotonic()
        root = lib.add("request", "t1", now - 0.2, now, model="m")
        lib.add("queueWait", "t1", now - 0.2, now - 0.1, parent=root)
        lib.annotate(done=True)
    return lib.tree("t1")


def test_span_tree_matches_jax(configs):
    ours, theirs = _drive_tracer(trace), _drive_tracer(jax_trace)
    assert _tree_shape(ours) == _tree_shape(theirs)
    assert ours["spanCount"] == theirs["spanCount"] == 5
    assert trace.known_traces() == jax_trace.known_traces() == ["t1"]
    assert set(trace.durations_by_name("t1")) == \
        set(jax_trace.durations_by_name("t1"))


def test_chrome_trace_schema_matches_jax(configs):
    _drive_tracer(trace)
    _drive_tracer(jax_trace)
    ours, theirs = export.chrome_trace("t1"), jax_export.chrome_trace("t1")
    assert ours["displayTimeUnit"] == theirs["displayTimeUnit"] == "ms"

    def schema(doc):
        return [(e["ph"], e["name"], sorted(e),
                 {k: v for k, v in e.get("args", {}).items()
                  if k != "name"})
                for e in doc["traceEvents"]]

    assert schema(ours) == schema(theirs)
    assert all(e["ts"] >= 0 and e["dur"] >= 0
               for e in ours["traceEvents"] if e["ph"] == "X")
    assert export.chrome_trace("nope") is None


def test_disabled_tracing_is_a_shared_noop(tmp_path):
    obs.set_config(Config(home=str(tmp_path), trace=False))
    try:
        with trace.span("job", trace="off") as sp:
            assert sp is trace.NOOP
            assert trace.span("inner") is trace.NOOP
        assert trace.add("x", "off", 0.0, 1.0) is None
        timeline.record("off", step=1, dt=0.1)
        assert trace.tree("off") is None and timeline.summary("off") is None
    finally:
        obs.reset_config()


# ----------------------------------------------------------------------
# the timeline
# ----------------------------------------------------------------------
def test_timeline_summary_percentiles_match_jax(configs):
    rng = np.random.default_rng(5)
    for lib in (timeline, jax_timeline):
        for i in range(37):
            lib.record("job", step=4 * (i + 1), dt=float(rng.random()),
                       examples_per_second=float(rng.random() * 1e3),
                       loss=float(rng.random()),
                       bad_steps=int(i % 5 == 0),
                       mfu=float(rng.random()) / 10,
                       tflopsPerSecPerChip=float(rng.random()) * 50)
        rng = np.random.default_rng(5)
    assert timeline.entries("job") == jax_timeline.entries("job")
    assert timeline.summary("job") == jax_timeline.summary("job")
    assert timeline.summary("never") is None


# ----------------------------------------------------------------------
# the event log
# ----------------------------------------------------------------------
def test_event_log_and_its_rotation_match_jax(tmp_path):
    logs = {name: str(tmp_path / name / "events.jsonl")
            for name in ("port", "jax")}
    jax_config.set_config(jax_config.Config(
        home=str(tmp_path / "jh"), event_log=logs["jax"],
        event_log_max_bytes=400))
    obs.set_config(Config(home=str(tmp_path / "ph"),
                          event_log=logs["port"], event_log_max_bytes=400))
    try:
        for lib in (export, jax_export):
            for i in range(12):
                lib.log_event("job", f"e{i}", trace_id="t", seq=i,
                              obj=object)

        def rows(path):
            out = []
            for p in (path + ".1", path):
                if os.path.exists(p):
                    out += [json.loads(ln) for ln in open(p)]
            for r in out:
                r.pop("ts")
            return out

        assert rows(logs["port"]) == rows(logs["jax"])
        assert os.path.exists(logs["port"] + ".1")
        assert export.read_tail(200).endswith("\n")
        assert [json.loads(ln)["name"] for ln in
                export.read_tail(1 << 20).splitlines()] == \
            [json.loads(ln)["name"] for ln in
             jax_export.read_tail(1 << 20).splitlines()]
    finally:
        jax_config.reset_config()
        obs.reset_config()


HOSTILE = ['plain', 'quo"te', 'back\\slash', 'new\nline', '\\"\n',
           'serve/m/1']


@pytest.mark.parametrize("value", HOSTILE)
def test_label_escaping_matches_jax(value):
    assert port_server.escape_label_value(value) == \
        jax_server.escape_label_value(value)


def test_prometheus_survives_hostile_route_names(tmp_path):
    api = Api(ServiceContext(Config(home=str(tmp_path), monitor=False,
                                    incidents=False), device="cpu"))
    try:
        api.record_metrics("GET", f'{PREFIX}/weird"svc\\x\ny/end', 200,
                           0.001)
        text = api.metrics_prometheus().decode()
        bad = [ln for ln in text.splitlines() if "weird" in ln]
        assert bad
        for ln in bad:
            assert r'\"' in ln and r'\\' in ln and r'\n' in ln
        for ln in text.splitlines():
            if ln and not ln.startswith("#"):
                float(ln.rsplit(" ", 1)[1])
    finally:
        api.ctx.close()


def _wait(api, name, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        meta = api.ctx.catalog.get_metadata(name) or {}
        if meta.get("finished"):
            return meta
        time.sleep(0.05)
    raise AssertionError(f"{name} never finished: "
                         f"{api.ctx.catalog.get_documents(name)[-1:]}")


def test_failing_or_slow_trace_export_never_fails_the_job(tmp_path):
    """An armed ``trace_export`` fault (raise, then latency) costs only
    the faulted event lines; the jobs finish."""
    log = tmp_path / "events.jsonl"
    api = Api(ServiceContext(Config(
        home=str(tmp_path / "h"), event_log=str(log), sandbox_mode="trusted",
        fault_inject="trace_export:2:raise", monitor=False), device="cpu"))
    try:
        for i, spec in enumerate(("trace_export:2:raise",
                                  "trace_export:1:latency:0.2")):
            api.ctx.config.fault_inject = spec
            faults.reset()
            st, body, _ = api.dispatch(
                "POST", f"{PREFIX}/function/python", {},
                {"name": f"f{i}", "functionParameters": {},
                 "function": f"response = {{'v': {i}}}"})
            assert st == 201, body
            assert _wait(api, f"f{i}")["finished"]
        rows = [json.loads(ln) for ln in log.read_text().splitlines()]
        assert {"queued", "start", "finished"} <= {r["name"] for r in rows}
    finally:
        api.ctx.close()


# ----------------------------------------------------------------------
# REST: the same jobs and requests in both packages
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def rest(tmp_path_factory):
    """A NeuralModel and a 2-layer LM trained over REST (2 epochs,
    checkpointed) in both packages, then one LM serving request each,
    with pinned peaks so the roofline carries ``mfu``. Yields the two
    ``Api``s after the work (their servers' state intact)."""
    root = tmp_path_factory.mktemp("rest")
    saved = {k: os.environ.get(k) for k in (
        "LO_COMPUTE_DTYPE", "LO_PEAK_TFLOPS_PER_CHIP", "LO_PEAK_HBM_GBPS")}
    os.environ.update(LO_COMPUTE_DTYPE="float32",
                      LO_PEAK_TFLOPS_PER_CHIP="0.05", LO_PEAK_HBM_GBPS="1")
    jax_config.set_config(jax_config.Config(
        home=str(root / "jax"), compute_dtype="float32",
        serve_max_wait_ms=1.0))
    from learningorchestra_tpu.models.transformer import \
        LanguageModel as JaxLanguageModel
    from learningorchestra_tpu.services.server import Api as JaxApi

    for mod in (trace, timeline, hist, jax_trace, jax_timeline, jax_hist):
        mod.reset()
    jax_api = JaxApi()
    port_api = Api(ServiceContext(Config(home=str(root / "port")),
                                  device="cpu"))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    tokens = rng.integers(1, 97, (32, 16)).astype(np.int32)
    tree = weights.init_params(LM_CFG, seed=3)
    jlm = JaxLanguageModel(**LM_CFG, attention="dot")
    jlm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    plm = LanguageModel(**LM_CFG, device="cpu")
    plm.set_params(weights.params_from_flax(tree))
    out = {}
    try:
        for name, api, lm in (("jax", jax_api, jlm),
                              ("port", port_api, plm)):
            api.ctx.artifacts.save({"x": x, "y": y, "tokens": tokens},
                                   "d", "function/python")
            api.ctx.catalog.create_collection("d", "function/python", {})
            api.ctx.catalog.mark_finished("d")
            api.ctx.artifacts.save(lm, "lm", "model/tensorflow")
            api.ctx.catalog.create_collection("lm", "model/tensorflow", {
                "modulePath": "learningorchestra_tpu.models",
                "class": "LanguageModel", "classParameters": LM_CFG})
            api.ctx.catalog.mark_finished("lm")
            st, body, _ = api.dispatch(
                "POST", f"{PREFIX}/model/tensorflow", {},
                {"modelName": "m", "modulePath":
                 "learningorchestra_tpu.models", "class": "NeuralModel",
                 "classParameters": {"layer_configs": DENSE}})
            assert st == 201, body
            _wait(api, "m")
            for job, model, params in (
                    ("t", "m", {"x": "$d.x", "y": "$d.y", "epochs": 2,
                                "batch_size": 16, "shuffle": False,
                                "checkpoint": True}),
                    ("lm_t", "lm", {"x": "$d.tokens", "epochs": 2,
                                    "batch_size": 8, "shuffle": False,
                                    "checkpoint": True})):
                st, body, _ = api.dispatch(
                    "POST", f"{PREFIX}/train/tensorflow", {},
                    {"name": job, "modelName": model, "method": "fit",
                     "methodParameters": params})
                assert st == 201, body
                _wait(api, job, timeout=300)
                api.ctx.jobs.wait(job, timeout=300)
            st, body, _ = api.dispatch(
                "POST", f"{PREFIX}/serve/lm_t", {},
                {"type": "lm", "maxSlots": 2, "cacheLen": 32})
            assert st == 201, body
            st, body, _ = api.dispatch(
                "POST", f"{PREFIX}/serve/lm_t/predict", {},
                {"prompt": [3, 4, 5], "maxNewTokens": 4})
            assert st == 200, body
            if api.ctx.monitor is not None:
                api.ctx.monitor.sample_once()
            doc = {}
            for key, path, params in (
                    ("trace", "/observability/trace/t", {}),
                    ("lmTrace", "/observability/trace/lm_t", {}),
                    ("timeline", "/observability/timeline/t", {}),
                    ("lmTimeline", "/observability/timeline/lm_t", {}),
                    ("request", "/observability/trace/serve/lm_t/1", {}),
                    ("perf", "/observability/perf/lm_t", {}),
                    ("servingPerf", "/observability/perf/m", {})):
                doc[key] = api.dispatch("GET", PREFIX + path, params, None)
            doc["metrics"] = api.dispatch("GET", "/metrics", {}, None)[1]
            doc["prometheus"] = api.dispatch(
                "GET", "/metrics", {"format": "prometheus"}, None)[1]
            out[name] = doc
        yield out
    finally:
        jax_api.ctx.close()
        port_api.ctx.close()
        jax_config.reset_config()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("key", ["trace", "lmTrace"])
def test_rest_train_span_tree_matches_jax(rest, key):
    (st_j, ours_j, _), (st_p, ours_p, _) = rest["jax"][key], \
        rest["port"][key]
    assert st_j == st_p == 200
    want = _pairs(ours_j, drop=("compile",))
    assert _pairs(ours_p) == want
    names = [n for n, _ in want]
    assert names.count("epoch") == names.count("checkpointCommit") == 2
    assert ("epoch", "attempt") in want and ("submit", None) in want


@pytest.mark.parametrize("key", ["timeline", "lmTimeline"])
def test_rest_train_timeline_fields_match_jax(rest, key):
    (_, jax_doc, _), (_, port_doc, _) = rest["jax"][key], rest["port"][key]
    jw, pw = jax_doc["timeline"], port_doc["timeline"]
    assert len(jw) == len(pw) == 2
    # the JAX package's first window holds its compile and carries no
    # roofline (its steady state starts after it); the port compiles
    # nothing, so each of its windows carries one
    roofline = {"mfu", "tflopsPerSecPerChip"} | BYTES_FIELDS
    assert set(pw[0]) - roofline == set(jw[0]) - roofline
    assert set(pw[1]) == set(jw[1]) - BYTES_FIELDS
    for a, b in zip(jw, pw):
        assert a["step"] == b["step"] and b["retrace"] is False
        assert b["mfu"] >= 0 and b["tflopsPerSecPerChip"] >= 0
    js, ps = jax_doc["summary"], port_doc["summary"]
    assert set(ps) == set(js)
    assert set(ps["perf"]) == set(js["perf"]) - BYTES_FIELDS
    assert ps["windows"] == js["windows"] and ps["steps"] == js["steps"]


def test_rest_perf_report_matches_jax(rest):
    (_, jp, _), (_, pp, _) = rest["jax"]["perf"], rest["port"]["perf"]
    assert jp["kind"] == pp["kind"] == "serving"
    # the decode roofline keeps its analytic bytes in both
    assert set(pp) == set(jp) and set(pp["perf"]) == set(jp["perf"])
    assert pp["platform"]["peakTflopsPerChip"] == \
        jp["platform"]["peakTflopsPerChip"] == 0.05
    assert rest["port"]["servingPerf"][0] == 404 == \
        rest["jax"]["servingPerf"][0]


def test_rest_serving_request_spans_match_jax(rest):
    (st_j, jd, _), (st_p, pd, _) = rest["jax"]["request"], \
        rest["port"]["request"]
    assert st_j == st_p == 200
    assert _pairs(pd) == _pairs(jd)
    (req,) = pd["spans"]
    assert req["name"] == "request" and req["attrs"]["model"] == "lm_t"


def test_metrics_keys_are_the_jax_servers_less_the_unported(rest):
    jax_keys, port_keys = set(rest["jax"]["metrics"]), \
        set(rest["port"]["metrics"])
    assert port_keys == jax_keys - UNPORTED_KEYS
    assert not port_keys & UNPORTED_KEYS
    for key in ("latencyHistograms", "gateway", "perf", "xray",
                "cluster", "alerts", "incidents", "serving"):
        assert key in port_keys
    jm, pm = rest["jax"]["metrics"], rest["port"]["metrics"]
    assert set(pm["gateway"]) == set(jm["gateway"])
    assert set(pm["xray"]) == set(jm["xray"])
    assert set(pm["serving"]) == set(jm["serving"])
    assert set(pm["featureCache"]) == set(jm["featureCache"])
    assert set(pm["arena"]) == set(jm["arena"])
    assert set(pm["meshScheduler"]) == set(jm["meshScheduler"])
    assert set(pm["latencyHistograms"]) == \
        set(jm["latencyHistograms"]) - UNPORTED_SERIES


def _series(text):
    return {m.group(1): m.group(2) for m in re.finditer(
        r"^# TYPE (\S+) (\S+)$", text.decode(), re.M)}


def test_prometheus_series_are_the_jax_servers_less_the_unported(rest):
    jax_series, port_series = _series(rest["jax"]["prometheus"]), \
        _series(rest["port"]["prometheus"])
    want = {k: v for k, v in jax_series.items()
            if k not in UNPORTED_SERIES}
    assert port_series == want
