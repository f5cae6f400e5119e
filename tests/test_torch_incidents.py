"""The port's flight recorder and profiler gate
(``learningorchestra_tpu_torch/observability/incidents.py``) against the
JAX package's, on the CPU.

The same rings (a trace, a timeline) and the same captures go through
both recorders: the bundle's sections, manifest keys, implicated names
and (empty) errors are equal; the per-trigger cooldown, the keep bound
and the tar download behave the same. The port's ``ProfilerGate`` drives
``torch.profiler`` (CPU activity here) and writes a Chrome trace; a
profiler that fails to start answers an error and leaves the gate free.
Over REST: ``/observability/incidents`` (list, manifest, tar, manual
capture, 404 with ``LO_INCIDENTS=0``), ``/profile``'s lifecycle, and the
triggers of a dead-lettered job, a health rollback and a serving-latency
page (with its profiler window).
"""

import io
import json
import os
import tarfile
import time

import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.observability import incidents as jax_incidents
from learningorchestra_tpu.observability import timeline as jax_timeline
from learningorchestra_tpu.observability import trace as jax_trace
from learningorchestra_tpu.observability import xray as jax_xray
from learningorchestra_tpu_torch import observability as obs
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.observability import incidents, timeline
from learningorchestra_tpu_torch.observability import trace
from learningorchestra_tpu_torch.runtime import health as health_lib
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
SECTIONS = {"cluster.json", "alerts.json", "memory.json", "perf.json",
            "metrics.json", "eventlog.tail", "config.json",
            "versions.json", "manifest.json"}


@pytest.fixture(autouse=True)
def _fresh():
    # the JAX package's compiled-artifact reports of other tests in this
    # process would ride into its bundles
    for lib in (trace, timeline, jax_trace, jax_timeline, jax_xray):
        lib.reset()
    yield
    for lib in (trace, timeline, jax_trace, jax_timeline):
        lib.reset()
    for lib in (incidents, jax_incidents):
        lib.set_recorder(None)
    jax_config.reset_config()
    obs.reset_config()


@pytest.fixture()
def recorders(tmp_path):
    """A recorder of each package over the same rings and collectors."""
    fields = dict(incident_keep=3, incident_cooldown_s=300.0,
                  event_log=str(tmp_path / "events.jsonl"))
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "j"),
                                            **fields))
    obs.set_config(Config(home=str(tmp_path / "p"), **fields))
    for tr, tl in ((trace, timeline), (jax_trace, jax_timeline)):
        with tr.span("job", trace="t"):
            with tr.span("epoch", epoch=0):
                pass
        tl.record("t", step=4, dt=0.5, loss=1.0)

    def stats():
        return {"jobLifecycle": {"retries": 0}}

    made = {"port": incidents.FlightRecorder(
                str(tmp_path / "p"), cluster_snapshot=lambda: {"n": 1},
                alerts_snapshot=lambda: {"alerts": []},
                stats_snapshot=stats, active_names=lambda: ["t"]),
            "jax": jax_incidents.FlightRecorder(
                str(tmp_path / "j"), cluster_snapshot=lambda: {"n": 1},
                alerts_snapshot=lambda: {"alerts": []},
                stats_snapshot=stats, active_names=lambda: ["t"])}
    yield made
    for rec in made.values():
        rec.close()


def test_bundle_sections_and_manifest_match_jax(recorders):
    got = {name: rec.capture("manual", {"job": "t", "note": 1})
           for name, rec in recorders.items()}
    ours, theirs = got["port"], got["jax"]
    assert set(ours) == set(theirs)
    assert ours["errors"] == theirs["errors"] == {}
    assert set(ours["files"]) == set(theirs["files"])
    assert SECTIONS - {"manifest.json"} <= set(ours["files"])
    assert {"trace/t.json", "timeline/t.json"} <= set(ours["files"])
    assert ours["implicated"] == theirs["implicated"]
    assert ours["context"] == theirs["context"] == {"job": "t", "note": 1}
    assert ours["trigger"] == "manual" and ours["schema"] == 1
    path = os.path.join(recorders["port"].root, ours["id"])
    assert set(os.listdir(path)) >= {"manifest.json", "trace", "timeline"}
    with open(os.path.join(path, "versions.json")) as f:
        versions = json.load(f)
    assert versions["torchVersion"] == torch.__version__
    assert versions["backend"] == "cpu" and "cudaVersion" in versions


def test_cooldown_keep_bound_and_tar_match_jax(recorders):
    for name, rec in recorders.items():
        assert rec.trigger("slo:servingP99") is True
        assert rec.trigger("slo:servingP99") is False   # cooled down
        assert rec.trigger("job:deadLettered", job="t") is True
        deadline = time.monotonic() + 30
        while rec.stats()["captured"] < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        for _ in range(3):
            rec.capture("manual")
    ours, theirs = recorders["port"], recorders["jax"]
    assert [b["trigger"] for b in ours.list()] == \
        [b["trigger"] for b in theirs.list()]
    assert len(ours.list()) == 3   # LO_INCIDENT_KEEP
    for key in ("captured", "byTrigger", "dropped", "captureErrors",
                "bundles"):
        assert ours.stats()[key] == theirs.stats()[key]
    iid = ours.list()[-1]["id"]
    with tarfile.open(fileobj=io.BytesIO(ours.tar_bytes(iid))) as tar:
        names = tar.getnames()
    assert names and all(n.startswith(iid) for n in names)
    assert f"{iid}/manifest.json" in names
    assert ours.tar_bytes("nope") is None and ours.manifest("../x") is None


def test_prune_dirs_matches_jax(tmp_path):
    for lib, root in ((incidents, tmp_path / "p"),
                      (jax_incidents, tmp_path / "j")):
        for name in ("20260101-a", "20260102-b", "20260103-c", ".tmp-x"):
            os.makedirs(root / name)
        assert lib.prune_dirs(str(root), 2) == 1
    assert sorted(os.listdir(tmp_path / "p")) == \
        sorted(os.listdir(tmp_path / "j"))


def test_profiler_gate_writes_a_chrome_trace(tmp_path):
    gate = incidents.ProfilerGate()
    assert gate.stop() is None
    assert gate.try_start(str(tmp_path / "a")) is True
    assert gate.try_start(str(tmp_path / "b")) is False
    torch.ones(64, 64) @ torch.ones(64, 64)
    assert gate.stop() == str(tmp_path / "a")
    with open(tmp_path / "a" / "trace.json") as f:
        doc = json.load(f)
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
    assert gate.active() is None
    assert gate.try_start(str(tmp_path / "c"), max_seconds=0.2) is True
    deadline = time.monotonic() + 10
    while gate.active() is not None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert gate.last_auto_stop()["dir"] == str(tmp_path / "c")
    assert os.path.exists(tmp_path / "c" / "trace.json")


def test_a_profiler_that_fails_to_start_answers_an_error(tmp_path,
                                                         monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    api = Api(ServiceContext(Config(home=str(tmp_path), monitor=False),
                             device="cpu"))
    try:
        st, body, _ = api.dispatch("POST", f"{PREFIX}/profile", {},
                                   {"action": "start"})
        assert st == 500 and "profiler unavailable" in body["result"]
        assert api.ctx.profiler_gate.active() is None
    finally:
        api.ctx.close()


@pytest.fixture()
def api(tmp_path):
    a = Api(ServiceContext(Config(
        home=str(tmp_path), monitor_interval_ms=3_600_000.0,
        event_log=str(tmp_path / "events.jsonl"), sandbox_mode="trusted",
        incident_profile_s=0.3, slo_serving_p99_ms=50.0,
        slo_fast_window_s=1.0, slo_slow_window_s=2.0), device="cpu"))
    yield a
    a.ctx.close()


def test_profile_route_lifecycle(api):
    call = api.dispatch
    assert call("POST", f"{PREFIX}/profile", {}, {"action": "stop"})[0] == 406
    assert call("POST", f"{PREFIX}/profile", {}, {"action": "x"})[0] == 406
    st, started, _ = call("POST", f"{PREFIX}/profile", {},
                          {"action": "start"})
    assert st == 201
    assert call("POST", f"{PREFIX}/profile", {},
                {"action": "start"})[0] == 406
    assert call("GET", f"{PREFIX}/profile", {}, None)[1]["active"] is True
    st, stopped, _ = call("POST", f"{PREFIX}/profile", {},
                          {"action": "stop"})
    assert st == 200 and stopped == {"result": started["result"],
                                     "files": 1}
    st, listing, _ = call("GET", f"{PREFIX}/profile", {}, None)
    assert listing == {"active": False,
                       "traces": [os.path.basename(started["result"])]}
    assert call("POST", f"{PREFIX}/profile", {},
                {"action": "start"})[0] == 201
    assert call("POST", f"{PREFIX}/profile", {},
                {"action": "stop"})[0] == 200


def _bundle(api, trigger, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st, listed, _ = api.dispatch(
            "GET", f"{PREFIX}/observability/incidents", {}, None)
        found = [b for b in listed["result"] if b["trigger"] == trigger]
        if found:
            return found[-1]
        time.sleep(0.05)
    raise AssertionError(f"no {trigger} bundle: {listed}")


def test_incident_routes(api):
    st, manifest, _ = api.dispatch(
        "POST", f"{PREFIX}/observability/incidents", {}, {"job": "x"})
    assert st == 201 and manifest["trigger"] == "manual"
    assert SECTIONS - {"manifest.json"} <= set(manifest["files"])
    assert manifest["errors"] == {}
    st, listed, _ = api.dispatch(
        "GET", f"{PREFIX}/observability/incidents", {}, None)
    assert [b["id"] for b in listed["result"]] == [manifest["id"]]
    st, again, _ = api.dispatch(
        "GET", f"{PREFIX}/observability/incidents/{manifest['id']}", {},
        None)
    assert st == 200 and again["id"] == manifest["id"]
    st, data, ctype = api.dispatch(
        "GET", f"{PREFIX}/observability/incidents/{manifest['id']}/"
               f"download", {}, None)
    assert st == 200 and ctype == "application/x-tar"
    tarfile.open(fileobj=io.BytesIO(data)).close()
    assert api.dispatch("GET", f"{PREFIX}/observability/incidents/nope",
                        {}, None)[0] == 404
    text = api.metrics_prometheus().decode()
    assert 'lo_incidents_total{trigger="manual"} 1' in text
    assert "lo_incident_bundles 1" in text
    assert f'torch_version="{torch.__version__}"' in text


def test_incidents_off_routes_404(tmp_path):
    api = Api(ServiceContext(Config(home=str(tmp_path), incidents=False,
                                    monitor=False), device="cpu"))
    try:
        assert api.ctx.incidents is None
        st, body, _ = api.dispatch(
            "GET", f"{PREFIX}/observability/incidents", {}, None)
        assert st == 404 and "LO_INCIDENTS=0" in body["result"]
        assert "incidents" not in api.metrics()
    finally:
        api.ctx.close()


def test_failure_triggers_capture_bundles(api):
    # a dead-lettered job
    st, body, _ = api.dispatch(
        "POST", f"{PREFIX}/function/python", {},
        {"name": "bad", "functionParameters": {},
         "function": "raise ValueError('boom')"})
    assert st == 201, body
    dead = _bundle(api, "job:deadLettered")
    manifest = api.ctx.incidents.manifest(dead["id"])
    assert manifest["context"]["job"] == "bad"
    assert "trace/bad.json" in manifest["files"]
    # a health rollback, through the context's listener
    health_lib.record("rollbacks")
    _bundle(api, "health:rollback")
    # a serving-latency page records a profiler window into its bundle
    w = api.ctx.monitor.watchdog
    from learningorchestra_tpu_torch.observability import hist

    t0 = time.time()
    w.evaluate(now=t0)
    for _ in range(10):
        hist.observe("lo_serving_request_seconds", 0.5)
    w.evaluate(now=t0 + 0.5)
    page = _bundle(api, "slo:servingP99")
    manifest = api.ctx.incidents.manifest(page["id"])
    assert manifest["errors"] == {}
    assert "profile/trace.json" in manifest["files"]
    assert manifest["notes"]["profileSeconds"] == 0.3
    assert manifest["context"]["alert"]["transition"] == "firing"
    events = [json.loads(ln)["kind"] for ln in
              open(api.ctx.config.event_log).read().splitlines()]
    assert "incident" in events and "alert" in events
