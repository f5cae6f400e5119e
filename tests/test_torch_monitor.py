"""The port's cluster monitor and SLO watchdog
(``learningorchestra_tpu_torch/observability/{monitor,slo}.py``) against
the JAX package's, on the CPU.

The same fake collectors, histogram observations, pushed gauges and
sampler series at the same timestamps go through both packages: the
sampler's rings and latest sample are equal (less the slice
scheduler's, not ported: absent, not zero), and every objective's
firing and resolved transitions are equal, exactly. The footprint
calibration's registry and clamp equal the JAX functions, and the
port's preflight prefers a job's measured peak as the JAX execution
layer does. Over REST: the cluster and alerts routes, ``/healthz``
503 while a page fires (and while draining) and 200 after, and 404s
with ``LO_MONITOR=0``.
"""

import time

import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.observability import hist as jax_hist
from learningorchestra_tpu.observability import incidents as jax_incidents
from learningorchestra_tpu.observability import monitor as jax_monitor
from learningorchestra_tpu.observability import slo as jax_slo
from learningorchestra_tpu.observability import xray as jax_xray
from learningorchestra_tpu_torch import analysis as A
from learningorchestra_tpu_torch import observability as obs
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.observability import hist, incidents
from learningorchestra_tpu_torch.observability import monitor, slo, xray
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
PORT, JAX = "port", "jax"
LIBS = {PORT: (monitor, slo, hist), JAX: (jax_monitor, jax_slo, jax_hist)}


@pytest.fixture(autouse=True)
def _fresh():
    for lib in (hist, jax_hist):
        lib.reset()
    for lib in (monitor, jax_monitor):
        lib.reset_calibration()
    for lib in (slo, jax_slo):
        lib.reset_gauges()
    for lib in (incidents, jax_incidents):
        lib.set_recorder(None)
    yield
    for lib in (hist, jax_hist):
        lib.reset()
    for lib in (slo, jax_slo):
        lib.reset_gauges()
    jax_config.reset_config()
    obs.reset_config()


def _configs(tmp_path, **slo_fields):
    """The same SLO fields in both packages' plane configs."""
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "j"),
                                            **slo_fields))
    obs.set_config(Config(home=str(tmp_path / "p"), **slo_fields))


def _fake_devices(in_use=2 << 30, peak=3 << 30, limit=16 << 30, n=1):
    def collect():
        return [{"device": i, "platform": "cuda", "bytesInUse": in_use,
                 "peakBytesInUse": peak, "bytesLimit": limit}
                for i in range(n)]
    return collect


def test_sampler_rings_and_latest_match_jax(tmp_path):
    _configs(tmp_path)
    depth = {"n": 0}

    def serving():
        return {"queueDepth": depth["n"], "batchFill": 0.5,
                "kvPagesFree": 7, "kvPagesShared": 1}

    def jobs():
        return {"running": 1, "queued": depth["n"], "deadLettered": 2}

    def arena():
        return {"entries": depth["n"], "bytesInUse": depth["n"] << 20,
                "evictions": depth["n"] * 3, "hits": 1, "misses": 2}

    def scheduler():
        # the card lease's counting mode: one lease, busy or not
        return {"sliced": False, "devicesTotal": None,
                "devicesBusy": depth["n"] % 2, "fragmentation": 0.0}

    made = {}
    for name, (mon, _, _) in LIBS.items():
        made[name] = mon.ClusterMonitor(
            ring=8, scheduler_stats=scheduler, serving_stats=serving,
            job_stats=jobs, arena_stats=arena,
            device_stats=_fake_devices(in_use=3 << 30, n=2))
    for t in range(12):
        depth["n"] = t % 3
        for m in made.values():
            m.sample_once(now=100.0 + t)
    ours, theirs = made[PORT].snapshot(), made[JAX].snapshot()
    # measured live: host RSS, and the X-ray remainder (liveArrays in
    # the JAX package on the CPU, no allocator count in the port)
    xray_series = {"xrayAttributedBytes", "xrayUnattributedBytes",
                   "hostRssBytes"}
    assert {k: v for k, v in ours["series"].items()
            if k not in xray_series} == \
        {k: v for k, v in theirs["series"].items() if k not in xray_series}
    assert ours["samples"] == theirs["samples"] == 12
    assert ours["ring"] == theirs["ring"] == 8
    ol, tl = ours["latest"], theirs["latest"]
    assert set(ol) == set(tl)
    for key in ("devices", "hbm", "arena", "scheduler", "serving", "jobs",
                "ts"):
        assert ol[key] == tl[key]
    assert ours["series"]["arenaBytesInUse"] == \
        theirs["series"]["arenaBytesInUse"]
    assert made[PORT].series_window("hbmBytesInUse", 1.5, now=111.0) == \
        made[JAX].series_window("hbmBytesInUse", 1.5, now=111.0)


def test_failing_collector_is_counted_not_raised():
    def boom():
        raise RuntimeError("down")

    m = monitor.ClusterMonitor(serving_stats=boom, device_stats=lambda: [])
    assert m.sample_once(now=1.0)["serving"] is None
    assert m.snapshot()["sampleErrors"] == 1
    assert monitor.device_memory_stats() == []   # no card here
    assert monitor.peak_hbm_bytes() is None
    assert monitor.host_rss_bytes() > 0


def _history(w):
    return [(h["name"], h["transition"], h["value"])
            for h in w.snapshot()["history"]]


def _serving_scenario(name, series, fields):
    """Slow requests of one series, then silence: a firing and a
    resolve."""
    def run(lib_name, w):
        _, _, h = LIBS[lib_name]
        t0 = 1000.0
        w.evaluate(now=t0)
        for _ in range(50):
            h.observe(series, 0.5)
        w.evaluate(now=t0 + 1.0)
        w.evaluate(now=t0 + 1.5)
        w.evaluate(now=t0 + 3.0)
        w.evaluate(now=t0 + 9.0)
    return name, fields, run


def _spike_scenario():
    """A fast-window spike over a long healthy history: no page."""
    def run(lib_name, w):
        _, _, h = LIBS[lib_name]
        t0 = 2000.0
        w.evaluate(now=t0)
        for _ in range(2000):
            h.observe("lo_serving_request_seconds", 0.001)
        w.evaluate(now=t0 + 1.0)
        for _ in range(5):
            h.observe("lo_serving_request_seconds", 0.5)
        w.evaluate(now=t0 + 2.0)
    return "spike", dict(slo_serving_p99_ms=100.0, slo_fast_window_s=1.0,
                         slo_slow_window_s=60.0), run


def _sampler_scenario(name, fields, devices, dead_steps):
    def run(lib_name, w):
        mon = LIBS[lib_name][0]
        dead = {"n": 0}
        m = mon.ClusterMonitor(
            job_stats=lambda: {"running": 0, "queued": 0,
                               "deadLettered": dead["n"]},
            device_stats=devices, watchdog=w)
        t0 = 5000.0
        for i, (dt, n) in enumerate(dead_steps):
            dead["n"] = n
            m.sample_once(now=t0 + dt)
    return name, fields, run


def _drift_scenario():
    def run(lib_name, w):
        lib = LIBS[lib_name][1]
        t0 = time.time()
        lib.set_gauge("servingDrift", 0.2, now=t0)
        w.evaluate(now=t0 + 0.5)
        lib.set_gauge("servingDrift", 0.3, now=t0 + 1.0)
        w.evaluate(now=t0 + 1.2)
        # the producer stops: the gauge ages out and the alert resolves
        w.evaluate(now=t0 + 30.0)
    return "servingDrift", dict(serve_drift_max=0.05, slo_fast_window_s=1.0,
                                slo_slow_window_s=2.0), run


def _growth_scenario():
    def run(lib_name, w):
        mon = LIBS[lib_name][0]
        lib_xray = xray if lib_name == PORT else jax_xray
        grown = {"n": 0}
        saved = lib_xray.ring_sample
        lib_xray.ring_sample = lambda: (0, grown["n"])
        try:
            m = mon.ClusterMonitor(device_stats=lambda: [], watchdog=w)
            for i in range(6):
                grown["n"] = i * (1 << 20)
                m.sample_once(now=7000.0 + i)
            grown["n"] = 5 << 20
            for i in range(6, 12):
                m.sample_once(now=7000.0 + i)
        finally:
            lib_xray.ring_sample = saved
    return "unattributedGrowth", dict(
        slo_unattributed_growth_bytes=float(1 << 20),
        slo_fast_window_s=2.0, slo_slow_window_s=4.0), run


SCENARIOS = dict((s[0], s) for s in [
    _serving_scenario("servingP99", "lo_serving_request_seconds",
                      dict(slo_serving_p99_ms=100.0, slo_fast_window_s=1.0,
                           slo_slow_window_s=5.0)),
    _serving_scenario("servingP99:gold",
                      "lo_serving_request_seconds_tenant_gold",
                      dict(slo_serving_p99_ms=100.0, slo_fast_window_s=1.0,
                           slo_slow_window_s=5.0)),
    _serving_scenario("servingRoleP99:prefill",
                      "lo_serving_request_seconds_role_prefill",
                      dict(slo_serving_p99_ms=100.0, slo_fast_window_s=1.0,
                           slo_slow_window_s=5.0)),
    _serving_scenario("queueWait", "lo_lease_wait_seconds",
                      dict(slo_queue_wait_s=0.1, slo_fast_window_s=1.0,
                           slo_slow_window_s=5.0)),
    _spike_scenario(),
    _sampler_scenario("hbmHeadroom", dict(
        slo_hbm_headroom_frac=0.2, slo_fast_window_s=1.0,
        slo_slow_window_s=2.0), _fake_devices(in_use=15 << 30),
        [(0.0, 0), (1.0, 0), (2.0, 0), (3.0, 0)]),
    _sampler_scenario("deadLetterRate", dict(
        slo_deadletter_rate=1.0, slo_fast_window_s=60.0,
        slo_slow_window_s=120.0), lambda: [],
        [(0.0, 0), (30.0, 10), (31.0, 10), (200.0, 10), (260.0, 10)]),
    _drift_scenario(),
    _growth_scenario(),
])


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_slo_transitions_match_jax(tmp_path, scenario):
    _, fields, run = SCENARIOS[scenario]
    _configs(tmp_path, **fields)
    got = {}
    for name in (PORT, JAX):
        w = LIBS[name][1].SloWatchdog(active_trace=lambda: "serve/m")
        run(name, w)
        got[name] = (_history(w), w.objectives(),
                     sorted(a["name"] for a in w.firing()))
    assert got[PORT] == got[JAX]
    history = got[PORT][0]
    if scenario == "spike":
        assert history == []
    else:
        assert history and history[0][:2] == (scenario, "firing")


def test_calibration_matches_jax():
    for lib in (monitor, jax_monitor):
        lib.record_peak("m:fit", 100)
        lib.record_peak("m:fit", 50)
        lib.record_peak("m:fit", 0)
        lib.record_peak(None, 10)
    assert monitor.measured_peak("m:fit") == \
        jax_monitor.measured_peak("m:fit") == 100
    for measured, estimate, margin in ((100, 1000, 1.25), (10, 1000, 1.0),
                                       (50000, 1000, 1.25), (7, 0, 2.0)):
        assert monitor.calibrated_hbm_bytes(measured, estimate, margin) == \
            jax_monitor.calibrated_hbm_bytes(measured, estimate, margin)


def test_preflight_prefers_a_measured_peak():
    cfg = Config(footprint_calibrate=True, footprint_margin=1.5)
    meta = {"name": "m"}
    fp = {"hbmBytes": 4000, "estimator": "heuristic"}
    A.calibrate_footprint(fp, meta, "fit", cfg)
    assert fp == {"hbmBytes": 4000, "estimator": "heuristic",
                  "calibrationKey": "m:fit"}
    monitor.record_peak("m:fit", 1000)
    A.calibrate_footprint(fp, meta, "fit", cfg)
    assert fp["estimator"] == "measured-peak"
    assert fp["estimatedHbmBytes"] == 4000
    assert fp["hbmBytes"] == jax_monitor.calibrated_hbm_bytes(1000, 4000,
                                                              1.5) == 1500
    off = {"hbmBytes": 4000}
    A.calibrate_footprint(off, meta, "fit", Config())
    assert off == {"hbmBytes": 4000}


def test_a_card_jobs_peak_is_recorded_under_its_calibration_key(
        tmp_path, monkeypatch):
    from learningorchestra_tpu_torch.services import jobs as jobs_mod

    monkeypatch.setattr(jobs_mod.obs_monitor, "peak_hbm_bytes",
                        lambda: 123456)
    resets = []
    monkeypatch.setattr(jobs_mod.obs_monitor, "reset_peak_hbm",
                        lambda: resets.append(1))
    ctx = ServiceContext(Config(home=str(tmp_path), monitor=False),
                         device="cpu")
    try:
        ctx.catalog.create_collection("j", "train/tensorflow", {})
        ctx.jobs.submit("j", lambda: 1, needs_card=True,
                        footprint={"calibrationKey": "m:fit"}).result()
        assert ctx.catalog.get_metadata("j")["peakHbmBytes"] == 123456
        assert monitor.measured_peak("m:fit") == 123456 and resets == [1]
        ctx.catalog.create_collection("h", "train/tensorflow", {})
        ctx.jobs.submit("h", lambda: 1).result()
        assert "peakHbmBytes" not in ctx.catalog.get_metadata("h")
        assert ctx.jobs.queue_stats() == {"running": 0, "queued": 0,
                                          "deadLettered": 0}
    finally:
        ctx.close()


@pytest.fixture()
def slo_api(tmp_path):
    api = Api(ServiceContext(Config(
        home=str(tmp_path), monitor_interval_ms=3_600_000.0,
        slo_serving_p99_ms=50.0, slo_fast_window_s=1.0,
        slo_slow_window_s=2.0), device="cpu"))
    yield api
    api.ctx.close()


def test_cluster_and_alert_routes(slo_api):
    slo_api.ctx.monitor.sample_once()
    st, doc, _ = slo_api.dispatch("GET", f"{PREFIX}/observability/cluster",
                                  {}, None)
    assert st == 200
    assert set(doc) == {"intervalSeconds", "ring", "samples",
                        "sampleErrors", "latest", "series"}
    assert set(doc["latest"]) == {"ts", "devices", "hbm", "arena",
                                  "scheduler", "serving", "jobs",
                                  "hostRssBytes", "xray"}
    assert doc["latest"]["scheduler"]["devicesBusy"] == 0
    assert doc["series"]["sliceDevicesBusy"][0][1] == 0
    assert doc["latest"]["serving"]["sessions"] == 0
    assert doc["latest"]["arena"]["entries"] == 0
    assert "hostRssBytes" in doc["series"]
    st, alerts, _ = slo_api.dispatch("GET", f"{PREFIX}/observability/alerts",
                                     {}, None)
    assert st == 200 and set(alerts) == {"objectives", "alerts", "firing",
                                         "history"}
    assert alerts["objectives"]["servingP99"]["threshold"] == 50.0


def test_healthz_pages_then_recovers(slo_api):
    w = slo_api.ctx.monitor.watchdog
    assert slo_api.dispatch("GET", "/healthz", {}, None)[:2] == \
        (200, {"status": "ok"})
    t0 = time.time()
    w.evaluate(now=t0)
    for _ in range(20):
        hist.observe("lo_serving_request_seconds", 0.4)
    w.evaluate(now=t0 + 0.5)
    st, body, _ = slo_api.dispatch("GET", "/healthz", {}, None)
    assert st == 503 and body["status"] == "failing"
    assert [a["name"] for a in body["alerts"]] == ["servingP99"]
    text = slo_api.metrics_prometheus().decode()
    assert 'lo_alert_firing{alert="servingP99",severity="page"} 1' in text
    assert "lo_alerts_firing 1" in text
    w.evaluate(now=t0 + 5.0)
    assert slo_api.dispatch("GET", "/healthz", {}, None)[0] == 200
    slo_api.ctx.begin_drain()
    assert slo_api.dispatch("GET", "/healthz", {}, None)[:2] == \
        (503, {"status": "draining"})


def test_monitor_off_routes_404(tmp_path):
    api = Api(ServiceContext(Config(home=str(tmp_path), monitor=False),
                             device="cpu"))
    try:
        assert api.ctx.monitor is None
        for route in ("cluster", "alerts"):
            st, body, _ = api.dispatch(
                "GET", f"{PREFIX}/observability/{route}", {}, None)
            assert st == 404 and "LO_MONITOR=0" in body["result"]
        metrics = api.metrics()
        assert "cluster" not in metrics and "alertsFiring" not in metrics
        assert api.dispatch("GET", "/healthz", {}, None)[0] == 200
        st, health, _ = api.dispatch("GET", "/health", {}, None)
        assert st == 200 and health["devicePlatform"] == "cpu"
        assert health["deviceCount"] == 1 and "podFailure" not in health
    finally:
        api.ctx.close()


def test_autoscaler_route_is_404_until_ported(slo_api):
    st, body, _ = slo_api.dispatch(
        "GET", f"{PREFIX}/observability/autoscaler", {}, None)
    assert st == 404
    assert "autoscaler" not in slo_api.metrics()
    assert np.isfinite(slo_api.metrics()["uptimeSeconds"])
