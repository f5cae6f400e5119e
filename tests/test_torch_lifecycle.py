"""The PyTorch port's job lifecycle on the CPU, held against the JAX
package: each scenario of ``tests/test_lifecycle.py`` runs on both job
managers (the JAX one at one mesh lease, the port's on its card lease)
and must end with the same statuses, documents (their keys, classes,
attempts and exception texts) and counters.

Scenarios: a hung job past its deadline hands the lease to the next job;
a cancel of a running job and of one waiting for the lease; a deadline
that expires in the lease queue; transient retries with backoff; a
permanent error; an exhausted transient budget; the numerical class's
budget; the stall watchdog with and without heartbeats; a shutdown that
drops a queued job. Then the function route: a deadline and a ``DELETE
.../run`` kill the jailed child in both packages alike, and
``classify_error`` answers as the JAX one on a shared table.
"""

import threading
import time

import pytest

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.catalog import Catalog as JaxCatalog
from learningorchestra_tpu.runtime import health as jax_health
from learningorchestra_tpu.runtime import preempt as jax_preempt
from learningorchestra_tpu.services import faults as jax_faults
from learningorchestra_tpu.services import jobs as jax_jobs
from learningorchestra_tpu_torch.catalog.store import Catalog
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.runtime import health, preempt
from learningorchestra_tpu_torch.services import faults, jobs
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

PREFIX = "/api/learningOrchestra/v1"
# document keys that carry times, not outcomes
_TIMES = ("timeCreated", "elapsedSeconds", "queueWaitSeconds",
          "leaseWaitSeconds", "nextRetryInSeconds")


class Side:
    """One package's catalog, job manager and preempt module."""

    def __init__(self, which: str, root, spec: str = "", **kw):
        self.which = which
        home = str(root / which)
        if which == "jax":
            cfg = jax_config.Config(home=home, fault_inject=spec)
            jax_config.set_config(cfg)
            jax_faults.reset()
            self.catalog = JaxCatalog(cfg.catalog_path, cfg.datasets_dir)
            self.jobs = jax_jobs.JobManager(self.catalog, max_workers=kw.pop(
                "max_workers", 4), mesh_leases=1, **kw)
            self.preempt, self.health = jax_preempt, jax_health
            self.card = {"needs_mesh": True}
        else:
            cfg = Config(home=home, fault_inject=spec)
            faults.reset()
            self.catalog = Catalog(cfg.catalog_path, cfg.datasets_dir)
            self.jobs = jobs.JobManager(self.catalog, max_workers=kw.pop(
                "max_workers", 4), config=cfg, **kw)
            self.preempt, self.health = preempt, health
            self.card = {"needs_card": True}

    def create(self, *names):
        for name in names:
            self.catalog.create_collection(name, "train/tensorflow")

    def wait(self, name, timeout=30):
        try:
            return self.jobs.wait(name, timeout=timeout)
        except Exception:  # noqa: BLE001 — a future cancelled pre-start
            return None

    def wait_status(self, name, status, timeout=20):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.catalog.get_metadata(name).get("status") == status:
                return
            time.sleep(0.01)
        raise AssertionError(f"{self.which}: {name} never {status}")

    def outcome(self, *names):
        out = {}
        for name in names:
            meta = self.catalog.get_metadata(name)
            docs = [{k: v for k, v in d.items() if k not in _TIMES + ("_id",)}
                    | {"keys": sorted(k for k in d if k != "_id")}
                    for d in self.catalog.get_documents(name)
                    if d.get("_id") != 0]  # the metadata: compared below
            out[name] = {"finished": meta["finished"],
                         "status": meta.get("status"),
                         "progressStep": (meta.get("progress") or {}).get(
                             "step"),
                         "docs": docs}
        counters = self.jobs.lifecycle_counters()
        out["counters"] = {k: counters.get(k, 0) for k in (
            "retries", "cancelled", "timedOut", "numericalRetries",
            "deadLettered", "stalled")}
        return out

    def close(self):
        self.jobs.shutdown()
        self.catalog.close()


def _timed_out_hang(side):
    side.create("hang_job", "next_job")
    side.jobs.submit("hang_job", lambda: "never", timeout=0.5, **side.card)
    side.jobs.submit("next_job", lambda: "ran", **side.card)
    assert side.wait("next_job") == "ran"
    side.wait("hang_job")
    return side.outcome("hang_job", "next_job")


def _cancel_running(side):
    side.create("cancel_me")

    def loop():
        side.preempt.heartbeat(step=1, epoch=0)
        while True:
            side.preempt.check_cancel()
            time.sleep(0.01)

    side.jobs.submit("cancel_me", loop, **side.card)
    side.wait_status("cancel_me", "running")
    first = side.jobs.cancel("cancel_me")
    side.wait("cancel_me")
    return side.outcome("cancel_me") | {
        "cancelled": (first, side.jobs.cancel("cancel_me"),
                      side.jobs.cancel("ghost"))}


def _holder(side, name):
    release, started = threading.Event(), threading.Event()

    def hold():
        started.set()
        release.wait(20)
        return "held"

    side.jobs.submit(name, hold, **side.card)
    assert started.wait(10)
    return release


def _cancel_waiting_for_lease(side):
    side.create("holder", "queued")
    release = _holder(side, "holder")
    side.jobs.submit("queued", lambda: "nope", **side.card)
    time.sleep(0.3)  # in the lease queue's cancel-aware wait
    first = side.jobs.cancel("queued")
    side.wait("queued")
    release.set()
    assert side.wait("holder") == "held"
    return side.outcome("holder", "queued") | {
        "cancelled": (first, side.jobs.cancel("queued"))}


def _deadline_in_lease_queue(side):
    side.create("holder", "late")
    release = _holder(side, "holder")
    side.jobs.submit("late", lambda: "nope", timeout=0.3, **side.card)
    side.wait("late")
    release.set()
    side.wait("holder")
    return side.outcome("holder", "late")


def _transient_retries(side):
    side.create("r1")
    side.jobs.submit("r1", lambda: "ok", max_retries=3)
    assert side.wait("r1") == "ok"
    return side.outcome("r1")


def _permanent_error(side):
    side.create("p1")
    calls = []

    def bad():
        calls.append(1)
        raise ValueError("user bug")

    side.jobs.submit("p1", bad, max_retries=3)
    side.wait("p1")
    return side.outcome("p1") | {"calls": len(calls)}


def _exhausted_budget(side):
    side.create("x1")
    calls = []

    def flaky():
        calls.append(1)
        raise IOError("flaky forever")

    side.jobs.submit("x1", flaky, max_retries=2)
    side.wait("x1")
    return side.outcome("x1") | {"calls": len(calls)}


def _numerical_budget(side):
    side.create("n1")
    calls = []

    def diverge():
        calls.append(1)
        raise side.health.NumericalDivergence("epoch 0: nonfinite")

    side.jobs.submit("n1", diverge, max_retries=3, **side.card)
    side.wait("n1")
    return side.outcome("n1") | {"calls": len(calls)}


def _stalled(side):
    side.create("wedge")

    def wedged():
        side.preempt.heartbeat(step=1, epoch=0)  # one beat, then silence
        while True:
            side.preempt.check_cancel()
            time.sleep(0.02)

    side.jobs.submit("wedge", wedged)
    side.wait("wedge")
    return side.outcome("wedge")


def _quiet_job_not_stalled(side):
    side.create("quiet")
    side.jobs.submit("quiet", lambda: time.sleep(0.5) or "done")
    assert side.wait("quiet") == "done"
    return side.outcome("quiet")


def _shutdown_aborts_queued(side):
    side.create("blocker", "starved")
    release = _holder(side, "blocker")
    side.jobs.submit("starved", lambda: "never")
    side.jobs.shutdown()
    release.set()
    side.wait("blocker")
    return side.outcome("blocker", "starved")


SCENARIOS = {
    "hung job times out, next job runs": (_timed_out_hang,
                                          "job_run:1:hang", {}),
    "cancel a running job": (_cancel_running, "", {}),
    "cancel a job waiting for the lease": (_cancel_waiting_for_lease, "",
                                           {}),
    "deadline in the lease queue": (_deadline_in_lease_queue, "", {}),
    "transient retries with backoff": (_transient_retries, "job_run:2", {
        "retry_backoff": 0.05, "retry_backoff_max": 0.2}),
    "permanent error dead-letters": (_permanent_error, "", {}),
    "exhausted transient budget": (_exhausted_budget, "", {
        "retry_backoff": 0.02}),
    "numerical budget": (_numerical_budget, "", {
        "retry_backoff": 0.02, "numerical_retries": 1}),
    "stall watchdog escalates": (_stalled, "", {
        "stall_seconds": 0.3, "stall_escalate": True}),
    "no heartbeat, no stall": (_quiet_job_not_stalled, "", {
        "stall_seconds": 0.1, "stall_escalate": True}),
    "shutdown aborts a queued job": (_shutdown_aborts_queued, "", {
        "max_workers": 1}),
}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_lifecycle_scenario_matches_jax(tmp_path, case):
    scenario, spec, kw = SCENARIOS[case]
    outcomes = []
    try:
        for which in ("jax", "port"):
            side = Side(which, tmp_path, spec, **dict(kw))
            try:
                outcomes.append(scenario(side))
            finally:
                side.close()
    finally:
        jax_config.reset_config()
        jax_faults.reset()
        faults.reset()
    want, got = outcomes
    assert got == want


ERRORS = {
    "injected fault": (faults.InjectedFault("x"),
                       jax_faults.InjectedFault("x")),
    "IOError": (IOError("disk detached"),) * 2,
    "MemoryError": (MemoryError(),) * 2,
    "ConnectionResetError": (ConnectionResetError(),) * 2,
    "TimeoutError": (TimeoutError(),) * 2,
    "InterruptedError": (InterruptedError(),) * 2,
    "RESOURCE_EXHAUSTED": (RuntimeError(
        "RESOURCE_EXHAUSTED: out of memory while allocating"),) * 2,
    "CUDA out of memory": (RuntimeError(
        "CUDA error: out of memory"),) * 2,
    "UNAVAILABLE": (RuntimeError("UNAVAILABLE: endpoint"),) * 2,
    "ValueError": (ValueError("bad arg"),) * 2,
    "TypeError": (TypeError("wrong type"),) * 2,
    "KeyError": (KeyError("missing"),) * 2,
    "NumericalDivergence": (health.NumericalDivergence("x"),
                            jax_health.NumericalDivergence("x")),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_classify_error_matches_jax(case):
    port_exc, jax_exc = ERRORS[case]
    assert jobs.classify_error(port_exc) == \
        jax_jobs.classify_error(jax_exc)


# ----------------------------------------------------------------------
# the function route: the deadline and a cancel kill the jailed child
# ----------------------------------------------------------------------
SLOW = ("import time\n"
        "for _ in range(600):\n"
        "    time.sleep(0.1)\n"
        "response = 1\n")


@pytest.fixture()
def apis(tmp_path):
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax")))
    from learningorchestra_tpu.services.server import Api as JaxApi

    pair = (JaxApi(), Api(ServiceContext(
        Config(home=str(tmp_path / "port")), device="cpu")))
    yield pair
    for api in pair:
        api.ctx.close()
    jax_config.reset_config()


def _call(api, method, path, body=None):
    return api.dispatch(method, PREFIX + path, {}, body)[:2]


def _job_outcome(api, name):
    meta = api.ctx.catalog.get_metadata(name)
    doc = api.ctx.catalog.get_documents(name)[-1]
    return (meta["finished"], meta.get("status"), meta.get("timeout"),
            doc.get("status"), doc.get("cancelReason"),
            doc.get("exception"))


def test_function_deadline_and_cancel_kill_the_child_as_jax(apis):
    t0 = time.monotonic()
    for api in apis:
        assert _call(api, "POST", "/function/python", {
            "name": "slowf", "function": SLOW, "functionParameters": {},
            "timeout": 2.0})[0] == 201
        assert _call(api, "POST", "/function/python", {
            "name": "cancel_me", "function": SLOW,
            "functionParameters": {}})[0] == 201
    answers = []
    for api in apis:
        deadline = time.monotonic() + 60
        while api.ctx.catalog.get_metadata("cancel_me").get(
                "status") != "running":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        answers.append([_call(api, "DELETE", path) for path in (
            "/function/python/cancel_me/run",)])
    for api in apis:
        api.ctx.jobs.wait("slowf", timeout=60)
        try:
            api.ctx.jobs.wait("cancel_me", timeout=60)
        except Exception:  # noqa: BLE001
            pass
        answers[-1 if api is apis[1] else 0].extend(
            _call(api, "DELETE", path) for path in (
                "/function/python/cancel_me/run",
                "/function/python/never_existed/run"))
    # both children died long before their 60 s of sleeps
    assert time.monotonic() - t0 < 45
    want, got = ([_job_outcome(api, n) for n in ("slowf", "cancel_me")]
                 for api in apis)
    assert got == want
    assert got[0][:5] == (False, "timedOut", 2.0, "timedOut", "timedOut")
    assert got[1][1] == "cancelled"
    assert answers[1] == answers[0]
    assert [status for status, _ in answers[1]] == [200, 406, 404]
    for bad in (-1, 0, True, "5"):
        body = {"name": "tv", "function": "response = 1",
                "functionParameters": {}, "timeout": bad}
        assert _call(apis[1], "POST", "/function/python", body) == \
            _call(apis[0], "POST", "/function/python", body)


def test_timeout_field_validation_matches_jax(apis):
    from learningorchestra_tpu.services import validators as JaxV
    from learningorchestra_tpu_torch.services import validators as V

    for value in (None, 3, 2.5, -1, 0, True, "5", [1]):
        outcomes = []
        for mod in (JaxV, V):
            try:
                outcomes.append(("ok", mod.valid_timeout(value)))
            except mod.HttpError as exc:
                outcomes.append((exc.status, exc.message))
        assert outcomes[1] == outcomes[0]


@pytest.mark.parametrize("value", [
    None, "skip", "off", {"action": "rollback", "maxRollbacks": 1},
    {"bogus": 1}, {"action": "explode"}, 7, {"spikeFactor": 0.5}])
def test_health_policy_field_validation_matches_jax(value):
    from learningorchestra_tpu.services import validators as JaxV
    from learningorchestra_tpu_torch.services import validators as V

    outcomes = []
    for mod in (JaxV, V):
        try:
            outcomes.append(("ok", mod.valid_health_policy(value)))
        except mod.HttpError as exc:
            outcomes.append((exc.status, exc.message))
    assert outcomes[1] == outcomes[0]


def test_cancelled_fit_leaves_the_lease_and_memory_to_the_next_job(
        tmp_path):
    """A NeuralModel fit cancelled mid-epoch ends ``cancelled`` at a
    step boundary, its frames are cleared, and a job queued behind it
    on the card lease runs."""
    import numpy as np
    import weakref

    from learningorchestra_tpu_torch.models import NeuralModel

    ctx = ServiceContext(Config(home=str(tmp_path)), device="cpu")
    try:
        ctx.catalog.create_collection("fit", "train/tensorflow")
        ctx.catalog.create_collection("after", "evaluate/tensorflow")
        x = np.random.default_rng(0).normal(size=(4096, 8)).astype(
            np.float32)
        y = (x.sum(1) > 0).astype(np.int64)
        refs = {}
        steps = []

        def fit():
            model = NeuralModel([{"kind": "dense", "units": 8},
                                 {"kind": "dense", "units": 2,
                                  "activation": "softmax"}], device="cpu")
            refs["model"] = weakref.ref(model)
            return model.fit(x, y, epochs=50, batch_size=8,
                             log_fn=steps.append)

        ctx.jobs.submit("fit", fit, needs_card=True)
        ctx.jobs.submit("after", lambda: "ran", needs_card=True)
        deadline = time.monotonic() + 30
        while not steps:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert ctx.jobs.cancel("fit")
        assert ctx.jobs.wait("after", timeout=30) == "ran"
        assert ctx.catalog.get_metadata("fit")["status"] == "cancelled"
        assert refs["model"]() is None  # nothing kept the fit's state
        assert len(steps) < 50
    finally:
        ctx.close()
