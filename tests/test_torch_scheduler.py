"""The port's card lease (``learningorchestra_tpu_torch/services/
scheduler.py``), held against the JAX package's ``SliceLease`` in its
counting mode (``LO_MESH_LEASES=1``, which resolves no device).

The same scripted arrivals, pools, weights and cancels go to both leases
under one frozen clock (patched into both modules), so the grant order
and every ``stats()`` value must be equal, waits included. Then the
lease's users: the job manager's pools and epoch-boundary yield in both
packages, a REST fit that yields to an evaluate (its ``/metrics`` blocks
and series beside the JAX server's), an ``Engine`` fit that offers a
yield each epoch and learns the same when it yields, a serving session
that yields mid-stream with tokens equal to solo decode, the ``hold``
policy, the monitor's scheduler sample and the lock witness.
"""

import os
import re
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.catalog.store import Catalog as JaxCatalog
from learningorchestra_tpu.observability import monitor as jax_monitor
from learningorchestra_tpu.runtime import preempt as jax_preempt
from learningorchestra_tpu.services import jobs as jax_jobs
from learningorchestra_tpu.services import scheduler as jax_scheduler
from learningorchestra_tpu_torch.catalog.store import Catalog
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.models.transformer import LanguageModel
from learningorchestra_tpu_torch.observability import monitor
from learningorchestra_tpu_torch.runtime import preempt
from learningorchestra_tpu_torch.services import jobs, scheduler
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 30.0
LM_CFG = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, max_len=64)
DENSE = [{"kind": "dense", "units": 4, "activation": "relu"},
         {"kind": "dense", "units": 2, "activation": "softmax"}]


def _poll(predicate, timeout=TIMEOUT):
    """Waits for lease state that nothing notifies (a waiter queued)."""
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError("timed out waiting for the lease")
        threading.Event().wait(0.002)


class _Clock:
    """A frozen ``time.monotonic`` that moves only when told."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


class _Lib:
    """One package's lease, cancel token and yield hook, at one clock."""

    def __init__(self, which, clock, mesh_yield=True):
        self.which = which
        self.clock = clock
        self.mesh_yield = mesh_yield
        self.preempt = jax_preempt if which == "jax" else preempt

    def make(self, weights=None, half_life=600.0):
        if self.which == "jax":
            return jax_scheduler.SliceLease(
                1, weights=weights, served_half_life_seconds=half_life)
        return scheduler.SliceLease(
            weights=weights, served_half_life_seconds=half_life,
            mesh_yield=self.mesh_yield)


class _Holder:
    """A thread that holds ``lease`` in ``pool`` until :meth:`free`."""

    def __init__(self, lease, pool):
        self._in, self._out = threading.Event(), threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        args=(lease, pool))
        self._thread.start()
        assert self._in.wait(TIMEOUT)

    def _run(self, lease, pool):
        with lease.lease(pool):
            self._in.set()
            self._out.wait(TIMEOUT)

    def free(self):
        self._out.set()
        self._thread.join(TIMEOUT)


def _queue(lease, pool, body, threads):
    """Starts a thread that takes ``lease`` in ``pool`` and runs
    ``body``; returns once it is queued."""
    n = lease.stats()["waiters"]

    def run():
        with lease.lease(pool):
            body()

    t = threading.Thread(target=run)
    t.start()
    threads.append(t)
    _poll(lambda: lease.stats()["waiters"] == n + 1)


def _serve(lease, pool, seconds):
    """One grant to ``pool``, released as ``seconds`` held."""
    lease.release(pool, seconds, grant=lease.acquire(pool))


def _join(threads):
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()


def _fifo_within_a_pool(lib):
    lease, order, threads = lib.make(), [], []
    holder = _Holder(lease, "train")
    for tag in ("a", "b", "c"):
        _queue(lease, "train", lambda t=tag: order.append(t), threads)
    holder.free()
    _join(threads)
    return order, lease


def _least_served_pool_wins(lib):
    lease, order, threads = lib.make(), [], []
    _serve(lease, "train", 10.0)
    holder = _Holder(lease, "evaluate")
    # train arrives first; tune, with no served seconds, goes first
    for pool in ("train", "tune"):
        _queue(lease, pool, lambda p=pool: order.append(p), threads)
    holder.free()
    _join(threads)
    return order, lease


def _weights_bias_the_share(lib):
    lease, order, threads = lib.make(weights={"train": 3.0}), [], []
    _serve(lease, "train", 9.0)   # 3 over weight 3
    _serve(lease, "tune", 4.0)    # 4 over weight 1
    holder = _Holder(lease, "predict")
    for pool in ("tune", "train"):
        _queue(lease, pool, lambda p=pool: order.append(p), threads)
    holder.free()
    _join(threads)
    return order, lease


def _epochs(lib, lease, pool, n, events, waiter_pool=None):
    """A holder in ``pool`` that runs ``n`` epochs and offers a yield
    after each but the last; after epoch 0 a ``waiter_pool`` job queues.
    Returns the holder's lease token."""
    threads, token_box = [], []

    def holder():
        with lease.lease(pool) as token:
            token_box.append(token)
            for epoch in range(n):
                events.append((pool, epoch))
                if epoch == 0 and waiter_pool is not None:
                    _queue(lease, waiter_pool,
                           lambda: events.append((waiter_pool, 0)),
                           threads)
                if epoch < n - 1:
                    lib.preempt.maybe_yield()

    t = threading.Thread(target=holder)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive()
    _join(threads)
    return token_box[0]


def _yield_point_hands_over_and_requeues(lib):
    lease, events = lib.make(), []
    token = _epochs(lib, lease, "train", 4, events, waiter_pool="tune")
    return (events, token.yields), lease


def _no_yield_without_contention(lib):
    lease = lib.make()
    with lease.lease("train") as token:
        fn = lib.preempt.current()
        assert fn is not None
        fn()
        contended = lease.contended()
    return (token.yields, contended, lib.preempt.current()), lease


def _same_pool_waiter_does_not_preempt(lib):
    lease, events = lib.make(), []
    token = _epochs(lib, lease, "train", 4, events, waiter_pool="train")
    return (events, token.yields), lease


def _mesh_yield_off(lib):
    lease, events = lib.make(), []
    token = _epochs(lib, lease, "train", 4, events, waiter_pool="tune")
    return (events, token.yields), lease


def _cancel_while_queued(lib):
    lease, order, threads = lib.make(), [], []
    token = (jax_preempt if lib.which == "jax" else preempt).CancelToken()
    holder = _Holder(lease, "train")

    def cancelled_waiter():
        try:
            lease.acquire("tune", cancel=token)
            order.append("tune granted")
        except lib.preempt.JobCancelled as exc:
            order.append(f"cancelled:{exc.reason}")

    t = threading.Thread(target=cancelled_waiter)
    t.start()
    threads.append(t)
    _poll(lambda: lease.stats()["waiters"] == 1)
    _queue(lease, "evaluate", lambda: order.append("evaluate"), threads)
    token.cancel("cancelled")
    _poll(lambda: lease.stats()["waiters"] == 1)
    holder.free()
    _join(threads)
    return order, lease


def _decayed_served_seconds(lib):
    lease, order, threads = lib.make(half_life=10.0), [], []
    _serve(lease, "train", 8.0)
    lib.clock.t += 10.0           # one half-life: train 4
    after_one = lease.served()
    _serve(lease, "tune", 3.0)
    lib.clock.t += 20.0           # two more: train 1, tune 0.75
    after_three = lease.served()
    holder = _Holder(lease, "predict")
    for pool in ("train", "tune"):
        _queue(lease, pool, lambda p=pool: order.append(p), threads)
    holder.free()
    _join(threads)
    rounded = [{k: round(v, 9) for k, v in d.items()}
               for d in (after_one, after_three)]
    return (rounded, order), lease


SCENARIOS = {
    "fifo_within_a_pool": (_fifo_within_a_pool, ["a", "b", "c"]),
    "least_served_pool_wins": (_least_served_pool_wins, ["tune", "train"]),
    "weights_bias_the_share": (_weights_bias_the_share, ["train", "tune"]),
    "yield_point_hands_over_and_requeues": (
        _yield_point_hands_over_and_requeues,
        ([("train", 0), ("tune", 0), ("train", 1), ("train", 2),
          ("train", 3)], 1)),
    "no_yield_without_contention": (_no_yield_without_contention,
                                    (0, False, None)),
    "same_pool_waiter_does_not_preempt": (
        _same_pool_waiter_does_not_preempt,
        ([("train", 0), ("train", 1), ("train", 2), ("train", 3),
          ("train", 0)], 0)),
    "mesh_yield_off": (
        _mesh_yield_off,
        ([("train", 0), ("train", 1), ("train", 2), ("train", 3),
          ("tune", 0)], 0)),
    "cancel_while_queued": (_cancel_while_queued,
                            ["cancelled:cancelled", "evaluate"]),
    "decayed_served_seconds": (
        _decayed_served_seconds,
        ([{"train": 4.0}, {"train": 1.0, "tune": 0.75}],
         ["tune", "train"])),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scripted_arrivals_grant_as_the_jax_lease(scenario, tmp_path,
                                                  monkeypatch):
    run, want = SCENARIOS[scenario]
    mesh_yield = scenario != "mesh_yield_off"
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "j"),
                                            mesh_yield=mesh_yield))
    got = {}
    try:
        for which, module in (("jax", jax_scheduler), ("port", scheduler)):
            clock = _Clock()
            monkeypatch.setattr(module, "time", types.SimpleNamespace(
                monotonic=clock.monotonic))
            outcome, lease = run(_Lib(which, clock, mesh_yield))
            got[which] = (outcome, lease.stats(), lease.served())
    finally:
        jax_config.reset_config()
    assert got["port"] == got["jax"]
    assert got["port"][0] == want
    stats = got["port"][1]
    assert stats["sliced"] is False and stats["devicesTotal"] is None
    assert stats["devicesBusy"] == 0 and stats["waiters"] == 0


def test_parse_pool_weights_matches_jax():
    for spec in ("", "train=2,tune=1", " train = 2 ", "a=0,b=-1"):
        assert scheduler.parse_pool_weights(spec) == \
            jax_scheduler.parse_pool_weights(spec)
    with pytest.raises(ValueError, match="pool weight"):
        scheduler.parse_pool_weights("train=fast")


def test_serving_lease_matches_jax():
    """Acquire, a yield to a waiting job, a second release and the stats,
    for both policies."""
    for policy in ("preempt", "hold"):
        got = {}
        for which in ("jax", "port"):
            slices = (jax_scheduler.SliceLease(1) if which == "jax"
                      else scheduler.SliceLease())
            cls = (jax_scheduler.ServingLease if which == "jax"
                   else scheduler.ServingLease)
            sl = cls(slices, pool="serving", policy=policy)
            sl.acquire()
            ran, threads = [], []
            before = sl.maybe_yield()
            t = threading.Thread(target=lambda: (
                ran.append("train"),
                _serve(slices, "train", 0.0)))
            t.start()
            threads.append(t)
            _poll(lambda: slices.stats()["waiters"] == 1)
            yielded = sl.maybe_yield()
            if not yielded:
                sl.release()
            _join(threads)
            if not yielded:
                sl.acquire()
            sl.release()
            sl.release()
            st = sl.stats()
            st.pop("waitSeconds")
            got[which] = (before, yielded, ran, st,
                          sorted(slices.stats()["grantsByPool"].items()),
                          slices.stats()["devicesBusy"])
        assert got["port"] == got["jax"]
        assert got["port"][1] is (policy == "preempt")


# ----------------------------------------------------------------------
# the job manager's pools, both packages
# ----------------------------------------------------------------------
def _managers(tmp_path):
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax")))
    jcat = JaxCatalog(str(tmp_path / "j.sqlite"), str(tmp_path / "jd"))
    pcat = Catalog(str(tmp_path / "p.sqlite"), str(tmp_path / "pd"))
    return (("jax", jcat, jax_jobs.JobManager(jcat, max_workers=4),
             jax_preempt, {"needs_mesh": True}),
            ("port", pcat, jobs.JobManager(pcat, max_workers=4),
             preempt, {"needs_card": True}))


def test_job_manager_pools_match_jax(tmp_path):
    """A long train yields between epochs to a tune queued after its
    first epoch, which finishes first (the JAX package's
    test_job_manager_fair_pools, scripted). A second train queued beside
    the tune does not make the fit yield, but it is ahead of the fit's
    re-queue in their pool's order, so it runs before the fit's rest."""
    got = {}
    try:
        for which, cat, mgr, pre, card in _managers(tmp_path):
            events = []
            try:
                def train_fn(mgr=mgr, pre=pre, events=events):
                    for epoch in range(4):
                        events.append(("train", epoch))
                        if epoch == 0:
                            for name, pool in (("t-tune", "tune"),
                                               ("t-train2", "train")):
                                n = mgr.scheduler_stats()["waiters"]
                                mgr.submit(name, lambda p=pool: (
                                    events.append((p, "run")), p)[1],
                                    pool=pool, **card)
                                _poll(lambda n=n: mgr.scheduler_stats()[
                                    "waiters"] == n + 1)
                        if epoch < 3:
                            pre.maybe_yield()
                    return "trained"

                for name in ("t-train", "t-tune", "t-train2"):
                    cat.create_collection(name, "train/tensorflow", {})
                mgr.submit("t-train", train_fn, pool="train", **card)
                assert mgr.wait("t-train", timeout=TIMEOUT) == "trained"
                assert mgr.wait("t-tune", timeout=TIMEOUT) == "tune"
                assert mgr.wait("t-train2", timeout=TIMEOUT) == "train"
                doc = [d for d in cat.get_documents("t-train")
                       if "elapsedSeconds" in d][-1]
                other = [d for d in cat.get_documents("t-tune")
                         if "elapsedSeconds" in d][-1]
                stats = mgr.scheduler_stats()
                got[which] = (
                    events, doc["leaseYields"], doc["preemptedSeconds"] > 0,
                    "leaseYields" in other, "preemptedSeconds" in other,
                    sorted(mgr.mesh_served()), stats["grantsByPool"],
                    stats["leaseWaitCount"], stats["devicesBusy"])
            finally:
                mgr.shutdown()
                cat.close()
    finally:
        jax_config.reset_config()
    assert got["port"] == got["jax"]
    assert got["port"][0] == [("train", 0), ("tune", "run"),
                              ("train", "run"), ("train", 1), ("train", 2),
                              ("train", 3)]
    assert got["port"][1] == 1 and got["port"][2]


def test_a_job_cancelled_while_queued_gives_up_its_turn(tmp_path):
    """The cancel-while-waiting document and status are the JAX
    manager's."""
    got = {}
    try:
        for which, cat, mgr, pre, card in _managers(tmp_path):
            hold, held = threading.Event(), threading.Event()
            try:
                for name in ("a", "b", "c"):
                    cat.create_collection(name, "train/tensorflow", {})
                mgr.submit("a", lambda: (held.set(), hold.wait(TIMEOUT)),
                           pool="train", **card)
                assert held.wait(TIMEOUT)
                mgr.submit("b", lambda: "b", pool="tune", **card)
                _poll(lambda: mgr.scheduler_stats()["waiters"] == 1)
                mgr.submit("c", lambda: "c", pool="evaluate", **card)
                _poll(lambda: mgr.scheduler_stats()["waiters"] == 2)
                assert mgr.cancel("b")
                _poll(lambda: mgr.scheduler_stats()["waiters"] == 1)
                hold.set()
                assert mgr.wait("c", timeout=TIMEOUT) == "c"
                mgr.wait("a", timeout=TIMEOUT)
                # the waiter writes the document, the status, then the
                # count
                _poll(lambda: mgr.lifecycle_counters()["cancelled"] == 1)
                doc = cat.get_documents("b")[-1]
                got[which] = (doc["exception"], doc["status"],
                              cat.get_metadata("b")["status"],
                              mgr.lifecycle_counters()["cancelled"],
                              mgr.scheduler_stats()["grantsByPool"])
            finally:
                hold.set()
                mgr.shutdown()
                cat.close()
    finally:
        jax_config.reset_config()
    assert got["port"] == got["jax"]
    assert got["port"][4] == {"train": 1, "evaluate": 1}


# ----------------------------------------------------------------------
# a REST fit that yields to an evaluate, both servers
# ----------------------------------------------------------------------
def _wait_finished(api, name, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not (api.ctx.catalog.get_metadata(name) or {}).get("finished"):
        if time.monotonic() > deadline:
            raise AssertionError(
                f"{name}: {api.ctx.catalog.get_documents(name)[-1:]}")
        threading.Event().wait(0.01)


def _execution_doc(api, name, timeout=120.0):
    """The job's last execution document, once its runner has written
    it (after it marks the job finished)."""
    deadline = time.monotonic() + timeout
    while True:
        docs = [d for d in api.ctx.catalog.get_documents(name)
                if "elapsedSeconds" in d]
        if docs:
            return docs[-1]
        if time.monotonic() > deadline:
            raise AssertionError(f"{name}: no execution document")
        threading.Event().wait(0.01)


def _blank(value):
    """Times blanked, every key kept."""
    if isinstance(value, dict):
        return {k: (None if k.endswith(("Seconds", "Sum", "Max"))
                    else _blank(v)) for k, v in value.items()}
    return value


@pytest.fixture(scope="module")
def rest(tmp_path_factory):
    """Each package: a NeuralModel made and fitted once over REST, then
    a 3-epoch fit whose first epoch boundary waits until an evaluate of
    the first fit is queued. Returns what each server showed."""
    root = tmp_path_factory.mktemp("rest")
    jax_config.set_config(jax_config.Config(home=str(root / "jax")))
    from learningorchestra_tpu.services.server import Api as JaxApi

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    out = {}
    apis = {"jax": JaxApi(),
            "port": Api(ServiceContext(Config(home=str(root / "port")),
                                       device="cpu"))}
    try:
        for which, api in apis.items():
            pre = jax_preempt if which == "jax" else preempt
            api.ctx.artifacts.save({"x": x, "y": y}, "d", "function/python")
            api.ctx.catalog.create_collection("d", "function/python", {})
            api.ctx.catalog.mark_finished("d")
            finished = []
            mark = api.ctx.catalog.mark_finished
            api.ctx.catalog.mark_finished = \
                lambda name, *a, **k: (finished.append(name),
                                       mark(name, *a, **k))[1]
            st, body, _ = api.dispatch(
                "POST", f"{PREFIX}/model/tensorflow", {},
                {"modelName": "m", "modulePath":
                 "learningorchestra_tpu.models", "class": "NeuralModel",
                 "classParameters": {"layer_configs": DENSE}})
            assert st == 201, body
            _wait_finished(api, "m")
            fit = {"x": "$d.x", "y": "$d.y", "batch_size": 16,
                   "shuffle": False}

            def post(verb, name, model, method, params):
                st, body, _ = api.dispatch(
                    "POST", f"{PREFIX}/{verb}/tensorflow", {},
                    {"name": name, "modelName": model, "method": method,
                     "methodParameters": params})
                assert st == 201, body

            post("train", "t0", "m", "fit", dict(fit, epochs=1))
            _wait_finished(api, "t0")
            at_boundary, queued = threading.Event(), threading.Event()
            real_yield = pre.maybe_yield

            def first_boundary_waits():
                if not at_boundary.is_set():
                    at_boundary.set()
                    assert queued.wait(TIMEOUT)
                real_yield()

            pre.maybe_yield = first_boundary_waits
            try:
                post("train", "t", "m", "fit", dict(fit, epochs=3))
                assert at_boundary.wait(TIMEOUT)
                post("evaluate", "e", "t0", "evaluate",
                     {"x": "$d.x", "y": "$d.y"})
                _poll(lambda: api.ctx.jobs.scheduler_stats()["waiters"] == 1)
                queued.set()
                _wait_finished(api, "t")
                _wait_finished(api, "e")
            finally:
                pre.maybe_yield = real_yield
            doc = _execution_doc(api, "t")
            _execution_doc(api, "e")
            if api.ctx.monitor is not None:
                api.ctx.monitor.sample_once()
            out[which] = {
                "finished": finished,
                "doc": doc,
                "metrics": api.dispatch("GET", "/metrics", {}, None)[1],
                "prometheus": api.dispatch(
                    "GET", "/metrics", {"format": "prometheus"}, None)[1],
            }
        yield out
    finally:
        for api in apis.values():
            api.ctx.close()
        jax_config.reset_config()


def test_rest_fit_yields_to_an_evaluate_as_jax(rest):
    got, want = rest["port"], rest["jax"]
    assert got["finished"] == want["finished"] == ["m", "t0", "e", "t"]
    for side in (got, want):
        assert side["doc"]["leaseYields"] == 1
        assert side["doc"]["preemptedSeconds"] > 0
    assert set(got["doc"]) == set(want["doc"])


def test_metrics_scheduler_blocks_match_jax(rest):
    pm, jm = rest["port"]["metrics"], rest["jax"]["metrics"]
    assert _blank(pm["meshScheduler"]) == _blank(jm["meshScheduler"])
    assert pm["meshScheduler"]["grantsByPool"] == \
        {"model": 1, "train": 3, "evaluate": 1}
    assert sorted(pm["meshSecondsByPool"]) == \
        sorted(jm["meshSecondsByPool"]) == ["evaluate", "model", "train"]
    assert pm["cluster"]["scheduler"].keys() == \
        jm["cluster"]["scheduler"].keys()


def _scheduler_series(text):
    """``lo_mesh_*`` and ``lo_slice_*`` samples with their labels and
    types; values blanked where they are seconds."""
    body = text.decode()
    types_ = dict(re.findall(r"^# TYPE (lo_(?:mesh|slice|lease)_\S+) (\S+)$",
                             body, re.M))
    samples = sorted(
        (name, labels, None if "seconds" in name else value)
        for name, labels, value in re.findall(
            r"^(lo_(?:mesh|slice)_\w+|lo_lease_wait_seconds_max)"
            r"(\{[^}]*\})? (\S+)$", body, re.M))
    return types_, samples


def test_prometheus_scheduler_series_match_jax(rest):
    got = _scheduler_series(rest["port"]["prometheus"])
    want = _scheduler_series(rest["jax"]["prometheus"])
    assert got == want
    names = {s[0] for s in got[1]}
    assert names == {"lo_mesh_seconds_total", "lo_lease_wait_seconds_max",
                     "lo_mesh_devices_busy", "lo_slice_grants_total",
                     "lo_slice_fragmentation"}


def test_monitor_scheduler_sample_matches_jax():
    got = {}
    for which, mon, slices in (
            ("jax", jax_monitor, jax_scheduler.SliceLease(1)),
            ("port", monitor, scheduler.SliceLease())):
        slices.acquire("train")
        m = mon.ClusterMonitor(scheduler_stats=slices.stats,
                               device_stats=lambda: [])
        sample = m.sample_once(now=50.0)
        got[which] = (set(sample), _blank(sample["scheduler"]),
                      m.series("sliceDevicesBusy"),
                      m.series("sliceFragmentation"))
    assert got["port"] == got["jax"]
    assert got["port"][2] == [[50.0, 1]]


# ----------------------------------------------------------------------
# the engine's yield point and a yielding session, on the CPU
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def tree():
    return weights.init_params(LM_CFG, seed=4)


def _lm(tree):
    lm = LanguageModel(**LM_CFG, device="cpu")
    lm.set_params(weights.params_from_flax(tree))
    return lm


@pytest.mark.parametrize("staged", [True, False])
def test_engine_fit_offers_a_yield_each_epoch(tree, staged, monkeypatch):
    """Between epochs only; a fit that yields to another pool's job
    learns what an unyielded fit learns."""
    if not staged:
        monkeypatch.setenv("LO_SCAN_FIT_MAX_BYTES", "0")
    x = np.random.default_rng(1).integers(1, 97, (32, 16)).astype(np.int32)
    calls = []
    preempt.install(lambda: calls.append(1))
    try:
        _lm(tree).fit(x, batch_size=8, epochs=3, shuffle=False)
    finally:
        preempt.clear()
    assert len(calls) == 2
    want = _lm(tree).fit(x, batch_size=8, epochs=3,
                         shuffle=False).history["loss"]
    lease, ran, threads = scheduler.SliceLease(), [], []
    with lease.lease("train") as token:
        inner = preempt.current()

        def first_boundary_queues_an_evaluate():
            if not threads:
                _queue(lease, "evaluate", lambda: ran.append("evaluate"),
                       threads)
            inner()

        preempt.install(first_boundary_queues_an_evaluate)
        got = _lm(tree).fit(x, batch_size=8, epochs=3,
                            shuffle=False).history["loss"]
    _join(threads)
    assert ran == ["evaluate"] and token.yields == 1
    assert got == want


def _session_api(tmp_path, tree, **config):
    ctx = ServiceContext(Config(home=str(tmp_path), **config), device="cpu")
    ctx.artifacts.save(_lm(tree), "slm", "train/tensorflow")
    return Api(ctx)


def _prompts():
    rng = np.random.default_rng(2)
    return [[int(t) for t in rng.integers(1, 97, size=n)] for n in (9, 17)]


def test_a_session_yields_mid_stream_and_decodes_as_solo(tmp_path, tree):
    api = _session_api(tmp_path, tree)
    try:
        st, body, _ = api.dispatch("POST", f"{PREFIX}/serve/slm", {},
                                   {"type": "lm", "maxSlots": 2,
                                    "cacheLen": 64, "temperature": 0.0})
        assert st == 201, body
        assert body["lease"]["held"] and body["lease"]["policy"] == \
            "preempt"
        session = api.ctx.serving._get("slm")
        mid, queued = threading.Event(), threading.Event()
        decode_round = session._decode_round
        rounds = []

        def pausing_round(active):
            decode_round(active)
            rounds.append(1)
            if len(rounds) == 3:
                mid.set()
                assert queued.wait(TIMEOUT)

        session._decode_round = pausing_round
        prompts, new = _prompts(), 12
        out = [None] * len(prompts)

        def client(i):
            out[i] = api.dispatch("POST", f"{PREFIX}/serve/slm/predict", {},
                                  {"prompt": prompts[i],
                                   "maxNewTokens": new})[:2]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        assert mid.wait(TIMEOUT)
        fit_ran = threading.Event()
        api.ctx.catalog.create_collection("fit", "train/tensorflow", {})
        api.ctx.jobs.submit("fit", fit_ran.set, needs_card=True,
                            pool="train")
        _poll(lambda: api.ctx.jobs.scheduler_stats()["waiters"] == 1)
        queued.set()
        api.ctx.jobs.wait("fit", timeout=TIMEOUT)
        assert fit_ran.is_set()
        _join(threads)
        solo = api.ctx.artifacts.load("slm")
        for prompt, (status, body) in zip(prompts, out):
            assert status == 200, body
            want = solo.generate([prompt], max_new_tokens=new)[0]
            assert body["tokens"] == [int(t) for t in want[len(prompt):]]
        stats = api.ctx.serving.stats()
        yields = stats["bySession"][0]["lease"]["yields"]
        assert yields >= 1 and stats["leaseYields"] == yields
        assert "lo_serving_lease_yields_total " + str(yields) in \
            api.dispatch("GET", "/metrics", {"format": "prometheus"},
                         None)[1].decode()
        assert api.dispatch("DELETE", f"{PREFIX}/serve/slm", {},
                            None)[0] == 200
        assert api.ctx.jobs.scheduler_stats()["devicesBusy"] == 0
    finally:
        api.ctx.close()


def test_a_hold_session_keeps_the_card_until_deleted(tmp_path, tree):
    api = _session_api(tmp_path, tree, serve_lease_policy="hold")
    try:
        st, body, _ = api.dispatch("POST", f"{PREFIX}/serve/slm", {},
                                   {"type": "lm", "maxSlots": 2,
                                    "cacheLen": 64})
        assert st == 201 and body["lease"]["policy"] == "hold", body
        started = threading.Event()
        api.ctx.catalog.create_collection("fit", "train/tensorflow", {})
        api.ctx.jobs.submit("fit", started.set, needs_card=True,
                            pool="train")
        _poll(lambda: api.ctx.jobs.scheduler_stats()["waiters"] == 1)
        t_queued = time.monotonic()
        st, body = api.dispatch("POST", f"{PREFIX}/serve/slm/predict", {},
                                {"prompt": [3, 4, 5],
                                 "maxNewTokens": 4})[:2]
        assert st == 200 and len(body["tokens"]) == 4
        assert not started.wait(0.3)
        t_delete = time.monotonic()
        st, final = api.dispatch("DELETE", f"{PREFIX}/serve/slm", {},
                                 None)[:2]
        assert st == 200 and final["lease"]["yields"] == 0
        api.ctx.jobs.wait("fit", timeout=TIMEOUT)
        assert started.is_set()
        meta = api.ctx.catalog.get_metadata("fit")
        assert meta["leaseWaitSeconds"] >= t_delete - t_queued
    finally:
        api.ctx.close()


_WITNESS = '''
import os, tempfile, threading
os.environ['LO_LOCK_WITNESS'] = '1'
os.environ['LO_LOCK_WITNESS_MODE'] = 'raise'
import numpy as np
import torch
torch.set_num_threads(2)
from learningorchestra_tpu_torch.runtime import locks
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.models.transformer import LanguageModel
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api
P = '/api/learningOrchestra/v1'
cfg = dict(vocab_size=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           max_len=64)
ctx = ServiceContext(Config(home=tempfile.mkdtemp()), device='cpu')
lm = LanguageModel(**cfg, device='cpu')
lm.set_params(weights.params_from_flax(weights.init_params(cfg, seed=0)))
ctx.artifacts.save(lm, 'slm', 'train/tensorflow')
api = Api(ctx)
s, b = api.dispatch('POST', P + '/serve/slm', {}, {'maxSlots': 2})[:2]
assert s == 201, b
ctx.catalog.create_collection('fit', 'train/tensorflow', {})
ctx.jobs.submit('fit', lambda: 'ran', needs_card=True, pool='train')
assert ctx.jobs.wait('fit', timeout=60) == 'ran'
s, out = api.dispatch('POST', P + '/serve/slm/predict', {},
                      {'prompt': [1, 2, 3], 'maxNewTokens': 4})[:2]
assert s == 200, out
yields = ctx.serving.stats()['leaseYields']
assert yields >= 1, yields
api.dispatch('DELETE', P + '/serve/slm', {}, None)
ctx.close()
stats = locks.witness_stats()
assert stats['enabled'] and stats['violations'] == 0, stats
edges = locks.witness_edges()
assert ('scheduler.servinglease', 'scheduler.fair') in edges, edges
print('OK')
'''


def test_a_yielding_session_keeps_the_lock_order_subprocess():
    """With every lock a witness: a session yields to a job and takes the
    card back with no violation, through the serving lease's row."""
    proc = subprocess.run([sys.executable, "-c", _WITNESS], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout, proc.stdout
