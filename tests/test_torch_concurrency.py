"""The port's concurrency static pass and runtime lock witness
(``learningorchestra_tpu_torch/analysis/concurrency.py``,
``learningorchestra_tpu_torch/runtime/locks.py``), mirroring the JAX
package's tests/test_concurrency.py case by case.

Static half: seeded AB/BA deadlock fixtures the pass must flag, the
interprocedural cycle, blocking-under-lock (the torch calls that wait on
the card in place of JAX dispatch) and callback-under-lock fixtures, the
waiver syntax, and zero error findings over the port's own package; each
fixture also goes through the JAX pass where the rule is shared, and both
must agree. Runtime half: raise and count modes, RLock re-entry,
condition-wait rank release, try-lock, and subprocesses that drive real
control-plane flows (incident capture; a REST fit, a serving round, a
Builder job and a dataType rewrite) with ``LO_LOCK_WITNESS=1`` and
require zero violations. The port's hierarchy is the JAX package's at
equal ranks, less the rows of unported modules, plus its own leaves.
"""

import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time

import pytest

from learningorchestra_tpu.analysis import concurrency as jax_concurrency
from learningorchestra_tpu.runtime import locks as jax_locks
from learningorchestra_tpu_torch import native
from learningorchestra_tpu_torch.analysis import concurrency
from learningorchestra_tpu_torch.analysis.findings import SEVERITY_ERROR
from learningorchestra_tpu_torch.runtime import locks

REPO = pathlib.Path(__file__).resolve().parent.parent

# A small fixture hierarchy: a outermost, d innermost.
H = {"fix.a": 10, "fix.b": 20, "fix.c": 30, "fix.d": 40}
# the port's own leaves: the kernels' launch counters and their build
PORT_ONLY = {"attention.launches", "kernels.build"}


def _errors(findings, rule=None):
    return [f for f in findings if f.severity == SEVERITY_ERROR
            and (rule is None or f.rule == rule)]


def _both(src):
    """The port's findings and the JAX pass's on the same fixture."""
    return (concurrency.analyze_source(src, "fix", "fix.py", hierarchy=H),
            jax_concurrency.analyze_source(src, "fix", "fix.py",
                                           hierarchy=H))


def _rules(findings):
    return sorted((f.severity, f.rule, f.location) for f in findings)


# ----------------------------------------------------------------------
# static pass: lock-order / cycles
# ----------------------------------------------------------------------

def test_static_flags_seeded_ab_ba_deadlock():
    src = (
        "from learningorchestra_tpu_torch.runtime import locks\n"
        "LA = locks.make_lock('fix.a')\n"
        "LB = locks.make_lock('fix.b')\n"
        "def thread_one():\n"
        "    with LA:\n"
        "        with LB:\n"
        "            pass\n"
        "def thread_two():\n"
        "    with LB:\n"
        "        with LA:\n"
        "            pass\n"
    )
    findings, jax_findings = _both(src)
    order = _errors(findings, concurrency.RULE_ORDER)
    assert order, findings
    assert any("fix.a" in f.message and "fix.b" in f.message
               for f in order)
    assert _rules(findings) == _rules(jax_findings)


def test_static_flags_cross_function_cycle():
    src = (
        "from learningorchestra_tpu_torch.runtime import locks\n"
        "LA = locks.make_lock('fix.a')\n"
        "LB = locks.make_lock('fix.b')\n"
        "def g():\n"
        "    with LB:\n"
        "        pass\n"
        "def f():\n"
        "    with LA:\n"
        "        g()\n"
        "def k():\n"
        "    with LA:\n"
        "        pass\n"
        "def h():\n"
        "    with LB:\n"
        "        k()\n"
    )
    findings, jax_findings = _both(src)
    assert _errors(findings, concurrency.RULE_ORDER), findings
    assert _rules(findings) == _rules(jax_findings)


def test_static_flags_a_cycle_the_ranks_cannot_see():
    # both edges respect an unranked (synthetic) pair: only the cycle
    # pass can report them
    src = (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self.a = threading.Lock()\n"
        "        self.b = threading.Lock()\n"
        "    def one(self):\n"
        "        with self.a:\n"
        "            with self.b:\n"
        "                pass\n"
        "    def two(self):\n"
        "        with self.b:\n"
        "            with self.a:\n"
        "                pass\n"
    )
    findings, jax_findings = _both(src)
    assert _errors(findings, concurrency.RULE_CYCLE), findings
    assert _rules(findings) == _rules(jax_findings)


def test_static_rank_respecting_nesting_is_clean():
    src = (
        "from learningorchestra_tpu_torch.runtime import locks\n"
        "LA = locks.make_lock('fix.a')\n"
        "LB = locks.make_lock('fix.b')\n"
        "def fine():\n"
        "    with LA:\n"
        "        with LB:\n"
        "            pass\n"
    )
    findings, _ = _both(src)
    assert not _errors(findings), findings


def test_static_flags_undeclared_and_unregistered_locks():
    src = (
        "import threading\n"
        "from learningorchestra_tpu_torch.runtime import locks\n"
        "ANON = threading.Lock()\n"
        "TYPO = locks.make_lock('fix.nope')\n"
        "NAMED = locks.make_lock(NAME)\n"
    )
    findings, jax_findings = _both(src)
    assert _errors(findings, concurrency.RULE_UNDECLARED)
    assert len(_errors(findings, concurrency.RULE_UNREGISTERED)) == 2
    assert _rules(findings) == _rules(jax_findings)


# ----------------------------------------------------------------------
# static pass: blocking-under-lock / callback-under-lock
# ----------------------------------------------------------------------

# the rules both passes share, and the torch calls that wait on the card
# (the port's counterpart of JAX dispatch)
SHARED_BLOCKING = ["time.sleep(0.1)", "fut.result()", "work_queue.get()",
                   "requests.get('http://x')", "worker_thread.join()",
                   "other_cv.wait()"]
CARD_WAITS = ["torch.cuda.synchronize()", "stream.synchronize()",
              "done_event.synchronize()", "loss.item()", "grads.cpu()"]


@pytest.mark.parametrize("stmt", SHARED_BLOCKING + CARD_WAITS)
def test_static_flags_blocking_under_lock(stmt):
    src = (
        "import time, torch, requests\n"
        "from learningorchestra_tpu_torch.runtime import locks\n"
        "LA = locks.make_lock('fix.a')\n"
        "def f(fut, work_queue, worker_thread, other_cv, stream,\n"
        "      done_event, loss, grads):\n"
        "    with LA:\n"
        f"        {stmt}\n"
    )
    findings, jax_findings = _both(src)
    assert _errors(findings, concurrency.RULE_BLOCKING), (stmt, findings)
    if stmt in SHARED_BLOCKING:
        assert _rules(findings) == _rules(jax_findings)


@pytest.mark.parametrize("stmt", ["jax.block_until_ready(x)",
                                  "x.to(device)", "torch.cuda.Stream()",
                                  "done.is_set()"])
def test_static_does_not_flag_calls_that_do_not_wait(stmt):
    # JAX dispatch is no wait of the port, nor are an asynchronous copy,
    # a new stream or an event flag's read
    src = (
        "import jax, torch\n"
        "from learningorchestra_tpu_torch.runtime import locks\n"
        "LA = locks.make_lock('fix.a')\n"
        "def f(x, device, done):\n"
        "    with LA:\n"
        f"        {stmt}\n"
    )
    findings = concurrency.analyze_source(src, "fix", "fix.py",
                                          hierarchy=H)
    assert not _errors(findings), (stmt, findings)


def test_static_card_wait_outside_a_lock_is_clean():
    src = (
        "import torch\n"
        "from learningorchestra_tpu_torch.runtime import locks\n"
        "LA = locks.make_lock('fix.a')\n"
        "def f(loss):\n"
        "    torch.cuda.synchronize()\n"
        "    value = loss.item()\n"
        "    with LA:\n"
        "        return value\n"
    )
    findings = concurrency.analyze_source(src, "fix", "fix.py",
                                          hierarchy=H)
    assert not _errors(findings), findings


def test_static_cv_wait_on_own_innermost_lock_is_legal():
    src = (
        "from learningorchestra_tpu_torch.runtime import locks\n"
        "CV = locks.make_condition('fix.a')\n"
        "def f():\n"
        "    with CV:\n"
        "        CV.wait()\n"
    )
    findings, _ = _both(src)
    assert not _errors(findings), findings


def test_static_cv_wait_with_outer_lock_held_is_flagged():
    src = (
        "from learningorchestra_tpu_torch.runtime import locks\n"
        "LA = locks.make_lock('fix.a')\n"
        "CV = locks.make_condition('fix.b')\n"
        "def f():\n"
        "    with LA:\n"
        "        with CV:\n"
        "            CV.wait()\n"
    )
    findings, jax_findings = _both(src)
    assert _errors(findings, concurrency.RULE_BLOCKING), findings
    assert _rules(findings) == _rules(jax_findings)


def test_static_flags_callback_under_lock():
    src = (
        "from learningorchestra_tpu_torch.runtime import locks\n"
        "LA = locks.make_lock('fix.a')\n"
        "def f(self):\n"
        "    with LA:\n"
        "        for cb in self.listeners:\n"
        "            cb()\n"
        "def g(self):\n"
        "    with LA:\n"
        "        self.on_change(1)\n"
    )
    findings, jax_findings = _both(src)
    cbs = _errors(findings, concurrency.RULE_CALLBACK)
    assert len(cbs) >= 2, findings
    assert _rules(findings) == _rules(jax_findings)


def test_static_waiver_downgrades_to_warning():
    src = (
        "import time\n"
        "from learningorchestra_tpu_torch.runtime import locks\n"
        "LA = locks.make_lock('fix.a')\n"
        "def f(loss):\n"
        "    with LA:\n"
        "        # lo-conc: waive(blocking-under-lock) — test fixture\n"
        "        time.sleep(0.01)\n"
        "        loss.item()  # lo-conc: waive(blocking-under-lock) — ok\n"
    )
    findings = concurrency.analyze_source(src, "fix", "fix.py",
                                          hierarchy=H)
    assert not _errors(findings), findings
    waived = [f for f in findings
              if f.rule == concurrency.RULE_BLOCKING]
    assert len(waived) == 2
    assert all(f.severity == "warning" and "waived" in f.message
               for f in waived)


def test_real_package_has_zero_error_findings():
    findings = concurrency.analyze_package()
    assert not _errors(findings), [
        (f.rule, f.location, f.message) for f in _errors(findings)]
    # the pass reads the port's own files, every one of them
    assert concurrency.PACKAGE == REPO / "learningorchestra_tpu_torch"


def test_lock_graph_respects_the_ranks():
    graph = concurrency.lock_graph()
    for outer, inners in graph.items():
        for inner in inners:
            if outer in locks.HIERARCHY and inner in locks.HIERARCHY:
                assert locks.HIERARCHY[outer] < locks.HIERARCHY[inner], \
                    (outer, inner)


# ----------------------------------------------------------------------
# the hierarchy
# ----------------------------------------------------------------------

def test_hierarchy_is_the_jax_one_at_equal_ranks():
    shared = set(locks.HIERARCHY) - PORT_ONLY
    assert shared <= set(jax_locks.HIERARCHY), \
        shared - set(jax_locks.HIERARCHY)
    for name in shared:
        assert locks.HIERARCHY[name] == jax_locks.HIERARCHY[name], name
    # the feature plane's three rows
    for name, rank in (("arena.default", 150), ("arena.entries", 160),
                       ("feature_cache.store", 170)):
        assert locks.HIERARCHY[name] == rank
    # no two of the port's rows share a rank, its own rows included
    assert len(set(locks.HIERARCHY.values())) == len(locks.HIERARCHY)


# ----------------------------------------------------------------------
# the C++ cores' one-time build
# ----------------------------------------------------------------------

@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="g++ is absent: the C++ CSV core cannot be built "
                           "here")
def test_two_threads_at_first_use_build_the_core_once(tmp_path,
                                                      monkeypatch):
    """Two threads call the CSV core first at the same instant: the
    ``native.registry`` lock lets one run ``g++``, and both get the one
    library."""
    monkeypatch.delenv("LO_NATIVE", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", {})
    monkeypatch.setattr(native, "_tried", {})
    monkeypatch.setattr(native, "_errors", {})
    runs = []
    real_run = native.subprocess.run

    def counted_run(*args, **kwargs):
        runs.append(args[0])
        return real_run(*args, **kwargs)

    monkeypatch.setattr(native.subprocess, "run", counted_run)
    barrier = threading.Barrier(2)
    libs = [None, None]

    def first_use(k):
        barrier.wait()
        libs[k] = native.get_lib(native.CSV)

    threads = [threading.Thread(target=first_use, args=(k,))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert libs[0] is not None and libs[0] is libs[1]
    assert len(runs) == 1 and runs[0][0] == "g++"
    assert os.listdir(tmp_path) == [native.library_path(native.CSV).name]


# ----------------------------------------------------------------------
# runtime witness
# ----------------------------------------------------------------------

@pytest.fixture
def witness(monkeypatch):
    monkeypatch.setenv("LO_LOCK_WITNESS", "1")
    monkeypatch.setenv("LO_LOCK_WITNESS_MODE", "raise")
    locks.reset_witness()
    locks._tls.held = []
    yield locks
    locks.reset_witness()
    locks._tls.held = []


def test_factories_are_plain_primitives_when_disabled(monkeypatch):
    monkeypatch.setenv("LO_LOCK_WITNESS", "0")
    assert type(locks.make_lock("scheduler.fair")) is \
        type(threading.Lock())
    assert type(locks.make_rlock("jobs.manager")) is \
        type(threading.RLock())
    assert isinstance(locks.make_condition("scheduler.fair"),
                      threading.Condition)


def test_factories_return_witnesses_when_enabled(witness):
    assert isinstance(locks.make_lock("jobs.manager"), locks.WitnessLock)
    assert isinstance(locks.make_rlock("jobs.manager"), locks.WitnessRLock)
    assert isinstance(locks.make_condition("scheduler.fair"),
                      locks.WitnessCondition)
    assert locks.witness_stats()["enabled"] is True


def test_factory_rejects_unregistered_name(witness, monkeypatch):
    with pytest.raises(KeyError):
        locks.make_lock("no.such.lock")
    monkeypatch.setenv("LO_LOCK_WITNESS", "0")
    with pytest.raises(KeyError):
        locks.make_rlock("no.such.lock")


def test_witness_raises_on_rank_inversion(witness):
    outer = locks.make_lock("scheduler.fair")        # rank 80
    inner = locks.make_lock("jobs.manager")          # rank 30
    with outer:
        with pytest.raises(locks.LockOrderViolation):
            inner.acquire()
    assert not inner._lock.locked()
    stats = locks.witness_stats()
    assert stats["violations"] == 1
    assert stats["samples"][0]["acquiring"] == "jobs.manager"


def test_witness_correct_order_is_silent(witness):
    a = locks.make_lock("jobs.manager")
    b = locks.make_lock("scheduler.fair")
    with a:
        with b:
            pass
    assert locks.witness_stats()["violations"] == 0
    assert ("jobs.manager", "scheduler.fair") in locks.witness_edges()


def test_witness_count_mode_records_and_continues(witness, monkeypatch):
    monkeypatch.setenv("LO_LOCK_WITNESS_MODE", "count")
    outer = locks.make_lock("scheduler.fair")
    inner = locks.make_lock("jobs.manager")
    with outer:
        with inner:
            pass
    stats = locks.witness_stats()
    assert stats["violations"] == 1
    assert stats["mode"] == "count"


def test_witness_rlock_reentry_is_legal(witness):
    rl = locks.make_rlock("jobs.manager")
    with rl:
        with rl:
            pass
    assert locks.witness_stats()["violations"] == 0


def test_witness_plain_lock_reentry_is_violation(witness):
    lk = locks.make_lock("jobs.manager")
    with lk:
        with pytest.raises(locks.LockOrderViolation):
            lk.acquire()
    assert locks.witness_stats()["violations"] == 1


def test_witness_condition_wait_releases_rank(witness):
    cv = locks.make_condition("scheduler.fair")
    low = locks.make_lock("jobs.manager")
    woke = []

    def waiter():
        locks._tls.held = []
        with cv:
            cv.wait(timeout=5)
            woke.append(True)
        with low:
            pass

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    with low:
        pass
    with cv:
        cv.notify_all()
    t.join(timeout=5)
    assert woke
    assert locks.witness_stats()["violations"] == 0


def test_witness_wait_under_foreign_lock_flags_inversion(
        witness, monkeypatch):
    monkeypatch.setenv("LO_LOCK_WITNESS_MODE", "count")
    high = locks.make_lock("serving.kvpool")       # rank 90
    cv = locks.make_condition("scheduler.fair")    # rank 80
    with high:
        cv.acquire()
        cv.release()
    assert locks.witness_stats()["violations"] >= 1


def test_witness_nonblocking_acquire_skips_order_check(witness):
    outer = locks.make_lock("scheduler.fair")
    inner = locks.make_lock("jobs.manager")
    with outer:
        ok = inner.acquire(blocking=False)
        assert ok
        inner.release()
    assert locks.witness_stats()["violations"] == 0


def test_witness_matches_the_jax_witness(witness, monkeypatch):
    """The same acquisition sequence through both witnesses: the same
    violations, samples and edges."""
    monkeypatch.setenv("LO_LOCK_WITNESS_MODE", "count")
    jax_locks.reset_witness()
    jax_locks._tls.held = []
    try:
        for lib in (locks, jax_locks):
            a = lib.make_lock("jobs.manager")
            b = lib.make_condition("scheduler.fair")
            c = lib.make_rlock("serving.kvpool")
            with c:
                with c:
                    with a:
                        pass
            with a:
                with b:
                    with c:
                        pass
        ours, theirs = locks.witness_stats(), jax_locks.witness_stats()
        assert ours["violations"] == theirs["violations"] == 1
        assert [s["acquiring"] for s in ours["samples"]] == \
            [s["acquiring"] for s in theirs["samples"]]
        assert locks.witness_edges() == jax_locks.witness_edges()
    finally:
        jax_locks.reset_witness()
        jax_locks._tls.held = []


# ----------------------------------------------------------------------
# end-to-end: real control-plane flows under the armed witness
# ----------------------------------------------------------------------

def _run_child(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout, proc.stdout
    return proc.stdout


def test_control_plane_flows_zero_violations_subprocess():
    """Incident capture, which takes the commit lock and then freezes
    every other subsystem, with every factory returning a witness."""
    code = (
        "import os, tempfile\n"
        "os.environ['LO_LOCK_WITNESS'] = '1'\n"
        "os.environ['LO_LOCK_WITNESS_MODE'] = 'raise'\n"
        "from learningorchestra_tpu_torch.runtime import locks\n"
        "from learningorchestra_tpu_torch.observability import incidents\n"
        "home = tempfile.mkdtemp()\n"
        "rec = incidents.FlightRecorder(home=home)\n"
        "bundle = rec.capture('witness-e2e', {'k': 'v'})\n"
        "assert bundle, 'no bundle captured'\n"
        "rec.close()\n"
        "stats = locks.witness_stats()\n"
        "assert stats['enabled'] and stats['violations'] == 0, stats\n"
        "print('edges:', len(locks.witness_edges()))\n"
        "print('OK')\n"
    )
    _run_child(code)


def test_feature_plane_flows_zero_violations_subprocess():
    """The port's job, serving and feature-plane flows in one context with
    the witness armed: a REST fit (staged, its arena pin), a serving
    round, a Builder job on the card families (feature cache and arena),
    a repeat of it, a dataType rewrite, /metrics and a capture."""
    code = r'''
import os, tempfile
os.environ['LO_LOCK_WITNESS'] = '1'
os.environ['LO_LOCK_WITNESS_MODE'] = 'raise'
os.environ['LO_MONITOR_INTERVAL_MS'] = '50'
import numpy as np
import torch
torch.set_num_threads(2)
from learningorchestra_tpu_torch.runtime import locks
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api
from learningorchestra_tpu_torch.runtime import arena
P = '/api/learningOrchestra/v1'
ctx = ServiceContext(Config(home=tempfile.mkdtemp()), device='cpu')
api = Api(ctx)
def call(m, path, body=None, params=None):
    return api.dispatch(m, P + path, params or {}, body)[:2]
rng = np.random.default_rng(0)
x = rng.normal(size=(256, 4)).astype(np.float32)
y = (x[:, 0] > 0).astype(np.int64)
for name in ('tr', 'te'):
    ctx.catalog.create_collection(name, 'dataset/csv', {})
    with ctx.catalog.dataset_writer(name) as w:
        w.write_batch({'f0': x[:, 0], 'f1': x[:, 1], 'f2': x[:, 2],
                       'f3': x[:, 3], 'label': y})
    ctx.catalog.mark_finished(name)
code = ("import numpy as np\n"
        "f = ['f0', 'f1', 'f2', 'f3']\n"
        "features_training = (np.stack([np.asarray(training_df[c], np.float32) for c in f], 1), np.asarray(training_df['label']))\n"
        "features_testing = np.stack([np.asarray(testing_df[c], np.float32) for c in f], 1)\n"
        "features_evaluation = (features_testing, np.asarray(testing_df['label']))\n")
body = {'trainDatasetName': 'tr', 'testDatasetName': 'te',
        'modelingCode': code, 'classifiersList': ['LR', 'NB'],
        'meshParallel': True, 'evaluationDatasetName': 'te'}
for _ in range(2):
    s, _b = call('POST', '/builder/sparkml', dict(body))
    assert s == 201, (s, _b)
    ctx.jobs.wait('teLR', timeout=120)
    assert ctx.catalog.get_metadata('teLR')['finished'], ctx.catalog.get_metadata('teLR')
assert arena.get_default_arena().stats()['hits'] >= 1, arena.get_default_arena().stats()
s, _b = call('POST', '/model/tensorflow', {
    'modelName': 'lm', 'modulePath': 'learningorchestra_tpu.models',
    'class': 'LanguageModel', 'classParameters': dict(
        vocab_size=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
        max_len=64)})
assert s == 201, (s, _b)
ctx.jobs.wait('lm', timeout=120)
toks = rng.integers(1, 61, size=(32, 32)).astype(np.int32)
ctx.catalog.create_collection('corpus', 'function/python', {})
ctx.artifacts.save({'tokens': toks}, 'corpus', 'function/python')
ctx.catalog.mark_finished('corpus')
s, _b = call('POST', '/train/tensorflow', {
    'name': 'fit', 'modelName': 'lm', 'method': 'fit',
    'methodParameters': {'x': '$corpus.tokens', 'batch_size': 8,
                         'epochs': 2}})
assert s == 201, (s, _b)
ctx.jobs.wait('fit', timeout=300)
assert ctx.catalog.get_metadata('fit')['finished'], ctx.catalog.get_metadata('fit')
s, _b = call('POST', '/serve/fit', {'type': 'lm', 'maxSlots': 2,
                                    'cacheLen': 48, 'temperature': 0.0})
assert s == 201, (s, _b)
s, out = call('POST', '/serve/fit/predict', {'prompt': [1, 2, 3],
                                             'maxNewTokens': 4})
assert s == 200 and len(out['tokens']) == 4, (s, out)
call('DELETE', '/serve/fit')
s, _b = call('POST', '/transform/dataType', {
    'datasetName': 'tr', 'types': {'f0': 'string'}})
assert s == 200, (s, _b)
ctx.jobs.wait('tr', timeout=120)
s, m = api.dispatch('GET', '/metrics', {}, None)[:2]
assert 'featureCache' in m and 'arena' in m, sorted(m)
if ctx.incidents is not None:
    ctx.incidents.capture('witness-feature-plane', {'k': 'v'})
ctx.close()
stats = locks.witness_stats()
assert stats['enabled'] and stats['violations'] == 0, stats
print('edges:', len(locks.witness_edges()))
print('OK')
'''
    out = _run_child(code)
    edges = int(out.split("edges:")[1].split()[0])
    assert edges > 0
