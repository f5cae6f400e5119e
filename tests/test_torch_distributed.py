"""The port's process group: formation, collectives and the bridge on
gloo CPU ranks; a pod of two entry points replaying a REST ``/train``
of a sharded fit; a SIGKILLed follower's typed failure; and the
heartbeat monitor. The counterpart of tests/test_distributed.py; every
spawned process imports no JAX, has a group timeout and a
``communicate`` timeout, so a hung collective fails its test and not
the suite.

The pod's fit (``LO_MESH_SHAPE=sp=2``, ring attention, float32) is held
against a one-process fit of the same windows from the same seed: losses
within 2e-5 relative (summation order)."""

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch.distributed as tdist

from learningorchestra_tpu_torch.runtime import distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "/api/learningOrchestra/v1"
LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          max_len=32, sliding_window=6, attention="ring")
CORPUS = ("import numpy as np\n"
          "rng = np.random.default_rng(3)\n"
          "response = {'tokens': rng.integers(1, 64, size=(32, 32))"
          ".astype(np.int32)}\n")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "LO_"))}
    env.update(PYTHONPATH=REPO, **extra)
    return env


def test_single_process_is_no_pod(monkeypatch):
    for key in ("LO_COORDINATOR", "LO_NUM_HOSTS", "LO_HOST_ID"):
        monkeypatch.delenv(key, raising=False)
    assert dist.initialize(device="cpu") is False
    assert not dist.is_initialized()
    info = dist.host_info("cpu")
    assert (info["processIndex"], info["processCount"],
            info["globalDevices"], info["localDevices"]) == (0, 1, 1, 1)
    assert info["platform"] == "cpu" and info["backend"] is None
    assert dist.is_coordinator() and dist.pod_failure() is None
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="outside a pod"):
        dist.initialize("127.0.0.1:1", 2, 5, device="cpu")


@pytest.mark.parametrize("device,ranks,cards,want", [
    ("cuda", 1, 1, "nccl"), ("cuda", 2, 2, "nccl"), ("cuda", 4, 8, "nccl"),
    ("cuda", 4, 1, "gloo"), ("cuda", 2, 1, "gloo"), ("cpu", 1, 0, "gloo"),
    ("cpu", 4, 0, "gloo")])
def test_backend_rule(device, ranks, cards, want):
    """NCCL where every rank has a card of its own; gloo for CPU ranks
    and for ranks sharing a card (NCCL refuses two ranks on one)."""
    assert dist.choose_backend(device, ranks, cards) == want


_RANK = textwrap.dedent("""
    import datetime
    import sys
    sys.path.insert(0, @REPO@)
    import torch
    from learningorchestra_tpu_torch.runtime import distributed as dist

    rank = int(sys.argv[1])
    assert dist.initialize("@COORD@", 2, rank, device="cpu",
                           timeout=datetime.timedelta(seconds=60))
    info = dist.host_info("cpu")
    assert info["processCount"] == info["globalDevices"] == 2, info
    assert info["backend"] == "gloo", info
    t = torch.tensor([rank + 1.0])
    assert dist.all_reduce(t).item() == 3.0
    got = dist.all_gather(torch.tensor([rank * 10]))
    assert [int(x) for x in got] == [0, 10], got
    b = dist.broadcast(torch.tensor([rank + 5]), src=1)
    assert int(b) == 6, b
    (shifted,) = dist.ring_shift((torch.tensor([float(rank)]),), [0, 1],
                                 None)
    assert shifted.item() == 1 - rank
    (swapped,) = dist.all_to_all(
        (torch.tensor([[rank * 2.0], [rank * 2.0 + 1]]),), None)
    assert swapped[:, 0].tolist() == [rank, rank + 2.0], swapped
    assert dist.staged_bytes() == {"toHost": 0, "toDevice": 0}
    bridge = dist.HostBridge()
    if rank == 0:
        bridge.publish({"op": "custom", "value": 41})
        bridge.publish({"op": "ping"})
        bridge.publish({"op": "run", "target": "json:dumps",
                        "kwargs": {"obj": 1}})
        bridge.publish({"op": "shutdown"})
    else:
        seen = []
        bridge.follow(lambda m: seen.append(m["value"]))
        assert seen == [41], seen
    dist.barrier()
    dist.shutdown()
    assert not dist.is_initialized()
    print("RANK_OK", rank, flush=True)
""")


def test_two_rank_formation_collectives_and_bridge():
    coord = f"127.0.0.1:{_free_port()}"
    script = _RANK.replace("@REPO@", repr(REPO)).replace("@COORD@", coord)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=_env())
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out.decode(errors="replace"))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, out[-3000:]


# ----------------------------------------------------------------------
# a pod of two entry points
# ----------------------------------------------------------------------
def _req(base, method, path, body=None, timeout=30):
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(base + path, data=data, method=method,
                               headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _docs(base, verb, name):
    return _req(base, "GET", f"{PREFIX}/{verb}/{name}?limit=1000")[1]


def _wait_finished(base, verb, name, timeout=240):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, body = _req(base, "GET", f"{PREFIX}/{verb}/{name}?limit=1")
        if status == 200 and body["metadata"].get("finished"):
            return body
        time.sleep(0.2)
    raise AssertionError(f"{verb}/{name} never finished: "
                         f"{_docs(base, verb, name)}")


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """Two port entry points on the CPU, rank 0 serving REST, over an
    ``sp=2`` mesh; yields ``(base url, processes, home)``."""
    home = str(tmp_path_factory.mktemp("pod"))
    coord = f"127.0.0.1:{_free_port()}"
    rest = _free_port()
    env = _env(LO_HOME=home, LO_MESH_SHAPE="sp=2",
               LO_COMPUTE_DTYPE="float32", LO_HEARTBEAT_INTERVAL="0.25",
               LO_STALL_SECONDS="0", LO_MONITOR="0")
    logs = [open(os.path.join(home, f"rank{r}.log"), "wb")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "learningorchestra_tpu_torch", "--device",
         "cpu", "--home", home, "--port", str(rest), "--coordinator", coord,
         "--num-hosts", "2", "--host-id", str(r)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(2)]
    for log in logs:
        log.close()  # the children hold their own descriptors
    base = f"http://127.0.0.1:{rest}"
    try:
        deadline = time.monotonic() + 120
        health = None
        while time.monotonic() < deadline:
            assert all(p.poll() is None for p in procs), _logs(home)
            try:
                health = _req(base, "GET", "/health", timeout=5)[1]
                break
            except OSError:
                time.sleep(0.3)
        assert health is not None, "the pod never served /health"
        yield base, procs, home, health
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _logs(home) -> str:
    out = []
    for r in range(2):
        with open(os.path.join(home, f"rank{r}.log"), "rb") as f:
            out.append(f.read()[-4000:].decode(errors="replace"))
    return "\n".join(out)


def _one_process_losses(epochs: int):
    """The same fit in this process, a world of one."""
    from learningorchestra_tpu_torch.models import transformer as tlm

    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    try:
        lm = tlm.LanguageModel(**dict(LM, attention="dot"), device="cpu")
        tokens = np.random.default_rng(3).integers(
            1, 64, size=(32, 32)).astype(np.int32)
        history = lm.fit(tokens, batch_size=8, epochs=epochs,
                         shuffle=False).history
    finally:
        del os.environ["LO_COMPUTE_DTYPE"]
    return history["loss"]


def test_pod_replays_a_rest_train_of_a_sharded_fit(pod):
    base, procs, home, health = pod
    assert health["status"] == "ok" and "podFailure" not in health
    assert (health["processCount"], health["globalDevices"],
            health["localDevices"], health["backend"]) == (2, 2, 1, "gloo")
    # the coordinator's flash-kernel launches: none on CPU tensors
    assert health["kernelLaunches"] and \
        not any(health["kernelLaunches"].values())
    assert _req(base, "POST", PREFIX + "/function/python", {
        "name": "corpus", "function": CORPUS,
        "functionParameters": {}})[0] == 201
    _wait_finished(base, "function/python", "corpus")
    assert _req(base, "POST", PREFIX + "/model/tensorflow", {
        "modelName": "lm", "modulePath": "learningorchestra_tpu_torch.models",
        "class": "LanguageModel", "classParameters": LM})[0] == 201
    _wait_finished(base, "model/tensorflow", "lm")
    assert _req(base, "POST", PREFIX + "/train/tensorflow", {
        "name": "fit", "modelName": "lm", "method": "fit",
        "methodParameters": {"x": "$corpus.tokens", "batch_size": 8,
                             "epochs": 2, "shuffle": False}})[0] == 201
    _wait_finished(base, "train/tensorflow", "fit")
    records = [d["epochRecord"] for d in _docs(base, "train/tensorflow",
                                               "fit")["result"]
               if "epochRecord" in d]
    losses = [r["loss"] for r in records]
    assert len(losses) == 2 and losses[1] < losses[0]
    np.testing.assert_allclose(losses, _one_process_losses(2), rtol=2e-5)
    # the follower replayed the job (it lives), and wrote nothing: the
    # artifact and the documents are the coordinator's
    assert all(p.poll() is None for p in procs)


def test_pod_records_a_job_error_at_once(pod):
    """A card job's own error in a pod is recorded at once: only a
    failed collective waits out the heartbeat bound for the verdict."""
    base, procs, home, _ = pod
    _wait_finished(base, "model/tensorflow", "lm")
    assert _req(base, "POST", PREFIX + "/train/tensorflow", {
        "name": "bad", "modelName": "lm", "method": "fit",
        "methodParameters": {"x": "$corpus.tokens",
                             "validation_split": 2.0}})[0] == 201
    deadline = time.monotonic() + 120
    failed = []
    while time.monotonic() < deadline and not failed:
        failed = [d for d in _docs(base, "train/tensorflow", "bad")["result"]
                  if "validation_split" in str(d.get("exception"))]
        time.sleep(0.1)
    assert failed, (_docs(base, "train/tensorflow", "bad"), _logs(home))
    assert "workerLost" not in failed[0]
    # the pod's heartbeat timeout: 10 intervals of 0.25 s
    assert failed[0]["elapsedSeconds"] < 10 * 0.25, failed[0]
    assert all(p.poll() is None for p in procs)


def _raised_in_collective(exc):
    try:
        with dist._collective():
            raise exc
    except RuntimeError as caught:
        return caught


def _raised_from(exc, cause):
    exc.__cause__ = cause
    return exc


@pytest.mark.parametrize("make,want", [
    (lambda: tdist.DistBackendError("gloo: connection closed"), True),
    (lambda: tdist.DistNetworkError("peer reset"), True),
    (lambda: _raised_in_collective(RuntimeError("Connection closed")), True),
    (lambda: _raised_from(ValueError("no result"),
                          _raised_in_collective(RuntimeError("x"))), True),
    (lambda: RuntimeError("a job's own error"), False),
    (lambda: ValueError("validation_split must be in (0, 1)"), False)])
def test_collective_errors_are_told_apart(make, want):
    """Only an error out of a collective (torch.distributed's own, one
    raised inside the port's collectives, or one raised from either)
    makes a failed pod job wait for the heartbeat verdict."""
    assert dist.is_collective_error(make()) is want


def test_sigkilled_follower_fails_the_job_typed(pod):
    base, procs, home, _ = pod
    _wait_finished(base, "model/tensorflow", "lm")
    assert _req(base, "POST", PREFIX + "/train/tensorflow", {
        "name": "long", "modelName": "lm", "method": "fit",
        "methodParameters": {"x": "$corpus.tokens", "batch_size": 8,
                             "epochs": 1000}})[0] == 201
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if any("epochRecord" in d for d in
               _docs(base, "train/tensorflow", "long")["result"]):
            break
        time.sleep(0.2)
    procs[1].send_signal(signal.SIGKILL)
    killed = time.monotonic()
    lost = None
    # the heartbeat bound (10 x 0.25 s) and the guard's tick
    while time.monotonic() - killed < 15:
        docs = _docs(base, "train/tensorflow", "long")["result"]
        lost = [d for d in docs if "WorkerLost" in str(d.get("exception"))]
        if lost:
            break
        time.sleep(0.1)
    assert lost, (_docs(base, "train/tensorflow", "long"), _logs(home))
    assert lost[0]["workerLost"] is True
    health = _req(base, "GET", "/health")[1]
    assert health["status"] == "degraded" and "[1]" in health["podFailure"]
    # a new card job is refused with a terminal typed document
    assert _req(base, "POST", PREFIX + "/train/tensorflow", {
        "name": "after", "modelName": "lm", "method": "fit",
        "methodParameters": {"x": "$corpus.tokens", "epochs": 1}})[0] == 201
    deadline = time.monotonic() + 15
    refused = False
    while time.monotonic() < deadline and not refused:
        refused = any("WorkerLost" in str(d.get("exception"))
                      for d in _docs(base, "train/tensorflow",
                                     "after")["result"])
        time.sleep(0.1)
    assert refused
    assert procs[0].poll() is None  # the coordinator lives on


def test_heartbeat_monitor_loss_and_resume():
    """A silent worker is reported lost, junk datagrams neither kill the
    monitor nor count, and resumed heartbeats clear the loss."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        addr = probe.getsockname()
    mon = dist.HeartbeatMonitor(addr, expected=[1, 2], timeout=0.6)
    try:
        sender = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

        def beat(host_id):
            sender.sendto(json.dumps({"hostId": host_id}).encode(), addr)

        for _ in range(4):
            beat(1)
            beat(2)
            sender.sendto(b"null", addr)
            sender.sendto(b'{"hostId": "x"}', addr)
            sender.sendto(b'{"hostId": 99}', addr)
            time.sleep(0.1)
        assert mon.lost_workers() == []
        deadline = time.monotonic() + 5
        lost = []
        while time.monotonic() < deadline:
            beat(1)
            lost = mon.lost_workers()
            if lost:
                break
            time.sleep(0.1)
        assert 2 in lost, lost
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            beat(1)
            beat(2)
            if mon.lost_workers() == []:
                break
            time.sleep(0.1)
        assert mon.lost_workers() == []
        sender.close()
    finally:
        mon.close()
