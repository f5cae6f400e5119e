"""The port's pod supervisor (``python -m learningorchestra_tpu_torch.
cluster``): one-command bring-up of a pod of the port's entry points on
the CPU, a pod-level restart after a member's SIGKILL, and the restart
budget, as tests/test_cluster.py holds the JAX package's."""

import json
import os
import socket
import threading
import time
import urllib.request

from learningorchestra_tpu_torch.cluster import PodSupervisor, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    """The members' environment: the port on the path, no JAX settings."""
    env = {k: "" for k in os.environ if k.startswith(("JAX", "XLA"))}
    env.update(PYTHONPATH=REPO, **extra)
    return env


def _health(port: int, timeout: float = 5.0):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=timeout) as r:
        return json.loads(r.read())


def _wait_healthy(port: int, want_hosts: int, deadline_s: float,
                  sup: PodSupervisor):
    deadline = time.monotonic() + deadline_s
    last = None
    while time.monotonic() < deadline:
        try:
            last = _health(port)
            if last.get("status") == "ok" and \
                    last.get("processCount") == want_hosts:
                return last
        except OSError:
            pass
        time.sleep(0.3)
    raise AssertionError(f"pod never healthy: {last}; logs under "
                         f"{sup.home}/logs")


def test_cluster_bringup_and_restart_on_failure(tmp_path):
    """A pod of two ranks up in one call; a SIGKILLed follower makes the
    supervisor tear the pod down and form it again, and /health is ok
    with both ranks."""
    rest_port = _free_port()
    sup = PodSupervisor(
        hosts=2, port=rest_port, home=str(tmp_path / "pod"), backoff=0.5,
        device="cpu",
        extra_env=_env(LO_MESH_SHAPE="auto", LO_MONITOR="0",
                       LO_HEARTBEAT_INTERVAL="0.25"))
    sup.start()
    result = {}
    thread = threading.Thread(
        target=lambda: result.update(code=sup.supervise()), daemon=True)
    thread.start()
    try:
        health = _wait_healthy(rest_port, 2, 120, sup)
        assert (health["backend"], health["globalDevices"]) == ("gloo", 2)
        first = list(sup.procs)
        first[1].kill()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and \
                sup.procs[0] is first[0]:
            time.sleep(0.3)
        assert sup.procs[0] is not first[0], "the pod never re-formed"
        assert all(p.poll() is not None for p in first)
        _wait_healthy(rest_port, 2, 120, sup)
    finally:
        sup._stopping = True
        thread.join(timeout=100)
    assert result.get("code") == 0
    assert not thread.is_alive()
    assert all(p.poll() is not None for p in sup.procs)


def test_cluster_gives_up_after_restart_budget(tmp_path):
    """A pod whose member crashes at boot stops restarting once the
    budget is spent."""
    sup = PodSupervisor(
        hosts=1, port=_free_port(), home=str(tmp_path / "pod"),
        max_restarts=2, restart_window=60.0, backoff=0.1, device="cpu",
        # an int setting that does not parse fails the boot at once
        extra_env=_env(LO_MAX_WORKERS="zero", LO_HEARTBEAT_INTERVAL="0.1"))
    assert sup.loss_grace() == 0.1 * 10 + 0.4 + 2.0
    sup.start()
    assert sup.supervise() == 1
    assert len(sup._restart_times) == 2
    logs = os.listdir(tmp_path / "pod" / "logs")
    assert logs == ["host0.log"]


def test_cluster_main_parses_its_flags(tmp_path, monkeypatch):
    """``main`` builds the supervisor from its flags (the budget case,
    so it returns at once)."""
    monkeypatch.setenv("LO_MAX_WORKERS", "zero")
    monkeypatch.setenv("LO_HEARTBEAT_INTERVAL", "0.1")
    monkeypatch.setenv("PYTHONPATH", REPO)
    assert main(["--hosts", "1", "--port", str(_free_port()), "--home",
                 str(tmp_path / "h"), "--max-restarts", "1",
                 "--restart-window", "30", "--device", "cpu"]) == 1
