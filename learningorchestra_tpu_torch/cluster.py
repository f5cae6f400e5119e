"""``python -m learningorchestra_tpu_torch.cluster`` — one-command pod
bring-up with restart on failure.

Counterpart of :mod:`learningorchestra_tpu.cluster`: spawn the
coordinator and ``hosts - 1`` followers as the port's entry point
(``python -m learningorchestra_tpu_torch --coordinator ... --num-hosts
... --host-id ...``, one rank a card) and supervise them. Restarts are
pod-level: a process group is all or nothing (a rank that died cannot
rejoin the survivors' group), so on any member's non-zero exit the
supervisor tears the pod down and forms it again, within a budget of
``max_restarts`` in ``restart_window`` seconds; checkpointed fits resume
and the boot requeue replays unfinished jobs. Unlike the JAX supervisor
it first leaves the survivors up for the heartbeat timeout, four
intervals and 2 s (``LO_HEARTBEAT_*`` of the members' environment): a JAX
coordination service ends them itself, but the port's coordinator
lives on, records the loss (its pod guard's ``WorkerLost`` documents)
and shows it on ``/health`` before it is torn down. A clean exit (code
0, a SIGTERM drain) stops the pod.

    python -m learningorchestra_tpu_torch.cluster --hosts 2 --port 8080 \
        --home /shared/lo [--device cpu]
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class PodSupervisor:
    """Spawn and supervise one pod's member processes."""

    def __init__(self, hosts: int, port: int, home: str,
                 coordinator_port: Optional[int] = None,
                 rest_host: str = "127.0.0.1",
                 max_restarts: int = 5,
                 restart_window: float = 300.0,
                 backoff: float = 1.0,
                 extra_env: Optional[dict] = None,
                 device: str = "cuda"):
        self.hosts = hosts
        self.port = port
        self.home = home
        self.coordinator_port = coordinator_port or _free_port()
        self.rest_host = rest_host
        self.max_restarts = max_restarts
        self.restart_window = restart_window
        self.backoff = backoff
        self.extra_env = dict(extra_env or {})
        self.device = device
        self.procs: List[subprocess.Popen] = []
        self._restart_times: List[float] = []
        self._stopping = False
        os.makedirs(os.path.join(home, "logs"), exist_ok=True)

    # ------------------------------------------------------------------
    def _spawn_member(self, host_id: int) -> subprocess.Popen:
        env = dict(os.environ)
        env.update(self.extra_env)
        log_path = os.path.join(self.home, "logs",
                                f"host{host_id}.log")
        log = open(log_path, "ab")
        cmd = [sys.executable, "-m", "learningorchestra_tpu_torch",
               "--home", self.home, "--device", self.device,
               "--host", self.rest_host, "--port", str(self.port),
               "--coordinator",
               f"{self.rest_host}:{self.coordinator_port}",
               "--num-hosts", str(self.hosts),
               "--host-id", str(host_id)]
        proc = subprocess.Popen(cmd, stdout=log, stderr=log, env=env)
        log.close()  # the child holds its own fd
        return proc

    def start(self) -> None:
        print(f"lo-cluster: forming pod of {self.hosts} "
              f"(coordinator 127.0.0.1:{self.coordinator_port}, REST "
              f"http://{self.rest_host}:{self.port}, logs "
              f"{self.home}/logs/)", flush=True)
        self.procs = [self._spawn_member(i) for i in range(self.hosts)]

    def _teardown(self, sig=signal.SIGTERM,
                  grace: float = 75.0) -> None:
        # the SIGTERM grace must exceed the entry point's own 60 s
        # in-flight job drain, or a clean stop SIGKILLs members mid-drain
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass
        deadline = time.monotonic() + grace
        for p in self.procs:
            timeout = max(0.1, deadline - time.monotonic())
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def loss_grace(self) -> float:
        """Seconds the survivors stay up after a member's failure: the
        members' heartbeat timeout, four intervals and 2 s."""
        env = dict(os.environ, **self.extra_env)
        interval = float(env.get("LO_HEARTBEAT_INTERVAL") or 1.0)
        timeout = float(env.get("LO_HEARTBEAT_TIMEOUT") or 10 * interval)
        return timeout + 4 * interval + 2.0

    def _budget_exhausted(self) -> bool:
        now = time.monotonic()
        self._restart_times = [t for t in self._restart_times
                               if now - t < self.restart_window]
        return len(self._restart_times) >= self.max_restarts

    def supervise(self) -> int:
        """Block, restarting the pod on member failure. Returns an
        exit code (0 = clean shutdown)."""

        def _stop(signum, frame):  # noqa: ARG001
            self._stopping = True

        try:
            signal.signal(signal.SIGTERM, _stop)
            signal.signal(signal.SIGINT, _stop)
        except ValueError:
            pass  # not the main thread (embedder drives _stopping)
        while True:
            if self._stopping:
                print("lo-cluster: draining pod", flush=True)
                self._teardown()
                return 0
            failed = [i for i, p in enumerate(self.procs)
                      if p.poll() not in (None, 0)]
            clean = [i for i, p in enumerate(self.procs)
                     if p.poll() == 0]
            if clean and not failed:
                # coordinator drained cleanly (operator stop) — treat
                # as pod shutdown, stop the rest
                print("lo-cluster: member exited cleanly, stopping "
                      "pod", flush=True)
                self._teardown()
                return 0
            if failed:
                if self._budget_exhausted():
                    print(f"lo-cluster: restart budget exhausted "
                          f"({self.max_restarts} restarts in "
                          f"{self.restart_window:.0f}s) — giving up",
                          flush=True)
                    self._teardown(signal.SIGKILL, grace=5.0)
                    return 1
                codes = {i: self.procs[i].poll() for i in failed}
                print(f"lo-cluster: member(s) {codes} failed — "
                      f"re-forming pod", flush=True)
                # the survivors record the loss first; then a pod-level
                # restart: their group lost a rank for good, and a new
                # rank cannot join it
                deadline = time.monotonic() + self.loss_grace()
                while time.monotonic() < deadline and not self._stopping:
                    time.sleep(0.1)
                self._teardown(signal.SIGKILL, grace=10.0)
                self._restart_times.append(time.monotonic())
                time.sleep(self.backoff)
                # a fresh coordinator port avoids TIME_WAIT collisions
                self.coordinator_port = _free_port()
                self.start()
            time.sleep(0.5)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="one-command learningOrchestra pod bring-up on "
                    "PyTorch, with restart on failure")
    parser.add_argument("--hosts", type=int, default=1,
                        help="pod size (1 coordinator + N-1 workers)")
    parser.add_argument("--port", type=int, default=8080,
                        help="REST port on the coordinator")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind/coordinator address")
    parser.add_argument("--home", default=os.environ.get(
        "LO_HOME", "./.lo_store"), help="shared storage root")
    parser.add_argument("--coordinator-port", type=int, default=None)
    parser.add_argument("--max-restarts", type=int, default=5,
                        help="pod restarts allowed per window before "
                             "giving up")
    parser.add_argument("--restart-window", type=float, default=300.0)
    parser.add_argument("--device", default="cuda",
                        help="each member's torch device (default cuda)")
    args = parser.parse_args(argv)

    sup = PodSupervisor(hosts=args.hosts, port=args.port,
                        home=args.home,
                        coordinator_port=args.coordinator_port,
                        rest_host=args.host,
                        max_restarts=args.max_restarts,
                        restart_window=args.restart_window,
                        device=args.device)
    sup.start()
    return sup.supervise()


if __name__ == "__main__":
    sys.exit(main())
