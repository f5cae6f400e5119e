"""``python -m learningorchestra_tpu_torch [--host H] [--port P]
[--home DIR] [--device cuda|cpu] [--coordinator HOST:PORT --num-hosts N
--host-id I]`` starts the REST server (on the card unless ``--device
cpu``; ``--port 0`` takes a free port, which the first line prints). At
start the server requeues the unfinished executions and functions found
under the home and fails the other unfinished jobs with a typed
document; the second line prints their names.

With ``--coordinator`` (or ``LO_COORDINATOR``, ``LO_NUM_HOSTS``,
``LO_HOST_ID``) the process joins a pod of ranks, one a card
(:mod:`.runtime.distributed`): rank 0 serves REST, the others never do
and follow its job broadcasts, replaying each card job so every sharded
step has all its ranks. On SIGTERM the coordinator drains its running
jobs (up to 60 s), then publishes ``shutdown`` to the followers."""

from __future__ import annotations

import argparse
import dataclasses
import signal
import time

from learningorchestra_tpu_torch.config import API_PREFIX, Config
from learningorchestra_tpu_torch.runtime import distributed as dist
from learningorchestra_tpu_torch.services import execution
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import RestServer


def _follow(config: Config, device: str) -> None:
    """A follower: replay every published job until ``shutdown``."""
    info = dist.host_info(device)
    print(f"learningOrchestra (PyTorch) rank {info['processIndex']}/"
          f"{info['processCount']} following the coordinator "
          f"({info['backend']})", flush=True)
    ctx = ServiceContext(config, device=device)
    execution.set_worker_context(ctx)
    try:
        dist.HostBridge().follow(lambda msg: None)
    finally:
        ctx.close()
        dist.shutdown()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="learningOrchestra REST server on PyTorch and CUDA")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--home", default=None,
                        help="storage root (default LO_HOME or ./.lo_store)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0 for a pod of ranks "
                             "(default LO_COORDINATOR)")
    parser.add_argument("--num-hosts", type=int, default=None,
                        help="ranks in the pod (default LO_NUM_HOSTS)")
    parser.add_argument("--host-id", type=int, default=None,
                        help="this process's rank (default LO_HOST_ID)")
    args = parser.parse_args(argv)
    config = Config()
    if args.home:
        config = dataclasses.replace(config, home=args.home)
    pod = dist.initialize(args.coordinator, args.num_hosts, args.host_id,
                          device=args.device)
    if pod and not dist.is_coordinator():
        _follow(config, args.device)
        return
    server = RestServer(args.host, args.port, context=ServiceContext(
        config, device=args.device))
    host, port = server.address
    print(f"learningOrchestra (PyTorch) REST on http://{host}:{port}"
          f"{API_PREFIX}", flush=True)
    print(f"recovered at start: {server.api.recovered}", flush=True)

    def _terminate(signum, frame):  # noqa: ARG001
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _terminate)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if pod:
            # drain running jobs first: a job publishing its broadcast
            # after the shutdown message would wait on followers that
            # left
            deadline = time.monotonic() + 60
            while server.api.ctx.jobs.running() and \
                    time.monotonic() < deadline:
                time.sleep(0.25)
            try:
                dist.HostBridge().publish({"op": "shutdown"})
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        server.stop()
        if pod:
            dist.shutdown()


if __name__ == "__main__":
    main()
