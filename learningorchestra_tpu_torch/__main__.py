"""``python -m learningorchestra_tpu_torch [--host H] [--port P]
[--home DIR] [--device cuda|cpu]`` starts the REST server (on the card
unless ``--device cpu``; ``--port 0`` takes a free port, which the first
line prints). At start the server requeues the unfinished executions and
functions found under the home and fails the other unfinished jobs with
a typed document; the second line prints their names."""

from __future__ import annotations

import argparse
import dataclasses
import signal

from learningorchestra_tpu_torch.config import API_PREFIX, Config
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import RestServer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="learningOrchestra REST server on PyTorch and CUDA")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--home", default=None,
                        help="storage root (default LO_HOME or ./.lo_store)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)
    config = Config()
    if args.home:
        config = dataclasses.replace(config, home=args.home)
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
        server.stop()


if __name__ == "__main__":
    main()
