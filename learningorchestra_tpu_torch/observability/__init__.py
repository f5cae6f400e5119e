"""Zero-dependency tracing and telemetry of the port (the counterpart of
``learningorchestra_tpu/observability``, documented in
``docs/OBSERVABILITY.md``).

- :mod:`trace` — bounded in-memory span tracer (one trace per job or
  serving request) with a thread-local current-span stack;
- :mod:`timeline` — per-step-window training telemetry the engine feeds
  once per epoch;
- :mod:`hist` — fixed-bucket latency histograms on ``/metrics`` (JSON and
  Prometheus ``_bucket``/``le``);
- :mod:`export` — span tree and Chrome ``trace_event`` JSON, and the
  best-effort JSONL lifecycle event log (``LO_EVENT_LOG``);
- :mod:`perf` — the roofline: the NVIDIA cards' peak FLOP/s and HBM
  bandwidth, achieved against peak, the per-job report registry;
- :mod:`xray` — the owner-tagged device-memory ledger against the torch
  caching allocator's count;
- :mod:`monitor` — the cluster resource sampler (per-card memory from
  the torch allocator, serving queues, the job queue, host RSS) and the
  footprint-calibration registry;
- :mod:`slo` — burn-rate SLO watchdog behind ``/healthz``;
- :mod:`incidents` — the flight recorder (debug bundles) and the
  ``torch.profiler`` gate behind ``POST /profile``.

The registries are process-wide, as the JAX package's are, so the plane
reads one process-wide config: the one the newest service context
installed with :func:`set_config`, else a
:class:`~learningorchestra_tpu_torch.config.Config` read from the
environment at first use. Nothing here may ever fail or stall the job it
observes.
"""

from __future__ import annotations

from typing import Any, Optional

_config: Optional[Any] = None


def get_config():
    """The config the plane reads: the installed one, else one read from
    the environment (built once, until :func:`reset_config`)."""
    global _config
    cfg = _config
    if cfg is None:
        from learningorchestra_tpu_torch.config import Config

        cfg = _config = Config()
    return cfg


def set_config(config) -> None:
    """Installs ``config`` process-wide (a service context does, at
    creation). The default device arena is sized from it, so it starts
    anew, as the JAX package's config swap resets it."""
    global _config
    _config = config
    from learningorchestra_tpu_torch.runtime import arena

    arena.reset_default_arena()


def reset_config() -> None:
    """Drops the installed config; the next read takes the environment."""
    set_config(None)


from learningorchestra_tpu_torch.observability import trace  # noqa: E402,F401
from learningorchestra_tpu_torch.observability import timeline  # noqa: E402,F401
from learningorchestra_tpu_torch.observability import hist  # noqa: E402,F401
from learningorchestra_tpu_torch.observability import export  # noqa: E402,F401
from learningorchestra_tpu_torch.observability import monitor  # noqa: E402,F401
from learningorchestra_tpu_torch.observability import slo  # noqa: E402,F401
from learningorchestra_tpu_torch.observability import perf  # noqa: E402,F401
from learningorchestra_tpu_torch.observability import xray  # noqa: E402,F401
