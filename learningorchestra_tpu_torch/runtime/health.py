"""Training health sentinel: policy + counters (the port's copy of the
JAX package's ``runtime/health.py``).

The reference's only numerical-failure story is the one it has for
every failure: the job dies with ``finished: False`` and is re-run
from its stored parent — and a re-run replays the same divergence.
Here the engine computes a cheap on-card health word per train step
(loss finiteness + global grad-norm, folded into the metric sums it
already carries) and checks it, together with an EMA loss-spike test,
at every epoch boundary against a per-job :class:`HealthPolicy`:

- ``skip``      drop the poisoned update on the card, count the step;
- ``rollback``  restore the last-good checkpoint, re-seed the
                data/RNG cursor, resume with a spike-check cooldown;
- ``fail``      raise :class:`NumericalDivergence`, which
                services/jobs.py classifies as the ``numerical``
                error class (bounded rollback-retries, then
                deadLettered).

The module imports no torch: the services layer imports it for
classification and policy plumbing without touching the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional
from learningorchestra_tpu_torch.runtime import locks

ACTIONS = ("off", "skip", "rollback", "fail")


class NumericalDivergence(RuntimeError):
    """A train job failed its health policy (non-finite step or loss
    spike with no rollback budget left). Its own error class in
    services/jobs.py: retried with bounded rollback-retries — a re-run
    of a checkpointed fit resumes from the last-good step — before
    dead-lettering."""


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Per-fit sentinel policy (request ``healthPolicy`` field /
    ``LO_HEALTH_*`` defaults)."""

    action: str = "skip"
    # epoch mean loss > spike_factor * EMA(loss) counts as a spike
    spike_factor: float = 4.0
    ema_alpha: float = 0.3
    # in-fit rollback budget before the fit raises NumericalDivergence
    max_rollbacks: int = 2
    # epochs after a rollback/restore during which the spike check is
    # suppressed (the EMA is stale relative to the restored params)
    cooldown_epochs: int = 1


def coerce_policy(value: Any) -> Optional[HealthPolicy]:
    """``None`` | action string | camelCase dict (the REST request
    shape) | HealthPolicy -> HealthPolicy or None (disabled). Raises
    ValueError naming the bad field on malformed input."""
    if value is None:
        return None
    if isinstance(value, HealthPolicy):
        return None if value.action in ("", "off") else value
    if isinstance(value, str):
        value = {"action": value}
    if not isinstance(value, dict):
        raise ValueError(
            f"healthPolicy must be an action string or object, "
            f"got {type(value).__name__}")
    action = value.get("action", "skip")
    if action not in ACTIONS:
        raise ValueError(
            f"healthPolicy.action must be one of {ACTIONS}, "
            f"got {action!r}")
    if action == "off":
        return None
    policy = HealthPolicy(
        action=action,
        spike_factor=float(value.get("spikeFactor", 4.0)),
        ema_alpha=float(value.get("emaAlpha", 0.3)),
        max_rollbacks=int(value.get("maxRollbacks", 2)),
        cooldown_epochs=int(value.get("cooldownEpochs", 1)))
    if policy.spike_factor <= 1.0:
        raise ValueError(
            f"healthPolicy.spikeFactor must be > 1, "
            f"got {policy.spike_factor!r}")
    if not 0.0 < policy.ema_alpha <= 1.0:
        raise ValueError(
            f"healthPolicy.emaAlpha must be in (0, 1], "
            f"got {policy.ema_alpha!r}")
    if policy.max_rollbacks < 0:
        raise ValueError(
            f"healthPolicy.maxRollbacks must be >= 0, "
            f"got {policy.max_rollbacks!r}")
    if policy.cooldown_epochs < 0:
        raise ValueError(
            f"healthPolicy.cooldownEpochs must be >= 0, "
            f"got {policy.cooldown_epochs!r}")
    return policy


def resolve_policy(request: Any, config) -> Optional[HealthPolicy]:
    """The effective policy for a job: the request's ``healthPolicy``
    (already-validated dict/string) merged OVER the ``LO_HEALTH_*``
    config defaults; None when disabled both ways."""
    defaults = {
        "action": getattr(config, "health_action", "") or "off",
        "spikeFactor": getattr(config, "health_spike_factor", 4.0),
        "emaAlpha": getattr(config, "health_ema_alpha", 0.3),
        "maxRollbacks": getattr(config, "health_max_rollbacks", 2),
        "cooldownEpochs": getattr(config, "health_cooldown_epochs", 1),
    }
    if isinstance(request, str):
        request = {"action": request}
    if isinstance(request, dict):
        defaults.update(request)
    elif request is not None:
        return coerce_policy(request)
    return coerce_policy(defaults)


# ----------------------------------------------------------------------
# process-wide monotonic counters (the JAX package exports them as
# lo_nonfinite_steps_total, lo_rollbacks_total, lo_loss_spikes_total and
# lo_checkpoints_quarantined_total on /metrics)
# ----------------------------------------------------------------------
_lock = locks.make_lock("health.counters")
_counters: Dict[str, int] = {"nonfiniteSteps": 0, "lossSpikes": 0,
                             "rollbacks": 0, "quarantined": 0,
                             # quantized-serving quality gate:
                             # drift-probe breaches and quant→bf16
                             # degrades
                             "driftBreaches": 0, "quantDegrades": 0}
# observers of sentinel events (the incident flight recorder
# subscribes to rollbacks); notified OUTSIDE the counter lock so a
# listener can read health_stats() without deadlocking, and strictly
# best-effort — a raising listener never touches the fit
_listeners: list = []


def add_listener(fn) -> None:
    """Register ``fn(kind, n)`` to be called after every
    :func:`record`."""
    with _lock:
        _listeners.append(fn)


def remove_listener(fn) -> None:
    with _lock:
        try:
            _listeners.remove(fn)
        except ValueError:
            pass


def record(kind: str, n: int = 1) -> None:
    with _lock:
        _counters[kind] = _counters.get(kind, 0) + n
        listeners = list(_listeners)
    for fn in listeners:
        try:
            fn(kind, n)
        except Exception:  # noqa: BLE001
            pass


def health_stats() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset_health_stats() -> None:
    with _lock:
        for key in _counters:
            _counters[key] = 0
