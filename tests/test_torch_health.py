"""The PyTorch port's training health sentinel and checkpoint integrity
faults on the CPU, held against the JAX package.

- ``coerce_policy``, ``resolve_policy`` and the fault grammar's data
  modes give both packages' answers (or error messages) on one table.
- The toy MLP of ``tests/test_health.py`` (dense 16 relu, dense 2
  softmax; 256 rows of 8 features from seed 0), its weights drawn by the
  JAX package and carried across with ``params_from_flax``, fitted in
  float32 with ``shuffle=False`` under ``engine_step:1:nan``: ``skip``,
  ``rollback`` and ``fail`` give the JAX package's history (within
  1e-5), health events and counters, and a rollback's run equals a clean
  run's bit for bit.
- ``ckpt_write:1:corrupt`` flips a payload after its checksum, so the
  next restore quarantines it and falls back, as in the JAX package.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.models.neural import NeuralModel as JaxNeuralModel
from learningorchestra_tpu.runtime import health as jax_health
from learningorchestra_tpu.services import faults as jax_faults
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import NeuralModel, weights
from learningorchestra_tpu_torch.runtime import health
from learningorchestra_tpu_torch.runtime.checkpoint import Checkpointer
from learningorchestra_tpu_torch.runtime.engine import Engine
from learningorchestra_tpu_torch.services import faults

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
MLP = [{"kind": "dense", "units": 16, "activation": "relu"},
       {"kind": "dense", "units": 2, "activation": "softmax"}]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """float32 in both packages, fresh fault budgets and counters, and a
    JAX config of its own (its faults read the global one)."""
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    monkeypatch.delenv("LO_FAULT_INJECT", raising=False)
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax")))
    for mod in (faults, jax_faults):
        mod.reset()
    for mod in (health, jax_health):
        mod.reset_health_stats()
    yield
    jax_config.reset_config()
    for mod in (faults, jax_faults):
        mod.reset()


def _arm(monkeypatch, spec: str) -> None:
    """The fault spec in both packages (the port's engine reads
    ``LO_FAULT_INJECT`` outside a job; the JAX engine the global config)."""
    monkeypatch.setenv("LO_FAULT_INJECT", spec)
    jax_config.set_config(dataclasses.replace(jax_config.get_config(),
                                              fault_inject=spec))
    for mod in (faults, jax_faults):
        mod.reset()


# ----------------------------------------------------------------------
# policy coercion and resolution
# ----------------------------------------------------------------------
POLICIES = {
    "none": None,
    "skip": "skip",
    "rollback": "rollback",
    "off": "off",
    "dict": {"action": "skip", "spikeFactor": 8, "maxRollbacks": 5},
    "defaults": {},
    "cooldown": {"action": "rollback", "cooldownEpochs": 3,
                 "emaAlpha": 0.5},
    "bad action": "explode",
    "spike <= 1": {"action": "skip", "spikeFactor": 0},
    "alpha > 1": {"action": "skip", "emaAlpha": 1.5},
    "negative rollbacks": {"action": "rollback", "maxRollbacks": -1},
    "negative cooldown": {"action": "rollback", "cooldownEpochs": -2},
    "a number": 3,
}


def _coerced(mod, value):
    try:
        policy = mod.coerce_policy(value)
    except ValueError as exc:
        return "error", str(exc)
    return None if policy is None else dataclasses.asdict(policy)


@pytest.mark.parametrize("case", list(POLICIES))
def test_coerce_policy_matches_jax(case):
    value = POLICIES[case]
    assert _coerced(health, value) == _coerced(jax_health, value)


@pytest.mark.parametrize("request_value", [None, "rollback", "off",
                                           {"spikeFactor": 6.0}])
@pytest.mark.parametrize("action", ["", "skip"])
def test_resolve_policy_matches_jax(tmp_path, request_value, action):
    port = Config(home=str(tmp_path), health_action=action,
                  health_spike_factor=9.0)
    want = jax_config.Config(home=str(tmp_path), health_action=action,
                             health_spike_factor=9.0)
    got = health.resolve_policy(request_value, port)
    expected = jax_health.resolve_policy(request_value, want)
    assert (None if got is None else dataclasses.asdict(got)) == \
        (None if expected is None else dataclasses.asdict(expected))


# ----------------------------------------------------------------------
# the fault grammar's data modes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    "engine_step:2:nan, ckpt_write:1:corrupt:64", "s:1:corrupt",
    "s:1:nan:5", "s:1:corrupt:0", "s:1:corrupt:2.5", "job_run:1:hang:3"])
def test_parse_spec_matches_jax(spec):
    def parsed(mod):
        try:
            return {k: dataclasses.asdict(v)
                    for k, v in mod.parse_spec(spec).items()}
        except ValueError as exc:
            return str(exc)

    assert parsed(faults) == parsed(jax_faults)


def test_data_fault_budget_isolated_from_maybe_inject(tmp_path):
    cfg = Config(home=str(tmp_path), fault_inject="engine_step:1:nan")
    faults.maybe_inject("engine_step", cfg)  # wrong mode: nothing spent
    assert faults.maybe_nan("engine_step", cfg) is True
    assert faults.maybe_nan("engine_step", cfg) is False
    assert faults.corrupt_nbytes("engine_step", cfg) == 0
    cfg = Config(home=str(tmp_path), fault_inject="ckpt_write:1:corrupt")
    faults.reset()
    assert faults.maybe_nan("ckpt_write", cfg) is False
    assert faults.corrupt_nbytes("ckpt_write", cfg) == 8
    assert faults.corrupt_nbytes("ckpt_write", cfg) == 0


def test_use_config_arms_sites_without_a_config(tmp_path, monkeypatch):
    monkeypatch.setenv("LO_FAULT_INJECT", "")
    assert faults.maybe_nan("engine_step") is False
    with faults.use_config(Config(home=str(tmp_path),
                                  fault_inject="engine_step:1:nan")):
        assert faults.maybe_nan("engine_step") is True
    faults.reset()
    assert faults.maybe_nan("engine_step") is False


# ----------------------------------------------------------------------
# the sentinel on the toy MLP, against the JAX package
# ----------------------------------------------------------------------
def _toy(n=256, features=8):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, features)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int64)
    return x, y


def _pair(x):
    """The JAX MLP with its drawn weights, and the port's holding them."""
    jm = JaxNeuralModel(MLP)
    jm._build_params(jm._coerce_x(x))
    pm = NeuralModel(MLP, device="cpu")
    pm.set_params(weights.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jm.params), sequential=True),
        {}, input_shape=jm.input_shape)
    return jm, pm


def _fit(model, x, y, policy, events, **kw):
    return model.fit(x, y, epochs=kw.pop("epochs", 3), batch_size=32,
                     shuffle=False, health_policy=policy,
                     log_fn=events.append, **kw).history


def _health_events(events):
    return [e["healthEvent"] for e in events if "healthEvent" in e]


def _counters(mod):
    stats = mod.health_stats()
    return {k: stats[k] for k in ("nonfiniteSteps", "lossSpikes",
                                  "rollbacks", "quarantined")}


@pytest.mark.parametrize("policy", [
    "skip", {"action": "rollback", "maxRollbacks": 2}],
    ids=["skip", "rollback"])
def test_sentinel_under_a_nan_step_matches_jax(monkeypatch, tmp_path,
                                               policy):
    _arm(monkeypatch, "engine_step:1:nan")
    x, y = _toy()
    jm, pm = _pair(x)
    jevents, pevents = [], []
    jhist = _fit(jm, x, y, policy, jevents)
    jax_counts = _counters(jax_health)
    phist = _fit(pm, x, y, policy, pevents)
    np.testing.assert_allclose(phist["loss"], jhist["loss"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(phist["accuracy"], jhist["accuracy"],
                               rtol=RTOL, atol=ATOL)
    assert all(np.isfinite(v) for v in phist["loss"])
    got, want = _health_events(pevents), _health_events(jevents)
    assert len(got) == len(want) == 1
    assert {k: v for k, v in got[0].items() if k not in ("loss", "ema")} \
        == {k: v for k, v in want[0].items() if k not in ("loss", "ema")}
    if want[0]["loss"] is None:
        assert got[0]["loss"] is None
    else:
        np.testing.assert_allclose(got[0]["loss"], want[0]["loss"],
                                   rtol=RTOL)
    assert _counters(health) == jax_counts
    assert phist.get("nonfiniteSteps") == jhist.get("nonfiniteSteps")
    for k, v in weights.params_from_flax(jax.tree_util.tree_map(
            np.asarray, jm.params), sequential=True).items():
        np.testing.assert_allclose(pm.params[k].detach().numpy(),
                                   v.numpy(), atol=5e-5)


def test_fail_policy_raises_numerical_divergence_as_jax(monkeypatch):
    _arm(monkeypatch, "engine_step:1:nan")
    x, y = _toy()
    jm, pm = _pair(x)
    errors = []
    for model in (jm, pm):
        with pytest.raises(Exception) as err:
            _fit(model, x, y, "fail", [])
        errors.append(err.value)
    assert isinstance(errors[1], health.NumericalDivergence)
    assert str(errors[1]) == str(errors[0])
    assert "nonfinite" in str(errors[1])


def test_rollback_run_equals_a_clean_run_bit_for_bit(monkeypatch,
                                                     tmp_path):
    """The replayed epoch from the last good state reaches the params a
    never-faulted run reaches (same policy, no shuffle, no dropout)."""
    x, y = _toy(n=128)
    policy = {"action": "rollback", "maxRollbacks": 2}
    _, clean = _pair(x)
    _fit(clean, x, y, policy, [])
    _arm(monkeypatch, "engine_step:1:nan")
    _, faulted = _pair(x)
    ck = Checkpointer(str(tmp_path / "ck"))
    _fit(faulted, x, y, policy, [], checkpointer=ck)
    assert health.health_stats()["rollbacks"] == 1
    for k, v in clean.params.items():
        assert torch.equal(faulted.params[k], v), k


def test_rollback_budget_exhaustion_escalates_as_jax(monkeypatch,
                                                     tmp_path):
    """Every epoch poisoned: one rollback, then NumericalDivergence."""
    _arm(monkeypatch, "engine_step:99:nan")
    x, y = _toy()
    jm, pm = _pair(x)
    policy = {"action": "rollback", "maxRollbacks": 1}
    messages = []
    for model, root in ((jm, "j"), (pm, "p")):
        with pytest.raises(Exception) as err:
            _fit(model, x, y, policy, [], epochs=4)
        messages.append(str(err.value))
    assert messages[1] == messages[0]
    assert "after 1 rollbacks" in messages[1]
    assert health.health_stats()["rollbacks"] == 1


def test_skip_keeps_the_optimizer_count_of_good_steps(monkeypatch):
    """A skipped step moves neither the params nor Adam's count: the
    count lives on the card for the fit and comes back as an int."""
    _arm(monkeypatch, "engine_step:1:nan")
    x, y = _toy(n=64)
    _, pm = _pair(x)
    eng = pm._get_engine()
    state = eng.init_state(pm.params, pm.model_state)
    batcher = pm._batcher(x, y, 32)
    state, hist = eng.fit(state, batcher, epochs=2, health_policy="skip")
    assert state.step == 4
    assert state.opt_state["count"] == 3
    assert isinstance(state.opt_state["count"], int)
    assert hist[0]["nonfiniteSteps"] == 1


def test_spike_verdict_after_the_ema_warms_as_jax():
    from learningorchestra_tpu.runtime.engine import Engine as JaxEngine

    def run(engine_cls, mod):
        eng = object.__new__(engine_cls)
        policy = mod.coerce_policy(
            {"action": "fail", "spikeFactor": 4.0, "emaAlpha": 0.5})
        sent = engine_cls._new_sentinel()
        out = []
        for epoch, loss in enumerate((1.0, 1.0, 3.0)):
            result = eng._health_epoch_end(policy, sent, epoch, 0, loss,
                                           None, None, None, None)
            out.append((result[0], result[-1], sent["ema"]))
        with pytest.raises(mod.NumericalDivergence) as err:
            eng._health_epoch_end(policy, sent, 3, 0, 50.0, None, None,
                                  None, None)
        return out, str(err.value), mod.health_stats()["lossSpikes"]

    assert run(Engine, health) == run(JaxEngine, jax_health)


# ----------------------------------------------------------------------
# checkpoint integrity under the corrupt fault
# ----------------------------------------------------------------------
def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}


def test_corrupt_site_exercises_the_quarantine_fallback(monkeypatch,
                                                        tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1))
    _arm(monkeypatch, "ckpt_write:1:corrupt:4")
    ck.save(2, _tree(2))  # the budget fires here, after the checksum
    assert ck.latest_step() == 2  # same size: the cheap check passes
    with pytest.warns(RuntimeWarning, match="quarantined"):
        out = ck.restore(_tree(99))
    np.testing.assert_array_equal(out["w"], _tree(1)["w"])
    assert health.health_stats()["quarantined"] == 1
    assert (tmp_path / ".quarantine").is_dir()
