"""The port's staged whole-epoch fit and its prefetch feed
(``learningorchestra_tpu_torch/runtime/engine.py``,
``runtime/data.py``) on the CPU.

- Staged (the padded epoch on the device once, each step gathered there),
  the prefetch feed (``scan_batches=False`` or
  ``LO_SCAN_FIT_MAX_BYTES=0``; on the CPU the feed hands the host batches
  back unchanged) and a per-step reference loop over ``batcher.epoch``
  give the same params and losses bit for bit: a small LM (its
  attention's plain versions), a CNN and the Builder's LR.
- Against the JAX package's scanned fit of the same MLP and CNN from the
  same weights, unshuffled, in float32: losses within 1e-5 relative and
  params within atol 2e-5.
- A tokened fit keeps its staged tensors in the device arena; a cancel
  mid-epoch, a NaN rollback and a ``NumericalDivergence`` each leave no
  pin behind (the entry can be evicted), a poisoned step leaves the
  arena's tensors clean, and a sample weight turns reuse off.
"""

import jax
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.models.neural import NeuralModel as JaxNeuralModel
from learningorchestra_tpu.services import faults as jax_faults
from learningorchestra_tpu_torch.models import NeuralModel, weights
from learningorchestra_tpu_torch.models import transformer as tlm
from learningorchestra_tpu_torch.models.estimators import \
    LogisticRegressionJAX
from learningorchestra_tpu_torch.runtime import arena, health, preempt
from learningorchestra_tpu_torch.runtime import data as port_data
from learningorchestra_tpu_torch.runtime.data import (ArrayBatcher,
                                                      prefetch_to_device)
from learningorchestra_tpu_torch.runtime.engine import Engine
from learningorchestra_tpu_torch.services import faults

torch.set_num_threads(2)

MLP = [{"kind": "dense", "units": 16, "activation": "relu"},
       {"kind": "dense", "units": 2, "activation": "softmax"}]
CNN = [{"kind": "conv2d", "filters": 4, "kernel": [3, 3],
        "activation": "relu"},
       {"kind": "maxpool2d", "pool": [2, 2]},
       {"kind": "flatten"},
       {"kind": "dense", "units": 3, "activation": "softmax"}]
LM_CFG = dict(vocab_size=61, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, max_len=32)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """float32 compute, no armed fault, a fresh default arena and health
    counters, and a JAX config of its own."""
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    monkeypatch.delenv("LO_FAULT_INJECT", raising=False)
    monkeypatch.delenv("LO_SCAN_FIT_MAX_BYTES", raising=False)
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax")))
    for mod in (faults, jax_faults):
        mod.reset()
    health.reset_health_stats()
    arena.reset_default_arena()
    yield
    arena.reset_default_arena()
    jax_config.reset_config()
    for mod in (faults, jax_faults):
        mod.reset()
    preempt.clear_cancel()


def _toy(n=256, features=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, features)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int64)
    return x, y


def _images(n=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int64)
    return x, y


def _params(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _per_step(eng, state, batcher, epochs):
    """The per-step reference: every batch of ``batcher.epoch`` straight
    to the train step, as the engine's feeds must give them (its params
    are compared; its epoch losses would sum on the host)."""
    for epoch in range(epochs):
        for batch in batcher.epoch(epoch):
            eng._train_step_body(
                state, Engine._to_device(batch, torch.device("cpu")), 0)


# ----------------------------------------------------------------------
# staged == prefetch feed == per-step, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("body,data", [(MLP, _toy), (CNN, _images)],
                         ids=["mlp", "cnn"])
def test_staged_equals_prefetch_and_per_step(body, data):
    x, y = data()
    init = None
    runs = {}
    for mode in ("staged", "prefetch", "perStep"):
        model = NeuralModel(body, device="cpu")
        if init is None:
            model._build_params(model._coerce_x(x))
            init = (_params(model.params), _params(model.model_state))
        else:
            model.set_params(*init, input_shape=x.shape[1:])
        eng = model._get_engine()
        state = eng.init_state(model.params, model.model_state)
        batcher = model._batcher(x, y, 32, shuffle=True)
        assert eng._should_stage(batcher)
        losses = None
        if mode == "perStep":
            _per_step(eng, state, batcher, 3)
        else:
            _, hist = eng.fit(state, batcher, epochs=3,
                              scan_batches=mode == "staged")
            losses = [h["loss"] for h in hist]
        runs[mode] = (losses, _params(model.params))
    assert runs["prefetch"][0] == runs["staged"][0]
    for mode in ("prefetch", "perStep"):
        _assert_equal(runs[mode][1], runs["staged"][1])


def test_lm_fit_staged_equals_the_prefetch_feed(monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.integers(1, LM_CFG["vocab_size"], size=(48, 17)).astype(np.int32)
    init = weights.params_from_flax(weights.init_params(LM_CFG, seed=0))
    runs = {}
    for mode, limit in (("staged", None), ("prefetch", "0")):
        if limit is None:
            monkeypatch.delenv("LO_SCAN_FIT_MAX_BYTES", raising=False)
        else:
            monkeypatch.setenv("LO_SCAN_FIT_MAX_BYTES", limit)
        lm = tlm.LanguageModel(**LM_CFG, device="cpu")
        lm.set_params(init)
        batcher = lm._batcher(x, 8, shuffle=True)
        assert lm._get_engine()._should_stage(batcher) == (limit is None)
        hist = lm.fit(x, batch_size=8, epochs=2, grad_accum=2).history
        runs[mode] = (hist["loss"], _params(lm._master_params()))
    assert runs["prefetch"][0] == runs["staged"][0]
    _assert_equal(runs["prefetch"][1], runs["staged"][1])


def test_lr_fit_staged_through_the_arena_equals_the_prefetch_feed(
        monkeypatch):
    x, y = _toy(n=512, features=4, seed=3)
    fits = {}
    for mode in ("arena", "staged", "prefetch"):
        monkeypatch.setenv("LO_SCAN_FIT_MAX_BYTES",
                           "0" if mode == "prefetch" else str(1 << 30))
        lr = LogisticRegressionJAX(epochs=3, batch_size=64, device="cpu")
        if mode == "arena":
            lr.feature_token = ("builder", "ds", 1)
            lr.feature_tags = ("ds",)
        lr.fit(x, y)
        fits[mode] = lr
    for mode in ("staged", "prefetch"):
        for k in ("w", "b"):
            np.testing.assert_array_equal(fits[mode].params[k],
                                          fits["arena"].params[k])
        assert [h["loss"] for h in fits[mode].history] == \
            [h["loss"] for h in fits["arena"].history]
    s = arena.get_default_arena().stats()
    assert (s["entries"], s["misses"], s["pins"]) == (1, 1, 0)
    # a repeat fit with the token is a hit on the staged tensors
    again = LogisticRegressionJAX(epochs=3, batch_size=64, device="cpu")
    again.feature_token, again.feature_tags = ("builder", "ds", 1), ("ds",)
    monkeypatch.setenv("LO_SCAN_FIT_MAX_BYTES", str(1 << 30))
    again.fit(x, y)
    np.testing.assert_array_equal(again.params["w"], fits["arena"].params["w"])
    assert arena.get_default_arena().stats()["hits"] == 1


def test_prefetch_feed_on_the_cpu_hands_batches_back():
    batches = [{"x": np.arange(4) + i} for i in range(3)]
    out = list(prefetch_to_device(iter(batches), "cpu", buffer_size=1))
    assert len(out) == 3 and all(a is b for a, b in zip(out, batches))


@pytest.mark.parametrize("n,buffer,threaded", [
    (256, None, True), (32, None, False), (256, "0", False)],
    ids=["steps-prefetch", "one-step-copy", "buffer0-copy"])
def test_the_host_feed_takes_the_prefetch_thread_over_one_step(
        monkeypatch, n, buffer, threaded):
    """A fit that is not staged goes through the prefetch feed only when
    its epoch takes more than one step and ``LO_PREFETCH_BUFFER`` is
    above 0; otherwise the step copies each host batch. Either way the
    fit equals the staged one bit for bit."""
    from learningorchestra_tpu_torch.runtime import engine as engine_lib

    if buffer is None:
        monkeypatch.delenv("LO_PREFETCH_BUFFER", raising=False)
    else:
        monkeypatch.setenv("LO_PREFETCH_BUFFER", buffer)
    fed = []

    def counted(batches, device):
        fed.append(device)
        return prefetch_to_device(batches, device)

    monkeypatch.setattr(engine_lib, "prefetch_to_device", counted)
    x, y = _toy(n=n)
    runs = {}
    init = None
    for staged in (True, False):
        model = NeuralModel(MLP, device="cpu")
        if init is None:
            model._build_params(model._coerce_x(x))
            init = (_params(model.params), _params(model.model_state))
        else:
            model.set_params(*init, input_shape=x.shape[1:])
        eng = model._get_engine()
        state = eng.init_state(model.params, model.model_state)
        _, hist = eng.fit(state, model._batcher(x, y, 32), epochs=2,
                          scan_batches=staged)
        runs[staged] = ([h["loss"] for h in hist], _params(model.params))
    assert len(fed) == (2 if threaded else 0)
    assert runs[False][0] == runs[True][0]
    _assert_equal(runs[False][1], runs[True][1])


def test_the_staging_rule_is_the_jax_rule(monkeypatch):
    from learningorchestra_tpu.runtime import data as jax_data
    from learningorchestra_tpu.runtime.engine import Engine as JaxEngine

    x, y = _toy(n=64)
    for limit, n, bs in ((None, 64, 32), (None, 64, 64), ("0", 64, 32),
                         ("100", 64, 32), (str(64 * 8 * 4 + 64 * 8), 64,
                                           16)):
        if limit is None:
            monkeypatch.delenv("LO_SCAN_FIT_MAX_BYTES", raising=False)
        else:
            monkeypatch.setenv("LO_SCAN_FIT_MAX_BYTES", limit)
        jax_config.reset_config()
        ours = ArrayBatcher({"x": x[:n], "y": y[:n]}, bs)
        theirs = jax_data.ArrayBatcher({"x": x[:n], "y": y[:n]}, bs)
        assert Engine._should_stage(ours) == \
            JaxEngine._should_scan(object.__new__(JaxEngine), theirs), \
            (limit, n, bs)


def test_a_sample_weight_turns_reuse_off():
    from learningorchestra_tpu.runtime import data as jax_data

    x, y = _toy(n=64)
    for lib in (jax_data, port_data):
        plain = lib.ArrayBatcher({"x": x, "y": y}, 16, cache_token="t",
                                 cache_tags=["ds"])
        weighted = lib.ArrayBatcher({"x": x, "y": y}, 16, cache_token="t",
                                    cache_tags=["ds"],
                                    sample_weight=np.ones(64))
        assert plain.cache_token == "t" and plain.cache_tags == ("ds",)
        assert weighted.cache_token is None
    model = NeuralModel(MLP, device="cpu")
    model._build_params(model._coerce_x(x))
    eng = model._get_engine()
    weighted = ArrayBatcher({"x": x, "y": y}, 16, cache_token="t",
                            sample_weight=np.full(64, 0.5, np.float32))
    eng.fit(eng.init_state(model.params, model.model_state), weighted,
            epochs=1)
    assert arena.get_default_arena().stats()["misses"] == 0


# ----------------------------------------------------------------------
# against the JAX package's scanned fit
# ----------------------------------------------------------------------
def _jax_pair(body, x):
    jm = JaxNeuralModel(body)
    jm._build_params(jm._coerce_x(x))
    pm = NeuralModel(body, device="cpu")
    pm.set_params(weights.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jm.params), sequential=True),
        {}, input_shape=jm.input_shape)
    return jm, pm


@pytest.mark.parametrize("body,data", [(MLP, _toy), (CNN, _images)],
                         ids=["mlp", "cnn"])
def test_staged_fit_matches_the_jax_scanned_fit(body, data):
    from learningorchestra_tpu.runtime.engine import Engine as JaxEngine

    x, y = data()
    jm, pm = _jax_pair(body, x)
    scanned = []
    real = JaxEngine._fit_scanned

    def watched(self, *a, **k):
        scanned.append(True)
        return real(self, *a, **k)

    JaxEngine._fit_scanned = watched
    try:
        jhist = jm.fit(x, y, epochs=3, batch_size=32, shuffle=False).history
    finally:
        JaxEngine._fit_scanned = real
    assert scanned, "the JAX fit did not take its scanned path"
    batcher = pm._batcher(x, y, 32)
    assert pm._get_engine()._should_stage(batcher)
    phist = pm.fit(x, y, epochs=3, batch_size=32, shuffle=False).history
    np.testing.assert_allclose(phist["loss"], jhist["loss"], rtol=1e-5)
    want = weights.params_from_flax(jax.tree_util.tree_map(
        np.asarray, jm.params), sequential=True)
    for k, v in want.items():
        np.testing.assert_allclose(pm.params[k].detach().numpy(),
                                   v.numpy(), atol=2e-5)


# ----------------------------------------------------------------------
# the arena pin on every unwind
# ----------------------------------------------------------------------
def _tokened(model, x, y, bs=32):
    return ArrayBatcher({"x": model._coerce_x(x), "y": model._coerce_y(y)},
                        bs, shuffle=True, seed=0, cache_token=("ds", 1),
                        cache_tags=("ds",))


def _evictable():
    """The default arena's entries are unpinned, and a later insert that
    does not fit beside them evicts them."""
    a = arena.get_default_arena()
    s = a.stats()
    assert s["pins"] == 0 and s["entries"] == 1, s
    budget = s["byteBudget"]
    a.get_or_put("filler", lambda: {"x": torch.zeros(budget // 4 - 16)}
                 ).release()
    assert a.stats()["evictions"] == 1


def test_a_cancel_mid_epoch_leaves_no_pin(monkeypatch):
    x, y = _toy()
    model = NeuralModel(MLP, device="cpu")
    model._build_params(model._coerce_x(x))
    eng = model._get_engine()
    token = preempt.CancelToken()
    preempt.install_cancel(token)
    steps = []
    real = Engine._train_step_body

    def counted(self, *a, **k):
        steps.append(1)
        if len(steps) == 3:
            token.cancel("cancelled")
        return real(self, *a, **k)

    monkeypatch.setattr(Engine, "_train_step_body", counted)
    with pytest.raises(preempt.JobCancelled):
        eng.fit(eng.init_state(model.params, model.model_state),
                _tokened(model, x, y), epochs=2)
    assert len(steps) == 3  # the fourth step of 8 never ran
    _evictable()


def test_a_feed_stopped_by_a_cancel_raises_without_a_record(monkeypatch):
    """The prefetch feed's producer stops at a cancel (on the card) and
    the epoch's batches end early: the fit raises, records nothing."""
    from learningorchestra_tpu_torch.runtime import engine as engine_lib

    x, y = _toy()
    model = NeuralModel(MLP, device="cpu")
    model._build_params(model._coerce_x(x))
    eng = model._get_engine()
    token = preempt.CancelToken()
    preempt.install_cancel(token)

    def stopping_feed(batches, device):
        for i, batch in enumerate(batches):
            if i == 3:
                token.cancel("cancelled")
            if token.cancelled():
                return  # as the producer thread does
            yield batch

    monkeypatch.setattr(engine_lib, "prefetch_to_device", stopping_feed)
    records = []
    with pytest.raises(preempt.JobCancelled):
        eng.fit(eng.init_state(model.params, model.model_state),
                model._batcher(x, y, 32), epochs=2, scan_batches=False,
                log_fn=records.append)
    assert records == []


def test_a_nan_rollback_leaves_no_pin_and_a_clean_entry(monkeypatch):
    monkeypatch.setenv("LO_FAULT_INJECT", "engine_step:1:nan")
    faults.reset()
    x, y = _toy()
    model = NeuralModel(MLP, device="cpu")
    model._build_params(model._coerce_x(x))
    eng = model._get_engine()
    batcher = _tokened(model, x, y)
    state, hist = eng.fit(eng.init_state(model.params, model.model_state),
                          batcher, epochs=2,
                          health_policy={"action": "rollback",
                                         "maxRollbacks": 2})
    assert health.health_stats()["rollbacks"] == 1
    assert all(np.isfinite(h["loss"]) for h in hist)
    # the poisoned step's copy went NaN, never the staged tensors
    a = arena.get_default_arena()
    entry = a.get_or_put(("fit_arrays", ("ds", 1), batcher.steps_per_epoch,
                          32, True, "cpu"),
                         lambda: pytest.fail("the entry was not kept"))
    assert all(bool(torch.isfinite(t.float()).all())
               for t in entry.arrays.values())
    np.testing.assert_array_equal(entry.arrays["x"][:256].numpy(),
                                  model._coerce_x(x))
    entry.release()
    _evictable()


def test_numerical_divergence_leaves_no_pin(monkeypatch):
    monkeypatch.setenv("LO_FAULT_INJECT", "engine_step:1:nan")
    faults.reset()
    x, y = _toy()
    model = NeuralModel(MLP, device="cpu")
    model._build_params(model._coerce_x(x))
    eng = model._get_engine()
    with pytest.raises(health.NumericalDivergence):
        eng.fit(eng.init_state(model.params, model.model_state),
                _tokened(model, x, y), epochs=2, health_policy="fail")
    _evictable()


def test_a_repeat_tokened_fit_hits_and_matches(monkeypatch):
    x, y = _toy()
    out = []
    for _ in range(2):
        model = NeuralModel(MLP, device="cpu")
        if not out:
            model._build_params(model._coerce_x(x))
            init = _params(model.params)
        else:
            model.set_params(init, {}, input_shape=x.shape[1:])
        eng = model._get_engine()
        eng.fit(eng.init_state(model.params, model.model_state),
                _tokened(model, x, y), epochs=2)
        out.append(_params(model.params))
    _assert_equal(out[0], out[1])
    s = arena.get_default_arena().stats()
    assert (s["hits"], s["misses"], s["pins"]) == (1, 1, 0)
    # the tag invalidates it
    assert arena.get_default_arena().invalidate("ds") == 1


def test_the_jax_token_rule_for_the_card_families():
    """Both packages' LR carries the token the Builder stamps into its
    batcher; a fit without one stages nothing in the arena."""
    from learningorchestra_tpu.models.estimators import \
        LogisticRegressionJAX as JaxLR

    ours, theirs = LogisticRegressionJAX(device="cpu"), JaxLR()
    assert ours.feature_token is None and theirs.feature_token is None
    assert ours.feature_tags == theirs.feature_tags == ()
    x, y = _toy(n=256, features=4)
    ours.batch_size = 32
    ours.fit(x, y)
    assert arena.get_default_arena().stats()["misses"] == 0
