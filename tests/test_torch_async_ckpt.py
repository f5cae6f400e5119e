"""The port's asynchronous checkpoint commit, sharded step layout and
params-only migration, against the JAX package's.

- The cases of ``tests/test_async_ckpt.py`` run on the port (the bounded
  quarantine, the torn commit and the atomic sidecar are already run by
  ``tests/test_torch_checkpoint.py``): FIFO commits with reads that
  barrier, the sidecar on the same queue, a latched commit failure, no
  save after close, ``wrap_checkpointer`` and its config, the sharded
  layout, shard corruption and the verified partial restore.
- Sharded step dirs cross packages both ways (``shards=3``).
- A fit through the asynchronous manager equals a synchronous one: the
  same losses and params, and each step dir's payload bytes.
- The params-only migration against the JAX package's on one step dir
  (written with sgd, resumed with adam): the same grafted params and
  step, the next epoch's loss within 1e-5 relative; a step dir that
  turns unreadable between the failed restore and the migration's read
  re-raises in both packages.

float32, small shapes, inputs from numpy seeds.
"""

import dataclasses
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learningorchestra_tpu.runtime import checkpoint as jax_ckpt
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.models.neural import build_optimizer
from learningorchestra_tpu_torch.models.transformer import LanguageModel
from learningorchestra_tpu_torch.runtime import engine as engine_lib
from learningorchestra_tpu_torch.runtime.async_ckpt import (
    AsyncCheckpointError, AsyncCheckpointManager, wrap_checkpointer)
from learningorchestra_tpu_torch.runtime.checkpoint import (
    CheckpointCorrupted, Checkpointer)
from learningorchestra_tpu_torch.runtime.data import ArrayBatcher
from learningorchestra_tpu_torch.services import faults

torch.set_num_threads(2)

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           max_len=32)


def _tree(step):
    return {"step": np.int32(step),
            "params": {"w": np.full((4, 4), float(step), np.float32),
                       "b": np.arange(8, dtype=np.float32) + step}}


def _corrupt_first_payload(ckpt_dir, step):
    """Flips bytes of one payload file without changing its size, so the
    size check passes and the sha256 re-hash must catch it."""
    step_dir = os.path.join(ckpt_dir, str(step))
    names = sorted(n for n in os.listdir(step_dir) if n.endswith(".msgpack"))
    with open(os.path.join(step_dir, names[0]), "r+b") as f:
        f.seek(0)
        f.write(b"\xde\xad\xbe\xef")


@pytest.fixture(autouse=True)
def _faults_reset():
    faults.reset()
    yield
    faults.reset()


# ----------------------------------------------------------------------
# the asynchronous manager (tests/test_async_ckpt.py)
# ----------------------------------------------------------------------
def test_async_fifo_commits_and_reads_barrier(tmp_path):
    mgr = AsyncCheckpointManager(
        Checkpointer(str(tmp_path / "ck"), max_to_keep=10))
    try:
        for step in (1, 2, 3, 5, 8):
            mgr.save(step, _tree(step))
        # every read waits for the queue: what was saved is on disk
        assert mgr.latest_step() == 8
        restored = mgr.restore(_tree(0))
        np.testing.assert_array_equal(restored["params"]["w"],
                                      _tree(8)["params"]["w"])
        on_disk = sorted(int(d) for d in os.listdir(tmp_path / "ck")
                         if d.isdigit())
        assert on_disk == [1, 2, 3, 5, 8]
        assert [c["step"] for c in mgr.commits] == [1, 2, 3, 5, 8]
        assert [s["step"] for s in mgr.snapshots] == [1, 2, 3, 5, 8]
    finally:
        mgr.close()


def test_async_meta_rides_the_same_fifo(tmp_path):
    mgr = AsyncCheckpointManager(Checkpointer(str(tmp_path / "ck")))
    try:
        mgr.save(1, _tree(1))
        mgr.save_meta({"epoch": 7})
        assert mgr.load_meta() == {"epoch": 7}
    finally:
        mgr.close()


def test_async_commit_failure_latches_on_train_thread(tmp_path):
    mgr = AsyncCheckpointManager(
        Checkpointer(str(tmp_path / "ck")),
        config=Config(home=str(tmp_path),
                      fault_inject="ckpt_async_commit:1:raise"))
    try:
        mgr.save(1, _tree(1))  # the worker fails, latches, keeps draining
        with pytest.raises(AsyncCheckpointError) as err:
            mgr.wait_until_finished()
        assert isinstance(err.value.__cause__, faults.InjectedFault)
        # the latched error raises on the next save too
        with pytest.raises(AsyncCheckpointError):
            mgr.save(2, _tree(2))
        # the failed commit left no accepted step, and its snapshot left
        # the X-ray ledger (the JAX package's stays: ROADMAP Queue 3
        # item 35)
        assert Checkpointer(str(tmp_path / "ck")).latest_step() is None
        from learningorchestra_tpu_torch.observability import xray
        assert xray.by_owner()["snapshot"] == 0
    finally:
        # close() drains without raising and does not hang
        mgr.close()


def test_async_save_after_close_refuses(tmp_path):
    mgr = AsyncCheckpointManager(Checkpointer(str(tmp_path / "ck")))
    mgr.close()
    with pytest.raises(AsyncCheckpointError):
        mgr.save(1, _tree(1))


def test_wrap_checkpointer_honors_config(tmp_path, monkeypatch):
    sync = Checkpointer(str(tmp_path / "ck"))
    off = Config(home=str(tmp_path), ckpt_async=False)
    assert wrap_checkpointer(sync, config=off) is sync
    cfg = dataclasses.replace(off, ckpt_async=True, ckpt_inflight=3)
    wrapped = wrap_checkpointer(sync, config=cfg)
    assert isinstance(wrapped, AsyncCheckpointManager)
    assert wrapped._queue.maxsize == 3
    wrapped.close()
    # the environment's knobs, as the JAX package reads them
    monkeypatch.setenv("LO_CKPT_ASYNC", "1")
    monkeypatch.setenv("LO_CKPT_INFLIGHT", "5")
    env = wrap_checkpointer(Checkpointer(str(tmp_path / "ck2")))
    assert isinstance(env, AsyncCheckpointManager)
    assert env._queue.maxsize == 5
    env.close()


# ----------------------------------------------------------------------
# the sharded layout (tests/test_async_ckpt.py)
# ----------------------------------------------------------------------
def test_sharded_layout_roundtrip(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"), shards=2)
    ckpt.save(3, _tree(3))
    step_dir = tmp_path / "ck" / "3"
    names = sorted(os.listdir(step_dir))
    assert "shard-00000-of-00002.msgpack" in names
    assert "shard-00001-of-00002.msgpack" in names
    assert "checkpoint.msgpack" not in names
    with open(step_dir / "manifest.json") as f:
        manifest = json.load(f)
    assert set(manifest["files"]) == {n for n in names
                                      if n.endswith(".msgpack")}
    restored = ckpt.restore(_tree(0))
    np.testing.assert_array_equal(restored["params"]["b"],
                                  _tree(3)["params"]["b"])


def test_shard_corruption_quarantines_and_falls_back(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=5, shards=2)
    ckpt.save(1, _tree(1))
    ckpt.save(2, _tree(2))
    _corrupt_first_payload(str(tmp_path / "ck"), 2)
    # the size check passes, so latest_step is fooled...
    assert ckpt.latest_step() == 2
    # ...but the re-hashing restore quarantines the step and falls back
    with pytest.warns(RuntimeWarning, match="quarantined"):
        restored = ckpt.restore(_tree(0))
    np.testing.assert_array_equal(restored["params"]["w"],
                                  _tree(1)["params"]["w"])
    assert len(os.listdir(tmp_path / "ck" / ".quarantine")) == 1
    assert ckpt.latest_step() == 1


def test_restore_partial_verifies_and_falls_back(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=5, shards=2)
    ckpt.save(1, _tree(1))
    ckpt.save(2, _tree(2))
    _corrupt_first_payload(str(tmp_path / "ck"), 2)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        out = ckpt.restore_partial({"params": _tree(0)["params"]})
    np.testing.assert_array_equal(out["params"]["w"], _tree(1)["params"]["w"])
    # an explicitly requested corrupt step has no substitute
    ckpt.save(4, _tree(4))
    _corrupt_first_payload(str(tmp_path / "ck"), 4)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        with pytest.raises(CheckpointCorrupted):
            ckpt.restore_partial({"params": _tree(0)["params"]}, step=4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_step_dirs_cross_packages(tmp_path, writer):
    """A ``shards=3`` step dir of either package restores in the other,
    fully and partially, and its files are the other's byte for byte."""
    tree = {"step": np.asarray(5, np.int64),
            "params": {"w": np.arange(24, dtype=np.float32).reshape(6, 4),
                       "b": np.ones(4, np.float32),
                       "e": np.full((3, 2), 2.0, np.float32)},
            "opt_state": {"trace": {"w": np.zeros((6, 4), np.float32)}}}
    make = {"jax": jax_ckpt.Checkpointer, "port": Checkpointer}
    other = "port" if writer == "jax" else "jax"
    make[writer](str(tmp_path / writer), shards=3).save(5, tree)
    make[other](str(tmp_path / other), shards=3).save(5, tree)
    names = sorted(os.listdir(tmp_path / writer / "5"))
    assert names == sorted(os.listdir(tmp_path / other / "5"))
    assert sum(n.startswith("shard-") for n in names) == 3
    for name in names:
        if name.startswith("shard-"):
            assert (tmp_path / writer / "5" / name).read_bytes() == \
                (tmp_path / other / "5" / name).read_bytes()
    reader = make[other](str(tmp_path / writer))
    got = reader.restore(tree)
    for k, v in tree["params"].items():
        np.testing.assert_array_equal(np.asarray(got["params"][k]), v)
    assert int(got["step"]) == 5
    part = reader.restore_partial({"params": tree["params"]})
    np.testing.assert_array_equal(np.asarray(part["params"]["e"]),
                                  tree["params"]["e"])


# ----------------------------------------------------------------------
# a fit through the manager
# ----------------------------------------------------------------------
def test_async_fit_equals_sync_fit(tmp_path, monkeypatch):
    """The language model's fit (dropout, shuffle, grad_accum 2, 2
    epochs) through the asynchronous manager: the losses and params of
    the synchronous fit, and each step dir's payload bytes; the
    snapshots ledger nothing once committed."""
    from learningorchestra_tpu_torch.observability import xray

    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    tree = weights.init_params(CFG, seed=0)
    x = ((np.random.default_rng(1).integers(1, 64, size=16)[:, None]
          + np.arange(32)[None, :]) % 63 + 1).astype(np.int32)
    runs = {}
    for mode in ("sync", "async"):
        lm = LanguageModel(**CFG, dropout=0.1, device="cpu")
        lm.set_params(weights.params_from_flax(tree))
        ckpt = Checkpointer(str(tmp_path / mode))
        if mode == "async":
            ckpt = AsyncCheckpointManager(ckpt)
        hist = lm.fit(x, batch_size=8, epochs=2, grad_accum=2,
                      shuffle=True, checkpointer=ckpt).history
        ckpt.close()
        runs[mode] = (hist["loss"], {k: v.detach().clone()
                                     for k, v in lm.params.items()}, ckpt)
    assert runs["async"][0] == runs["sync"][0]
    for k, v in runs["sync"][1].items():
        assert torch.equal(runs["async"][1][k], v), k
    steps = sorted(n for n in os.listdir(tmp_path / "sync") if n.isdigit())
    assert steps == sorted(n for n in os.listdir(tmp_path / "async")
                           if n.isdigit()) and len(steps) == 2
    for step in steps:
        assert (tmp_path / "sync" / step / "checkpoint.msgpack").read_bytes() \
            == (tmp_path / "async" / step / "checkpoint.msgpack").read_bytes()
    mgr = runs["async"][2]
    assert [c["bytes"] for c in mgr.commits] == \
        [c["bytes"] for c in runs["sync"][2].commits]
    assert len(mgr.snapshots) == 2 and all(
        s["bytes"] > 0 and s["seconds"] >= 0 for s in mgr.snapshots)
    assert xray.by_owner()["snapshot"] == 0


# ----------------------------------------------------------------------
# the params-only migration (tests/test_runtime.py)
# ----------------------------------------------------------------------
def _linear_data():
    x = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    return x, y


def _jax_engine(opt):
    from learningorchestra_tpu.runtime import engine as E
    from learningorchestra_tpu.runtime import mesh as M

    def apply_fn(params, model_state, batch, train, rng_):
        return batch["x"] @ params["w"], model_state

    return E.Engine(apply_fn, E.mse_loss, opt, mesh=M.build_mesh("auto"),
                    compute_dtype=jnp.float32)


def _jax_batcher():
    from learningorchestra_tpu.runtime.data import ArrayBatcher as JaxBatcher

    x, y = _linear_data()
    return JaxBatcher({"x": x, "y": y}, 8, dp_multiple=8)


def _port_engine(spec):
    return engine_lib.Engine(
        apply_fn=lambda p, b, train, rng: b["x"] @ p["w"],
        loss_fn=engine_lib.mse_loss, optimizer=build_optimizer(spec),
        compute_dtype=torch.float32)


def _port_batcher():
    x, y = _linear_data()
    return ArrayBatcher({"x": x, "y": y}, 8)


def _written_by_jax(root):
    """A step dir of 2 sgd epochs of the JAX engine: (dir, params,
    step)."""
    eng = _jax_engine(optax.sgd(0.1))
    state = eng.init_state({"w": jnp.zeros((3, 1))})
    state, _ = eng.fit(state, _jax_batcher(), epochs=2,
                       checkpointer=jax_ckpt.Checkpointer(str(root)))
    return np.asarray(state.params["w"]), int(state.step)


def test_params_only_migration_matches_jax(tmp_path, tmp_config):
    trained_w, trained_step = _written_by_jax(tmp_path / "ck")
    assert not np.allclose(trained_w, 0.0)
    shutil.copytree(tmp_path / "ck", tmp_path / "ck_port")
    # the JAX engine resumed with adam: params grafted, a fresh optimizer
    jeng = _jax_engine(optax.adam(0.1))
    jstate = jeng.init_state({"w": jnp.zeros((3, 1))})
    with pytest.warns(UserWarning, match="rebuilt optimizer"):
        jstate, jhist = jeng.fit(jstate, _jax_batcher(), epochs=3,
                                 checkpointer=jax_ckpt.Checkpointer(
                                     str(tmp_path / "ck")))
    # the port's engine on the same step dir
    peng = _port_engine({"kind": "adam", "learning_rate": 0.1})
    probe = peng.init_state({"w": torch.zeros(3, 1, requires_grad=True)})
    with pytest.warns(UserWarning, match="rebuilt optimizer state fresh"):
        assert peng._maybe_restore(probe, Checkpointer(
            str(tmp_path / "ck_port")))
    assert probe.step == trained_step
    np.testing.assert_array_equal(probe.params["w"].detach().numpy(),
                                  trained_w)
    assert probe.opt_state["count"] == 0 and set(probe.opt_state) == {
        "count", "mu", "nu"}
    pstate = peng.init_state({"w": torch.zeros(3, 1, requires_grad=True)})
    with pytest.warns(UserWarning, match="rebuilt optimizer state fresh"):
        pstate, phist = peng.fit(pstate, _port_batcher(), epochs=3,
                                 checkpointer=Checkpointer(
                                     str(tmp_path / "ck_port")))
    assert len(phist) == len(jhist) == 1  # 2 of 3 epochs were done
    assert pstate.step == int(jstate.step) == trained_step + 2
    np.testing.assert_allclose(phist[0]["loss"], jhist[0]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(pstate.params["w"].detach().numpy(),
                               np.asarray(jstate.params["w"]), rtol=1e-5,
                               atol=1e-6)


def test_params_drift_trains_from_scratch_as_jax(tmp_path, tmp_config):
    """Params of another shape cannot be migrated: a warning, and the
    fit starts at step 0 with every epoch to run."""
    _written_by_jax(tmp_path / "ck")
    peng = engine_lib.Engine(
        apply_fn=lambda p, b, train, rng: b["x"] @ p["w"] + p["b"],
        loss_fn=engine_lib.mse_loss,
        optimizer=build_optimizer({"kind": "adam", "learning_rate": 0.1}),
        compute_dtype=torch.float32)
    state = peng.init_state({"w": torch.zeros(3, 1, requires_grad=True),
                             "b": torch.zeros((), requires_grad=True)})
    with pytest.warns(UserWarning, match="training from scratch"):
        state, hist = peng.fit(state, _port_batcher(), epochs=3,
                               checkpointer=Checkpointer(str(tmp_path / "ck")))
    assert len(hist) == 3 and state.step == 6


def test_unreadable_step_dir_reraises_in_both(tmp_path, tmp_config):
    """Layout drift whose params-only read then fails (every step turned
    corrupt after the newest one's structure was read): training from
    scratch could overwrite the last good step, so both packages raise
    the restore's error."""
    _written_by_jax(tmp_path / "ck")
    shutil.copytree(tmp_path / "ck", tmp_path / "ck_port")

    def rotting(cls, root):
        class Rotting(cls):
            def saved_metadata(self, step=None):
                meta = super().saved_metadata(step)
                for name in os.listdir(root):
                    if name.isdigit():
                        _corrupt_first_payload(str(root), name)
                return meta
        return Rotting(str(root))

    jeng = _jax_engine(optax.adam(0.1))
    with pytest.warns(RuntimeWarning, match="quarantined"):
        with pytest.raises((ValueError, KeyError, TypeError)):
            jeng._maybe_restore(jeng.init_state({"w": jnp.zeros((3, 1))}),
                                rotting(jax_ckpt.Checkpointer,
                                        tmp_path / "ck"))
    peng = _port_engine({"kind": "adam", "learning_rate": 0.1})
    with pytest.warns(RuntimeWarning, match="quarantined"):
        with pytest.raises((ValueError, KeyError, TypeError)):
            peng._maybe_restore(
                peng.init_state({"w": torch.zeros(3, 1, requires_grad=True)}),
                rotting(Checkpointer, tmp_path / "ck_port"))
