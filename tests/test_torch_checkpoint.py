"""The port's step checkpoints and resume, against the JAX package's.

- The ``Checkpointer`` cases of the JAX package's own tests
  (``tests/test_health.py``: manifest, bit flip, torn write, all steps
  corrupt, explicit step, leftover ``.tmp``, legacy dir;
  ``tests/test_async_ckpt.py``: bounded quarantine, torn commit, atomic
  and torn sidecar; ``tests/test_runtime.py``: round trip and engine
  resume) run on the port's. Each step dir of either package restores
  in the other: the payload bytes of one tree are equal.
- A 1-epoch fit plus a resume to 2 equals an uninterrupted 2-epoch fit
  bit for bit (dropout 0.1, ``shuffle=True``, ``grad_accum=2``); a
  re-run of a finished fit is a no-op.
- Over REST, as ``tests/test_server.py::test_train_checkpoint_and_patch_resume``:
  ``checkpoint: true`` commits a step after every epoch, PATCH resumes
  with ``epochs`` as the total, DELETE removes the directory; the
  bodies and step dirs are held against the JAX package's.

Small shapes (vocab 64, d_model 32, 2 layers, 32-token windows), float32.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu import native as jax_native
from learningorchestra_tpu.runtime import checkpoint as jax_ckpt
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.models.neural import build_optimizer
from learningorchestra_tpu_torch.models.transformer import LanguageModel
from learningorchestra_tpu_torch.runtime import engine as engine_lib
from learningorchestra_tpu_torch.runtime.checkpoint import (
    CheckpointCorrupted, Checkpointer, load_pytree, save_pytree)
from learningorchestra_tpu_torch.runtime.data import ArrayBatcher
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           max_len=32, sliding_window=16)


ROOFLINE = {"tflopsPerSecPerChip", "mfu", "gbPerSecPerChip",
            "arithmeticIntensity", "hbmBwUtil", "boundBy"}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}


def _flip(path, at):
    raw = bytearray(open(path, "rb").read())
    raw[at] ^= 0xFF
    open(path, "wb").write(bytes(raw))


def _stream(n, seed):
    start = np.random.default_rng(seed).integers(1, 64, size=n)
    return ((start[:, None] + np.arange(32)[None, :]) % 63 + 1) \
        .astype(np.int32)


@pytest.fixture()
def float32(monkeypatch):
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    jax_config.reset_config()
    yield
    jax_config.reset_config()


# ----------------------------------------------------------------------
# the Checkpointer (tests/test_health.py, tests/test_async_ckpt.py)
# ----------------------------------------------------------------------
def test_manifest_written_and_round_trip(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    tree = _tree(0)
    ck.save(1, tree)
    manifest = json.loads((tmp_path / "1" / "manifest.json").read_text())
    assert set(manifest) == {"step", "wallTime", "files"}
    assert manifest["step"] == 1
    entry = manifest["files"]["checkpoint.msgpack"]
    assert len(entry["sha256"]) == 64
    assert entry["bytes"] == os.path.getsize(
        tmp_path / "1" / "checkpoint.msgpack")
    out = ck.restore(_tree(99))
    np.testing.assert_array_equal(out["w"], tree["w"])
    np.testing.assert_array_equal(out["b"], tree["b"])
    assert [c["step"] for c in ck.commits] == [1]
    assert [r["step"] for r in ck.restores] == [1]


def test_step_dirs_cross_packages(tmp_path):
    """The same tree commits the same payload bytes and manifest layout
    in both packages, and each restores the other's step. (The JAX
    checkpointer's tree_map sorts a dict's keys and the codec keeps a
    dict's order, so the tree is given sorted.)"""
    tree = dict(sorted(_tree(3).items()))
    Checkpointer(str(tmp_path / "port")).save(5, tree)
    jax_ckpt.Checkpointer(str(tmp_path / "jax")).save(5, tree)
    assert (tmp_path / "port" / "5" / "checkpoint.msgpack").read_bytes() == \
        (tmp_path / "jax" / "5" / "checkpoint.msgpack").read_bytes()
    for reader in (jax_ckpt.Checkpointer(str(tmp_path / "port")),
                   Checkpointer(str(tmp_path / "jax"))):
        out = reader.restore(_tree(0))
        np.testing.assert_array_equal(np.asarray(out["w"]), tree["w"])
    man = [json.loads((tmp_path / d / "5" / "manifest.json").read_text())
           for d in ("port", "jax")]
    assert man[0]["files"] == man[1]["files"]


def test_bitflip_quarantines_and_falls_back(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _tree(1))
    ck.save(2, _tree(2))
    payload = tmp_path / "2" / "checkpoint.msgpack"
    _flip(payload, os.path.getsize(payload) // 2)
    assert ck.latest_step() == 2  # same size: the cheap check passes
    with pytest.warns(RuntimeWarning, match="quarantined"):
        out = ck.restore(_tree(99))
    np.testing.assert_array_equal(out["w"], _tree(1)["w"])
    assert ck.latest_step() == 1
    qdir = tmp_path / ".quarantine"
    assert qdir.is_dir() and any(n.startswith("2-")
                                 for n in os.listdir(qdir))


def test_truncation_detected_by_cheap_check(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _tree(1))
    ck.save(2, _tree(2))
    payload = tmp_path / "2" / "checkpoint.msgpack"
    payload.write_bytes(payload.read_bytes()[:-16])  # torn write
    assert ck.latest_step() == 1
    with pytest.warns(RuntimeWarning, match="quarantined"):
        out = ck.restore(_tree(99))
    np.testing.assert_array_equal(out["b"], _tree(1)["b"])


def test_all_steps_corrupt_restores_none(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _tree(1))
    _flip(tmp_path / "1" / "checkpoint.msgpack", 0)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert ck.restore(_tree(99)) is None
    assert ck.restores == []


def test_explicit_step_restore_raises_on_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(1, _tree(1))
    ck.save(2, _tree(2))
    _flip(tmp_path / "2" / "checkpoint.msgpack", -1)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        with pytest.raises(CheckpointCorrupted, match="sha256"):
            ck.restore(_tree(99), step=2)
    out = ck.restore(_tree(99), step=1)
    np.testing.assert_array_equal(out["w"], _tree(1)["w"])


def test_leftover_tmp_dir_swept_on_init(tmp_path):
    Checkpointer(str(tmp_path)).save(1, _tree(1))
    stranded = tmp_path / "7.tmp"
    stranded.mkdir()
    (stranded / "checkpoint.msgpack").write_bytes(b"half-written")
    ck = Checkpointer(str(tmp_path))
    assert not stranded.exists()
    assert ck.latest_step() == 1


def test_legacy_dir_without_manifest_still_restores(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1))
    os.remove(tmp_path / "1" / "manifest.json")
    assert ck.latest_step() == 1
    np.testing.assert_array_equal(ck.restore(_tree(99))["w"],
                                  _tree(1)["w"])


def test_old_steps_are_pruned(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        ck.save(step, _tree(step))
    assert sorted(n for n in os.listdir(tmp_path) if n.isdigit()) == \
        ["2", "3"]


def test_quarantine_is_bounded(tmp_path, monkeypatch):
    monkeypatch.setenv("LO_CKPT_QUARANTINE_KEEP", "2")
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=10)
    for step in range(1, 6):
        ck.save(step, _tree(step))
        _flip(tmp_path / "ck" / str(step) / "checkpoint.msgpack", 0)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert ck.restore(_tree(0)) is None
    assert len(os.listdir(tmp_path / "ck" / ".quarantine")) <= 2


def test_crash_mid_commit_never_accepted(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, _tree(1))
    tmp_dir = tmp_path / "ck" / "2.tmp"
    os.makedirs(tmp_dir)
    (tmp_dir / "checkpoint.msgpack").write_bytes(b"torn")
    assert ck.latest_step() == 1
    np.testing.assert_array_equal(ck.restore(_tree(0))["w"], _tree(1)["w"])
    bad = tmp_path / "ck" / "3"
    os.makedirs(bad)
    (bad / "manifest.json").write_text(json.dumps(
        {"step": 3, "wallTime": 0.0, "files": {"checkpoint.msgpack": {
            "sha256": "0" * 64, "bytes": 4}}}))
    assert ck.latest_step() == 1


def test_save_meta_atomic_and_torn_sidecar_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save_meta({"epoch": 3, "step": 12})
    assert not os.path.exists(tmp_path / "ck" / "progress.json.tmp")
    assert ck.load_meta() == {"epoch": 3, "step": 12}
    (tmp_path / "ck" / "progress.json").write_text('{"epoch": 3, "ste')
    assert ck.load_meta() is None


def test_checkpointer_roundtrip_and_pytree_files(tmp_path):
    tree = {"a": np.arange(4.0), "b": {"c": np.ones((2, 2))}}
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(1, tree)
    ck.save(2, {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 2}})
    ck.wait_until_finished()
    assert ck.latest_step() == 2
    assert np.allclose(ck.restore(tree)["a"], np.arange(4.0) * 2)
    path = str(tmp_path / "tree.msgpack")
    save_pytree(tree, path)
    assert np.allclose(load_pytree(path, tree)["b"]["c"], 1.0)
    # the JAX package reads the port's file and writes the same bytes
    assert np.allclose(jax_ckpt.load_pytree(path, tree)["b"]["c"], 1.0)
    jax_ckpt.save_pytree(tree, str(tmp_path / "jax.msgpack"))
    assert open(path, "rb").read() == \
        open(tmp_path / "jax.msgpack", "rb").read()
    ck.close()


def test_sharded_layout_is_refused(tmp_path):
    """The sharded step layout, refused before it was ported, now writes
    the JAX package's shard files byte for byte, and each package
    restores the other's."""
    tree = {"step": np.asarray(3, np.int64), "params": _tree(3),
            "opt_state": {}}
    port = Checkpointer(str(tmp_path / "port"), shards=2)
    port.save(3, tree)
    jax_side = jax_ckpt.Checkpointer(str(tmp_path / "jax"), shards=2)
    jax_side.save(3, tree)
    names = sorted(os.listdir(tmp_path / "port" / "3"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "3")) == [
        "manifest.json", "shard-00000-of-00002.msgpack",
        "shard-00001-of-00002.msgpack"]
    for name in names[1:]:
        assert open(tmp_path / "port" / "3" / name, "rb").read() == \
            open(tmp_path / "jax" / "3" / name, "rb").read()
    for ck in (port, Checkpointer(str(tmp_path / "jax"))):
        got = ck.restore(tree)
        np.testing.assert_array_equal(got["params"]["w"], tree["params"]["w"])
        assert int(got["step"]) == 3 and got["opt_state"] == {}
    got = jax_ckpt.Checkpointer(str(tmp_path / "port")).restore(tree)
    np.testing.assert_array_equal(np.asarray(got["params"]["b"]),
                                  tree["params"]["b"])


# ----------------------------------------------------------------------
# the engine (tests/test_runtime.py::test_checkpoint_resume)
# ----------------------------------------------------------------------
def test_engine_resume_takes_epochs_as_the_total(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)

    def make(batch_size=8):
        eng = engine_lib.Engine(
            apply_fn=lambda p, b, train, rng: b["x"] @ p["w"],
            loss_fn=engine_lib.sparse_softmax_loss,
            optimizer=build_optimizer({"kind": "sgd",
                                       "learning_rate": 0.05}),
            metrics={"accuracy": engine_lib.accuracy_metric},
            compute_dtype=torch.float32)
        state = eng.init_state({"w": torch.zeros(4, 2,
                                                 requires_grad=True)})
        return eng, state, ArrayBatcher({"x": x, "y": y}, batch_size)

    ckpt = Checkpointer(str(tmp_path / "ck"))
    eng, state, batcher = make()
    state, hist = eng.fit(state, batcher, epochs=2, checkpointer=ckpt)
    assert state.step == 8 and [h["epoch"] for h in hist] == [0, 1]
    assert 0.0 <= hist[-1]["accuracy"] <= 1.0
    eng2, state2, batcher2 = make()
    state2, hist2 = eng2.fit(state2, batcher2, epochs=3, checkpointer=ckpt)
    assert state2.step == 12 and [h["epoch"] for h in hist2] == [2]
    eng3, state3, batcher3 = make()
    state3, hist3 = eng3.fit(state3, batcher3, epochs=3, checkpointer=ckpt)
    assert state3.step == 12 and hist3 == []
    # progress comes from the sidecar: a re-run that reshapes the feed
    # (8 steps an epoch) still counts 3 epochs done
    eng4, state4, batcher4 = make(batch_size=4)
    state4, hist4 = eng4.fit(state4, batcher4, epochs=3, checkpointer=ckpt)
    assert state4.step == 12 and hist4 == []


def test_losses_and_metric_match_jax():
    """sparse_softmax_loss and accuracy_metric against the JAX
    package's, with a sample weight and a single-logit head."""
    import jax.numpy as jnp

    from learningorchestra_tpu.runtime import engine as jax_engine

    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 3)).astype(np.float32)
    y = np.array([0, 2, 1, 1, 0, 2], np.int32)
    w = np.array([1, 1, 0, 1, 1, 0], np.float32)
    single = rng.normal(size=(6, 1)).astype(np.float32)
    yb = (single[:, 0] > 0.3).astype(np.int32)
    for out, labels in ((logits, y), (single, yb)):
        for weights_ in (None, w):
            jw = None if weights_ is None else jnp.asarray(weights_)
            tw = None if weights_ is None else torch.from_numpy(weights_)
            jb, tb = {"y": jnp.asarray(labels)}, \
                {"y": torch.from_numpy(labels)}
            want = jax_engine.accuracy_metric(jnp.asarray(out), jb, jw)
            got = engine_lib.accuracy_metric(torch.from_numpy(out), tb, tw)
            assert [float(v) for v in got] == [float(v) for v in want]
            if out.shape[-1] > 1:
                np.testing.assert_allclose(
                    float(engine_lib.sparse_softmax_loss(
                        torch.from_numpy(out), tb, tw)),
                    float(jax_engine.sparse_softmax_loss(
                        jnp.asarray(out), jb, jw)), rtol=1e-6)


# ----------------------------------------------------------------------
# LanguageModel.fit resume
# ----------------------------------------------------------------------
def _lm(tree):
    lm = LanguageModel(**CFG, dropout=0.1, device="cpu")
    lm.set_params(weights.params_from_flax(tree))
    return lm


def test_resumed_fit_equals_uninterrupted_bit_for_bit(tmp_path, float32):
    """dropout 0.1, shuffle on, grad_accum 2: epoch 1 then a resume to 2
    gives the uninterrupted fit's losses, params and optimizer state."""
    tree = weights.init_params(CFG, seed=0)
    x = _stream(24, seed=1)
    kw = dict(batch_size=8, grad_accum=2, shuffle=True)
    whole = _lm(tree)
    want = whole.fit(x, epochs=2, **kw).history
    ck_dir = str(tmp_path / "ck")
    first = _lm(tree)
    got1 = first.fit(x, epochs=1, checkpointer=Checkpointer(ck_dir),
                     **kw).history
    resumed = _lm(tree)
    ck = Checkpointer(ck_dir)
    got2 = resumed.fit(x, epochs=2, checkpointer=ck, **kw).history
    assert got1["loss"] + got2["loss"] == want["loss"]
    assert got1["accuracy"] + got2["accuracy"] == want["accuracy"]
    assert got2["epoch"] == [1]
    assert [r["step"] for r in ck.restores] == [3]
    for key, value in whole.params.items():
        assert torch.equal(resumed.params[key], value), key
    saved = ck.saved_metadata()
    assert int(saved["step"]) == 6 and int(saved["opt_state"]["count"]) == 6
    assert set(saved["params"]) == set(tree)
    # a finished fit re-run is a no-op
    again = _lm(tree)
    assert again.fit(x, epochs=2, checkpointer=Checkpointer(ck_dir),
                     **kw).history == {}
    for key, value in whole.params.items():
        assert torch.equal(again.params[key], value), key


def test_checkpoint_state_is_the_flax_layout(tmp_path, float32):
    """The saved params and Adam slots are flax trees: the JAX package's
    ``params_from``-free reader sees kernels as (in, out)."""
    tree = weights.init_params(CFG, seed=0)
    lm = _lm(tree)
    lm.fit(_stream(8, seed=2), batch_size=8, epochs=1,
           checkpointer=Checkpointer(str(tmp_path)))
    raw = jax_ckpt.Checkpointer(str(tmp_path)).saved_metadata()
    kernel = raw["params"]["layer_0"]["attn"]["q_proj"]["kernel"]
    assert kernel.shape == tree["layer_0"]["attn"]["q_proj"]["kernel"].shape
    np.testing.assert_array_equal(
        kernel, lm.params["layer_0.attn.q_proj.weight"].numpy().T)
    assert set(raw["opt_state"]) == {"count", "mu", "nu"}
    assert set(raw["opt_state"]["mu"]) == set(tree)


# ----------------------------------------------------------------------
# REST (tests/test_server.py::test_train_checkpoint_and_patch_resume)
# ----------------------------------------------------------------------
def _call(api, method, path, body=None):
    return api.dispatch(method, PREFIX + path, {}, body)[:2]


def _wait(api, path, timeout=300.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, body = _call(api, "GET", path)
        assert status == 200, body
        if body["metadata"]["finished"]:
            return body
        if any(d.get("exception") for d in body["result"]):
            raise AssertionError(f"job failed: {body['result'][-1]}")
        time.sleep(0.02)
    raise AssertionError(f"timeout polling {path}")


def _write_csv(path, x):
    with open(path, "w") as f:
        f.write(",".join(f"t{i}" for i in range(x.shape[1])) + "\n")
        for row in x:
            f.write(",".join(str(int(t)) for t in row) + "\n")
    return str(path)


def _rest_run(api, ckpt_root, csv, seeded):
    """create, fit 1 epoch with checkpoints, PATCH to 2, then DELETE;
    what a client sees at each point. The stored model is replaced by
    ``seeded`` (one weight tree for both packages) before the fit."""
    seen = {}
    for route, body in (("/dataset/csv", {"datasetName": "corpus",
                                          "datasetURI": csv}),
                        ("/model/tensorflow", {
                            "modelName": "lm",
                            "modulePath": "learningorchestra_tpu.models",
                            "class": "LanguageModel",
                            "classParameters": CFG})):
        assert _call(api, "POST", route, body)[0] == 201
    # a GET while the JAX ingest writes can answer 500
    api.ctx.jobs.wait("corpus", timeout=300)
    _wait(api, "/dataset/csv/corpus")
    _wait(api, "/model/tensorflow/lm")
    api.ctx.artifacts.save(seeded, "lm", "model/tensorflow")
    params = {"x": "$corpus", "epochs": 1, "batch_size": 16,
              "shuffle": False, "checkpoint": True}
    seen["post"] = _call(api, "POST", "/train/tensorflow", {
        "name": "ck_train", "modelName": "lm", "method": "fit",
        "methodParameters": params})
    docs = _wait(api, "/train/tensorflow/ck_train")["result"]
    seen["first"] = [d["epochRecord"] for d in docs if "epochRecord" in d]
    ck_dir = os.path.join(ckpt_root, "ck_train")
    seen["steps1"] = sorted(n for n in os.listdir(ck_dir) if n.isdigit())
    seen["patch"] = _call(api, "PATCH", "/train/tensorflow/ck_train", {
        "methodParameters": dict(params, epochs=2)})
    time.sleep(0.05)
    docs = _wait(api, "/train/tensorflow/ck_train")["result"]
    records = [d["epochRecord"] for d in docs if "epochRecord" in d]
    seen["second"] = records[len(seen["first"]):]
    seen["steps2"] = sorted(n for n in os.listdir(ck_dir) if n.isdigit())
    seen["progress"] = json.loads(open(os.path.join(
        ck_dir, "progress.json")).read())
    seen["metadata"] = _call(api, "GET",
                             "/train/tensorflow/ck_train")[1]["metadata"]
    seen["delete"] = _call(api, "DELETE", "/train/tensorflow/ck_train")
    seen["dir_left"] = os.path.exists(ck_dir)
    return seen


def test_rest_checkpoint_patch_resume_and_delete_as_jax(tmp_path, float32,
                                                        monkeypatch):
    # the JAX ingest takes its pyarrow reader, the port's reference (its
    # native parser builds into one cache shared by every process)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    x = _stream(32, seed=4)
    csv = _write_csv(tmp_path / "c.csv", x)
    # a one-device JAX mesh: on the 8-device CPU test mesh the JAX
    # LanguageModel's resume fails (the restored step and Adam count
    # land on different devices)
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax"),
                                            mesh_shape="dp=1"))
    from learningorchestra_tpu.services.server import Api as JaxApi

    import jax
    import jax.numpy as jnp

    from learningorchestra_tpu.models import transformer as jax_tlm

    tree = weights.init_params(CFG, seed=5)
    jax_lm = jax_tlm.LanguageModel(**CFG)
    jax_lm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    port_lm = LanguageModel(**CFG, device="cpu")
    port_lm.set_params(weights.params_from_flax(tree))
    jax_api = JaxApi()
    port_api = Api(ServiceContext(Config(home=str(tmp_path / "port")),
                                  device="cpu"))
    try:
        want = _rest_run(jax_api, jax_config.get_config().checkpoints_dir,
                         csv, jax_lm)
        got = _rest_run(port_api, port_api.ctx.config.checkpoints_dir, csv,
                        port_lm)
    finally:
        jax_api.ctx.close()
        port_api.ctx.close()
        jax_config.reset_config()
    for key in ("post", "patch", "delete", "steps1", "steps2", "progress",
                "dir_left"):
        assert got[key] == want[key], key
    assert got["steps1"] == ["2"] and got["steps2"] == ["2", "4"]
    assert got["dir_left"] is False
    for part in ("first", "second"):
        assert [r["epoch"] for r in got[part]] == \
            [r["epoch"] for r in want[part]]
        # the roofline of a window (tflopsPerSecPerChip, ...): the JAX
        # package's first window holds its compile and carries none; the
        # port compiles nothing, so its first window carries one
        assert set(got[part][0]) - ROOFLINE == set(want[part][0]) - ROOFLINE
        np.testing.assert_allclose([r["loss"] for r in got[part]],
                                   [r["loss"] for r in want[part]],
                                   rtol=1e-5)
    assert got["metadata"]["finished"] and want["metadata"]["finished"]
    assert "checkpointCommitSeconds" in got["metadata"]
    assert [c["step"] for c in got["metadata"]["checkpointCommits"]] == [4]
    assert [r["step"] for r in got["metadata"]["checkpointRestores"]] == [2]
