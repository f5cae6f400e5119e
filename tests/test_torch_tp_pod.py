"""A pod of two port entry points at ``LO_MESH_SHAPE=tp=2``: a REST
``/train`` of a ``LanguageModel`` runs tensor-parallel on both ranks
(each holding its shards of the params and of AdamW's moments), and the
trained artifact is the whole flax tree. Beside
tests/test_torch_distributed.py's ``sp=2`` pod; every spawned process
imports no JAX and has a group timeout, and the fixture's waits are
bounded.

The pod's float32 fit is held against a one-process fit of the same
windows from the same seed: losses within 2e-5 relative (summation
order), the trained weights within 1e-5."""

import glob
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from tests.test_torch_distributed import (PREFIX, _docs, _env, _req,
                                          _wait_finished)

LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          max_len=32, sliding_window=6, attention="flash")
CORPUS = ("import numpy as np\n"
          "rng = np.random.default_rng(3)\n"
          "response = {'tokens': rng.integers(1, 64, size=(32, 32))"
          ".astype(np.int32)}\n")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _logs(home) -> str:
    out = []
    for r in range(2):
        with open(os.path.join(home, f"rank{r}.log"), "rb") as f:
            out.append(f.read()[-4000:].decode(errors="replace"))
    return "\n".join(out)


@pytest.fixture(scope="module")
def tp_pod(tmp_path_factory):
    """Two entry points on the CPU over a ``tp=2`` mesh; yields ``(base
    url, processes, home)``."""
    home = str(tmp_path_factory.mktemp("tp_pod"))
    coord = f"127.0.0.1:{_free_port()}"
    rest = _free_port()
    env = _env(LO_HOME=home, LO_MESH_SHAPE="tp=2",
               LO_COMPUTE_DTYPE="float32", LO_HEARTBEAT_INTERVAL="0.25",
               LO_STALL_SECONDS="0", LO_MONITOR="0")
    logs = [open(os.path.join(home, f"rank{r}.log"), "wb")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "learningorchestra_tpu_torch", "--device",
         "cpu", "--home", home, "--port", str(rest), "--coordinator", coord,
         "--num-hosts", "2", "--host-id", str(r)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(2)]
    for log in logs:
        log.close()
    base = f"http://127.0.0.1:{rest}"
    try:
        deadline = time.monotonic() + 120
        health = None
        while time.monotonic() < deadline:
            assert all(p.poll() is None for p in procs), _logs(home)
            try:
                health = _req(base, "GET", "/health", timeout=5)[1]
                break
            except OSError:
                time.sleep(0.3)
        assert health is not None, "the pod never served /health"
        yield base, procs, home
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _one_process_fit(epochs: int):
    """The same fit in this process, a world of one: its losses and its
    trained flax tree."""
    from learningorchestra_tpu_torch.models import transformer as tlm
    from learningorchestra_tpu_torch.models import weights

    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    try:
        lm = tlm.LanguageModel(**LM, device="cpu")
        tokens = np.random.default_rng(3).integers(
            1, 64, size=(32, 32)).astype(np.int32)
        history = lm.fit(tokens, batch_size=8, epochs=epochs,
                         shuffle=False).history
    finally:
        del os.environ["LO_COMPUTE_DTYPE"]
    return history["loss"], weights.params_to_flax(lm.module.state_dict())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_tp_pod_fits_a_language_model_sharded(tp_pod):
    from learningorchestra_tpu_torch.runtime import serialization

    base, procs, home = tp_pod
    assert _req(base, "POST", PREFIX + "/function/python", {
        "name": "corpus", "function": CORPUS,
        "functionParameters": {}})[0] == 201
    _wait_finished(base, "function/python", "corpus")
    assert _req(base, "POST", PREFIX + "/model/tensorflow", {
        "modelName": "lm", "modulePath": "learningorchestra_tpu_torch.models",
        "class": "LanguageModel", "classParameters": LM})[0] == 201
    _wait_finished(base, "model/tensorflow", "lm")
    assert _req(base, "POST", PREFIX + "/train/tensorflow", {
        "name": "fit", "modelName": "lm", "method": "fit",
        "methodParameters": {"x": "$corpus.tokens", "batch_size": 8,
                             "epochs": 2, "shuffle": False}})[0] == 201
    _wait_finished(base, "train/tensorflow", "fit")
    records = [d["epochRecord"] for d in _docs(base, "train/tensorflow",
                                               "fit")["result"]
               if "epochRecord" in d]
    losses = [r["loss"] for r in records]
    want_losses, want_tree = _one_process_fit(2)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-5)
    # both ranks ran the step: the epoch records carry the two ranks
    assert [len(r["launchesByRank"]) for r in records] == [2, 2]
    # the trained artifact is the whole tree, every leaf at its flax shape
    paths = glob.glob(os.path.join(home, "artifacts", "**",
                                   "weights.msgpack"), recursive=True)
    trained = [p for p in paths if os.sep + "fit" + os.sep in p]
    assert trained, paths
    with open(trained[0], "rb") as f:
        saved = _flat(serialization.msgpack_restore(f.read())["params"])
    want = _flat(want_tree)
    assert sorted(saved) == sorted(want)
    for key, value in want.items():
        assert saved[key].shape == value.shape, key
        np.testing.assert_allclose(saved[key], value, rtol=1e-5, atol=1e-5)
    assert all(p.poll() is None for p in procs)
