"""The PyTorch port's boot recovery on the CPU, held against the JAX
package.

- ``recover_unfinished`` over the same unfinished collections (an
  execution and a function in flight, one that a shutdown dropped, one
  that ended in failure, an ingest, a projection, a model build, a
  finished job) requeues and fails the same names, with the same typed
  ``InterruptedError`` document.
- A server process (``python -m learningorchestra_tpu_torch --device
  cpu``) killed with SIGKILL after the first epoch of a checkpointed
  2-epoch fit: the restarted server requeues the fit, which resumes from
  its step and trains epoch 2 to the loss of an uninterrupted fit, bit
  for bit; an unfinished projection gets its ``InterruptedError``.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.catalog import Catalog as JaxCatalog
from learningorchestra_tpu.catalog import documents as JD
from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.catalog.store import Catalog
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import NeuralModel
from learningorchestra_tpu_torch.runtime.checkpoint import Checkpointer
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "/api/learningOrchestra/v1"
MLP = [{"kind": "dense", "units": 16, "activation": "relu"},
       {"kind": "dense", "units": 2, "activation": "softmax"}]

# (name, type, metadata extras, the documents after the metadata)
UNFINISHED = [
    ("ex_mid", "train/tensorflow", {
        "parentName": "ghost", "method": "fit", "methodParameters": {},
        "timeout": 30.0, "healthPolicy": "skip"}, []),
    ("fn_mid", "function/python", {
        "function": "response = 1", "functionParameters": {},
        "sandboxMode": "restricted"}, []),
    ("ex_aborted", "evaluate/tensorflow", {
        "parentName": "ghost", "method": "evaluate",
        "methodParameters": {}}, [{
            "exception": "ShutdownAborted('server shut down before this "
                         "queued job started')",
            "status": "shutdownAborted", "shutdownAborted": True}]),
    ("ex_failed", "train/tensorflow", {
        "parentName": "ghost", "method": "fit", "methodParameters": {}}, [
        {"exception": "ValueError('bad')", "status": "deadLettered"}]),
    ("ds_mid", "dataset/csv", {"url": "/nowhere.csv"}, []),
    ("proj_mid", "transform/projection", {"parentName": "ds_mid",
                                          "fields": ["a"]}, []),
    ("model_mid", "model/tensorflow", {"modulePath": "x",
                                       "class": "Y"}, []),
]


def _populate(catalog):
    for name, type_string, extra, docs in UNFINISHED:
        catalog.create_collection(name, type_string, dict(extra))
        for doc in docs:
            catalog.append_document(name, dict(doc))
    catalog.create_collection("done", "train/tensorflow", {
        "parentName": "ghost", "method": "fit", "methodParameters": {}})
    catalog.mark_finished("done")


def test_recover_unfinished_matches_jax(tmp_path, monkeypatch):
    jcfg = jax_config.Config(home=str(tmp_path / "jax"),
                             sandbox_mode="restricted")
    jax_config.set_config(jcfg)
    from learningorchestra_tpu.services.server import Api as JaxApi

    seen = {}
    original = JaxApi.recover_unfinished

    def spy(self):
        seen["jax"] = original(self)
        return seen["jax"]

    monkeypatch.setattr(JaxApi, "recover_unfinished", spy)
    jcat = JaxCatalog(jcfg.catalog_path, jcfg.datasets_dir)
    _populate(jcat)
    jcat.close()
    pcfg = Config(home=str(tmp_path / "port"), sandbox_mode="restricted")
    pcat = Catalog(pcfg.catalog_path, pcfg.datasets_dir)
    _populate(pcat)
    pcat.close()
    apis = (JaxApi(), Api(ServiceContext(pcfg, device="cpu")))
    try:
        got = apis[1].recovered
        want = seen["jax"]
        assert {k: sorted(v) for k, v in got.items()} == \
            {k: sorted(v) for k, v in want.items()}
        assert sorted(got["requeued"]) == ["ex_aborted", "ex_mid", "fn_mid"]
        for api in apis:
            for name in got["requeued"]:
                try:
                    api.ctx.jobs.wait(name, timeout=60)
                except Exception:  # noqa: BLE001
                    pass
        outcomes = []
        for api, fields in zip(apis, (JD, D)):
            docs = {name: api.ctx.catalog.get_documents(name)[-1]
                    for name in ("ds_mid", "proj_mid", "model_mid",
                                 "ex_failed", "fn_mid")}
            outcomes.append({name: (doc.get(fields.EXCEPTION_FIELD),
                                    doc.get("status"))
                             for name, doc in docs.items()})
            # the requeued function ran to its end
            assert api.ctx.catalog.get_metadata("fn_mid")["finished"]
        assert outcomes[1] == outcomes[0]
        assert outcomes[1]["ds_mid"][0] == (
            "InterruptedError('job was in flight when the server stopped; "
            "resubmit it')")
        # the requeued execution kept its stored deadline and policy
        meta = apis[1].ctx.catalog.get_metadata("ex_mid")
        assert (meta["timeout"], meta["healthPolicy"]) == (30.0, "skip")
    finally:
        for api in apis:
            api.ctx.close()
        jax_config.reset_config()


# ----------------------------------------------------------------------
# a killed server's checkpointed fit resumes bit for bit
# ----------------------------------------------------------------------
def _start(home):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "LO_FAULT_INJECT")}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"  # a tiny MLP: threads only contend
    proc = subprocess.Popen(
        [sys.executable, "-m", "learningorchestra_tpu_torch", "--home",
         home, "--device", "cpu", "--port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    line = proc.stdout.readline()
    assert "REST on http://" in line, line
    base = line.split("REST on ")[1].split(PREFIX)[0].strip()
    recovered = proc.stdout.readline()
    return proc, base, recovered


def _http(base, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + PREFIX + path, data=data,
                                 method=method)
    req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _data(n=16000):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int64)
    return x, y


def test_killed_servers_fit_resumes_bit_for_bit(tmp_path):
    home = str(tmp_path / "home")
    x, y = _data()
    ctx = ServiceContext(Config(home=home), device="cpu")
    api = Api(ctx)
    try:
        ctx.catalog.create_collection("data", "function/python", {})
        ctx.artifacts.save({"x": x, "y": y}, "data", "function/python")
        ctx.catalog.mark_finished("data")
        assert api.dispatch("POST", PREFIX + "/model/tensorflow", {}, {
            "modelName": "mlp",
            "modulePath": "learningorchestra_tpu.models",
            "class": "NeuralModel",
            "classParameters": {"layer_configs": MLP}})[0] == 201
        ctx.jobs.wait("mlp", timeout=60)
        reference = ctx.artifacts.load("mlp")
    finally:
        ctx.close()
    fit = {"name": "fit", "modelName": "mlp", "method": "fit",
           "methodParameters": {"x": "$data.x", "y": "$data.y",
                                "epochs": 2, "batch_size": 8,
                                "checkpoint": True}}
    progress = os.path.join(home, "checkpoints", "fit", "progress.json")
    proc, base, _ = _start(home)
    try:
        assert _http(base, "POST", "/train/tensorflow", fit)[0] == 201
        # the kill comes after the first epoch's commit and after its
        # record, which the fit appends just after the commit
        deadline = time.monotonic() + 120
        while True:
            assert time.monotonic() < deadline, "no first epoch"
            try:
                with open(progress) as f:
                    committed = json.load(f).get("epochs_done") == 1
            except (OSError, ValueError):
                committed = False
            if committed and any(
                    d.get("epochRecord", {}).get("epoch") == 0 for d in
                    _http(base, "GET", "/train/tensorflow/fit")[1]["result"]):
                break
            time.sleep(0.005)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(progress) as f:
        assert json.load(f)["epochs_done"] == 1, "killed too late"
    # a projection left unfinished by the kill
    cat = Catalog(os.path.join(home, "catalog.sqlite"),
                  os.path.join(home, "datasets"))
    cat.create_collection("proj", "transform/projection",
                          {"parentName": "data", "fields": ["x"]})
    cat.close()
    proc, base, recovered = _start(home)
    try:
        assert "'requeued': ['fit']" in recovered
        assert "'failed': ['proj']" in recovered
        deadline = time.monotonic() + 120
        while True:
            status, body = _http(base, "GET", "/train/tensorflow/fit")
            if body["metadata"]["finished"]:
                break
            assert not body["metadata"].get("status") == "deadLettered", \
                body["result"][-1]
            assert time.monotonic() < deadline
            time.sleep(0.05)
        proj = _http(base, "GET", "/transform/projection/proj")[1]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    records = [d["epochRecord"] for d in body["result"]
               if "epochRecord" in d]
    assert [r["epoch"] for r in records] == [0, 1]
    assert body["metadata"]["checkpointRestores"][0]["step"] == 2000
    assert proj["result"][-1]["exception"].startswith("InterruptedError(")
    direct = reference.fit(x, y, epochs=2, batch_size=8,
                           checkpointer=Checkpointer(str(tmp_path / "ck")))
    assert records[1]["loss"] == direct.history["loss"][1]
    assert records[0]["loss"] == direct.history["loss"][0]
    assert isinstance(reference, NeuralModel)
