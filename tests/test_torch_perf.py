"""The port's roofline (``learningorchestra_tpu_torch/observability/
perf.py``) against the JAX package's, on the CPU.

- The registry holds NVIDIA rows only, matched against the card's name,
  most specific first: ``"NVIDIA H100 80GB HBM3"`` is the H100 SXM5 row
  (989.4 TFLOP/s dense bf16, 3.35 TB/s), the PCIe and NVL cards their
  own; an unknown card and the CPU give no peak, as the JAX registry
  gives none off the TPU.
- ``roofline()`` returns exactly the JAX function's fields and values
  under the same ``LO_PEAK_*`` overrides, bytes or no bytes, and so does
  the per-job report registry.
- The LM's FLOPs a step: the analytic floor equals the JAX package's
  floor exactly; where the counter sees nothing (the hand-written
  kernels on the card) the floor is the step's FLOPs exactly; a counted
  step trains bit-equal to an uncounted one; on the CPU the counted
  FLOPs sit within 25% of the JAX engine's ``_step_flops``
  (XLA's cost analysis and ``FlopCounterMode`` count different ops: the
  tolerance is their disagreement at this size, stated, not a bound on
  the port's arithmetic).
- A finished job's report survives the registry on its metadata.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.models.transformer import \
    LanguageModel as JaxLanguageModel
from learningorchestra_tpu.observability import perf as jax_perf
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.models.transformer import LanguageModel
from learningorchestra_tpu_torch.observability import perf, trace
from learningorchestra_tpu_torch.runtime import engine as engine_lib
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
LM_CFG = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, max_len=64)
FLOPS_REL_TOL = 0.25


@pytest.fixture(autouse=True)
def _no_pins(monkeypatch):
    for key in ("LO_PEAK_TFLOPS_PER_CHIP", "LO_PEAK_HBM_GBPS", "LO_PERF"):
        monkeypatch.delenv(key, raising=False)
    perf.reset()
    jax_perf.reset()
    yield
    perf.reset()
    jax_perf.reset()


@pytest.mark.parametrize("name,row,tflops,gbps", [
    ("NVIDIA H100 80GB HBM3", "H100 SXM5 80GB HBM3", 989.4, 3350.0),
    ("NVIDIA H100 PCIe", "H100 PCIe", 756.0, 2000.0),
    ("NVIDIA H100 NVL", "H100 NVL", 835.5, 3900.0),
    ("NVIDIA A100-SXM4-80GB", None, None, None),
])
def test_registry_matches_the_card_name(monkeypatch, name, row, tflops,
                                        gbps):
    monkeypatch.setattr(perf, "_device", lambda: ("cuda", name))
    summary = perf.platform_summary()
    assert summary["deviceKind"] == name
    assert summary.get("peakSource") == row
    assert summary["peakTflopsPerChip"] == tflops
    assert summary["peakHbmGbPerSec"] == gbps
    out = perf.roofline(1e12, 1e10, 4, 1.0, 1)
    assert ("mfu" in out) == (row is not None)
    if row is not None:
        assert out["mfu"] == round(4e12 / (tflops * 1e12), 4)


def test_no_tpu_row_and_no_peak_on_the_cpu():
    assert all(key.startswith("h100") for key, *_ in perf.PEAKS)
    assert perf.peak_flops_per_chip() is None
    assert perf.peak_hbm_bytes_per_chip() is None
    assert jax_perf.peak_flops_per_chip() is None
    summary = perf.platform_summary()
    assert summary["platform"] == "cpu"
    assert summary["peakTflopsPerChip"] is None
    assert "mfu" not in perf.roofline(1e12, 1e10, 4, 1.0, 1)


CASES = {
    "compute-bound": (4e12, 2e9, 4, 0.5, 1),
    "bandwidth-bound": (1e9, 5e9, 8, 0.25, 1),
    "no bytes": (6.4e11, 0.0, 8, 1.7, 1),
    "no flops": (0.0, 1e9, 3, 1.0, 1),
    "no steps": (1e12, 1e9, 0, 1.0, 1),
    "two chips": (2e12, 1e11, 5, 0.9, 2),
}


@pytest.mark.parametrize("pins", [("0.05", "1"), ("989.4", "3350"),
                                  (None, None)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_roofline_matches_jax_under_the_same_pins(monkeypatch, case, pins):
    tflops, gbps = pins
    if tflops is not None:
        monkeypatch.setenv("LO_PEAK_TFLOPS_PER_CHIP", tflops)
        monkeypatch.setenv("LO_PEAK_HBM_GBPS", gbps)
    assert perf.roofline(*CASES[case]) == jax_perf.roofline(*CASES[case])
    keys = ("peakTflopsPerChip", "peakHbmGbPerSec", "ridgeFlopsPerByte")
    ours, theirs = perf.platform_summary(), jax_perf.platform_summary()
    assert {k: ours.get(k) for k in keys} == {k: theirs.get(k) for k in keys}


def test_perf_off_keeps_only_the_history_fields(monkeypatch):
    monkeypatch.setenv("LO_PEAK_TFLOPS_PER_CHIP", "1")
    monkeypatch.setenv("LO_PERF", "0")
    assert perf.roofline(*CASES["compute-bound"]) == \
        jax_perf.roofline(*CASES["compute-bound"])
    assert set(perf.roofline(*CASES["compute-bound"])) == \
        {"tflopsPerSecPerChip", "mfu"}
    perf.record_job("j", {"mfu": 0.1})
    assert perf.job_report("j") is None


def test_report_registry_is_the_jax_lru():
    for lib in (perf, jax_perf):
        for i in range(130):
            lib.record_job(f"j{i % 131}", {"mfu": i / 1000, "epoch": i})
        lib.record_job("j5", {"mfu": 0.5})
    assert perf.known_jobs() == jax_perf.known_jobs()
    assert len(perf.known_jobs()) == 128
    assert list(perf.latest(7)) == list(jax_perf.latest(7))
    for name in ("j5", "j129", "j0"):
        ours, theirs = perf.job_report(name), jax_perf.job_report(name)
        assert (ours is None) == (theirs is None)
        if ours is not None:
            ours.pop("updatedAt")
            theirs.pop("updatedAt")
            assert ours == theirs


@pytest.fixture()
def jax_lm(tmp_path):
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax"),
                                            compute_dtype="float32"))
    lm = JaxLanguageModel(**LM_CFG, attention="dot")
    lm.params = jax.tree_util.tree_map(
        jnp.asarray, weights.init_params(LM_CFG, seed=3))
    yield lm
    jax_config.reset_config()


def _port_lm():
    lm = LanguageModel(**LM_CFG, device="cpu")
    lm.set_params(weights.params_from_flax(weights.init_params(LM_CFG,
                                                               seed=3)))
    return lm


@pytest.mark.parametrize("shape", [(8, 16), (16, 32), (2, 64)])
def test_lm_flops_floor_equals_the_jax_floor(jax_lm, shape):
    batch = {"x": np.zeros(shape, np.int32)}
    assert _port_lm()._flops_floor(batch) == \
        jax_lm._get_engine()._flops_floor_fn(batch)


def test_the_floor_governs_where_the_counter_sees_nothing(monkeypatch):
    # a counter that sees nothing, as FlopCounterMode sees nothing of the
    # hand-written kernels on the card
    monkeypatch.setattr(engine_lib, "_counted", lambda fn: (fn(), 0.0))
    monkeypatch.setattr(engine_lib, "_FLOPS_CACHE", {})
    lm = _port_lm()
    x = np.random.default_rng(0).integers(1, 97, (16, 16)).astype(np.int32)
    hist = lm.fit(x, batch_size=8, epochs=1).history
    floor = lm._flops_floor({"x": x[:8]})
    assert lm._engine._step_flops == floor
    steps, dt = 2, hist["epochSeconds"][0]
    assert hist["tflopsPerSecPerChip"][0] == pytest.approx(
        floor * steps / dt / 1e12, rel=0.01, abs=1e-4)


def test_a_counted_step_trains_as_an_uncounted_one(monkeypatch):
    x = np.random.default_rng(4).integers(1, 97, (16, 16)).astype(np.int32)
    params = []
    for cache in ({}, None):
        if cache is not None:
            monkeypatch.setattr(engine_lib, "_FLOPS_CACHE", cache)
        else:
            # the cache the first fit filled: nothing is counted
            monkeypatch.setattr(engine_lib.Engine, "_needs_count",
                                lambda self, batch: False)
        lm = _port_lm()
        lm.fit(x, batch_size=8, epochs=1, grad_accum=2)
        params.append({k: v.clone() for k, v in
                       lm.module.state_dict().items()})
    assert all(torch.equal(params[0][k], params[1][k]) for k in params[0])


def test_a_call_the_formulas_cannot_take_counts_zero_and_runs():
    """``bmm`` with ``out_dtype`` (the MoE experts' float32 results on
    the card) has no FLOP formula that takes it: the call runs, counts
    0, and the counter goes on (meta tensors: the overload has no CPU
    kernel)."""
    a = torch.ones(2, 3, 4, device="meta", dtype=torch.bfloat16)
    b = torch.ones(2, 4, 5, device="meta", dtype=torch.bfloat16)

    def step():
        torch.bmm(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    out, flops = engine_lib._counted(step)
    assert out.dtype == torch.float32 and out.shape == (2, 3, 5)
    assert flops == 2 * 2 * 3 * 4 * 5


def test_cpu_counted_flops_sit_near_the_jax_engines(jax_lm, monkeypatch):
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    monkeypatch.setattr(engine_lib, "_FLOPS_CACHE", {})
    x = np.random.default_rng(0).integers(1, 97, (16, 16)).astype(np.int32)
    jax_lm.fit(x, batch_size=8, epochs=1, shuffle=False)
    ours = _port_lm()
    ours.fit(x, batch_size=8, epochs=1, shuffle=False)
    want = jax_lm._get_engine()._step_flops
    got = ours._engine._step_flops
    assert got >= ours._flops_floor({"x": x[:8]})
    assert abs(got / want - 1) <= FLOPS_REL_TOL, (got, want)


def test_a_finished_jobs_report_survives_the_registry(tmp_path, monkeypatch):
    monkeypatch.setenv("LO_PEAK_TFLOPS_PER_CHIP", "0.05")
    api = Api(ServiceContext(Config(home=str(tmp_path), monitor=False),
                             device="cpu"))
    try:
        x = np.random.default_rng(1).integers(1, 97, (16, 16)).astype(
            np.int32)
        lm = _port_lm()
        api.ctx.artifacts.save(lm, "lm", "model/tensorflow")
        api.ctx.catalog.create_collection("lm", "model/tensorflow", {
            "modulePath": "learningorchestra_tpu.models",
            "class": "LanguageModel", "classParameters": LM_CFG})
        api.ctx.catalog.mark_finished("lm")
        api.ctx.artifacts.save({"tokens": x}, "d", "function/python")
        api.ctx.catalog.create_collection("d", "function/python", {})
        api.ctx.catalog.mark_finished("d")
        st, body, _ = api.dispatch("POST", f"{PREFIX}/train/tensorflow", {},
                                   {"name": "t", "modelName": "lm",
                                    "method": "fit", "methodParameters": {
                                        "x": "$d.tokens", "epochs": 2,
                                        "batch_size": 8}})
        assert st == 201, body
        api.ctx.jobs.wait("t", timeout=120)
        deadline = time.monotonic() + 30
        while "perf" not in (api.ctx.catalog.get_metadata("t") or {}) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        st, live, _ = api.dispatch("GET", f"{PREFIX}/observability/perf/t",
                                   {}, None)
        assert st == 200 and live["kind"] == "train"
        assert live["perf"]["mfu"] >= 0 and "terminal" not in live
        perf.reset()
        trace.reset()
        st, stamped, _ = api.dispatch(
            "GET", f"{PREFIX}/observability/perf/t", {}, None)
        assert st == 200 and stamped["terminal"] is True
        assert stamped["perf"] == {k: v for k, v in live["perf"].items()
                                   if k in ("mfu", "tflopsPerSecPerChip")}
        st, listing, _ = api.dispatch(
            "GET", f"{PREFIX}/observability/perf", {}, None)
        assert st == 200 and listing["platform"]["peakTflopsPerChip"] == 0.05
        assert api.dispatch("GET", f"{PREFIX}/observability/perf/none",
                            {}, None)[0] == 404
    finally:
        api.ctx.close()
