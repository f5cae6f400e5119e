"""The port's model preflight (``learningorchestra_tpu_torch/analysis/
preflight.py``) held to the JAX package's, case by case: every case of
``tests/test_analysis.py``'s shape preflight units and of its end-to-end
submit checks runs through both packages.

Findings are compared on rule, severity and location, and on the
message up to the error text of the failed build (flax's words in one
package, torch's in the other). Two differences are deliberate and held
here: ``mesh-divisibility`` never fires on one card (the JAX package's
8-device test mesh warns), and the footprint's ``estimator`` is always
``"heuristic"`` (XLA's ``memory_analysis`` has no torch counterpart),
with the JAX formula's ``paramBytes`` and heuristic ``hbmBytes``.
"""

import numpy as np
import pytest

from learningorchestra_tpu import analysis as JA
from learningorchestra_tpu.services import validators as JV
from learningorchestra_tpu_torch import analysis as PA
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services import validators as PV
from learningorchestra_tpu_torch.services.context import ServiceContext

_NEURAL = ("learningorchestra_tpu.models", "NeuralModel")
_TRACE_PREFIX = "layer stack cannot initialize"


def _key(f):
    # the build's own error text follows the first ": " of a trace
    # finding's message (the prefix holds none)
    message = f.message.split(": ", 1)[0] \
        if f.message.startswith(_TRACE_PREFIX) else f.message
    return (f.severity, f.rule, f.location, message)


def _same(jax_findings, port_findings):
    assert [_key(f) for f in port_findings] == \
        [_key(f) for f in jax_findings]
    return [_key(f) for f in port_findings]


class _FakeCatalog:
    def __init__(self, shapes_by_name):
        self._shapes = shapes_by_name

    def get_metadata(self, name):
        shapes = self._shapes.get(name)
        if shapes is None:
            return None
        return {JA.RESULT_SHAPES_FIELD: shapes}


def _root_meta(configs, module=_NEURAL[0]):
    return {"modulePath": module, "class": _NEURAL[1],
            "classParameters": {"layer_configs": configs}}


_DATA = _FakeCatalog({"d": {
    "x": {"shape": [32, 8], "dtype": "float32"},
    "y": {"shape": [32], "dtype": "int32"},
    "y_short": {"shape": [16], "dtype": "int32"},
    "ids": {"shape": [32, 20], "dtype": "int32"},
    "img": {"shape": [32, 28, 28, 1], "dtype": "float32"},
}})
_DENSE = [{"kind": "dense", "units": 4, "activation": "relu"},
          {"kind": "dense", "units": 2, "activation": "softmax"}]

MODEL_CASES = {
    "valid stack": (_NEURAL, {"layer_configs": _DENSE}),
    "foreign class bypassed": (
        ("sklearn.linear_model", "LogisticRegression"), {"C": 0.1}),
    "unknown layer kind": (_NEURAL, {"layer_configs": [
        {"kind": "input", "shape": [8]}, {"kind": "wurble", "units": 4}]}),
    "config not a dict": (_NEURAL, {"layer_configs": [
        {"kind": "dense", "units": 4}, "not-a-dict"]}),
    "config without kind": (_NEURAL, {"layer_configs": [{"units": 4}]}),
    "undersized stack on declared input": (_NEURAL, {"layer_configs": [
        {"kind": "input", "shape": [8]},
        {"kind": "conv2d", "filters": 4, "kernel": 3}]}),
    "valid declared stack": (_NEURAL, {"layer_configs": [
        {"kind": "input", "shape": [8]}] + _DENSE}),
    "hash expression linted": (_NEURAL, {
        "layer_configs": _DENSE, "name": "#open('/etc/passwd')"}),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_check_model_matches_jax(case):
    (module, cls), params = MODEL_CASES[case]
    keys = _same(JA.check_model(module, cls, params),
                 PA.check_model(module, cls, params))
    want = {"valid stack": [], "foreign class bypassed": [],
            "valid declared stack": []}
    if case in want:
        assert keys == want[case]
    else:
        assert any(k[0] == "error" for k in keys), keys
    if case == "unknown layer kind":
        assert keys[0][1] == "unknown-layer"


EXECUTION_CASES = {
    "matching spec": (_DENSE, "fit", {"x": "$d.x", "y": "$d.y",
                                      "epochs": 1, "batch_size": 8}),
    "x/y count mismatch": (_DENSE, "fit", {"x": "$d.x",
                                           "y": "$d.y_short"}),
    "declared input contradicts x": (
        [{"kind": "input", "shape": [4]}] + _DENSE, "fit",
        {"x": "$d.x", "y": "$d.y"}),
    "unknown artifacts bypassed": (_DENSE, "fit", {
        "x": "$elsewhere.x", "y": "$elsewhere.y"}),
    "other methods bypassed": (_DENSE, "generate", {"prompt": "hi"}),
    "stack cannot take x": (
        [{"kind": "conv2d", "filters": 4, "kernel": 3}] + _DENSE,
        "evaluate", {"x": "$d.x", "y": "$d.y"}),
    "embedding stack on ids": (
        [{"kind": "embedding", "vocab": 50, "dim": 8},
         {"kind": "lstm", "units": 4}, {"kind": "dense", "units": 2}],
        "fit", {"x": "$d.ids", "y": "$d.y", "batch_size": 8}),
    "cnn on images": (
        [{"kind": "conv2d", "filters": 4, "kernel": [3, 3],
          "activation": "relu"}, {"kind": "maxpool2d"},
         {"kind": "flatten"}, {"kind": "batchnorm"}] + _DENSE,
        "predict", {"x": "$d.img"}),
    "structurally broken root": ([{"units": 4}], "fit",
                                 {"x": "$d.x", "y": "$d.y"}),
    "hash expression linted": (_DENSE, "fit", {
        "x": "$d.x", "y": "$d.y", "epochs": "#__import__('os')"}),
}


@pytest.mark.parametrize("case", sorted(EXECUTION_CASES))
def test_check_execution_matches_jax(case):
    configs, method, params = EXECUTION_CASES[case]
    keys = _same(
        JA.check_execution(_DATA, _root_meta(configs), method, params),
        PA.check_execution(_DATA, _root_meta(configs), method, params))
    if case in ("matching spec", "unknown artifacts bypassed",
                "other methods bypassed", "embedding stack on ids",
                "cnn on images"):
        assert keys == []
    else:
        assert any(k[0] == "error" for k in keys), keys


def test_port_module_path_is_modelled_too():
    """A root stored with the port's own module path is the same model."""
    configs = [{"kind": "input", "shape": [4]}] + _DENSE
    port_path = "learningorchestra_tpu_torch.models"
    assert [_key(f) for f in PA.check_execution(
        _DATA, _root_meta(configs, port_path), "fit",
        {"x": "$d.x", "y": "$d.y"})] == [_key(f) for f in JA.check_execution(
            _DATA, _root_meta(configs), "fit", {"x": "$d.x", "y": "$d.y"})]


def test_mesh_divisibility_never_fires_on_one_card():
    from learningorchestra_tpu.runtime import mesh as mesh_lib

    dp = mesh_lib.data_parallel_size(mesh_lib.get_default_mesh())
    assert dp > 1  # the JAX tests' 8-device CPU mesh
    params = {"x": "$d.x", "y": "$d.y", "batch_size": dp + 1}
    jax_rules = [_key(f) for f in JA.check_execution(
        _DATA, _root_meta(_DENSE), "fit", params)]
    assert [r[1] for r in jax_rules] == ["mesh-divisibility"]
    assert PA.check_execution(_DATA, _root_meta(_DENSE), "fit",
                              params) == []


@pytest.mark.parametrize("case", [
    "matching spec", "embedding stack on ids", "cnn on images"])
def test_footprint_is_the_jax_heuristic(case):
    configs, method, params = EXECUTION_CASES[case]
    want = JA.estimate_footprint(_DATA, _root_meta(configs), method, params)
    got = PA.estimate_footprint(_DATA, _root_meta(configs), method, params)
    assert got["estimator"] == "heuristic"
    assert got["paramBytes"] == want["paramBytes"]
    x = _DATA.get_metadata("d")[JA.RESULT_SHAPES_FIELD][
        params["x"].split(".")[1]]
    feature_bytes = int(np.prod(x["shape"][1:])) * \
        np.dtype(x["dtype"]).itemsize
    batch = params.get("batch_size", 128)
    assert got["hbmBytes"] == want["paramBytes"] * 4 + \
        2 * batch * feature_bytes
    if want["estimator"] == "heuristic":
        assert got == want
    # unmodelable specs bypass in both
    assert PA.estimate_footprint(_DATA, _root_meta(_DENSE), "fit",
                                 {"x": "$elsewhere.x"}) is None
    assert JA.estimate_footprint(_DATA, _root_meta(_DENSE), "fit",
                                 {"x": "$elsewhere.x"}) is None


def test_result_shapes_and_builder_lint_match_jax():
    value = {"x": np.zeros((32, 8), np.float32),
             "y": np.zeros((32,), np.int32), "other": "not-an-array"}
    assert PA.result_shapes(value) == JA.result_shapes(value) == {
        "x": {"shape": [32, 8], "dtype": "float32"},
        "y": {"shape": [32], "dtype": "int32"}}
    assert PA.result_shapes(np.zeros((4,), np.float32)) == \
        JA.result_shapes(np.zeros((4,), np.float32))
    assert PA.result_shapes("scalar-ish") is None
    for code in ("import os\nfeatures_training = training_df\n",
                 "x = ().__class__.__mro__\n",
                 "import numpy as np\nfeatures_training = training_df\n",
                 None):
        assert [_key(f) for f in PA.check_builder(code)] == \
            [_key(f) for f in JA.check_builder(code)]


# ----------------------------------------------------------------------
# end to end through the services of both packages
# ----------------------------------------------------------------------
@pytest.fixture()
def contexts(tmp_path, tmp_config):
    from learningorchestra_tpu.services.context import \
        ServiceContext as JaxContext

    jax_ctx = JaxContext(tmp_config)
    port_ctx = ServiceContext(Config(home=str(tmp_path / "port")),
                              device="cpu")
    yield jax_ctx, port_ctx
    jax_ctx.close()
    port_ctx.close()


def _data(ctx, artifacts_save):
    """A finished result with recorded shapes, as a function job leaves
    it (no sandbox child: the shapes are what preflight reads)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    value = {"x": x, "y": (x[:, 0] > 0).astype(np.int32)}
    ctx.catalog.create_collection("pf_data", "function/python", {
        "resultShapes": JA.result_shapes(value)})
    artifacts_save(value, "pf_data", "function/python")
    ctx.catalog.mark_finished("pf_data")


def _services(ctx, package):
    import importlib

    ms = importlib.import_module(f"{package}.services.model_service")
    es = importlib.import_module(f"{package}.services.execution")
    return ms.ModelService(ctx), es.ExecutionService(ctx)


def test_preflight_rejects_bad_shape_spec_and_runs_good_one(contexts):
    """The same data and two specs differing only in the declared input
    shape: the contradictory one is a 406 with a ``shape-mismatch``
    finding and leaves no document; the consistent one trains and its
    job document carries the footprint."""
    outcomes = []
    for ctx, package, errors in zip(
            contexts, ("learningorchestra_tpu",
                       "learningorchestra_tpu_torch"), (JV, PV)):
        _data(ctx, ctx.artifacts.save)
        ms, es = _services(ctx, package)
        for model_name, feat in (("pf_good", 8), ("pf_bad", 4)):
            ms.create({
                "modelName": model_name,
                "modulePath": "learningorchestra_tpu.models",
                "class": "NeuralModel",
                "classParameters": {"layer_configs": [
                    {"kind": "input", "shape": [feat]}] + _DENSE}},
                "tensorflow")
            ctx.jobs.wait(model_name, timeout=180)
        body = {"name": "pf_train_bad", "modelName": "pf_bad",
                "method": "fit",
                "methodParameters": {"x": "$pf_data.x", "y": "$pf_data.y",
                                     "epochs": 1, "batch_size": 8}}
        with pytest.raises(errors.HttpError) as exc:
            es.create(body, "train", "tensorflow")
        assert ctx.catalog.get_metadata("pf_train_bad") is None
        status, _ = es.create(dict(body, name="pf_train_good",
                                   modelName="pf_good"),
                              "train", "tensorflow")
        ctx.jobs.wait("pf_train_good", timeout=300)
        meta = ctx.catalog.get_metadata("pf_train_good")
        outcomes.append((exc.value.status, [
            (f["severity"], f["rule"], f["location"])
            for f in exc.value.findings], status, meta["finished"],
            meta["footprint"]["paramBytes"]))
    assert outcomes[1] == outcomes[0]
    assert outcomes[0][:4] == (406, [
        ("error", "shape-mismatch", "methodParameters.x")], 201, True)


def test_model_preflight_at_create_and_patch(contexts):
    """A stack that cannot build on its declared input is refused at
    create (no document) and at PATCH (the model keeps its parameters),
    with the same findings in both packages."""
    bad = [{"kind": "input", "shape": [8]},
           {"kind": "conv2d", "filters": 4, "kernel": 3}]
    seen = []
    for ctx, package, errors in zip(
            contexts, ("learningorchestra_tpu",
                       "learningorchestra_tpu_torch"), (JV, PV)):
        ms, _ = _services(ctx, package)
        body = {"modelName": "m", "modulePath": _NEURAL[0],
                "class": _NEURAL[1],
                "classParameters": {"layer_configs": bad}}
        with pytest.raises(errors.HttpError) as created:
            ms.create(body, "tensorflow")
        assert ctx.catalog.get_metadata("m") is None
        ms.create(dict(body, classParameters={"layer_configs": _DENSE}),
                  "tensorflow")
        ctx.jobs.wait("m", timeout=180)
        with pytest.raises(errors.HttpError) as patched:
            ms.update("m", {"classParameters": {"layer_configs": bad}},
                      "tensorflow")
        assert ctx.catalog.get_metadata("m")["classParameters"] == {
            "layer_configs": _DENSE}
        seen.append([(e.value.status, [(f["severity"], f["rule"],
                                        f["location"])
                                       for f in e.value.findings])
                     for e in (created, patched)])
    assert seen[1] == seen[0]
    assert seen[0][0] == (406, [("error", "shape-mismatch",
                                 "classParameters.layer_configs")])


def test_function_service_rejects_escape_code_at_submit(contexts):
    from learningorchestra_tpu.services.function_service import \
        FunctionService as JaxFunctions
    from learningorchestra_tpu_torch.services.function_service import \
        FunctionService as PortFunctions

    body = {"name": "esc", "functionParameters": {},
            "function": "response = ().__class__.__base__"
                        ".__subclasses__()"}
    seen = []
    for ctx, service, errors in zip(contexts, (JaxFunctions, PortFunctions),
                                    (JV, PV)):
        with pytest.raises(errors.HttpError) as exc:
            service(ctx).create(dict(body))
        assert ctx.catalog.get_metadata("esc") is None
        seen.append((exc.value.status, sorted(
            f["rule"] for f in exc.value.findings)))
    assert seen[1] == seen[0]
    assert seen[0][0] == 406 and "dunder-attribute" in seen[0][1]


def test_preflight_flag_bypasses_all_submit_checks(tmp_path):
    """``LO_PREFLIGHT=0``: a spec the preflight would refuse is accepted
    at submit."""
    from learningorchestra_tpu_torch.services.model_service import \
        ModelService

    ctx = ServiceContext(Config(home=str(tmp_path), preflight=False),
                         device="cpu")
    try:
        status, _ = ModelService(ctx).create({
            "modelName": "blind", "modulePath": _NEURAL[0],
            "class": _NEURAL[1], "classParameters": {"layer_configs": [
                {"kind": "input", "shape": [8]},
                {"kind": "conv2d", "filters": 4, "kernel": 3}]}},
            "tensorflow")
        assert status == 201
        ctx.jobs.wait("blind", timeout=60)
    finally:
        ctx.close()


def test_builder_rejects_escaping_modeling_code(contexts):
    from learningorchestra_tpu.services.builder_service import \
        BuilderService as JaxBuilder
    from learningorchestra_tpu_torch.services.builder_service import \
        BuilderService as PortBuilder

    seen = []
    for ctx, builder, errors, columns in zip(
            contexts, (JaxBuilder, PortBuilder), (JV, PV),
            (_arrow_table, dict)):
        for ds in ("btrain", "btest"):
            ctx.catalog.create_collection(ds, "dataset/csv")
            with ctx.catalog.dataset_writer(ds) as w:
                w.write_batch(columns({"a": [1.0, 2.0], "label": [0, 1]}))
            ctx.catalog.mark_finished(ds)
        with pytest.raises(errors.HttpError) as exc:
            builder(ctx).create({
                "trainDatasetName": "btrain", "testDatasetName": "btest",
                "classifiersList": ["LR"],
                "modelingCode": "import os\n"
                                "features_training = training_df\n"})
        assert ctx.catalog.get_metadata("btestLR") is None
        seen.append((exc.value.status, [
            (f["severity"], f["rule"], f["location"])
            for f in exc.value.findings]))
    assert seen[1] == seen[0]
    assert seen[0][0] == 406 and seen[0][1][0][1] == "forbidden-import"


def _arrow_table(columns):
    import pyarrow as pa

    return pa.table(columns)
