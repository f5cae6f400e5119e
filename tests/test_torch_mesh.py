"""The port's mesh and sharding rules against the JAX package's.

``runtime/mesh.py`` lays the JAX package's axes over process-group
ranks and ``parallel/sharding.py`` keeps its rule table as pure
functions; both are held here against the JAX functions on the
8-device CPU test mesh (rank ``i`` standing for device ``i``). A mesh
with ``tp``, ``fsdp``, ``ep`` or ``pp`` above 1 is built as the JAX
package builds it, and a service boots on it; each rank's parameter
shards take the shapes of the JAX ``NamedSharding``'s shards. The
preflight's ``mesh-divisibility`` warning of a ``LanguageModel`` fit
(the port's own: the JAX package checks the ``NeuralModel`` fits it
shards) is held on meshes set as the default.
"""

import dataclasses
import pkgutil

import jax
import numpy as np
import pytest

import learningorchestra_tpu_torch
from learningorchestra_tpu.parallel import sharding as jax_sharding
from learningorchestra_tpu.runtime import mesh as jax_mesh
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.parallel import sharding
from learningorchestra_tpu_torch.runtime import mesh as mesh_lib

SPECS = ["auto", "dp=8", "dp=2,sp=4", "dp=-1,sp=2", "sp=-1", "dcn=2,dp=4",
         "dcn=2,dp=-1,sp=2", "dp=2", "sp=4", "dp=1", "dp = 2 , sp = 2"]
BAD_SPECS = ["dp=2,dcn=2", "dp=-1,sp=-1", "dp=16", "dp=3,sp=-1", "",
             "dp:2", "DP=2"]


def _jax(spec):
    return jax_mesh.build_mesh(spec, devices=jax.devices())


def _ids(mesh):
    return [d.id for d in np.asarray(mesh.devices).flat]


@pytest.mark.parametrize("spec", SPECS)
def test_build_mesh_matches_jax(spec):
    want = _jax(spec)
    got = mesh_lib.build_mesh(spec, devices=range(8))
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.ranks.shape == np.asarray(want.devices).shape
    assert list(got.ranks.flat) == _ids(want)
    assert mesh_lib.data_axes(got) == jax_mesh.data_axes(want)
    assert mesh_lib.data_parallel_size(got) == \
        jax_mesh.data_parallel_size(want)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_in_both(spec):
    with pytest.raises(ValueError):
        _jax(spec)
    with pytest.raises(ValueError):
        mesh_lib.build_mesh(spec, devices=range(8))


@pytest.mark.parametrize("spec", ["dp=2,sp=2", " dp = 4 ", "tp=2,dp=-1"])
def test_parse_mesh_spec_matches_jax(spec):
    assert mesh_lib.parse_mesh_spec(spec) == jax_mesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", ["tp=2", "dp=2,fsdp=2", "ep=4",
                                  "dp=2,pp=2", "fsdp=-1"])
def test_model_parallel_axes_are_accepted(spec, tmp_path):
    """The axes the port once refused build as the JAX package builds
    them, pass the boot check and boot a service."""
    want = _jax(spec)
    got = mesh_lib.build_mesh(spec, devices=range(8))
    assert got.shape == dict(want.shape)
    assert list(got.ranks.flat) == _ids(want)
    mesh_lib.check_spec(spec)
    from learningorchestra_tpu_torch.services.context import ServiceContext

    config = dataclasses.replace(Config(home=str(tmp_path)),
                                 mesh_shape=spec)
    ServiceContext(config, device="cpu").close()
    # size 1 is no parallelism, as before
    mesh_lib.build_mesh("dp=2,tp=1,fsdp=1", devices=range(8))


def test_slices_and_sub_meshes_match_jax():
    devices = jax.devices()
    for k in (1, 2, 3, 8, 20):
        want = jax_mesh.sub_meshes(_jax("auto"), k)
        got = mesh_lib.sub_meshes(mesh_lib.build_mesh("auto", range(8)), k)
        assert [list(m.ranks.flat) for m in got] == \
            [_ids(m) for m in want]
    for idx in ([1, 3, 5], [0, 1], [2]):
        want = jax_mesh.slice_mesh([devices[i] for i in idx])
        got = mesh_lib.slice_mesh(idx)
        assert list(got.ranks.flat) == _ids(want)
        assert got == mesh_lib.slice_mesh(list(idx))
        assert got.axis_names == tuple(want.axis_names)


def test_default_mesh_grants_and_fractions(monkeypatch):
    monkeypatch.setenv("LO_MESH_SHAPE", "auto")
    mesh_lib.reset_default_mesh()
    try:
        base = mesh_lib.get_default_mesh()  # a world of one rank
        assert base.shape == {"dp": 1} and list(base.ranks.flat) == [0]
        assert mesh_lib.mesh_for_slice(None) is base
        assert mesh_lib.mesh_for_slice([0]) is base
        assert mesh_lib.mesh_fraction(base) == 1.0
        assert mesh_lib.current_mesh() is base
        other = mesh_lib.build_mesh("dp=2", devices=[4, 5])
        with mesh_lib.use_mesh(other):
            assert mesh_lib.current_mesh() is other
            assert mesh_lib.set_current_mesh(base) is other
            assert mesh_lib.current_mesh() is base
        assert mesh_lib.current_mesh() is base
        with mesh_lib.use_mesh(None):
            assert mesh_lib.current_mesh() is base
    finally:
        mesh_lib.reset_default_mesh()


@pytest.mark.parametrize("n,multiple", [(7, 2), (8, 2), (1, 8), (17, 4)])
def test_pad_to_multiple_matches_jax(n, multiple):
    assert mesh_lib.pad_to_multiple(n, multiple) == \
        jax_mesh.pad_to_multiple(n, multiple)


def test_shard_blocks_follow_the_mesh():
    """The rows and sequence columns each rank of dp=2,sp=2 takes: the
    JAX batch spec's layout (rows over dp, the sequence over sp)."""
    mesh = mesh_lib.build_mesh("dp=2,sp=2", devices=range(4))
    blocks = {}
    for rank in range(4):
        shard = mesh_lib.Shard(mesh, rank, seq_parallel=True)
        blocks[rank] = (shard.rows(8), shard.columns(32), shard.row_index)
        assert mesh.axis_ranks("sp", rank) == shard.seq_ranks
    assert blocks == {0: (slice(0, 4), slice(0, 16), 0),
                      1: (slice(0, 4), slice(16, 32), 1),
                      2: (slice(4, 8), slice(0, 16), 2),
                      3: (slice(4, 8), slice(16, 32), 3)}
    flat = mesh_lib.Shard(mesh, 3, seq_parallel=False)
    assert (flat.seq_size, flat.columns(32)) == (1, slice(0, 32))
    with pytest.raises(ValueError):
        mesh_lib.Shard(mesh, 7, seq_parallel=True)


# ----------------------------------------------------------------------
# the sharding rule table
# ----------------------------------------------------------------------
RULE_MESHES = ["dp=2,tp=4", "fsdp=2,tp=2,dp=2", "dp=8", "ep=2,tp=2,dp=2",
               "tp=8", "fsdp=8"]
PATHS = [("decoder/layer_0/attn/q_proj/kernel", (512, 512)),
         ("layer_1/attn/k_proj/kernel", (512, 3)),
         ("layer_1/attn/qkv_proj/kernel", (512, 1536)),
         ("layer_0/attn/o_proj/kernel", (512, 512)),
         ("layer_0/mlp/down_proj/kernel", (2048, 512)),
         ("embed/embedding", (32000, 512)),
         ("lm_head/kernel", (512, 32000)),
         ("layer_0/moe/experts/wi", (8, 512, 2048)),
         ("layer_0/moe/experts/wo", (8, 2048, 512)),
         ("layer_0/attn_norm/scale", (512,)),
         ("final_norm/scale", (7,)),
         ("other/thing", (6, 10))]


def _rule_mesh(spec):
    """The port's mesh for ``spec`` without the port's refusal (the rule
    functions are pure and take any axes)."""
    sizes = mesh_lib.parse_mesh_spec(spec)
    if sizes.get("dp") == -1:
        sizes["dp"] = 8 // int(np.prod([s for s in sizes.values()
                                        if s != -1]))
    return mesh_lib.Mesh(sizes, range(8))


@pytest.mark.parametrize("spec", RULE_MESHES)
@pytest.mark.parametrize("fsdp", [True, False])
def test_spec_for_matches_jax(spec, fsdp):
    want_mesh, got_mesh = _jax(spec), _rule_mesh(spec)
    for path, shape in PATHS:
        want = jax_sharding.spec_for(path, shape, want_mesh, fsdp=fsdp)
        got = sharding.spec_for(path, shape, got_mesh, fsdp=fsdp)
        assert tuple(got) == tuple(want), (path, got, want)


@pytest.mark.parametrize("spec", RULE_MESHES + ["dp=2,sp=4", "sp=8",
                                                "dcn=2,dp=2,sp=2"])
@pytest.mark.parametrize("seq_axis", [False, True])
def test_batch_spec_matches_jax(spec, seq_axis):
    want = jax_sharding.batch_spec(_jax(spec), seq_axis=seq_axis)
    got = sharding.batch_spec(_rule_mesh(spec), seq_axis=seq_axis)
    assert tuple(got) == tuple(want)


def test_private_rule_helpers_match_jax():
    want_mesh, got_mesh = _jax("fsdp=2,tp=4"), _rule_mesh("fsdp=2,tp=4")
    P, JP = sharding.P, jax.sharding.PartitionSpec
    cases = [((None, "tp"), (512, 6)), (("tp", None), (8, 8)),
             ((("fsdp", "tp"), None), (16, 3)), ((None, "dp"), (4, 4))]
    for entries, shape in cases:
        assert tuple(sharding._drop_non_divisible(
            sharding._axes_in_mesh(P(*entries), got_mesh), shape,
            got_mesh)) == tuple(jax_sharding._drop_non_divisible(
                jax_sharding._axes_in_mesh(JP(*entries), want_mesh), shape,
                want_mesh))
        assert tuple(sharding._fsdp_spec(shape, P(*entries), got_mesh)) == \
            tuple(jax_sharding._fsdp_spec(shape, JP(*entries), want_mesh))


def test_new_modules_are_probed_for_imports():
    """tests/test_torch_imports.py imports every module of the package
    without JAX; this slice's modules are among them."""
    names = {m.name for m in pkgutil.walk_packages(
        learningorchestra_tpu_torch.__path__,
        learningorchestra_tpu_torch.__name__ + ".")}
    assert {"learningorchestra_tpu_torch.runtime.mesh",
            "learningorchestra_tpu_torch.runtime.distributed",
            "learningorchestra_tpu_torch.cluster",
            "learningorchestra_tpu_torch.parallel.sharding",
            "learningorchestra_tpu_torch.parallel.ring",
            "learningorchestra_tpu_torch.parallel.ulysses",
            "learningorchestra_tpu_torch.parallel.pipeline",
            "learningorchestra_tpu_torch.models.pp_transformer"} <= names


class _Catalog:
    """A catalog that knows one corpus's recorded shapes."""

    def __init__(self, seq: int):
        self._meta = {"corpus": {"resultShapes": {
            "tokens": {"shape": [64, seq], "dtype": "int32"}}}}

    def get_metadata(self, name):
        return self._meta.get(name)


@pytest.mark.parametrize("spec,attention,batch,seq,want", [
    ("dp=2,sp=2", "ring", 8, 64, []),
    ("dp=2,sp=2", "ring", 7, 64, ["methodParameters.batch_size"]),
    ("dp=2,sp=2", "ulysses", 8, 63, ["methodParameters.x"]),
    ("dp=2,sp=2", "flash", 8, 63, []),
    ("dp=4", "dot", 6, 64, ["methodParameters.batch_size"]),
    ("sp=4", "ring", 5, 30, ["methodParameters.x"]),
    # fsdp is a data axis; tp and pp hold the same rows
    ("fsdp=2,tp=2", "flash", 7, 64, ["methodParameters.batch_size"]),
    ("dp=2,pp=2", "dot", 6, 64, []),
])
def test_mesh_divisibility_of_a_language_model_fit(monkeypatch, spec,
                                                   attention, batch, seq,
                                                   want):
    """The preflight's ``mesh-divisibility`` warning for an LM fit on the
    default mesh: a batch the data axes do not divide, or, under ring or
    Ulysses, windows ``sp`` does not divide."""
    from learningorchestra_tpu_torch.analysis import preflight

    monkeypatch.setattr(mesh_lib, "_default_mesh",
                        mesh_lib.build_mesh(spec, devices=range(4)))
    root = {"modulePath": "learningorchestra_tpu_torch.models",
            "class": "LanguageModel",
            "classParameters": {"vocab_size": 64, "attention": attention}}
    found = preflight.check_execution(
        _Catalog(seq), root, "fit",
        {"x": "$corpus.tokens", "batch_size": batch})
    assert [(f.severity, f.rule) for f in found] == \
        [("warning", "mesh-divisibility")] * len(want)
    assert [f.location for f in found] == want
    # an evaluate, and a world of one rank, never warn
    assert preflight.check_execution(
        _Catalog(seq), root, "evaluate",
        {"x": "$corpus.tokens", "batch_size": batch}) == []
    monkeypatch.setattr(mesh_lib, "_default_mesh",
                        mesh_lib.build_mesh("auto", devices=[0]))
    assert preflight.check_execution(
        _Catalog(seq), root, "fit",
        {"x": "$corpus.tokens", "batch_size": batch}) == []
