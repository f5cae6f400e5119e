"""Tensor, fully-sharded, expert and pipeline parallelism of the port
against the JAX package's.

One module fixture spawns four gloo ranks on the CPU (processes that
import no JAX), which compute every case on their shards of the same
numpy inputs and save their results; each test compares one case with
the JAX package on its 8-device CPU test mesh (the Pallas kernels in
interpret mode where the case runs flash). Cases:

- the small LM's first step, loss and every gradient (gathered from the
  ranks' shards), at ``tp=2``, ``tp=4`` (4 heads over 2 kv heads: k and
  v replicated), ``fsdp=2``, ``dp=2,tp=2``, ``fsdp=2,tp=2``, ``sp=2,tp=2``
  ring (the vocabulary-parallel loss with a head chunk) and fused
  projections at ``tp=2``;
- the mixture of experts at ``ep=2`` and ``ep=2,tp=2``, and at ``dp=2``
  and ``sp=2`` ring with its router skewed so that experts overflow
  (ROADMAP Queue 3 item 45: the layer routes over the mesh's tokens);
- every parameter's shard shape against the JAX ``NamedSharding``'s;
- ``pipeline_apply`` and the pipelined LM's GPipe and 1F1B passes at
  ``pp=2`` and ``pp=4``, and the divisibility errors;
- a ``tp=2`` fit's checkpoint resumed on one rank, and a one-rank
  checkpoint resumed at ``tp=2``, each against the uninterrupted
  one-rank fit; a ``tp=2`` fit with dropout against the one-rank fit.

Tolerances: 2e-5 for values and 5e-5 for gradients in float32
(tests/test_ops.py's), the orders of summation being the only
difference; 1e-5 between the port's own fits.
"""

import contextlib
import functools
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from learningorchestra_tpu.models import pp_transformer as jax_pp
from learningorchestra_tpu.models import transformer as jax_tlm
from learningorchestra_tpu.parallel import pipeline as jax_pipeline
from learningorchestra_tpu.parallel import sharding as jax_sharding
from learningorchestra_tpu.runtime import mesh as jax_mesh
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.parallel import sharding
from learningorchestra_tpu_torch.runtime import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
FIT_TOL = dict(rtol=1e-5, atol=1e-5)

LM_CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, max_len=32, sliding_window=6)
MOE_CFG = dict(LM_CFG, n_experts=8, moe_k=2)
LM_BATCH = 8
# name -> (mesh spec, attention, head chunk, config)
LM_CASES = {
    "tp2": ("tp=2", "flash", 0, LM_CFG),
    "tp4-kv-replicated": ("tp=4", "flash", 0, LM_CFG),
    "fsdp2": ("fsdp=2", "flash", 0, LM_CFG),
    "dp2-tp2": ("dp=2,tp=2", "flash", 0, LM_CFG),
    "fsdp2-tp2": ("fsdp=2,tp=2", "flash", 0, LM_CFG),
    "sp2-tp2-ring": ("sp=2,tp=2", "ring", 8, LM_CFG),
    "fused-tp2": ("tp=2", "flash", 0,
                  dict(LM_CFG, n_kv_heads=0, fused_proj=True)),
    "moe-ep2": ("ep=2", "flash", 0, MOE_CFG),
    "moe-ep2-tp2": ("ep=2,tp=2", "flash", 0, MOE_CFG),
    "moe-dp2": ("dp=2", "flash", 0, MOE_CFG),
    "moe-sp2-ring": ("sp=2", "ring", 0, MOE_CFG),
}
# the pipelined LM: vocab, d_model, layers, heads; 8 windows of 12
PP_CFG = dict(vocab=32, d=16, layers=4, heads=2)
PP_CASES = {"pp2": "pp=2", "pp4": "pp=4"}
# the fits of the checkpoint cases: 16 windows, batch 8, two epochs
FIT_WINDOWS, FIT_BATCH = 16, 8
# meshes whose groups the ranks form in this order, the smaller first
GROUP_MESHES = ["tp=2", "dp=2,tp=2", "fsdp=2", "dp=2,pp=2", "sp=4"]
SHARD_MESHES = ["tp=2", "tp=4", "fsdp=2,tp=2", "dp=2,ep=2,tp=2",
                "fsdp=4,tp=2", "ep=4"]


def _lm_tree(cfg):
    """The case's flax tree, its MoE router skewed toward expert 0 so
    that the top choices overflow their capacity."""
    tree = weights.init_params(cfg, seed=0)
    for i in range(cfg["n_layers"]):
        layer = tree[f"layer_{i}"]
        if "moe" in layer:
            layer["moe"]["gate"][:, 0] *= 12.0
    return tree


def _lm_tokens():
    return np.random.default_rng(7).integers(
        1, LM_CFG["vocab_size"], size=(LM_BATCH, 32)).astype(np.int32)


def _fit_tokens():
    return np.random.default_rng(3).integers(
        1, LM_CFG["vocab_size"], size=(FIT_WINDOWS, 32)).astype(np.int32)


def _pp_params():
    """The pipelined LM's params as numpy (seed 0)."""
    from learningorchestra_tpu_torch.models import pp_transformer

    c = PP_CFG
    return weights.pp_params_to_numpy(pp_transformer.init_params(
        0, c["vocab"], c["d"], c["layers"]))


def _pp_tokens():
    return np.random.default_rng(0).integers(
        1, PP_CFG["vocab"], size=(8, 12)).astype(np.int32)


def _stage_inputs():
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(4, 6, 6)) * 0.4).astype(np.float32)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    return w, x


_RANK = textwrap.dedent("""
    import datetime, os, pickle, sys
    sys.path.insert(0, @REPO@)
    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from learningorchestra_tpu_torch.models import pp_transformer as pp
    from learningorchestra_tpu_torch.models import transformer as tlm
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.parallel import pipeline
    from learningorchestra_tpu_torch.runtime import checkpoint
    from learningorchestra_tpu_torch.runtime import data
    from learningorchestra_tpu_torch.runtime import distributed as dist
    from learningorchestra_tpu_torch.runtime import mesh as mesh_lib

    rank = int(sys.argv[1])
    with open(@INPUTS@, "rb") as f:
        inputs = pickle.load(f)
    assert dist.initialize("127.0.0.1:@PORT@", @WORLD@, rank, device="cpu",
                           timeout=datetime.timedelta(seconds=120))
    out = {}

    # a smaller mesh's groups, then a larger one's, then the smaller
    # one's ranks again: every rank forms each mesh's groups at the same
    # point, the ranks outside a mesh too; each axis's group sums the
    # ranks' (rank + 1)
    sums = {}
    for spec in inputs["groupMeshes"]:
        mesh = mesh_lib.build_mesh(spec)
        if mesh.coords(rank) is None:
            mesh.form_groups()
            continue
        sums[spec] = {
            axis: float(dist.all_reduce(torch.tensor([rank + 1.0]),
                                        mesh.group(axis))[0])
            for axis in mesh.axis_names if mesh.shape[axis] > 1}
    out["groupSums"] = sums

    def model(cfg, attention, chunk, tree, mesh):
        lm = tlm.LanguageModel(**cfg, attention=attention,
                               head_chunk=chunk, device="cpu")
        lm.set_params(weights.params_from_flax(tree))
        lm._mesh_override = mesh
        return lm

    x = inputs["tokens"]
    batch = {"x": x, data.MASK_KEY: np.ones(len(x), np.float32)}
    for name, (spec, attention, chunk, cfg) in inputs["lm"].items():
        mesh = mesh_lib.build_mesh(spec)
        if mesh.coords(rank) is None:  # a mesh smaller than the world
            mesh.form_groups()
            continue
        lm = model(cfg, attention, chunk, inputs["trees"][name], mesh)
        blocks = [getattr(lm.module, "layer_%d" % i)
                  for i in range(cfg["n_layers"])]
        for block in blocks:
            if hasattr(block, "moe"):
                block.moe.stats = {}
        eng = lm._get_engine()
        shard, columns = lm._plan(x.shape[1])
        state = eng.init_state(lm._master_params(),
                               layout=lm._layout(shard))
        grads, metrics = eng.sharded_grads(state, batch, 0, shard, columns)
        local = {k: tuple(t.shape) for k, t in state.params.items()}
        slots = {k: tuple(t.shape) for k, t in
                 state.opt_state["mu"].items()}
        if state.layout is not None:
            grads = state.layout.gather(grads)
        dropped = sum(block.moe.stats.get("dropped", 0)
                      for block in blocks if hasattr(block, "moe"))
        out["lm-" + name] = {
            "loss": float(metrics["loss"][0] / metrics["loss"][1]),
            "accuracy": float(metrics["accuracy"][0]
                              / metrics["accuracy"][1]),
            "local": local, "slots": slots, "dropped": dropped,
            "grads": weights.params_to_flax(
                {k: g.detach() for k, g in grads.items()})}

    # the pipeline: a stage function over stacked weights, then the LM
    w, xs = inputs["stage"]
    for name, spec in inputs["pp"].items():
        mesh = mesh_lib.build_mesh(spec)
        if mesh.coords(rank) is None:
            mesh.form_groups()
            continue
        stages = pipeline.Stages(mesh)
        wt = torch.from_numpy(w).requires_grad_(True)
        xt = torch.from_numpy(xs).requires_grad_(True)

        def stage_fn(p, h):
            for i in range(p["w"].shape[0]):
                h = torch.tanh(h @ p["w"][i])
            return h

        y = pipeline.pipeline_apply(
            stage_fn, pipeline.stage_slice({"w": wt}, stages), xt, stages,
            num_microbatches=4)
        (y ** 2).sum().backward()
        dw = dist.all_reduce(wt.grad.clone(), stages.group)
        res = {"y": y.detach().numpy(), "dw": dw.numpy(),
               "dx": xt.grad.numpy()}
        params = weights.pp_params_from_numpy(inputs["ppParams"])
        leaves = [params["embed"]] + [params["blocks"][k]
                                     for k in pp.BLOCK_KEYS]
        for t in leaves:
            t.requires_grad_(True)
        c = inputs["ppCfg"]
        loss = pp.next_token_loss(params, inputs["ppTokens"], mesh,
                                  c["heads"], num_microbatches=4,
                                  attention="flash")
        g = torch.autograd.grad(loss, leaves)
        # each stage's rows of the block gradients: the sum over pp is
        # the whole gradient (the embedding's is whole on every stage)
        g = [g[0]] + [dist.all_reduce(t.clone(), stages.group)
                      for t in g[1:]]
        res["gpipe"] = (float(loss), [t.numpy() for t in g])
        loss, grads = pp.value_and_grad_1f1b(
            params, inputs["ppTokens"], mesh, c["heads"],
            num_microbatches=4, attention="flash")
        res["1f1b"] = (float(loss), weights.pp_params_to_numpy(grads))
        try:
            pp.forward(params, inputs["ppTokens"][:6], mesh, c["heads"],
                       num_microbatches=4)
        except ValueError as exc:
            res["microbatchError"] = str(exc)
        out["pp-" + name] = res

    # checkpoints: a tp=2 fit of one epoch saved, and the one-rank
    # checkpoint (made by the test) resumed at tp=2 to two epochs
    mesh = mesh_lib.build_mesh("tp=2")
    mesh.form_groups()
    if mesh.coords(rank) is not None:
        fx = inputs["fitTokens"]
        cfg = inputs["fitCfg"]
        lm = model(cfg, "flash", 0, inputs["fitTree"], mesh)
        lm.fit(fx, batch_size=inputs["fitBatch"], epochs=1, shuffle=False,
               checkpointer=checkpoint.Checkpointer(inputs["tpCkpt"]))
        lm = model(cfg, "flash", 0, inputs["fitTree"], mesh)
        lm.fit(fx, batch_size=inputs["fitBatch"], epochs=2, shuffle=False,
               checkpointer=checkpoint.Checkpointer(inputs["oneCkpt"]))
        out["resumedAtTp2"] = weights.params_to_flax(
            {k: t.detach() for k, t in lm._master_params().items()})
        # dropout: the two tp ranks of the block draw one mask
        lm = model(dict(cfg, dropout=0.1), "flash", 0, inputs["fitTree"],
                   mesh)
        history = lm.fit(fx, batch_size=inputs["fitBatch"], epochs=1,
                         shuffle=False).history
        out["dropoutAtTp2"] = (history["loss"], weights.params_to_flax(
            {k: t.detach() for k, t in lm._master_params().items()}))
    out["hostInfo"] = dist.host_info("cpu")
    dist.barrier()
    dist.shutdown()
    with open(os.path.join(@OUT@, "rank%d.pkl" % rank), "wb") as f:
        pickle.dump(out, f)
    print("RANK_OK", rank, flush=True)
""")


@contextlib.contextmanager
def _float32():
    """The port's fits in this process compute in float32, as the ranks'
    do (the variable is put back after)."""
    before = os.environ.get("LO_COMPUTE_DTYPE")
    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("LO_COMPUTE_DTYPE")
        else:
            os.environ["LO_COMPUTE_DTYPE"] = before


def _port_lm(cfg, tree=None):
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel

    lm = LanguageModel(**cfg, attention="flash", device="cpu")
    lm.set_params(weights.params_from_flax(
        tree if tree is not None else weights.init_params(cfg, seed=0)))
    return lm


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on four gloo CPU ranks: ``[rank 0's results, ...]``,
    and the one-rank fits of the checkpoint cases."""
    from learningorchestra_tpu_torch.runtime import checkpoint

    tmp = tmp_path_factory.mktemp("ranks")
    one_ckpt, tp_ckpt = str(tmp / "one"), str(tmp / "tp")
    # the one-rank checkpoint of epoch 1, which the ranks resume at tp=2
    _one_rank_fit(1, checkpoint.Checkpointer(one_ckpt))
    inputs = {
        "groupMeshes": GROUP_MESHES,
        "lm": LM_CASES, "tokens": _lm_tokens(),
        "trees": {name: _lm_tree(case[3])
                  for name, case in LM_CASES.items()},
        "pp": PP_CASES, "ppCfg": PP_CFG, "ppParams": _pp_params(),
        "ppTokens": _pp_tokens(), "stage": _stage_inputs(),
        "fitTokens": _fit_tokens(), "fitBatch": FIT_BATCH,
        "fitCfg": LM_CFG, "fitTree": weights.init_params(LM_CFG, seed=0),
        "oneCkpt": one_ckpt, "tpCkpt": tp_ckpt}
    path = str(tmp / "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = (_RANK.replace("@REPO@", repr(REPO))
              .replace("@INPUTS@", repr(path)).replace("@OUT@", repr(str(tmp)))
              .replace("@PORT@", str(port)).replace("@WORLD@", str(WORLD)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out.decode(errors="replace"))
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in text, text[-4000:]
    results = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return {"ranks": results, "oneCkpt": one_ckpt, "tpCkpt": tp_ckpt}


def _mesh(spec):
    n = int(np.prod(list(jax_mesh.parse_mesh_spec(spec).values())))
    return jax_mesh.build_mesh(spec, devices=jax.devices()[:n])


def _jax_lm_step(name):
    spec, attention, chunk, cfg = LM_CASES[name]
    mesh = _mesh(spec)
    tree = _lm_tree(cfg)
    lm = jax_tlm.LanguageModel(**cfg, attention=attention,
                               head_chunk=chunk)
    module = lm.module.clone(mesh=mesh, fused_head_chunk=chunk)
    loss_fn = jax_tlm.next_token_loss(0.01, head_chunk=chunk or 1024,
                                      mesh=mesh)
    x = jnp.asarray(_lm_tokens())
    mask = jnp.ones((LM_BATCH,), jnp.float32)

    def loss(params):
        out = module.apply({"params": params}, x, train=True)
        res = loss_fn(out, {"x": x}, mask)
        return res[0] if isinstance(res, tuple) else res

    value, grads = jax.jit(jax.value_and_grad(loss))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    return float(value), grads


@pytest.mark.parametrize("spec", GROUP_MESHES)
def test_groups_of_a_smaller_mesh_then_a_larger_one(ranks, spec):
    """Each member's group along each axis sums over exactly the ranks
    that the mesh puts in its block, whatever meshes came before."""
    mesh = mesh_lib.build_mesh(spec, devices=list(range(WORLD)))
    for r, res in enumerate(ranks["ranks"]):
        if mesh.coords(r) is None:
            assert spec not in res["groupSums"]
            continue
        want = {axis: float(sum(b + 1 for b in mesh.axis_ranks(axis, r)))
                for axis in mesh.axis_names if mesh.shape[axis] > 1}
        assert res["groupSums"][spec] == want


@pytest.mark.parametrize("name", list(LM_CASES))
def test_model_parallel_lm_first_step_matches_jax(ranks, name):
    spec = LM_CASES[name][0]
    want_loss, want_grads = _jax_lm_step(name)
    n = int(np.prod(list(jax_mesh.parse_mesh_spec(spec).values())))
    got = ranks["ranks"][0]["lm-" + name]
    # every rank of the mesh ends the step with the same loss and the
    # same whole gradients
    for other in ranks["ranks"][1:n]:
        assert other["lm-" + name]["loss"] == got["loss"]
    np.testing.assert_allclose(got["loss"], want_loss, **VALUE_TOL)
    assert jax.tree_util.tree_structure(got["grads"]) == \
        jax.tree_util.tree_structure(want_grads)
    for a, b in zip(jax.tree_util.tree_leaves(got["grads"]),
                    jax.tree_util.tree_leaves(want_grads)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **GRAD_TOL)
    if name.startswith("moe-") and "ep" not in spec:
        # the repair's cases route under pressure
        assert got["dropped"] > 0


@pytest.mark.parametrize("name", list(LM_CASES))
def test_each_rank_holds_its_shards(ranks, name):
    """Each rank's params and AdamW moments have the shard shapes that
    ``spec_for`` with the LM's rules gives (the tensor, expert and fsdp
    axes shard; a data or sequence axis alone shards nothing)."""
    spec, _, _, cfg = LM_CASES[name]
    n = int(np.prod(list(jax_mesh.parse_mesh_spec(spec).values())))
    mesh = mesh_lib.Mesh(mesh_lib.parse_mesh_spec(spec), range(n))
    lm = _port_lm(cfg, _lm_tree(cfg))
    specs = sharding.param_specs(
        {k: tuple(p.shape) for k, p in lm.module.named_parameters()},
        mesh, weights.flax_path, lm._param_rules(mesh))
    want = {k: sharding.local_shape(tuple(p.shape), specs[k], mesh)
            for k, p in lm.module.named_parameters()}
    for result in ranks["ranks"][:n]:
        got = result["lm-" + name]
        assert got["local"] == want and got["slots"] == want
    if any(a in spec for a in ("tp", "ep", "fsdp")):
        assert any(want[k] != tuple(p.shape)
                   for k, p in lm.module.named_parameters())


@pytest.mark.parametrize("spec", SHARD_MESHES)
@pytest.mark.parametrize("cfg", [LM_CFG, MOE_CFG,
                                 dict(LM_CFG, n_kv_heads=0,
                                      fused_proj=True)],
                         ids=["gqa", "moe", "fused"])
def test_shard_shapes_match_named_sharding(spec, cfg):
    """Every leaf's shard shape on a port rank equals the per-device
    shard shape of the JAX ``NamedSharding`` of the LM's rules."""
    jmesh = jax_mesh.build_mesh(spec, devices=jax.devices())
    mesh = mesh_lib.Mesh(dict(jmesh.shape), range(jmesh.size))
    tree = weights.init_params(cfg, seed=0)
    jlm = jax_tlm.LanguageModel(**cfg)
    lm = _port_lm(cfg, tree)
    shardings = jax_sharding.param_shardings(
        tree, jmesh, jlm._param_rules(jmesh))
    specs = sharding.param_specs(
        {k: tuple(p.shape) for k, p in lm.module.named_parameters()},
        mesh, weights.flax_path, lm._param_rules(mesh))
    for key, p in lm.module.named_parameters():
        path, transposed = weights.flax_path(key)
        node, shard = tree, shardings
        for part in path:
            node, shard = node[part], shard[part]
        want = shard.shard_shape(node.shape)
        got = sharding.local_shape(tuple(p.shape), specs[key], mesh)
        assert (got[::-1] if transposed else got) == tuple(want), key


def _jax_stage_fn(p, h):
    for i in range(p["w"].shape[0]):
        h = jnp.tanh(h @ p["w"][i])
    return h


@pytest.mark.parametrize("name", list(PP_CASES))
def test_pipeline_apply_matches_jax(ranks, name):
    spec = PP_CASES[name]
    mesh = _mesh(spec)
    n = mesh.shape["pp"]
    w, x = _stage_inputs()

    def run(w, x):
        stacked = {"w": w.reshape((n, w.shape[0] // n) + w.shape[1:])}
        return jax_pipeline.pipeline_apply(_jax_stage_fn, stacked, x, mesh,
                                           num_microbatches=4)

    y = jax.jit(run)(jnp.asarray(w), jnp.asarray(x))
    dw, dx = jax.jit(jax.grad(lambda a, b: jnp.sum(run(a, b) ** 2),
                              argnums=(0, 1)))(jnp.asarray(w),
                                               jnp.asarray(x))
    for result in ranks["ranks"][:n]:
        got = result["pp-" + name]
        np.testing.assert_allclose(got["y"], np.asarray(y), **VALUE_TOL)
        np.testing.assert_allclose(got["dw"], np.asarray(dw), **GRAD_TOL)
        np.testing.assert_allclose(got["dx"], np.asarray(dx), **GRAD_TOL)


def _jax_pp_params():
    return jax.tree_util.tree_map(jnp.asarray, _pp_params())


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("name", list(PP_CASES))
def test_pipelined_lm_matches_jax(ranks, name, schedule):
    spec = PP_CASES[name]
    mesh = _mesh(spec)
    n = mesh.shape["pp"]
    params = _jax_pp_params()
    tokens = jnp.asarray(_pp_tokens())
    heads = PP_CFG["heads"]
    if schedule == "1f1b":
        want_loss, want = jax.jit(lambda p: jax_pp.value_and_grad_1f1b(
            p, tokens, mesh, heads, num_microbatches=4,
            attention="flash"))(params)
    else:
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p: jax_pp.next_token_loss(
                p, tokens, mesh, heads, num_microbatches=4,
                attention="flash")))(params)
    want_list = [want["embed"]] + [want["blocks"][k] for k in
                                   weights.PP_BLOCK_KEYS]
    for result in ranks["ranks"][:n]:
        loss, got = result["pp-" + name][schedule]
        if isinstance(got, dict):
            got = [got["embed"]] + [got["blocks"][k]
                                    for k in weights.PP_BLOCK_KEYS]
        np.testing.assert_allclose(loss, float(want_loss), **VALUE_TOL)
        for a, b in zip(got, want_list):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       **GRAD_TOL)


def test_pipeline_divisibility_errors(ranks):
    """A batch the microbatches do not divide raises, as in JAX, and so
    do layers that pp does not divide."""
    from learningorchestra_tpu_torch.models import pp_transformer

    for name in PP_CASES:
        assert "not divisible by microbatches 4" in \
            ranks["ranks"][0]["pp-" + name]["microbatchError"]
    params = weights.pp_params_from_numpy(_pp_params())
    mesh = mesh_lib.Mesh({"pp": 8}, range(8))
    with pytest.raises(ValueError, match="not divisible"):
        pp_transformer.forward(params, _pp_tokens(), mesh, 2)
    with pytest.raises(ValueError, match="not divisible"):
        jax_pp.forward(_jax_pp_params(), jnp.asarray(_pp_tokens()),
                       jax_mesh.build_mesh("pp=8"), 2)


def _one_rank_fit(epochs, checkpointer=None):
    lm = _port_lm(LM_CFG)
    with _float32():
        lm.fit(_fit_tokens(), batch_size=FIT_BATCH, epochs=epochs,
               shuffle=False, checkpointer=checkpointer)
    return weights.params_to_flax(
        {k: t.detach() for k, t in lm._master_params().items()})


@functools.lru_cache(maxsize=None)
def _uninterrupted_fit():
    """The one-rank fit of both epochs, which both resumes must end at."""
    return _one_rank_fit(2)


def _assert_trees_close(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **FIT_TOL)


def test_tp2_checkpoint_resumes_on_one_rank(ranks):
    """The tp=2 fit's checkpoint holds the whole flax tree; one rank
    resumes it and ends where the uninterrupted one-rank fit ends."""
    from learningorchestra_tpu_torch.runtime import checkpoint

    ck = checkpoint.Checkpointer(ranks["tpCkpt"])
    assert ck.latest_step() == FIT_WINDOWS // FIT_BATCH
    meta = ck.saved_metadata()
    whole = weights.init_params(LM_CFG, seed=0)
    for leaf, want in zip(jax.tree_util.tree_leaves(meta["params"]),
                          jax.tree_util.tree_leaves(whole)):
        assert tuple(leaf.shape) == want.shape
    _assert_trees_close(_one_rank_fit(2, ck), _uninterrupted_fit())


def test_tp2_dropout_fit_matches_one_rank(ranks):
    """Dropout at tp=2: the two ranks of the (only) row block draw the
    one-rank stream's masks over the same replicated activations, so the
    fit is the one-rank fit's (ROADMAP Queue 3 item 42)."""
    lm = _port_lm(dict(LM_CFG, dropout=0.1))
    with _float32():
        want = lm.fit(_fit_tokens(), batch_size=FIT_BATCH, epochs=1,
                      shuffle=False).history["loss"]
    tree = weights.params_to_flax(
        {k: t.detach() for k, t in lm._master_params().items()})
    for result in ranks["ranks"][:2]:
        losses, got = result["dropoutAtTp2"]
        np.testing.assert_allclose(losses, want, **FIT_TOL)
        _assert_trees_close(got, tree)


def test_one_rank_checkpoint_resumes_at_tp2(ranks):
    for result in ranks["ranks"][:2]:
        _assert_trees_close(result["resumedAtTp2"], _uninterrupted_fit())
