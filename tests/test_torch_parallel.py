"""Ring and Ulysses attention and the sharded LM step of the port against
the JAX package's.

One module fixture spawns four gloo ranks on the CPU (processes that
import no JAX) which compute every case on their blocks of the same
numpy inputs and save their results; each test compares one case with
the JAX package on its 8-device CPU test mesh (the Pallas kernels in
interpret mode where the case is the flash ring). Cases: the dense and
flash rings, causal or not, their gradients, sliding windows (one below
a shard, multi-tile shards), Ulysses (GQA-native with kv heads dividing
``sp``) at ``sp=4``; and the first step of a small LM (2 layers, window
6 below the shard of 16) at ``dp=2``, ``sp=2`` ring, ``sp=2`` Ulysses and
``dp=2,sp=2`` ring: loss and every gradient.

Tolerances: 2e-5 for values and 5e-5 for gradients in float32
(tests/test_ops.py's), the orders of summation being the only
difference.
"""

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

from learningorchestra_tpu.models import transformer as jax_tlm
from learningorchestra_tpu.parallel import ring as jax_ring
from learningorchestra_tpu.parallel import ulysses as jax_ulysses
from learningorchestra_tpu.runtime import mesh as jax_mesh
from learningorchestra_tpu_torch.models import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)

LM_CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, max_len=32, sliding_window=6)
LM_BATCH = 8

# name -> (shape (b, s, h, d), kv heads, seed, causal, window, impl,
# with gradients)
OPS = {
    "ring-dense": ((2, 32, 4, 16), 4, 0, False, 0, "dense", False),
    "ring-dense-causal": ((2, 32, 4, 16), 4, 0, True, 0, "dense", False),
    "ring-dense-causal-grads": ((1, 16, 2, 8), 2, 3, True, 0, "dense",
                                True),
    "ring-flash": ((2, 32, 4, 16), 4, 0, False, 0, "flash", False),
    "ring-flash-causal": ((2, 32, 4, 16), 4, 0, True, 0, "flash", False),
    "ring-flash-causal-grads": ((1, 16, 2, 8), 2, 3, True, 0, "flash",
                                True),
    "ring-dense-window5": ((1, 32, 2, 8), 2, 1, True, 5, "dense", False),
    "ring-flash-window5": ((1, 32, 2, 8), 2, 1, True, 5, "flash", False),
    "ring-flash-window9-grads": ((1, 32, 2, 8), 2, 1, True, 9, "flash",
                                 True),
    "ring-flash-window64": ((1, 32, 2, 8), 2, 1, True, 64, "flash", False),
    "ring-flash-multitile-grads": ((1, 160, 2, 8), 2, 2, True, 10, "flash",
                                   True),
    "ulysses": ((2, 32, 4, 16), 4, 0, False, 0, "ulysses", False),
    "ulysses-causal-grads": ((2, 32, 4, 16), 4, 0, True, 0, "ulysses",
                             True),
    "ulysses-gqa-window-grads": ((1, 32, 8, 8), 4, 4, True, 9, "ulysses",
                                 True),
}
# name -> (mesh spec, attention, head chunk)
LM_CASES = {
    "dp2": ("dp=2", "dot", 0),
    "sp2-ring": ("sp=2", "ring", 8),
    "sp2-ulysses": ("sp=2", "ulysses", 0),
    "dp2-sp2-ring": ("dp=2,sp=2", "ring", 0),
}


def _op_inputs(name):
    shape, kvh, seed, *_ = OPS[name]
    rng = np.random.default_rng(seed)
    b, s, h, d = shape
    q = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(b, s, kvh, d)) * 0.5).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    return q, k, v


def _lm_tokens():
    return np.random.default_rng(7).integers(
        1, LM_CFG["vocab_size"], size=(LM_BATCH, 32)).astype(np.int32)


_RANK = textwrap.dedent("""
    import datetime, os, pickle, sys
    sys.path.insert(0, @REPO@)
    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from learningorchestra_tpu_torch.models import transformer as tlm
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.parallel import ring, ulysses
    from learningorchestra_tpu_torch.runtime import data
    from learningorchestra_tpu_torch.runtime import distributed as dist
    from learningorchestra_tpu_torch.runtime import mesh as mesh_lib

    rank = int(sys.argv[1])
    with open(@INPUTS@, "rb") as f:
        inputs = pickle.load(f)
    assert dist.initialize("127.0.0.1:@PORT@", @WORLD@, rank, device="cpu",
                           timeout=datetime.timedelta(seconds=120))
    out = {}
    for name, (q, k, v, causal, window, impl, grads) in inputs["ops"].items():
        n = @WORLD@
        mesh = mesh_lib.build_mesh("sp=%d" % n)
        cols = slice(rank * q.shape[1] // n, (rank + 1) * q.shape[1] // n)
        ql, kl, vl = (torch.from_numpy(np.ascontiguousarray(t[:, cols]))
                      .requires_grad_(grads) for t in (q, k, v))
        if impl == "ulysses":
            o = ulysses.ulysses_attention_sharded(
                ql, kl, vl, mesh, causal=causal, window=window)
        else:
            o = ring.ring_attention_sharded(
                ql, kl, vl, mesh, causal=causal, window=window,
                block_impl=impl)
        res = {"o": o.detach().numpy()}
        if grads:
            (o ** 2).sum().backward()
            res.update(dq=ql.grad.numpy(), dk=kl.grad.numpy(),
                       dv=vl.grad.numpy())
        out[name] = res
    tree = inputs["tree"]
    x = inputs["tokens"]
    for name, (spec, attention, chunk) in inputs["lm"].items():
        mesh = mesh_lib.build_mesh(spec)
        if mesh.coords(rank) is None:  # a mesh smaller than the world
            mesh.form_groups()
            continue
        lm = tlm.LanguageModel(**inputs["cfg"], attention=attention,
                               head_chunk=chunk, device="cpu")
        lm.set_params(weights.params_from_flax(tree))
        lm._mesh_override = mesh
        eng = lm._get_engine()
        state = eng.init_state(lm._master_params())
        shard, columns = lm._plan(x.shape[1])
        grads, metrics = eng.sharded_grads(
            state, {"x": x, data.MASK_KEY: np.ones(len(x), np.float32)},
            0, shard, columns)
        loss = float(metrics["loss"][0] / metrics["loss"][1])
        out["lm-" + name] = {
            "loss": loss, "seqParallel": shard.seq_size > 1,
            "grads": weights.params_to_flax(
                {k: g.detach() for k, g in grads.items()})}
    out["hostInfo"] = dist.host_info("cpu")
    dist.barrier()
    dist.shutdown()
    with open(os.path.join(@OUT@, "rank%d.pkl" % rank), "wb") as f:
        pickle.dump(out, f)
    print("RANK_OK", rank, flush=True)
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on four gloo CPU ranks: ``[rank 0's results, ...]``."""
    tmp = tmp_path_factory.mktemp("ranks")
    inputs = {
        "ops": {name: (*_op_inputs(name), *OPS[name][3:])
                for name in OPS},
        "lm": LM_CASES, "cfg": LM_CFG,
        "tree": weights.init_params(LM_CFG, seed=0),
        "tokens": _lm_tokens()}
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
    return results


def _joined(ranks, name, key):
    return np.concatenate([r[name][key] for r in ranks], axis=1)


def _jax_op(name):
    """(out, grads or None) of the JAX package's sharded op at sp=4."""
    _, kvh, _, causal, window, impl, grads = OPS[name]
    q, k, v = (jnp.asarray(t) for t in _op_inputs(name))
    mesh = jax_mesh.build_mesh("sp=4", devices=jax.devices()[:4])

    def run(q, k, v):
        if impl == "ulysses":
            return jax_ulysses.ulysses_attention_sharded(
                q, k, v, mesh, causal=causal, window=window)
        return jax_ring.ring_attention_sharded(
            q, k, v, mesh, causal=causal, window=window, block_impl=impl)

    out = run(q, k, v)
    if not grads:
        return np.asarray(out), None
    g = jax.grad(lambda a, b, c: jnp.sum(run(a, b, c) ** 2),
                 argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(t) for t in g]


@pytest.mark.parametrize("name", list(OPS))
def test_sharded_attention_matches_jax(ranks, name):
    want, want_grads = _jax_op(name)
    np.testing.assert_allclose(_joined(ranks, name, "o"), want, **VALUE_TOL)
    if want_grads is not None:
        for key, g in zip(("dq", "dk", "dv"), want_grads):
            np.testing.assert_allclose(_joined(ranks, name, key), g,
                                       **GRAD_TOL)


def _jax_lm_step(spec, attention, chunk):
    n = int(np.prod(list(jax_mesh.parse_mesh_spec(spec).values())))
    mesh = jax_mesh.build_mesh(spec, devices=jax.devices()[:n])
    tree = weights.init_params(LM_CFG, seed=0)
    lm = jax_tlm.LanguageModel(**LM_CFG, attention=attention,
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


@pytest.mark.parametrize("name", list(LM_CASES))
def test_sharded_lm_first_step_matches_jax(ranks, name):
    spec, attention, chunk = LM_CASES[name]
    want_loss, want_grads = _jax_lm_step(spec, attention, chunk)
    got = ranks[0]["lm-" + name]
    assert got["seqParallel"] == ("sp=" in spec)
    # every rank of the mesh ends the step with the same loss and
    # gradients
    n = int(np.prod(list(jax_mesh.parse_mesh_spec(spec).values())))
    for other in ranks[1:n]:
        assert other["lm-" + name]["loss"] == got["loss"]
    np.testing.assert_allclose(got["loss"], want_loss, **VALUE_TOL)
    flat_got = jax.tree_util.tree_leaves(got["grads"])
    flat_want = jax.tree_util.tree_leaves(want_grads)
    assert jax.tree_util.tree_structure(got["grads"]) == \
        jax.tree_util.tree_structure(want_grads)
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **GRAD_TOL)


def test_ranks_report_the_gloo_topology(ranks):
    for r, result in enumerate(ranks):
        info = result["hostInfo"]
        assert info["processIndex"] == r
        assert info["processCount"] == info["globalDevices"] == WORLD
        assert info["localDevices"] == 1
        assert (info["backend"], info["platform"]) == ("gloo", "cpu")
        # CPU tensors never cross through host staging
        assert info["stagedBytes"] == {"toHost": 0, "toDevice": 0}
