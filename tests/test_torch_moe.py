"""The PyTorch port's mixture-of-experts layer against the JAX package's.

Mirrors the MoE tests of ``tests/test_parallel.py`` (``moe_layer`` on one
device): the same params and inputs, made with numpy from a seed, go
through ``learningorchestra_tpu.parallel.moe`` and
``learningorchestra_tpu_torch.parallel.moe``. Float32 values agree to
atol 2e-5 and gradients to 5e-5 (``tests/test_ops.py``); in bf16 the two
packages agree to one bf16 rounding of the output's scale (stated
below). Routing (which copies are kept, in which slot) is compared
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.parallel import moe as jax_moe
from learningorchestra_tpu_torch.parallel import moe

torch.set_num_threads(2)

ATOL, GRAD_ATOL = 2e-5, 5e-5


def _params(seed, d_model, d_ff, n_experts):
    port = moe.init_moe_params(seed, d_model, d_ff, n_experts)
    return port, jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                        port)


def _x(seed, t, d):
    return np.random.default_rng(seed).standard_normal(
        (t, d), dtype=np.float32)


def _both(params, x, **kw):
    port, jp = params
    out, aux = moe.moe_layer(port, torch.from_numpy(x), **kw)
    jout, jaux = jax_moe.moe_layer(jp, jnp.asarray(x), **kw)
    return (out.numpy(), float(aux)), (np.asarray(jout), float(jaux))


@pytest.mark.parametrize("route", ["sparse", "dense"])
def test_moe_dense_dispatch_exact_when_capacity_ample(route):
    """Capacity >= tokens: every token reaches its top-k experts, so the
    output is the per-token loop, in both packages."""
    d_model, d_ff, n_experts, t = 8, 16, 4, 12
    params = _params(0, d_model, d_ff, n_experts)
    x = _x(2, t, d_model)
    (out, aux), (jout, jaux) = _both(params, x, k=2,
                                     capacity_factor=float(t), route=route)
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=0)
    assert aux == pytest.approx(jaux, abs=1e-6)
    p = {k: v.double().numpy() for k, v in params[0]["experts"].items()}
    gate = params[0]["gate"].double().numpy()
    logits = x.astype(np.float64) @ gate
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :2]
    vals = np.take_along_axis(probs, idx, -1)
    vals /= vals.sum(-1, keepdims=True)

    def gelu(h):
        return 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (h + 0.044715 * h ** 3)))

    want = np.zeros((t, d_model))
    for ti in range(t):
        for c in range(2):
            e = idx[ti, c]
            want[ti] += vals[ti, c] * (gelu(x[ti] @ p["wi"][e]) @ p["wo"][e])
    np.testing.assert_allclose(out, want, atol=2e-4, rtol=2e-4)


def test_moe_capacity_drops_tokens():
    d_model, d_ff, n_experts, t = 8, 16, 2, 32
    params = _params(2, d_model, d_ff, n_experts)
    x = np.ones((t, d_model), np.float32)  # identical tokens, one expert
    (out, _), (jout, _) = _both(params, x, k=1, capacity_factor=0.25)
    kept = np.any(np.abs(out) > 1e-12, axis=-1)
    assert 0 < kept.sum() < t
    # the first `capacity` tokens in token order keep their copy
    np.testing.assert_array_equal(kept, np.any(np.abs(jout) > 1e-12,
                                               axis=-1))
    assert kept[:int(kept.sum())].all()
    stats = {}
    moe.moe_layer(params[0], torch.from_numpy(x), k=1, capacity_factor=0.25,
                  stats=stats)
    assert stats == {"copies": t, "dropped": t - int(kept.sum())}


@pytest.mark.parametrize("k", [1, 2, 3])
def test_moe_sparse_matches_dense_under_capacity_pressure(k):
    """The sort/segment route keeps exactly the dense route's copies
    (choice 0 first, then token order) at every capacity, and both equal
    the JAX package's."""
    d_model, d_ff, n_experts, t = 8, 16, 4, 48
    params = _params(4, d_model, d_ff, n_experts)
    x = _x(5, t, d_model)
    for cf in (0.3, 0.75, 1.25, 4.0):
        (sparse, saux), (jsparse, _) = _both(params, x, k=k,
                                             capacity_factor=cf)
        (dense, daux), (jdense, _) = _both(params, x, k=k,
                                           capacity_factor=cf, route="dense")
        np.testing.assert_allclose(sparse, dense, atol=ATOL, rtol=0,
                                   err_msg=f"cf={cf}")
        np.testing.assert_allclose(sparse, jsparse, atol=ATOL, rtol=0,
                                   err_msg=f"cf={cf}")
        np.testing.assert_allclose(dense, jdense, atol=ATOL, rtol=0,
                                   err_msg=f"cf={cf}")
        assert saux == daux


def test_moe_routing_plan_matches_jax_bit_for_bit():
    """``sparse_route`` gives the JAX plan: tokens, slots, the capacity
    mask and the gate weights, in the same expert-sorted order."""
    t, k, e, capacity = 40, 2, 4, 7
    probs = np.random.default_rng(6).random((t, e)).astype(np.float32)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k].astype(np.int32)
    vals = np.take_along_axis(probs, idx, -1)
    got = moe.sparse_route(torch.from_numpy(idx).long(),
                           torch.from_numpy(vals), e, capacity)
    want = jax_moe.sparse_route(jnp.asarray(idx), jnp.asarray(vals), e,
                                capacity)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_moe_ties_break_to_the_lower_expert_as_lax_top_k():
    """A zero router gives every expert the same probability: the top-k
    picks the lowest expert ids, as ``lax.top_k`` does."""
    d_model, d_ff, n_experts, t = 8, 16, 4, 16
    port, jp = _params(7, d_model, d_ff, n_experts)
    port["gate"] = torch.zeros_like(port["gate"])
    jp = dict(jp, gate=jnp.zeros_like(jp["gate"]))
    x = _x(8, t, d_model)
    idx, vals, _ = moe._topk_renorm(torch.from_numpy(x) @ port["gate"], 2)
    assert (idx.numpy() == [[0, 1]] * t).all()
    (out, aux), (jout, jaux) = _both((port, jp), x, k=2)
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=0)
    assert aux == pytest.approx(jaux, abs=1e-7)


def test_moe_aux_loss_matches_jax():
    d_model, d_ff, n_experts, t = 16, 32, 8, 64
    params = _params(9, d_model, d_ff, n_experts)
    x = _x(10, t, d_model)
    for k in (1, 2):
        (_, aux), (_, jaux) = _both(params, x, k=k)
        assert aux == pytest.approx(jaux, rel=1e-6)
        assert aux > 0


def test_moe_gradients_match_jax():
    """Gradients of x, the router and both expert stacks, through the
    sparse route under capacity pressure, of sum(sin(out)) + aux."""
    d_model, d_ff, n_experts, t = 16, 32, 4, 96
    port, jp = _params(11, d_model, d_ff, n_experts)
    x = _x(12, t, d_model)

    def jloss(p, xx):
        out, aux = jax_moe.moe_layer(p, xx, k=2, capacity_factor=1.0)
        return jnp.sum(jnp.sin(out)) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {"gate": port["gate"].clone().requires_grad_(),
              "wi": port["experts"]["wi"].clone().requires_grad_(),
              "wo": port["experts"]["wo"].clone().requires_grad_()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_layer(
        {"gate": leaves["gate"],
         "experts": {"wi": leaves["wi"], "wo": leaves["wo"]}},
        xt, k=2, capacity_factor=1.0)
    (torch.sin(out).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x),
                               atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(leaves["gate"].grad.numpy(),
                               np.asarray(jg_p["gate"]), atol=GRAD_ATOL,
                               rtol=0)
    for name in ("wi", "wo"):
        np.testing.assert_allclose(leaves[name].grad.numpy(),
                                   np.asarray(jg_p["experts"][name]),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_moe_bf16_within_one_rounding_of_jax():
    """bf16 tokens and weights: the router logits, the expert inputs and
    the GELU'd hidden states are bf16 in both packages and the products
    accumulate in float32. Both round the same float32 values, so they
    differ only where the float32 sums differ in their last bits and a
    rounding lands the other way: the bound is one bf16 ulp (2^-8 of the
    value) of the largest output, and routing is identical."""
    d_model, d_ff, n_experts, t = 32, 64, 8, 128
    port, jp = _params(13, d_model, d_ff, n_experts)
    x = _x(14, t, d_model)
    port16 = jax.tree_util.tree_map(lambda a: a.to(torch.bfloat16), port)
    jp16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    out, aux = moe.moe_layer(port16, xt, k=2)
    jout, jaux = jax_moe.moe_layer(jp16, jnp.asarray(x).astype(jnp.bfloat16),
                                   k=2)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    want = np.asarray(jout.astype(jnp.float32))
    bound = float(np.abs(want).max()) * 2.0 ** -8
    np.testing.assert_allclose(got, want, atol=bound, rtol=0)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-3)


def test_moe_refuses_a_mesh_and_an_unknown_route():
    params = moe.init_moe_params(0, 8, 16, 4)
    x = torch.zeros(4, 8)
    # a mesh is a Mesh or a rank's Shard of one; expert parallelism
    # itself runs (tests/test_torch_model_parallel.py)
    with pytest.raises(ValueError, match="a Mesh or a Shard"):
        moe.moe_layer(params, x, mesh=object())
    with pytest.raises(ValueError, match="unknown MoE route"):
        moe.moe_layer(params, x, route="ragged")
