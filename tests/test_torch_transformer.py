"""The PyTorch port's language model against the JAX package's.

One random flax-layout tree (``init_params``, numpy seed) drives both
models: the JAX ``LanguageModel`` takes it as its params, the port takes
it through ``params_from_flax``. The model is small (2 layers, d_model
64, 4 heads over 2 kv heads, window 16, vocab 97) so the prompts of 40
tokens make the window bind. Logits are held to atol 1e-4 in float32
(two frameworks summing in different orders over 2 layers); greedy
tokens must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.models import transformer as jax_tlm
from learningorchestra_tpu.models.transformer import \
    LanguageModel as JaxLanguageModel
from learningorchestra_tpu_torch.catalog import ArtifactStore
from learningorchestra_tpu_torch.models import transformer as tlm
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.models.transformer import LanguageModel
from learningorchestra_tpu_torch.runtime import data as data_lib

# tiny shapes: two intra-op threads are as fast as all cores and leave
# the rest to the other test workers
torch.set_num_threads(2)

CFG = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           max_len=64, sliding_window=16)


@pytest.fixture(scope="module")
def tree():
    return weights.init_params(CFG, seed=0)


@pytest.fixture(scope="module")
def jax_lm(tree):
    lm = JaxLanguageModel(**CFG, attention="dot")
    lm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    return lm


def _port(tree, attention="flash"):
    lm = LanguageModel(**CFG, attention=attention, device="cpu")
    lm.set_params(weights.params_from_flax(tree))
    return lm


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        1, CFG["vocab_size"], size=shape).astype(np.int32)


def test_init_params_has_the_flax_tree(tree):
    lm = JaxLanguageModel(**CFG, attention="dot")
    lm._build_params(np.zeros((1, 8), np.int32))
    shapes = jax.tree_util.tree_map(lambda a: a.shape, lm.params)
    assert jax.tree_util.tree_map(lambda a: a.shape, tree) == shapes


def test_flax_round_trip_is_exact(tree):
    back = weights.params_to_flax(weights.params_from_flax(tree))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("attention", ["dot", "flash", "ring", "ulysses"])
def test_logits_match_jax(tree, jax_lm, attention):
    tokens = _tokens(1, (2, 40))
    want, _ = jax_lm.module.apply({"params": jax_lm.params},
                                  jnp.asarray(tokens), train=False)
    lm = _port(tree, attention)
    got = lm.module(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("attention", ["flash", "ring", "ulysses"])
def test_unsharded_attention_runs_the_flash_kernel(tree, attention,
                                                   monkeypatch):
    """Where no step shard splits the sequence (an evaluate, a predict, a
    one-rank or data-parallel fit), ring and Ulysses run the flash
    kernel's wrapper over the whole sequence as flash does, never the
    dense reference: on a CUDA tensor that wrapper launches the kernel."""
    real = tlm.attn_ops.flash_attention
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    def dense(*args, **kwargs):
        raise AssertionError("the dense reference ran")

    monkeypatch.setattr(tlm.attn_ops, "flash_attention", spy)
    monkeypatch.setattr(tlm.attn_ops, "full_attention_reference", dense)
    lm = _port(tree, attention)
    lm.module(torch.from_numpy(_tokens(1, (2, 40))).long())
    assert len(calls) == CFG["n_layers"]


def test_rope_and_norm_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 4, 16), dtype=np.float32)
    jc, js = jax_tlm.rope_tables(12, 16, offset=3)
    tc, ts = tlm.rope_tables(12, 16, offset=3)
    want = jax_tlm.apply_rope(jnp.asarray(x), jc, js)
    got = tlm.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    import flax.linen as nn

    h = rng.standard_normal((3, 64), dtype=np.float32)
    ref = nn.RMSNorm().apply({"params": {"scale": np.full(64, 1.5,
                                                          np.float32)}},
                             jnp.asarray(h))
    norm = tlm.RMSNorm(64)
    with torch.no_grad():
        norm.scale.fill_(1.5)
    np.testing.assert_allclose(norm(torch.from_numpy(h)).detach().numpy(),
                               np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_greedy_generate_matches_jax(tree, jax_lm):
    prompt = _tokens(3, (1, 40))
    want = jax_lm.generate(prompt, max_new_tokens=12)
    got = _port(tree).generate(prompt, max_new_tokens=12)
    np.testing.assert_array_equal(got, want)


def test_left_padded_generate_matches_jax(tree, jax_lm):
    rows = [list(_tokens(4, (10,))), list(_tokens(5, (22,)))]
    want = jax_lm.generate(rows, max_new_tokens=6)
    got = _port(tree).generate(rows, max_new_tokens=6)
    np.testing.assert_array_equal(got, want)


def test_cached_decode_matches_full_forward(tree):
    """Every generated token is the argmax (pad id 0 excluded) of the
    full forward over the finished sequence: the incremental cache, the
    scalar decode branch and the prefill agree."""
    lm = _port(tree)
    out = lm.generate(_tokens(6, (1, 30)), max_new_tokens=10)
    logits = lm.module(torch.from_numpy(out).long()).detach().numpy()
    pred = logits[0, 29:-1, 1:].argmax(-1) + 1
    np.testing.assert_array_equal(pred, out[0, 30:])


def test_per_row_decode_matches_scalar_decode(tree):
    """The slot branch (one position per row) gives the scalar branch's
    logits for a row at the same position."""
    lm = _port(tree)
    tokens = torch.from_numpy(_tokens(7, (1, 20))).long()
    cache_a, cache_b = lm._new_cache(1, 32), lm._new_cache(1, 32)
    with torch.no_grad():
        lm.module(tokens, cache=cache_a)
        lm.module(tokens, cache=cache_b)
        nxt = tokens[:, -1:]
        a = lm.module(nxt, cache=cache_a, decode_pos=20)
        b = lm.module(nxt, cache=cache_b,
                      decode_pos=torch.tensor([20]))
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_sampled_generate_is_seeded(tree):
    lm = _port(tree)
    prompt = _tokens(8, (1, 12))
    a = lm.generate(prompt, 10, temperature=0.8, top_k=12, seed=5)
    b = lm.generate(prompt, 10, temperature=0.8, top_k=12, seed=5)
    c = lm.generate(prompt, 10, temperature=0.8, top_p=0.9, seed=6)
    np.testing.assert_array_equal(a, b)
    assert a.shape == c.shape == (1, 22)
    assert (a[:, 12:] > 0).all() and (c[:, 12:] > 0).all()


def test_filter_logits_matches_jax():
    rng = np.random.default_rng(9)
    last = rng.standard_normal((3, 40), dtype=np.float32)
    for kwargs in ({"top_k": 5}, {"top_p": 0.7}, {"top_k": 9,
                                                   "top_p": 0.5}):
        want = JaxLanguageModel._filter_logits(jnp.asarray(last), 0.7,
                                               **kwargs)
        got = LanguageModel._filter_logits(torch.from_numpy(last), 0.7,
                                           **kwargs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


def test_artifact_round_trip(tree, tmp_path):
    store = ArtifactStore(str(tmp_path / "artifacts"), device="cpu")
    lm = _port(tree)
    store.save(lm, "lm", "train/tensorflow")
    assert store.find("lm") == "train/tensorflow"
    loaded = store.load("lm")
    assert loaded.sliding_window == 16 and loaded.n_kv_heads == 2
    for key, value in lm.params.items():
        torch.testing.assert_close(loaded.params[key], value, atol=0,
                                   rtol=0)


def test_unported_options_raise():
    # ring and Ulysses are ported (parallel/ring.py, parallel/ulysses.py);
    # an unknown implementation still raises
    for impl in ("ring", "ulysses"):
        assert LanguageModel(**CFG, attention=impl,
                             device="cpu")._resolved_attention() == impl
    with pytest.raises(ValueError, match="unknown attention"):
        LanguageModel(**CFG, attention="ring2", device="cpu")
    # LoRA, MoE and fused projections are ported: their options are taken
    assert LanguageModel(**CFG, lora_rank=8, device="cpu").lora_rank == 8
    moe = LanguageModel(**CFG, n_experts=4, moe_k=1, device="cpu")
    assert (moe.n_experts, moe.moe_k) == (4, 1)
    assert "layer_0.moe.gate" in moe._new_module().state_dict()
    fused = LanguageModel(**CFG, fused_proj=True, device="cpu")
    assert "layer_0.mlp.gate_up.weight" in fused._new_module().state_dict()


@pytest.mark.parametrize("d_model,n_heads,want", [(1024, 4, "dot"),
                                                   (256, 4, "flash")])
def test_auto_attention_takes_flash_only_where_a_kernel_does(d_model,
                                                             n_heads, want):
    """``attention="auto"`` gives ``flash`` where a flash kernel takes
    the head_dim (<= 128) and ``dot`` above it (head_dim 256 here), as
    the JAX package runs such a model (its Pallas kernels pad any
    head_dim)."""
    lm = LanguageModel(vocab_size=97, d_model=d_model, n_layers=1,
                       n_heads=n_heads, attention="auto", device="cpu")
    assert lm._resolved_attention() == want


def test_auto_attention_at_head_dim_256_matches_jax():
    """An ``auto`` model with head_dim 256 (2 layers, d_model 256, 1
    head) gives the JAX ``auto`` model's logits from the same weights."""
    cfg = dict(vocab_size=97, d_model=256, n_layers=2, n_heads=1,
               max_len=64)
    tree = weights.init_params(cfg, seed=1)
    jax_lm = JaxLanguageModel(**cfg, attention="auto")
    jax_lm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    lm = LanguageModel(**cfg, attention="auto", device="cpu")
    lm.set_params(weights.params_from_flax(tree))
    assert lm._resolved_attention() == "dot"
    tokens = _tokens(12, (2, 40))
    want, _ = jax_lm.module.apply({"params": jax_lm.params},
                                  jnp.asarray(tokens), train=False)
    got = lm.module(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_head_dim_12_lm_matches_jax():
    """A head_dim-12 LM (d_model 48, 4 heads over 2 kv heads, 2 layers,
    window 16: the head_dim the split-TF32 kernels zero-fill to 16 on the
    card) on ``flash`` against the JAX LM on ``dot``: logits at the
    file's atol 1e-4; loss and every gradient at the training tests'
    float32 tolerances (loss rtol 1e-5; gradients atol 1e-6, rtol
    1e-5), with a padded sample masked out of the loss."""
    cfg = dict(vocab_size=97, d_model=48, n_layers=2, n_heads=4,
               n_kv_heads=2, max_len=64, sliding_window=16)
    tree = weights.init_params(cfg, seed=2)
    jax_lm = JaxLanguageModel(**cfg, attention="dot")
    jax_lm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    lm = LanguageModel(**cfg, attention="flash", device="cpu")
    lm.set_params(weights.params_from_flax(tree))
    x = _tokens(13, (4, 40))
    x[0, 30:] = 0
    mask = np.array([1, 1, 1, 0], np.float32)

    want_logits, _ = jax_lm.module.apply({"params": jax_lm.params},
                                         jnp.asarray(x), train=False)
    got_logits = lm.module(torch.from_numpy(x).long())
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(want_logits), atol=1e-4,
                               rtol=1e-4)

    jax_loss_fn = jax_tlm.next_token_loss(0.01, head_chunk=1024)
    jbatch = {"x": jnp.asarray(x)}

    def jax_loss(params):
        out = jax_lm.module.apply({"params": params}, jbatch["x"],
                                  train=True)
        res = jax_loss_fn(out, jbatch, jnp.asarray(mask))
        return res[0] if isinstance(res, tuple) else res

    want_loss, want_grads = jax.value_and_grad(jax_loss)(jax_lm.params)
    params = dict(lm.module.named_parameters())
    batch = {"x": torch.from_numpy(x),
             data_lib.MASK_KEY: torch.from_numpy(mask)}
    out = lm._apply_fn(params, batch, True, None)
    loss = tlm.next_token_loss(0.01, head_chunk=1024)(
        out, batch, batch[data_lib.MASK_KEY])
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got_tree = weights.params_to_flax(dict(zip(params, grads)))
    assert jax.tree_util.tree_structure(got_tree) == \
        jax.tree_util.tree_structure(want_grads)
    for a, b in zip(jax.tree_util.tree_leaves(got_tree),
                    jax.tree_util.tree_leaves(want_grads)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6,
                                   rtol=1e-5)
