"""The LanguageModel's options of the PyTorch port against the JAX
package's: mixture of experts, fused projections, remat, beam search,
the ``LO_*`` overrides, their weights and their serving.

One random flax-layout tree (``init_params``, numpy seed) drives both
packages. The model is small (vocab 64, d_model 32, 2 layers, 4 heads
over 2 kv heads, windows of 32 tokens, sliding window 16; 4 experts,
k 2 where MoE is on). Both compute in float32 unless bf16 is the point.

Tolerances, float32: logits to atol 2e-5 (``tests/test_ops.py``); the
MoE LM's loss to rtol 1e-5 and its gradients to atol 1e-6 plus rtol
1e-5, as ``tests/test_torch_training.py`` holds the dense LM's; a fit's
losses to rtol 1e-5. After 4 AdamW steps an MoE param may differ by up
to 1e-4: AdamW divides each step by the gradient's running scale, so an
element whose gradient terms nearly cancel (a summation-order matter
between XLA's einsums and torch's products) moves by up to the learning
rate either way (measured 1.02e-5). Remat is held to no remat bit for
bit (the recompute replays the same operations and dropout masks).
Beam search and serving tokens, and int8/fp8 serving weights, are
equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.catalog import ArtifactStore as JaxArtifactStore
from learningorchestra_tpu.models import transformer as jax_tlm
from learningorchestra_tpu_torch.catalog import ArtifactStore
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import transformer as tlm
from learningorchestra_tpu_torch.models import weights
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           max_len=32, sliding_window=16)
MOE = dict(CFG, n_experts=4, moe_k=2)
SEQ = 32

OPTIONS = {
    "moe": MOE,
    "fused gqa": dict(CFG, fused_proj=True),
    "fused mha": dict(CFG, n_kv_heads=0, fused_proj=True),
    "moe fused": dict(MOE, fused_proj=True),
}


@pytest.fixture()
def float32(monkeypatch):
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    jax_config.reset_config()
    yield
    jax_config.reset_config()


def _stream(n: int, seed: int = 0) -> np.ndarray:
    """``n`` windows of the cyclic successor stream (t -> t % 63 + 1)."""
    start = np.random.default_rng(seed).integers(1, 64, size=n)
    return ((start[:, None] + np.arange(SEQ)[None, :]) % 63 + 1) \
        .astype(np.int32)


def _jax_lm(tree, config, **kwargs):
    lm = jax_tlm.LanguageModel(**{**config, **kwargs})
    lm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    return lm


def _port_lm(tree, config, **kwargs):
    lm = tlm.LanguageModel(**{**config, **kwargs}, device="cpu")
    lm.set_params(weights.params_from_flax(tree))
    return lm


def _assert_trees_close(got, want, **tol):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# ----------------------------------------------------------------------
# the module: MoE and fused projections against JAX
# ----------------------------------------------------------------------
@pytest.mark.parametrize("option", list(OPTIONS))
def test_logits_and_tree_match_jax(option, float32):
    """The JAX module initialized from scratch has the tree layout of
    ``init_params``, and the port's logits equal JAX's on one tree."""
    config = OPTIONS[option]
    tree = weights.init_params(config, seed=1)
    jlm = _jax_lm(tree, config, attention="dot")
    flax_tree = jlm.module.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, flax_tree)) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(flax_tree),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape
    lm = _port_lm(tree, config, attention="flash")
    x = _stream(8, seed=2)
    np.testing.assert_allclose(lm.predict(x, batch_size=8),
                               jlm.predict(x, batch_size=8), atol=2e-5,
                               rtol=0)


def test_moe_fit_matches_jax(float32):
    """2 epochs of 2 AdamW steps of the MoE LM from one tree: the
    losses (with the load-balance term), accuracy and final params."""
    tree = weights.init_params(MOE, seed=3)
    x = _stream(32, seed=10)
    jlm = _jax_lm(tree, MOE, attention="dot")
    want = jlm.fit(x, batch_size=16, epochs=2, shuffle=False).history
    lm = _port_lm(tree, MOE, attention="flash")
    got = lm.fit(x, batch_size=16, epochs=2, shuffle=False).history
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    assert got["loss"][1] < got["loss"][0]
    _assert_trees_close(weights.params_to_flax(lm.params), jlm.params,
                        atol=1e-4, rtol=0)


@pytest.mark.parametrize("head_chunk", [0, 8])
def test_moe_loss_and_gradients_match_jax(float32, head_chunk):
    """One training forward of the MoE LM (aux in the loss, capacity
    binding at 4 experts): the loss and every gradient, router and
    experts included, on the full-logits and the chunked lm-head path."""
    tree = weights.init_params(MOE, seed=28)
    x = _stream(6, seed=29)
    jlm = _jax_lm(tree, MOE, attention="dot")
    module = jlm.module.clone(fused_head_chunk=head_chunk)
    loss_fn = jax_tlm.next_token_loss(0.01, head_chunk=head_chunk or 1024)

    def jax_loss(params):
        out = module.apply({"params": params}, jnp.asarray(x), train=True)
        res = loss_fn(out, {"x": jnp.asarray(x)}, None)
        return res[0] if isinstance(res, tuple) else res

    want_loss, want_grads = jax.value_and_grad(jax_loss)(jlm.params)
    lm = _port_lm(tree, MOE, attention="flash", head_chunk=head_chunk)
    params = dict(lm.module.named_parameters())
    batch = {"x": torch.from_numpy(x)}
    res = tlm.next_token_loss(0.01, head_chunk=head_chunk or 1024)(
        lm._apply_fn(params, batch, True, None), batch, None)
    loss = res[0] if isinstance(res, tuple) else res
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_trees_close(weights.params_to_flax(dict(zip(params, grads))),
                        want_grads, atol=1e-6, rtol=1e-5)


def test_moe_aux_term_reaches_the_loss(float32):
    """The summed load-balance loss enters the loss as ``aux_coef ·
    aux``: on the full-logits and the chunked lm-head paths alike, and
    as JAX's (logits, aux) gives it."""
    tree = weights.init_params(MOE, seed=4)
    x = torch.from_numpy(_stream(4, seed=5)).long()
    lm = _port_lm(tree, MOE, attention="dot")
    with torch.no_grad():
        logits, aux = lm.module(x, return_aux=True)
        fused = lm.module(x, train=True, fused_head=True)
    jlogits, jaux = _jax_lm(tree, MOE, attention="dot").module.apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, tree)},
        jnp.asarray(x.numpy()))
    assert float(aux) > 0
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    assert float(fused.aux) == float(aux)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=0)
    batch = {"x": x}
    for chunk in (0, 16):
        out = fused if chunk else (logits, aux)
        with torch.no_grad():
            res = tlm.next_token_loss(0.5, head_chunk=chunk or 1024)(
                out, batch, None)
            base = tlm.next_token_loss(0.0, head_chunk=chunk or 1024)(
                out, batch, None)
        loss = res[0] if isinstance(res, tuple) else res
        base = base[0] if isinstance(base, tuple) else base
        assert float(loss - base) == pytest.approx(0.5 * float(aux),
                                                   rel=1e-5)


def test_fused_proj_matches_unfused_math(float32):
    """Splitting a split tree's q/k/v and gate/up kernels into the
    fused layout gives the split model's logits, in both packages (the
    JAX package's own test builds the fused tree the same way)."""
    config = dict(CFG, n_kv_heads=0)
    tree = weights.init_params(config, seed=6)
    fused = {k: v for k, v in tree.items()}
    for name, layer in tree.items():
        if not name.startswith("layer_"):
            continue
        attn = dict(layer["attn"])
        attn["qkv_proj"] = {"kernel": np.concatenate(
            [attn.pop(p)["kernel"] for p in ("q_proj", "k_proj", "v_proj")],
            axis=1)}
        mlp = dict(layer["mlp"])
        mlp["gate_up"] = {"kernel": np.concatenate(
            [mlp.pop("gate")["kernel"], mlp.pop("up_proj")["kernel"]],
            axis=1)}
        fused[name] = dict(layer, attn=attn, mlp=mlp)
    x = _stream(8, seed=7)
    split_logits = _port_lm(tree, config).predict(x, batch_size=8)
    port_fused = _port_lm(fused, config, fused_proj=True)
    np.testing.assert_allclose(port_fused.predict(x, batch_size=8),
                               split_logits, atol=1e-5, rtol=0)
    jax_fused = _jax_lm(fused, config, fused_proj=True, attention="dot")
    np.testing.assert_allclose(jax_fused.predict(x, batch_size=8),
                               split_logits, atol=2e-5, rtol=0)


def test_fused_proj_gqa_keeps_only_mlp_fusion():
    lm = tlm.LanguageModel(**CFG, fused_proj=True, device="cpu")
    keys = set(lm._new_module().state_dict())
    assert "layer_0.attn.q_proj.weight" in keys
    assert not any("qkv_proj" in k for k in keys)
    assert "layer_0.mlp.gate_up.weight" in keys
    mha = tlm.LanguageModel(**dict(CFG, n_kv_heads=4), fused_proj=True,
                            device="cpu")
    assert "layer_0.attn.qkv_proj.weight" in mha._new_module().state_dict()


def test_fused_qkv_hands_the_kernels_contiguous_rows(monkeypatch):
    """q, k and v sliced from the fused product reach flash attention
    contiguous, as the card's kernels require (the CPU's plain version
    would take any strides)."""
    from learningorchestra_tpu_torch.ops import attention as attn_ops

    config = dict(CFG, n_kv_heads=0, fused_proj=True, attention="flash")
    lm = _port_lm(weights.init_params(config, seed=30), config)
    seen = []
    flash = attn_ops.flash_attention
    monkeypatch.setattr(attn_ops, "flash_attention", lambda q, k, v, **kw: (
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        or flash(q, k, v, **kw)))
    lm.predict(_stream(2, seed=31), batch_size=2)
    assert seen == [True] * CFG["n_layers"]


def test_fused_proj_changes_nothing_on_the_gqa_moe_lm(float32):
    """Under GQA the attention does not fuse, and an MoE block has no
    MLP: the tree, the logits and a fit step are the unfused model's."""
    tree = weights.init_params(MOE, seed=8)
    assert weights.init_params(dict(MOE, fused_proj=True), seed=8).keys() \
        == tree.keys()
    x = _stream(16, seed=9)
    plain, fused = (_port_lm(tree, MOE, fused_proj=f) for f in (False, True))
    assert set(plain.params) == set(fused.params)
    np.testing.assert_array_equal(plain.predict(x, batch_size=8),
                                  fused.predict(x, batch_size=8))
    want = plain.fit(x, batch_size=16, epochs=1, shuffle=False).history
    got = fused.fit(x, batch_size=16, epochs=1, shuffle=False).history
    assert got["loss"] == want["loss"]


def test_fused_proj_env_override_is_strict(monkeypatch):
    """``LO_TLM_FUSED_PROJ`` as the JAX package reads it: 0/1 words
    override, empty takes the constructor's value, anything else
    raises in both packages."""
    lm = tlm.LanguageModel(**CFG, fused_proj=True, device="cpu")
    jlm = jax_tlm.LanguageModel(**CFG, fused_proj=True)
    for env, want in (("0", False), ("no", False), ("TRUE", True),
                      ("", True)):
        monkeypatch.setenv("LO_TLM_FUSED_PROJ", env)
        assert lm._resolved_fused_proj() is want
        assert jlm._resolved_fused_proj() is want
    monkeypatch.setenv("LO_TLM_FUSED_PROJ", "on")
    for model in (lm, jlm):
        with pytest.raises(ValueError, match="LO_TLM_FUSED_PROJ"):
            model._resolved_fused_proj()
    monkeypatch.setenv("LO_TLM_FUSED_PROJ", "0")
    assert not any("gate_up" in k for k in lm._new_module().state_dict())


def test_head_chunk_and_remat_env_overrides(monkeypatch):
    lm = tlm.LanguageModel(**dict(CFG, vocab_size=9000), head_chunk=64,
                           remat="dots", device="cpu")
    jlm = jax_tlm.LanguageModel(**dict(CFG, vocab_size=9000), head_chunk=64,
                                remat="dots")
    for model in (lm, jlm):
        assert model._head_chunk() == 64 and model._resolved_remat() == "dots"
    monkeypatch.setenv("LO_LM_HEAD_CHUNK", "0")
    monkeypatch.setenv("LO_TLM_REMAT", "full")
    for model in (lm, jlm):
        assert model._head_chunk() == 0 and model._resolved_remat() == "full"
    monkeypatch.setenv("LO_TLM_REMAT", "some")
    for model in (lm, jlm):
        with pytest.raises(ValueError, match="unknown remat policy"):
            model._resolved_remat()


# ----------------------------------------------------------------------
# remat
# ----------------------------------------------------------------------
def _micro_grads(lm, x, seed=1234):
    eng = lm._get_engine()
    grads, metrics = eng._micro_grads(lm._master_params(),
                                      {"x": torch.from_numpy(x).long()},
                                      seed)
    return grads, float(metrics["loss"][0])


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", ["dense", "moe"])
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gradients_equal_no_remat_with_dropout(monkeypatch, remat,
                                                     config, compute):
    """Under dropout 0.1 the recompute replays each block's masks and
    runs on the step's compute-dtype weights: the loss and every
    gradient are the no-remat step's, bit for bit, and the flash
    forward runs twice per layer."""
    from learningorchestra_tpu_torch.ops import attention as attn_ops

    monkeypatch.setenv("LO_COMPUTE_DTYPE", compute)
    base = dict(MOE if config == "moe" else CFG, dropout=0.1,
                attention="flash")
    tree = weights.init_params(base, seed=11)
    x = _stream(8, seed=12)
    calls = []
    forward = attn_ops._FlashAttention.forward
    monkeypatch.setattr(attn_ops._FlashAttention, "forward", staticmethod(
        lambda *a, **k: calls.append(1) or forward(*a, **k)))
    want, want_loss = _micro_grads(_port_lm(tree, base), x)
    plain_calls = len(calls)
    got, got_loss = _micro_grads(_port_lm(tree, base, remat=remat), x)
    assert plain_calls == base["n_layers"]
    assert len(calls) - plain_calls == 2 * base["n_layers"]
    assert got_loss == want_loss
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_remat_is_never_applied_outside_training(float32, monkeypatch):
    """Evaluate, predict and generate of a remat model run one forward
    per layer (remat wraps the training forward only)."""
    from learningorchestra_tpu_torch.ops import attention as attn_ops

    tree = weights.init_params(CFG, seed=15)
    lm = _port_lm(tree, CFG, remat="full", attention="flash")
    plain = _port_lm(tree, CFG, attention="flash")
    x = _stream(8, seed=16)
    calls = []
    forward = attn_ops._FlashAttention.forward
    monkeypatch.setattr(attn_ops._FlashAttention, "forward", staticmethod(
        lambda *a, **k: calls.append(1) or forward(*a, **k)))
    assert lm.evaluate(x, batch_size=8) == plain.evaluate(x, batch_size=8)
    assert len(calls) == 2 * CFG["n_layers"]
    np.testing.assert_array_equal(lm.generate(x[:2, :8], max_new_tokens=4),
                                  plain.generate(x[:2, :8],
                                                 max_new_tokens=4))


# ----------------------------------------------------------------------
# beam search
# ----------------------------------------------------------------------
def _seq_logprob(lm, seq, prompt_len):
    """The model's summed log-prob of ``seq``'s continuation, token 0
    masked (the JAX package's ``_seq_logprob``)."""
    logits = torch.from_numpy(lm.predict(seq[None], batch_size=1)[0])
    logits[..., 0] = tlm.NEG_INF
    lp = torch.log_softmax(logits.double(), dim=-1)
    return float(sum(lp[pos - 1, seq[pos]] for pos in
                     range(prompt_len, len(seq))))


@pytest.mark.parametrize("config", ["dense", "moe"])
def test_beam_search_tokens_match_jax(config, float32):
    conf = dict(MOE if config == "moe" else CFG, max_len=24)
    tree = weights.init_params(conf, seed=17)
    x = _stream(16, seed=18)
    lm, jlm = _port_lm(tree, conf), _jax_lm(tree, conf, attention="dot")
    prompt = x[:2, :6]
    greedy = lm.generate(prompt, max_new_tokens=8)
    np.testing.assert_array_equal(lm.generate(prompt, max_new_tokens=8,
                                              num_beams=1), greedy)
    for beams in (2, 4):
        got = lm.generate(prompt, max_new_tokens=8, num_beams=beams)
        want = jlm.generate(prompt, max_new_tokens=8, num_beams=beams)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert (got[:, :6] == prompt).all() and (got > 0).all()


def test_beam_search_full_width_is_exhaustive(float32):
    """A beam as wide as the non-pad vocabulary over a 2-token horizon is
    exhaustive: its result is the argmax continuation of the model's own
    log-probs (the JAX package's oracle test)."""
    vocab = 12
    conf = dict(CFG, vocab_size=vocab, max_len=16)
    tree = weights.init_params(conf, seed=19)
    lm = _port_lm(tree, conf)
    prompt = (np.arange(8).reshape(2, 4) % (vocab - 1) + 1).astype(np.int32)
    full = lm.generate(prompt, max_new_tokens=2, num_beams=vocab - 1)
    for i in range(2):
        best = max(((t1, t2) for t1 in range(1, vocab)
                    for t2 in range(1, vocab)),
                   key=lambda c: _seq_logprob(
                       lm, np.concatenate([prompt[i], c]), 4))
        np.testing.assert_array_equal(full[i, 4:], best)


def test_beam_search_refusals_match_jax():
    lm = _port_lm(weights.init_params(CFG, seed=20), CFG)
    jlm = jax_tlm.LanguageModel(**CFG)
    jlm.params = jax.tree_util.tree_map(
        jnp.asarray, weights.init_params(CFG, seed=20))
    prompt = _stream(1, seed=21)[:, :4]
    for kwargs, match in (({"temperature": 0.8}, "beam search is "
                                                 "deterministic"),
                          ({"top_k": 5}, "top_k/top_p"),
                          ({"top_p": 0.9}, "top_k/top_p"),
                          ({"num_beams": 64}, "exceeds the 63 non-pad")):
        for model in (lm, jlm):
            with pytest.raises(ValueError, match=match):
                model.generate(prompt, max_new_tokens=2,
                               **{"num_beams": 2, **kwargs})
    for model in (lm, jlm):
        with pytest.raises(ValueError, match="equal-length prompts"):
            model.generate([[1, 2, 3], [4, 5]], max_new_tokens=2,
                           num_beams=2)


# ----------------------------------------------------------------------
# weights and artifacts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("option", list(OPTIONS))
def test_weights_round_trip(option):
    config = OPTIONS[option]
    tree = weights.init_params(config, seed=22)
    state = weights.params_from_flax(tree)
    if config.get("n_experts"):
        assert state["layer_0.moe.gate"].shape == (32, 4)
        assert state["layer_0.moe.experts.wi"].shape == (4, 32, 128)
        np.testing.assert_array_equal(state["layer_0.moe.experts.wo"],
                                      tree["layer_0"]["moe"]["experts"]["wo"])
        assert weights.flax_path("layer_0.moe.gate") == \
            (("layer_0", "moe", "gate"), False)
    else:
        assert weights.flax_path("layer_0.mlp.gate_up.weight") == \
            (("layer_0", "mlp", "gate_up", "kernel"), True)
    back = weights.params_to_flax(state)
    _assert_trees_close(back, tree, atol=0, rtol=0)
    lm = tlm.LanguageModel(**config, device="cpu")
    assert set(lm._new_module().state_dict()) == set(state)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_artifacts_cross_packages(tmp_path, float32, option):
    """A JAX-written artifact of each option loads in the port with
    JAX's logits, and the port's loads in the JAX package."""
    config = dict(OPTIONS[option], attention="dot")
    tree = weights.init_params(config, seed=23)
    jlm = _jax_lm(tree, config)
    JaxArtifactStore(str(tmp_path / "j")).save(jlm, "m", "train/tensorflow")
    loaded = ArtifactStore(str(tmp_path / "j"), device="cpu").load(
        "m", "train/tensorflow")
    x = _stream(8, seed=24)
    np.testing.assert_allclose(loaded.predict(x, batch_size=8),
                               jlm.predict(x, batch_size=8), atol=2e-5,
                               rtol=0)
    d = ArtifactStore(str(tmp_path / "p"), device="cpu").save(
        loaded, "m", "train/tensorflow")
    back = jax_tlm.LanguageModel.__lo_load__(os.path.join(d, "native"))
    _assert_trees_close(back.params, jlm.params, atol=0, rtol=0)
    assert (back.n_experts, back.fused_proj) == (
        config.get("n_experts", 0), config.get("fused_proj", False))


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_serving_weights_leave_moe_exact_as_jax(dtype):
    """``quantize_serving_params`` narrows only kernel/embedding leaves:
    the MoE router and experts stay exact, and every leaf equals the
    JAX package's bit for bit (the fused kernels per output channel)."""
    config = dict(MOE, fused_proj=True)
    tree = weights.init_params(config, seed=25)
    want = jax_tlm.quantize_serving_params(
        jax.tree_util.tree_map(jnp.asarray, tree), dtype)
    got = weights.params_to_flax(
        tlm.quantize_serving_params(weights.params_from_flax(tree), dtype),
        leaf=lambda v, transposed: (v, transposed))
    moe = got["layer_0"]["moe"]
    for value, _ in (moe["gate"], moe["experts"]["wi"],
                     moe["experts"]["wo"]):
        assert isinstance(value, torch.Tensor) and \
            value.dtype == torch.float32
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        node = got
        for key in keys[:-1]:
            node = node[key]
        value, transposed = node[keys[-1]]
        if isinstance(value, dict):
            q = value["qvalue"].T if transposed else value["qvalue"]
            jq = np.asarray(flat_want[path + (jax.tree_util.DictKey(
                "qvalue"),)])
            np.testing.assert_array_equal(
                q.float().numpy(), jq.astype(np.float32), err_msg=str(keys))
            scale = value["qscale"].reshape(-1).numpy()
            np.testing.assert_array_equal(scale, np.asarray(flat_want[
                path + (jax.tree_util.DictKey("qscale"),)]).reshape(-1))
        else:
            assert keys[-1] in ("scale", "gate", "wi", "wo"), keys
            np.testing.assert_array_equal(value.numpy(), leaf)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kv", ["slot", "paged"])
def test_moe_session_tokens_match_the_jax_session(tmp_path, kv):
    """Sequential greedy requests on a 4-slot MoE session: with E 8 and k
    2 the step's capacity is 1 copy an expert, so the idle lanes' stale
    tokens compete with the live stream (and the stream's tokens need
    not equal a solo ``generate``'s, in the JAX package either). The
    port keeps every lane as the JAX session does: the tokens are the
    JAX session's."""
    config = dict(CFG, max_len=64, n_experts=8, moe_k=2)
    tree = weights.init_params(config, seed=26)
    rng = np.random.default_rng(27)
    specs = [([int(t) for t in rng.integers(1, 64, size=n)], 8)
             for n in (9, 17, 12, 30)]
    body = {"maxSlots": 4, "cacheLen": 64, "temperature": 0.0}
    if kv == "paged":
        body.update(kv="paged", pageLen=8)

    def run(api):
        status, resp, _ = api.dispatch("POST", PREFIX + "/serve/m", {},
                                       body)
        assert status == 201, resp
        out = []
        for prompt, new in specs:
            status, got, _ = api.dispatch(
                "POST", PREFIX + "/serve/m/predict", {},
                {"prompt": prompt, "maxNewTokens": new})
            assert status == 200, got
            out.append(got["tokens"])
        api.ctx.close()
        return out

    ctx = ServiceContext(Config(home=str(tmp_path / "port")), device="cpu")
    ctx.artifacts.save(_port_lm(tree, config), "m", "train/tensorflow")
    got = run(Api(ctx))
    jax_config.set_config(jax_config.Config(
        home=str(tmp_path / "jax"), compute_dtype="float32",
        serve_max_wait_ms=1.0))
    try:
        from learningorchestra_tpu.services.server import Api as JaxApi

        japi = JaxApi()
        japi.ctx.artifacts.save(_jax_lm(tree, config, attention="dot"), "m",
                                "train/tensorflow")
        want = run(japi)
    finally:
        jax_config.reset_config()
    assert got == want
