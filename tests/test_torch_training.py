"""The PyTorch port's training slice against the JAX package's.

One random flax-layout tree (``init_params``, numpy seed) drives both
packages: the JAX ``LanguageModel`` takes it as its params, the port
takes it through ``params_from_flax``. The model is small (vocab 64,
d_model 32, 2 layers, 4 heads over 2 kv heads, windows of 32 tokens,
sliding window 16) and the data is a cyclic-successor stream, so a few
steps move the loss. Both run in float32 (``LO_COMPUTE_DTYPE``) unless
bf16 is the point; the JAX side runs its 8-device CPU test mesh, with
the Pallas kernels in interpret mode where ``attention="flash"``.

Tolerances, float32: losses and gradients agree to summation order
(rtol 1e-5, atol 1e-6 on gradients); params after 4 AdamW steps to 1e-6
(measured ~1e-7). bf16: one epoch's loss to 1e-3 relative (the two
frameworks round the bf16 activations at different places; measured
9e-6).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.catalog import ArtifactStore as JaxArtifactStore
from learningorchestra_tpu.models import neural as jax_neural
from learningorchestra_tpu.models import transformer as jax_tlm
from learningorchestra_tpu.runtime import data as jax_data
from learningorchestra_tpu_torch.catalog import ArtifactStore
from learningorchestra_tpu_torch.models import neural, weights
from learningorchestra_tpu_torch.models import transformer as tlm
from learningorchestra_tpu_torch.runtime import data, engine
from learningorchestra_tpu_torch.runtime.checkpoint import Checkpointer

# tiny shapes: two intra-op threads are as fast as all cores and leave
# the rest to the other test workers
torch.set_num_threads(2)

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           max_len=32, sliding_window=16)
SEQ = 32


@pytest.fixture()
def compute_dtype(monkeypatch):
    """Sets LO_COMPUTE_DTYPE for both packages (each reads it when it
    builds its engine)."""
    def set_dtype(name: str):
        monkeypatch.setenv("LO_COMPUTE_DTYPE", name)
        jax_config.reset_config()

    set_dtype("float32")
    yield set_dtype
    monkeypatch.delenv("LO_COMPUTE_DTYPE")
    jax_config.reset_config()


@pytest.fixture(scope="module")
def tree():
    return weights.init_params(CFG, seed=0)


def _stream(n: int, seed: int = 0) -> np.ndarray:
    """``n`` windows of the cyclic successor stream (t -> t % 63 + 1)."""
    start = np.random.default_rng(seed).integers(1, 64, size=n)
    return ((start[:, None] + np.arange(SEQ)[None, :]) % 63 + 1) \
        .astype(np.int32)


def _jax_lm(tree, **kwargs):
    lm = jax_tlm.LanguageModel(**{**CFG, **kwargs})
    lm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    return lm


def _port_lm(tree, **kwargs):
    lm = tlm.LanguageModel(**{**CFG, **kwargs}, device="cpu")
    lm.set_params(weights.params_from_flax(tree))
    return lm


def _assert_trees_close(got, want, **tol):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# ----------------------------------------------------------------------
# loss and accuracy
# ----------------------------------------------------------------------
@pytest.mark.parametrize("head_chunk", [0, 8])
def test_next_token_loss_and_gradients_match_jax(tree, compute_dtype,
                                                 head_chunk):
    """Full logits (head_chunk 0) and the chunked lm-head loss (chunks
    of 8 tokens): loss, accuracy and every parameter gradient."""
    x = _stream(6, seed=1)
    x[0, 20:] = 0           # padding tokens are masked out of the loss
    mask = np.array([1, 1, 1, 1, 1, 0], np.float32)  # a padded sample
    jax_lm = _jax_lm(tree, attention="dot")
    module = jax_lm.module.clone(fused_head_chunk=head_chunk)
    loss_fn = jax_tlm.next_token_loss(0.01, head_chunk=head_chunk or 1024)
    jbatch = {"x": jnp.asarray(x)}

    def jax_loss(params):
        out = module.apply({"params": params}, jbatch["x"], train=True)
        res = loss_fn(out, jbatch, jnp.asarray(mask))
        return (res[0], res[1]) if isinstance(res, tuple) else (res, out)

    (want_loss, aux), want_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(jax_lm.params)
    if head_chunk:
        want_ok = aux["accuracy"]
    else:
        want_ok = jax_tlm.token_accuracy(aux, jbatch, jnp.asarray(mask))

    lm = _port_lm(tree, attention="flash", head_chunk=head_chunk)
    params = dict(lm.module.named_parameters())
    batch = {"x": torch.from_numpy(x),
             data.MASK_KEY: torch.from_numpy(mask)}
    out = lm._apply_fn(params, batch, True, None)
    assert isinstance(out, tlm.FusedHeadOut) == bool(head_chunk)
    res = tlm.next_token_loss(0.01, head_chunk=head_chunk or 1024)(
        out, batch, batch[data.MASK_KEY])
    loss, got_ok = (res[0], res[1]["accuracy"]) if head_chunk else \
        (res, tlm.token_accuracy(out, batch, batch[data.MASK_KEY]))
    grads = torch.autograd.grad(loss, list(params.values()))

    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose([float(v) for v in got_ok],
                               [float(v) for v in want_ok], rtol=1e-6)
    got_tree = weights.params_to_flax(dict(zip(params, grads)))
    _assert_trees_close(got_tree, want_grads, atol=1e-6, rtol=1e-5)


# ----------------------------------------------------------------------
# optimizers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    {"kind": "adam", "learning_rate": 1e-2, "beta_1": 0.8, "beta_2": 0.99},
    {"kind": "adamw", "learning_rate": 1e-2, "weight_decay": 0.1,
     "beta_1": 0.5},
    {"kind": "sgd", "learning_rate": 0.1},
    {"kind": "sgd", "learning_rate": 0.1, "momentum": 0.9,
     "nesterov": True},
    {"kind": "rmsprop", "learning_rate": 1e-2, "rho": 0.8,
     "momentum": 0.5},
    {"kind": "adagrad", "learning_rate": 0.1},
])
def test_optimizer_steps_match_optax(spec):
    """Five updates from the same gradients: every kind, with the
    adamw decay mask (a matrix decays, a vector does not)."""
    rng = np.random.default_rng(3)
    init = {"w": rng.standard_normal((4, 3), dtype=np.float32),
            "scale": rng.standard_normal((3,), dtype=np.float32)}
    grads = [{k: rng.standard_normal(v.shape, dtype=np.float32)
              for k, v in init.items()} for _ in range(5)]
    tx = jax_neural.build_optimizer(spec)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    opt = neural.build_optimizer(spec)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    state = opt.init(params)
    for g in grads:
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in
                                     g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update(params, {k: torch.from_numpy(v) for k, v in g.items()},
                   state)
    for k in init:
        np.testing.assert_allclose(params[k].numpy(),
                                   np.asarray(jparams[k]), atol=1e-6,
                                   rtol=0)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        neural.build_optimizer({"kind": "lamb"})


# ----------------------------------------------------------------------
# data and accumulation
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_match_jax(shuffle):
    x = _stream(21, seed=4)
    ours = data.ArrayBatcher({"x": x}, 8, shuffle=shuffle, seed=5)
    theirs = jax_data.ArrayBatcher({"x": x}, 8, shuffle=shuffle, seed=5)
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 3
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
    assert list(ours.epoch(0))[-1][data.MASK_KEY].tolist() == \
        [1.0] * 5 + [0.0] * 3


def test_grad_accum_2_equals_accum_1(tree, compute_dtype):
    """Two micro-batches of a padded batch, weighted by their sample
    totals, give the one-batch gradients and metric sums."""
    lm = _port_lm(tree, attention="flash")
    params = dict(lm.module.named_parameters())
    batcher = data.ArrayBatcher({"x": _stream(6, seed=6)}, 8)
    batch = engine.Engine._to_device(next(batcher.epoch(0)),
                                     torch.device("cpu"))
    one = lm._get_engine()
    grads1, metrics1 = one._micro_grads(params, batch, 0)
    lm._set_grad_accum(2)
    two = lm._get_engine()
    assert two is not one
    grads2, metrics2 = two._accum_grads(params, batch, 0, 0)
    for k in grads1:
        torch.testing.assert_close(grads2[k], grads1[k], atol=1e-6,
                                   rtol=1e-5)
    for k, (s, c) in metrics1.items():
        torch.testing.assert_close(metrics2[k][0], s, atol=1e-5,
                                   rtol=1e-5)
        torch.testing.assert_close(metrics2[k][1], c, atol=0, rtol=0)


# ----------------------------------------------------------------------
# modules and init
# ----------------------------------------------------------------------
def test_rmsnorm_bf16_matches_flax():
    """flax computes the statistics in float32 under bf16 compute; a
    bf16 mean of squares would round visibly at this width."""
    import flax.linen as fnn

    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 512), dtype=np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 512).astype(np.float32)
    want = fnn.RMSNorm().apply(
        {"params": {"scale": jnp.asarray(scale, jnp.bfloat16)}},
        jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    norm = tlm.RMSNorm(512).to(torch.bfloat16)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    got = norm(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().detach().numpy(),
                                  np.asarray(want, np.float32))


def test_init_params_statistics_match_flax():
    """Dense kernels: truncated lecun_normal (variance 1/fan_in, nothing
    past 2 / 0.8796 standard units); embedding: variance 1/d_model — the
    statistics of the JAX package's flax init."""
    cfg = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
               n_kv_heads=2, max_len=32)
    ours = weights.init_params(cfg, seed=8)
    lm = jax_tlm.LanguageModel(**cfg, attention="dot")
    lm._build_params(np.zeros((1, 8), np.int32))
    for tree in (ours, jax.tree_util.tree_map(np.array, lm.params)):
        flat = weights.params_from_flax(tree)
        units = [(w.T * np.sqrt(w.shape[1])).reshape(-1)
                 for k, w in ((k, v.numpy()) for k, v in flat.items())
                 if w.ndim == 2 and not k.startswith("embed")]
        units = np.concatenate(units)
        assert abs(units.var() - 1.0) < 0.05
        assert np.abs(units).max() <= 2.0 / 0.87962566 + 1e-5
        emb = flat["embed.weight"].numpy() * np.sqrt(cfg["d_model"])
        assert abs(emb.var() - 1.0) < 0.05


def test_dropout_is_seeded_and_scaled(tree, compute_dtype):
    lm = _port_lm(tree, attention="flash", dropout=0.5)
    params = dict(lm.module.named_parameters())
    batch = {"x": torch.from_numpy(_stream(2, seed=9))}
    with torch.no_grad():
        a = lm._apply_fn(params, batch, True, 11)[0]
        b = lm._apply_fn(params, batch, True, 11)[0]
        c = lm._apply_fn(params, batch, True, 12)[0]
        off = lm._apply_fn(params, batch, False, 11)[0]
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c) and not torch.equal(a, off)
    h = torch.ones(20000)
    dropped = tlm._dropout(h, 0.25, torch.Generator().manual_seed(0))
    assert set(dropped.unique().tolist()) <= {
        0.0, float(np.float32(1.0 / 0.75))}
    assert abs(float((dropped == 0).float().mean()) - 0.25) < 0.02


# ----------------------------------------------------------------------
# fit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("jax_attention,grad_accum,head_chunk", [
    ("dot", 1, None), ("flash", 2, 8)])
def test_fit_matches_jax(tree, compute_dtype, jax_attention, grad_accum,
                         head_chunk):
    """2 epochs of 2 AdamW steps from the same weights: the history's
    loss and accuracy, and the final params. Batch 16 is a multiple of
    the JAX test mesh's 8 devices, so its batcher adds no padding."""
    x = _stream(32, seed=10)
    jlm = _jax_lm(tree, attention=jax_attention, head_chunk=head_chunk)
    want = jlm.fit(x, batch_size=16, epochs=2, shuffle=False,
                   grad_accum=grad_accum).history
    lm = _port_lm(tree, attention="flash", head_chunk=head_chunk)
    got = lm.fit(x, batch_size=16, epochs=2, shuffle=False,
                 grad_accum=grad_accum).history
    assert got["epoch"] == [0, 1]
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    assert got["loss"][1] < got["loss"][0]
    assert set(got) >= {"loss", "accuracy", "epoch", "epochSeconds",
                        "samplesPerSecond"}
    assert lm.history == [dict(zip(got, v)) for v in zip(*got.values())]
    _assert_trees_close(weights.params_to_flax(lm.params), jlm.params,
                        atol=1e-6, rtol=0)
    ev = lm.evaluate(x[:8], batch_size=8)
    jev = jlm.evaluate(x[:8], batch_size=8)
    np.testing.assert_allclose([ev["loss"], ev["accuracy"]],
                               [jev["loss"], jev["accuracy"]], rtol=1e-5)
    np.testing.assert_allclose(lm.predict(x[:8], batch_size=8),
                               jlm.predict(x[:8], batch_size=8),
                               atol=1e-4, rtol=1e-4)


def test_bf16_fit_matches_jax(tree, compute_dtype):
    compute_dtype("bfloat16")
    x = _stream(32, seed=11)
    want = _jax_lm(tree, attention="dot").fit(
        x, batch_size=16, epochs=1, shuffle=False).history
    lm = _port_lm(tree, attention="flash")
    assert lm._get_engine()._compute_dtype == torch.bfloat16
    got = lm.fit(x, batch_size=16, epochs=1, shuffle=False).history
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
    for p in lm.module.parameters():
        assert p.dtype == torch.float32


def test_fit_from_scratch_shuffled_with_validation(compute_dtype):
    """No weights yet: fit draws them from init_params(seed); shuffled
    batches follow the per-step numpy order; the validation tail is
    scored after the last epoch."""
    lm = tlm.LanguageModel(**CFG, attention="flash", device="cpu")
    lm.compile({"kind": "adam", "learning_rate": 1e-2})
    hist = lm.fit(_stream(40, seed=12), batch_size=8, epochs=2,
                  validation_split=0.2).history
    assert lm.num_params() == sum(
        v.size for v in jax.tree_util.tree_leaves(
            weights.init_params(CFG, 0)))
    assert set(hist) >= {"val_loss", "val_accuracy"}
    assert np.isfinite(hist["loss"]).all()
    assert hist["loss"][1] < hist["loss"][0]


def test_fit_rejects_bad_input(tree, tmp_path):
    lm = _port_lm(tree)
    for bad in (np.full((2, 8), 64), np.full((2, 8), -1)):
        with pytest.raises(ValueError, match=r"in \[0, 64\)"):
            lm.fit(bad, batch_size=2)
    # a checkpoint of another model's layout: its params cannot be
    # migrated either, so the fit warns and trains from scratch, as the
    # JAX package's does
    other = tlm.LanguageModel(**{**CFG, "d_model": 16}, device="cpu")
    other.fit(_stream(2), batch_size=2,
              checkpointer=Checkpointer(str(tmp_path / "ck")))
    with pytest.warns(UserWarning, match="params could not be migrated"):
        hist = lm.fit(_stream(2), batch_size=2,
                      checkpointer=Checkpointer(str(tmp_path / "ck"))).history
    assert hist["epoch"] == [0]
    with pytest.raises(ValueError, match="validation_split"):
        lm.fit(_stream(4), batch_size=2, validation_split=1.5)


# ----------------------------------------------------------------------
# artifacts
# ----------------------------------------------------------------------
def test_trained_artifact_config_matches_jax(tree, tmp_path,
                                             compute_dtype):
    x = _stream(16, seed=13)
    lm = _port_lm(tree, attention="flash")
    lm.compile({"kind": "adamw", "learning_rate": 1e-3})
    lm.seed = 3
    lm.fit(x, batch_size=8, epochs=1)
    store = ArtifactStore(str(tmp_path / "port"), device="cpu")
    port_dir = store.save(lm, "lm", "train/tensorflow")
    jlm = _jax_lm(tree, attention="flash")
    jax_dir = JaxArtifactStore(str(tmp_path / "jax")).save(
        jlm, "lm", "train/tensorflow")

    def config(d):
        with open(os.path.join(d, "native", "config.json")) as f:
            return json.load(f)

    ours = config(port_dir)
    assert set(ours) == set(config(jax_dir))
    loaded = store.load("lm")
    assert loaded.optimizer_spec == lm.optimizer_spec
    assert loaded.seed == 3 and loaded.history == lm.history
    assert len(loaded.history) == 1
    for key, value in lm.params.items():
        torch.testing.assert_close(loaded.params[key], value, atol=0,
                                   rtol=0)


def test_dataframe_tokens_match_jax():
    """A catalog-style frame (an ``_id`` column, two integer token
    columns and a string column) gives the same token windows through the
    port's ``_coerce_tokens`` as through the JAX one: ``_id`` dropped,
    the string column factorized."""
    pd = pytest.importorskip("pandas")
    frame = pd.DataFrame({"_id": [1, 2, 3, 4],
                          "t0": [5, 6, 7, 8], "t1": [9, 10, 11, 12],
                          "word": ["a", "b", "a", "c"]})
    want = jax_tlm.LanguageModel(**CFG)._coerce_tokens(frame)
    got = tlm.LanguageModel(**CFG, device="cpu")._coerce_tokens(frame)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :2], [[5, 9], [6, 10], [7, 11],
                                               [8, 12]])


def test_dataframe_to_arrays_matches_jax():
    pd = pytest.importorskip("pandas")
    frame = pd.DataFrame({"_id": [1, 2, 3], "x": ["1.5", "oops", "3"],
                          "c": ["u", "v", "u"], "y": ["no", "yes", "no"]})
    want = jax_data.dataframe_to_arrays(frame, label_column="y")
    got = data.dataframe_to_arrays(frame, label_column="y")
    assert set(got) == set(want) == {"x", "y"}
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_unknown_remat_raises_in_both_packages():
    with pytest.raises(ValueError, match="unknown remat policy"):
        jax_tlm.LanguageModel(**CFG, remat="bogus")._resolved_remat()
    with pytest.raises(ValueError, match=r"unknown remat policy 'bogus' "
                                         r"\(none\|dots\|full\)"):
        tlm.LanguageModel(**CFG, remat="bogus", device="cpu")


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_policies_match_no_remat(tree, compute_dtype, remat):
    """A 2-epoch fit under each remat policy gives the no-remat fit's
    losses and params bit for bit, with dropout on (the recompute
    replays each block's dropout masks), and the JAX package's remat fit
    of the same tree without dropout."""
    for ok in (None, "none", remat):
        assert tlm.LanguageModel(**CFG, remat=ok, device="cpu").remat == ok
    x = _stream(32, seed=12)
    plain = _port_lm(tree, dropout=0.1, attention="flash")
    want = plain.fit(x, batch_size=16, epochs=2, shuffle=False).history
    lm = _port_lm(tree, dropout=0.1, attention="flash", remat=remat)
    got = lm.fit(x, batch_size=16, epochs=2, shuffle=False).history
    assert got["loss"] == want["loss"]
    for key, value in plain.params.items():
        assert torch.equal(lm.params[key], value), key
    jax_hist = _jax_lm(tree, attention="dot", remat=remat).fit(
        x, batch_size=16, epochs=1, shuffle=False).history
    got = _port_lm(tree, attention="flash", remat=remat).fit(
        x, batch_size=16, epochs=1, shuffle=False).history
    np.testing.assert_allclose(got["loss"], jax_hist["loss"], rtol=1e-5)
