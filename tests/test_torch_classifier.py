"""The port's ``TextClassifier`` (bidirectional encoder, pad-masked mean
pool, ``cls_head`` with bias) against the JAX package's.

One flax tree (``init_params`` with ``n_classes``, numpy seed) drives
both. Logits, loss and accuracy agree in float32 to atol 2e-5 / rtol
1e-5 with ``dot`` and with ``flash`` (the JAX package's Pallas kernel in
interpret mode, the port's plain version on the CPU), non-causal, with
padded rows. The classifier learns the marker task of
``tests/test_transformer.py`` (whether token 3 appears anywhere), gives
probability rows and round-trips as an artifact; ``POST /model`` of the
tutorial's ``TextClassifier`` answers 201 and finishes in both packages.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.models import transformer as jax_tlm
from learningorchestra_tpu_torch.catalog import ArtifactStore
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import TextClassifier, weights
from learningorchestra_tpu_torch.models.encoder import TransformerEncoder
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
CFG = dict(vocab_size=40, n_classes=3, d_model=32, n_layers=2, n_heads=4,
           n_kv_heads=2, max_len=24)
# docs/TUTORIAL.md's classifier
TUTORIAL = {"vocab_size": 20000, "n_classes": 2, "d_model": 256,
            "n_layers": 4, "n_heads": 8, "n_kv_heads": 4, "max_len": 512}


@pytest.fixture()
def float32(monkeypatch):
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    jax_config.reset_config()
    yield
    jax_config.reset_config()


def _rows(n, seed, seq=24):
    """Token rows padded with 0 to lengths 6..seq, and labels."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, CFG["vocab_size"], size=(n, seq)).astype(np.int32)
    lengths = rng.integers(6, seq + 1, size=n)
    x[np.arange(seq)[None, :] >= lengths[:, None]] = 0
    y = rng.integers(0, CFG["n_classes"], size=n).astype(np.int32)
    return x, y


def _pair(attention, seed=0):
    tree = weights.init_params(CFG, seed)
    # a non-zero bias, so its mapping counts
    tree["cls_head"]["bias"] = np.array([0.1, -0.2, 0.05], np.float32)
    jclf = jax_tlm.TextClassifier(**CFG, attention=attention)
    jclf.params = jax.tree_util.tree_map(jnp.asarray, tree)
    clf = TextClassifier(**CFG, attention=attention, device="cpu")
    clf.set_params(weights.params_from_flax(tree))
    return jclf, clf, tree


def test_init_params_has_the_jax_encoder_tree():
    jclf = jax_tlm.TextClassifier(**CFG)
    jclf._build_params(np.zeros((1, 8), np.int32))
    want = jax.tree_util.tree_map(np.asarray, jclf.params)
    got = weights.init_params(CFG, 0)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert not got["cls_head"]["bias"].any()


@pytest.mark.parametrize("attention", ["dot", "flash"])
def test_logits_loss_accuracy_match_jax(float32, attention):
    jclf, clf, _ = _pair(attention)
    x, y = _rows(16, seed=1)
    want = jclf.predict(x, batch_size=8)
    got = clf.predict(x, batch_size=8)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    jev = jclf.evaluate(x, y, batch_size=8)
    ev = clf.evaluate(x, y, batch_size=8)
    np.testing.assert_allclose(ev["loss"], jev["loss"], rtol=1e-5)
    assert ev["accuracy"] == pytest.approx(jev["accuracy"], abs=1e-7)
    # the raw logits too, through the module
    logits = clf._get_engine().predict(dict(clf.module.named_parameters()),
                                       clf._batcher(x[:8], None, 8))
    jlogits = jclf._get_engine().predict(
        jclf._get_engine().init_state(jclf.params),
        jclf._batcher(x[:8], None, 8))
    np.testing.assert_allclose(logits, np.asarray(jlogits), atol=2e-5,
                               rtol=1e-5)


def test_flash_takes_the_kernel_path_without_a_mask():
    """Pads are attended in both packages and only left out of the pool:
    the encoder passes no kv_valid, so flash reaches flash_attention."""
    from learningorchestra_tpu_torch.ops import attention as attn

    calls = []
    real = attn.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("causal"))
        return real(*a, **kw)

    _, clf, _ = _pair("flash")
    x, _ = _rows(2, seed=2)
    attn.flash_attention = spy
    try:
        clf.predict(x, batch_size=2)
    finally:
        attn.flash_attention = real
    assert calls == [False] * CFG["n_layers"]


def test_one_fit_step_matches_jax(float32):
    """Two SGD steps (Adam would turn the near-zero gradients of a
    padded pool's rarely-seen weights into whole steps of either sign)."""
    jclf, clf, _ = _pair("dot")
    for model in (jclf, clf):
        model.compile({"kind": "sgd", "learning_rate": 0.1})
    x, y = _rows(16, seed=3)
    want = jclf.fit(x, y, batch_size=16, epochs=2, shuffle=False).history
    got = clf.fit(x, y, batch_size=16, epochs=2, shuffle=False).history
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(
            weights.params_to_flax(clf.params)),
            jax.tree_util.tree_leaves(jclf.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)


def test_learns_the_marker_task_and_round_trips(tmp_path, float32):
    """As the JAX package's test_text_classifier_learns_and_round_trips:
    the label is whether token 3 appears anywhere."""
    rng = np.random.default_rng(0)
    x = rng.integers(4, 16, size=(128, 10)).astype(np.int32)
    y = rng.integers(0, 2, size=128).astype(np.int32)
    pos = rng.integers(0, 10, size=128)
    x[np.arange(128)[y == 1], pos[y == 1]] = 3
    clf = TextClassifier(vocab_size=16, n_classes=2, d_model=32, n_layers=1,
                         n_heads=2, max_len=10, attention="flash",
                         name="tc_rt", device="cpu")
    clf.compile({"kind": "adam", "learning_rate": 5e-3})
    hist = clf.fit(x, y, batch_size=32, epochs=15, shuffle=False)
    assert hist.history["loss"][-1] < hist.history["loss"][0]
    assert clf.evaluate(x, y, batch_size=32)["accuracy"] > 0.9
    probs = clf.predict(x[:8], batch_size=8)
    assert probs.shape == (8, 2)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    store = ArtifactStore(str(tmp_path), device="cpu")
    store.save(clf, "tc", "train/tensorflow")
    loaded = store.load("tc")
    assert isinstance(loaded, TextClassifier)
    assert loaded.history == clf.history and loaded.name == "tc_rt"
    np.testing.assert_array_equal(loaded.predict(x[:8], batch_size=8), probs)
    assert loaded.num_params() == clf.num_params() == sum(
        v.size for v in jax.tree_util.tree_leaves(
            weights.params_to_flax(clf.params)))


def test_auto_follows_the_port_lm_rule():
    assert TextClassifier(**CFG, attention="auto",
                          device="cpu")._resolved_attention() == "flash"
    wide = dict(CFG, d_model=512, n_heads=2)
    assert TextClassifier(**wide, attention="auto",
                          device="cpu")._resolved_attention() == "dot"
    assert TextClassifier(**CFG, device="cpu").attention == "dot"
    # ring and Ulysses are implementations of the LM module the encoder
    # shares, as in the JAX package (without an sp axis they attend
    # densely); an unknown one raises
    assert TextClassifier(**CFG, attention="ring",
                          device="cpu").attention == "ring"
    with pytest.raises(ValueError, match="unknown attention"):
        TextClassifier(**CFG, attention="ring2", device="cpu")
    with pytest.raises(ValueError, match="n_kv_heads"):
        TextClassifier(**dict(CFG, n_kv_heads=3), device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        TextClassifier(**CFG, device="cpu").fit(
            np.full((2, 4), 40), np.zeros(2))
    assert isinstance(TransformerEncoder(10, 2, d_model=8, n_layers=1,
                                         n_heads=2), torch.nn.Module)


def _call(api, method, path, body=None):
    return api.dispatch(method, PREFIX + path, {}, body)[:2]


def _wait(api, path, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, body = _call(api, "GET", path)
        if body["metadata"]["finished"]:
            return body
        time.sleep(0.02)
    raise AssertionError(f"timeout polling {path}")


def test_tutorial_classifier_is_created_over_rest_as_jax(tmp_path):
    """docs/TUTORIAL.md's POST /model of the TextClassifier: 201, then
    finished, in both packages, and the stored model takes the body."""
    body = {"modelName": "clf", "modulePath": "learningorchestra_tpu.models",
            "class": "TextClassifier", "classParameters": TUTORIAL}
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax")))
    from learningorchestra_tpu.services.server import Api as JaxApi

    apis = (JaxApi(), Api(ServiceContext(
        Config(home=str(tmp_path / "port")), device="cpu")))
    try:
        seen = []
        for api in apis:
            posted = _call(api, "POST", "/model/tensorflow", body)
            done = _wait(api, "/model/tensorflow/clf")
            seen.append((posted, done["metadata"]["classParameters"],
                         done["metadata"]["finished"]))
        stored = apis[1].ctx.artifacts.load("clf")
    finally:
        for api in apis:
            api.ctx.close()
        jax_config.reset_config()
    assert seen[0] == seen[1]
    assert seen[1][0] == (201, {"result": PREFIX + "/model/tensorflow/clf"})
    assert isinstance(stored, TextClassifier)
    assert {k: getattr(stored, k) for k in TUTORIAL} == TUTORIAL


def test_fit_takes_catalog_tables(float32):
    """``$rows`` and ``$labels`` resolve to catalog ``Table``s over REST
    (a tune's refit passes them as they are): the fit equals the one on
    arrays."""
    from learningorchestra_tpu_torch.catalog.store import Table

    x, y = _rows(16, seed=4)
    rows = Table({f"t{i}": x[:, i] for i in range(x.shape[1])}, len(x))
    labels = Table({"label": y.astype(np.int64)}, len(y))
    hists = []
    for xs, ys in ((x, y), (rows, labels)):
        _, clf, _ = _pair("dot")
        hists.append(clf.fit(xs, ys, batch_size=8, epochs=1,
                             shuffle=False).history["loss"])
    assert hists[0] == hists[1]
