"""Native artifacts cross packages as ``weights.msgpack``.

A ``LanguageModel`` (with and without LoRA adapters) and a
``TextClassifier`` that the JAX package's ``ArtifactStore`` wrote load
through the port's store with the same logits (float32, atol 2e-5), and
the JAX package's ``__lo_load__`` reads the port's artifact dirs with the
same logits. Both packages write the same ``config.json`` keys and the
same ``weights.msgpack`` bytes for one tree. An artifact the port wrote
before it wrote msgpack (``weights.pt``) still loads; a JAX class the
port lacks, or a config value it does not run, raises "not yet ported".
"""

import json
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
from learningorchestra_tpu_torch.models import (LanguageModel,
                                                TextClassifier, weights)

torch.set_num_threads(2)

LM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          max_len=32, sliding_window=16, attention="dot")
LORA = dict(LM, lora_rank=4, lora_alpha=8.0)
CLF = dict(vocab_size=40, n_classes=2, d_model=32, n_layers=2, n_heads=4,
           n_kv_heads=2, max_len=24)


@pytest.fixture()
def float32(monkeypatch):
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    jax_config.reset_config()
    yield
    jax_config.reset_config()


def _tree(config, seed):
    tree = weights.init_params(config, seed)
    rng = np.random.default_rng(seed + 1)
    for layer in (v for k, v in tree.items() if k.startswith("layer_")):
        for proj in layer["attn"].values():
            if "lora_b" in proj:  # adapters that change the logits
                proj["lora_b"] = rng.normal(
                    scale=0.1, size=proj["lora_b"].shape).astype(np.float32)
    if "cls_head" in tree:
        tree["cls_head"]["bias"] = np.array([0.3, -0.1], np.float32)
    return tree


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(
        1, vocab, size=shape).astype(np.int32)


CASES = {
    "lm": (jax_tlm.LanguageModel, LanguageModel, LM),
    "lm with lora": (jax_tlm.LanguageModel, LanguageModel, LORA),
    "classifier": (jax_tlm.TextClassifier, TextClassifier, CLF),
}


def _models(case, seed=0):
    jax_cls, port_cls, config = CASES[case]
    tree = _tree(config, seed)
    jax_model = jax_cls(**config, name=f"m_{seed}")
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jax_model.history = [{"loss": 1.5, "epoch": 0}]
    jax_model.seed = 4
    port_model = port_cls(**config, name=f"m_{seed}", device="cpu")
    port_model.set_params(weights.params_from_flax(tree))
    port_model.history = [{"loss": 1.5, "epoch": 0}]
    port_model.seed = 4
    return jax_model, port_model, config


def _logits(model, config):
    x = _tokens(config["vocab_size"], (8, 12), seed=7)
    return np.asarray(model.predict(x, batch_size=8))


@pytest.mark.parametrize("case", list(CASES))
def test_jax_artifact_loads_in_the_port(tmp_path, float32, case):
    jax_model, _, config = _models(case)
    JaxArtifactStore(str(tmp_path)).save(jax_model, "m", "train/tensorflow")
    loaded = ArtifactStore(str(tmp_path), device="cpu").load(
        "m", "train/tensorflow")
    assert type(loaded) is CASES[case][1]
    assert loaded.history == jax_model.history and loaded.seed == 4
    assert getattr(loaded, "lora_rank", 0) == config.get("lora_rank", 0)
    np.testing.assert_allclose(_logits(loaded, config),
                               _logits(jax_model, config), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_port_artifact_loads_in_the_jax_package(tmp_path, float32, case):
    jax_model, port_model, config = _models(case)
    d = ArtifactStore(str(tmp_path), device="cpu").save(
        port_model, "m", "train/tensorflow")
    loaded = CASES[case][0].__lo_load__(os.path.join(d, "native"))
    assert loaded.history == port_model.history and loaded.seed == 4
    np.testing.assert_allclose(_logits(loaded, config),
                               _logits(port_model, config), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_both_packages_write_the_same_files(tmp_path, case):
    """config.json has the same keys and values; weights.msgpack the same
    bytes once the flax tree's keys are in one order (flax packs a
    dict in its own order, and flax's init orders them its own way)."""
    jax_model, port_model, _ = _models(case)
    jd = JaxArtifactStore(str(tmp_path / "jax")).save(
        jax_model, "m", "train/tensorflow")
    pd = ArtifactStore(str(tmp_path / "port"), device="cpu").save(
        port_model, "m", "train/tensorflow")
    configs = [json.load(open(os.path.join(d, "native", "config.json")))
               for d in (jd, pd)]
    assert configs[0] == configs[1]

    def canonical(path):
        from flax import serialization

        tree = serialization.msgpack_restore(open(path, "rb").read())
        return serialization.msgpack_serialize(
            jax.tree_util.tree_map(np.asarray, tree))  # keys sorted

    assert canonical(os.path.join(jd, "native", "weights.msgpack")) == \
        canonical(os.path.join(pd, "native", "weights.msgpack"))


def test_pre_msgpack_artifact_still_loads(tmp_path, float32):
    """An artifact as the port wrote it before msgpack: config.json and a
    ``torch.save``d state_dict, ``weights.pt``."""
    _, port_model, config = _models("lm")
    d = tmp_path / "train" / "tensorflow" / "old" / "native"
    d.mkdir(parents=True)
    cfg = {k: getattr(port_model, k) for k in LanguageModel._CONFIG_KEYS}
    cfg.update(name="old", optimizer_spec=port_model.optimizer_spec,
               seed=0, history=[], built=True)
    (d / "config.json").write_text(json.dumps(cfg))
    torch.save({k: t.detach().clone() for k, t in port_model.params.items()},
               str(d / "weights.pt"))
    (d.parent / "meta.json").write_text(json.dumps({
        "name": "old", "type": "train/tensorflow", "kind": "native",
        "module": "learningorchestra_tpu_torch.models.transformer",
        "class": "LanguageModel"}))
    loaded = ArtifactStore(str(tmp_path), device="cpu").load("old")
    for k, v in port_model.params.items():
        assert torch.equal(loaded.params[k], v), k
    np.testing.assert_array_equal(_logits(loaded, config),
                                  _logits(port_model, config))


def test_unported_jax_classes_and_options_raise(tmp_path):
    from learningorchestra_tpu.models.tf_compat.keras import (
        layers as jax_layers, optimizers as jax_optimizers)
    from learningorchestra_tpu_torch.models.tf_compat.keras import (
        layers as port_layers, optimizers as port_optimizers)

    store = ArtifactStore(str(tmp_path), device="cpu")
    # the JAX tensorflow shim's specs (its store writes them with dill)
    # load as the port's shim classes of the same names
    for name, spec, cls in (
            ("dense", jax_layers.Dense(4, activation="relu"),
             port_layers.Dense),
            ("adam", jax_optimizers.Adam(0.05), port_optimizers.Adam)):
        JaxArtifactStore(str(tmp_path)).save(spec, name, "model/tensorflow")
        loaded = store.load(name)
        assert type(loaded) is cls
        assert vars(loaded) == vars(spec)
    # a JAX class the port has no counterpart for
    d = tmp_path / "model" / "tensorflow" / "nm"
    d.mkdir(parents=True)
    (d / "meta.json").write_text(json.dumps({
        "name": "nm", "type": "model/tensorflow", "kind": "native",
        "module": "learningorchestra_tpu.models.transformer",
        "class": "TransformerLM"}))
    with pytest.raises(ValueError, match="transformer.TransformerLM of the "
                                         "JAX package is not yet ported"):
        store.load("nm")
    # a JAX LanguageModel with ring attention: ported, so it loads
    ring = jax_tlm.LanguageModel(**dict(LM, attention="ring"))
    JaxArtifactStore(str(tmp_path)).save(ring, "ring", "model/tensorflow")
    assert store.load("ring").attention == "ring"
    # MoE and fused projections run: their JAX artifacts load
    for name, option in (("moe", {"n_experts": 4}),
                         ("fused", {"fused_proj": True})):
        jax_model = jax_tlm.LanguageModel(**dict(LM, **option))
        JaxArtifactStore(str(tmp_path)).save(jax_model, name,
                                             "model/tensorflow")
        loaded = store.load(name)
        assert all(getattr(loaded, k) == v for k, v in option.items())
    # weights.msgpack whose keys do not match the model's
    jax_model, _, _ = _models("lm")
    JaxArtifactStore(str(tmp_path)).save(jax_model, "lm", "model/tensorflow")
    cfg_path = tmp_path / "model" / "tensorflow" / "lm" / "native" / \
        "config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["lora_rank"] = 2  # the model now expects adapters the file lacks
    cfg_path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="keys do not match"):
        store.load("lm")
