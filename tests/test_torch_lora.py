"""LoRA, and the tutorial's LM workflow, in the port against the JAX package's (``_LoRADense``,
``enable_lora``, ``merge_lora`` and the frozen-base optimizer).

One flax tree with adapters (``init_params`` with ``lora_rank``, numpy
seed) drives both packages. Tolerances, float32: logits to atol 2e-5;
losses to rtol 1e-5 and params after AdamW steps to atol 1e-6 (the
optimizer parity of ``tests/test_torch_training.py``); ``enable_lora``
keeps step-0 predictions to atol 1e-5 and ``merge_lora`` folds the
adapted ones to atol 1e-4 (``tests/test_transformer.py``'s LoRA tests).
Small shapes (vocab 64, d_model 32, 2 layers, 4 heads over 2 kv heads).
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu import native as jax_native
from learningorchestra_tpu.models import transformer as jax_tlm
from learningorchestra_tpu_torch.catalog import ArtifactStore
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.models import neural, weights
from learningorchestra_tpu_torch.models.transformer import (LanguageModel,
                                                            LoRALinear)
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.server import Api

torch.set_num_threads(2)

PREFIX = "/api/learningOrchestra/v1"
CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           max_len=32, sliding_window=16)
LORA = dict(CFG, lora_rank=4, lora_alpha=8.0)


@pytest.fixture()
def float32(monkeypatch):
    monkeypatch.setenv("LO_COMPUTE_DTYPE", "float32")
    jax_config.reset_config()
    yield
    jax_config.reset_config()


def _stream(n, seed):
    start = np.random.default_rng(seed).integers(1, 64, size=n)
    return ((start[:, None] + np.arange(32)[None, :]) % 63 + 1) \
        .astype(np.int32)


def _moved_tree(seed=0):
    """An adapter tree with non-zero B, so the adapters change logits."""
    tree = weights.init_params(LORA, seed)
    rng = np.random.default_rng(seed + 1)
    for i in range(CFG["n_layers"]):
        for proj in tree[f"layer_{i}"]["attn"].values():
            proj["lora_b"] = rng.normal(
                scale=0.1, size=proj["lora_b"].shape).astype(np.float32)
    return tree


def _jax(tree, **kw):
    lm = jax_tlm.LanguageModel(**{**LORA, **kw})
    lm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    return lm


def _port(tree, **kw):
    lm = LanguageModel(**{**LORA, **kw}, device="cpu")
    lm.set_params(weights.params_from_flax(tree))
    return lm


def test_adapter_tree_maps_both_ways():
    tree = weights.init_params(LORA, 0)
    proj = tree["layer_0"]["attn"]["q_proj"]
    assert list(proj) == ["kernel", "lora_a", "lora_b"]
    assert proj["lora_a"].shape == (32, 4) and proj["lora_b"].shape == (4, 32)
    assert not proj["lora_b"].any()
    back = weights.params_to_flax(weights.params_from_flax(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # the JAX model's own init has the same tree
    jlm = jax_tlm.LanguageModel(**LORA)
    jlm._build_params(np.zeros((1, 8), np.int32))
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(
        np.asarray, jlm.params)) == jax.tree_util.tree_structure(tree)


@pytest.mark.parametrize("attention", ["dot", "flash"])
def test_adapted_logits_match_jax(float32, attention):
    tree = _moved_tree()
    x = _stream(4, seed=2)
    want = _jax(tree, attention="dot").predict(x, batch_size=4)
    got = _port(tree, attention=attention).predict(x, batch_size=4)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_lora_linear_is_the_jax_dense():
    """y = xW + (xA)B·α/r, A and B cast to x's dtype, the scale rounded
    to it."""
    lin = LoRALinear(6, 5, rank=3, alpha=7.0)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in lin.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape)
                                     .astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32))
    want = x.numpy() @ lin.weight.detach().numpy().T + \
        (x.numpy() @ lin.lora_a.detach().numpy()) @ \
        lin.lora_b.detach().numpy() * np.float32(7.0 / 3)
    np.testing.assert_allclose(lin(x).detach().numpy(), want, atol=1e-5)


def test_adapter_steps_match_jax_and_the_base_stays(float32):
    """4 AdamW steps: only adapters get updates and optimizer state
    (the JAX package's optax multi_transform with set_to_zero)."""
    tree = weights.init_params(LORA, 0)
    x = _stream(32, seed=4)
    jlm = _jax(tree, attention="dot")
    want = jlm.fit(x, batch_size=16, epochs=2, shuffle=False).history
    lm = _port(tree, attention="flash")
    got = lm.fit(x, batch_size=16, epochs=2, shuffle=False).history
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    got_tree = weights.params_to_flax(lm.params)
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(got_tree)[0],
            jax.tree_util.tree_leaves(jlm.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)
        leaf = jax.tree_util.keystr(path)
        if "lora_" not in leaf:  # the base stays bit for bit
            init = tree
            for part in [p.key for p in path]:
                init = init[part]
            np.testing.assert_array_equal(a, init)
    assert not np.array_equal(got_tree["layer_0"]["attn"]["q_proj"]
                              ["lora_b"], 0)
    # the optimizer holds state for the adapters only
    state = lm._get_engine()._optimizer.init(dict(
        lm.module.named_parameters()))
    assert set(state["mu"]) == {k for k in lm.params if ".lora_" in k}
    assert all(p.requires_grad == (".lora_" in n)
               for n, p in lm.module.named_parameters())


def test_frozen_base_optimizer_matches_optax_multi_transform():
    spec = {"kind": "adamw", "learning_rate": 1e-2, "weight_decay": 0.1}
    rng = np.random.default_rng(5)
    init = {"a.weight": rng.normal(size=(4, 3)).astype(np.float32),
            "a.lora_a": rng.normal(size=(3, 2)).astype(np.float32),
            "a.lora_b": rng.normal(size=(2, 4)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in init.items()} for _ in range(3)]
    import optax

    from learningorchestra_tpu.models import neural as jax_neural

    def nested(flat):  # the flax layout: leaves named under "a"
        return {"a": {k.split(".")[1]: jnp.asarray(v)
                      for k, v in flat.items()}}

    tx = jax_tlm._lora_optimizer(jax_neural.build_optimizer(spec))
    jparams = nested(init)
    jstate = tx.init(jparams)
    opt = neural.build_optimizer(spec, frozen_base=True)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    state = opt.init(params)
    assert set(state["mu"]) == {"a.lora_a", "a.lora_b"}
    for g in grads:
        upd, jstate = tx.update(nested(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update(params, {k: torch.from_numpy(v) for k, v in g.items()
                            if ".lora_" in k}, state)
    for k in init:
        np.testing.assert_allclose(params[k].numpy(),
                                   np.asarray(jparams["a"][k.split(".")[1]]),
                                   atol=1e-6, rtol=0)
    np.testing.assert_array_equal(params["a.weight"].numpy(),
                                  init["a.weight"])


def test_enable_and_merge_keep_predictions(float32):
    """As the JAX package's test_lora_enable_merge_roundtrip."""
    x = _stream(16, seed=6)
    lm = LanguageModel(**CFG, attention="flash", device="cpu")
    lm.fit(x, batch_size=8, epochs=2)
    base_pred = lm.predict(x[:4], batch_size=4)
    base = {k: v.clone() for k, v in lm.params.items()}
    lm.enable_lora(rank=4)
    assert lm.lora_rank == 4 and lm.lora_alpha == 16.0
    np.testing.assert_allclose(lm.predict(x[:4], batch_size=4), base_pred,
                               atol=1e-5)
    lm.fit(x, batch_size=8, epochs=3)
    for k, v in base.items():
        assert torch.equal(lm.params[k], v), k
    adapted = lm.predict(x[:4], batch_size=4)
    assert not np.allclose(adapted, base_pred, atol=1e-4)
    lm.merge_lora()
    assert lm.lora_rank == 0
    assert not any(".lora_" in k for k in lm.params)
    np.testing.assert_allclose(lm.predict(x[:4], batch_size=4), adapted,
                               atol=1e-4)
    assert all(p.requires_grad for p in lm.module.parameters())


def test_merge_folds_as_jax(float32):
    """merge_lora of one adapted tree gives JAX's merged kernels."""
    tree = _moved_tree(seed=7)
    jlm, lm = _jax(tree), _port(tree)
    jlm.merge_lora()
    lm.merge_lora()
    for a, b in zip(jax.tree_util.tree_leaves(
            weights.params_to_flax(lm.params)),
            jax.tree_util.tree_leaves(jlm.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-7, rtol=0)


def test_guards_raise():
    lm = LanguageModel(**CFG, device="cpu")
    with pytest.raises(RuntimeError, match="no weights"):
        lm.enable_lora(rank=2)
    with pytest.raises(RuntimeError, match="no LoRA adapters"):
        lm.merge_lora()
    lm.set_params(weights.params_from_flax(weights.init_params(CFG, 0)))
    with pytest.raises(ValueError, match="rank must be >= 1"):
        lm.enable_lora(rank=0)
    lm.enable_lora(rank=2)
    with pytest.raises(RuntimeError, match="already has LoRA adapters"):
        lm.enable_lora(rank=2)
    with pytest.raises(ValueError, match="lora_rank must be >= 0"):
        LanguageModel(**CFG, lora_rank=-1, device="cpu")
    # a tree that lacks a base weight is refused, not re-initialized
    other = LanguageModel(**CFG, device="cpu")
    state = weights.params_from_flax(weights.init_params(CFG, 0))
    other.set_params(state)
    other.module.final_norm = torch.nn.Identity()
    with pytest.raises(ValueError, match="no leaf at 'final_norm/scale'"):
        other.enable_lora(rank=2)


def test_lora_artifact_round_trips(tmp_path, float32):
    tree = _moved_tree(seed=8)
    lm = _port(tree)
    store = ArtifactStore(str(tmp_path), device="cpu")
    store.save(lm, "lora", "train/tensorflow")
    loaded = store.load("lora")
    assert loaded.lora_rank == 4 and loaded.lora_alpha == 8.0
    for k, v in lm.params.items():
        assert torch.equal(loaded.params[k], v), k
    x = _stream(2, seed=9)
    np.testing.assert_array_equal(loaded.predict(x), lm.predict(x))


# ----------------------------------------------------------------------
# REST: the tutorial's enable_lora -> fit -> merge_lora -> generate
# ----------------------------------------------------------------------
def _call(api, method, path, body=None):
    return api.dispatch(method, PREFIX + path, {}, body)[:2]


def _wait(api, path, timeout=300.0, meta_keys=()):
    """The GET body once the job is finished and (both packages mark it
    finished first) its execution document is written, and its metadata
    document holds ``meta_keys`` (the JAX package writes its timings
    after)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, body = _call(api, "GET", path)
        assert status == 200, body
        executes = path.startswith(("/train/", "/predict/"))
        if body["metadata"]["finished"] and (
                not executes or "queueWaitSeconds" in body["result"][-1]) \
                and all(k in body["result"][0] for k in meta_keys):
            return body
        if any(d.get("exception") for d in body["result"]):
            raise AssertionError(f"job failed: {body['result'][-1]}")
        time.sleep(0.02)
    raise AssertionError(f"timeout polling {path}")


def _run(api, name, parent, method, params, verb="train"):
    status, body = _call(api, "POST", f"/{verb}/tensorflow", {
        "name": name, "modelName": parent, "method": method,
        "methodParameters": params})
    assert status == 201, body
    return _wait(api, f"/{verb}/tensorflow/{name}")


def _lora_pipeline(api, csv, seeded, graft):
    out = {}
    assert _call(api, "POST", "/dataset/csv", {
        "datasetName": "corpus", "datasetURI": csv})[0] == 201
    assert _call(api, "POST", "/model/tensorflow", {
        "modelName": "lm", "modulePath": "learningorchestra_tpu.models",
        "class": "LanguageModel", "classParameters": CFG})[0] == 201
    # a GET while the JAX ingest writes can answer 500
    api.ctx.jobs.wait("corpus", timeout=300)
    _wait(api, "/dataset/csv/corpus")
    _wait(api, "/model/tensorflow/lm")
    api.ctx.artifacts.save(seeded, "lm", "model/tensorflow")
    _run(api, "lm_t", "lm", "fit", {"x": "$corpus", "batch_size": 16,
                                     "shuffle": False})
    out["enable"] = _run(api, "lm_lora", "lm_t", "enable_lora",
                         {"rank": 4})
    # one set of adapters in both packages (each draws its own)
    graft(api)
    out["fit"] = _run(api, "lm_ft", "lm_lora", "fit", {
        "x": "$corpus", "epochs": 2, "batch_size": 16, "shuffle": False})
    out["merge"] = _run(api, "lm_merged", "lm_ft", "merge_lora", {})
    out["generate"] = _run(api, "lm_gen", "lm_merged", "generate", {
        "prompt": [[1, 2, 3]], "max_new_tokens": 5, "temperature": 0.8,
        "top_p": 0.9}, verb="predict")
    out["merged"] = api.ctx.artifacts.load("lm_merged")
    out["tuned"] = api.ctx.artifacts.load("lm_ft")
    out["trained"] = api.ctx.artifacts.load("lm_t")
    return out


def test_rest_lora_workflow_as_jax(tmp_path, float32, monkeypatch):
    # the JAX ingest takes its pyarrow reader, the port's reference (its
    # native parser builds into one cache shared by every process)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    x = _stream(32, seed=10)
    csv = tmp_path / "c.csv"
    with open(csv, "w") as f:
        f.write(",".join(f"t{i}" for i in range(32)) + "\n")
        for row in x:
            f.write(",".join(str(int(t)) for t in row) + "\n")
    tree = weights.init_params(CFG, seed=11)
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax")))
    from learningorchestra_tpu.services.server import Api as JaxApi

    jax_api = JaxApi()
    port_api = Api(ServiceContext(Config(home=str(tmp_path / "port")),
                                  device="cpu"))
    adapters = {}

    def graft_port(api):
        lora = api.ctx.artifacts.load("lm_lora")
        adapters.update({k: v.clone() for k, v in lora.params.items()
                         if ".lora_" in k})

    def graft_jax(api):
        lora = api.ctx.artifacts.load("lm_lora")
        flat = weights.params_to_flax(
            {**weights.params_from_flax(jax.tree_util.tree_map(
                np.asarray, lora.params)), **adapters})
        lora.params = jax.tree_util.tree_map(jnp.asarray, flat)
        api.ctx.artifacts.save(lora, "lm_lora", "train/tensorflow")

    jax_seeded = jax_tlm.LanguageModel(**CFG)
    jax_seeded.params = jax.tree_util.tree_map(jnp.asarray, tree)
    port_seeded = LanguageModel(**CFG, device="cpu")
    port_seeded.set_params(weights.params_from_flax(tree))
    try:
        got = _lora_pipeline(port_api, str(csv), port_seeded, graft_port)
        want = _lora_pipeline(jax_api, str(csv), jax_seeded, graft_jax)
    finally:
        jax_api.ctx.close()
        port_api.ctx.close()
        jax_config.reset_config()
    for step in ("enable", "fit", "merge", "generate"):
        g, w = got[step], want[step]
        assert g["metadata"]["finished"] and w["metadata"]["finished"]
        # the execution document has JAX's keys; the metadata JAX's
        # core (JAX adds compile, perf and slice fields)
        assert set(g["result"][-1]) == set(w["result"][-1])
        assert set(g["metadata"]) <= set(w["metadata"])
    records = [[d["epochRecord"] for d in out["fit"]["result"]
                if "epochRecord" in d] for out in (got, want)]
    assert [r["epoch"] for r in records[0]] == [r["epoch"]
                                                for r in records[1]]
    np.testing.assert_allclose([r["loss"] for r in records[0]],
                               [r["loss"] for r in records[1]], rtol=1e-5)
    for k, v in got["trained"].params.items():
        assert torch.equal(got["tuned"].params[k], v), k
    assert got["merged"].lora_rank == want["merged"].lora_rank == 0
    for a, b in zip(jax.tree_util.tree_leaves(
            weights.params_to_flax(got["merged"].params)),
            jax.tree_util.tree_leaves(want["merged"].params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)
    tokens = [[d["result"] for d in out["generate"]["result"]
               if "result" in d][0] for out in (got, want)]
    assert np.asarray(tokens[0]).shape == np.asarray(tokens[1]).shape \
        == (1, 8)
    assert tokens[0][0][:3] == [1, 2, 3]
    assert tokens[0] == got["merged"].generate(
        [[1, 2, 3]], max_new_tokens=5, temperature=0.8,
        top_p=0.9).tolist()


# docs/TUTORIAL.md's LM workflow (section 4), body for body; the LM's
# widths are cut for the CPU (its vocab still holds the prompt's ids)
TUTORIAL_LM = {"vocab_size": 32000, "d_model": 512, "n_layers": 8,
               "n_heads": 8, "n_kv_heads": 4, "max_len": 2048,
               "sliding_window": 1024}
SMALL_LM = dict(TUTORIAL_LM, vocab_size=2048 + 64, d_model=32, n_layers=2,
                max_len=64, sliding_window=32)
TUTORIAL_RUNS = (
    ("train", "lm_t", "lm", "fit", {
        "x": "$corpus.tokens", "epochs": 3, "batch_size": 16,
        "grad_accum": 2, "checkpoint": True}),
    ("train", "lm_lora", "lm_t", "enable_lora", {"rank": 16}),
    ("train", "lm_ft", "lm_lora", "fit", {
        "x": "$domain_corpus.tokens", "epochs": 2, "batch_size": 16}),
    ("train", "lm_merged", "lm_ft", "merge_lora", {}),
    ("predict", "lm_gen", "lm_merged", "generate", {
        "prompt": [[101, 2023, 2003]], "max_new_tokens": 64,
        "temperature": 0.8, "top_p": 0.9}),
)


def _tutorial(api, store_object):
    seen = []
    for name, params in (("lm_full", TUTORIAL_LM), ("lm", SMALL_LM)):
        seen.append(_call(api, "POST", "/model/tensorflow", {
            "modelName": name, "modulePath": "learningorchestra_tpu.models",
            "class": "LanguageModel", "classParameters": params}))
        _wait(api, f"/model/tensorflow/{name}")
    rng = np.random.default_rng(12)
    for name, step in (("corpus", 1), ("domain_corpus", 7)):
        start = rng.integers(1, 2048)
        store_object(name, {"tokens": ((start + step * np.arange(
            3 * 16 * 64)) % 2047 + 1).astype(np.int32)})
    for verb, name, parent, method, params in TUTORIAL_RUNS:
        seen.append(_call(api, "POST", f"/{verb}/tensorflow", {
            "name": name, "modelName": parent, "method": method,
            "methodParameters": params}))
        body = _wait(api, f"/{verb}/tensorflow/{name}", meta_keys=(
            ("checkpointCommitSeconds",) if params.get("checkpoint")
            else ()))
        meta, *docs = body["result"]
        seen.append((name, [sorted(d) for d in docs]))
        # the metadata: JAX's core keys, and the port's checkpoint timings
        seen.append((name, sorted(set(meta) & {
            "name", "type", "finished", "status", "parentName", "method",
            "methodParameters", "checkpointCommitSeconds"})))
    return seen, body


def test_tutorial_lm_bodies_run_as_jax(tmp_path, float32):
    """Every request of docs/TUTORIAL.md's LM workflow answers 201 and
    finishes in the port, with the JAX package's answers and documents:
    create, the checkpointed fit, enable_lora, the fine-tune, merge_lora
    and the sampled generate."""
    jax_config.set_config(jax_config.Config(home=str(tmp_path / "jax")))
    from learningorchestra_tpu.services.server import Api as JaxApi

    jax_api = JaxApi()
    port_api = Api(ServiceContext(Config(home=str(tmp_path / "port")),
                                  device="cpu"))
    try:
        want, _ = _tutorial(jax_api, lambda n, v: jax_api.ctx.artifacts.save(
            v, n, "function/python"))
        got, gen = _tutorial(port_api, lambda n, v: port_api.ctx.artifacts
                             .save(v, n, "function/python"))
        ck_dir = os.path.join(port_api.ctx.config.checkpoints_dir, "lm_t")
        steps = sorted(int(n) for n in os.listdir(ck_dir) if n.isdigit())
    finally:
        jax_api.ctx.close()
        port_api.ctx.close()
        jax_config.reset_config()
    assert got == want
    posts = [answer for answer in got if isinstance(answer[0], int)]
    assert len(posts) == 7 and all(answer[0] == 201 for answer in posts)
    tokens = [d["result"] for d in gen["result"] if "result" in d][0]
    # (3 + 64 tokens, cut to the small LM's max_len)
    assert np.asarray(tokens).shape == (1, 64) and tokens[0][:3] == \
        [101, 2023, 2003]
    # 48 windows of 64 tokens at batch 16: 3 steps an epoch, one step
    # dir per epoch
    assert steps == [3, 6, 9]
