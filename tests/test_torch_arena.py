"""The port's device arena (``learningorchestra_tpu_torch/runtime/arena.py``)
against the JAX package's ``runtime/arena.py``.

Each case replays one sequence of operations on a JAX arena (numpy
arrays, as the JAX package's tests/test_feature_cache.py drives it) and
on the port's (torch tensors on the CPU) and requires equal stats: hits,
misses, evictions, invalidations, entries, pins and groups. Bytes are
compared within each package only (``bytesInUse`` against the sizes the
sequence staged). The cases are the JAX tests' arena cases — the LRU
skips pinned readers, an all-pinned arena degrades to no eviction,
invalidation keeps in-flight tensors, a zero budget disables caching —
plus group budgets, the build race, the default arena's budget and
reset, the X-ray mirror and the port's ``discard``.
"""

import threading

import numpy as np
import pytest
import torch

from learningorchestra_tpu import config as jax_config
from learningorchestra_tpu.runtime import arena as jax_arena
from learningorchestra_tpu_torch import observability as obs
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.observability import xray
from learningorchestra_tpu_torch.runtime import arena

# stats both packages keep; bytes differ by what a "block" is in each
COUNTS = ("entries", "pins", "hits", "misses", "evictions",
          "invalidations", "groups")


def _block(kind, n=250):
    """A 1000-byte float32 block: numpy for the JAX arena, a CPU tensor
    for the port's."""
    if kind == "jax":
        return {"x": np.ones(n, np.float32)}
    return {"x": torch.ones(n, dtype=torch.float32)}


def _pair(budget):
    return {"jax": jax_arena.DeviceArena(budget),
            "port": arena.DeviceArena(budget)}


def _counts(a):
    s = a.stats()
    return {k: s[k] for k in COUNTS}


def _same(arenas):
    assert _counts(arenas["jax"]) == _counts(arenas["port"])


def _sum(entry) -> float:
    x = entry.arrays["x"]
    return float(x.sum())


def test_lru_eviction_skips_pinned_readers():
    arenas = _pair(3000)
    pinned = {}
    for kind, a in arenas.items():
        pinned[kind] = a.get_or_put("k1", lambda k=kind: _block(k),
                                    tags=("c1",))
        for key in ("k2", "k3", "k4"):
            a.get_or_put(key, lambda k=kind: _block(k),
                         tags=(key.replace("k", "c"),)).release()
    _same(arenas)
    for kind, a in arenas.items():
        s = a.stats()
        assert s["evictions"] == 1 and s["bytesInUse"] == 3000
        # k1 was the LRU candidate but is pinned: k2 went instead
        a.get_or_put("k1", lambda: pytest.fail("pinned entry was evicted")
                     ).release()
        assert _sum(pinned[kind]) == 250.0
        pinned[kind].release()
        pinned[kind].release()  # idempotent
    _same(arenas)
    assert arenas["port"].stats()["pins"] == 0


def test_all_pinned_degrades_to_no_eviction():
    arenas = _pair(1500)
    for kind, a in arenas.items():
        e1 = a.get_or_put("a", lambda k=kind: _block(k))
        e2 = a.get_or_put("b", lambda k=kind: _block(k))
        s = a.stats()
        assert s["bytesInUse"] == 2000 and s["evictions"] == 0
        e1.release(), e2.release()
        a.get_or_put("c", lambda k=kind: _block(k)).release()
        assert a.stats()["bytesInUse"] <= 1500
    _same(arenas)


def test_invalidate_keeps_inflight_arrays():
    arenas = _pair(1 << 20)
    for kind, a in arenas.items():
        build = ((lambda: {"x": np.arange(10)}) if kind == "jax" else
                 (lambda: {"x": torch.arange(10)}))
        entry = a.get_or_put(("k", 0), build, tags=("ds",))
        assert a.invalidate("ds") == 1
        assert a.stats()["entries"] == 0
        assert int(entry.arrays["x"].sum()) == 45
        entry.release()  # must not raise on the unlinked key
        a.get_or_put(("k", 0), build).release()
        assert a.stats()["misses"] == 2
    _same(arenas)


def test_zero_budget_disables_caching():
    arenas = _pair(0)
    for kind, a in arenas.items():
        e = a.get_or_put("k", lambda k=kind: _block(k, 4))
        assert _sum(e) == 4.0
        e.release()
        assert a.stats()["entries"] == 0
        assert a.get_or_put("k", lambda k=kind: _block(k, 4)).arrays
        assert a.stats()["hits"] == 0
    _same(arenas)


def test_oversized_entry_is_untracked():
    arenas = _pair(500)
    for kind, a in arenas.items():
        e = a.get_or_put("big", lambda k=kind: _block(k))
        assert a.stats()["bytesInUse"] == 0 and e.nbytes == 1000
        e.release()
    _same(arenas)


def test_group_budgets_evict_within_their_group():
    arenas = _pair(4000)
    for kind, a in arenas.items():
        a.get_or_put("g1", lambda k=kind: _block(k), group="half",
                     group_fraction=0.5).release()
        a.get_or_put("other", lambda k=kind: _block(k)).release()
        a.get_or_put("g2", lambda k=kind: _block(k), group="half",
                     group_fraction=0.5).release()
        # the half group holds 2000 of 4000: a third block evicts its
        # own oldest, never "other"
        a.get_or_put("g3", lambda k=kind: _block(k), group="half",
                     group_fraction=0.5).release()
        a.get_or_put("other", lambda: pytest.fail("evicted across groups")
                     ).release()
        s = a.stats()
        assert s["evictions"] == 1 and s["bytesInUse"] == 3000
    _same(arenas)


def test_invalidate_and_lru_sequence_matches_jax():
    """A longer mixed sequence: tags over several collections, pins held
    across invalidations and evictions, re-staging after a drop."""
    arenas = _pair(5000)
    held = {"jax": [], "port": []}
    for kind, a in arenas.items():
        for i in range(8):
            e = a.get_or_put(("fit", i % 5), lambda k=kind: _block(k),
                             tags=(f"ds{i % 3}", "shared"))
            if i % 4 == 0:
                held[kind].append(e)
            else:
                e.release()
        a.invalidate("ds1")
        for e in held[kind][:1]:
            e.release()
        for i in range(6):
            a.get_or_put(("fit", i), lambda k=kind: _block(k),
                         tags=(f"ds{i % 3}",)).release()
        a.invalidate("shared")
        for e in held[kind][1:]:
            e.release()
    _same(arenas)
    assert arenas["port"].stats()["pins"] == 0


def test_concurrent_misses_build_twice_and_keep_the_first():
    a = arena.DeviceArena(1 << 20)
    gate = threading.Barrier(4)
    built = []

    def build():
        gate.wait(timeout=10)
        built.append(1)
        return {"x": torch.full((8,), float(len(built)))}

    entries = []

    def reader():
        entries.append(a.get_or_put("k", build))

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    s = a.stats()
    assert len(built) == 4 and s["entries"] == 1 and s["misses"] == 4
    # every reader got the winner's tensors, each holding its own pin
    first = entries[0].arrays["x"]
    assert all(e.arrays["x"] is first for e in entries)
    assert s["pins"] == 4
    for e in entries:
        e.release()
    assert a.stats()["pins"] == 0


def test_discard_unlinks_one_entry_whatever_its_pins():
    a = arena.DeviceArena(1 << 20)
    e = a.get_or_put("session", lambda: _block("port"), tags=("lm",))
    a.get_or_put("other", lambda: _block("port"), tags=("lm",)).release()
    assert a.discard("session") is True and a.discard("session") is False
    assert _sum(e) == 250.0
    e.release()
    s = a.stats()
    assert s["entries"] == 1 and s["bytesInUse"] == 1000
    assert s["invalidations"] == 0


def test_residents_mirror_into_the_xray_ledger():
    a = arena.DeviceArena(1 << 20)
    before = xray.by_owner()["arena"]
    a.get_or_put(("k", 1), lambda: _block("port"), tags=("ds",)).release()
    assert xray.by_owner()["arena"] - before == 1000
    a.invalidate("ds")
    assert xray.by_owner()["arena"] == before
    a.get_or_put(("k", 2), lambda: _block("port")).release()
    a.clear()
    assert xray.by_owner()["arena"] == before


def test_auto_budget_is_a_gibibyte_for_cpu_tensors():
    a, b = arena.DeviceArena(None), jax_arena.DeviceArena(None)
    assert a.stats()["byteBudget"] is None
    a.get_or_put("k", lambda: _block("port")).release()
    assert a.stats()["byteBudget"] == 1 << 30
    # host arrays too (the JAX arena's fallback where a backend reports
    # no limit)
    assert arena._auto_budget({"x": np.ones(4)}) == 1 << 30
    b.get_or_put("k", lambda: _block("jax")).release()
    assert b.stats()["byteBudget"] > 0


def test_default_arena_follows_the_installed_config(tmp_path):
    try:
        obs.set_config(Config(home=str(tmp_path / "p"), arena_bytes=2048))
        jax_config.set_config(jax_config.Config(home=str(tmp_path / "j"),
                                                arena_bytes=2048))
        port, theirs = arena.get_default_arena(), \
            jax_arena.get_default_arena()
        assert port is arena.get_default_arena()
        assert port.stats()["byteBudget"] == \
            theirs.stats()["byteBudget"] == 2048
        port.get_or_put("k", lambda: _block("port")).release()
        assert xray.by_owner()["arena"] >= 1000
        # a config swap starts a new arena, as the JAX config reset does,
        # and the old one's residents leave the ledger
        obs.set_config(Config(home=str(tmp_path / "p"), arena_bytes=0))
        jax_config.set_config(jax_config.Config(home=str(tmp_path / "j"),
                                                arena_bytes=0))
        assert arena.get_default_arena() is not port
        assert arena.get_default_arena().stats()["byteBudget"] == \
            jax_arena.get_default_arena().stats()["byteBudget"] == 0
        assert port.stats()["entries"] == 0
        obs.reset_config()
        arena.reset_default_arena()
        assert arena.get_default_arena().stats()["byteBudget"] is None
    finally:
        obs.reset_config()
        jax_config.reset_config()


def test_config_reads_the_feature_plane_variables(monkeypatch):
    for env, field, value in (("LO_ARENA_BYTES", "arena_bytes", "4096"),
                              ("LO_PREFETCH_BUFFER", "prefetch_buffer", "5"),
                              ("LO_PARAM_CACHE", "param_cache_bytes", "77"),
                              ("LO_SCAN_FIT_MAX_BYTES",
                               "scan_fit_max_bytes", "0")):
        monkeypatch.delenv(env, raising=False)
        assert getattr(Config(home="unused"), field) == \
            getattr(jax_config.Config(), field)
        monkeypatch.setenv(env, value)
        assert getattr(Config(home="unused"), field) == \
            getattr(jax_config.Config(), field) == int(value)
