"""The PyTorch port stands alone: importing every module of
``learningorchestra_tpu_torch`` (the msgpack codec, the checkpointer, the
encoder, the fault injector, the mixture of experts, the keras-shaped
layers and the sweeps among them) loads
neither JAX, flax nor any module of the JAX package, nor pandas,
pyarrow, dill or msgpack (the card's machine has none of them), and
``chip_smoke.py`` refuses to run without a card."""

import os
import pkgutil
import subprocess
import sys

import learningorchestra_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
# the card's machine lacks these: any import of one fails here (torch's
# own optional imports of them tolerate that)
for absent in ("pandas", "pyarrow", "dill", "msgpack"):
    sys.modules[absent] = None
import learningorchestra_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                     "learningorchestra_tpu", "pandas",
                                     "pyarrow", "dill", "msgpack"))
print(len(names), bad)
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    expected = len(list(pkgutil.walk_packages(
        learningorchestra_tpu_torch.__path__,
        learningorchestra_tpu_torch.__name__ + ".")))
    assert int(count) == expected >= 30
    assert bad == "[]"


def test_new_modules_are_among_those_probed():
    """The msgpack codec, the checkpointer, the encoder, the fault
    injector, the mixture of experts, the keras-shaped layer stack,
    ResNet-50 and the sweeps are imported by the probe above (none of
    them may import msgpack, flax or the JAX package's copy of
    itself)."""
    names = {m.name for m in pkgutil.walk_packages(
        learningorchestra_tpu_torch.__path__,
        learningorchestra_tpu_torch.__name__ + ".")}
    assert {"learningorchestra_tpu_torch.runtime.serialization",
            "learningorchestra_tpu_torch.runtime.checkpoint",
            "learningorchestra_tpu_torch.models.encoder",
            "learningorchestra_tpu_torch.services.faults",
            "learningorchestra_tpu_torch.parallel",
            "learningorchestra_tpu_torch.parallel.moe",
            "learningorchestra_tpu_torch.models.neural",
            "learningorchestra_tpu_torch.models.sequential_module",
            "learningorchestra_tpu_torch.models.resnet",
            "learningorchestra_tpu_torch.models.sweep"} <= names


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        env={**_env(), "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
