"""The PyTorch port stands alone: importing every module of
``learningorchestra_tpu_torch`` loads neither JAX nor any module of the
JAX package, and ``chip_smoke.py`` refuses to run without a card."""

import os
import pkgutil
import subprocess
import sys

import learningorchestra_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import learningorchestra_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "learningorchestra_tpu"))
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
    assert int(count) == expected >= 14
    assert bad == "[]"


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        env={**_env(), "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
