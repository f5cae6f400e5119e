"""The PyTorch port stands alone: importing every module of
``learningorchestra_tpu_torch`` (the msgpack codec, the checkpointer and
its asynchronous commit, the encoder, the fault injector, the mixture of experts, the keras-shaped
layers, the sweeps, the client, the sandbox, the function service, the
lint, the Builder, its estimators, the booster core's binding, the
CSV core's and the tree and SGD cores' among them) loads
neither JAX, flax nor any module of the JAX package, nor pandas,
pyarrow, dill, msgpack, sklearn, matplotlib, seaborn, h5py, keras,
tensorflow or tf_keras (the card's machine has none of the first four,
and the others only where they happen to be installed: the explore route
imports matplotlib and seaborn inside its job, the keras readers and
writers h5py and keras inside the calls that need them), the tensorflow
shim's layers, optimizers and losses load no torch, and
``chip_smoke.py`` refuses to run without a card; and no source of the
port imports sklearn anywhere (the Builder's families are the port's
own)."""

import os
import pkgutil
import re
import subprocess
import sys

import learningorchestra_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
# the card's machine lacks these: any import of one fails here (torch's
# own optional imports of them tolerate that)
for absent in ("pandas", "pyarrow", "dill", "msgpack", "sklearn",
               "matplotlib", "seaborn", "h5py", "keras", "tensorflow",
               "tf_keras"):
    sys.modules[absent] = None
import learningorchestra_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                     "learningorchestra_tpu", "pandas",
                                     "pyarrow", "dill", "msgpack",
                                     "sklearn", "matplotlib",
                                     "seaborn", "h5py", "keras",
                                     "tensorflow", "tf_keras"))
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
    """The msgpack codec, the checkpointer and its asynchronous commit,
    the encoder, the fault injector, the mixture of experts, the
    keras-shaped layer stack, ResNet-50, the sweeps, the fused engine
    and the card's fair lease are imported by the probe above (none of
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
            "learningorchestra_tpu_torch.models.sweep",
            "learningorchestra_tpu_torch.client",
            "learningorchestra_tpu_torch.services.sandbox",
            "learningorchestra_tpu_torch.services.function_service",
            "learningorchestra_tpu_torch.analysis",
            "learningorchestra_tpu_torch.analysis.findings",
            "learningorchestra_tpu_torch.analysis.code_lint",
            "learningorchestra_tpu_torch.analysis.preflight",
            "learningorchestra_tpu_torch.runtime.preempt",
            "learningorchestra_tpu_torch.runtime.health",
            "learningorchestra_tpu_torch.services.cache",
            "learningorchestra_tpu_torch.services.columnar",
            "learningorchestra_tpu_torch.services.database_executor",
            "learningorchestra_tpu_torch.services.builder_service",
            "learningorchestra_tpu_torch.models.estimators",
            "learningorchestra_tpu_torch.native",
            "learningorchestra_tpu_torch.native.hgb",
            "learningorchestra_tpu_torch.native.ops",
            "learningorchestra_tpu_torch.models.tf_bundle",
            "learningorchestra_tpu_torch.models.weights_io",
            "learningorchestra_tpu_torch.models.tf_compat",
            "learningorchestra_tpu_torch.models.tf_compat.keras",
            "learningorchestra_tpu_torch.models.tf_compat.keras.layers",
            "learningorchestra_tpu_torch.models.tf_compat.keras.losses",
            "learningorchestra_tpu_torch.models.tf_compat.keras.optimizers",
            "learningorchestra_tpu_torch.models.tf_compat.keras.models",
            "learningorchestra_tpu_torch.models.tf_compat.keras.applications",
            "learningorchestra_tpu_torch.runtime.async_ckpt",
            "learningorchestra_tpu_torch.runtime.engine",
            "learningorchestra_tpu_torch.runtime.locks",
            "learningorchestra_tpu_torch.services.scheduler",
            "learningorchestra_tpu_torch.native.trees",
            "learningorchestra_tpu_torch.native.sgd",
            "learningorchestra_tpu_torch.models.trees",
            "learningorchestra_tpu_torch.models.linear",
            } <= names


# an import of sklearn anywhere in a source line: a statement at any
# depth (a job-time import inside a function too) or a dynamic import
_SKLEARN_IMPORT = re.compile(
    r"^\s*(import\s+sklearn\b|from\s+sklearn\b)|"
    r"(import_module|__import__)\(\s*[\"']sklearn\b", re.M)


def test_no_source_of_the_port_imports_sklearn():
    """The card's machine has no sklearn: no module of the port imports
    it, also not inside a function, where the probe above, which only
    imports the modules, would not see it."""
    package = os.path.join(ROOT, "learningorchestra_tpu_torch")
    offenders, scanned = [], 0
    for folder, _, files in os.walk(package):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(folder, name)
            with open(path, encoding="utf-8") as f:
                text = f.read()
            scanned += 1
            for match in _SKLEARN_IMPORT.finditer(text):
                line = text.count("\n", 0, match.start()) + 1
                offenders.append(f"{os.path.relpath(path, ROOT)}:{line}")
    assert scanned >= 80
    assert offenders == []
    assert _SKLEARN_IMPORT.search("def f():\n    from sklearn.tree import "
                                  "DecisionTreeClassifier\n")
    assert _SKLEARN_IMPORT.search("importlib.import_module('sklearn.svm')")
    assert not _SKLEARN_IMPORT.search("# sklearn's defaults\n")


OBSERVABILITY = ("export", "hist", "incidents", "monitor", "perf", "slo",
                 "timeline", "trace", "xray")


def test_observability_modules_are_among_those_probed():
    """The observability package (the counterparts of the JAX package's
    nine ``observability/`` modules and its ``__init__``) and every
    module hooked into it are imported by the probe above, so none of
    them loads JAX or the JAX package."""
    names = {m.name for m in pkgutil.walk_packages(
        learningorchestra_tpu_torch.__path__,
        learningorchestra_tpu_torch.__name__ + ".")}
    port = "learningorchestra_tpu_torch."
    assert {port + "observability." + m for m in OBSERVABILITY} | {
        port + "observability",
        port + "runtime.engine", port + "runtime.checkpoint",
        port + "runtime.health", port + "services.jobs",
        port + "services.execution", port + "services.context",
        port + "services.serving", port + "services.server",
    } <= names
    jax_side = {m.name.rsplit(".", 1)[-1] for m in pkgutil.iter_modules(
        [os.path.join(ROOT, "learningorchestra_tpu", "observability")])}
    assert jax_side == set(OBSERVABILITY)


_LIGHT = """
import sys
import learningorchestra_tpu_torch.client
import learningorchestra_tpu_torch.services.sandbox
print(sorted(m for m in ("torch", "pandas", "numpy") if m in sys.modules))
"""


def test_client_and_sandbox_import_without_torch():
    """The client is standard library, and the sandbox's child boots on
    the sandbox module alone: neither loads torch or pandas (a function
    job pays for torch only when its code imports it)."""
    out = subprocess.run([sys.executable, "-c", _LIGHT], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_SHIM = """
import sys
import learningorchestra_tpu_torch.models.tf_compat as tensorflow
from learningorchestra_tpu_torch.models.tf_compat.keras import (
    layers, losses, optimizers)
specs = [layers.Dense(16).config, optimizers.Adam(0.05).spec,
         losses.SparseCategoricalCrossentropy.spec,
         tensorflow.keras.layers.Conv2D(4).config["kind"]]
print(sorted(m for m in ("torch", "numpy") if m in sys.modules), len(specs))
"""


def test_the_shim_specs_import_no_torch():
    """``tensorflow``, ``tensorflow.keras`` and its layers, optimizers and
    losses load neither torch nor numpy (a ``#`` expression builds them in
    the sandbox's child, which pays no torch import for it)."""
    out = subprocess.run([sys.executable, "-c", _SHIM], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] 4"


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        env={**_env(), "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
