"""The port's sandbox (``learningorchestra_tpu_torch/services/sandbox.py``)
against the escapes ``tests/test_sandbox_jail.py`` holds the JAX jail to,
each in the mode that test covers, plus what the port adds: ``import jax``
is refused with its message and ``import tensorflow`` is the port's shim,
a child that imports torch sees no card, the store is unreadable from the
jail, and the AST lint gives the JAX lint's findings for the code both
packages take.

The cases of the tensorflow shim's ``#`` spec objects (their crossing of
the subprocess boundary, the result unpickler's class allowlist) are in
``tests/test_torch_keras.py``.
"""

import dataclasses
import pickle

import numpy as np
import pytest

from learningorchestra_tpu.analysis import code_lint as jax_lint
from learningorchestra_tpu_torch.analysis import code_lint
from learningorchestra_tpu_torch.catalog.store import Table
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services import sandbox


@pytest.fixture()
def cfg(tmp_path):
    return Config(home=str(tmp_path / "lo_home"))


def _run(code, cfg, parameters=None, mode="subprocess", lint=True,
         **kwargs):
    return sandbox.run_user_code(code, parameters, mode=mode, lint=lint,
                                 config=cfg, **kwargs)


def test_jail_normal_code_and_stdout(cfg):
    g, out = _run(
        "import numpy as np\n"
        "print('computed')\n"
        "response = {'x': np.arange(6, dtype='float32').reshape(2, 3)}\n",
        cfg)
    assert g["response"]["x"].shape == (2, 3)
    assert g["response"]["x"].dtype == np.float32
    assert "computed" in out


def test_jail_dataframe_params_cross_boundary(cfg):
    import pandas as pd

    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    g, _ = _run(
        "response = {'vals': frame['a'].to_numpy() * 2,"
        " 'frame': frame[frame['a'] > 1]}",
        cfg, {"frame": df})
    assert list(g["response"]["vals"]) == [2, 4, 6]
    assert list(g["response"]["frame"]["b"]) == ["y", "z"]
    assert list(g["response"]["frame"].index) == [1, 2]


def test_catalog_table_reaches_code_as_a_dataframe_only_when_asked(cfg):
    """The function route passes ``dataframes=True``: a ``Table`` becomes
    a DataFrame with the Table's dtypes, in the child and in process;
    without it the code gets the ``Table``."""
    table = Table({"i": np.arange(3, dtype=np.int64),
                   "f": np.array([1.5, np.nan, 2.0]),
                   "s": np.array(["a", None, "c"], dtype=object)}, 3)
    code = ("response = [type(t).__name__, t['i'].dtype.str,"
            " t['f'].dtype.str, len(t)]")
    for mode in ("subprocess", "restricted"):
        got = _run(code, cfg, {"t": table}, mode=mode,
                   dataframes=True)[0]["response"]
        assert got == ["DataFrame", "<i8", "<f8", 3]
        got = _run(code, cfg, {"t": table}, mode=mode)[0]["response"]
        assert got == ["Table", "<i8", "<f8", 3]
    g, _ = _run("response = t.dropna(subset=['f'])", cfg, {"t": table},
                dataframes=True)
    assert list(g["response"]["i"]) == [0, 2]
    assert list(g["response"]["s"]) == ["a", "c"]


def test_jail_blocks_passwd_read_via_pandas(cfg):
    with pytest.raises(PermissionError, match="denied"):
        _run("import pandas as pd\n"
             "response = pd.read_csv('/etc/passwd')\n", cfg)


def test_jail_blocks_passwd_read_via_numpy(cfg):
    with pytest.raises(PermissionError, match="denied"):
        _run("import numpy as np\n"
             "response = np.loadtxt('/etc/passwd', dtype=str)\n", cfg)


_LOADER = ("cls = [c for c in ().__class__.__base__.__subclasses__()"
           " if c.__name__ == 'BuiltinImporter'][0]\n")


def test_jail_blocks_dunder_escape_to_os_system(cfg, tmp_path):
    marker = tmp_path / "pwned"
    code = (_LOADER + "os = cls().load_module('os')\n"
            f"response = os.system('touch {marker}')\n")
    with pytest.raises(PermissionError, match="os.system"):
        _run(code, cfg, lint=False)
    assert not marker.exists()


def test_jail_blocks_ctypes_ffi_escape(cfg, tmp_path):
    """ctypes bypasses the audit hook (raw libc calls fire no events):
    the interpreter's own symbols do not open, and a library of the
    interpreter's tree, which loads (``import torch`` loads one), yields
    no symbol."""
    import numpy._core._multiarray_umath as umath

    marker = tmp_path / "escape_ctypes"
    for lib in ("None", repr(umath.__file__)):
        code = (_LOADER + "ct = cls().load_module('ctypes')\n"
                f"libc = ct.CDLL({lib})\n"
                f"response = libc.system(b'touch {marker}')\n")
        with pytest.raises(PermissionError, match="ctypes"):
            _run(code, cfg, lint=False)
        assert not marker.exists()


def test_jail_batched_hash_exprs_are_distinct_objects(cfg):
    """One child evaluates the batch; equal texts still give distinct
    objects."""
    a, b = sandbox.eval_hash_expressions(
        ["#[{'kind': 'dense', 'units': 2}]",
         "#[{'kind': 'dense', 'units': 2}]"], mode="subprocess", config=cfg)
    assert a is not b
    assert a == b == [{"kind": "dense", "units": 2}]


def test_jail_blocks_write_outside_scratch(cfg, tmp_path):
    target = tmp_path / "leak.npy"
    code = (_LOADER + "io_mod = cls().load_module('io')\n"
            f"f = io_mod.open('{target}', 'w')\n"
            "f.write('x')\n"
            "response = 1\n")
    with pytest.raises(PermissionError, match="denied"):
        _run(code, cfg, lint=False)
    assert not target.exists()


def test_jail_blocks_rename_out_of_scratch(cfg, tmp_path):
    target = tmp_path / "renamed_out"
    for fn in ("os_mod.rename", "os_mod.replace"):
        code = (_LOADER + "io_mod = cls().load_module('io')\n"
                "os_mod = cls().load_module('os')\n"
                "f = io_mod.open('inside.txt', 'w')\n"
                "f.write('x')\n"
                "f.close()\n"
                f"{fn}('inside.txt', '{target}')\n"
                "response = 1\n")
        with pytest.raises(PermissionError, match="denied"):
            _run(code, cfg, lint=False)
        assert not target.exists()


def test_jail_blocks_symlink_and_link_out(cfg, tmp_path):
    target = tmp_path / "linked_out"
    for call in (f"os_mod.link('inside.txt', '{target}')",
                 f"os_mod.symlink('inside.txt', '{target}')"):
        code = (_LOADER + "io_mod = cls().load_module('io')\n"
                "os_mod = cls().load_module('os')\n"
                "f = io_mod.open('inside.txt', 'w')\n"
                "f.write('x')\n"
                "f.close()\n"
                f"{call}\n"
                "response = 1\n")
        with pytest.raises(PermissionError, match="denied"):
            _run(code, cfg, lint=False)
        assert not target.exists()


def test_jail_keeps_the_store_unreadable_even_under_sys_path(tmp_path):
    """The store (``Config.home``) lies under a ``sys.path`` root here, as
    ``./.lo_store`` does under a server started from its checkout: the
    jail still refuses to read it."""
    home = tmp_path / "root" / "store"
    home.mkdir(parents=True)
    (home / "secret.txt").write_text("s3cret")
    cfg = Config(home=str(home))
    import sys

    sys.path.append(str(tmp_path / "root"))
    try:
        with pytest.raises(PermissionError, match="denied"):
            _run("import numpy as np\n"
                 f"response = np.loadtxt('{home}/secret.txt', dtype=str)",
                 cfg)
    finally:
        sys.path.remove(str(tmp_path / "root"))


def test_jail_dropped_vars_surface_reason(cfg):
    g, _ = _run("class Foo:\n"
                "    pass\n"
                "response = Foo()\n", cfg)
    assert "response" in g.get(sandbox.DROPPED_KEY, [])
    err = sandbox.missing_variable_error(
        g, "response", "function must assign a 'response' variable")
    assert isinstance(err, TypeError)
    assert "response" in str(err) and "restricted" in str(err)


def test_jail_import_allowlist_still_applies(cfg):
    with pytest.raises(ImportError):
        _run("import os\nresponse = 1", cfg, lint=False)
    with pytest.raises(ImportError):
        _run("import subprocess\nresponse = 1", cfg, lint=False)


@pytest.mark.parametrize("mode", ["subprocess", "restricted"])
def test_jax_and_tensorflow_imports_are_refused_with_their_messages(
        cfg, mode):
    with pytest.raises(ImportError,
                       match="'jax' is not allowed in sandboxed code"):
        _run("import jax\nresponse = 1", cfg, mode=mode, lint=False)
    # tensorflow and keras are the port's shim, as the JAX package maps
    # them to its own
    for stmt, name in (("import tensorflow", "tensorflow.__version__"),
                       ("from tensorflow import keras",
                        "keras.layers.Dense(3).config['units']"),
                       ("import keras", "keras.losses.MeanSquaredError.spec"),
                       ("import tensorflow.keras.layers",
                        "tensorflow.keras.layers.Flatten().config['kind']")):
        g, _ = _run(f"{stmt}\nresponse = {name}", cfg, mode=mode)
        assert g["response"] == {
            "import tensorflow": "2.0-learningorchestra-torch",
            "from tensorflow import keras": 3,
            "import keras": "mean_squared_error",
            "import tensorflow.keras.layers": "flatten"}[stmt]


def test_child_that_imports_torch_sees_no_card(cfg):
    g, _ = _run(
        "import torch\n"
        "import learningorchestra_tpu_torch.models\n"
        "response = [torch.cuda.is_available(), torch.__version__,"
        " float(torch.ones(3).sum())]\n", cfg)
    available, version, total = g["response"]
    assert available is False and total == 3.0
    assert type(version) is str
    # the child's environment hides every card
    g, _ = _run(_LOADER + "posix = cls().load_module('posix')\n"
                "response = posix.environ.get(b'CUDA_VISIBLE_DEVICES')\n",
                cfg, lint=False)
    assert g["response"] == b""


def test_jail_hash_dsl_returns_values(cfg):
    value = sandbox.eval_hash_expression("#2 ** 7", mode="subprocess",
                                         config=cfg)
    assert value == 128 and type(value) is int
    layers = sandbox.eval_hash_expression(
        "#[{'kind': 'dense', 'units': u} for u in (4, 2)]",
        mode="restricted", config=cfg)
    assert layers == [{"kind": "dense", "units": 4},
                      {"kind": "dense", "units": 2}]


def test_jail_runtime_errors_propagate_with_type(cfg):
    with pytest.raises(ValueError, match="boom"):
        _run("raise ValueError('boom')", cfg)


def test_numpy_scalars_and_str_subclasses_cross_the_boundary(cfg):
    g, _ = _run("import numpy as np\n"
                "class Version(str):\n"
                "    pass\n"
                "response = [np.float64(0.5), np.int32(3), Version('2.1')]\n",
                cfg)
    half, three, version = g["response"]
    assert half == 0.5 and half.dtype == np.float64
    assert three == 3 and three.dtype == np.int32
    assert version == "2.1" and type(version) is str


def test_restricted_unpickler_blocks_gadgets():
    class Evil:
        def __reduce__(self):
            return (print, ("gadget-fired",))

    raw = pickle.dumps({"vars": {"response": Evil()}, "stdout": ""})
    with pytest.raises(pickle.UnpicklingError, match="may not reference"):
        sandbox._safe_load_envelope(raw)
    with pytest.raises(pickle.UnpicklingError):
        sandbox._safe_load_envelope(pickle.dumps(sandbox.run_user_code))
    # no class of the port resolves either
    with pytest.raises(pickle.UnpicklingError, match="may not reference"):
        sandbox._safe_load_envelope(pickle.dumps(Table({}, 0)))
    ok = {"vars": {"response": [1, (2, 3), b"x"]}, "stdout": ""}
    assert sandbox._safe_load_envelope(pickle.dumps(ok)) == ok


def test_stored_model_through_function_capability_seam(cfg):
    """A stored model as a ``$`` parameter: the default subprocess jail
    fails the job with a pointer at the escalation path, a request's
    ``sandboxMode: "restricted"`` within the operator's ceiling runs it in
    process, and ``trusted`` above the ceiling is a 406 at POST."""
    from learningorchestra_tpu_torch.models.neural import NeuralModel
    from learningorchestra_tpu_torch.services import validators as V
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.function_service import (
        FunctionService)

    ctx0 = ServiceContext(cfg, device="cpu")
    try:
        with pytest.raises(V.HttpError) as exc0:
            FunctionService(ctx0).create({
                "name": "no_opt_in", "function": "response = 1",
                "functionParameters": {}, "sandboxMode": "restricted"})
        assert exc0.value.status == V.HTTP_NOT_ACCEPTABLE
    finally:
        ctx0.close()

    ctx = ServiceContext(dataclasses.replace(
        cfg, home=cfg.home + "2", sandbox_max_mode="restricted"),
        device="cpu")
    try:
        model = NeuralModel([{"kind": "dense", "units": 2,
                              "activation": "softmax"}], device="cpu")
        model._build_params(np.zeros((1, 4), np.float32))
        ctx.catalog.create_collection("stored_model", "model/tensorflow",
                                      {})
        ctx.artifacts.save(model, "stored_model", "model/tensorflow")
        ctx.catalog.mark_finished("stored_model")
        fs = FunctionService(ctx)
        code = "response = float(model.num_params())"

        fs.create({"name": "live_default", "function": code,
                   "functionParameters": {"model": "$stored_model"}})
        ctx.jobs.wait("live_default", timeout=120)
        docs = ctx.catalog.get_documents("live_default")
        errs = [d.get("exception") for d in docs if d.get("exception")]
        assert errs and "restricted" in errs[0] and "TypeError" in errs[0]

        fs.create({"name": "live_restricted", "function": code,
                   "functionParameters": {"model": "$stored_model"},
                   "sandboxMode": "restricted"})
        ctx.jobs.wait("live_restricted", timeout=120)
        assert ctx.catalog.get_metadata("live_restricted")["finished"]
        result = ctx.artifacts.load("live_restricted", "function/python")
        assert result == float(model.num_params())

        with pytest.raises(V.HttpError) as exc:
            fs.create({"name": "live_trusted", "function": code,
                       "functionParameters": {"model": "$stored_model"},
                       "sandboxMode": "trusted"})
        assert exc.value.status == V.HTTP_NOT_ACCEPTABLE
        assert "ceiling" in exc.value.message
    finally:
        ctx.close()


def test_jail_function_service_end_to_end(cfg):
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.function_service import (
        FunctionService)

    ctx = ServiceContext(cfg, device="cpu")
    try:
        assert ctx.config.sandbox_mode == "subprocess"
        fs = FunctionService(ctx)
        fs.create({"name": "evil_read",
                   "function": "import pandas as pd\n"
                               "response = pd.read_csv('/etc/passwd')",
                   "functionParameters": {}})
        ctx.jobs.wait("evil_read", timeout=120)
        assert ctx.catalog.get_metadata("evil_read")["finished"] is False
        docs = ctx.catalog.get_documents("evil_read")
        assert any("PermissionError" in (d.get("exception") or "")
                   for d in docs)
    finally:
        ctx.close()


# the runtime guards hold with the lint off: names built at run time are
# invisible to the AST pass
def test_restricted_getattr_blocks_dynamic_dunder_smuggle(cfg):
    with pytest.raises(AttributeError, match="blocked"):
        _run("name = '__cl' + 'ass__'\n"
             "response = getattr((), name)\n", cfg, mode="restricted",
             lint=False)


def test_restricted_setattr_blocks_dunder_smuggle(cfg):
    with pytest.raises(AttributeError, match="blocked"):
        _run("class Foo:\n"
             "    pass\n"
             "setattr(Foo, '__getattr' + '__', lambda s, n: n)\n"
             "response = 1\n", cfg, mode="restricted", lint=False)


def test_restricted_vars_blocks_dict_access(cfg):
    with pytest.raises(TypeError, match="blocked"):
        _run("class Foo:\n"
             "    pass\n"
             "response = vars(Foo)\n", cfg, mode="restricted", lint=False)


def test_restricted_guards_allow_normal_attribute_use(cfg):
    g, _ = _run("import math\n"
                "response = getattr(math, 'pi')\n"
                "class Box:\n"
                "    pass\n"
                "b = Box()\n"
                "setattr(b, 'x', 3)\n"
                "response = response + b.x\n", cfg, mode="restricted",
                lint=False)
    assert g["response"] > 6


def test_subprocess_jail_also_blocks_dynamic_dunder_smuggle(cfg):
    with pytest.raises(AttributeError, match="blocked"):
        _run("name = '__subcl' + 'asses__'\n"
             "response = getattr((), '__class__', None) or "
             "getattr((), name)\n", cfg, lint=False)


# ----------------------------------------------------------------------
# the AST lint against the JAX package's
# ----------------------------------------------------------------------
LINT_CASES = {
    "clean": "import numpy as np\nresponse = np.ones(3)",
    "syntax": "response = (",
    "forbidden import": "import os\nimport subprocess as sp",
    "relative import": "from . import x",
    "forbidden calls": "open('/etc/passwd')\neval('1')\nexec('x=1')",
    "dunder attribute": "response = ().__class__.__bases__",
    "string smuggle": "getattr((), '__class__')\nsetattr(o, '__dict__', 1)",
    "dynamic name": "getattr((), '__cl' + 'ass__')",
    "allowed imports": "import pandas, sklearn.linear_model, scipy\n"
                       "from collections import OrderedDict",
    "shim imports": "import tensorflow\nimport keras.layers\n"
                    "from tensorflow.keras import optimizers",
}


@pytest.mark.parametrize("mode", ["subprocess", "restricted", "trusted"])
@pytest.mark.parametrize("case", list(LINT_CASES))
def test_lint_findings_equal_the_jax_lint(case, mode):
    code = LINT_CASES[case]
    got = [f.to_dict() for f in code_lint.lint_code(code, mode=mode)]
    want = [f.to_dict() for f in jax_lint.lint_code(code, mode=mode)]
    assert got == want


def test_lint_refuses_what_the_port_cannot_import():
    """``torch`` and the shim's ``tensorflow`` pass where ``jax`` does
    not (the JAX lint passes ``jax`` and its own shim's ``tensorflow``)."""
    rules = {n: [f.rule for f in code_lint.lint_code(f"import {n}")]
             for n in ("torch", "learningorchestra_tpu_torch.models",
                       "jax", "tensorflow", "learningorchestra_tpu")}
    assert rules == {"torch": [], "learningorchestra_tpu_torch.models": [],
                     "jax": ["forbidden-import"],
                     "tensorflow": [],
                     "learningorchestra_tpu": ["forbidden-import"]}
    assert [f.rule for f in jax_lint.lint_code("import jax")] == []
