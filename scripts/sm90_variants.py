"""Text-substituted builds of the port's CUDA sources, for the sweeps.

``scripts/sm90_fwd_narrow_sweep.py`` and ``scripts/sm90_bwd_narrow_sweep.py``
declare their variants as ``{name: {source: substitutions}}``: for each
source (a file stem under ``learningorchestra_tpu_torch/csrc/``) a list of
``(old, new)`` pairs, where ``old`` is a string that must occur in the
source or a compiled pattern that must match it exactly once. ``build``
writes every variant's sources under ``build/variants/`` (the package's
sources are not touched), compiles them with one nvcc each, all started
together, prints their ptxas reports, refuses a build that spills, and
loads each entry point ``lo_<source>``. ``in_turns`` times the loaded
variants with CUDA events in a given order.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess

INCLUDE = '#include "sm90_common.cuh"\n'


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return f"device: {smi.stdout.strip()}"


def set_constants(values: dict, sources) -> dict:
    """Substitutions giving each ``constexpr int|bool NAME`` of
    ``values`` its value, in each of ``sources``."""
    subs = [(re.compile(rf"constexpr (int|bool) {k} = \w+;"),
             rf"constexpr \g<1> {k} = "
             + (str(v).lower() if isinstance(v, bool) else str(v)) + ";")
            for k, v in values.items()]
    return {src: list(subs) for src in sources}


def after_header(definitions: str) -> tuple:
    """The substitution that puts ``definitions`` right after the common
    header, in its namespace, where they shadow what the kernels call."""
    return (INCLUDE, INCLUDE + "namespace sm90 {\n" + definitions + "}\n")


def _substitute(text: str, subs, where: str) -> str:
    for old, new in subs:
        if isinstance(old, str):
            if old not in text:
                raise RuntimeError(f"{where}: {old!r} not found")
            text = text.replace(old, new)
        else:
            text, n = old.subn(new, text)
            if n != 1:
                raise RuntimeError(f"{where}: {old.pattern} {n} times")
    return text


def build(_build_mod, variants: dict, argtypes: dict) -> tuple:
    """Compile ``variants`` in parallel. Returns the loaded entry points
    ``{name: {source: fn}}`` (``fn.argtypes = argtypes[source]``) and the
    failures ``{name: why}``."""
    import chip_smoke as cs

    out_dir = _build_mod.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, sources in variants.items():
        for src, subs in sources.items():
            text = _substitute((_build_mod.CSRC / f"{src}.cu").read_text(),
                               subs, f"{name}: {src}.cu")
            cu = out_dir / f"{name}_{src}.cu"
            cu.write_text(text)
            cmd = [_build_mod._nvcc(), *_build_mod.NVCC_FLAGS,
                   f"-I{_build_mod.CSRC}", "-o",
                   str(out_dir / f"{name}_{src}.so"), str(cu)]
            procs[(name, src)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
    failed, report = {}, {}
    for (name, src), proc in procs.items():
        out, err = proc.communicate()
        report[f"{name}/{src}"] = {
            "kernels": cs._ptxas_report(out + err),
            "notes": [line.strip() for line in (out + err).splitlines()
                      if re.search(r"wgmma|serializ|warning", line)]}
        if proc.returncode != 0:
            failed[name] = err[-2000:]
        elif any(v.get("spillStores", 1) or v.get("spillLoads", 1)
                 for v in report[f"{name}/{src}"]["kernels"]):
            failed.setdefault(name, f"{src} spills")
    print("ptxas " + json.dumps(report), flush=True)
    fns = {}
    for name, sources in variants.items():
        if name in failed:
            continue
        fns[name] = {}
        for src in sources:
            fn = getattr(ctypes.CDLL(str(out_dir / f"{name}_{src}.so")),
                         f"lo_{src}")
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes[src]
            fns[name][src] = fn
    return fns, failed


def in_turns(torch, cs, runs: dict, order, iters: int = 50) -> dict:
    """Times ``runs[name]`` for every name of ``order``, in that order,
    with chip_smoke's CUDA-event timer. A run is one callable (its times
    a list) or ``{part: callable}``, timed part after part (its times
    ``{part: list}``)."""
    out = {}
    for name in order:
        run = runs[name]
        if callable(run):
            out.setdefault(name, []).append(
                cs._time_ms(torch, run, iters=iters))
            continue
        for part, fn in run.items():
            out.setdefault(name, {}).setdefault(part, []).append(
                cs._time_ms(torch, fn, iters=iters))
    return out
