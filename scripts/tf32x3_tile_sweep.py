#!/usr/bin/env python3
"""Tile sweep of the split-TF32 (3xTF32) attention kernels on one
NVIDIA card.

    python3 scripts/tf32x3_tile_sweep.py [kernel ...]

Builds variants of ``learningorchestra_tpu_torch/csrc/flash_fwd_tf32x3.cu``,
``flash_bwd_dkv_tf32x3.cu`` and ``flash_bwd_dq_tf32x3.cu`` (all three,
or the ones named) that differ only in the rows of the streamed tile at
head_dim <= 64 (forward and dQ: keys per stage, ``kN``; dK/dV: q rows
per stage, ``kM``) and in the blocks per SM ptxas is told to fit
(``kMinBlocks`` in ``__launch_bounds__``, which caps the registers),
variants of how the dK/dV kernel keeps dV's and dK's long sums off the
tensor cores' accumulator (dV per k-step at width 64; runs of 1, 4, 8 or
16 q tiles), and one ``narrow`` variant that sends float32 rows at d % 4 == 0
through the any-width loads and pair stores (``kWide`` false) instead
of the 16-byte path, each from a text-substituted copy under
``build/variants/`` (the sources in the package are not touched). Each
variant is checked against its plain version
(``flash_attention_reference``, ``flash_bwd_reference``) at the
float32 tolerance (bf16 o: one bf16 ulp; it fails the run outside it)
and timed with CUDA events, in turns (every variant, then every variant
again in reverse order): the backward kernels at the training path's
shape (b 8, 2048 tokens, 8 heads over 4 kv heads, d 64, causal, window
1024) and at the d-12 LM's (b 2, d 12: the width-16 variants) in
float32, the dK/dV kernel also at d 128 (b 2), the forward at the training shape and at the serving
prefill's (b 1, 1536 tokens) in float32 and at the d-12 LM's in
float32 and bf16.
Prints the card's name and power limit, ptxas's registers and spills
per variant (the float32 d-64 and d-128 instances, and the width-16
float32 and bf16 ones), and one JSON line per kernel and shape. Needs a card and
nvcc; exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# kernel -> (the lines of the source that set the tile rows and the
# blocks per SM, their text with {rows} and {blocks}, variants of (name,
# rows at d <= 64, minimum blocks per SM at d <= 64[, further text
# replacements]), the shapes (b, s, h, kvh, d, causal, window, dtype) it
# is timed at); the package's own variant is the first of each
# pointer arguments of each entry point: q, k, v (and dO, lse, delta in
# the backward), then the outputs (o and lse, dq, or dk and dv)
POINTERS = {"flash_fwd_tf32x3": 5, "flash_bwd_dq_tf32x3": 7,
            "flash_bwd_dkv_tf32x3": 8}
TRAIN_SHAPE = (8, 2048, 8, 4, 64, True, 1024, "float32")
SERVE_SHAPE = (1, 1536, 8, 4, 64, True, 1024, "float32")
# the d-12 LM's micro-step: the width-16 variants
D12_SHAPE = (2, 2048, 8, 4, 12, True, 1024, "float32")
D12_BF16_SHAPE = D12_SHAPE[:-1] + ("bfloat16",)
# the entries' float32 launch without the 16-byte path
NARROW = {"dispatch<float, true>": "dispatch<float, false>"}
# the dK/dV kernel's accumulation: dV summed per k-step on the CUDA cores
# up to width 64 (the package stops at 32), and the run length
STEP_V64 = {"kStepV = DMAX <= 32;": "kStepV = DMAX <= 64;"}
RUN = "kRun = DMAX == 128 ? 4 : 8;"
# the widest variant (d 128) at the training path's sequence
D128_SHAPE = (2, 2048, 8, 4, 128, True, 1024, "float32")
# ptxas's instances reported per variant: float32 at width 64 (the wide
# one, or the narrow variant's) and the width-16 float32 and bf16 ones
INSTANCES = {"d64": "kernelIfLi64ELb1E", "d64narrow": "kernelIfLi64ELb0E",
             "d128": "kernelIfLi128ELb1E",
             "w16": "kernelIfLi16ELb1E", "w16narrow": "kernelIfLi16ELb0E",
             "w16bf16": "kernelI13__nv_bfloat16Li16ELb0E"}
KERNELS = {
    "flash_fwd_tf32x3": (
        ("static constexpr int kN = DMAX == 128 ? 32 : 64;",
         "static constexpr int kMinBlocks = 1;"),
        ("static constexpr int kN = DMAX == 128 ? 32 : {rows};",
         "static constexpr int kMinBlocks = DMAX == 128 ? 1 : {blocks};"),
        [("n64", 64, 1), ("narrow", 64, 1, NARROW), ("n32", 32, 1),
         ("n64b2", 64, 2), ("n32b3", 32, 3), ("n16", 16, 1), ("n32b2", 32, 2),
         ("n16b3", 16, 3)],
        (TRAIN_SHAPE, SERVE_SHAPE, D12_SHAPE, D12_BF16_SHAPE)),
    "flash_bwd_dkv_tf32x3": (
        ("static constexpr int kM = DMAX == 16 ? 64 : 32;",
         "static constexpr int kMinBlocks = 1;"),
        ("static constexpr int kM = DMAX == 128 ? 32 : {rows};",
         "static constexpr int kMinBlocks = DMAX == 128 ? 1 : {blocks};"),
        # the package's own: 64 rows at width 16, else 32
        [("m64at16", "DMAX == 16 ? 64 : 32", 1),
         ("narrow", "DMAX == 16 ? 64 : 32", 1, NARROW), ("m32", 32, 1),
         ("m64", 64, 1), ("m16b3", 16, 3), ("m16", 16, 1),
         # how dV and dK keep their long sums off the accumulator:
         # dV's fresh fragment at width 64 (32 or 24 rows a stage), and
         # the runs of q tiles summed there before their add to memory
         ("stepV64", "DMAX == 16 ? 64 : 32", 1, STEP_V64),
         ("stepV64m24", "DMAX == 16 ? 64 : 24", 1, STEP_V64),
         ("run4", "DMAX == 16 ? 64 : 32", 1, {RUN: "kRun = 4;"}),
         ("run16", "DMAX == 16 ? 64 : 32", 1,
          {RUN: "kRun = DMAX == 128 ? 4 : 16;"}),
         ("run1at128", "DMAX == 16 ? 64 : 32", 1,
          {RUN: "kRun = DMAX == 128 ? 1 : 8;"})],
        (TRAIN_SHAPE, D12_SHAPE, D128_SHAPE)),
    "flash_bwd_dq_tf32x3": (
        ("static constexpr int kN = 32;",
         "static constexpr int kMinBlocks = 1;"),
        ("static constexpr int kN = DMAX == 128 ? 32 : {rows};",
         "static constexpr int kMinBlocks = DMAX == 128 ? 1 : {blocks};"),
        [("n32", 32, 1), ("narrow", 32, 1, NARROW), ("n64", 64, 1),
         ("n16b3", 16, 3), ("n16", 16, 1)],
        (TRAIN_SHAPE, D12_SHAPE)),
}


def _build_variants(_build, kernels) -> dict:
    out_dir = _build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel in kernels:
        lines, templates, variants, _ = KERNELS[kernel]
        src = (_build.CSRC / f"{kernel}.cu").read_text()
        if not all(line in src for line in lines):
            raise RuntimeError(f"{kernel}: the tile lines have changed")
        for name, rows, blocks, *extra in variants:
            text = src
            for line, template in zip(lines, templates):
                text = text.replace(line, template.format(rows=rows,
                                                          blocks=blocks))
            for old, new in (extra[0] if extra else {}).items():
                if old not in text:
                    raise RuntimeError(f"{kernel} {name}: no {old!r}")
                text = text.replace(old, new)
            cu = out_dir / f"{kernel}_{name}.cu"
            cu.write_text(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
                   "-o", str(out_dir / f"{kernel}_{name}.so"), str(cu)]
            procs[(kernel, name)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
    fns = {}
    for (kernel, name), proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{kernel} {name}: nvcc exited "
                               f"{proc.returncode}\n{err}")
        # ptxas reports every instance; keep the float32 d 64 one (the
        # wide one, template <float, 64, true>, or the narrow variant's
        # <float, 64, false>) and the width-16 ones
        log = out + err
        narrow = "narrow" if name == "narrow" else ""
        keys = ("d64" + narrow, "w16" + narrow, "w16bf16") + \
            (() if narrow else ("d128",))
        report = {}
        for key in keys:
            tail = log[log.index(INSTANCES[key]):]
            report[key] = {
                "registers": int(re.search(r"Used (\d+) registers",
                                           tail).group(1)),
                "spillStores": int(re.search(r"(\d+) bytes spill stores",
                                             tail).group(1))}
        print(f"ptxas {kernel} {name}: {json.dumps(report)}", flush=True)
        fn = getattr(ctypes.CDLL(str(out_dir / f"{kernel}_{name}.so")),
                     f"lo_{kernel}")
        fn.restype = ctypes.c_int
        # every entry point takes a dtype code after the offset
        fn.argtypes = [ctypes.c_void_p] * POINTERS[kernel] \
            + [ctypes.c_int] * 6 + [ctypes.c_float] \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fns[(kernel, name)] = fn
    return fns


def _time_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _runner(torch, attn, kernel, shape, gen):
    """(run(fn), check()) for one kernel at one shape: run launches a
    variant's entry point on fresh inputs into its outputs, check holds
    the outputs to the plain version at the float32 tolerance (a bf16 o
    within one bf16 ulp)."""
    b, s, h, kvh, d, causal, window, dtype = shape
    dtype = getattr(torch, dtype)
    q, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(b, s, kvh, d, device="cuda", generator=gen)
            .to(dtype) for _ in range(2))
    scale = 1.0 / d ** 0.5
    stream = torch.cuda.current_stream().cuda_stream
    dims = (b, s, s, h, kvh, d, scale, int(causal), window, 0,
            attn._DTYPE_CODES[dtype], stream)
    if kernel == "flash_fwd_tf32x3":
        outs = [torch.empty_like(q), torch.empty(b, s, h, device="cuda")]
        ins = (q, k, v)
        ro, rlse = attn.flash_attention_reference(
            q, k, v, causal=causal, scale=scale, window=window)
        tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 \
            else dict(atol=1e-4, rtol=1e-2)

        def check():
            torch.testing.assert_close(outs[0].float(), ro.float(), **tol)
            torch.testing.assert_close(outs[1], rlse, atol=1e-4, rtol=0)
    else:
        # the forward kernel's (o, lse): contiguous, as the entry points
        # read them
        o, lse = attn._flash_fwd(q, k, v, causal, scale, window, 0)
        delta = attn._bwd_delta(o, do, None)
        ins = (q, k, v, do, lse, delta)
        want = attn.flash_bwd_reference(q, k, v, o, lse, do, None,
                                        causal=causal, scale=scale,
                                        window=window)
        dkv = "dkv" in kernel
        outs = [torch.empty_like(k), torch.empty_like(v)] if dkv \
            else [torch.empty_like(q)]
        refs = want[1:] if dkv else want[:1]

        def check():
            for got, ref in zip(outs, refs):
                torch.testing.assert_close(
                    got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())

    def run(fn):
        err = fn(*(t.data_ptr() for t in (*ins, *outs)), *dims)
        if err:
            raise RuntimeError(f"{kernel}: CUDA error {err}")

    return run, check


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tf32x3_tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    from learningorchestra_tpu_torch.ops import _build
    from learningorchestra_tpu_torch.ops import attention as attn

    kernels = sys.argv[1:] or list(KERNELS)
    unknown = [k for k in kernels if k not in KERNELS]
    if unknown:
        print(f"tf32x3_tile_sweep: unknown kernels {unknown}; known: "
              f"{list(KERNELS)}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"device: {smi.stdout.strip()}", flush=True)
    fns = _build_variants(_build, kernels)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for kernel in kernels:
        _, _, variants, shapes = KERNELS[kernel]
        names = [name for name, *_ in variants]
        for shape in shapes:
            run, check = _runner(torch, attn, kernel, shape, gen)
            for name in names:
                run(fns[(kernel, name)])
                torch.cuda.synchronize()
                check()
            times = {name: [] for name in names}
            for order in (names, names[::-1]):
                for name in order:
                    times[name].append(_time_ms(
                        torch, lambda: run(fns[(kernel, name)])))
            print(json.dumps({"kernel": kernel, "shape": list(shape),
                              "ms": times,
                              "meanMs": {n: sum(t) / len(t)
                                         for n, t in times.items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
