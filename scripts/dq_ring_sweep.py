#!/usr/bin/env python3
"""Ring-depth sweep of the tensor-core dQ kernel on one NVIDIA card.

    python3 scripts/dq_ring_sweep.py

Builds variants of ``learningorchestra_tpu_torch/csrc/flash_bwd_dq_sm90.cu``
that differ only in the depth of the mbarrier ring that streams K and V
(``kStages``), each from a text-substituted copy under
``build/variants/`` (the source in the package is not touched). Each
variant is checked against ``flash_bwd_reference`` (it fails the run
outside the float32 tolerance) and timed with CUDA
events at the training path's shape (b 8, 2048 tokens, 8 heads over 4 kv
heads, d 64, causal, window 1024) and at a small causal shape, in turns
(every variant, then every variant again in reverse order). Prints the
card's name and power limit, ptxas's spill report per variant, and one
JSON line per shape. Needs a card and nvcc; exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (name, ring stages); the package's own is 2
VARIANTS = [("s2", 2), ("s3", 3), ("s4", 4)]
SHAPES = [(8, 2048, 8, 4, 64, True, 1024), (2, 300, 4, 2, 64, True, 0)]


def _build_variants(_build) -> dict:
    src = (_build.CSRC / "flash_bwd_dq_sm90.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, stages in VARIANTS:
        text = src.replace("constexpr int kStages = 2;",
                           f"constexpr int kStages = {stages};")
        cu = out_dir / f"dq_{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
               str(out_dir / f"dq_{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        spills = [line.strip() for line in (out + err).splitlines()
                  if "spill" in line]
        print(f"ptxas {name}: {spills}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{err}")
        fn = ctypes.CDLL(str(out_dir / f"dq_{name}.so")).lo_flash_bwd_dq_sm90
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def _time_ms(torch, fn, iters: int = 50) -> float:
    for _ in range(5):
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dq_ring_sweep: no CUDA device", file=sys.stderr)
        return 2
    from learningorchestra_tpu_torch.ops import _build
    from learningorchestra_tpu_torch.ops import attention as attn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"device: {smi.stdout.strip()}", flush=True)
    fns = _build_variants(_build)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen) \
            .to(torch.bfloat16)

    for b, s, h, kvh, d, causal, window in SHAPES:
        q, k, v, do = rand(b, s, h, d), rand(b, s, kvh, d), \
            rand(b, s, kvh, d), rand(b, s, h, d)
        scale = 1.0 / d ** 0.5
        o, lse = attn._flash_fwd(q, k, v, causal, scale, window, 0)
        delta = attn._bwd_delta(o, do, None)
        want = attn.flash_bwd_reference(q, k, v, o, lse, do, None,
                                        causal=causal, scale=scale,
                                        window=window)[0]
        stream = torch.cuda.current_stream().cuda_stream

        def launch(fn, dq):
            return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(), b, s, s, h,
                              kvh, d, scale, int(causal), window, 0, stream)

        result = {}
        for name, fn in fns.items():
            dq = torch.full(q.shape, float("nan"), device="cuda")
            if launch(fn, dq)() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            # float32 summation-order tolerance, as chip_smoke.py holds
            # the split-emulating plain version (1e-4 max |g| + 1e-4 |g|)
            tol = 1e-4 * want.abs().max().item() + 1e-4 * want.abs()
            used = ((dq - want).abs() / tol).max().item()
            if not used <= 1.0:
                raise AssertionError(f"{name}: dq exceeds the tolerance "
                                     f"{used}x")
            result[name] = {"tolUsed": used, "ms": []}
        dq = torch.empty(q.shape, device="cuda")
        for name in list(fns) + list(reversed(fns)):
            result[name]["ms"].append(_time_ms(torch, launch(fns[name], dq)))
        print(json.dumps({"shape": [b, s, h, kvh, d, causal, window],
                          "variants": result}), flush=True)
        del q, k, v, do, o, lse, delta, want, dq
    return 0


if __name__ == "__main__":
    sys.exit(main())
