#!/usr/bin/env python3
"""Sweep of the wgmma forward kernel's narrow instance on one NVIDIA card.

    python3 scripts/sm90_fwd_narrow_sweep.py [--shape B,SQ,SK,H,KVH,D]
        [variant ...]

``flash_fwd_sm90.cu`` takes head_dim <= 32 in a narrow instance
(32-column tiles, P.V into m64n32 accumulators, a persistent grid). This
script builds text-substituted copies of the source under
``build/variants/`` (the package's source is not touched):

- ``old``: head_dim <= 32 routed back through the 64-column instance
  (``launch<1>``), the design before the narrow instance;
- ``s<stages>g<warpgroups>k<keys>``: the narrow instance with that K/V
  ring depth (``kFStages``), consumer warpgroups (``kFWarpgroups``: 64
  q rows each, with their register budgets) and keys per tile
  (``kFBlockN``, 64 or 128). ``s4g4k64`` is the package's own.

A variant name may end in diagnostics (one or more): ``-xexp``,
``-xsplit``, ``-xpv``, ``-xsoft``: the narrow kernel without its exp2s,
without its hi + lo splits, without its P.V products, or without its
whole softmax (maxima, exp2s and sums; the scores go to P as they
are). Those compute wrong outputs, are not checked, and are timed only,
to show what each part costs.

Each variant's ptxas report (registers, spills, wgmma serialization
notes) is printed. Each real variant is checked against
``flash_attention_reference`` at chip_smoke.py's tolerances for the
wgmma forward (the derived bound of bf16 P, and float32 order against the
plain version that splits P as the kernel does; lse within 2e-5, rows
with no visible key at o = 0 and lse = -1e30) and two launches for bit
equality, on the classifier's layout and on causal, windowed, offset,
ragged, GQA and MQA cases at head_dim 8 to 32, one with more work items
than the card has SMs. Then every variant that passed is timed with CUDA
events in turns (every variant, then in reverse, twice) at the
classifier's shape (bf16, b 128, 512 tokens, 8 heads over 4, d 32,
non-causal; or the non-causal ``--shape``), beside SDPA's forward under
each backend, and ``old`` against the package's at the training shape
(d 64: both run the unchanged wide instance). Prints the card's name and
power limit first, one JSON line per section. Needs a card and nvcc;
exits 2 without a card, 1 if a variant fails to build or a check. The
builds and the timer are ``scripts/sm90_variants.py``'s.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import sm90_variants as sv  # noqa: E402  (beside this script)

SOURCE = "flash_fwd_sm90"
OLD = [("if (d <= kNarrowCols)\n    return (int)launch_narrow",
        "if (false)\n    return (int)launch_narrow")]
PACKAGE = "s4g4k64"
# with no variant named: these, the package's with each diagnostic, and
# old
VARIANTS = ("s4g4k64", "s3g4k64", "s6g4k64", "s4g3k64", "s3g2k128",
            "s4g4k64-xexp", "s4g4k64-xsplit", "s4g4k64-xpv",
            "s4g4k64-xsoft", "s4g4k64-xsoft-xsplit-xpv")
# (b, sq, sk, h, kvh, d, causal, window, kv_offset)
CHECKS = [(16, 512, 512, 8, 4, 32, False, 0, 0),
          (2, 200, 200, 4, 4, 32, True, 48, 24),
          (2, 77, 201, 4, 4, 24, False, 0, 0),
          (2, 130, 130, 8, 1, 16, True, 0, 0),
          (1, 150, 150, 4, 4, 8, True, 32, 0),
          # more work items (256 at 256 q rows) than the card has SMs
          (16, 384, 384, 8, 2, 32, True, 128, 0)]
CLASSIFIER = (128, 512, 512, 8, 4, 32, False, 0, 0)
TRAINING = (8, 2048, 2048, 8, 4, 64, True, 1024, 0)
ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]

# timing-only diagnostics: a part of the narrow kernel's work replaced by
# nothing, defined after the header so that only the narrow kernel's
# calls change (the wide instance calls exp2f, split_fragment, wgmma_rs)
DIAGNOSTICS = {
    "xexp": "#define ex2_ftz(x) (x)\n",
    "xsplit": "#define split_pair(a, b, h, l) ((h) = __float_as_uint(a), "
              "(l) = __float_as_uint(b))\n",
    "xpv": "template <int T>\n__device__ __forceinline__ void pv_none("
           "float (&d)[16], const uint32_t (&a)[4], uint64_t) {\n"
           "  d[0] += __uint_as_float(a[0] ^ a[3]);\n}\n"
           "#define wgmma_rs_n32 pv_none\n"}
# diagnostics made by rewriting the narrow kernel's calls
DIAGNOSTIC_CALLS = {
    "xsoft": ("softmax_tile(sc, m, l, alpha, scale_log2);",
              "alpha[0] = alpha[1] = 1.f;")}
FLAGS = {"kFStages": 1, "kFWarpgroups": 2, "kFBlockN": 3}


def _substitutions(name: str) -> dict:
    if name == "old":
        return {SOURCE: OLD}
    name, *diags = name.split("-")
    m = re.fullmatch(r"s(\d)g(\d)k(64|128)", name)
    if not m:
        raise ValueError(f"not a variant name: {name}")
    subs = sv.set_constants({k: m.group(i) for k, i in FLAGS.items()},
                            [SOURCE])
    if diags:
        subs[SOURCE].append(sv.after_header(
            "".join(DIAGNOSTICS.get(x, "") for x in diags)))
        subs[SOURCE] += [DIAGNOSTIC_CALLS[x] for x in diags
                         if x in DIAGNOSTIC_CALLS]
    return subs


class Case:
    """Inputs of one shape and a launcher of any variant's kernel on
    them."""

    def __init__(self, torch, shape, seed):
        (self.b, self.sq, self.sk, self.h, self.kvh, self.d, self.causal,
         self.window, self.offset) = shape
        gen = torch.Generator(device="cuda").manual_seed(seed)

        def rand(*s):
            return torch.randn(*s, device="cuda", generator=gen) \
                .to(torch.bfloat16)

        b, sq, sk, h, kvh, d = (self.b, self.sq, self.sk, self.h, self.kvh,
                                self.d)
        self.q, self.k, self.v = rand(b, sq, h, d), rand(b, sk, kvh, d), \
            rand(b, sk, kvh, d)
        self.scale = 1.0 / d ** 0.5
        self.o = torch.empty_like(self.q)
        self.lse = torch.empty((b, sq, h), device="cuda")
        self.stream = torch.cuda.current_stream().cuda_stream

    def launch(self, fn):
        err = fn(self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                 self.o.data_ptr(), self.lse.data_ptr(), self.b, self.sq,
                 self.sk, self.h, self.kvh, self.d, self.scale,
                 int(self.causal), self.window, self.offset, self.stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")


def _check(torch, attn, cs, case, fn) -> dict:
    case.launch(fn)
    got = (case.o.clone(), case.lse.clone())
    case.launch(fn)
    torch.cuda.synchronize()
    out = {"bitEqual": torch.equal(got[0], case.o)
           and torch.equal(got[1], case.lse)}
    o, lse = got
    ro, rlse = attn.flash_attention_reference(
        case.q, case.k, case.v, causal=case.causal, scale=case.scale,
        window=case.window, kv_offset=case.offset)
    out["derivedBoundUsed"], out["splitEmulationUsed"] = cs._sm90_fwd_used(
        torch, attn, o, ro, case.q, case.k, case.v, case.causal, case.scale,
        case.window, case.offset)
    seen = rlse != attn.NEG_INF
    out["emptyRowsEqual"] = torch.equal(seen, lse != attn.NEG_INF)
    out["lseMaxAbsErr"] = (lse - rlse)[seen].abs().max().item()
    out["emptyRows"] = int((~seen).sum())
    if case.offset:
        out["emptyRowsZero"] = bool((~seen).any()) and bool(
            (o[~seen] == 0).all())
    out["ok"] = out["bitEqual"] and out["emptyRowsEqual"] \
        and out["lseMaxAbsErr"] <= 2e-5 \
        and out.get("emptyRowsZero", True) \
        and out["derivedBoundUsed"] <= 1.0 \
        and out["splitEmulationUsed"] <= 1.0
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sm90_fwd_narrow_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from learningorchestra_tpu_torch.ops import _build
    from learningorchestra_tpu_torch.ops import attention as attn

    print(sv.device_line(), flush=True)
    args = sys.argv[1:]
    timing_shape = CLASSIFIER
    if "--shape" in args:
        i = args.index("--shape")
        timing_shape = (*map(int, args[i + 1].split(",")), False, 0, 0)
        del args[i:i + 2]
    names = args or ["old", *VARIANTS]
    for name in (n for n in ("old", PACKAGE) if n not in names):
        names.append(name)
    fns, failed = sv.build(_build, {n: _substitutions(n) for n in names},
                           {SOURCE: ARGS})
    fns = {n: f[SOURCE] for n, f in fns.items()}
    for name, why in failed.items():
        print(f"variant {name} failed to build: {why}", flush=True)

    checks = {}
    for i, shape in enumerate(CHECKS):
        case = Case(torch, shape, seed=10 + i)
        for name, fn in fns.items():
            if "-x" in name:
                continue
            checks.setdefault(name, []).append(
                dict(_check(torch, attn, cs, case, fn), shape=list(shape)))
        del case
        torch.cuda.empty_cache()
    for name, results in checks.items():
        print(f"check {name} " + json.dumps(results), flush=True)
        if not all(r["ok"] for r in results):
            failed[name] = "check"
    timed = [n for n in fns if n not in failed]

    case = Case(torch, timing_shape, seed=1)
    pairs = int(cs._visible_mask(torch, case.sq, case.sk, case.causal,
                                 case.window, case.offset, "cuda").sum()) \
        * case.b * case.h
    result = sv.in_turns(torch, cs, {n: lambda n=n: case.launch(fns[n])
                                     for n in timed},
                         2 * (timed + timed[::-1]))
    sdpa = cs._sdpa_times(torch, case.q, case.k, case.v, None, case.causal,
                          case.window, case.offset, case.scale)
    clock = cs._sm_clock_mhz()
    print("classifier " + json.dumps({
        "shape": list(timing_shape), "visiblePairs": pairs, **clock,
        "boundMs": 4.0 * case.d * pairs / cs.PEAK_FLOPS["bfloat16"] * 1e3,
        "boundSplitMs": 6.0 * case.d * pairs / cs.PEAK_FLOPS["bfloat16"]
        * 1e3,
        "boundExpMs": cs._exp_bound_ms(pairs, clock["smClockMaxMhz"]),
        "ms": result, "sdpaForwardMs": sdpa["forwardMs"],
        "sdpaForwardBackend": sdpa["forwardBackend"],
        "sdpaBackends": {k: f.get("forwardMs", f.get("error"))
                         for k, f in sdpa["figures"].items()}}), flush=True)
    del case
    torch.cuda.empty_cache()

    if "old" in timed and PACKAGE in timed:
        case = Case(torch, TRAINING, seed=2)
        train = sv.in_turns(torch, cs,
                            {n: lambda n=n: case.launch(fns[n])
                             for n in ("old", PACKAGE)},
                            2 * ["old", PACKAGE, PACKAGE, "old"])
        print("training " + json.dumps({"shape": list(TRAINING),
                                        "ms": train}), flush=True)
    if failed:
        print(f"failed: {json.dumps(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
