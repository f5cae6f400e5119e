#!/usr/bin/env python3
"""Sweep of the wgmma backward kernels' narrow instances on one NVIDIA card.

    python3 scripts/sm90_bwd_narrow_sweep.py [variant ...]

``flash_bwd_dq_sm90.cu`` and ``flash_bwd_dkv_sm90.cu`` take head_dim
<= 32 in narrow instances (32-column tiles, n32 accumulators; the dQ
kernel computes delta and writes lse and delta by head for dK/dV). This
script builds text-substituted copies of both sources under
``build/variants/`` (the package's sources are not touched):

- ``old``: head_dim <= 32 routed back through the 64-column instance
  (``NB = 1``), the design before the narrow instances, driven as it was
  (``_bwd_delta`` and ``_by_head`` around the kernels);
- ``s<stages>g<warpgroups><n|p>[r]``: the narrow instances with that
  ring depth (``kNStages``), consumer warpgroups (``kNWarpgroups``: 64 q
  rows or keys each, with their register budgets), a grid of one block
  per item (``n``) or one persistent block per SM (``p``,
  ``kNPersistent``); ``r``: dQ's S and dP with Q and dO as register
  fragments (``kNRegA``). ``<dq>+<dkv>`` builds the dQ source as the
  first and the dK/dV source as the second. ``s2g3pr+s2g3n`` is the
  package's own.

A variant name may end in a diagnostic: ``-xexp``, ``-xsplit``,
``-xgemm``: the narrow kernels without their exp2s, their hi + lo
splits, or their gradient products; ``-xss``: those products' A operand
read from shared memory (a resident tile) in place of the register
fragments, which therefore need not be ready. Those compute wrong
gradients, are not checked, and are timed only, to show what each part
costs.

Each variant's ptxas report (registers, spills, wgmma serialization
notes) is printed. Each variant is checked against
``flash_bwd_reference`` at chip_smoke.py's tolerances for the wgmma
backward (the derived bound of bf16 P and dS, and float32 order against
the plain version that splits P and dS as the kernels do), its lse and
delta by head against ``_by_head``, and two launches for bit equality,
on the classifier's layout and on causal, windowed, offset, ragged and
GQA cases at head_dim 8 to 32. Then every variant that passed is timed
with CUDA events in turns (every variant, then in reverse) at the
classifier's shape (bf16, b 128, 512 tokens, 8 heads over 4, d 32,
non-causal), and ``old`` against the package's at the training shape
(d 64: both run the unchanged wide instance). Last, the whole backward
at the classifier's shape (the kernels, delta, the transposes and the
casts to bf16), in turns: the old design's flow, the narrow kernels with
the old flow around them, the package's ``_flash_bwd``, beside SDPA's
backward under each backend. Prints the card's name and power limit
first, one JSON line per section. Needs a card and nvcc; exits 2
without a card, 1 if a variant fails to build or a check. The builds and
the timer are ``scripts/sm90_variants.py``'s.
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

SOURCES = ("flash_bwd_dq_sm90", "flash_bwd_dkv_sm90")
OLD = {"flash_bwd_dq_sm90": [("const bool narrow = d <= kNarrowCols;",
                              "const bool narrow = false;")],
       "flash_bwd_dkv_sm90": [("if (d <= kNarrowCols)\n    return (int)"
                               "launch_narrow", "if (false)\n    return "
                               "(int)launch_narrow")]}
PACKAGE = "s2g3pr+s2g3n"
VARIANTS = ("s2g3pr+s2g3n", "s2g3pr", "s2g3p+s2g3n", "s3g3pr+s3g3n",
            "s2g3nr+s2g3n", "s2g2pr+s2g2n", "s2g2nr+s2g2n")
# (b, sq, sk, h, kvh, d, causal, window, kv_offset, dlse)
CHECKS = [(16, 512, 512, 8, 4, 32, False, 0, 0, False),
          (2, 200, 200, 4, 2, 32, True, 48, 24, True),
          (2, 77, 201, 4, 2, 24, False, 0, 0, False),
          (2, 130, 130, 8, 2, 16, True, 0, 0, False),
          (1, 150, 150, 4, 2, 8, True, 32, 0, False)]
CLASSIFIER = (128, 512, 512, 8, 4, 32, False, 0, 0, False)
TRAINING = (8, 2048, 2048, 8, 4, 64, True, 1024, 0, False)
DQ_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float] \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]
DKV_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float] \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]


# timing-only diagnostics: a part of the narrow kernels' work replaced by
# nothing, defined after the header so that only the narrow kernels'
# calls change
DIAGNOSTICS = {
    "xexp": "#define ex2_ftz(x) (x)\n",
    "xsplit": "#define split_pair(a, b, h, l) ((h) = __float_as_uint(a), "
              "(l) = __float_as_uint(b))\n",
    "xgemm": "template <int T>\n__device__ __forceinline__ void rs_none("
             "float (&d)[16], const uint32_t (&a)[4], uint64_t) {\n"
             "  d[0] += __uint_as_float(a[0] ^ a[3]);\n}\n"
             "#define wgmma_rs_n32 rs_none\n",
    "xss": "__device__ __forceinline__ void sink(const uint32_t (&a)[4]) {\n"
           "  asm volatile(\"\" ::\"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), "
           "\"r\"(a[3]));\n}\n"
           "template <int T>\n__device__ __forceinline__ void wgmma_ss_n32("
           "float (&d)[16], uint64_t da, uint64_t db, int acc) {\n"
           "  asm volatile(\"{\\n.reg .pred p;\\nsetp.ne.b32 p, %18, 0;\\n"
           "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, "
           "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
           "%16, %17, p, 1, 1, 0, %19;\\n}\\n\"\n"
           "    : \"+f\"(d[0]), \"+f\"(d[1]), \"+f\"(d[2]), \"+f\"(d[3]), "
           "\"+f\"(d[4]), \"+f\"(d[5]), \"+f\"(d[6]), \"+f\"(d[7]), "
           "\"+f\"(d[8]), \"+f\"(d[9]), \"+f\"(d[10]), \"+f\"(d[11]), "
           "\"+f\"(d[12]), \"+f\"(d[13]), \"+f\"(d[14]), \"+f\"(d[15])\n"
           "    : \"l\"(da), \"l\"(db), \"r\"(acc), \"n\"(T));\n}\n"}
# per-source rewrites a diagnostic needs beside its definitions: the
# products with A from a resident tile of the right size
DIAGNOSTIC_CALLS = {"xss": {
    "flash_bwd_dq_sm90": [
        ("wgmma_rs_n32<1>(acc, ds_hi[kk], kb);",
         "sink(ds_hi[kk]); wgmma_ss_n32<1>(acc, desc_sw64(q_tile), kb, 1);"),
        ("wgmma_rs_n32<1>(acc, ds_lo[kk], kb);",
         "sink(ds_lo[kk]); wgmma_ss_n32<1>(acc, desc_sw64(q_tile), kb, 1);")],
    "flash_bwd_dkv_sm90": [
        (f"wgmma_rs_n32<1>({acc}, {frag}[kk], {b});",
         f"sink({frag}[kk]); wgmma_ss_n32<1>({acc}, desc_sw64(k_tile), {b}, "
         "1);")
        for acc, frag, b in (("acc_v", "p_hi", "b_do"),
                             ("acc_v", "p_lo", "b_do"),
                             ("acc_k", "ds_hi", "b_q"),
                             ("acc_k", "ds_lo", "b_q"))]}}

def _substitutions(name: str) -> dict:
    if name == "old":
        return OLD
    if "+" in name:
        dq_name, dkv_name = name.split("+")
        return {SOURCES[0]: _substitutions(dq_name)[SOURCES[0]],
                SOURCES[1]: _substitutions(dkv_name)[SOURCES[1]]}
    name, _, diag = name.partition("-")
    m = re.fullmatch(r"s(\d)g(\d)([np])(r?)", name)
    flags = {"kNStages": m.group(1), "kNWarpgroups": m.group(2),
             "kNPersistent": m.group(3) == "p"}
    subs = sv.set_constants(flags, SOURCES)
    # only dQ takes its resident operands as fragments
    subs[SOURCES[0]] += sv.set_constants({"kNRegA": bool(m.group(4))},
                                         SOURCES[:1])[SOURCES[0]]
    if diag:
        for src in SOURCES:
            subs[src].append(sv.after_header(DIAGNOSTICS[diag]))
            subs[src] += DIAGNOSTIC_CALLS.get(diag, {}).get(src, [])
    return subs


class Case:
    """Inputs of one shape, the forward's (o, lse) from the package's
    kernel, and launchers of each variant's kernels on them."""

    def __init__(self, torch, attn, shape, seed):
        (self.b, self.sq, self.sk, self.h, self.kvh, self.d, self.causal,
         self.window, self.offset, with_dlse) = shape
        self.torch, self.attn = torch, attn
        gen = torch.Generator(device="cuda").manual_seed(seed)

        def rand(*s):
            return torch.randn(*s, device="cuda", generator=gen) \
                .to(torch.bfloat16)

        b, sq, sk, h, kvh, d = (self.b, self.sq, self.sk, self.h, self.kvh,
                                self.d)
        self.q, self.k, self.v = rand(b, sq, h, d), rand(b, sk, kvh, d), \
            rand(b, sk, kvh, d)
        self.do = rand(b, sq, h, d)
        self.dlse = torch.randn(b, sq, h, device="cuda", generator=gen) \
            if with_dlse else None
        self.scale = 1.0 / d ** 0.5
        self.o, self.lse = attn._flash_fwd(self.q, self.k, self.v,
                                           self.causal, self.scale,
                                           self.window, self.offset)
        self.delta = attn._bwd_delta(self.o, self.do, self.dlse)
        self.rows = attn._head_rows(sq)
        self.stream = torch.cuda.current_stream().cuda_stream
        self.dq = torch.empty(self.q.shape, device="cuda")
        self.dk = torch.empty(self.k.shape, device="cuda")
        self.dv = torch.empty(self.v.shape, device="cuda")
        self.by_head = [torch.empty((b, h, self.rows), device="cuda")
                        for _ in range(2)]

    def _dims(self):
        return (self.b, self.sq, self.sk, self.h, self.kvh, self.d,
                self.rows, self.scale, int(self.causal), self.window,
                self.offset, self.stream)

    def dq_fold(self, fn):
        """The narrow dQ as the package's backward launches it."""
        dlse = self.dlse.data_ptr() if self.dlse is not None else None
        err = fn(self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                 self.do.data_ptr(), self.o.data_ptr(), self.lse.data_ptr(),
                 dlse, None, self.dq.data_ptr(), self.by_head[0].data_ptr(),
                 self.by_head[1].data_ptr(), *self._dims())
        if err:
            raise RuntimeError(f"dq launch failed: CUDA error {err}")

    def dq_delta(self, fn):
        """dQ given delta, as the wide instances take it."""
        err = fn(self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                 self.do.data_ptr(), None, self.lse.data_ptr(), None,
                 self.delta.data_ptr(), self.dq.data_ptr(), None, None,
                 *self._dims())
        if err:
            raise RuntimeError(f"dq launch failed: CUDA error {err}")

    def by_head_old(self):
        """lse and delta by head as the wrapper makes them for the wide
        instances."""
        self.by_head = [self.attn._by_head(self.lse, self.rows),
                        self.attn._by_head(self.delta, self.rows)]

    def dkv(self, fn):
        err = fn(self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                 self.do.data_ptr(), self.by_head[0].data_ptr(),
                 self.by_head[1].data_ptr(), self.dk.data_ptr(),
                 self.dv.data_ptr(), *self._dims())
        if err:
            raise RuntimeError(f"dkv launch failed: CUDA error {err}")

    def run(self, name, pair):
        """(dq, dk, dv) of one variant, launched as its design is."""
        if name == "old":
            self.dq_delta(pair[0])
            self.by_head_old()
        else:
            self.dq_fold(pair[0])
        self.dkv(pair[1])
        return self.dq.clone(), self.dk.clone(), self.dv.clone()


def _check(torch, attn, cs, case, name, pair) -> dict:
    got = case.run(name, pair)
    by_head = [t.clone() for t in case.by_head]
    again = case.run(name, pair)
    torch.cuda.synchronize()
    out = {"bitEqual": all(torch.equal(a, b) for a, b in zip(got, again))}
    lse_t = attn._by_head(case.lse, case.rows)
    delta_t = attn._by_head(case.delta, case.rows)
    out["byHeadLseEqual"] = torch.equal(by_head[0], lse_t)
    out["byHeadDeltaUsed"] = ((by_head[1] - delta_t).abs()
                              / (1e-5 * delta_t.abs().max().item()
                                 + 1e-5 * delta_t.abs())).max().item()
    want = attn.flash_bwd_reference(
        case.q, case.k, case.v, case.o, case.lse, case.do, case.dlse,
        causal=case.causal, scale=case.scale, window=case.window,
        kv_offset=case.offset)
    split = cs._split_bwd(torch, attn, case.q, case.k, case.v, case.o,
                          case.lse, case.do, case.dlse, case.causal,
                          case.scale, case.window, case.offset)
    for part, g, w, e, bound in zip(("dq", "dk", "dv"), got, want,
                                    split[:3], split[3:]):
        floor = 1e-4 * w.abs().max().item()
        out[part] = {
            "derivedBoundUsed": ((g - w).abs() / (2.0 ** -8 * bound + floor))
            .max().item(),
            "splitEmulationUsed": ((g - e).abs() / (floor + 1e-4 * e.abs()))
            .max().item()}
    if case.offset:
        empty = case.lse == attn.NEG_INF
        out["emptyRowsZero"] = bool(empty.any()) and bool(
            (got[0][empty] == 0).all())
    out["ok"] = out["bitEqual"] and out["byHeadLseEqual"] \
        and out["byHeadDeltaUsed"] <= 1.0 \
        and out.get("emptyRowsZero", True) and all(
            out[p]["derivedBoundUsed"] <= 1.0
            and out[p]["splitEmulationUsed"] <= 1.0
            for p in ("dq", "dk", "dv"))
    del want, split
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sm90_bwd_narrow_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from learningorchestra_tpu_torch.ops import _build
    from learningorchestra_tpu_torch.ops import attention as attn

    print(sv.device_line(), flush=True)
    names = sys.argv[1:] or ["old", *VARIANTS]
    for name in (n for n in ("old", PACKAGE) if n not in names):
        names.append(name)
    _build.build(["flash_fwd_sm90", *SOURCES])
    fns, failed = sv.build(_build, {n: _substitutions(n) for n in names},
                           dict(zip(SOURCES, (DQ_ARGS, DKV_ARGS))))
    fns = {n: tuple(f[s] for s in SOURCES) for n, f in fns.items()}
    for name, why in failed.items():
        print(f"variant {name} failed to build: {why}", flush=True)

    checks = {}
    for i, shape in enumerate(CHECKS):
        case = Case(torch, attn, shape, seed=10 + i)
        for name, pair in fns.items():
            if "-x" in name:
                continue
            checks.setdefault(name, []).append(
                dict(_check(torch, attn, cs, case, name, pair),
                     shape=list(shape)))
        del case
        torch.cuda.empty_cache()
    for name, results in checks.items():
        print(f"check {name} " + json.dumps(results), flush=True)
        if not all(r["ok"] for r in results):
            failed[name] = "check"
    timed = [n for n in fns if n not in failed]

    case = Case(torch, attn, CLASSIFIER, seed=1)
    pairs = int(cs._visible_mask(torch, case.sq, case.sk, case.causal,
                                 case.window, case.offset, "cuda").sum()) \
        * case.b * case.h
    # lse and delta by head as the wrapper makes them for the wide
    # instances; the narrow dQ writes the same into these buffers
    case.by_head_old()
    dq_launch = {n: case.dq_delta if n == "old" else case.dq_fold
                 for n in timed}
    result = sv.in_turns(
        torch, cs, {n: {"dqMs": lambda n=n: dq_launch[n](fns[n][0]),
                        "dkvMs": lambda n=n: case.dkv(fns[n][1])}
                    for n in timed}, timed + timed[::-1])
    clock = cs._sm_clock_mhz()
    print("classifier " + json.dumps({
        "shape": list(CLASSIFIER), "visiblePairs": pairs, **clock,
        "boundExpMs": cs._exp_bound_ms(pairs, clock["smClockMaxMhz"]),
        "variants": result}), flush=True)

    # the whole backward: the old design's flow, the narrow kernels with
    # the old flow around them, and the package's _flash_bwd, each with
    # its casts to bf16
    old, new = fns.get("old"), fns.get(PACKAGE)
    flows = {}
    if old:
        def parent_flow():
            case.delta = attn._bwd_delta(case.o, case.do, None)
            case.dq_delta(old[0])
            case.by_head_old()
            case.dkv(old[1])
            return case.dq.to(torch.bfloat16), case.dk.to(torch.bfloat16), \
                case.dv.to(torch.bfloat16)
        flows["oldDesign"] = parent_flow
    if new:
        def narrow_old_flow():
            case.delta = attn._bwd_delta(case.o, case.do, None)
            case.dq_delta(new[0])
            case.by_head_old()
            case.dkv(new[1])
            return case.dq.to(torch.bfloat16), case.dk.to(torch.bfloat16), \
                case.dv.to(torch.bfloat16)
        flows["narrowKernelsOldGlue"] = narrow_old_flow

    def package_flow():
        dq, dk, dv = attn._flash_bwd(case.q, case.k, case.v, case.o,
                                     case.lse, case.do, None, case.causal,
                                     case.scale, case.window, case.offset)
        return dq.to(torch.bfloat16), dk.to(torch.bfloat16), \
            dv.to(torch.bfloat16)
    flows["package"] = package_flow
    whole = sv.in_turns(torch, cs, flows, list(flows) + list(flows)[::-1])
    sdpa = cs._sdpa_times(torch, case.q, case.k, case.v, case.do,
                          case.causal, case.window, case.offset, case.scale)
    print("wholeBackward " + json.dumps({
        "shape": list(CLASSIFIER), "ms": whole, "sdpa": sdpa}), flush=True)
    del case
    torch.cuda.empty_cache()

    if old and new:
        case = Case(torch, attn, TRAINING, seed=2)
        case.by_head_old()
        train = sv.in_turns(
            torch, cs, {n: {"dqMs": lambda n=n: case.dq_delta(fns[n][0]),
                            "dkvMs": lambda n=n: case.dkv(fns[n][1])}
                        for n in ("old", PACKAGE)},
            ["old", PACKAGE, PACKAGE, "old"])
        print("training " + json.dumps({"shape": list(TRAINING),
                                        "variants": train}), flush=True)
    if failed:
        print(f"failed: {json.dumps(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
