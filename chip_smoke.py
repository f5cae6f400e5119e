#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

1. Builds every CUDA source of the port (one nvcc per source, started
   together) into build/kernels/.
2. Kernel phase: each hand-written kernel against its plain PyTorch
   version on the card — the forward at the serving prefill and the
   training shape, the backward kernels at the training shape (b 8,
   2048 tokens, 8 heads over 4 kv heads, window 1024), fp32 and bf16,
   every kernel at the d-12 LM's shape in both dtypes, and small edge
   cases (also at head dims 13 and 36) — with its time, the plain
   version's time, the least time the card could take (bound) and one
   PyTorch library call computing the same function, timed as a
   yardstick only. bf16 at a head_dim that is a multiple of 8 takes the
   wgmma tensor-core kernels (flash_fwd_sm90, flash_bwd_dq_sm90,
   flash_bwd_dkv_sm90); every other float32 or bf16 head_dim the
   split-TF32 tensor-core kernels (flash_fwd_tf32x3,
   flash_bwd_dq_tf32x3, flash_bwd_dkv_tf32x3). Each bf16 case of the
   wgmma route is held twice more: to the derived bound of bf16 P and dS
   against the float32 plain version, and tightly against the plain
   version with P and dS split into bf16 hi + lo as the kernels split
   them; each case of the split-TF32 route, float32 or bf16, against the
   plain version that splits every product 3xTF32 as the kernels do, at
   the float32 tolerance (a bf16 o within one bf16 ulp).
3. Serving path: a REST server on the card serving the tutorial's LM
   (vocab 32000, d_model 512, 8 layers, 8 heads over 4 kv heads, window
   1024, random weights from seed 0), four concurrent predicts of
   1100-1500-token prompts, 32 greedy tokens each, sent twice (cold,
   then warm), float32: every prefill layer runs flash_fwd_tf32x3 and
   nothing else. Each stream must equal the port's solo ``generate``;
   the prefill logits through the kernel must agree with the dense path.
4. Training path: ``LanguageModel.fit`` of the same LM from
   ``init_params(seed 0)`` on 64 windows of 2048 tokens of a
   cyclic-successor stream, batch 16, 2 epochs, grad_accum 2, bf16
   compute: the loss must be finite, fall, and stay within 1% of the
   first (CUDA-core) kernels' epoch losses, and the forward, dq and dK/dV must
   run once per layer and micro-batch, all three on the tensor-core
   route. A profiler window of 2 steps gives the kernels' time per step
   and the card's idle share. A float32 window of the same fit (2
   optimizer steps of 16 windows, grad_accum 2) runs the split-TF32
   kernels and reports its own step time and profile (the
   ``trainFloat32`` line). In float32 one micro-step's gradients
   through the kernels must match the dense path's, for the tutorial LM
   (split-TF32 kernels) and for a small LM with head_dim 12 (d_model
   96, 8 heads: the split-TF32 kernels' width-16 variants); the same
   small LM takes one bf16 micro-step through the same kernels.
   The trained artifact is then served over REST and must answer with
   its reloaded copy's ``generate``.

The kernel launch counts are zeroed just before each path and read
just after it.

Earlier lines print the card (nvidia-smi name and power limit), the
build time, ptxas's registers and spill bytes of every kernel variant
(a tensor-core variant, sm90 or tf32x3, that spills fails the run),
the ``kernels`` JSON
line and the phases' lines; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises and
the exit code is not 0. Without a card, or without the package beside
it, the script exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request

PREFIX = "/api/learningOrchestra/v1"
# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, bf16 and TF32 on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
LM_CONFIG = dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=8,
                 n_kv_heads=4, d_ff=0, max_len=2048, sliding_window=1024,
                 rope_base=10000.0)
PROMPT_LENS = (1100, 1234, 1367, 1500)
NEW_TOKENS = 32
# a small LM whose head_dim (96 / 8 = 12) is not a multiple of 8: both
# passes run the split-TF32 kernels' width-16 variants, in either dtype
D12_CONFIG = dict(LM_CONFIG, d_model=96, n_layers=2)
# the training path: 64 windows of 2048 tokens, batch 16, 2 epochs,
# grad_accum 2 -> 8 optimizer steps of 2 micro-batches
TRAIN_WINDOWS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_ACCUM = \
    64, 2048, 16, 2, 2
# each kernel (one per CUDA source) and the counter its wrapper adds one
# to at each launch
COUNTERS = {"flash_fwd_sm90": "FLASH_FWD_SM90_LAUNCHES",
            "flash_bwd_dq_sm90": "FLASH_BWD_DQ_SM90_LAUNCHES",
            "flash_bwd_dkv_sm90": "FLASH_BWD_DKV_SM90_LAUNCHES",
            "flash_fwd_tf32x3": "FLASH_FWD_TF32X3_LAUNCHES",
            "flash_bwd_dq_tf32x3": "FLASH_BWD_DQ_TF32X3_LAUNCHES",
            "flash_bwd_dkv_tf32x3": "FLASH_BWD_DKV_TF32X3_LAUNCHES"}
# epoch losses of the train phase's fit through the first, CUDA-core
# kernels (bf16; PERF.md), which the tensor-core route must stay within
# 1% of
CUDA_CORE_LOSSES = (8.82798957824707, 3.2666094303131104)


def _reset_launches(attn) -> None:
    for counter in COUNTERS.values():
        setattr(attn, counter, 0)


def _launches(attn) -> dict:
    """Launches of each kernel (one per CUDA source) since the reset."""
    return {name: getattr(attn, counter)
            for name, counter in COUNTERS.items()}


def _kernel_name(mangled: str) -> str:
    """``flash_bwd_dq_tf32x3_kernel<bf16,16,0>`` from ptxas's mangled
    name (types, ints, and bools as 0 or 1)."""
    m = re.search(r"(?<=\d)(flash_\w*?_kernel)I(.+?)EEv", mangled)
    if not m:
        return mangled
    args = [n or b or ("bf16" if bf else "float") for n, b, bf, _ in
            re.findall(r"Li(\d+)E|Lb(\d)|(13__nv_bfloat16)|(f)",
                       m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def _ptxas_report(log: str) -> list:
    """Registers and spill bytes of each kernel variant in ``nvcc
    -Xptxas=-v`` output."""
    out = []
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            out.append({"kernel": _kernel_name(m.group(1))})
        elif out and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[-1].update(spillStores=int(m.group(1)),
                           spillLoads=int(m.group(2)))
        elif out and (m := re.search(r"Used (\d+) registers", line)):
            out[-1]["registers"] = int(m.group(1))
    return out


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


def _visible_mask(torch, sq, sk, causal, window, offset, device):
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= row >= col + offset
    if window > 0:
        mask &= col + offset > row - window
    return mask


def _split_fwd(torch, attn, q, k, v, causal, scale, window, offset):
    """The plain forward with the weights exp(s - m) split into bf16 hi
    + lo before the product with v, as flash_fwd_sm90 multiplies them,
    and each element's bound term sum_j p_j |v_j| / l. float32, (b, sq,
    h, d) each."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    valid = attn._visible(sq, sk, causal, window, offset, q.device)
    s = torch.where(valid, s, attn.NEG_INF)
    e = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    del s
    l = e.sum(dim=-1, keepdim=True)
    inv = torch.where(l > 0, 1.0 / l, 0.0).permute(0, 3, 1, 2, 4)
    o = torch.einsum("bhgqk,bkhd->bqhgd", attn._bf16_split(e), v.float())
    w = torch.einsum("bhgqk,bkhd->bqhgd", e, v.float().abs())
    return (o * inv).reshape(b, sq, h, d), (w * inv).reshape(b, sq, h, d)


def _split_bwd(torch, attn, q, k, v, o, lse, do, dlse, causal, scale,
               window, offset):
    """flash_bwd_reference's dQ, dK and dV with P and dS split into bf16
    hi + lo before the products, as flash_bwd_dq_sm90 and
    flash_bwd_dkv_sm90 multiply them, and each element's bound terms
    sum |ds| |k|, sum |ds| |q| and sum p |dO|. float32."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    dog = do.float().reshape(b, sq, kvh, h // kvh, d)
    valid = attn._visible(sq, sk, causal, window, offset, q.device)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    p = torch.exp(torch.where(valid, s - attn._by_group(lse.float(), kvh),
                              attn.NEG_INF))
    del s
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - attn._by_group(attn._bwd_delta(o, do, dlse), kvh)) \
        * scale
    del dp
    ds_split = attn._bf16_split(ds)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds_split, k.float()) \
        .reshape(b, sq, h, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds_split, qg)
    del ds_split
    dv = torch.einsum("bhgqk,bqhgd->bkhd", attn._bf16_split(p), dog)
    bq = torch.einsum("bhgqk,bkhd->bqhgd", ds.abs(), k.float().abs()) \
        .reshape(b, sq, h, d)
    bk = torch.einsum("bhgqk,bqhgd->bkhd", ds.abs(), qg.abs())
    bv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog.abs())
    return dq, dk, dv, bq, bk, bv


def kernel_phase(torch, log):
    """The forward kernels against flash_attention_reference on the card,
    by route (:func:`_route`): flash_fwd_sm90 (bf16 at a head_dim that is
    a multiple of 8, wgmma tensor cores) and flash_fwd_tf32x3 (every
    other float32 or bf16 head_dim, split-TF32 tensor cores). Returns the
    kernels-line entries: flash_fwd_tf32x3 at the slice's shape (its main
    path, serving) with its training-shape and d-12 numbers nested,
    flash_fwd_sm90 at the training path's bf16 shape."""
    import torch.nn.functional as F

    from learningorchestra_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    # (name, b, sq, sk, h, kvh, d, causal, window, kv_offset, dtype)
    cases = [
        ("slice", 1, 1536, 1536, 8, 4, 64, True, 1024, 0, f32),
        ("slice", 1, 1536, 1536, 8, 4, 64, True, 1024, 0, bf16),
        # a main-path prompt length: the last q tile is ragged
        ("prefill-1500", 1, 1500, 1500, 8, 4, 64, True, 1024, 0, f32),
        ("prefill-1500", 1, 1500, 1500, 8, 4, 64, True, 1024, 0, bf16),
        ("non-causal", 2, 96, 96, 4, 2, 64, False, 0, 0, f32),
        ("non-causal", 2, 96, 96, 4, 2, 64, False, 0, 0, bf16),
        ("mqa", 2, 130, 130, 8, 1, 64, True, 0, 0, f32),
        ("mqa", 2, 130, 130, 8, 1, 64, True, 0, 0, bf16),
        ("ragged-sk", 2, 77, 201, 4, 2, 32, False, 0, 0, f32),
        ("ragged-sk", 2, 77, 201, 4, 2, 32, False, 0, 0, bf16),
        ("offset-empty-rows", 2, 64, 64, 4, 4, 128, True, 16, 40, f32),
        ("offset-empty-rows", 2, 64, 64, 4, 4, 128, True, 16, 40, bf16),
        ("offset-empty-rows", 1, 64, 64, 4, 4, 64, True, 16, 40, bf16),
        ("offset-empty-rows", 1, 64, 64, 4, 4, 64, True, 16, 40, f32),
        # the training path's shape: bf16 is its dtype, float32 the
        # float32 fit's
        ("train", 8, 2048, 2048, 8, 4, 64, True, 1024, 0, bf16),
        ("train", 8, 2048, 2048, 8, 4, 64, True, 1024, 0, f32),
        # the d-12 LM's micro-step (2 windows of 2048): the split-TF32
        # kernel's width-16 variant in both dtypes
        ("lm-d12", 2, 2048, 2048, 8, 4, 12, True, 1024, 0, f32),
        ("lm-d12", 2, 2048, 2048, 8, 4, 12, True, 1024, 0, bf16),
        # an odd head_dim (a bf16 row of odd length loads element by
        # element; o's last pair is a single column) with ragged sq and
        # sk, and a kv_offset that leaves rows with no visible key; every
        # head its own kv head, so o and lse are compared on every head
        ("ragged-offset-empty-rows-d13", 2, 75, 131, 4, 4, 13, True, 16,
         40, f32),
        ("ragged-offset-empty-rows-d13", 2, 75, 131, 4, 4, 13, True, 16,
         40, bf16),
        # a multiple of 4 but not of 8, between the kernels' widths, GQA
        ("gqa-window-d36", 2, 160, 160, 8, 2, 36, True, 48, 0, f32),
        ("gqa-window-d36", 2, 160, 160, 8, 2, 36, True, 48, 0, bf16),
    ]
    # (atol, rtol). float32: summation order only (the split-TF32 route's
    # products depart from float32 ones by about 2**-22 of sum |x||y|).
    # bf16: o is rounded once from float32 by kernel and plain version
    # alike, so they differ by at most one bf16 ulp of |o| (<= 2**-7 |o|,
    # under rtol) plus the float32 error (under atol); the wgmma kernel
    # adds its bf16 hi + lo split of P, about 2**-16 of the product
    tols = {f32: (2e-5, 2e-5), bf16: (1e-4, 1e-2)}
    # the counter each route's wrapper adds one to
    routed = {"sm90": "FLASH_FWD_SM90_LAUNCHES",
              "tf32x3": "FLASH_FWD_TF32X3_LAUNCHES"}
    entries = {}
    for (name, b, sq, sk, h, kvh, d, causal, window, offset,
         dtype) in cases:
        def rand(*shape):
            return torch.randn(*shape, device="cuda", generator=gen) \
                .to(dtype)

        q, k, v = rand(b, sq, h, d), rand(b, sk, kvh, d), rand(b, sk, kvh, d)
        with_lse = h == kvh
        route = attn._route(q)
        want_route = "sm90" if dtype == bf16 and d % 8 == 0 else "tf32x3"
        sm90 = route == "sm90"
        scale = 1.0 / d ** 0.5

        def kernel():
            if with_lse:
                return attn.flash_attention_with_lse(
                    q, k, v, causal=causal, window=window, kv_offset=offset)
            return attn.flash_attention(q, k, v, causal=causal,
                                        window=window), None

        def plain(split=False):
            return attn.flash_attention_reference(
                q, k, v, causal=causal, window=window, kv_offset=offset,
                tf32x3=split)

        before = {r: getattr(attn, c) for r, c in routed.items()}
        o, lse = kernel()
        torch.cuda.synchronize()
        ran = {r: getattr(attn, c) - before[r] for r, c in routed.items()}
        if route != want_route or ran != {r: int(r == route)
                                          for r in routed}:
            raise AssertionError(f"flash_fwd {name} {dtype}: took the "
                                 f"{route} route, want {want_route} "
                                 f"(launches {ran})")
        ro, rlse = plain()
        diff = (o.float() - ro.float()).abs()
        err = diff.max().item()
        atol, rtol = tols[dtype]
        # worst |o - ro| / (atol + rtol |ro|); <= 1 passes
        excess = (diff / (atol + rtol * ro.float().abs())).max().item()
        if not excess <= 1.0:
            raise AssertionError(f"flash_fwd {name} {dtype}: |o - ro| "
                                 f"exceeds atol {atol} + rtol {rtol} |ro| "
                                 f"by {excess}x (max abs err {err})")
        line = {"case": name, "dtype": str(dtype).split(".")[-1],
                "kernel": f"flash_fwd_{route}",
                "shape": [b, sq, sk, h, kvh, d], "causal": causal,
                "window": window, "kvOffset": offset, "maxAbsErr": err,
                "atol": atol, "rtol": rtol, "tolUsed": excess}
        if sm90:
            # (a) against the float32 plain version at the derived bound
            # of bf16 P, 2**-8 sum p |v| / l, plus o's own rounding (one
            # bf16 ulp, <= 2**-7 |ro|); (b) against the plain version
            # with P split as the kernel splits it: float32 order (2**-14
            # of the bound term) plus o's rounding
            eo, w = _split_fwd(torch, attn, q, k, v, causal, scale, window,
                               offset)
            used_a = (diff / (2.0 ** -8 * w + 2.0 ** -7 * ro.float().abs()
                              + 1e-5)).max().item()
            eo = eo.to(dtype).float()
            used_b = ((o.float() - eo).abs()
                      / (2.0 ** -14 * w + 2.0 ** -7 * eo.abs() + 1e-6)) \
                .max().item()
            del eo, w
            if not (used_a <= 1.0 and used_b <= 1.0):
                raise AssertionError(
                    f"flash_fwd_sm90 {name}: bound used {used_a}x, "
                    f"split emulation tolerance used {used_b}x")
            line.update(derivedBoundUsed=used_a, splitEmulationUsed=used_b)
        else:
            # against the plain version that splits both products 3xTF32
            # as the kernel does, at the same tolerance
            eo, e_lse = plain(split=True)
            used = ((o.float() - eo.float()).abs()
                    / (atol + rtol * eo.float().abs())).max().item()
            seen = e_lse != attn.NEG_INF
            lse_used = ((lse - e_lse)[seen].abs().max().item() / 1e-4
                        if lse is not None else 0.0)
            del eo, e_lse
            if not (used <= 1.0 and lse_used <= 1.0):
                raise AssertionError(
                    f"flash_fwd_tf32x3 {name} {dtype}: split emulation "
                    f"tolerance used {used}x (lse {lse_used}x)")
            line["splitEmulationUsed"] = used
        empty = 0
        if lse is not None:
            # rows with no visible key carry exactly NEG_INF in both
            seen = rlse != attn.NEG_INF
            if not torch.equal(seen, lse != attn.NEG_INF):
                raise AssertionError(f"flash_fwd {name}: empty rows differ")
            lse_err = (lse - rlse)[seen].abs().max().item()
            if not lse_err <= (2e-5 if sm90 else 1e-4):
                raise AssertionError(f"flash_fwd {name}: lse err {lse_err}")
            empty = int((~seen).sum())
            if offset and not (empty and bool((o[~seen] == 0).all())):
                raise AssertionError(f"{name}: no empty rows, or empty "
                                     f"rows with a non-zero o")
            line["lseMaxAbsErr"] = lse_err
        line["emptyRows"] = empty
        if name in ("slice", "train", "lm-d12"):
            mask = _visible_mask(torch, sq, sk, causal, window, offset,
                                 q.device)
            pairs = int(mask.sum())
            flops = 4.0 * d * pairs * h * b
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size() + 4 * b * sq * h
            dt = line["dtype"]
            # the least time for the function on these inputs, whatever
            # the route: bf16 inputs at the card's bf16 rate, float32 ones
            # as three TF32 products; float32 FMAs beside it, and the
            # split work the route runs (wgmma: P split hi + lo, 6 d FLOP
            # per pair in bf16; split TF32: 12 d in float32, 6 d in bf16,
            # whose Q.K^T is one product and P.V two, at the TF32 rate)
            fp32_ms = flops / PEAK_FLOPS["float32"] * 1e3
            op_ms = (flops / PEAK_FLOPS["bfloat16"] if dtype != f32
                     else 3 * flops / PEAK_FLOPS["tf32"]) * 1e3
            split_ms = (1.5 * flops / PEAK_FLOPS["bfloat16"] if sm90
                        else (3 if dtype == f32 else 1.5) * flops
                        / PEAK_FLOPS["tf32"]) * 1e3
            byte_ms = nbytes / PEAK_BYTES * 1e3
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            line.update({
                "ms": _time_ms(torch, lambda: kernel()),
                "plain_ms": _time_ms(torch, plain, iters=5),
                "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=scale,
                    enable_gqa=True)),
                "bound_ms": max(op_ms, byte_ms),
                "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                "boundFloat32Ms": fp32_ms, "boundSplitMs": split_ms,
                "flops": flops, "bytes": nbytes, "visiblePairs": pairs,
            })
            del mask, qt, kt, vt
            picked = {k: line[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "boundFloat32Ms", "boundSplitMs", "splitEmulationUsed")}
            picked.update(max_abs_err=err, dtype=dt,
                          shape=[b, sq, sk, h, kvh, d])
            if "derivedBoundUsed" in line:
                picked["derivedBoundUsed"] = line["derivedBoundUsed"]
            if name == "slice" and dtype == f32:
                entries.setdefault("flash_fwd_tf32x3", {}).update(picked)
            elif name == "train" and dtype == f32:
                entries.setdefault("flash_fwd_tf32x3", {})[
                    "trainShapeFloat32"] = picked
            elif name == "train":
                entries["flash_fwd_sm90"] = picked
            elif name == "lm-d12":
                # nested, so that the serving shape's figures stay the
                # entry's own
                entries.setdefault("flash_fwd_tf32x3", {})[
                    "d12Float32" if dtype == f32 else "d12Bfloat16"] = picked
        log.append("kernel " + json.dumps(line))
        del q, k, v, o, lse, ro, rlse, diff
    return entries


def bwd_kernel_phase(torch, log):
    """The backward kernels against flash_bwd_reference on the card, each
    case in fp32 and bf16, on the forward kernel's own (o, lse), by the
    backward's route (:func:`_route`): flash_bwd_dq_sm90 and
    flash_bwd_dkv_sm90 (bf16 at a head_dim that is a multiple of 8),
    flash_bwd_dq_tf32x3 and flash_bwd_dkv_tf32x3 (every other head_dim,
    float32 or bf16). Returns the kernels-line entries: each kernel at
    the training path's shape in its dtype, bf16 for the fit and float32
    for the float32 fit, with the tf32x3 kernels' d-12 figures nested."""
    import torch.nn.functional as F

    from learningorchestra_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(1)
    # (name, b, sq, sk, h, kvh, d, causal, window, kv_offset, dlse)
    cases = [
        ("train", 8, 2048, 2048, 8, 4, 64, True, 1024, 0, False),
        ("non-causal-ragged-d32", 2, 77, 201, 4, 2, 32, False, 0, 0, False),
        ("mqa", 2, 130, 130, 8, 1, 64, True, 0, 0, False),
        ("offset-empty-rows-dlse-d128", 2, 64, 64, 4, 4, 128, True, 16, 40,
         True),
        # the d-12 LM's micro-step (2 windows of 2048): a head_dim off the
        # multiple of 8 takes the split-TF32 backward in both dtypes
        ("lm-d12", 2, 2048, 2048, 8, 4, 12, True, 1024, 0, False),
        # an odd head_dim (a bf16 row of odd length: loads element by
        # element) with ragged sq and sk under a dlse term
        ("ragged-dlse-d13", 2, 75, 131, 4, 4, 13, False, 0, 0, True),
        # a multiple of 4 but not of 8, between the kernels' widths, GQA
        ("gqa-window-d36", 2, 160, 160, 8, 2, 36, True, 48, 0, False),
    ]
    # (atol as a share of the case's largest |g|, rtol). Kernel and plain
    # version compute in float32 from the same inputs and (o, lse) and
    # differ in summation order only. The tensor-core dQ and dK/dV are
    # held more tightly: sm90 (bf16 on wgmma) (a) to the derived bound of
    # bf16 P and dS, 2**-8 sum |ds| |k|, 2**-8 sum |ds| |q| and 2**-8 sum
    # p |dO|, and (b) to the float32 tolerance against the plain version
    # with P and dS split into bf16 hi + lo as the kernels split them;
    # tf32x3 in both dtypes (a bf16 input is exact in TF32) to the
    # float32 tolerance against the float32 plain version and against
    # the plain version that splits every product 3xTF32 as the kernels
    # do. sm90 holds bf16 to the bound a bf16 gradient would carry
    # (rtol 1e-2, about one bf16 ulp).
    tols = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 1e-2)}
    routed = {"sm90": ("FLASH_BWD_DQ_SM90_LAUNCHES",
                       "FLASH_BWD_DKV_SM90_LAUNCHES"),
              "tf32x3": ("FLASH_BWD_DQ_TF32X3_LAUNCHES",
                         "FLASH_BWD_DKV_TF32X3_LAUNCHES")}
    entries = {}
    for (name, b, sq, sk, h, kvh, d, causal, window, offset,
         with_dlse) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            def rand(*shape):
                return torch.randn(*shape, device="cuda", generator=gen) \
                    .to(dtype)

            q, k, v = rand(b, sq, h, d), rand(b, sk, kvh, d), \
                rand(b, sk, kvh, d)
            do = rand(b, sq, h, d)
            dlse = torch.randn(b, sq, h, device="cuda", generator=gen) \
                if with_dlse else None
            scale = 1.0 / d ** 0.5
            o, lse = attn._flash_fwd(q, k, v, causal, scale, window, offset)
            delta = attn._bwd_delta(o, do, dlse)
            route = attn._route(q)
            want_route = "sm90" if dtype == torch.bfloat16 and d % 8 == 0 \
                else "tf32x3"
            dq = getattr(attn, f"_flash_bwd_dq_{route}")
            dkv = getattr(attn, f"_flash_bwd_dkv_{route}")
            dq_name, dkv_name = (f"{n}_{route}" for n in (
                "flash_bwd_dq", "flash_bwd_dkv"))
            args = (q, k, v, do, lse, delta, causal, scale, window, offset)

            def dq_kernel():
                return dq(*args)

            def dkv_kernel():
                return dkv(*args)

            def plain(split=False):
                return attn.flash_bwd_reference(
                    q, k, v, o, lse, do, dlse, causal=causal, scale=scale,
                    window=window, kv_offset=offset, tf32x3=split)

            counters = [c for pair in routed.values() for c in pair]
            before = [getattr(attn, c) for c in counters]
            got = (dq_kernel(), *dkv_kernel())
            torch.cuda.synchronize()
            ran = dict(zip(counters, (getattr(attn, c) - n
                                      for c, n in zip(counters, before))))
            want_ran = {c: int(r == route) for r, pair in routed.items()
                        for c in pair}
            if ran != want_ran or route != want_route:
                raise AssertionError(f"flash_bwd {name} {dtype}: dq and "
                                     f"dkv took the {route} route, want "
                                     f"{want_route} (tensor-core launches "
                                     f"{ran})")
            want = plain()
            rel_atol, rtol = tols[torch.float32 if route == "tf32x3"
                                  else dtype]
            # each of dq, dk, dv finite and within atol (rel_atol of the
            # case's largest |g|) + rtol |g| of the float32 plain version
            errs, used = [], []
            for g, w, part in zip(got, want, ("dq", "dk", "dv")):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"flash_bwd {name} {dtype}: {part} "
                                         f"not finite")
                atol = rel_atol * w.abs().max().item()
                diff = (g - w).abs()
                errs.append(diff.max().item())
                # worst |g - w| / (atol + rtol |w|); <= 1 passes
                used.append((diff / (atol + rtol * w.abs())).max().item())
                if not used[-1] <= 1.0:
                    raise AssertionError(
                        f"flash_bwd {part} {name} {dtype}: exceeds atol "
                        f"{atol} + rtol {rtol} |ref| by {used[-1]}x (max "
                        f"abs err {errs[-1]})")
            empty = int((lse == attn.NEG_INF).sum())
            if offset and not (empty and bool(
                    (got[0][lse == attn.NEG_INF] == 0).all())):
                raise AssertionError(f"{name}: no empty rows, or empty "
                                     f"rows with a non-zero dq")
            dt = str(dtype).split(".")[-1]
            line = {"case": name, "dtype": dt, "route": route,
                    "dqKernel": dq_name, "dkvKernel": dkv_name,
                    "shape": [b, sq, sk, h, kvh, d], "causal": causal,
                    "window": window, "kvOffset": offset, "dlse": with_dlse,
                    "maxAbsErr": dict(zip(("dq", "dk", "dv"), errs)),
                    "relAtol": rel_atol, "rtol": rtol,
                    "tolUsed": dict(zip(("dq", "dk", "dv"), used)),
                    "emptyRows": empty}
            if route == "sm90":
                split = _split_bwd(torch, attn, q, k, v, o, lse, do, dlse,
                                   causal, scale, window, offset)
                checks = {}
                for part, g, w, e, bound in zip(("dq", "dk", "dv"), got,
                                                want, split[:3], split[3:]):
                    floor = 1e-4 * w.abs().max().item()
                    checks[part] = (
                        ((g - w).abs() / (2.0 ** -8 * bound + floor))
                        .max().item(),
                        ((g - e).abs() / (floor + 1e-4 * e.abs()))
                        .max().item())
                del split
                if not all(a <= 1.0 and e <= 1.0
                           for a, e in checks.values()):
                    raise AssertionError(f"flash_bwd sm90 {name}: (bound "
                                         f"used, split emulation used) "
                                         f"{checks}")
                line["derivedBoundUsed"] = {
                    k: c[0] for k, c in checks.items()}
                line["splitEmulationUsed"] = {
                    k: c[1] for k, c in checks.items()}
            else:
                checks = {}
                for part, g, w, e in zip(("dq", "dk", "dv"), got, want,
                                         plain(split=True)):
                    floor = 1e-4 * w.abs().max().item()
                    checks[part] = ((g - e).abs()
                                    / (floor + 1e-4 * e.abs())).max().item()
                if not all(e <= 1.0 for e in checks.values()):
                    raise AssertionError(f"flash_bwd tf32x3 {name}: split "
                                         f"emulation used {checks}")
                line["splitEmulationUsed"] = checks
            d12 = name == "lm-d12"
            if name == "train" or d12:
                pairs = int(_visible_mask(torch, sq, sk, causal, window,
                                          offset, q.device).sum())
                elt = q.element_size()
                ins = (2 * q.numel() + k.numel() + v.numel()) * elt \
                    + 2 * 4 * lse.numel()
                plain_ms = _time_ms(torch, plain, iters=3)
                # library yardstick: the backward of SDPA over the same
                # mask, i.e. its forward+backward less its forward
                mask = _visible_mask(torch, sq, sk, causal, window, offset,
                                     q.device)
                qt, kt, vt = (x.transpose(1, 2).contiguous()
                              .requires_grad_() for x in (q, k, v))
                dot = do.transpose(1, 2).contiguous()

                def sdpa():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, scale=scale,
                        enable_gqa=True)

                def sdpa_fwd_bwd():
                    torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

                with torch.no_grad():
                    sdpa_fwd_ms = _time_ms(torch, sdpa)
                library_ms = _time_ms(torch, sdpa_fwd_bwd) - sdpa_fwd_ms
                # each kernel: its launch, the function's FLOP per visible
                # pair and head-dim column, the same with bf16 inputs on
                # the tensor cores (P and dS split hi + lo, each input
                # whole: 1 + 1 + 2 products for dq, 1 + 1 + 2 + 2 for
                # dK/dV, whether as bf16 on wgmma or as TF32), output
                # elements, the gradients it writes
                for kernel, fn, per_pair, bf16_pair, outs, parts in (
                        (dq_name, dq_kernel, 6.0, 8.0, q.numel(), ("dq",)),
                        (dkv_name, dkv_kernel, 8.0, 12.0,
                         k.numel() + v.numel(), ("dk", "dv"))):
                    work = per_pair * d * pairs * h * b
                    nbytes = ins + 4 * outs
                    byte_ms = nbytes / PEAK_BYTES * 1e3
                    # the least time for the function on these inputs:
                    # bf16 inputs at the card's bf16 rate, float32 ones
                    # as 3xTF32, on every route; beside it, the split
                    # work the route
                    # runs (bf16 P and dS split hi + lo on wgmma, 3xTF32
                    # for float32 inputs, the reduced split for bf16
                    # inputs at the TF32 rate) and float32 at the CUDA
                    # cores' rate
                    fp32_ms = work / PEAK_FLOPS["float32"] * 1e3
                    bf16_work = bf16_pair / per_pair * work
                    split_ms = {
                        "sm90": bf16_work / PEAK_FLOPS["bfloat16"] * 1e3,
                        "tf32x3": (3 * work if dtype == torch.float32
                                   else bf16_work)
                        / PEAK_FLOPS["tf32"] * 1e3}[route]
                    op_ms = (3 * work / PEAK_FLOPS["tf32"]
                             if dtype == torch.float32
                             else work / PEAK_FLOPS["bfloat16"]) * 1e3
                    ms = _time_ms(torch, fn)
                    part = {
                        "ms": ms, "bound_ms": max(op_ms, byte_ms),
                        "bound_by": "operations" if op_ms >= byte_ms
                        else "bytes", "flops": work, "bytes": nbytes,
                        "boundFloat32Ms": fp32_ms, "boundSplitMs": split_ms}
                    figures = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=part["bound_ms"],
                        bound_by=part["bound_by"], library_ms=library_ms,
                        max_abs_err=max(e for e, p in zip(
                            errs, ("dq", "dk", "dv")) if p in parts),
                        dtype=dt, boundFloat32Ms=fp32_ms,
                        boundSplitMs=split_ms,
                        shape=[b, sq, sk, h, kvh, d],
                        splitEmulationUsed={
                            p: line["splitEmulationUsed"][p]
                            for p in parts})
                    if route == "sm90":
                        figures["derivedBoundUsed"] = {
                            p: line["derivedBoundUsed"][p] for p in parts}
                    if d12:
                        # nested, so that the training shape's figures
                        # stay the entry's own
                        nest = "d12Float32" if dtype == torch.float32 \
                            else "d12Bfloat16"
                        entries.setdefault(kernel, {})[nest] = figures
                    else:
                        entries.setdefault(kernel, {}).update(figures)
                    line[kernel] = part
                line.update(plain_ms=plain_ms, library_ms=library_ms,
                            sdpaForwardMs=sdpa_fwd_ms, visiblePairs=pairs)
                del mask, qt, kt, vt, dot
            log.append("kernel " + json.dumps(line))
            del q, k, v, do, o, lse, delta, got, want
    return entries


def _http(base, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + PREFIX + path, data=data,
                                 method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def slice_phase(torch, log, home):
    """REST create -> 4 concurrent predicts -> stats -> delete. Returns
    the kernel launches of the serving path."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    state = weights.params_from_flax(weights.init_params(LM_CONFIG, seed=0))
    lm = LanguageModel(**LM_CONFIG, device="cuda")
    lm.set_params(state)
    ctx = ServiceContext(Config(home=home), device="cuda")
    ctx.artifacts.save(lm, "lm", "train/tensorflow")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, LM_CONFIG["vocab_size"],
                                             size=n)]
               for n in PROMPT_LENS]
    server = RestServer(port=0, context=ctx).start()
    rounds = []
    try:
        _reset_launches(attn)
        status, body = _http(server.base_url, "POST", "/serve/lm", {
            "type": "lm", "maxSlots": 4, "cacheLen": 2048,
            "temperature": 0.0})
        if status != 201:
            raise AssertionError(f"create: {status} {body}")
        # round 1 pays first use on the session's worker thread (library
        # handles, first launches); round 2 sends the same requests warm
        for name in ("cold", "warm"):
            out = [None] * len(prompts)
            walls = [0.0] * len(prompts)

            def client(i):
                c0 = time.monotonic()
                out[i] = _http(server.base_url, "POST",
                               "/serve/lm/predict",
                               {"prompt": prompts[i],
                                "maxNewTokens": NEW_TOKENS})
                walls[i] = time.monotonic() - c0

            t0 = time.monotonic()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.monotonic() - t0
            status, stats = _http(server.base_url, "GET", "/serve/lm")
            if status != 200:
                raise AssertionError(f"stats: {status} {stats}")
            rounds.append((name, out, walls, wall, stats))
        launches = _launches(attn)
        status, deleted = _http(server.base_url, "DELETE", "/serve/lm")
        if status != 200 or deleted.get("deleted") is not True:
            raise AssertionError(f"delete: {status} {deleted}")
    finally:
        server.stop()

    need = LM_CONFIG["n_layers"] * len(prompts) * len(rounds)
    if launches["flash_fwd_tf32x3"] < need:
        raise AssertionError(f"flash_fwd_tf32x3 launched "
                             f"{launches['flash_fwd_tf32x3']} times on the "
                             f"serving path; {len(prompts) * len(rounds)} "
                             f"prefills of {LM_CONFIG['n_layers']} layers "
                             f"need {need}")
    if any(n for k, n in launches.items() if k != "flash_fwd_tf32x3"):
        raise AssertionError(f"serving (float32) ran a kernel other than "
                             f"flash_fwd_tf32x3: {launches}")
    solos = [lm.generate([p], max_new_tokens=NEW_TOKENS)[0][len(p):]
             for p in prompts]
    report = []
    for name, out, walls, wall, stats in rounds:
        for i, (result, solo) in enumerate(zip(out, solos)):
            if result is None or result[0] != 200:
                raise AssertionError(f"{name} predict {i}: {result}")
            tokens = result[1]["tokens"]
            if len(tokens) != NEW_TOKENS or not all(
                    0 < t < LM_CONFIG["vocab_size"] for t in tokens):
                raise AssertionError(f"{name} predict {i}: bad tokens "
                                     f"{tokens}")
            want = [int(t) for t in solo]
            if tokens != want:
                first = next(j for j, (a, b) in enumerate(zip(tokens, want))
                             if a != b)
                raise AssertionError(f"{name} predict {i} diverges from "
                                     f"solo generate at token {first}")
        decode_s = max(r[1]["decodeSeconds"] for r in out)
        # this round's own TTFT as each client saw it: its request's wall
        # less the decode after the first token (session stats pool the
        # TTFT of every round)
        ttft_ms = sorted((w - r[1]["decodeSeconds"]) * 1e3
                         for w, r in zip(walls, out))
        report.append({
            "round": name, "wallSeconds": wall,
            "clientTtftMs": {"p50": ttft_ms[(len(ttft_ms) - 1) // 2],
                             "max": ttft_ms[-1], "all": ttft_ms},
            "maxDecodeSeconds": decode_s,
            "decodeTokensPerSec": len(out) * (NEW_TOKENS - 1) / decode_s,
            "statsSoFar": {k: stats[k] for k in (
                "ttft", "roles", "perf", "tokensTotal")}})
    report.append(_decode_profile(torch, lm, prompts))
    # the prefill logits through the kernel against the dense path
    dense = LanguageModel(**LM_CONFIG, attention="dot", device="cuda")
    dense.set_params(state)
    tokens = torch.tensor([prompts[-1]], device="cuda")
    with torch.inference_mode():
        got = lm.module(tokens)
        want = dense.module(tokens)
    if not bool(torch.isfinite(got).all()) or \
            got.shape != (1, PROMPT_LENS[-1], LM_CONFIG["vocab_size"]):
        raise AssertionError("prefill logits not finite or misshapen")
    logit_err = (got - want).abs().max().item()
    if not logit_err <= 1e-3:
        raise AssertionError(f"flash vs dot prefill logits: {logit_err}")
    log.append("slice " + json.dumps({
        "prompts": list(PROMPT_LENS), "newTokens": NEW_TOKENS,
        "launches": launches, "tokensEqualSolo": True,
        "prefillLogitsMaxAbsErrVsDot": logit_err, "rounds": report}))
    return launches


def _decode_profile(torch, lm, prompts, steps: int = 8):
    """Where a warm decode step's time goes: ``steps`` slot steps of 4
    filled slots under ``torch.profiler``, with the host wall per step
    and the top operators by device and by host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    step, prefill_for, join = lm.serve_fns(4, 2048, 0.0)
    cache = lm.serve_cache(4, 2048)
    col = np.zeros(4, np.int64)
    tok = np.zeros((4, 1), np.int64)
    for slot, prompt in enumerate(prompts):
        tokens = torch.tensor([prompt], device="cuda")
        nxt, pcache = prefill_for(len(prompt))(tokens, 0)
        join(cache, pcache, slot)
        tok[slot, 0], col[slot] = int(nxt[0]), len(prompt)
    seeds = np.zeros(4, np.int64)

    def run(n):
        for _ in range(n):
            nxt = step(cache, tok, col, seeds).cpu().numpy()
            tok[:, 0] = nxt
            col[:] += 1

    run(4)
    t0 = time.monotonic()
    run(steps)
    wall_ms = (time.monotonic() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]

    def top(rows, attr):
        rows = sorted(rows, key=lambda e: getattr(e, attr), reverse=True)
        return [[e.key[:80], round(getattr(e, attr) / steps / 1e3, 4),
                 e.count / steps] for e in rows[:10]]

    return {"round": "decodeProfile", "steps": steps,
            "hostWallMsPerStep": wall_ms,
            "deviceBusyMsPerStep": sum(
                e.self_device_time_total for e in kernels) / steps / 1e3,
            "kernelLaunchesPerStep": sum(e.count for e in kernels) / steps,
            "topKernelsMs": top(kernels, "self_device_time_total"),
            "topHostMs": top(events, "self_cpu_time_total")}


def _successor_windows(np, n: int, seq: int, seed: int):
    """``n`` windows of ``seq`` tokens of the stream where id t is
    followed by t % 63 + 1; each window starts at an id drawn from
    ``seed``."""
    start = np.random.default_rng(seed).integers(1, 64, size=n)
    return ((start[:, None] - 1 + np.arange(seq)[None, :]) % 63 + 1) \
        .astype(np.int32)


def _float32_fit_window(torch, lm, x, log) -> dict:
    """The fit of the train phase in float32 (``LO_COMPUTE_DTYPE``): one
    optimizer step of first use, 2 timed steps (host clock to a
    synchronize), then the same 2 batches again under the profiler, each
    step of TRAIN_BATCH windows at grad_accum TRAIN_ACCUM. The params are restored after it,
    so the artifact holds exactly the bf16 fit's steps. Logs the
    ``trainFloat32`` line and returns the kernel launches of the 2 timed
    steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from learningorchestra_tpu_torch.ops import attention as attn

    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    lm._engine = None
    try:
        eng = lm._get_engine()
        if eng._compute_dtype != torch.float32 or \
                eng._grad_accum != TRAIN_ACCUM:
            raise AssertionError("the float32 window must run the fit's "
                                 "float32 engine at its grad_accum")
        params = lm._master_params()
        saved = {k: p.detach().clone() for k, p in params.items()}
        tstate = eng.init_state(params)
        batches = [eng._to_device(b, lm.device) for b in
                   lm._batcher(x[:3 * TRAIN_BATCH], TRAIN_BATCH).epoch(0)]
        eng._train_step_body(tstate, batches[0], 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(attn)
        t0 = time.monotonic()
        losses = [eng._train_step_body(tstate, batch, 0)["loss"]
                  for batch in batches[1:3]]
        torch.cuda.synchronize()
        step_ms = (time.monotonic() - t0) / 2 * 1e3
        launches = _launches(attn)
        peak_bytes = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.monotonic()
            for batch in batches[1:3]:
                eng._train_step_body(tstate, batch, 0)
            torch.cuda.synchronize()
            window_ms = (time.monotonic() - w0) * 1e3
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])
        losses = [float(s) / float(c) for s, c in losses]
        del saved, tstate, batches
    finally:
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
        lm._engine = None
    if not all(np.isfinite(losses)):
        raise AssertionError(f"float32 window losses {losses}")
    need = LM_CONFIG["n_layers"] * TRAIN_ACCUM * 2
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_fwd_tf32x3=need, flash_bwd_dq_tf32x3=need,
                flash_bwd_dkv_tf32x3=need)
    if launches != want:
        raise AssertionError(f"kernel launches in the float32 window "
                             f"{launches}; 2 steps of {TRAIN_ACCUM} "
                             f"micro-batches of {LM_CONFIG['n_layers']} "
                             f"layers need {want}")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    per_step = {name: sum(e.self_device_time_total for e in kernels
                          if f"{name}_kernel" in e.key) / 2e3
                for name in COUNTERS}
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    log.append("trainFloat32 " + json.dumps({
        "computeDtype": "float32", "optimizerSteps": 2,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "gradAccum": TRAIN_ACCUM,
        "stepMs": step_ms,
        "trainTokensPerSec": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
        "losses": losses, "launches": launches,
        "launchesPerStep": {k: n / 2 for k, n in launches.items() if n},
        "maxMemoryAllocatedBytes": peak_bytes,
        "profile": {"steps": 2, "windowMs": window_ms,
                    "deviceBusyMs": busy_ms,
                    "idleShare": 1.0 - busy_ms / window_ms,
                    "kernelMsPerStep": {k: v for k, v in per_step.items()
                                        if v},
                    "topKernelsMsPerStep": [
                        [e.key[:80], e.self_device_time_total / 2e3,
                         e.count / 2] for e in top]}}))
    return launches


def train_phase(torch, log, home):
    """fit on the card -> checks -> a profiled 2-step window -> a float32
    window of the same fit -> kernel-vs-dense gradients -> save, serve
    over REST, predict. Returns the kernel launches of each path it
    drove: the bf16 fit, the float32 fit window, the two float32
    gradient steps and the d-12 LM's bf16 gradient step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime.data import MASK_KEY
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    state = weights.params_from_flax(weights.init_params(LM_CONFIG, seed=0))
    x = _successor_windows(np, TRAIN_WINDOWS, TRAIN_SEQ, seed=0)
    lm = LanguageModel(**LM_CONFIG, device="cuda")
    lm.set_params(state)
    if lm._get_engine()._compute_dtype != torch.bfloat16:
        raise AssertionError("the training path must compute in bf16")
    steps = TRAIN_EPOCHS * TRAIN_WINDOWS // TRAIN_BATCH
    micro = steps * TRAIN_ACCUM
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(attn)
    t0 = time.monotonic()
    hist = lm.fit(x, batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                  grad_accum=TRAIN_ACCUM).history
    fit_s = time.monotonic() - t0
    launches = _launches(attn)
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = hist["loss"]
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_EPOCHS:
        raise AssertionError(f"training losses {losses}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not all(abs(a - b) <= 0.01 * b
               for a, b in zip(losses, CUDA_CORE_LOSSES)):
        raise AssertionError(f"epoch losses {losses} are not within 1% of "
                             f"the CUDA-core kernels' {CUDA_CORE_LOSSES}")
    # bf16: the forward, dq and dK/dV take the tensor-core route, every
    # time
    need = LM_CONFIG["n_layers"] * micro
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_fwd_sm90=need, flash_bwd_dq_sm90=need,
                flash_bwd_dkv_sm90=need)
    if launches != want:
        raise AssertionError(f"kernel launches during fit {launches}; "
                             f"{micro} micro-batches of "
                             f"{LM_CONFIG['n_layers']} layers need {want}")
    # steady-state step time: the second epoch, after first use
    step_ms = hist["epochSeconds"][1] / (steps // TRAIN_EPOCHS) * 1e3
    tokens_per_s = TRAIN_WINDOWS * TRAIN_SEQ / hist["epochSeconds"][1]

    # a profiled window of 2 optimizer steps; the params are restored
    # after it, so the artifact holds exactly the fit's 8 steps
    eng = lm._get_engine()
    params = lm._master_params()
    saved = {k: p.detach().clone() for k, p in params.items()}
    tstate = eng.init_state(params)
    batches = [eng._to_device(b, lm.device) for b in
               lm._batcher(x[:3 * TRAIN_BATCH], TRAIN_BATCH).epoch(0)]
    eng._train_step_body(tstate, batches[0], 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.monotonic()
        for batch in batches[1:]:
            eng._train_step_body(tstate, batch, 0)
        torch.cuda.synchronize()
        window_ms = (time.monotonic() - w0) * 1e3
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(saved[k])
    del saved, tstate, batches
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    per_step = {name: sum(e.self_device_time_total for e in kernels
                          if f"{name}_kernel" in e.key) / 2e3
                for name in COUNTERS}
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]

    f32_fit = _float32_fit_window(torch, lm, x, log)

    # one micro-step of 2 windows through the split-TF32 kernels, one
    # launch of each per layer, against the same step on the dense path
    # (plain autograd): in float32 for the tutorial LM (head_dim 64) and
    # the d-12 LM (the width-16 variants), each within 1e-4; in bf16 for
    # the d-12 LM, finite, its error against the bf16 dense path recorded
    # only (the kernel phase holds the kernels' numbers)
    kernels = ("flash_fwd_tf32x3", "flash_bwd_dq_tf32x3",
               "flash_bwd_dkv_tf32x3")
    f32_grad = {}
    for path, config, dtype, limit in (
            ("trainFloat32Grad", LM_CONFIG, "float32", 1e-4),
            ("trainFloat32GradD12", D12_CONFIG, "float32", 1e-4),
            ("trainBf16GradD12", D12_CONFIG, "bfloat16", None)):
        os.environ["LO_COMPUTE_DTYPE"] = dtype
        init = state if config is LM_CONFIG else weights.params_from_flax(
            weights.init_params(config, seed=0))
        grads = {}
        for impl in ("flash", "dot"):
            model = LanguageModel(**config, attention=impl, device="cuda")
            model.set_params(init)
            feng = model._get_engine()
            if feng._compute_dtype != getattr(torch, dtype):
                raise AssertionError(f"the gradient check must run in "
                                     f"{dtype}")
            batch = feng._to_device(
                {"x": x[:2], MASK_KEY: np.ones(2, np.float32)}, model.device)
            _reset_launches(attn)
            g, _ = feng._micro_grads(model._master_params(), batch, 0)
            ran = _launches(attn)
            want_ran = dict.fromkeys(COUNTERS, 0)
            if impl == "flash":
                want_ran.update(dict.fromkeys(kernels, config["n_layers"]))
            if ran != want_ran:
                raise AssertionError(f"{path} {impl} gradient step launched "
                                     f"{ran}, want {want_ran}")
            if not all(bool(torch.isfinite(t).all()) for t in g.values()):
                raise AssertionError(f"{path} {impl}: gradients not finite")
            if impl == "flash":
                f32_grad[path] = {"launches": ran}
            grads[impl] = g
            del model, feng, batch
        rel = {k: ((grads["flash"][k].float() - grads["dot"][k].float())
                   .norm() / grads["dot"][k].float().norm().clamp_min(1e-30))
               .item() for k in grads["dot"]}
        worst = max(rel, key=rel.get)
        if limit is not None and not rel[worst] <= limit:
            raise AssertionError(f"{path}: kernel vs dense gradient of "
                                 f"{worst}: relative L2 error {rel[worst]}")
        f32_grad[path]["relL2VsDot"] = {"max": rel[worst], "worst": worst}
        del grads
    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"

    # the trained artifact, reloaded and served over REST
    ctx = ServiceContext(Config(home=home), device="cuda")
    ctx.artifacts.save(lm, "trained", "train/tensorflow")
    loaded = ctx.artifacts.load("trained")
    if loaded.history != lm.history:
        raise AssertionError("the artifact lost the training history")
    prompt = [int(t) for t in x[0, :256]]
    server = RestServer(port=0, context=ctx).start()
    try:
        status, body = _http(server.base_url, "POST", "/serve/trained", {
            "type": "lm", "maxSlots": 2, "cacheLen": 512,
            "temperature": 0.0})
        if status != 201:
            raise AssertionError(f"create: {status} {body}")
        status, out = _http(server.base_url, "POST",
                            "/serve/trained/predict",
                            {"prompt": prompt, "maxNewTokens": NEW_TOKENS})
        if status != 200:
            raise AssertionError(f"predict: {status} {out}")
        _http(server.base_url, "DELETE", "/serve/trained")
    finally:
        server.stop()
    want = [int(t) for t in loaded.generate(
        [prompt], max_new_tokens=NEW_TOKENS)[0][len(prompt):]]
    if out["tokens"] != want:
        raise AssertionError(f"served tokens {out['tokens']} differ from "
                             f"the reloaded model's generate {want}")
    follows = sum(t == p % 63 + 1 for p, t in
                  zip([prompt[-1]] + want[:-1], want)) / len(want)
    log.append("train " + json.dumps({
        "config": LM_CONFIG, "windows": TRAIN_WINDOWS, "seq": TRAIN_SEQ,
        "batch": TRAIN_BATCH, "epochs": TRAIN_EPOCHS,
        "gradAccum": TRAIN_ACCUM, "optimizerSteps": steps,
        "microBatches": micro, "computeDtype": "bfloat16",
        "history": hist, "fitSeconds": fit_s, "launches": launches,
        "stepMs": step_ms, "trainTokensPerSec": tokens_per_s,
        "maxMemoryAllocatedBytes": peak_bytes,
        "profile": {"steps": 2, "windowMs": window_ms,
                    "deviceBusyMs": busy_ms,
                    "idleShare": 1.0 - busy_ms / window_ms,
                    "kernelMsPerStep": per_step,
                    "topKernelsMsPerStep": [
                        [e.key[:80], e.self_device_time_total / 2e3,
                         e.count / 2] for e in top]},
        "f32GradRelL2VsDot": f32_grad["trainFloat32Grad"]["relL2VsDot"],
        "f32GradLaunches": f32_grad["trainFloat32Grad"]["launches"],
        "f32GradD12": f32_grad["trainFloat32GradD12"],
        "bf16GradD12": f32_grad["trainBf16GradD12"],
        "servedTokensEqualGenerate": True,
        "servedSuccessorShare": follows}))
    return {"train": launches, "trainFloat32": f32_fit,
            **{path: c["launches"] for path, c in f32_grad.items()}}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from learningorchestra_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"device: {smi.stdout.strip()}", flush=True)
    t0 = time.monotonic()
    _build.build()
    print(f"kernel build seconds: {time.monotonic() - t0:.3f} "
          f"(sources {_build.sources()})", flush=True)
    ptxas = {name: _ptxas_report(text)
             for name, text in sorted(_build.BUILD_LOG.items())}
    print("ptxas " + json.dumps(ptxas), flush=True)
    spilled = [v for name, variants in ptxas.items()
               if name.endswith(("_sm90", "_tf32x3"))
               for v in variants if v.get("spillStores", 1)
               or v.get("spillLoads", 1)]
    if spilled:
        print(f"chip_smoke: tensor-core variants spill (or ptxas did not "
              f"report): {spilled}", file=sys.stderr)
        return 1

    log: list = []
    try:
        entries = kernel_phase(torch, log)
        entries.update(bwd_kernel_phase(torch, log))
        with tempfile.TemporaryDirectory() as home:
            served = slice_phase(torch, log, home)
        with tempfile.TemporaryDirectory() as home:
            paths = {"serve": served, **train_phase(torch, log, home)}
        # each kernel's main path: serving (float32) for the split-TF32
        # forward, the bf16 fit for the wgmma kernels, the float32 fit for
        # the split-TF32 backward
        main_path = {"flash_fwd_sm90": "train",
                     "flash_bwd_dq_sm90": "train",
                     "flash_bwd_dkv_sm90": "train",
                     "flash_fwd_tf32x3": "serve",
                     "flash_bwd_dq_tf32x3": "trainFloat32",
                     "flash_bwd_dkv_tf32x3": "trainFloat32"}
        missing = [name for name, path in main_path.items()
                   if name not in entries or not paths[path][name]]
        if missing:
            raise AssertionError(f"kernels never measured or never launched "
                                 f"on their path: {missing}")
    except BaseException:
        for line in log:
            print(line)
        traceback.print_exc()
        return 1
    # the line of each TPU kernel (learningorchestra_tpu/ops/attention.py)
    replaces = {"fwd": 188, "bwd_dq": 338, "bwd_dkv": 402}
    kernels = []
    for name in COUNTERS:
        op, tensor_core_route = name[len("flash_"):].rsplit("_", 1)
        entry = entries[name]
        path = main_path[name]
        # route: the kernel's language (CUDA C++, no Triton);
        # tensorCoreRoute: the port's route that launches it (_route)
        entry.update({
            "name": name, "route": "cuda",
            "tensorCoreRoute": tensor_core_route,
            "source": f"learningorchestra_tpu_torch/csrc/{name}.cu",
            "replaces": f"learningorchestra_tpu/ops/attention.py:"
                        f"{replaces[op]}",
            "launches": paths[path][name], "mainPath": path,
            "launchesByPath": {p: c[name] for p, c in paths.items()}})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    for line in log:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
