#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

1. Builds every CUDA source of the port (one nvcc per source, started
   together) into build/kernels/.
2. Kernel phase: each hand-written kernel against its plain PyTorch
   version on the card, at the serving prefill shape (fp32 and bf16)
   and small edge cases, with its time, the plain version's time, the
   least time the card could take (bound) and one PyTorch library call
   computing the same function, timed as a yardstick only.
3. Slice phase (the main path): a REST server on the card serving the
   tutorial's LM (vocab 32000, d_model 512, 8 layers, 8 heads over 4 kv
   heads, window 1024, random weights from seed 0), four concurrent
   predicts of 1100-1500-token prompts, 32 greedy tokens each, sent
   twice (cold, then warm). The kernel launch counts are zeroed just
   before and read just after.
   Each stream must equal the port's solo ``generate``; the prefill
   logits through the kernel must agree with the dense path.

Earlier lines print the card (nvidia-smi name and power limit), the
build time, the ``kernels`` JSON line and the phases' lines; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises and
the exit code is not 0. Without a card, or without the package beside
it, the script exits 2 and prints no result.
"""

from __future__ import annotations

import json
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
# cores, bf16 on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
LM_CONFIG = dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=8,
                 n_kv_heads=4, d_ff=0, max_len=2048, sliding_window=1024,
                 rope_base=10000.0)
PROMPT_LENS = (1100, 1234, 1367, 1500)
NEW_TOKENS = 32


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


def kernel_phase(torch, log):
    """flash_fwd against flash_attention_reference on the card. Returns
    the kernels-line entry measured at the slice's fp32 shape."""
    import torch.nn.functional as F

    from learningorchestra_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(0)
    # (name, b, sq, sk, h, kvh, d, causal, window, kv_offset, dtype)
    cases = [
        ("slice", 1, 1536, 1536, 8, 4, 64, True, 1024, 0, torch.float32),
        ("slice", 1, 1536, 1536, 8, 4, 64, True, 1024, 0, torch.bfloat16),
        # a main-path prompt length: the last q tile is ragged
        ("prefill-1500", 1, 1500, 1500, 8, 4, 64, True, 1024, 0,
         torch.float32),
        ("prefill-1500", 1, 1500, 1500, 8, 4, 64, True, 1024, 0,
         torch.bfloat16),
        ("non-causal", 2, 96, 96, 4, 2, 64, False, 0, 0, torch.float32),
        ("mqa", 2, 130, 130, 8, 1, 64, True, 0, 0, torch.float32),
        ("ragged-sk", 2, 77, 201, 4, 2, 32, False, 0, 0, torch.float32),
        ("offset-empty-rows", 2, 64, 64, 4, 4, 128, True, 16, 40,
         torch.float32),
        ("offset-empty-rows", 1, 64, 64, 4, 4, 64, True, 16, 40,
         torch.bfloat16),
    ]
    # (atol, rtol). float32: summation order only. bf16: both compute in
    # float32 and round o once, so they differ by at most one bf16 ulp of
    # |o| (<= 2**-7 |o|, under rtol) plus the float32 error (under atol)
    tols = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 1e-2)}
    entry = None
    for (name, b, sq, sk, h, kvh, d, causal, window, offset,
         dtype) in cases:
        def rand(*shape):
            return torch.randn(*shape, device="cuda", generator=gen) \
                .to(dtype)

        q, k, v = rand(b, sq, h, d), rand(b, sk, kvh, d), rand(b, sk, kvh, d)
        with_lse = h == kvh

        def kernel():
            if with_lse:
                return attn.flash_attention_with_lse(
                    q, k, v, causal=causal, window=window, kv_offset=offset)
            return attn.flash_attention(q, k, v, causal=causal,
                                        window=window), None

        def plain():
            return attn.flash_attention_reference(
                q, k, v, causal=causal, window=window, kv_offset=offset)

        o, lse = kernel()
        torch.cuda.synchronize()
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
        empty = 0
        if lse is not None:
            # rows with no visible key carry exactly NEG_INF in both
            seen = rlse != attn.NEG_INF
            if not torch.equal(seen, lse != attn.NEG_INF):
                raise AssertionError(f"flash_fwd {name}: empty rows differ")
            lse_err = (lse - rlse)[seen].abs().max().item()
            if not lse_err <= 1e-4:
                raise AssertionError(f"flash_fwd {name}: lse err {lse_err}")
            empty = int((~seen).sum())
            if offset and not empty:
                raise AssertionError(f"{name}: the case has no empty rows")
        line = {"case": name, "dtype": str(dtype).split(".")[-1],
                "shape": [b, sq, sk, h, kvh, d], "causal": causal,
                "window": window, "kvOffset": offset, "maxAbsErr": err,
                "atol": atol, "rtol": rtol, "tolUsed": excess,
                "emptyRows": empty}
        if name == "slice":
            mask = _visible_mask(torch, sq, sk, causal, window, offset,
                                 q.device)
            pairs = int(mask.sum())
            flops = 4.0 * d * pairs * h * b
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size() + 4 * b * sq * h
            dt = line["dtype"]
            op_ms = flops / PEAK_FLOPS[dt] * 1e3
            byte_ms = nbytes / PEAK_BYTES * 1e3
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            scale = 1.0 / d ** 0.5
            line.update({
                "ms": _time_ms(torch, lambda: kernel()),
                "plain_ms": _time_ms(torch, plain, iters=5),
                "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=scale,
                    enable_gqa=True)),
                "bound_ms": max(op_ms, byte_ms),
                "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                "flops": flops, "bytes": nbytes, "visiblePairs": pairs,
            })
            if dtype == torch.float32:
                entry = {k: line[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}
                entry["max_abs_err"] = err
        log.append("kernel " + json.dumps(line))
    return entry


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
    the flash_fwd launches of the main path."""
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
        attn.FLASH_FWD_LAUNCHES = 0
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
        launches = attn.FLASH_FWD_LAUNCHES
        status, deleted = _http(server.base_url, "DELETE", "/serve/lm")
        if status != 200 or deleted.get("deleted") is not True:
            raise AssertionError(f"delete: {status} {deleted}")
    finally:
        server.stop()

    need = LM_CONFIG["n_layers"] * len(prompts) * len(rounds)
    if launches < need:
        raise AssertionError(f"flash_fwd launched {launches} times on the "
                             f"main path; {len(prompts) * len(rounds)} "
                             f"prefills of {LM_CONFIG['n_layers']} layers "
                             f"need {need}")
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
        "flashLaunches": launches, "tokensEqualSolo": True,
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
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", file=sys.stderr)

    log: list = []
    try:
        entry = kernel_phase(torch, log)
        with tempfile.TemporaryDirectory() as home:
            launches = slice_phase(torch, log, home)
    except BaseException:
        for line in log:
            print(line)
        traceback.print_exc()
        return 1
    entry.update({
        "name": "flash_fwd", "route": "cuda",
        "source": "learningorchestra_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "learningorchestra_tpu/ops/attention.py:188",
        "launches": launches})
    print(json.dumps({"kernels": [entry]}))
    for line in log:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
