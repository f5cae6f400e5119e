#!/usr/bin/env python3
"""How far the split-TF32 kernels' results are from float32, on one card.

    python3 scripts/tf32x3_accuracy.py [--root DIR] [--classifier]

For random inputs (b 4, 8 heads over 4, non-causal) at head_dim 32 with
64, 512 and 2048 keys, and at head_dim 64 and 128 (the widest variants)
with 2048 keys, with a mean of 0 and of 3 (a common component, as the
activations of a trained model carry), prints the relative L2 error of
o, dq, dk and dv from ``flash_fwd_tf32x3``, ``flash_bwd_dq_tf32x3`` and
``flash_bwd_dkv_tf32x3`` against the float32 plain version, beside the
error of the kernels' own 3xTF32 emulation (``tf32x3=True``). An error
that grows in proportion to the keys, where the emulation's grows as
their square root, is the tensor cores' float32 accumulation drifting.
It then times the three kernels at the float32 training, serving and
classifier shapes, the d-12 shapes and at d 128 (b 2, 2048 tokens).
With ``--classifier`` it trains ``chip_smoke.py``'s TextClassifier (bf16, 3 epochs) and, in float32,
holds one gradient micro-step of each pairing of the forward and the
backward (kernel or emulation) against the dense path, before and after
training.

``--root`` imports the port and ``chip_smoke.py`` from another tree (an
unpacked ``git archive`` of another commit), so two versions compare in
one call. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--classifier", action="store_true")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tf32x3_accuracy: no CUDA device", file=sys.stderr)
        return 2
    smoke = types.ModuleType("chip_smoke")
    with open(os.path.join(root, "chip_smoke.py")) as f:
        exec(compile(f.read(), "chip_smoke.py", "exec"), smoke.__dict__)
    from learningorchestra_tpu_torch.ops import _build
    from learningorchestra_tpu_torch.ops import attention as attn

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": root, "ptxas": {
        name: smoke._ptxas_report(text)
        for name, text in _build.BUILD_LOG.items() if "tf32x3" in name}}

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    rows = []
    # head_dim 32 at three key counts; 64 and 128 (the widest variants,
    # where the registers run out) at the longest
    cases = [(32, sk) for sk in (64, 512, 2048)] + [(64, 2048), (128, 2048)]
    for d, sk in cases:
        for mean in (0.0, 3.0):
            b, h, kvh = 4, 8, 4

            def rand(*shape, mean=mean):
                return torch.randn(*shape, device="cuda",
                                   generator=gen) + mean

            q, k, v = rand(b, sk, h, d), rand(b, sk, kvh, d), \
                rand(b, sk, kvh, d)
            do = rand(b, sk, h, d, mean=0.0)
            scale = d ** -0.5
            plain_o, plain_lse = attn.flash_attention_reference(
                q, k, v, causal=False)
            plain = (plain_o,) + attn.flash_bwd_reference(
                q, k, v, plain_o, plain_lse, do, causal=False, scale=scale)
            o, lse = attn._flash_fwd(q, k, v, False, scale, 0, 0)
            delta = attn._bwd_delta(o, do, None)
            bwd = (q, k, v, do, lse, delta, False, scale, 0, 0)
            kernel = (o, attn._flash_bwd_dq_tf32x3(*bwd),
                      *attn._flash_bwd_dkv_tf32x3(*bwd))
            emul_o, emul_lse = attn.flash_attention_reference(
                q, k, v, causal=False, tf32x3=True)
            emul = (emul_o,) + attn.flash_bwd_reference(
                q, k, v, emul_o, emul_lse, do, causal=False, scale=scale,
                tf32x3=True)
            rows.append({"headDim": d, "keys": sk, "mean": mean,
                         "relL2VsFloat32": {
                "kernel": dict(zip(("o", "dq", "dk", "dv"),
                                   (rel(x, y) for x, y in zip(kernel,
                                                              plain)))),
                "emulation": dict(zip(("o", "dq", "dk", "dv"),
                                      (rel(x, y) for x, y in zip(emul,
                                                                 plain))))}})
    out["accuracy"] = rows

    shapes = {"trainFloat32": (8, 2048, 8, 4, 64, True, 1024, torch.float32),
              "serveFloat32": (1, 1536, 8, 4, 64, True, 1024, torch.float32),
              "classifierFloat32": (128, 512, 8, 4, 32, False, 0,
                                    torch.float32),
              "d12Float32": (2, 2048, 8, 4, 12, True, 1024, torch.float32),
              "d128Float32": (2, 2048, 8, 4, 128, True, 1024,
                              torch.float32),
              "d12Bfloat16": (2, 2048, 8, 4, 12, True, 1024,
                              torch.bfloat16)}
    times = {}
    for name, (b, s, h, kvh, d, causal, window, dtype) in shapes.items():
        def rand(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

        q, k, v, do = rand(b, s, h, d), rand(b, s, kvh, d), \
            rand(b, s, kvh, d), rand(b, s, h, d)
        scale = d ** -0.5
        o, lse = attn._flash_fwd_tf32x3(q, k, v, causal, scale, window, 0)
        lse = lse.contiguous()
        delta = attn._bwd_delta(o, do, None).contiguous()
        bwd = (q, k, v, do, lse, delta, causal, scale, window, 0)
        times[name] = {
            "fwdMs": smoke._time_ms(torch, lambda: attn._flash_fwd_tf32x3(
                q, k, v, causal, scale, window, 0)),
            "dqMs": smoke._time_ms(
                torch, lambda: attn._flash_bwd_dq_tf32x3(*bwd)),
            "dkvMs": smoke._time_ms(
                torch, lambda: attn._flash_bwd_dkv_tf32x3(*bwd))}
    out["times"] = times
    if args.classifier:
        out["classifier"] = _classifier(smoke, attn, np, torch)
    print(json.dumps(out), flush=True)
    return 0


def _classifier(smoke, attn, np, torch) -> dict:
    """Per-tensor relative L2 (worst tensor) of one float32 gradient
    micro-step (8 rows) against the dense path, for each pairing of the
    forward and the backward as kernel or emulation."""
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.encoder import TextClassifier
    from learningorchestra_tpu_torch.runtime.data import MASK_KEY

    x, y = smoke._marker_rows(np, smoke.CLF_ROWS, smoke.CLF_SEQ,
                              smoke.CLF_CONFIG["vocab_size"], seed=0)
    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    clf = TextClassifier(**smoke.CLF_CONFIG, attention="flash",
                         device="cuda")
    clf.fit(x, y, batch_size=smoke.CLF_BATCH, epochs=smoke.CLF_EPOCHS)
    states = {"init": weights.params_from_flax(weights.init_params(
        dict(smoke.CLF_CONFIG), 0)),
        "trained": {k: t.detach().cpu() for k, t in clf.params.items()}}
    kernel_fwd, kernel_bwd = attn._flash_fwd, attn._flash_bwd

    def emul_fwd(q, k, v, causal, scale, window, offset):
        o, lse = attn.flash_attention_reference(
            q, k, v, causal=causal, scale=scale, window=window,
            kv_offset=offset, tf32x3=True)
        return o, lse.contiguous()

    def emul_bwd(q, k, v, o, lse, do, dlse, causal, scale, window, offset):
        return attn.flash_bwd_reference(
            q, k, v, o, lse, do, dlse, causal=causal, scale=scale,
            window=window, kv_offset=offset, tf32x3=True)

    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    out = {}
    try:
        for wname, state in states.items():
            grads = {}
            for name, fwd, bwd, impl in (
                    ("dot", kernel_fwd, kernel_bwd, "dot"),
                    ("kernelFwdKernelBwd", kernel_fwd, kernel_bwd, "flash"),
                    ("kernelFwdEmulatedBwd", kernel_fwd, emul_bwd, "flash"),
                    ("emulatedFwdKernelBwd", emul_fwd, kernel_bwd, "flash"),
                    ("emulatedFwdEmulatedBwd", emul_fwd, emul_bwd,
                     "flash")):
                attn._flash_fwd, attn._flash_bwd = fwd, bwd
                model = TextClassifier(**smoke.CLF_CONFIG, attention=impl,
                                       device="cuda")
                model.set_params(state)
                eng = model._get_engine()
                batch = eng._to_device({"x": x[:8], "y": y[:8],
                                        MASK_KEY: np.ones(8, np.float32)},
                                       model.device)
                grads[name], _ = eng._micro_grads(
                    dict(model.module.named_parameters()), batch, 0)
            for name, g in grads.items():
                if name == "dot":
                    continue
                rel = {k: ((g[k] - grads["dot"][k]).norm()
                           / grads["dot"][k].norm()).item() for k in g}
                worst = max(rel, key=rel.get)
                out[f"{wname}.{name}"] = {"worst": worst, "max": rel[worst]}
    finally:
        attn._flash_fwd, attn._flash_bwd = kernel_fwd, kernel_bwd
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    return out


if __name__ == "__main__":
    sys.exit(main())
