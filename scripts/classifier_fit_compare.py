#!/usr/bin/env python3
"""The classifier's bf16 fit, timed in one or more checkouts on one NVIDIA
card.

    python3 scripts/classifier_fit_compare.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository: ``.``, or another commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists
(``build/``). In the order given, each runs in a process of its own,
which builds that checkout's kernels, fits chip_smoke.py's
``TextClassifier`` (the tutorial's: 4 layers, d_model 256, 8 heads over
4, head_dim 32; 1024 rows of 512 tokens, batch 128, 3 epochs, bf16,
flash attention) from its seeded rows, and profiles one more epoch with
``torch.profiler``: device time by kernel and op, largest first. Give the
roots in turns (parent, change, change, parent) to compare two commits
on one card. Prints the card's name and power limit, then one JSON line
per root and section. Exits 2 without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def _one(root: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from learningorchestra_tpu_torch.models.encoder import TextClassifier
    from learningorchestra_tpu_torch.ops import _build

    _build.build()
    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    x, y = cs._marker_rows(np, cs.CLF_ROWS, cs.CLF_SEQ,
                           cs.CLF_CONFIG["vocab_size"], seed=0)
    clf = TextClassifier(**cs.CLF_CONFIG, attention="flash", device="cuda")
    hist = clf.fit(x, y, batch_size=cs.CLF_BATCH,
                   epochs=cs.CLF_EPOCHS).history
    print(json.dumps({"root": root, "epochSeconds": hist["epochSeconds"],
                      "loss": hist["loss"]}), flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        clf.fit(x, y, batch_size=cs.CLF_BATCH, epochs=1)
        torch.cuda.synchronize()
    rows = []
    for event in prof.key_averages():
        ms = (getattr(event, "device_time_total", None)
              or getattr(event, "cuda_time_total", 0)) / 1e3
        if ms:
            rows.append((event.key[:70], round(ms, 4), event.count))
    rows.sort(key=lambda r: -r[1])
    print(json.dumps({"root": root, "profiledEpochDeviceMs": rows[:14]}),
          flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        _one(sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("classifier_fit_compare: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"device: {smi.stdout.strip()}", flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
