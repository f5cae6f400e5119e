"""The seconds of ``chip_smoke.py`` phases in two trees, on one card.

Runs ``python chip_smoke.py --only PHASES`` in the tree ``--base`` (an
unpacked parent commit) and in this checkout, in the order base,
change, change, base, and writes every phase's ``phaseSeconds`` (read
from its line) with the card's name and power limit to ``--out`` as
JSON. A run that exits non-zero is recorded with its exit code and the
end of its output, and the script exits 1.

    python scripts/phase_walls.py --base archive/parent \\
        --phases ingest,builder,distributed --out walls.json
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


def _run(tree: str, phases: str, timeout: float) -> dict:
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--only",
                           phases], cwd=tree, capture_output=True,
                          text=True, timeout=timeout)
    out = {"tree": tree, "rc": proc.returncode,
           "commandSeconds": time.monotonic() - t0, "phaseSeconds": {}}
    for line in proc.stdout.splitlines():
        name, _, rest = line.partition(" ")
        if name in phases.split(",") and rest.startswith("{"):
            out["phaseSeconds"][name] = json.loads(rest).get("phaseSeconds")
    if proc.returncode != 0:
        out["stdoutTail"] = proc.stdout[-4000:]
        out["stderrTail"] = proc.stderr[-4000:]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True)
    ap.add_argument("--phases", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    base = os.path.abspath(args.base)
    runs = []
    for tree in (base, ROOT, ROOT, base):
        runs.append(_run(tree, args.phases, args.timeout))
        print(json.dumps({k: v for k, v in runs[-1].items()
                          if k in ("tree", "rc", "commandSeconds",
                                   "phaseSeconds")}), flush=True)
    result = {"card": _card(), "order": "base, change, change, base",
              "runs": runs}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
