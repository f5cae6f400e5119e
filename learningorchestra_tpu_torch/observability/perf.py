"""Roofline performance observability of the port (the counterpart of
the JAX package's ``observability/perf.py``, docs/OBSERVABILITY.md).

The single source of truth for what the card CAN do and what each
program ACHIEVED against it:

- a registry of per-card dense bf16 peak FLOP/s and peak HBM bandwidth
  (public spec-sheet numbers of NVIDIA's H100 cards, substring-matched
  against ``torch.cuda.get_device_name()``, most specific name first;
  ``None`` on the CPU and on a card the table does not know, where a
  roofline is not meaningful; ``LO_PEAK_TFLOPS_PER_CHIP`` /
  ``LO_PEAK_HBM_GBPS`` override it — for cards the table predates, or to
  pin a roofline on the CPU in tests);
- :func:`roofline` — achieved TFLOP/s per card, MFU, and with a bytes
  count achieved GB/s, arithmetic intensity and a compute-/bandwidth-
  bound classification against the ridge point. torch has no
  bytes-accessed count of a train step, so a train window reports the
  FLOP side only (bytes 0, as the JAX function does without them); the
  serving decode roofline keeps its analytic bytes;
- a bounded per-job report registry fed by the engine once per epoch
  window and read by ``GET /observability/perf/{name}`` plus the
  ``lo_mfu`` / ``lo_tflops_per_chip`` / ``lo_hbm_bw_util_frac`` gauges on
  ``/metrics``.

``LO_PERF=0`` disables the extended block and the registry (the
``tflopsPerSecPerChip``/``mfu`` history fields stay); nothing here may
ever fail or stall the job it observes.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from learningorchestra_tpu_torch.runtime import locks

# (substring of the lower-cased device name, row, dense bf16 FLOP/s,
# HBM bytes/s), most specific first. Public spec-sheet numbers:
# - H100 NVL: NVIDIA H100 NVL datasheet — BF16 Tensor Core 1,671
#   TFLOP/s with sparsity, so 835.5 dense; HBM3 3.9 TB/s.
# - H100 PCIe: NVIDIA H100 Tensor Core GPU Architecture whitepaper,
#   table "H100 PCIe" — peak BF16 Tensor (FP32 accumulate) 756 TFLOP/s
#   dense; HBM2e 2.0 TB/s (datasheet).
# - H100 SXM5 80GB HBM3 (the name torch reports: "NVIDIA H100 80GB
#   HBM3"): the same whitepaper, table "H100 SXM5" — peak BF16 Tensor
#   (FP32 accumulate) 989.4 TFLOP/s dense; HBM3 3.35 TB/s (datasheet).
PEAKS: Tuple[Tuple[str, str, float, float], ...] = (
    ("h100 nvl", "H100 NVL", 835.5e12, 3.9e12),
    ("h100 pcie", "H100 PCIe", 756.0e12, 2.0e12),
    ("h100 80gb hbm3", "H100 SXM5 80GB HBM3", 989.4e12, 3.35e12),
    ("h100 sxm", "H100 SXM5 80GB HBM3", 989.4e12, 3.35e12),
)

_MAX_JOBS = 128

_lock = locks.make_lock("perf.registry")
_reports: "collections.OrderedDict[str, Dict[str, Any]]" = \
    collections.OrderedDict()


def enabled() -> bool:
    """Master switch for the extended roofline block + registry
    (``LO_PERF``, default on). Read per call, as in the JAX package."""
    return os.environ.get("LO_PERF", "1") not in ("0", "false", "no")


def _device() -> Tuple[str, str]:
    """``(platform, device name)`` of the card this process computes
    on: ``("cuda", torch.cuda.get_device_name(0))``, else ``("cpu",
    "")``."""
    import torch

    if torch.cuda.is_available():
        return "cuda", torch.cuda.get_device_name(0)
    return "cpu", ""


def match(kind: str) -> Optional[Tuple[str, float, float]]:
    """``(row, peak FLOP/s, peak HBM bytes/s)`` of the registry row
    ``kind`` (a device name) matches, or None."""
    kind = kind.lower()
    for key, row, flops, hbm in PEAKS:
        if key in kind:
            return row, flops, hbm
    return None


def _env_peak(name: str, scale: float) -> Optional[float]:
    env = os.environ.get(name)
    if env:
        try:
            return float(env) * scale
        except ValueError:
            pass
    return None


def _matched() -> Optional[Tuple[str, float, float]]:
    try:
        platform, kind = _device()
    except Exception:  # noqa: BLE001 — no backend, no roofline
        return None
    return match(kind) if platform == "cuda" else None


def peak_flops_per_chip() -> Optional[float]:
    """Dense bf16 peak of the current card, None on the CPU and on an
    unknown card (MFU is only meaningful against a hardware roofline).
    ``LO_PEAK_TFLOPS_PER_CHIP`` overrides the table."""
    env = _env_peak("LO_PEAK_TFLOPS_PER_CHIP", 1e12)
    if env is not None:
        return env
    row = _matched()
    return row[1] if row else None


def peak_hbm_bytes_per_chip() -> Optional[float]:
    """Peak HBM bandwidth (bytes/s) of the current card, None on the CPU
    and on an unknown card. ``LO_PEAK_HBM_GBPS`` overrides the table."""
    env = _env_peak("LO_PEAK_HBM_GBPS", 1e9)
    if env is not None:
        return env
    row = _matched()
    return row[2] if row else None


def platform_summary() -> Dict[str, Any]:
    """The roofline this process measures against: platform, card name,
    the registry row it matched (``peakSource``, absent when none did),
    peaks and the ridge point (flops/byte above which a program is
    compute-bound)."""
    try:
        platform, kind = _device()
    except Exception:  # noqa: BLE001
        platform, kind = "unknown", ""
    peak_f = peak_flops_per_chip()
    peak_b = peak_hbm_bytes_per_chip()
    out: Dict[str, Any] = {
        "platform": platform,
        "deviceKind": kind,
        "peakTflopsPerChip": (round(peak_f / 1e12, 2)
                              if peak_f else None),
        "peakHbmGbPerSec": (round(peak_b / 1e9, 1) if peak_b else None),
    }
    row = match(kind) if platform == "cuda" else None
    if row is not None:
        out["peakSource"] = row[0]
    if peak_f and peak_b:
        out["ridgeFlopsPerByte"] = round(peak_f / peak_b, 2)
    return out


def roofline(flops_per_step: float, bytes_per_step: float, steps: int,
             dt: float, n_chips: int) -> Dict[str, Any]:
    """Roofline position of ``steps`` steady-state steps over ``dt``
    seconds on ``n_chips`` chips.

    Always emits ``tflopsPerSecPerChip`` (+ ``mfu`` when a peak is
    known) — the history fields. With ``bytes_per_step`` and
    :func:`enabled`, adds achieved ``gbPerSecPerChip``,
    ``arithmeticIntensity`` (flops/byte), ``hbmBwUtil`` and the
    ``boundBy`` classification against the ridge point. On the CPU or an
    unknown card with no override every peak-relative field is simply
    absent — never a division by a made-up number."""
    out: Dict[str, Any] = {}
    if not flops_per_step or steps <= 0 or dt <= 0 or n_chips <= 0:
        return out
    achieved_flops = flops_per_step * steps / dt / n_chips
    out["tflopsPerSecPerChip"] = round(achieved_flops / 1e12, 4)
    peak_f = peak_flops_per_chip()
    if peak_f:
        out["mfu"] = round(achieved_flops / peak_f, 4)
    if not enabled() or not bytes_per_step:
        return out
    achieved_bytes = bytes_per_step * steps / dt / n_chips
    out["gbPerSecPerChip"] = round(achieved_bytes / 1e9, 3)
    intensity = flops_per_step / bytes_per_step
    out["arithmeticIntensity"] = round(intensity, 3)
    peak_b = peak_hbm_bytes_per_chip()
    if peak_b:
        out["hbmBwUtil"] = round(min(achieved_bytes / peak_b, 1.0), 4)
    if peak_f and peak_b:
        # below the ridge the memory system, not the tensor cores,
        # caps the program (decode lives here)
        out["boundBy"] = ("compute" if intensity >= peak_f / peak_b
                          else "bandwidth")
    return out


# ----------------------------------------------------------------------
# per-job report registry (train jobs; serving reports come live from
# ServingManager stats)
def record_job(job: str, report: Dict[str, Any]) -> None:
    """Upsert ``job``'s latest roofline window (bounded LRU, like the
    timeline rings). No-op when LO_PERF=0."""
    if not enabled():
        return
    entry = dict(report)
    entry["updatedAt"] = time.time()
    with _lock:
        _reports[job] = entry
        _reports.move_to_end(job)
        while len(_reports) > _MAX_JOBS:
            _reports.popitem(last=False)


def job_report(job: str) -> Optional[Dict[str, Any]]:
    with _lock:
        report = _reports.get(job)
        return dict(report) if report else None


def known_jobs() -> List[str]:
    with _lock:
        return list(_reports.keys())


def latest(limit: int = 32) -> Dict[str, Dict[str, Any]]:
    """The most recently updated reports (newest last), for the
    ``/metrics`` gauges — bounded so the exposition stays scrape-sized
    even after hundreds of jobs."""
    with _lock:
        names = list(_reports.keys())[-max(0, int(limit)):]
        return {n: dict(_reports[n]) for n in names}


def reset() -> None:
    with _lock:
        _reports.clear()
