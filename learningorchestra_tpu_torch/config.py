"""Configuration of the PyTorch port: the fields its serving and training
slices and its pipeline services read.

Environment variables keep the JAX package's names and defaults
(``LO_HOME``, ``LO_SERVE_MAX_BATCH``, ``LO_SERVE_QUEUE``,
``LO_REQUEST_TIMEOUT``, ``LO_COMPUTE_DTYPE``, ``LO_MAX_WORKERS``). The
device is chosen in code only (``device=`` or ``--device``). A
:class:`Config` is an object the caller creates and passes down; there
is no process-wide singleton.
"""

from __future__ import annotations

import dataclasses
import os

import torch

API_PREFIX = "/api/learningOrchestra/v1"


@dataclasses.dataclass
class Config:
    # storage root (artifacts live under <home>/artifacts)
    home: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_HOME", os.path.join(os.getcwd(), ".lo_store")))
    # worker threads of the job manager
    max_workers: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("LO_MAX_WORKERS", "8")))
    # default slot count of an LM serving session (maxSlots)
    serve_max_batch: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_SERVE_MAX_BATCH", "8")))
    # bounded request queue per serving session; full -> 429
    serve_queue_depth: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("LO_SERVE_QUEUE", "64")))
    # how long a predict waits for its tokens (0 = no limit) -> 503
    request_timeout_seconds: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_REQUEST_TIMEOUT", "0")))
    # torch device the models run on; "cpu" only when asked for
    device: str = "cuda"
    # training: the batch size when fit() is given none, and the dtype
    # the forward and backward compute in over float32 master params
    default_batch_size: int = 128
    compute_dtype: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_COMPUTE_DTYPE",
                                               "bfloat16"))

    @property
    def artifacts_dir(self) -> str:
        return os.path.join(self.home, "artifacts")

    @property
    def datasets_dir(self) -> str:
        return os.path.join(self.home, "datasets")

    @property
    def catalog_path(self) -> str:
        return os.path.join(self.home, "catalog.sqlite")


def resolve_device(device) -> torch.device:
    """The torch device for ``device``. A CUDA device with no card
    raises: entry points never carry on on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                f"available (pass device='cpu' to run on the CPU)")
        # the JAX serving path computes at the params' float32: keep
        # float32 matmuls and convolutions out of TF32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
