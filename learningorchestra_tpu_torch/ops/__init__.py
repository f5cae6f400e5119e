"""Attention ops: the hand-written Hopper kernels and their plain
PyTorch versions."""

from learningorchestra_tpu_torch.ops.attention import (  # noqa: F401
    flash_attention,
    reference_attention,
)
