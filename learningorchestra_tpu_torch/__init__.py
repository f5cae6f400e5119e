"""learningOrchestra on PyTorch and CUDA: the port of
:mod:`learningorchestra_tpu` to one NVIDIA Hopper card.

The JAX package stays the reference; this package keeps its module
paths and names, imports ``torch`` and never ``jax`` or anything of the
JAX package, and replaces each Pallas TPU kernel with a kernel written
by hand for ``sm_90a``. Entry points run on ``device="cuda"`` unless the
caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
