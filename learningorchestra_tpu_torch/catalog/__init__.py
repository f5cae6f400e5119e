"""Artifact store of the port."""

from learningorchestra_tpu_torch.catalog.artifacts import (  # noqa: F401
    ArtifactNotFound,
    ArtifactStore,
)
