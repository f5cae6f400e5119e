"""The services' shared state: config, artifact store, artifact lookup
and the serving plane."""

from __future__ import annotations

import dataclasses
from typing import Optional

from learningorchestra_tpu_torch.catalog.artifacts import ArtifactStore
from learningorchestra_tpu_torch.config import Config, resolve_device
from learningorchestra_tpu_torch.services.params import ParameterResolver
from learningorchestra_tpu_torch.services.serving import ServingManager


class ServiceContext:
    def __init__(self, config: Optional[Config] = None,
                 device: Optional[str] = None):
        config = config or Config()
        if device is not None:
            config = dataclasses.replace(config, device=device)
        self.config = config
        self.device = resolve_device(config.device)
        self.artifacts = ArtifactStore(config.artifacts_dir,
                                       device=self.device)
        self.params = ParameterResolver(self)
        self.serving = ServingManager(self)

    def close(self) -> None:
        self.serving.close()
