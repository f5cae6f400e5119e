"""The services' shared state: config, catalog, artifact store, job
manager, the ``$`` resolver and the serving plane."""

from __future__ import annotations

import dataclasses
from typing import Optional

from learningorchestra_tpu_torch.catalog.artifacts import ArtifactStore
from learningorchestra_tpu_torch.catalog.store import Catalog
from learningorchestra_tpu_torch.config import Config, resolve_device
from learningorchestra_tpu_torch.services.jobs import JobManager
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
        self.catalog = Catalog(config.catalog_path, config.datasets_dir)
        self.artifacts = ArtifactStore(config.artifacts_dir,
                                       device=self.device)
        self.jobs = JobManager(self.catalog, max_workers=config.max_workers)
        self.params = ParameterResolver(self)
        self.serving = ServingManager(self)

    def close(self) -> None:
        self.jobs.shutdown()
        self.serving.close()
        self.catalog.close()
