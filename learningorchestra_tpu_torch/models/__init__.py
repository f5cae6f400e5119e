"""Model layer of the port: the decoder-only language model."""

from learningorchestra_tpu_torch.models.transformer import (  # noqa: F401
    LanguageModel,
    TransformerLM,
)
