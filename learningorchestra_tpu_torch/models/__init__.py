"""Model layer of the port: the decoder-only language model and the
sequence classifier over the bidirectional encoder."""

from learningorchestra_tpu_torch.models.encoder import (  # noqa: F401
    TextClassifier,
    TransformerEncoder,
)
from learningorchestra_tpu_torch.models.transformer import (  # noqa: F401
    LanguageModel,
    TransformerLM,
)
