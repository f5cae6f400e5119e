"""Model layer of the port: the decoder-only language model, the
sequence classifier over the bidirectional encoder, the keras-shaped
``NeuralModel`` and the hyperparameter sweeps over them."""

from learningorchestra_tpu_torch.models.encoder import (  # noqa: F401
    TextClassifier,
    TransformerEncoder,
)
from learningorchestra_tpu_torch.models.neural import NeuralModel  # noqa: F401
from learningorchestra_tpu_torch.models.sweep import (  # noqa: F401
    GridSearch,
    RandomSearch,
)
from learningorchestra_tpu_torch.models.transformer import (  # noqa: F401
    LanguageModel,
    TransformerLM,
)
