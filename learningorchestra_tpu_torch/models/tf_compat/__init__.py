"""``tensorflow`` compatibility shim of the port.

The reference's REST contract names TensorFlow classes by module path
(``modulePath: "tensorflow.keras.models"``, ``class: "Sequential"``,
reference model_image/model.py:136-137) and its ``#`` DSL evaluates
expressions like ``#tensorflow.keras.optimizers.Adam(0.001)``
(binary_execution.py:52-64). Real TensorFlow is not a dependency: the
model service and the sandbox route ``tensorflow``, ``tensorflow.keras``
and ``keras`` here (services/sandbox.py ``resolve_module``), where the
keras surface is the port's ``NeuralModel`` on the card.

Importing this package, ``keras``, ``keras.layers``, ``keras.optimizers``
or ``keras.losses`` loads no torch (the sandbox's child evaluates ``#``
expressions with them); ``keras.models`` and ``keras.applications``,
which build models, load on first use.
"""

from learningorchestra_tpu_torch.models.tf_compat import keras  # noqa: F401

__version__ = "2.0-learningorchestra-torch"
