"""Explore and Transform by reflection (the port's
``services/database_executor.py``).

``POST /{explore,transform}/{tool}`` takes ``name``, ``description``,
``modulePath``, ``class``, ``classParameters``, ``method`` and
``methodParameters``: the class (of any module path the validators
admit) is instantiated afresh for the request, with ``$``/``#`` values
resolved, and its method's result is the artifact (with no ``method``,
the instance is):

- ``explore/*``: the result is drawn as a PNG (:func:`render_plot_png`),
  which ``GET /explore/{tool}/{name}`` answers as ``image/png``. The job
  imports matplotlib and seaborn; where they are missing it fails with
  an ``ImportError`` document that names them;
- ``transform/*``: the result (a fitted scaler, a transformed array) is
  stored for later steps.

PATCH re-runs with new parameters, DELETE removes the collection and
the artifact.
"""

from __future__ import annotations

import io
from typing import Any, Dict, Tuple

from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.config import API_PREFIX
from learningorchestra_tpu_torch.services import validators as V

NAME_FIELD = "name"
DESCRIPTION_FIELD = "description"
MODULE_PATH_FIELD = "modulePath"
CLASS_FIELD = "class"
CLASS_PARAMETERS_FIELD = "classParameters"
METHOD_FIELD = "method"
METHOD_PARAMETERS_FIELD = "methodParameters"


def _plotting():
    """matplotlib's pyplot and seaborn, imported by the job that draws."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns
    except ImportError as exc:
        raise ImportError(
            f"an explore plot needs matplotlib and seaborn, and this "
            f"server cannot import them ({exc})") from None
    return plt, sns


def render_plot_png(result: Any) -> bytes:
    """An explore result as PNG bytes: a matplotlib figure or axes as
    drawn, anything array-shaped as a seaborn scatterplot of its first two
    columns (of one column against the row number)."""
    import numpy as np

    plt, sns = _plotting()
    if hasattr(result, "savefig"):  # a Figure
        fig = result
    elif hasattr(result, "get_figure"):  # an Axes
        fig = result.get_figure()
    else:
        if hasattr(result, "toarray"):  # scipy sparse
            result = result.toarray()
        arr = np.asarray(result)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        x = arr[:, 0]
        y = arr[:, 1] if arr.shape[1] >= 2 else np.arange(len(arr))
        ax = sns.scatterplot(x=x, y=y)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        fig = ax.get_figure()
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    return buf.getvalue()


class DatabaseExecutorService:
    def __init__(self, context):
        self._ctx = context
        self._validator = V.RequestValidator(context)

    def create(self, body: Dict[str, Any], verb: str, tool: str,
               ) -> Tuple[int, Dict[str, Any]]:
        self._validator.required_fields(
            body, [NAME_FIELD, MODULE_PATH_FIELD, CLASS_FIELD])
        name = self._validator.safe_name(body[NAME_FIELD])
        module_path = body[MODULE_PATH_FIELD]
        class_name = body[CLASS_FIELD]
        class_parameters = body.get(CLASS_PARAMETERS_FIELD) or {}
        method = body.get(METHOD_FIELD) or ""
        method_parameters = body.get(METHOD_PARAMETERS_FIELD) or {}
        description = body.get(DESCRIPTION_FIELD, "")
        self._validator.not_duplicate(name)
        cls = self._validator.valid_class(module_path, class_name)
        self._validator.valid_class_parameters(cls, class_parameters)
        if method:
            self._validator.valid_method(cls, method)
            self._validator.valid_method_parameters(
                cls, method, method_parameters)
        type_string = D.normalize_type(f"{verb}/{tool}")
        self._ctx.catalog.create_collection(name, type_string, {
            D.MODULE_PATH_FIELD: module_path,
            D.CLASS_FIELD: class_name,
            D.CLASS_PARAMETERS_FIELD: class_parameters,
            D.METHOD_FIELD: method,
            D.METHOD_PARAMETERS_FIELD: method_parameters,
            D.DESCRIPTION_FIELD: description,
        })
        self._submit(name, type_string, cls, class_parameters, method,
                     method_parameters, description, verb)
        return V.HTTP_CREATED, {"result": f"{API_PREFIX}/{verb}/{tool}/{name}"}

    def update(self, name: str, body: Dict[str, Any], verb: str, tool: str,
               ) -> Tuple[int, Dict[str, Any]]:
        meta = self._validator.existing(name)
        method = body.get(METHOD_FIELD, meta.get(D.METHOD_FIELD)) or ""
        method_parameters = body.get(
            METHOD_PARAMETERS_FIELD,
            meta.get(D.METHOD_PARAMETERS_FIELD)) or {}
        class_parameters = body.get(
            CLASS_PARAMETERS_FIELD, meta.get(D.CLASS_PARAMETERS_FIELD)) or {}
        description = body.get(DESCRIPTION_FIELD, "")
        cls = self._validator.valid_class(
            meta[D.MODULE_PATH_FIELD], meta[D.CLASS_FIELD])
        if method:
            self._validator.valid_method(cls, method)
        self._ctx.catalog.update_metadata(
            name, {D.METHOD_PARAMETERS_FIELD: method_parameters,
                   D.CLASS_PARAMETERS_FIELD: class_parameters,
                   D.FINISHED_FIELD: False})
        self._submit(name, meta[D.TYPE_FIELD], cls, class_parameters,
                     method, method_parameters, description, verb)
        return V.HTTP_SUCCESS, {"result": f"{API_PREFIX}/{verb}/{tool}/{name}"}

    def image_response(self, name: str) -> Tuple[bytes, str]:
        """The PNG of ``GET /explore/{tool}/{name}`` and its type."""
        meta = self._validator.existing(name)
        path, content_type = self._ctx.artifacts.bytes_path(
            name, meta[D.TYPE_FIELD])
        with open(path, "rb") as f:
            return f.read(), content_type

    def _submit(self, name: str, type_string: str, cls,
                class_parameters: Dict[str, Any], method: str,
                method_parameters: Dict[str, Any], description: str,
                verb: str) -> None:
        def run():
            instance = cls(**self._ctx.params.treat(class_parameters))
            if method:
                result = getattr(instance, method)(
                    **self._ctx.params.treat(method_parameters))
            else:
                result = instance
            if verb == "explore":
                self._ctx.artifacts.save_bytes(
                    render_plot_png(result), name, type_string,
                    filename="plot.png", content_type="image/png")
            else:
                self._ctx.artifacts.save(result, name, type_string)
            return result

        self._ctx.jobs.submit(name, run, description=description,
                              parameters=method_parameters)
