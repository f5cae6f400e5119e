"""Columnar dataset steps: Histogram, DataType and Projection (the port's
``services/columnar.py``, over the catalog's numpy columns: no pandas,
no pyarrow).

- **Histogram** (``POST /explore/histogram``): one document per field,
  ``{field: [{"_id": value, "count": n}, ...]}``, the buckets in the
  order of each value's first row and a null as ``None`` (pyarrow's
  ``value_counts``, which the JAX package calls).
- **DataType** (``POST /transform/dataType``): rewrites the dataset in
  place. ``"number"`` turns ``""`` into a null and parses the rest as
  pandas' ``to_numeric`` does; the column stays integral when every
  value is (the JAX package's ``Int64`` downcast), else float.
  ``"string"`` writes each value as pandas' ``astype(str)`` after the
  JAX package's ``to_pandas`` (an int column with nulls is float there,
  so ``1`` becomes ``"1.0"``), a null as ``""``.
- **Projection** (``POST /transform/projection``): the named columns,
  in the request's order, written to a new dataset.

Request fields are the reference's: ``inputDatasetName``,
``outputDatasetName`` and ``names`` (projection, histogram);
``datasetName`` and ``types`` (dataType).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.config import API_PREFIX
from learningorchestra_tpu_torch.native import ops
from learningorchestra_tpu_torch.services import validators as V

INPUT_FIELD = "inputDatasetName"
OUTPUT_FIELD = "outputDatasetName"
NAMES_FIELD = "names"
DATASET_NAME_FIELD = "datasetName"
TYPES_FIELD = "types"

STRING_TYPE = "string"
NUMBER_TYPE = "number"

# what pandas' to_numeric parses as an integer, else as a float
_INT_TEXT = re.compile(r"^\s*[+-]?\d+\s*$")


# ``(value, count)`` of a column in the order of each value's first row;
# nulls count as one ``None`` value and NaNs as one NaN (the C++ core's
# hash counts, or np.unique where the core is off)
value_counts = ops.value_counts


def _is_null(value: Any) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def _to_number(value: Any, position: int) -> Any:
    """One value as pandas' ``to_numeric`` parses it (None for a null)."""
    if _is_null(value) or value == "":
        return None
    if isinstance(value, str):
        if _INT_TEXT.match(value):
            return int(value)
        try:
            return float(value)
        except ValueError:
            raise ValueError(f"Unable to parse string \"{value}\" at "
                             f"position {position}") from None
    if isinstance(value, bool):
        return int(value)
    return value


def to_number_column(values: List[Any]) -> np.ma.MaskedArray:
    """A column of values as numbers: int64 when every present value is
    integral, else float64; nulls masked."""
    parsed = [_to_number(v, i) for i, v in enumerate(values)]
    mask = np.array([v is None for v in parsed], bool)
    present = [v for v in parsed if v is not None]
    integral = all(float(v).is_integer() for v in present)
    if integral:
        data = np.array([0 if v is None else int(v) for v in parsed],
                        np.int64)
    else:
        data = np.array([np.nan if v is None else float(v)
                         for v in parsed], np.float64)
    return np.ma.array(data, mask=mask)


def to_string_column(values: List[Any]) -> np.ndarray:
    """A column of values as text; a null is ``""``."""
    return np.array(["" if _is_null(v) else str(v) for v in values],
                    dtype=str)


def _pandas_view(kind: str, data: np.ndarray,
                 mask: Optional[np.ndarray]) -> List[Any]:
    """The column's values as the JAX package's ``to_pandas`` gives them:
    an int column with nulls is float."""
    if mask is not None and kind == "int64":
        data = data.astype(np.float64)
    values = data.tolist()
    if mask is not None:
        for i in np.flatnonzero(mask).tolist():
            values[i] = None
    return values


def _stored(data: np.ndarray, mask: Optional[np.ndarray]):
    """A stored column as the dataset writer takes it back."""
    return data if mask is None else np.ma.array(data, mask=mask)


class HistogramService:
    def __init__(self, context):
        self._ctx = context
        self._validator = V.RequestValidator(context)

    def create(self, body: Dict[str, Any], tool: str = "histogram",
               ) -> Tuple[int, Dict[str, Any]]:
        self._validator.required_fields(
            body, [INPUT_FIELD, OUTPUT_FIELD, NAMES_FIELD])
        parent = body[INPUT_FIELD]
        name = self._validator.safe_name(body[OUTPUT_FIELD])
        fields = body[NAMES_FIELD]
        self._validator.not_duplicate(name)
        self._validator.existing_finished(parent)
        self._validator.valid_fields(parent, fields)
        self._ctx.catalog.create_collection(
            name, D.EXPLORE_HISTOGRAM_TYPE,
            {D.PARENT_NAME_FIELD: parent, D.FIELDS_FIELD: fields})
        self._ctx.jobs.submit(
            name, lambda: self._run(parent, name, fields),
            description=f"histogram of {parent}",
            parameters={NAMES_FIELD: fields})
        return V.HTTP_CREATED, {
            "result": f"{API_PREFIX}/explore/{tool}/{name}"}

    def _run(self, parent: str, name: str, fields: List[str]) -> None:
        columns = self._ctx.catalog.read_columns(parent, fields)
        for field in fields:
            _, data, mask = columns[field]
            buckets = [{"_id": v, "count": int(c)}
                       for v, c in value_counts(data, mask)]
            self._ctx.catalog.append_document(name, {field: buckets})
        self._ctx.catalog.update_metadata(name, {"rows": len(fields)})


class DataTypeService:
    def __init__(self, context):
        self._ctx = context
        self._validator = V.RequestValidator(context)

    def create(self, body: Dict[str, Any], tool: str = "dataType",
               ) -> Tuple[int, Dict[str, Any]]:
        self._validator.required_fields(
            body, [DATASET_NAME_FIELD, TYPES_FIELD])
        name = body[DATASET_NAME_FIELD]
        types = body[TYPES_FIELD]
        meta = self._validator.existing(name)
        if not meta.get(D.FINISHED_FIELD, False):
            raise V.HttpError(V.HTTP_NOT_ACCEPTABLE,
                              f"{V.MESSAGE_UNFINISHED_PARENT}: {name}")
        if not isinstance(types, dict) or not types:
            raise V.HttpError(V.HTTP_NOT_ACCEPTABLE, "invalid types")
        self._validator.valid_fields(name, list(types))
        for t in types.values():
            if t not in (STRING_TYPE, NUMBER_TYPE):
                raise V.HttpError(V.HTTP_NOT_ACCEPTABLE,
                                  f"invalid field type: {t}")
        # an in-place rewrite: not finished while it converts
        self._ctx.catalog.update_metadata(name, {D.FINISHED_FIELD: False})
        self._ctx.jobs.submit(
            name, lambda: self._run(name, types),
            description=f"dataType {types}", parameters={TYPES_FIELD: types})
        return V.HTTP_SUCCESS, {
            "result": f"{API_PREFIX}/transform/{tool}/{name}"}

    def _run(self, name: str, types: Dict[str, str]) -> None:
        # through the feature cache (the conversions below make new
        # arrays, the cached ones stay as read); the write bumps the
        # version, so the next reader reads again
        columns = self._ctx.features.columns(name)
        out = {}
        for field, (kind, data, mask) in columns.items():
            target = types.get(field)
            if target is None:
                out[field] = _stored(data, mask)
                continue
            values = _pandas_view(kind, data, mask)
            out[field] = (to_string_column(values) if target == STRING_TYPE
                          else to_number_column(values))
        with self._ctx.catalog.dataset_writer(name) as writer:
            writer.write_batch(out)
        self._ctx.catalog.update_metadata(
            name, {D.FIELDS_FIELD: list(columns)})


class ProjectionService:
    def __init__(self, context):
        self._ctx = context
        self._validator = V.RequestValidator(context)

    def create(self, body: Dict[str, Any], tool: str = "projection",
               ) -> Tuple[int, Dict[str, Any]]:
        self._validator.required_fields(
            body, [INPUT_FIELD, OUTPUT_FIELD, NAMES_FIELD])
        parent = body[INPUT_FIELD]
        name = self._validator.safe_name(body[OUTPUT_FIELD])
        fields = body[NAMES_FIELD]
        self._validator.not_duplicate(name)
        self._validator.existing_finished(parent)
        self._validator.valid_fields(parent, fields)
        self._ctx.catalog.create_collection(
            name, D.TRANSFORM_PROJECTION_TYPE,
            {D.PARENT_NAME_FIELD: parent, D.FIELDS_FIELD: fields})
        self._ctx.jobs.submit(
            name, lambda: self._run(parent, name, fields),
            description=f"projection of {parent}",
            parameters={NAMES_FIELD: fields})
        return V.HTTP_CREATED, {
            "result": f"{API_PREFIX}/transform/{tool}/{name}"}

    def _run(self, parent: str, name: str, fields: List[str]) -> None:
        columns = self._ctx.catalog.read_columns(parent, fields)
        with self._ctx.catalog.dataset_writer(name) as writer:
            writer.write_batch({f: _stored(*columns[f][1:]) for f in fields})
        self._ctx.catalog.update_metadata(
            name, {D.FIELDS_FIELD: fields,
                   "rows": self._ctx.catalog.count_rows(name)})
