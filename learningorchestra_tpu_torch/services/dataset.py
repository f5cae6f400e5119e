"""Dataset service: CSV ingest and the universal read API, as the JAX
package's ``services/dataset.py`` serves them.

- ``POST /dataset/csv`` with ``datasetName`` and ``datasetURI`` (an
  ``http(s)://`` URL, a local path or a ``file://`` URI) ingests on a
  job: the bytes stream in through ``urllib`` (never held whole), the
  standard ``csv`` module parses, and each column's kind is inferred
  from its first
  chunk of rows as pyarrow's CSV reader infers it for these kinds:
  int64, else float64, else bool (``1``/``0`` and ``true``/``false`` in
  three spellings), else string. An empty cell (or another of pyarrow's
  null spellings) is a null in a column of another kind and stays text
  in a string column; a column of nulls only is null throughout.
- ``POST /dataset/generic`` stores the bytes behind ``datasetURI`` as
  they are (an artifact named after the URI's last path segment; the
  metadata gets ``sizeBytes``).
- ``GET /{service}/{tool}/{name}?skip&limit&query`` reads any collection
  (metadata document, rows, execution documents), ``GET
  /{service}/{tool}`` lists, ``DELETE`` removes.
"""

from __future__ import annotations

import csv
import io
import itertools
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.services import validators as V

DATASET_NAME_FIELD = "datasetName"
DATASET_URI_FIELD = "datasetURI"

# rows per parsed chunk; the first chunk fixes each column's kind
_CHUNK_ROWS = 65536
# pyarrow's default null spellings and boolean spellings
_NULLS = frozenset(("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                    "-NaN", "-nan", "1.#IND", "1.#QNAN", "N/A", "NA", "NULL",
                    "NaN", "n/a", "nan", "null"))
_TRUE = frozenset(("1", "True", "TRUE", "true"))
_FALSE = frozenset(("0", "False", "FALSE", "false"))
_INT_RE = re.compile(r"^\s*-?\d+\s*$")


def _is_int(text: str) -> bool:
    return bool(_INT_RE.match(text)) and -2 ** 63 <= int(text) < 2 ** 63


def _is_float(text: str) -> bool:
    if "_" in text:
        return False
    try:
        float(text)
    except ValueError:
        return False
    return True


def infer_kind(cells: List[str]) -> str:
    """The kind pyarrow's CSV reader infers for a column of these
    cells: ``null`` when every cell is a null spelling."""
    present = [c for c in cells if c not in _NULLS]
    if not present:
        return "null"
    if all(_is_int(c) for c in present):
        return "int64"
    if all(c in _TRUE or c in _FALSE for c in present):
        return "bool"
    if all(_is_float(c) for c in present):
        return "float64"
    return "string"


def convert(kind: str, cells: List[str]):
    """One column of cells as the writer stores it: a masked array of
    ``kind`` (masked where null), or a string array."""
    if kind == "string":
        return np.array(cells, dtype=str)
    mask = np.array([c in _NULLS for c in cells], bool)
    if kind == "null":  # text where a later chunk has values
        return np.ma.array(np.array(cells, dtype=str), mask=mask)
    parse = {"int64": int, "float64": float,
             "bool": lambda c: c in _TRUE}[kind]
    check = {"int64": _is_int, "float64": _is_float,
             "bool": lambda c: c in _TRUE or c in _FALSE}[kind]
    values = []
    for c, null in zip(cells, mask.tolist()):
        if null:
            values.append(0)
        elif not check(c):
            raise ValueError(f"CSV conversion error to {kind}: invalid "
                             f"value {c!r}")
        else:
            values.append(parse(c))
    return np.ma.array(np.array(values, dtype=kind), mask=mask)


# bytes a generic download reads at a time
_CHUNK = 1 << 20


def _open_uri_stream(uri: str):
    """A readable binary stream of an http(s) URL, a ``file://`` URI or a
    local path."""
    if uri.startswith(("http://", "https://")):
        import urllib.request

        return urllib.request.urlopen(uri, timeout=600)
    if uri.startswith("file://"):
        return open(uri[len("file://"):], "rb")
    return open(uri, "rb")


class DatasetService:
    def __init__(self, context):
        self._ctx = context
        self._validator = V.RequestValidator(context)

    # -- POST -----------------------------------------------------------
    def create(self, body: Dict[str, Any], tool: str,
               ) -> Tuple[int, Dict[str, Any]]:
        self._validator.required_fields(
            body, [DATASET_NAME_FIELD, DATASET_URI_FIELD])
        name = self._validator.safe_name(body[DATASET_NAME_FIELD])
        uri = body[DATASET_URI_FIELD]
        self._validator.not_duplicate(name)
        if tool not in ("csv", "generic"):
            raise V.HttpError(V.HTTP_NOT_ACCEPTABLE,
                              f"unknown dataset tool: {tool}")
        if not isinstance(uri, str) or not uri:
            raise V.HttpError(V.HTTP_NOT_ACCEPTABLE, "invalid url")
        self._ctx.catalog.create_collection(name, f"dataset/{tool}",
                                            {"url": uri})
        run = self._ingest_csv if tool == "csv" else self._ingest_generic
        self._ctx.jobs.submit(
            name, lambda: run(name, uri),
            description=f"ingest {uri}", parameters={"url": uri})
        return V.HTTP_CREATED, {
            "result": f"/api/learningOrchestra/v1/dataset/{tool}/{name}"}

    def _ingest_csv(self, name: str, uri: str) -> None:
        rows = 0
        with _open_uri_stream(uri) as raw, io.TextIOWrapper(
                raw, encoding="utf-8", newline="") as f, \
                self._ctx.catalog.dataset_writer(name) as writer:
            # blank lines are skipped, as pyarrow skips them
            reader = (r for r in csv.reader(f) if r)
            header = next(reader, None)
            if header is None:
                raise ValueError("Empty CSV file")
            if len(set(header)) != len(header):
                raise ValueError(f"duplicate column names in {header}")
            kinds = None
            while True:
                chunk = list(itertools.islice(reader, _CHUNK_ROWS))
                if not chunk:
                    break
                for i, row in enumerate(chunk):
                    if len(row) != len(header):
                        raise ValueError(
                            f"CSV parse error: row {rows + i + 1}: expected "
                            f"{len(header)} columns, got {len(row)}")
                cells = [list(c) for c in zip(*chunk)]
                if kinds is None:
                    kinds = [infer_kind(c) for c in cells]
                writer.write_batch({h: convert(k, c) for h, k, c in
                                    zip(header, kinds, cells)})
                rows += len(chunk)
            fields = writer.fields()
        self._ctx.catalog.update_metadata(
            name, {D.FIELDS_FIELD: fields, "rows": rows})

    def _ingest_generic(self, name: str, uri: str) -> None:
        buf = io.BytesIO()
        with _open_uri_stream(uri) as stream:
            while True:
                chunk = stream.read(_CHUNK)
                if not chunk:
                    break
                buf.write(chunk)
        filename = os.path.basename(uri.split("?")[0]) or "payload.bin"
        self._ctx.artifacts.save_bytes(
            buf.getvalue(), name, D.DATASET_GENERIC_TYPE, filename=filename)
        self._ctx.catalog.update_metadata(name, {"sizeBytes": buf.tell()})

    # -- universal GET/DELETE ------------------------------------------
    def list_files(self, type_string: Optional[str] = None,
                   ) -> Tuple[int, Any]:
        """Every collection's metadata document (of one type)."""
        return V.HTTP_SUCCESS, {
            "result": self._ctx.catalog.list_collections(type_string)}

    def read_file(self, name: str, skip: int = 0,
                  limit: Optional[int] = None,
                  query: Optional[Dict[str, Any]] = None,
                  ) -> Tuple[int, Any]:
        meta = self._validator.existing(name)
        rows = self._ctx.catalog.read_entries(
            name, skip=skip, limit=limit, query=query)
        return V.HTTP_SUCCESS, {"metadata": meta, "result": rows}

    def delete_file(self, name: str) -> Tuple[int, Any]:
        meta = self._validator.existing(name)
        self._ctx.catalog.delete_collection(name)
        self._ctx.artifacts.delete(name, meta.get(D.TYPE_FIELD))
        return V.HTTP_SUCCESS, {"result": f"deleted file {name}"}


def parse_query_param(raw: Optional[str]) -> Optional[Dict[str, Any]]:
    """``query`` arrives as a JSON string query parameter."""
    if not raw:
        return None
    try:
        q = json.loads(raw)
    except json.JSONDecodeError:
        raise V.HttpError(V.HTTP_NOT_ACCEPTABLE, "invalid query") from None
    if not isinstance(q, dict):
        raise V.HttpError(V.HTTP_NOT_ACCEPTABLE, "invalid query")
    return q
