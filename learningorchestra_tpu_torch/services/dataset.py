"""Dataset service: CSV ingest and the universal read API, as the JAX
package's ``services/dataset.py`` serves them.

- ``POST /dataset/csv`` with ``datasetName`` and ``datasetURI`` (an
  ``http(s)://`` URL, a local path or a ``file://`` URI) ingests on a
  job: the bytes stream in (never held whole), a chunk of
  ``_CHUNK_ROWS`` records at a time, and each column's kind is inferred
  from the first chunk as pyarrow's CSV reader infers it for these
  kinds: int64, else bool (``1``/``0`` and ``true``/``false`` in three
  spellings), else float64, else string. An empty cell (or another of
  pyarrow's null spellings) is a null in a column of another kind and
  stays text in a string column; a column of nulls only is null
  throughout. The port's C++ core (:mod:`..native.ops`) parses each
  chunk while a thread reads the next; the standard ``csv`` module is
  the Python path (``LO_NATIVE=0``, no ``g++``), and the reference: the
  core gives the same columns and errors, and hands a file it cannot
  read as ``csv.reader`` does (invalid UTF-8, a field over the size
  limit) to that path whole.
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
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from learningorchestra_tpu_torch import native
from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.native import ops
from learningorchestra_tpu_torch.native.ops import convert, infer_kind
from learningorchestra_tpu_torch.services import validators as V

DATASET_NAME_FIELD = "datasetName"
DATASET_URI_FIELD = "datasetURI"

# rows per parsed chunk; the first chunk fixes each column's kind
_CHUNK_ROWS = ops.CHUNK_ROWS
# bytes the core path reads from the stream at a time
_READ_BLOCK = 4 << 20
# bytes after a failing chunk that csv.reader's file may already have
# decoded (it reads 8 KiB at a time): invalid UTF-8 there is its error
_DECODE_AHEAD = 64 << 10

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


class _Records:
    """A binary stream's complete CSV records, a chunk at a time: each
    :meth:`next` reads until ``n`` records are complete (or the stream
    ends) and returns their bytes and count. One caller at a time."""

    def __init__(self, stream):
        self._stream = stream
        self._carry = b""
        self._eof = False

    def _read(self, size: int) -> None:
        more = self._stream.read(size)
        if more:
            self._carry += more
        else:
            self._eof = True

    def next(self, n: int) -> Tuple[bytes, int]:
        while True:
            cut, got = ops.split_records(self._carry, n, self._eof)
            if got == n or self._eof:
                chunk = self._carry[:max(cut, 0)]
                self._carry = self._carry[max(cut, 0):] if got else b""
                return chunk, got
            # a record longer than the buffer doubles the read
            self._read(max(_READ_BLOCK, len(self._carry)))

    def refuse_if_undecodable(self, following: bytes) -> None:
        """Raises :class:`ops.CoreRefused` when the bytes just after the
        current chunk (``following``, then the stream) hold invalid UTF-8
        within :data:`_DECODE_AHEAD`: ``csv.reader``'s file may have hit
        it before the error at hand."""
        ahead = following[:_DECODE_AHEAD]
        while len(ahead) + len(self._carry) < _DECODE_AHEAD and \
                not self._eof:
            self._read(_READ_BLOCK)
        ahead += self._carry[:_DECODE_AHEAD - len(ahead)]
        if not ops.utf8_valid(ahead, truncated_ok=True):
            raise ops.CoreRefused("invalid UTF-8 after the failing chunk")


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
        fields, rows = None, 0
        if ops.core() is not None:
            try:
                fields, rows = self._ingest_csv_core(name, uri)
            except ops.CoreRefused:
                # only csv.reader gives this file's error (or reads it)
                native.count("ingestDelegated", "python", 1)
        if fields is None:
            fields, rows = self._ingest_csv_py(name, uri)
        self._ctx.catalog.update_metadata(
            name, {D.FIELDS_FIELD: fields, "rows": rows})

    def _ingest_csv_core(self, name: str, uri: str) -> Tuple[List[str], int]:
        """The ingest through the C++ core: a thread reads the stream and
        cuts it into chunks of ``_CHUNK_ROWS`` records while the core
        parses the chunk before (ctypes releases the GIL). Raises
        :class:`ops.CoreRefused` where only the Python path reads the
        file as ``csv.reader`` does, or gives its error."""
        rows = 0
        with _open_uri_stream(uri) as raw, \
                self._ctx.catalog.dataset_writer(name) as writer, \
                ThreadPoolExecutor(1, thread_name_prefix="lo-csv-read") \
                as pool:
            records = _Records(raw)
            head, n = records.next(1)
            try:
                if n == 0:
                    raise ValueError("Empty CSV file")
                header = ops.csv_header(head, fallback=False)
                if len(set(header)) != len(header):
                    raise ValueError(f"duplicate column names in {header}")
            except ValueError:
                records.refuse_if_undecodable(b"")
                raise
            kinds = None
            pending = pool.submit(records.next, _CHUNK_ROWS)
            while True:
                chunk, n = pending.result()
                if n == 0:
                    break
                pending = pool.submit(records.next, _CHUNK_ROWS)
                try:
                    columns, kinds = ops.parse_csv(
                        chunk, has_header=False, ncols=len(header),
                        kinds=kinds, row_base=rows, fallback=False)
                except ValueError:
                    # a ragged record or a bad value: csv.reader's file
                    # may have met invalid UTF-8 first
                    records.refuse_if_undecodable(pending.result()[0])
                    raise
                writer.write_batch(dict(zip(header, columns)))
                rows += n
            return writer.fields(), rows

    def _ingest_csv_py(self, name: str, uri: str) -> Tuple[List[str], int]:
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
                        raise ops.ragged_error(rows + i + 1, len(header),
                                               len(row))
                cells = [list(c) for c in zip(*chunk)]
                if kinds is None:
                    kinds = [infer_kind(c) for c in cells]
                writer.write_batch({h: convert(k, c) for h, k, c in
                                    zip(header, kinds, cells)})
                native.count("parse_csv", "python", len(chunk))
                rows += len(chunk)
            return writer.fields(), rows

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
