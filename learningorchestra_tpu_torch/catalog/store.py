"""The catalog of the port: an SQLite index of metadata and execution
documents, and a dataset store of numpy columns.

The metadata and document half follows the JAX package's
``catalog/store.py``: the same three tables, a connection per thread,
WAL, and execution-document ids allocated inside one INSERT..SELECT.
The dataset half needs neither pyarrow nor pandas: a dataset is a
directory with ``schema.json`` (column names in file order, each
column's kind, the row count) and one ``.npy`` per column, plus one
boolean ``.null.npy`` per column that has missing values.

Column kinds are ``int64``, ``float64``, ``bool`` and ``string`` (saved
as fixed-width unicode, so no file needs pickle). A missing value is a
null: a row document gives ``None`` for it, and :meth:`Catalog.read_table`
gives each column the dtype ``pyarrow.Table.to_pandas`` would (an int
column with nulls becomes float64 with NaN, a bool column with nulls
and every string column an object array holding ``None``).
"""

from __future__ import annotations

import json
import os
import shutil
import sqlite3
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from learningorchestra_tpu_torch.catalog import documents as D
from learningorchestra_tpu_torch.catalog.artifacts import validate_safe_name

_SCHEMA = """
CREATE TABLE IF NOT EXISTS collections (
    name TEXT PRIMARY KEY,
    type TEXT NOT NULL,
    created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS docs (
    collection TEXT NOT NULL,
    id INTEGER NOT NULL,
    body TEXT NOT NULL,
    PRIMARY KEY (collection, id)
);
CREATE TABLE IF NOT EXISTS changes (
    seq INTEGER PRIMARY KEY AUTOINCREMENT,
    collection TEXT NOT NULL,
    op TEXT NOT NULL,
    ts REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_collections_type ON collections(type);
"""

_SCHEMA_FILE = "schema.json"
# rows turned into documents at a time by a queried read
_READ_BLOCK = 4096


class CollectionExists(Exception):
    pass


class CollectionNotFound(Exception):
    pass


class Table:
    """A dataset read whole: a read-only mapping of column name to numpy
    array, in file order. What ``$name`` resolves to in the port, in
    place of the JAX package's pandas DataFrame; ``len`` is the row
    count, as a DataFrame's is."""

    def __init__(self, columns: Dict[str, np.ndarray], rows: int):
        self._columns = dict(columns)
        self._rows = int(rows)

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._columns[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._columns)

    def __len__(self) -> int:
        return self._rows

    def to_numpy(self) -> np.ndarray:
        """(rows, columns), promoted to one dtype (object when a column
        holds strings)."""
        if not self._columns:
            return np.zeros((self._rows, 0))
        return np.column_stack(list(self._columns.values()))

    def __repr__(self) -> str:
        return f"Table({self._rows} rows, columns={self.columns})"


def _column(values) -> Tuple[str, np.ndarray, np.ndarray]:
    """(kind, data, null mask) of one written column: a numpy array
    (masked arrays carry their nulls), or a sequence where ``None`` is
    a null."""
    if isinstance(values, np.ma.MaskedArray):
        data, mask = np.asarray(values.data), np.ma.getmaskarray(values)
    else:
        data = np.asarray(values)
        mask = np.zeros(data.shape, bool)
        if data.dtype == object:
            mask = np.array([v is None for v in data.tolist()], bool)
            present = [v for v in data.tolist() if v is not None]
            if present and all(isinstance(v, (bool, np.bool_))
                               for v in present):
                data = np.array([bool(v) if v is not None else False
                                 for v in data.tolist()])
            elif present and all(
                    isinstance(v, (int, np.integer))
                    and not isinstance(v, (bool, np.bool_))
                    for v in present):
                data = np.array([v if v is not None else 0
                                 for v in data.tolist()], np.int64)
            elif present and all(
                    isinstance(v, (int, float, np.integer, np.floating))
                    and not isinstance(v, (bool, np.bool_))
                    for v in present):
                data = np.array([v if v is not None else np.nan
                                 for v in data.tolist()], np.float64)
            else:
                data = np.array(["" if v is None else str(v)
                                 for v in data.tolist()], dtype=str)
    if data.ndim != 1:
        raise ValueError(f"a column must be 1-D, got shape {data.shape}")
    if data.dtype == bool:
        kind = "bool"
    elif np.issubdtype(data.dtype, np.integer):
        kind = "int64"
    elif np.issubdtype(data.dtype, np.floating):
        kind = "float64"
    elif data.dtype.kind in "US":
        kind = "string"
    else:
        raise TypeError(f"unsupported column dtype {data.dtype}")
    return kind, data, mask


def _typed(kind: str, data: np.ndarray) -> np.ndarray:
    """``data`` in the stored dtype of ``kind``."""
    return data.astype({"int64": np.int64, "float64": np.float64,
                        "bool": bool, "string": str}[kind])


class Catalog:
    def __init__(self, db_path: str, datasets_dir: str):
        self._db_path = db_path
        self._datasets_dir = datasets_dir
        os.makedirs(datasets_dir, exist_ok=True)
        os.makedirs(os.path.dirname(db_path) or ".", exist_ok=True)
        self._local = threading.local()
        with self._conn() as conn:
            conn.executescript(_SCHEMA)

    # ------------------------------------------------------------------
    # connection handling
    # ------------------------------------------------------------------
    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self._db_path, timeout=30.0)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    @staticmethod
    def _record_change(conn: sqlite3.Connection, collection: str,
                       op: str) -> None:
        conn.execute(
            "INSERT INTO changes (collection, op, ts) VALUES (?, ?, ?)",
            (collection, op, time.time()))

    # ------------------------------------------------------------------
    # collections and metadata documents
    # ------------------------------------------------------------------
    def create_collection(self, name: str, type_string: str,
                          metadata_extra: Optional[Dict[str, Any]] = None,
                          ) -> Dict[str, Any]:
        """Register a collection and write its ``_id: 0`` metadata
        document with ``finished: False``."""
        validate_safe_name(name)
        type_string = D.normalize_type(type_string)
        meta = D.metadata_document(name, type_string, metadata_extra)
        conn = self._conn()
        try:
            with conn:
                conn.execute(
                    "INSERT INTO collections (name, type, created) "
                    "VALUES (?, ?, ?)", (name, type_string, time.time()))
                conn.execute(
                    "INSERT INTO docs (collection, id, body) "
                    "VALUES (?, 0, ?)", (name, json.dumps(meta)))
                self._record_change(conn, name, "create")
        except sqlite3.IntegrityError:
            raise CollectionExists(name) from None
        return meta

    def exists(self, name: str) -> bool:
        cur = self._conn().execute(
            "SELECT 1 FROM collections WHERE name = ?", (name,))
        return cur.fetchone() is not None

    def get_type(self, name: str) -> Optional[str]:
        cur = self._conn().execute(
            "SELECT type FROM collections WHERE name = ?", (name,))
        row = cur.fetchone()
        return row[0] if row else None

    def get_metadata(self, name: str) -> Optional[Dict[str, Any]]:
        cur = self._conn().execute(
            "SELECT body FROM docs WHERE collection = ? AND id = 0", (name,))
        row = cur.fetchone()
        return json.loads(row[0]) if row else None

    def update_metadata(self, name: str, updates: Dict[str, Any]) -> None:
        conn = self._conn()
        with conn:
            cur = conn.execute(
                "SELECT body FROM docs WHERE collection = ? AND id = 0",
                (name,))
            row = cur.fetchone()
            if row is None:
                raise CollectionNotFound(name)
            body = json.loads(row[0])
            body.update(updates)
            body[D.ID] = 0
            conn.execute(
                "UPDATE docs SET body = ? WHERE collection = ? AND id = 0",
                (json.dumps(body), name))
            self._record_change(conn, name, "update")

    def mark_finished(self, name: str,
                      extra: Optional[Dict[str, Any]] = None) -> None:
        """Flip the ``finished`` flag clients poll."""
        self.update_metadata(name, {D.FINISHED_FIELD: True, **(extra or {})})

    def list_collections(self, type_string: Optional[str] = None,
                         ) -> List[Dict[str, Any]]:
        """Every metadata document, oldest first, optionally of one
        type."""
        sql = ("SELECT d.body FROM docs d JOIN collections c "
               "ON d.collection = c.name WHERE d.id = 0")
        args: Tuple = ()
        if type_string is not None:
            sql += " AND c.type = ?"
            args = (D.normalize_type(type_string),)
        cur = self._conn().execute(sql + " ORDER BY c.created", args)
        return [json.loads(r[0]) for r in cur.fetchall()]

    def delete_collection(self, name: str) -> bool:
        conn = self._conn()
        with conn:
            cur = conn.execute(
                "DELETE FROM collections WHERE name = ?", (name,))
            conn.execute("DELETE FROM docs WHERE collection = ?", (name,))
            deleted = cur.rowcount > 0
            if deleted:
                self._record_change(conn, name, "delete")
        shutil.rmtree(self._dataset_dir(name), ignore_errors=True)
        return deleted

    # ------------------------------------------------------------------
    # execution documents (append-only run history)
    # ------------------------------------------------------------------
    def append_document(self, name: str, body: Dict[str, Any]) -> int:
        """Append a document under the next integer id, allocated inside
        one write transaction."""
        if not self.exists(name):
            raise CollectionNotFound(name)
        conn = self._conn()
        with conn:
            conn.execute(
                "INSERT INTO docs (collection, id, body) "
                "SELECT ?, COALESCE(MAX(id), 0) + 1, ? FROM docs "
                "WHERE collection = ?", (name, json.dumps({}), name))
            new_id = conn.execute(
                "SELECT MAX(id) FROM docs WHERE collection = ?",
                (name,)).fetchone()[0]
            body = dict(body)
            body[D.ID] = new_id
            conn.execute(
                "UPDATE docs SET body = ? WHERE collection = ? AND id = ?",
                (json.dumps(body), name, new_id))
            self._record_change(conn, name, "doc")
        return new_id

    def get_documents(self, name: str) -> List[Dict[str, Any]]:
        cur = self._conn().execute(
            "SELECT body FROM docs WHERE collection = ? ORDER BY id", (name,))
        return [json.loads(r[0]) for r in cur.fetchall()]

    # ------------------------------------------------------------------
    # datasets (numpy columns)
    # ------------------------------------------------------------------
    def _dataset_dir(self, name: str) -> str:
        return os.path.join(self._datasets_dir, name)

    def _schema(self, name: str) -> Optional[Dict[str, Any]]:
        path = os.path.join(self._dataset_dir(name), _SCHEMA_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def dataset_writer(self, name: str) -> "DatasetWriter":
        return DatasetWriter(self, name)

    def count_rows(self, name: str) -> int:
        schema = self._schema(name)
        return 0 if schema is None else int(schema["rows"])

    def _load_columns(self, name: str, schema: Dict[str, Any],
                      ) -> List[Tuple[str, str, np.ndarray,
                                      Optional[np.ndarray]]]:
        """(name, kind, data, null mask or None) per column; the data
        files are memory-mapped."""
        d = self._dataset_dir(name)
        out = []
        for i, col in enumerate(schema["columns"]):
            data = np.load(os.path.join(d, f"c{i}.npy"), mmap_mode="r")
            mask = (np.load(os.path.join(d, f"c{i}.null.npy"))
                    if col["nulls"] else None)
            out.append((col["name"], col["kind"], data, mask))
        return out

    def read_table(self, name: str) -> Table:
        """The whole dataset as a :class:`Table`, each column in the
        dtype pandas would give it."""
        schema = self._schema(name)
        if schema is None:
            raise CollectionNotFound(f"{name} has no tabular data")
        columns = {}
        for col, kind, data, mask in self._load_columns(name, schema):
            data = np.array(data)
            if kind == "string":
                values = data.astype(object)
                if mask is not None:
                    values[mask] = None
            elif mask is None:
                values = data
            elif kind == "bool":
                values = data.astype(object)
                values[mask] = None
            else:
                values = data.astype(np.float64)
                values[mask] = np.nan
            columns[col] = values
        return Table(columns, schema["rows"])

    @staticmethod
    def _row_documents(columns, start: int, stop: int,
                       ) -> List[Dict[str, Any]]:
        """Rows ``start..stop`` as documents with ``_id`` (rows count
        from 1, as the reference numbers them)."""
        lists = []
        for col, _, data, mask in columns:
            values = np.asarray(data[start:stop]).tolist()
            if mask is not None:
                for i in np.flatnonzero(mask[start:stop]).tolist():
                    values[i] = None
            lists.append((col, values))
        rows = []
        for i in range(stop - start):
            row = {col: values[i] for col, values in lists}
            row[D.ID] = start + i + 1
            rows.append(row)
        return rows

    def read_rows(self, name: str, skip: int = 0,
                  limit: Optional[int] = None,
                  query: Optional[Dict[str, Any]] = None,
                  ) -> List[Dict[str, Any]]:
        """A page of row documents (``_id`` 1..N) that match ``query``;
        ``limit`` 0 or None means no limit."""
        return self._read_rows_ex(name, skip, limit, query)[0]

    def _read_rows_ex(self, name: str, skip: int = 0,
                      limit: Optional[int] = None,
                      query: Optional[Dict[str, Any]] = None,
                      ) -> Tuple[List[Dict[str, Any]], int]:
        """read_rows and how much of ``skip`` matching rows used up
        (read_entries pages past the rows with the rest)."""
        schema = self._schema(name)
        if schema is None:
            return [], 0
        n = int(schema["rows"])
        columns = self._load_columns(name, schema)
        if query is None:
            start = min(skip, n)
            stop = n if not limit else min(n, start + limit)
            return self._row_documents(columns, start, stop), start
        out: List[Dict[str, Any]] = []
        skipped = 0
        for start in range(0, n, _READ_BLOCK):
            for row in self._row_documents(
                    columns, start, min(n, start + _READ_BLOCK)):
                if not D.matches_query(row, query):
                    continue
                if skipped < skip:
                    skipped += 1
                    continue
                out.append(row)
                if limit and len(out) >= limit:
                    return out, skipped
        return out, skipped

    # ------------------------------------------------------------------
    # the universal paged read
    # ------------------------------------------------------------------
    def read_entries(self, name: str, skip: int = 0,
                     limit: Optional[int] = None,
                     query: Optional[Dict[str, Any]] = None,
                     ) -> List[Dict[str, Any]]:
        """One paged sequence in insertion order: the metadata document
        (``_id`` 0), the rows (``_id`` 1..N), then the execution
        documents relabelled N+1.. ``limit`` 0 means no limit."""
        if not self.exists(name):
            raise CollectionNotFound(name)
        if limit == 0:
            limit = None
        all_docs = self.get_documents(name)
        meta = [d for d in all_docs if d.get(D.ID) == D.METADATA_ID]
        appended = [d for d in all_docs if d.get(D.ID) != D.METADATA_ID]
        out: List[Dict[str, Any]] = []

        def take(doc) -> bool:
            nonlocal skip
            if not D.matches_query(doc, query):
                return False
            if skip > 0:
                skip -= 1
                return False
            out.append(doc)
            return limit is not None and len(out) >= limit

        for d in meta:
            if take(d):
                return out
        n_rows = self.count_rows(name)
        row_limit = None if limit is None else limit - len(out)
        if row_limit != 0 and n_rows:
            rows, consumed = self._read_rows_ex(
                name, skip=skip, limit=row_limit, query=query)
            out.extend(rows)
            if limit is not None and len(out) >= limit:
                return out
            skip = max(0, skip - consumed)
        for d in appended:
            relabelled = dict(d)
            relabelled[D.ID] = n_rows + d.get(D.ID, 0)
            if take(relabelled):
                return out
        return out

    # ------------------------------------------------------------------
    # change sequence numbers
    # ------------------------------------------------------------------
    def latest_seq(self) -> int:
        cur = self._conn().execute(
            "SELECT COALESCE(MAX(seq), 0) FROM changes")
        return cur.fetchone()[0]

    def collection_seq(self, name: str) -> int:
        """Newest change seq touching ``name``."""
        cur = self._conn().execute(
            "SELECT COALESCE(MAX(seq), 0) FROM changes "
            "WHERE collection = ?", (name,))
        return cur.fetchone()[0]


class DatasetWriter:
    """Writes one dataset from column chunks: each :meth:`write_batch`
    takes ``{column: values}`` with the columns (names, order and kinds)
    of the first batch; :meth:`close` writes the ``.npy`` files and
    swaps them in whole, replacing rows stored before."""

    def __init__(self, catalog: Catalog, name: str):
        self._dir = catalog._dataset_dir(name)
        self._kinds: Optional[Dict[str, str]] = None
        self._chunks: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
        self._rows = 0
        self._closed = False

    def write_batch(self, columns: Dict[str, Any]) -> None:
        parsed = {col: _column(values) for col, values in columns.items()}
        sizes = {len(data) for _, data, _ in parsed.values()}
        if len(sizes) > 1:
            raise ValueError(f"columns of unequal length: {sorted(sizes)}")
        kinds = {col: kind for col, (kind, _, _) in parsed.items()}
        if self._kinds is None:
            self._kinds = kinds
            self._chunks = {col: [] for col in parsed}
        elif list(kinds.items()) != list(self._kinds.items()):
            raise ValueError(f"batch columns {kinds} do not match the "
                             f"first batch's {self._kinds}")
        for col, (kind, data, mask) in parsed.items():
            self._chunks[col].append((_typed(kind, data), mask))
        self._rows += sizes.pop() if sizes else 0

    def fields(self) -> List[str]:
        return list(self._kinds or ())

    def close(self) -> None:
        if self._kinds is None or self._closed:
            return
        self._closed = True
        staging = self._dir + ".staging"
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging)
        schema = {"columns": [], "rows": self._rows}
        for i, (col, kind) in enumerate(self._kinds.items()):
            data = np.concatenate([c for c, _ in self._chunks[col]])
            mask = np.concatenate([m for _, m in self._chunks[col]])
            np.save(os.path.join(staging, f"c{i}.npy"), data,
                    allow_pickle=False)
            nulls = bool(mask.any())
            if nulls:
                np.save(os.path.join(staging, f"c{i}.null.npy"), mask,
                        allow_pickle=False)
            schema["columns"].append({"name": col, "kind": kind,
                                      "nulls": nulls})
        with open(os.path.join(staging, _SCHEMA_FILE), "w") as f:
            json.dump(schema, f)
        # a reader sees the old rows or the new ones, never a
        # half-written set of files
        old = self._dir + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(self._dir):
            os.rename(self._dir, old)
        os.rename(staging, self._dir)
        shutil.rmtree(old, ignore_errors=True)
        self._chunks = {}

    def __enter__(self) -> "DatasetWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # a failed ingest leaves the stored rows as they were
        if exc_type is None:
            self.close()
