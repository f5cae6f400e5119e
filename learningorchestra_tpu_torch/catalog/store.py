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
:meth:`Catalog.iter_batches` reads the same values a batch of rows at a
time from the memory-mapped files, for passes that must not hold a
whole dataset.
"""

from __future__ import annotations

import io
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
from learningorchestra_tpu_torch.native import ops
from learningorchestra_tpu_torch.runtime import locks

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
# rows a queried read's keep-mask covers at a time
_MASK_BLOCK = 1 << 20


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


def _values(kind: str, data: np.ndarray,
            mask: Optional[np.ndarray]) -> np.ndarray:
    """Stored column data (a memory-mapped slice) in memory, in the dtype
    pandas would give it: nulls as None in an object column (strings, or
    bools with nulls), as NaN in a float64 one (ints with nulls)."""
    data = np.array(data)
    if kind == "string":
        values = data.astype(object)
        if mask is not None:
            values[mask] = None
        return values
    if mask is None:
        return data
    if kind == "bool":
        values = data.astype(object)
        values[mask] = None
        return values
    values = data.astype(np.float64)
    values[mask] = np.nan
    return values


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
        # notified after each committed change: wakes watch()
        self._change_cond = locks.make_condition("catalog.change")
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

    def _notify(self) -> None:
        with self._change_cond:
            self._change_cond.notify_all()

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
        self._notify()
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
        """Merge ``updates`` into the metadata document. The read and the
        write share one write transaction, so a concurrent update (a job
        writing its status, the stall watchdog its progress) is never
        overwritten by a body read before it."""
        conn = self._conn()
        with conn:
            conn.execute("BEGIN IMMEDIATE")
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
        self._notify()

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
        if deleted:
            self._notify()
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
        self._notify()
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

    def dataset_fields(self, name: str) -> List[str]:
        """The stored columns' names, in file order."""
        schema = self._schema(name)
        return [] if schema is None else [c["name"]
                                          for c in schema["columns"]]

    def dataset_version(self, name: str) -> Optional[Tuple[int, int, int]]:
        """A stamp of the stored rows that changes with every write
        (writes replace the dataset directory and bypass the change
        feed): the schema file's inode, mtime and size; None without
        rows."""
        try:
            st = os.stat(os.path.join(self._dataset_dir(name),
                                      _SCHEMA_FILE))
        except OSError:
            return None
        return (st.st_ino, st.st_mtime_ns, st.st_size)

    def count_rows(self, name: str) -> int:
        schema = self._schema(name)
        return 0 if schema is None else int(schema["rows"])

    def _generation(self, name: str) -> Optional[Tuple[
            Dict[str, Any], List[Tuple[str, str, np.ndarray,
                                       Optional[np.ndarray]]]]]:
        """``(schema, [(name, kind, data, null mask or None)])`` of the
        stored rows, the data files memory-mapped; None without rows.
        Every file is opened through one handle on the dataset's
        directory, so a read racing a writer's swap gets the old files or
        fails (``OSError``) once they are removed: never a mix of two
        writes."""
        try:
            dfd = os.open(self._dataset_dir(name),
                          os.O_RDONLY | os.O_DIRECTORY)
        except FileNotFoundError:
            return None

        def opener(path, flags):
            return os.open(path, flags, dir_fd=dfd)

        try:
            try:
                with open(_SCHEMA_FILE, opener=opener) as f:
                    schema = json.load(f)
            except FileNotFoundError:
                return None
            out = []
            for i, col in enumerate(schema["columns"]):
                with open(f"c{i}.npy", "rb", opener=opener) as f:
                    data = _mapped(f)
                mask = None
                if col["nulls"]:
                    with open(f"c{i}.null.npy", "rb", opener=opener) as f:
                        mask = np.load(f)
                out.append((col["name"], col["kind"], data, mask))
            return schema, out
        finally:
            os.close(dfd)

    def read_columns(self, name: str,
                     fields: Optional[List[str]] = None,
                     ) -> Dict[str, Tuple[str, np.ndarray,
                                          Optional[np.ndarray]]]:
        """``{field: (kind, data, null mask or None)}`` of the stored
        columns (all, or ``fields`` in their order), read into memory."""
        stored = self._generation(name)
        if stored is None:
            raise CollectionNotFound(f"{name} has no tabular data")
        columns = {col: (kind, np.array(data), mask) for col, kind, data,
                   mask in stored[1]}
        return {f: columns[f] for f in (fields or list(columns))}

    def read_table(self, name: str) -> Table:
        """The whole dataset as a :class:`Table`, each column in the
        dtype pandas would give it."""
        stored = self._generation(name)
        if stored is None:
            raise CollectionNotFound(f"{name} has no tabular data")
        schema, loaded = stored
        columns = {col: _values(kind, data, mask) for col, kind, data, mask
                   in loaded}
        return Table(columns, schema["rows"])

    def iter_batches(self, name: str, columns: Optional[List[str]] = None,
                     batch_size: int = 65536,
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """The dataset's rows in order, ``batch_size`` at a time, as
        ``{column: values}`` (all columns, or ``columns`` in their order;
        values as :meth:`read_table` gives them). Each batch reads only
        its rows of the memory-mapped columns, so a pass holds one batch
        in memory, never a whole column."""
        generation = self._generation(name)
        if generation is None:
            raise CollectionNotFound(f"{name} has no tabular data")
        schema, loaded = generation
        stored = {col: (kind, data, mask) for col, kind, data, mask
                  in loaded}
        wanted = list(columns) if columns is not None else list(stored)
        unknown = [c for c in wanted if c not in stored]
        if unknown:
            raise KeyError(f"{name} has no column(s) {unknown}")
        n, step = int(schema["rows"]), max(1, int(batch_size))
        for start in range(0, n, step):
            stop = min(n, start + step)
            yield {c: _values(stored[c][0], stored[c][1][start:stop],
                              None if stored[c][2] is None
                              else stored[c][2][start:stop])
                   for c in wanted}

    @staticmethod
    def _row_documents(columns, rows: np.ndarray) -> List[Dict[str, Any]]:
        """The documents of ``rows`` (0-based, ascending) with ``_id``
        (rows count from 1, as the reference numbers them)."""
        lists = []
        for col, _, data, mask in columns:
            values = np.asarray(data[rows]).tolist()
            if mask is not None:
                for i in np.flatnonzero(mask[rows]).tolist():
                    values[i] = None
            lists.append((col, values))
        out = []
        for i, row in enumerate(rows.tolist()):
            doc = {col: values[i] for col, values in lists}
            doc[D.ID] = row + 1
            out.append(doc)
        return out

    @staticmethod
    def _query_matches(columns, n: int, query: Dict[str, Any], skip: int,
                       limit: Optional[int]) -> Optional[np.ndarray]:
        """The 0-based rows that match ``query``, through the core's
        keep-mask a block at a time, up to the first ``skip + limit``
        (all when ``limit`` is 0 or None); None where the mask does not
        take the query (the per-row loop does)."""
        data = {col: values for col, _, values, _ in columns}
        nulls = {col: mask for col, _, _, mask in columns}
        want = skip + limit if limit else None
        found: List[np.ndarray] = []
        total = 0
        for start in range(0, max(n, 1), _MASK_BLOCK):
            stop = min(n, start + _MASK_BLOCK)
            mask = ops.filter_mask(
                {c: v[start:stop] for c, v in data.items() if c in query},
                query, {c: None if m is None else m[start:stop]
                        for c, m in nulls.items() if c in query})
            if mask is None:
                return None
            rows = np.flatnonzero(mask) + start
            found.append(rows)
            total += len(rows)
            if want is not None and total >= want:
                break
        return np.concatenate(found) if found else np.empty(0, np.int64)

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
        stored = self._generation(name)
        if stored is None:
            return [], 0
        schema, columns = stored
        n = int(schema["rows"])
        if query is None:
            start = min(skip, n)
            stop = n if not limit else min(n, start + limit)
            return self._row_documents(columns,
                                       np.arange(start, stop)), start
        found = self._query_matches(columns, n, query, skip, limit)
        if found is not None:
            take = found[skip:] if not limit else found[skip:skip + limit]
            return self._row_documents(columns, take), \
                min(skip, len(found))
        out: List[Dict[str, Any]] = []
        skipped = 0
        for start in range(0, n, _READ_BLOCK):
            for row in self._row_documents(
                    columns, np.arange(start, min(n, start + _READ_BLOCK))):
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

    def changes_since(self, seq: int,
                      collection: Optional[str] = None,
                      ) -> List[Dict[str, Any]]:
        """The changes after ``seq`` (of one collection, or of all), in
        order: ``{"seq", "collection", "op", "ts"}``."""
        sql = "SELECT seq, collection, op, ts FROM changes WHERE seq > ?"
        args: Tuple = (seq,)
        if collection is not None:
            sql += " AND collection = ?"
            args = (seq, collection)
        cur = self._conn().execute(sql + " ORDER BY seq", args)
        return [{"seq": s, "collection": c, "op": o, "ts": t}
                for (s, c, o, t) in cur.fetchall()]

    def watch(self, seq: int, collection: Optional[str] = None,
              timeout: float = 30.0) -> List[Dict[str, Any]]:
        """Long-polls for changes after ``seq``: returns them as soon as
        there are any, or ``[]`` after ``timeout`` seconds. A commit on
        any thread wakes it; it holds no lock and no open transaction
        across its wait (the condition's wait is at most a second, in
        case a commit slips in between the read and the wait)."""
        deadline = time.monotonic() + timeout
        while True:
            changes = self.changes_since(seq, collection)
            if changes:
                return changes
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return []
            with self._change_cond:
                self._change_cond.wait(min(remaining, 1.0))


def _mapped(f) -> np.ndarray:
    """The ``.npy`` array of open file ``f``, memory-mapped read-only (as
    ``np.load(path, mmap_mode="r")`` maps it; an empty array, or a header
    version the public readers do not take, is read whole)."""
    fmt = np.lib.format
    read_header = {(1, 0): fmt.read_array_header_1_0,
                   (2, 0): fmt.read_array_header_2_0}.get(fmt.read_magic(f))
    if read_header is not None:
        shape, fortran, dtype = read_header(f)
        if all(shape) and not dtype.hasobject:
            return np.memmap(f, dtype=dtype, mode="r", shape=shape,
                             offset=f.tell(), order="F" if fortran else "C")
    f.seek(0)
    return np.load(f)


class _AppendedNpy:
    """One column's ``.npy`` file written batch by batch: the header for
    zero rows, each batch's rows appended as they come, and the header
    rewritten for the final count at :meth:`finish`. numpy pads a header
    so that its first dimension can grow to 21 digits at the same length,
    so the file is byte for byte what ``np.save`` writes for the whole
    column."""

    def __init__(self, path: str, dtype):
        self.path = path
        self.dtype = np.dtype(dtype)
        self.rows = 0
        self._file = open(path, "wb")
        self._file.write(self._header(0))

    def _header(self, rows: int) -> bytes:
        buf = io.BytesIO()
        np.lib.format.write_array_header_1_0(buf, {
            "descr": np.lib.format.dtype_to_descr(self.dtype),
            "fortran_order": False, "shape": (rows,)})
        return buf.getvalue()

    def append(self, data: np.ndarray) -> None:
        np.ascontiguousarray(data, self.dtype).tofile(self._file)
        self.rows += len(data)

    def finish(self) -> None:
        header = self._header(self.rows)
        if len(header) != len(self._header(0)):
            raise ValueError(f"{self.path}: {self.rows} rows outgrow the "
                             f".npy header written for the first batch")
        self._file.seek(0)
        self._file.write(header)
        self._file.close()

    def abandon(self) -> None:
        self._file.close()


class DatasetWriter:
    """Writes one dataset from column chunks: each :meth:`write_batch`
    takes ``{column: values}`` with the columns (names, order and kinds)
    of the first batch. A fixed-width column (bool, int64, float64) and
    every null mask are appended to their ``.npy`` files in a staging
    directory batch by batch, so the writer holds one batch at a time; a
    text column's chunks stay in memory until :meth:`close` (their width
    is the longest string's, known only then). :meth:`close` finishes
    the files and swaps them in whole, replacing rows stored before; a
    writer left by an exception removes its staging directory."""

    def __init__(self, catalog: Catalog, name: str):
        self._dir = catalog._dataset_dir(name)
        self._staging = self._dir + ".staging"
        self._kinds: Optional[Dict[str, str]] = None
        self._files: Dict[str, Tuple[Optional[_AppendedNpy],
                                     _AppendedNpy]] = {}
        self._texts: Dict[str, List[np.ndarray]] = {}
        self._nulls: Dict[str, bool] = {}
        self._rows = 0
        self._closed = False

    def _open(self, kinds: Dict[str, str]) -> None:
        shutil.rmtree(self._staging, ignore_errors=True)
        os.makedirs(self._staging)
        self._kinds = kinds
        for i, (col, kind) in enumerate(kinds.items()):
            data = None
            if kind == "string":
                self._texts[col] = []
            else:
                data = _AppendedNpy(os.path.join(
                    self._staging, f"c{i}.npy"), _typed(kind, np.empty(
                        0)).dtype)
            self._files[col] = (data, _AppendedNpy(os.path.join(
                self._staging, f"c{i}.null.npy"), bool))

    def write_batch(self, columns: Dict[str, Any]) -> None:
        parsed = {col: _column(values) for col, values in columns.items()}
        sizes = {len(data) for _, data, _ in parsed.values()}
        if len(sizes) > 1:
            raise ValueError(f"columns of unequal length: {sorted(sizes)}")
        kinds = {col: kind for col, (kind, _, _) in parsed.items()}
        if self._kinds is None:
            self._open(kinds)
        elif list(kinds.items()) != list(self._kinds.items()):
            raise ValueError(f"batch columns {kinds} do not match the "
                             f"first batch's {self._kinds}")
        for col, (kind, data, mask) in parsed.items():
            file, nulls = self._files[col]
            if file is None:
                self._texts[col].append(_typed(kind, data))
            else:
                file.append(_typed(kind, data))
            nulls.append(mask)
            self._nulls[col] = self._nulls.get(col, False) or \
                bool(mask.any())
        self._rows += sizes.pop() if sizes else 0

    def fields(self) -> List[str]:
        return list(self._kinds or ())

    def close(self) -> None:
        if self._kinds is None or self._closed:
            return
        self._closed = True
        schema = {"columns": [], "rows": self._rows}
        for i, (col, kind) in enumerate(self._kinds.items()):
            file, nulls_file = self._files[col]
            if file is None:
                np.save(os.path.join(self._staging, f"c{i}.npy"),
                        np.concatenate(self._texts.pop(col)),
                        allow_pickle=False)
            else:
                file.finish()
            nulls_file.finish()
            nulls = self._nulls.get(col, False)
            if not nulls:
                os.remove(nulls_file.path)
            schema["columns"].append({"name": col, "kind": kind,
                                      "nulls": nulls})
        with open(os.path.join(self._staging, _SCHEMA_FILE), "w") as f:
            json.dump(schema, f)
        # a reader sees the old rows or the new ones, never a
        # half-written set of files
        old = self._dir + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(self._dir):
            os.rename(self._dir, old)
        os.rename(self._staging, self._dir)
        shutil.rmtree(old, ignore_errors=True)
        self._files = {}

    def abandon(self) -> None:
        """Drops what was written; the stored rows stay as they were."""
        for file, nulls in self._files.values():
            for f in (file, nulls):
                if f is not None:
                    f.abandon()
        self._files, self._texts = {}, {}
        self._closed = True
        shutil.rmtree(self._staging, ignore_errors=True)

    def __enter__(self) -> "DatasetWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # a failed ingest leaves the stored rows as they were
        if exc_type is None:
            self.close()
        else:
            self.abandon()
