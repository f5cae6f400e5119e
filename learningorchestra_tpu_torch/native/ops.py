"""The port's host core for CSV ingest, query reads, histograms and the
batch gather: each wrapper over ``csrc/csv_core.cpp`` (the ``csv_core``
library of :mod:`learningorchestra_tpu_torch.native`) with its plain
Python version beside it, the counterpart of the JAX package's
``native/ops.py``.

The port keeps its columns as numpy arrays and null masks (as
``catalog/store.py`` stores them), so there are no ``*_arrow`` variants,
and the CSV is typed by the port's kinds, as pyarrow's CSV reader infers
them for these kinds (the JAX core reads only float64 and string):

- ``int64``: every present cell matches ``^\\s*-?\\d+\\s*$`` within the
  int64 range; ``bool``: ``1``/``0`` and ``true``/``false`` in three
  spellings; ``float64``: Python's ``float()`` without underscores
  (``inf``, ``nan``, exponents, a leading ``+``; no hex); else
  ``string``. A cell that is one of :data:`NULLS` is a null in a column
  of another kind and stays text in a string column; a column of nulls
  only is ``null`` (stored as masked text).
- A column's kind is fixed by its first :data:`CHUNK_ROWS` records.

The Python versions are the reference, and the core agrees with them
on every cell: the kinds, the values bit for bit, the null masks and the
error messages. Python's ``\\s``, ``int()`` and ``float()`` also take
non-ASCII digits and whitespace, so a cell with a byte outside printable
ASCII and ``\\t\\n\\v\\f\\r`` is judged by the Python predicates (the
``deferredCells`` counter). Bytes that ``csv.reader`` would refuse on its
own (invalid UTF-8, a field over its size limit) raise
:class:`CoreRefused` where the caller asked for no fallback.

Every wrapper counts its calls and rows by path (``native`` or
``python``) in :func:`counts`.
"""

from __future__ import annotations

import csv
import ctypes
import io
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from learningorchestra_tpu_torch import native
from learningorchestra_tpu_torch.catalog import documents as D

# records per chunk of an ingest; the first chunk fixes each column's kind
CHUNK_ROWS = 65536
# pyarrow's default null spellings and boolean spellings
NULLS = frozenset(("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                   "-NaN", "-nan", "1.#IND", "1.#QNAN", "N/A", "NA", "NULL",
                   "NaN", "n/a", "nan", "null"))
TRUE = frozenset(("1", "True", "TRUE", "true"))
FALSE = frozenset(("0", "False", "FALSE", "false"))
_INT_RE = re.compile(r"^\s*-?\d+\s*$")

_OPS = {"$eq": 0, "$ne": 1, "$lt": 2, "$lte": 3, "$gt": 4, "$gte": 5}
_KIND_CODES = {"int64": 0, "float64": 1, "bool": 2}

counts = native.counts
reset_counts = native.reset_counts


class CoreRefused(Exception):
    """The core does not read these bytes: ``csv.reader`` would refuse
    them itself (invalid UTF-8, a field over its size limit), so only
    the Python path gives its error."""


def core() -> Optional[ctypes.CDLL]:
    """The loaded ``csv_core``, or None (``LO_NATIVE=0``, no ``g++``)."""
    return native.get_lib(native.CSV)


def _addr(buf: bytes) -> int:
    """The address of a bytes object's data (no copy)."""
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value or 0


# ---------------------------------------------------------------------------
# The kinds (the Python reference)
# ---------------------------------------------------------------------------

def is_int(text: str) -> bool:
    return bool(_INT_RE.match(text)) and -2 ** 63 <= int(text) < 2 ** 63


def is_float(text: str) -> bool:
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
    present = [c for c in cells if c not in NULLS]
    if not present:
        return "null"
    if all(is_int(c) for c in present):
        return "int64"
    if all(c in TRUE or c in FALSE for c in present):
        return "bool"
    if all(is_float(c) for c in present):
        return "float64"
    return "string"


def _conversion_error(kind: str, cell: str) -> ValueError:
    return ValueError(f"CSV conversion error to {kind}: invalid value "
                      f"{cell!r}")


def convert(kind: str, cells: List[str]):
    """One column of cells as the writer stores it: a masked array of
    ``kind`` (masked where null), or a string array."""
    if kind == "string":
        return np.array(cells, dtype=str)
    mask = np.array([c in NULLS for c in cells], bool)
    if kind == "null":  # text where a later chunk has values
        return np.ma.array(np.array(cells, dtype=str), mask=mask)
    parse = {"int64": int, "float64": float,
             "bool": lambda c: c in TRUE}[kind]
    check = {"int64": is_int, "float64": is_float,
             "bool": lambda c: c in TRUE or c in FALSE}[kind]
    values = []
    for c, null in zip(cells, mask.tolist()):
        if null:
            values.append(0)
        elif not check(c):
            raise _conversion_error(kind, c)
        else:
            values.append(parse(c))
    return np.ma.array(np.array(values, dtype=kind), mask=mask)


def ragged_error(row: int, ncols: int, got: int) -> ValueError:
    """The Python path's error for record ``row`` (from 1) of ``got``
    fields where ``ncols`` are expected."""
    return ValueError(f"CSV parse error: row {row}: expected {ncols} "
                      f"columns, got {got}")


# ---------------------------------------------------------------------------
# Record cuts
# ---------------------------------------------------------------------------

def split_records(data: bytes, max_records: int = 0,
                  final: bool = False) -> Tuple[int, int]:
    """``(cut, n)``: the offset just past the terminator of the last
    complete record of ``data`` (-1 when none is), taking at most
    ``max_records`` records (0: no limit) and, where that limit did not
    stop it, the blank lines after it; ``n`` the records before the cut.
    Records are ``csv.reader``'s: a newline inside a quoted field does not
    end one. ``final``: ``data`` ends the input, so its last record needs
    no terminator."""
    lib = core()
    if lib is None:
        cut, n = _split_records_py(data, max_records, final)
        native.count("split_records", "python", n)
        return cut, n
    n = ctypes.c_int64()
    cut = lib.lo_csv_cut(data, len(data), max_records, int(final),
                         ctypes.byref(n))
    native.count("split_records", "native", n.value)
    return int(cut), n.value


def _split_records_py(data: bytes, max_records: int,
                      final: bool) -> Tuple[int, int]:
    newline, quote, comma = b"\r\n", 34, 44
    size, i, n, cut = len(data), 0, 0, -1
    while True:
        while i < size and data[i] in newline:
            i += 1
        if i >= size or 0 < max_records <= n:
            break
        # 0 start of field, 1 in field, 2 quoted, 3 quote in quoted
        state, complete = 0, False
        while i < size:
            c = data[i]
            if state == 2:
                state = 3 if c == quote else 2
            elif c in newline and state != 2:
                if c == 13 and i + 1 < size and data[i + 1] == 10:
                    i += 1
                i += 1
                complete = True
                break
            elif state == 0:
                state = 2 if c == quote else (0 if c == comma else 1)
            elif state == 1:
                state = 0 if c == comma else 1
            else:  # a quote in a quoted field
                state = 2 if c == quote else (0 if c == comma else 1)
            i += 1
        if not complete and not final:
            break
        n += 1
        cut = i
    if cut >= 0 and not 0 < max_records <= n:
        while cut < size and data[cut] in newline:
            cut += 1
    return cut, n


def safe_split(data: bytes, max_records: int = 0,
               final: bool = False) -> int:
    """Index just past the last complete CSV record of ``data`` (-1 when
    none is): the JAX package's cut, by ``csv.reader``'s records."""
    return split_records(data, max_records, final)[0]


def utf8_valid(data: bytes, truncated_ok: bool = False) -> bool:
    """Whether Python's strict UTF-8 decoder takes ``data``
    (``truncated_ok``: a sequence cut by the end is not an error)."""
    lib = core()
    if lib is None:
        try:
            data.decode("utf-8")
        except UnicodeDecodeError as exc:
            return truncated_ok and exc.reason == "unexpected end of data"
        return True
    return bool(lib.lo_utf8_valid(data, len(data), int(truncated_ok)))


# ---------------------------------------------------------------------------
# CSV parse
# ---------------------------------------------------------------------------

def _reader(text: str):
    """``csv.reader``'s non-blank records of ``text``, read as a file
    opened with ``newline=""``."""
    return (r for r in csv.reader(io.StringIO(text, newline="")) if r)


def csv_header(first_line, fallback: bool = True) -> List[str]:
    """The first record of ``first_line`` (str or UTF-8 bytes) as
    ``csv.reader`` reads it ([] when there is none). ``fallback=False``:
    raise :class:`CoreRefused` where only the Python path reads it."""
    buf = first_line.encode("utf-8") if isinstance(first_line, str) \
        else bytes(first_line)
    lib = core()
    if lib is None:
        native.count("csv_header", "python", 1)
        return next(_reader(buf.decode("utf-8")), [])
    table = _Table(lib, buf, 0, 0, max_records=1)
    try:
        try:
            table.refuse()
        except CoreRefused:
            if not fallback:
                raise
            native.count("csv_header", "python", 1)
            return next(_reader(buf.decode("utf-8")), [])
        native.count("csv_header", "native", 1)
        return [table.text(k) for k in range(table.cols)] \
            if table.rows else []
    finally:
        table.free()


class _Table:
    """One ``lo_csv_parse`` result over ``buf[start:]``."""

    def __init__(self, lib, buf: bytes, start: int, ncols: int,
                 max_records: int = 0):
        self.lib, self._buf = lib, buf
        self.handle = lib.lo_csv_parse(_addr(buf) + start, len(buf) - start,
                                       ncols, max_records)
        self.status = lib.lo_csv_status(self.handle)
        self.rows = lib.lo_csv_rows(self.handle)
        self.cols = lib.lo_csv_cols(self.handle)
        self._offs = None

    def refuse(self) -> None:
        """Raises :class:`CoreRefused` (after freeing the table) where
        ``csv.reader`` would refuse the bytes itself."""
        if self.status >= 2:
            self.free()
            raise CoreRefused("invalid UTF-8" if self.status == 2
                              else "a field over csv's size limit")

    def text(self, k: int) -> str:
        """Cell ``k`` (row-major) as str."""
        if self._offs is None:
            n = self.rows * self.cols + 1
            self._offs = np.frombuffer((ctypes.c_int64 * n).from_address(
                self.lib.lo_csv_offsets(self.handle)), np.int64)
        lo, hi = int(self._offs[k]), int(self._offs[k + 1])
        return ctypes.string_at(self.lib.lo_csv_data(self.handle) + lo,
                                hi - lo).decode("utf-8")

    def free(self) -> None:
        if self.handle:
            self.lib.lo_csv_free(self.handle)
            self.handle = None


def parse_csv(buf: bytes, *, has_header: bool = True,
              ncols: Optional[int] = None,
              kinds: Optional[Sequence[str]] = None, row_base: int = 0,
              fallback: bool = True) -> Tuple[List[Any], List[str]]:
    """One chunk of complete CSV records as the ingest writes it:
    ``(columns, kinds)``, each column as :func:`convert` gives it. The
    header record is skipped, not returned (read it with
    :func:`csv_header`); ``ncols`` is the width every record must have
    (the header's, else the first record's); ``kinds`` pins the columns'
    kinds (else they are inferred from these records); ``row_base`` is
    the number of data records before this chunk, for the row an error
    names. Raises what the Python path raises, in its order: a ragged
    record, then the first column with a value not of its kind.
    ``fallback=False``: raise :class:`CoreRefused` where only the Python
    path reads the bytes."""
    lib = core()
    if lib is None:
        return _parse_csv_py(buf, has_header, ncols, kinds, row_base)
    start = 0
    try:
        if has_header:
            cut, n = split_records(buf, 1, final=True)
            if n == 0:
                return [], list(kinds or [])
            if not utf8_valid(buf):
                raise CoreRefused("invalid UTF-8")
            header = csv_header(buf[:cut], fallback=False)
            ncols, start = len(header), cut
        table = _Table(lib, buf, start, ncols or 0)
        table.refuse()
    except CoreRefused:
        if not fallback:
            raise
        return _parse_csv_py(buf, has_header, ncols, kinds, row_base)
    try:
        if table.status == 1:
            raise ragged_error(
                row_base + lib.lo_csv_bad_row(table.handle) + 1,
                table.cols, lib.lo_csv_bad_width(table.handle))
        native.count("parse_csv", "native", table.rows)
        if table.rows == 0:
            return [], list(kinds or [])
        if kinds is None:
            kinds = [_infer_native(table, j) for j in range(table.cols)]
        return [_convert_native(table, j, k)
                for j, k in enumerate(kinds)], list(kinds)
    finally:
        table.free()


def _deferred(table: _Table, j: int, rows: np.ndarray):
    """(row, text) of column ``j``'s deferred cells; the cells handed to
    the Python predicates are counted."""
    sent = 0
    try:
        for r in rows.tolist():
            sent += 1
            yield r, table.text(r * table.cols + j)
    finally:
        if sent:
            native.count("deferredCells", "python", sent)


def _holds(pred, cells, first_fail: int) -> bool:
    """``all(pred(c) for c in present)`` given the core's first failing
    plain cell: the deferred cells before it are judged in order."""
    for r, text in cells:
        if 0 <= first_fail < r:
            break
        if not pred(text):
            return False
    return first_fail < 0


def _infer_native(table: _Table, j: int) -> str:
    any_present = ctypes.c_uint8()
    first_fail = np.empty(3, np.int64)
    rows = np.empty(table.rows, np.int64)
    nd = table.lib.lo_csv_infer(table.handle, j, ctypes.byref(any_present),
                                first_fail.ctypes.data, rows.ctypes.data)
    if not any_present.value:
        return "null"
    deferred = rows[:nd]
    if _holds(is_int, _deferred(table, j, deferred), int(first_fail[0])):
        return "int64"
    if first_fail[1] < 0:
        return "bool"
    if _holds(is_float, _deferred(table, j, deferred),
              int(first_fail[2])):
        return "float64"
    return "string"


def _convert_native(table: _Table, j: int, kind: str):
    lib, n = table.lib, table.rows
    if kind in ("string", "null"):
        width = lib.lo_csv_text_width(table.handle, j)
        text = np.empty(n * width, np.uint32)
        mask = np.empty(n, np.uint8) if kind == "null" else None
        lib.lo_csv_text(table.handle, j, width, text.ctypes.data,
                        None if mask is None else mask.ctypes.data)
        text = text.view(f"<U{width}")
        return text if mask is None else np.ma.array(text,
                                                     mask=mask.view(bool))
    out = np.empty(n, kind)
    mask = np.empty(n, np.uint8)
    rows = np.empty(n, np.int64)
    nd = ctypes.c_int64()
    bad = lib.lo_csv_convert(table.handle, j, _KIND_CODES[kind],
                             out.ctypes.data, mask.ctypes.data,
                             rows.ctypes.data, ctypes.byref(nd))
    check, parse = {"int64": (is_int, int),
                    "float64": (is_float, float)}.get(kind, (None, None))
    for r, text in _deferred(table, j, rows[:nd.value]):
        if not check(text):
            raise _conversion_error(kind, text)
        out[r] = parse(text)
    if bad >= 0:
        raise _conversion_error(kind, table.text(bad * table.cols + j))
    return np.ma.array(out, mask=mask.view(bool))


def _parse_csv_py(buf: bytes, has_header: bool, ncols: Optional[int],
                  kinds: Optional[Sequence[str]],
                  row_base: int) -> Tuple[List[Any], List[str]]:
    reader = _reader(buf.decode("utf-8"))
    if has_header:
        header = next(reader, None)
        if header is None:
            return [], list(kinds or [])
        ncols = len(header)
    records = list(reader)
    native.count("parse_csv", "python", len(records))
    if not records:
        return [], list(kinds or [])
    if ncols is None:
        ncols = len(records[0])
    for i, row in enumerate(records):
        if len(row) != ncols:
            raise ragged_error(row_base + i + 1, ncols, len(row))
    cells = [list(c) for c in zip(*records)]
    if kinds is None:
        kinds = [infer_kind(c) for c in cells]
    return [convert(k, c) for k, c in zip(kinds, cells)], list(kinds)


# ---------------------------------------------------------------------------
# Value counts
# ---------------------------------------------------------------------------

def value_counts(data: np.ndarray, mask: Optional[np.ndarray] = None,
                 ) -> List[Tuple[Any, int]]:
    """``(value, count)`` of a column in the order of each value's first
    row; nulls (``mask``) count as one ``None`` value and NaNs as one
    NaN. The core hashes int64, float64, bool and text columns."""
    data = np.asarray(data)
    lib = core()
    kind = {"f": 0}.get(data.dtype.kind, 1)
    if lib is None or data.ndim != 1 or not (
            data.dtype == np.float64 or data.dtype == np.int64
            or data.dtype == np.bool_ or data.dtype.kind == "U"):
        native.count("value_counts", "python", len(data))
        return _value_counts_py(data, mask)
    src = np.ascontiguousarray(data)
    skip = None if mask is None else np.ascontiguousarray(mask, bool)
    if skip is not None and skip.shape != src.shape:
        raise ValueError(f"value_counts: a mask of {skip.shape} for "
                         f"{src.shape} values")
    handle = lib.lo_value_counts(
        src.ctypes.data, len(src), src.dtype.itemsize, kind,
        None if skip is None else skip.ctypes.data)
    try:
        m = lib.lo_counts_n(handle)
        first = np.frombuffer((ctypes.c_int64 * m).from_address(
            lib.lo_counts_first(handle)), np.int64).copy() if m else \
            np.empty(0, np.int64)
        counted = np.frombuffer((ctypes.c_int64 * m).from_address(
            lib.lo_counts_counts(handle)), np.int64).copy() if m else \
            np.empty(0, np.int64)
    finally:
        lib.lo_counts_free(handle)
    native.count("value_counts", "native", len(src))
    items = list(zip(first.tolist(), src[first].tolist(),
                     counted.tolist()))
    return _with_nulls(items, mask)


def _with_nulls(items, mask) -> List[Tuple[Any, int]]:
    """``(first row, value, count)`` items with the nulls' ``None`` in
    place, as ``(value, count)``."""
    if mask is not None and mask.any():
        items.append((int(np.argmax(mask)), None, int(mask.sum())))
    items.sort(key=lambda item: item[0])
    return [(value, count) for _, value, count in items]


def _value_counts_py(data: np.ndarray, mask: Optional[np.ndarray],
                     ) -> List[Tuple[Any, int]]:
    rows = np.arange(len(data))
    present = rows if mask is None else rows[~mask]
    items = []
    if len(present):
        values, first, counted = np.unique(data[present],
                                           return_index=True,
                                           return_counts=True)
        items = list(zip(present[first].tolist(), values.tolist(),
                         counted.tolist()))
    return _with_nulls(items, mask)


# ---------------------------------------------------------------------------
# Predicate filter
# ---------------------------------------------------------------------------

def _predicates(columns: Dict[str, np.ndarray], query: Any):
    """``[(field, op, operand)]`` of a query the core evaluates, or None:
    a numeric operand (not a bool; an int within int64) against an int64
    or float64 column with ``$eq/$ne/$lt/$lte/$gt/$gte`` or equality, and
    a string against a text column with ``$eq/$ne`` or equality."""
    if not isinstance(query, dict) or not query:
        return None
    preds = []
    for field, cond in query.items():
        col = columns.get(field)
        if col is None:
            return None
        pairs = list(cond.items()) if isinstance(cond, dict) \
            else [("$eq", cond)]
        for op, operand in pairs:
            if op not in _OPS or isinstance(operand, bool):
                return None
            if isinstance(operand, (int, float)) and col.dtype in (
                    np.int64, np.float64):
                if isinstance(operand, int) and \
                        not -2 ** 63 <= operand < 2 ** 63:
                    return None
            elif not (isinstance(operand, str) and col.dtype.kind == "U"
                      and op in ("$eq", "$ne") and "\x00" not in operand):
                return None
            preds.append((field, _OPS[op], operand))
    return preds


def filter_mask(columns: Dict[str, np.ndarray], query: Any,
                nulls: Optional[Dict[str, Optional[np.ndarray]]] = None,
                ) -> Optional[np.ndarray]:
    """Boolean keep-mask of a Mongo-style AND query over equal-length
    columns (``nulls``: each column's null mask, or None), equal to
    ``documents.matches_query`` on every row: an int64 column compares
    as int64 (an int with an int, exactly with a float), a null matches
    ``$ne`` only, and so does NaN. Returns None for a query the core does
    not take (``$in``, a field not among the columns, a bool or null
    operand, mixed kinds); the caller then runs the per-row loop."""
    preds = _predicates(columns, query)
    if preds is None:
        return None
    nulls = nulls or {}
    n = len(columns[next(iter(query))])
    for field in query:
        null = nulls.get(field)
        if len(columns[field]) != n or (null is not None
                                        and len(null) != n):
            raise ValueError(f"filter_mask: column {field!r} is not "
                             f"{n} rows long")
    lib = core()
    if lib is None:
        native.count("filter_mask", "python", n)
        return _filter_mask_py(columns, query, nulls, n)
    mask = np.ones(n, np.uint8)
    for field, op, operand in preds:
        col = np.ascontiguousarray(columns[field])
        null = nulls.get(field)
        null_ptr = None
        if null is not None:
            null = np.ascontiguousarray(null, bool)
            null_ptr = null.ctypes.data
        if isinstance(operand, str):
            try:
                needle = np.frombuffer(operand.encode("utf-32-le"),
                                       np.uint32)
            except UnicodeEncodeError:  # a lone surrogate
                native.count("filter_mask", "python", n)
                return _filter_mask_py(columns, query, nulls, n)
            needle = np.ascontiguousarray(needle) if len(needle) else \
                np.zeros(1, np.uint32)
            lib.lo_filter_text_eq(col.ctypes.data, n,
                                  col.dtype.itemsize // 4, null_ptr,
                                  needle.ctypes.data, len(operand),
                                  int(op == 1), mask.ctypes.data)
        else:
            is_int_operand = isinstance(operand, int)
            lib.lo_filter(col.ctypes.data, n,
                          0 if col.dtype == np.int64 else 1, null_ptr, op,
                          int(is_int_operand),
                          operand if is_int_operand else 0,
                          0.0 if is_int_operand else float(operand),
                          mask.ctypes.data)
    native.count("filter_mask", "native", n)
    return mask.view(bool)


def _filter_mask_py(columns, query, nulls, n: int) -> np.ndarray:
    fields = [f for f in query if f in columns]
    values = {}
    for f in fields:
        vals = np.asarray(columns[f]).tolist()
        null = nulls.get(f)
        if null is not None:
            for i in np.flatnonzero(null).tolist():
                vals[i] = None
        values[f] = vals
    return np.fromiter((D.matches_query({f: values[f][i] for f in fields},
                                        query) for i in range(n)),
                       bool, count=n)


# ---------------------------------------------------------------------------
# Batch gather
# ---------------------------------------------------------------------------

def gather_rows(src: np.ndarray, idx) -> np.ndarray:
    """``src[idx]``, bit for bit: the core copies the rows of a
    C-contiguous float32 array of two or more dimensions for a 1-D
    integer index within range; numpy's fancy indexing takes the rest
    (and raises its own errors)."""
    idx = np.asarray(idx)
    lib = core()
    if (lib is None or not isinstance(src, np.ndarray)
            or src.dtype != np.float32 or src.ndim < 2
            or not src.flags.c_contiguous or idx.ndim != 1
            or idx.dtype.kind not in "iu"
            or (len(idx) and (int(idx.min()) < 0
                              or int(idx.max()) >= len(src)))):
        native.count("gather_rows", "python", len(idx) if idx.ndim else 1)
        return src[idx]
    idx64 = np.ascontiguousarray(idx, np.int64)
    out = np.empty((len(idx64),) + src.shape[1:], np.float32)
    row_bytes = src.itemsize * int(np.prod(src.shape[1:]))
    lib.lo_gather_rows(src.ctypes.data, row_bytes, idx64.ctypes.data,
                       len(idx64), out.ctypes.data)
    native.count("gather_rows", "native", len(idx64))
    return out
