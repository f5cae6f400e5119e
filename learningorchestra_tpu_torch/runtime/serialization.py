"""The port's msgpack codec: the bytes of ``flax.serialization``.

The JAX package writes its artifacts' weights and its step checkpoints
with ``flax.serialization.to_bytes`` (msgpack with three ext types).
This module writes and reads the same bytes in pure Python and numpy,
with no ``msgpack`` package, so the port reads the JAX package's files
and the JAX package reads the port's.

- nil, bool, int (up to 64 bits), float (always 64-bit), str, bin,
  array (from a list) and map (a dict's keys in the dict's own order),
  each in the shortest form msgpack-python's packer picks;
- ext 1, an array: the packed ``(shape, dtype name, C-order bytes)``;
  ext 2, a Python complex: the packed ``(real, imag)``; ext 3, a numpy
  scalar: ext 1's payload of a 0-d array;
- a leaf above :data:`MAX_CHUNK_SIZE` bytes (at the top or as a map
  value) as flax chunks it: ``{"__msgpack_chunked_array__": True,
  "shape": {"0": ...}, "chunks": {"0": ...}}``.

Arrays are numpy arrays or torch tensors. ``bfloat16``, which numpy
lacks, is written by its name from a uint16 view of a torch tensor (or
of a numpy array whose dtype is named ``bfloat16``) and read back as a
torch ``bfloat16`` tensor; every other dtype reads as a numpy array.
Array bytes are packed and read as whole buffers: the encoder hands
out views (:func:`encode_parts`) and the decoder returns arrays that
view the input (read-only, as flax's do).

:func:`to_bytes` / :func:`from_bytes` follow ``flax.serialization``'s:
a tree goes to its state dict first (dict keys as ``str``, lists,
tuples as ``{"0": ...}``, a namedtuple by field), and ``from_bytes``
restores into the structure of ``target``, raising ``ValueError``
where the target has a key the bytes lack (keys the bytes have beyond
the target's are dropped, as flax drops them).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class ExtType(NamedTuple):
    """An ext value of a type code the codec does not interpret."""
    code: int
    data: bytes


class _Array(NamedTuple):
    """A leaf's shape, dtype name and flat C-order bytes (uint8)."""
    shape: tuple
    dtype: str
    data: np.ndarray

    @property
    def nbytes(self) -> int:
        return int(self.data.size)


def _as_array(x: Any):
    """``x`` as an :class:`_Array`, or None when it is no array."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            flat = t.view(torch.int16).numpy().reshape(-1).view(np.uint8)
            return _Array(tuple(t.shape), "bfloat16", flat)
        arr = t.numpy()
    elif isinstance(x, np.ndarray):
        arr = x
    else:
        return None
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or \
            arr.dtype.fields is not None:
        raise ValueError("Object and structured dtypes not supported for "
                         "serialization of ndarrays.")
    # (np.ascontiguousarray would turn a 0-d array into a 1-d one)
    flat = np.ascontiguousarray(arr.reshape(-1))
    return _Array(arr.shape, arr.dtype.name, flat.view(np.uint8))


# ----------------------------------------------------------------------
# encoding
# ----------------------------------------------------------------------
def _int(n: int) -> bytes:
    if 0 <= n < 0x80 or -32 <= n < 0:
        return struct.pack(">b", n) if n < 0 else bytes((n,))
    if n >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if n <= top:
                return bytes((code,)) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if n >= low:
                return bytes((code,)) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit 64 bits")


def _sized(n: int, small: int, small_top: int, codes) -> bytes:
    """A length header: ``small | n`` up to ``small_top`` (when
    ``small`` is set), else the 8/16/32-bit form of ``codes``."""
    if small is not None and n <= small_top:
        return bytes((small | n,))
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"length {n} exceeds msgpack's 32-bit limit")


def _str_header(n: int) -> bytes:
    return _sized(n, 0xa0, 31, (0xd9, 0xda, 0xdb))


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, (0xc4, 0xc5, 0xc6))


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return bytes((fixed[n], code))
    return _sized(n, None, 0, (0xc7, 0xc8, 0xc9)) + bytes((code,))


def _array_payload(a: _Array) -> List[Any]:
    """The packed ``(shape, dtype name, bytes)`` as parts."""
    name = a.dtype.encode()
    head = [_sized(len(a.shape), 0x90, 15, (None, 0xdc, 0xdd)), b"".join(
        _int(int(n)) for n in a.shape), _str_header(len(name)), name,
        _bin_header(a.nbytes)]
    return [b"\x93" + b"".join(head), memoryview(a.data)]


def _pack_array(a: _Array, code: int, out: List[Any]) -> None:
    payload = _array_payload(a)
    out.append(_ext_header(sum(len(p) for p in payload), code))
    out.extend(payload)


def _chunk(a: _Array) -> Dict[str, Any]:
    """flax's chunked form of an oversized leaf: 1-D pieces of at most
    ``MAX_CHUNK_SIZE // itemsize`` elements."""
    count = int(np.prod(a.shape, dtype=np.int64))
    itemsize = a.nbytes // count
    step = max(1, MAX_CHUNK_SIZE // itemsize)
    chunks = {}
    for i, start in enumerate(range(0, count, step)):
        n = min(step, count - start)
        chunks[str(i)] = _Array((n,), a.dtype, a.data[
            start * itemsize:(start + n) * itemsize])
    return {_CHUNKED: True,
            "shape": {str(i): int(n) for i, n in enumerate(a.shape)},
            "chunks": chunks}


def _pack(obj: Any, out: List[Any], chunk: bool) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_int(obj))
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        data = obj.encode("utf-8")
        out.append(_str_header(len(data)))
        out.append(data)
    elif t in (bytes, bytearray, memoryview):
        data = memoryview(obj).cast("B")
        out.append(_bin_header(data.nbytes))
        out.append(data)
    elif t is dict:
        out.append(_sized(len(obj), 0x80, 15, (None, 0xde, 0xdf)))
        for key, value in obj.items():
            _pack(key, out, False)
            _pack(value, out, True)
    elif t is list:
        out.append(_sized(len(obj), 0x90, 15, (None, 0xdc, 0xdd)))
        for value in obj:
            _pack(value, out, False)
    elif t is complex:
        data = b"\x92\xcb" + struct.pack(">d", obj.real) + b"\xcb" + \
            struct.pack(">d", obj.imag)
        out.append(_ext_header(len(data), EXT_COMPLEX))
        out.append(data)
    elif t is _Array:
        if chunk and obj.nbytes > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out, False)
        else:
            _pack_array(obj, EXT_NDARRAY, out)
    elif isinstance(obj, np.generic):
        _pack_array(_as_array(np.asarray(obj)), EXT_NPSCALAR, out)
    else:
        arr = _as_array(obj)
        if arr is None:
            raise TypeError(f"can not serialize {t.__name__!r} object")
        _pack(arr, out, chunk)


def encode_parts(pytree: Any) -> List[Any]:
    """The msgpack bytes of ``pytree`` (dicts, lists and leaves) as a
    list of bytes and memoryviews over the arrays' own buffers:
    ``b"".join`` of it is :func:`msgpack_serialize`'s result, and a
    writer can stream it without that copy."""
    out: List[Any] = []
    _pack(pytree, out, True)
    return out


def msgpack_serialize(pytree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize``: a tree of dicts and
    lists with Python and array leaves, oversized leaves chunked."""
    return b"".join(encode_parts(pytree))


# ----------------------------------------------------------------------
# decoding
# ----------------------------------------------------------------------
class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        fmts = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in fmts:
            return self.unpack(fmts[b])
        sizes = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xc7: ">B", 0xc8: ">H",
                 0xc9: ">I", 0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xdc: ">H",
                 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}
        if b in sizes:
            n = self.unpack(sizes[b])
            if b <= 0xc6:
                return self.take(n)
            if b <= 0xc9:
                code = self.unpack(">b")
                return _ext(code, self.take(n))
            if b <= 0xdb:
                return str(self.take(n), "utf-8")
            if b <= 0xdd:
                return [self.read() for _ in range(n)]
            return self._map(n)
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, self.take(fixext[b]))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _array_from(data: memoryview):
    """ext 1's payload as an array viewing ``data``: numpy, or a torch
    bfloat16 tensor."""
    reader = _Reader(data)
    shape, name, buf = reader.read()
    shape = tuple(shape)
    if name == "bfloat16":
        arr = np.frombuffer(buf, np.uint16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


def _ext(code: int, data: memoryview) -> Any:
    if code == EXT_NDARRAY:
        return _array_from(data)
    if code == EXT_COMPLEX:
        real, imag = _Reader(data).read()
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        return _array_from(data)[()]
    return ExtType(code, bytes(data))


def _unchunk(node: Any) -> Any:
    if isinstance(node, dict):
        if _CHUNKED in node:
            shape = tuple(node["shape"][str(i)]
                          for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def msgpack_restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of ``data``,
    chunked leaves joined. bin values come back as ``bytes``."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("extra data after the msgpack object")
    return _unchunk(_bytes_out(tree))


def _bytes_out(node: Any) -> Any:
    if isinstance(node, memoryview):
        return bytes(node)
    if isinstance(node, dict):
        return {k: _bytes_out(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_bytes_out(v) for v in node]
    return node


# ----------------------------------------------------------------------
# state dicts (flax.serialization.to_state_dict / from_state_dict)
# ----------------------------------------------------------------------
def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_state_dict(tree: Any) -> Any:
    if isinstance(tree, dict):
        keys = {str(k) for k in tree}
        if len(keys) != len(tree):
            raise ValueError("Dict keys do not have a unique string "
                             f"representation: {keys} vs given: {tree}")
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return {k: to_state_dict(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def from_state_dict(target: Any, state: Any, path: str = ".") -> Any:
    if isinstance(target, dict):
        diff = set(map(str, target.keys())).difference(state.keys())
        if diff:
            raise ValueError(
                "The target dict keys and state dict keys do not match, "
                f"target dict contains keys {diff} which are not present "
                f"in state dict at path {path}")
        return {k: from_state_dict(v, state[str(k)],
                                   _join(path, str(k)))
                for k, v in target.items()}
    if _is_namedtuple(target):
        if set(state.keys()) != set(target._fields):
            raise ValueError(
                "The field names of the state dict and the named tuple do "
                f"not match, got {set(state.keys())} and "
                f"{set(target._fields)} at path {path}")
        return type(target)(**{
            k: from_state_dict(getattr(target, k), v, _join(path, k))
            for k, v in state.items()})
    if isinstance(target, (list, tuple)):
        if len(state) != len(target):
            raise ValueError(
                "The size of the list and the state dict do not match, got "
                f"{len(target)} and {len(state)} at path {path}")
        out = [from_state_dict(t, state[str(i)], _join(path, str(i)))
               for i, t in enumerate(target)]
        return out if isinstance(target, list) else tuple(out)
    return state


def _join(path: str, key: str) -> str:
    return f"{path}/{key}" if path != "." else f"./{key}"


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes``."""
    return msgpack_serialize(to_state_dict(tree))


def from_bytes(target: Any, data) -> Any:
    """``flax.serialization.from_bytes``."""
    return from_state_dict(target, msgpack_restore(data))
