"""Pure-python reader for TensorFlow SavedModel variable bundles.

The reference round-trips live Keras models through
``keras.models.save_model`` / ``load_model`` on a SavedModel directory
(reference binary_executor_image/utils.py:201-220) — the one artifact
format a TF-free runtime cannot open through h5py. This module reads
that format directly, without importing tensorflow:

- ``variables/variables.index`` is a leveldb-style immutable table
  (block-based SSTable, prefix-compressed keys, varint-encoded
  lengths, 48-byte footer ending in the 0xdb4775248b80fb57 magic)
  whose values are serialized ``BundleEntryProto`` messages;
- ``variables/variables.data-NNNNN-of-NNNNN`` shards hold the raw
  little-endian tensor bytes at (offset, size) from the entry;
- ``keras_metadata.pb`` is a ``SavedMetadata`` protobuf whose nodes
  carry the Keras layer/model configs as JSON strings.

Only the subset TF actually writes for checkpoints is implemented
(uncompressed blocks, single-level index); anything else fails loudly.

The port's copy of the JAX package's reader, which the port never
imports. It needs numpy alone, so it runs on any machine the port runs
on; where the JAX reader returns a bfloat16 tensor as an ``ml_dtypes``
array, this one widens it to float32 (the same values).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

_TABLE_MAGIC = 0xdb4775248b80fb57
_FOOTER_LEN = 48

# tensorflow DataType enum -> numpy dtype (the checkpointable subset)
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
    5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
    14: None,  # bfloat16 — read as uint16 and widened to float32
    17: np.uint16, 19: np.float16, 22: np.uint32, 23: np.uint64,
}


_BFLOAT16 = 14


def _np_dtype(enum: int):
    """The dtype of the stored bytes (bfloat16's as uint16)."""
    if enum == _BFLOAT16:
        return np.dtype(np.uint16)
    try:
        dt = _DTYPES[enum]
    except KeyError:
        raise ValueError(
            f"unsupported tensor dtype enum {enum} in bundle") from None
    return np.dtype(dt)


# ----------------------------------------------------------------------
# minimal protobuf wire-format decoding (no generated classes)
# ----------------------------------------------------------------------
def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, i


def pb_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) triples; length-delimited
    values are raw bytes, varints are ints."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, v


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    dims: List[int] = []
    for field, _, v in pb_fields(buf):
        if field == 2:  # Dim
            for f2, _, v2 in pb_fields(v):
                if f2 == 1:  # size
                    dims.append(v2)
        elif field == 3 and v:  # unknown_rank
            raise ValueError("bundle tensor with unknown rank")
    return tuple(dims)


def _parse_entry(buf: bytes) -> Dict[str, Any]:
    out = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0,
           "size": 0}
    for field, _, v in pb_fields(buf):
        if field == 1:
            out["dtype"] = v
        elif field == 2:
            out["shape"] = _parse_shape(v)
        elif field == 3:
            out["shard_id"] = v
        elif field == 4:
            out["offset"] = v
        elif field == 5:
            out["size"] = v
        elif field == 7:
            raise ValueError("sliced/partitioned bundle tensors are "
                             "not supported")
    return out


# ----------------------------------------------------------------------
# leveldb-style immutable table (the .index file)
# ----------------------------------------------------------------------
def _read_block(data: bytes, offset: int, size: int) -> bytes:
    block = data[offset:offset + size]
    if len(block) != size:
        raise ValueError("truncated table block")
    comp = data[offset + size]
    if comp != 0:
        raise ValueError(
            f"compressed table block (type {comp}); TF writes "
            f"checkpoint indexes uncompressed")
    return block


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    (n_restarts,) = struct.unpack("<I", block[-4:])
    data_end = len(block) - 4 - 4 * n_restarts
    i = 0
    key = b""
    while i < data_end:
        shared, i = _varint(block, i)
        unshared, i = _varint(block, i)
        vlen, i = _varint(block, i)
        key = key[:shared] + block[i:i + unshared]
        i += unshared
        yield key, block[i:i + vlen]
        i += vlen


def read_index(path: str) -> Dict[str, Dict[str, Any]]:
    """All (tensor_name -> BundleEntry dict) pairs from a
    ``variables.index`` file, plus the header under the ``""`` key."""
    data = open(path, "rb").read()
    if len(data) < _FOOTER_LEN:
        raise ValueError(f"{path}: too short to be a bundle index")
    footer = data[-_FOOTER_LEN:]
    (magic,) = struct.unpack("<Q", footer[-8:])
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{path}: bad table magic {magic:#x}")
    # footer = metaindex handle + index handle (varints), padded
    i = 0
    _, i = _varint(footer, i)   # metaindex offset (unused)
    _, i = _varint(footer, i)   # metaindex size
    idx_off, i = _varint(footer, i)
    idx_size, i = _varint(footer, i)
    index_block = _read_block(data, idx_off, idx_size)
    entries: Dict[str, Dict[str, Any]] = {}
    header: Dict[str, Any] = {}
    for _, handle in _block_entries(index_block):
        off, j = _varint(handle, 0)
        size, j = _varint(handle, j)
        for key, value in _block_entries(_read_block(data, off, size)):
            name = key.decode("utf-8")
            if name == "":
                for field, _, v in pb_fields(value):  # BundleHeader
                    if field == 1:
                        header["num_shards"] = v
            else:
                entries[name] = _parse_entry(value)
    entries[""] = header or {"num_shards": 1}
    return entries


def _shard_reader(variables_prefix: str, num_shards: int):
    shards: Dict[int, bytes] = {}

    def shard(i: int) -> bytes:
        if i not in shards:
            p = f"{variables_prefix}.data-{i:05d}-of-{num_shards:05d}"
            shards[i] = open(p, "rb").read()
        return shards[i]

    return shard


def read_tensors(variables_prefix: str, keys,
                 entries: Dict[str, Dict[str, Any]] = None,
                 ) -> Dict[str, np.ndarray]:
    """Decode only ``keys`` from a checkpoint bundle (a trained
    checkpoint also carries optimizer slot variables ~2x the model
    size — selective decode skips them). ``entries`` reuses an
    already-parsed index."""
    if entries is None:
        entries = read_index(variables_prefix + ".index")
    header = entries.get("", {})
    shard = _shard_reader(variables_prefix,
                          header.get("num_shards", 1))
    out: Dict[str, np.ndarray] = {}
    for name in keys:
        if name in out:
            continue
        e = entries[name]
        dt = _np_dtype(e["dtype"])
        raw = shard(e["shard_id"])[e["offset"]:e["offset"] + e["size"]]
        n = int(np.prod(e["shape"])) if e["shape"] else 1
        if len(raw) != n * dt.itemsize:
            raise ValueError(
                f"{name}: shard slice has {len(raw)} bytes, expected "
                f"{n * dt.itemsize} for shape {e['shape']} {dt}")
        arr = np.frombuffer(raw, dtype=dt).reshape(e["shape"])
        if e["dtype"] == _BFLOAT16:
            # a bfloat16 is the high half of a float32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out


def read_bundle(variables_prefix: str) -> Dict[str, np.ndarray]:
    """All (non-string) tensors of a checkpoint bundle, keyed by
    checkpoint name.

    ``variables_prefix`` is the path without extensions, e.g.
    ``<savedmodel>/variables/variables``.
    """
    entries = read_index(variables_prefix + ".index")
    keys = [k for k, e in entries.items()
            if k and e.get("dtype") != 7]  # strings = bookkeeping
    return read_tensors(variables_prefix, keys, entries=entries)


# ----------------------------------------------------------------------
# the checkpoint object graph (how named paths map to tensor keys)
# ----------------------------------------------------------------------
OBJECT_GRAPH_KEY = "_CHECKPOINTABLE_OBJECT_GRAPH"


def read_object_graph(variables_prefix: str,
                      entries: Dict[str, Dict[str, Any]] = None,
                      ) -> List[Dict[str, Any]]:
    """The checkpoint's ``TrackableObjectGraph`` as a list of nodes:
    ``{"children": {local_name: node_id},
    "attributes": {attr_name: checkpoint_key}}``.

    The saver dedupes shared variables by storing each tensor under ONE
    canonical key (e.g. an RNN cell kernel lands under ``variables/3``
    rather than ``layer_with_weights-1/cell/kernel/...``), so named
    lookups must resolve through this graph, not by string-joining
    paths."""
    if entries is None:
        entries = read_index(variables_prefix + ".index")
    header = entries.get("", {})
    e = entries.get(OBJECT_GRAPH_KEY)
    if e is None:
        raise ValueError(
            f"{variables_prefix}: checkpoint has no object graph")
    num_shards = header.get("num_shards", 1)
    p = (f"{variables_prefix}.data-{e['shard_id']:05d}-of-"
         f"{num_shards:05d}")
    raw = open(p, "rb").read()[e["offset"]:e["offset"] + e["size"]]
    # DT_STRING tensor encoding: one varint64 length per element, a
    # fixed32 crc32c of the lengths, then the concatenated bytes —
    # the graph is a scalar (1 element)
    ln, i = _varint(raw, 0)
    i += 4  # crc32c of the lengths region
    graph_bytes = raw[i:i + ln]
    nodes: List[Dict[str, Any]] = []
    for field, _, node_buf in pb_fields(graph_bytes):
        if field != 1:  # TrackableObjectGraph.nodes
            continue
        node = {"children": {}, "attributes": {}}
        for f2, _, v2 in pb_fields(node_buf):
            if f2 == 1:  # ObjectReference children
                node_id, local_name = 0, ""
                for f3, _, v3 in pb_fields(v2):
                    if f3 == 1:
                        node_id = v3
                    elif f3 == 2:
                        local_name = v3.decode("utf-8")
                node["children"][local_name] = node_id
            elif f2 == 2:  # SerializedTensor attributes
                attr_name, ckpt_key = "", ""
                for f3, _, v3 in pb_fields(v2):
                    if f3 == 1:
                        attr_name = v3.decode("utf-8")
                    elif f3 == 3:
                        ckpt_key = v3.decode("utf-8")
                node["attributes"][attr_name] = ckpt_key
        nodes.append(node)
    if not nodes:
        raise ValueError(f"{variables_prefix}: empty object graph")
    return nodes


def resolve_variable(nodes: List[Dict[str, Any]], path: str,
                     start: int = 0) -> str:
    """Follow ``path`` ("layer_with_weights-0/cell/kernel") through the
    object graph from node ``start`` and return the variable's
    canonical checkpoint key."""
    node_id = start
    for part in path.split("/"):
        children = nodes[node_id]["children"]
        if part not in children:
            raise KeyError(
                f"object-graph path {path!r}: node {node_id} has no "
                f"child {part!r} (has {sorted(children)})")
        node_id = children[part]
    attrs = nodes[node_id]["attributes"]
    if "VARIABLE_VALUE" not in attrs:
        raise KeyError(
            f"object-graph path {path!r} ends at node {node_id} which "
            f"is not a variable (attributes: {sorted(attrs)})")
    return attrs["VARIABLE_VALUE"]


# ----------------------------------------------------------------------
# keras_metadata.pb — model config extraction
# ----------------------------------------------------------------------
def _untuple(obj: Any) -> Any:
    """tf_keras serializes python tuples as {"class_name": "__tuple__",
    "items": [...]} and tf.TensorShape as {"class_name": "TensorShape",
    "items": [...]}; flatten both back to lists recursively."""
    if isinstance(obj, dict):
        if obj.get("class_name") in ("__tuple__", "TensorShape") \
                and "items" in obj:
            return [_untuple(v) for v in obj["items"]]
        return {k: _untuple(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_untuple(v) for v in obj]
    return obj


def read_saved_model_config(path: str) -> Dict[str, Any]:
    """The Sequential model config (keras dialect, ``__tuple__``
    wrappers removed) from a SavedModel directory's
    ``keras_metadata.pb``."""
    meta_path = os.path.join(path, "keras_metadata.pb")
    if not os.path.exists(meta_path):
        raise ValueError(
            f"{path}: no keras_metadata.pb — not a Keras SavedModel "
            f"(plain tf.Modules have no layer configs to import)")
    data = open(meta_path, "rb").read()
    for field, _, node in pb_fields(data):
        if field != 1:  # SavedMetadata.nodes
            continue
        ident, meta = None, None
        for f2, _, v2 in pb_fields(node):
            if f2 == 4:
                ident = v2.decode("utf-8", "replace")
            elif f2 == 5:
                meta = v2
        if ident in ("_tf_keras_sequential", "_tf_keras_model",
                     "_tf_keras_network") and meta:
            j = json.loads(meta)
            cfg = {"class_name": j.get("class_name"),
                   "config": _untuple(j.get("config", {}))}
            if cfg["class_name"] != "Sequential":
                raise ValueError(
                    f"only Sequential SavedModels are supported, got "
                    f"{cfg['class_name']!r}")
            # tf_keras records the built shape on the metadata node,
            # not inside the Sequential config
            build_shape = _untuple(j.get("build_input_shape"))
            if build_shape and not cfg["config"].get(
                    "build_input_shape"):
                cfg["config"]["build_input_shape"] = build_shape
            return cfg
    raise ValueError(f"{meta_path}: no Keras model node found")
