"""The port's msgpack codec against ``flax.serialization``.

The same dicts go through both: the port's ``to_bytes`` must give
flax's bytes exactly (scalars of every msgpack width, float32 / int32 /
bool / bfloat16 arrays, numpy scalars, empty and nested maps, a chunked
leaf with ``MAX_CHUNK_SIZE`` patched small on both sides), the port must
decode flax's bytes to the same values, and ``from_bytes`` refuses a
target key the bytes lack as flax does (and drops extra keys as flax
does). flax packs a dict's keys in the dict's own order, so byte
equality is checked on the very same dict.
"""

import flax.serialization as fser
import ml_dtypes
import numpy as np
import pytest
import torch

from learningorchestra_tpu_torch.runtime import serialization as ser


def _rng():
    return np.random.default_rng(0)


TREES = {
    "float32 nested": lambda: {
        "a": _rng().standard_normal((3, 4)).astype(np.float32),
        "b": {"c": np.arange(5, dtype=np.int32),
              "d": np.array([True, False, True])}},
    "python scalars": lambda: {
        "float": 1.5, "none": None, "true": True, "false": False,
        "str": "sé", "bytes": b"\x00\x01", "fixint": 127, "neg fixint": -32,
        "u8": 200, "u16": 60000, "u32": 2 ** 31, "u64": 2 ** 40,
        "i8": -100, "i16": -200, "i32": -70000, "i64": -2 ** 40,
        "complex": complex(1, -2)},
    "numpy scalars": lambda: {
        "f32": np.float32(2.5), "i64": np.int64(-7), "bool": np.bool_(True),
        "f64": np.float64(1e300), "u8": np.uint8(9)},
    "empty and nested maps": lambda: {
        "e": {}, "f": {"g": {}}, "h": np.zeros((0, 3), np.float32),
        "long key " * 5: np.ones((20,), np.float64),
        **{f"k{i}": i for i in range(20)}},
    "list": lambda: {"l": [1, 2.0, "x", [None]]},
    "bfloat16": lambda: {"bf": _rng().standard_normal(
        (7, 3)).astype(ml_dtypes.bfloat16)},
    "non-contiguous": lambda: {"t": np.ones((3, 4), np.float32).T},
    "wide array": lambda: {"w": _rng().standard_normal(
        (300, 300)).astype(np.float32)},
}


@pytest.mark.parametrize("case", list(TREES))
def test_bytes_equal_flax(case):
    tree = TREES[case]()
    assert ser.to_bytes(tree) == fser.to_bytes(tree)


def _same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, np.ndarray) and want.dtype == ml_dtypes.bfloat16:
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("case", list(TREES))
def test_decodes_flax_bytes(case):
    tree = TREES[case]()
    data = fser.to_bytes(tree)
    _same(ser.msgpack_restore(data), fser.msgpack_restore(data))
    assert ser.to_bytes(ser.msgpack_restore(data)) == data


def test_torch_tensors_pack_as_their_arrays():
    """A torch tensor packs as the numpy array of its values; bfloat16
    by name from a uint16 view, and it reads back as a bf16 tensor."""
    t = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    b = t.to(torch.bfloat16)
    want = fser.to_bytes({"t": t.numpy(), "b": b.view(torch.int16).numpy()
                          .view(ml_dtypes.bfloat16)})
    assert ser.to_bytes({"t": t, "b": b}) == want
    back = ser.from_bytes({"t": 0, "b": 0}, want)
    assert torch.equal(back["b"], b)
    np.testing.assert_array_equal(back["t"], t.numpy())


def test_chunked_leaf_matches_flax(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 64)
    big = _rng().standard_normal((5, 7)).astype(np.float32)
    tree = {"big": big, "small": np.ones(3, np.float32),
            "inner": {"bf": big.astype(ml_dtypes.bfloat16)}}
    data = fser.to_bytes(tree)
    assert ser.to_bytes(tree) == data
    assert b"__msgpack_chunked_array__" in data
    back = ser.from_bytes(tree, data)
    np.testing.assert_array_equal(back["big"], big)
    np.testing.assert_array_equal(
        back["inner"]["bf"].view(torch.int16).numpy(),
        tree["inner"]["bf"].view(np.int16))
    # and flax reads the port's chunked bytes
    np.testing.assert_array_equal(fser.msgpack_restore(
        ser.to_bytes(tree))["big"], big)


def test_state_dict_of_lists_tuples_and_namedtuples():
    from typing import NamedTuple

    class Pair(NamedTuple):
        mu: np.ndarray
        nu: np.ndarray

    tree = {"opt": (Pair(np.ones(2, np.float32), np.zeros(2, np.float32)),
                    [np.int32(3)])}
    data = fser.to_bytes(tree)
    assert ser.to_bytes(tree) == data
    back = ser.from_bytes(tree, data)
    assert isinstance(back["opt"], tuple) and isinstance(back["opt"][0], Pair)
    np.testing.assert_array_equal(back["opt"][0].mu, np.ones(2))


def test_from_bytes_refuses_missing_keys_as_flax():
    data = fser.to_bytes({"a": np.ones(2, np.float32),
                          "b": {"c": np.int32(3)}})
    for target in ({"a": 0, "z": 0, "b": {"c": 0}},
                   {"a": 0, "b": {"c": 0, "d": 1}}):
        with pytest.raises(ValueError) as want:
            fser.from_bytes(target, data)
        with pytest.raises(ValueError) as got:
            ser.from_bytes(target, data)
        assert str(got.value) == str(want.value)
    # extra keys in the bytes are dropped, as flax drops them
    target = {"a": 0}
    assert list(ser.from_bytes(target, data)) == \
        list(fser.from_bytes(target, data)) == ["a"]
    with pytest.raises(ValueError, match="size of the list"):
        ser.from_bytes([1, 2, 3], ser.to_bytes([1, 2]))


def test_arrays_are_packed_whole():
    """Encoding hands out views of the arrays' buffers (no element
    loop): the parts of a 64 MB leaf are a few headers and one view."""
    arr = np.zeros((4096, 4096), np.float32)
    parts = ser.encode_parts({"w": arr})
    assert len(parts) <= 6
    views = [p for p in parts if isinstance(p, memoryview)]
    assert len(views) == 1 and views[0].nbytes == arr.nbytes
    assert np.shares_memory(np.frombuffer(views[0], np.uint8), arr)
    back = ser.msgpack_restore(b"".join(parts))["w"]
    assert not back.flags.writeable  # a view of the bytes, as flax's


def test_refusals():
    with pytest.raises(TypeError, match="can not serialize"):
        ser.to_bytes({"x": object()})
    with pytest.raises(ValueError, match="Object"):
        ser.to_bytes({"x": np.array([object()])})
    with pytest.raises(ValueError, match="truncated"):
        ser.msgpack_restore(fser.to_bytes({"a": 1.0})[:-1])
