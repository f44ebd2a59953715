"""The port's plain-Python msgpack decoder against
``flax.serialization.msgpack_restore`` on files Flax writes: parameter
trees, every scalar type Flax emits, numpy scalars, complex numbers,
bfloat16 arrays and the chunked form of large arrays."""

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest

from dynamicfuion_python_tpu_torch.utils import flax_msgpack


def _equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(got, want.astype(np.float32))
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) or (isinstance(want, np.generic) and got == want), (got, want)
        assert got == want or (got != got and want != want)


def _tree(rng):
    return {
        "params": {
            "Conv_0": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32), "bias": np.zeros(8, np.float32)},
            "ConvTranspose_1": {"kernel": rng.normal(size=(4, 4, 8, 2)).astype(np.float32), "bias": rng.normal(size=2)},
        },
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, -1, -32, -33, -128, -129, -(2**31), -(2**63)],
        "floats": [0.0, -1.5, 1e300, float("inf"), float("nan")],
        "flags": [True, False, None],
        "names": ["", "a" * 31, "b" * 32, "é" * 200, "c" * 70000],
        "blob": b"\x00\x01" * 40000,
        "shapes": {"u8": np.arange(20, dtype=np.uint8), "i64": np.arange(-3, 3, dtype=np.int64),
                   "bool": np.array([True, False]), "f16": np.ones((2, 2), np.float16), "empty": np.zeros((0, 3), np.float32)},
        "scalars": [np.float32(2.5), np.int32(-7), complex(1.5, -2.0)],
        "bf16": np.asarray(jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16)),
        "many": {str(i): i for i in range(20)},
    }


def test_decoder_matches_flax_restore(tmp_path, rng):
    tree = _tree(rng)
    data = flax.serialization.msgpack_serialize(tree)
    want = flax.serialization.msgpack_restore(data)
    _equal(flax_msgpack.msgpack_restore(data), want)
    (tmp_path / "tree.msgpack").write_bytes(data)
    _equal(flax_msgpack.load(tmp_path / "tree.msgpack"), want)


def test_chunked_arrays_are_joined(rng, monkeypatch):
    """Arrays over Flax's chunk limit (lowered here to 1 kB) are written as
    chunked maps and come back whole."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1024)
    tree = {"big": rng.normal(size=(33, 17)).astype(np.float32), "nested": {"w": rng.normal(size=(600,))}}
    data = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _equal(flax_msgpack.msgpack_restore(data), flax.serialization.msgpack_restore(data))


def test_malformed_data_is_refused():
    data = flax.serialization.msgpack_serialize({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="ends inside"):
        flax_msgpack.msgpack_restore(data[:-3])
    with pytest.raises(ValueError, match="follow"):
        flax_msgpack.msgpack_restore(data + b"\x00")
    with pytest.raises(ValueError, match="0xc1"):
        flax_msgpack.msgpack_restore(b"\xc1")
