"""utils/msgpack_lite.py against flax.serialization on the subset of msgpack
that flax writes: a small tree with every handled type, and the flagship
release's params.msgpack leaf by leaf (exact equality)."""

from pathlib import Path

import msgpack
import numpy as np
import pytest
from flax.serialization import msgpack_restore, msgpack_serialize

from posteriflow_torch.utils.msgpack_lite import unpackb

RELEASE = Path(__file__).resolve().parents[1] / "model_release" / "npe_r7_best"


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _assert_same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def _small_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "dense": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                      "bias": np.zeros(4, np.float32)},
            "conv": {"kernel": rng.standard_normal((5, 1, 2))},   # float64
        },
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                 -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
        "floats": [0.5, -1e300, float("inf")],
        "flags": [True, False, None],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "é"],
        "blob": b"\x00\x01" * 200,
        "arrays": {str(i): a for i, a in enumerate([
            np.arange(6, dtype=np.int32).reshape(2, 3),
            np.arange(5, dtype=np.int64), np.ones(3, np.uint8),
            np.array([True, False]), np.float16([1.5, -2.0]),
            np.array(3.0, np.float32), np.zeros((0, 4), np.float32)])},
        "wide": {f"k{i:02d}": i for i in range(20)},            # map16
        "long": list(range(20)),                                 # array16
    }


def test_small_tree_matches_flax():
    data = msgpack_serialize(_small_tree())
    _assert_same(unpackb(data), msgpack_restore(data))


def test_release_params_match_flax():
    data = (RELEASE / "params.msgpack").read_bytes()
    mine, ref = _flat(unpackb(data)), _flat(msgpack_restore(data))
    assert len(mine) == len(ref) == 165
    assert list(mine) == list(ref)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype and mine[k].shape == ref[k].shape
        np.testing.assert_array_equal(mine[k], ref[k])


@pytest.mark.parametrize("payload", [
    msgpack.packb(msgpack.ExtType(2, b"\x00" * 9)),            # complex
    msgpack_serialize({"x": np.float32(1.0)}),                  # npscalar ext 3
    msgpack.packb({"__msgpack_chunked_array__": True,
                   "shape": {"0": 1}, "chunks": {}}),           # chunked
    msgpack_serialize({"x": np.ones(3, np.float32)})[:-2],      # truncated
    msgpack_serialize({"x": 1}) + b"\xc0",                      # trailing
], ids=["ext2", "ext3", "chunked", "truncated", "trailing"])
def test_unsupported_input_raises(payload):
    with pytest.raises(ValueError):
        unpackb(payload)
