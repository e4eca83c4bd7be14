"""The port's transport codec (`serl_tpu_torch/distributed/serialization.py`)
against serl_tpu's: round trips of every leaf kind, and the array section
of the payload (each array's header and raw bytes, in JAX's leaf order)
byte for byte equal to JAX's `dumps` of the same numpy tree."""

import struct

import numpy as np
import pytest
import torch

from serl_tpu.distributed import serialization as jser
from serl_tpu_torch.distributed import serialization as ser


def _tree(rng):
    """A nested numpy tree with every kind of leaf but 0-d arrays, its dict
    keys inserted out of sorted order."""
    return {
        "zeta": {"b": rng.normal(size=(3, 4)).astype(np.float32),
                 "a": rng.integers(0, 256, (2, 1, 8, 8, 3), dtype=np.uint8)},
        "alpha": [rng.integers(-5, 5, (7,), dtype=np.int32), None,
                  (rng.uniform(size=(2, 2)) > 0.5, np.float32(1.5), 3)],
        "mid": {"reward": np.float32(0.25), "flag": True, "name": "actor_env",
                "empty": {}, "t": rng.normal(size=(5,)).astype(np.float64)},
    }


def _array_section(payload: bytes) -> bytes:
    (skel_len,) = struct.unpack_from("<I", payload, 0)
    return payload[4 + skel_len:]


def _assert_equal_trees(got, want):
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == sorted(want)
        for k in want:
            _assert_equal_trees(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_equal_trees(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert got.flags.writeable
    else:
        assert got == want and type(got) is type(want)


def test_torch_codec_round_trips_every_leaf_kind():
    tree = _tree(np.random.default_rng(0))
    tree["zero_d"] = {"f": np.array(2.5, np.float32), "i": np.array(7, np.int64)}
    tree["column"] = np.arange(12, dtype=np.float32).reshape(3, 4).T  # not C-contiguous
    _assert_equal_trees(ser.loads(ser.dumps(tree)), tree)
    assert ser.loads(ser.dumps(tree))["zero_d"]["f"].shape == ()


def test_torch_codec_sends_tensors_as_numpy():
    t = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)),
         "steps": torch.arange(5, dtype=torch.int32), "u8": torch.zeros(2, 2, dtype=torch.uint8),
         "scalar": torch.tensor(3.0), "mask": torch.tensor([True, False]),
         "grad": torch.ones(2, requires_grad=True) * 2.0}
    got = ser.loads(ser.dumps(t))
    for k, v in t.items():
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], v.detach().numpy())
        assert got[k].dtype == v.detach().numpy().dtype and got[k].shape == tuple(v.shape)
    # the same bytes as the tree of their numpy arrays
    assert ser.dumps(t) == ser.dumps({k: v.detach().numpy() for k, v in t.items()})


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_codec_array_section_equals_jax_byte_for_byte(seed):
    tree = _tree(np.random.default_rng(seed))
    port, jax_payload = ser.dumps(tree), jser.dumps(tree)
    assert _array_section(port) == _array_section(jax_payload)
    # each side reads the other's arrays, in the same leaf order
    _assert_equal_trees(ser.loads(port), tree)
    _assert_equal_trees(jser.loads(jax_payload), ser.loads(port))


def test_torch_codec_keeps_zero_d_arrays_zero_d():
    """JAX's `np.ascontiguousarray` sends a 0-d array as shape (1,); the port
    keeps shape () with the same raw bytes, and JAX's loads reads it."""
    tree = {"raw": np.array(-4.6, np.float32)}
    port, jax_payload = _array_section(ser.dumps(tree)), _array_section(jser.dumps(tree))
    assert port.endswith(np.float32(-4.6).tobytes()) and jax_payload.endswith(
        np.float32(-4.6).tobytes())
    assert jser.loads(jser.dumps(tree))["raw"].shape == (1,)
    assert ser.loads(ser.dumps(tree))["raw"].shape == ()


def test_torch_codec_refuses_bfloat16():
    with pytest.raises(TypeError, match="bfloat16"):
        ser.dumps({"w": torch.zeros(3, dtype=torch.bfloat16)})


def test_torch_digest_follows_the_payload():
    tree = _tree(np.random.default_rng(2))
    assert ser.digest(tree) == ser.digest(ser.loads(ser.dumps(tree)))
    tree["zeta"]["b"][0, 0] += 1e-6
    assert ser.digest(tree) != ser.digest(_tree(np.random.default_rng(2)))
