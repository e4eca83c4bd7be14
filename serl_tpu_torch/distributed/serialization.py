"""Tree <-> bytes codec for the native transport, in numpy.

Port of `serl_tpu/distributed/serialization.py`. Array leaves travel as raw
buffers behind a (dtype name, shape) header, the tree's structure and its
other leaves in a small pickled skeleton, so multi-MB params are never
pickled leaf by leaf. The wire framing is the JAX package's:

  [u32 skeleton_len][skeleton pickle][for each array: u32 header_len
   [header pickle (dtype.name, shape)] raw bytes]

The array section is the JAX package's byte for byte, in its leaf order:
dicts by sorted key, lists and tuples in order, `None` an empty subtree (no
leaf). Where JAX pickles a treedef, the skeleton here holds builtins only: a
mirror of the containers with a placeholder per leaf. Leaves that are
`np.ndarray` (0-d included) or `torch.Tensor` (sent as
`.detach().cpu().numpy()`) are arrays; anything else, numpy scalars such as
a transition's `np.float32(reward)` among them, is pickled into the
skeleton, as JAX does. A dtype that numpy cannot name (bfloat16) raises: it
is never cast. `loads` returns numpy arrays.

One departure: JAX's `np.ascontiguousarray` turns a 0-d array into shape
(1,) on the wire; here a 0-d array keeps shape () (its raw bytes are the
same). The published params hold 0-d leaves (the temperature), which
`utils/jax_params.py::load_sac_params` checks by shape.
"""

import hashlib
import pickle
import struct
from typing import Any

import numpy as np
import torch

_U32 = struct.Struct("<I")
# skeleton node kinds: containers, then the two leaf kinds
_DICT, _LIST, _TUPLE, _NONE, _ARRAY, _PY = range(6)


def _as_array(leaf):
    """The numpy array a leaf travels as, or None for a non-array leaf."""
    if isinstance(leaf, torch.Tensor):
        try:
            return leaf.detach().cpu().numpy()
        except TypeError as exc:
            raise TypeError(f"a {leaf.dtype} tensor has no numpy dtype and is not cast: "
                            f"convert it before sending") from exc
    if isinstance(leaf, np.ndarray):
        return leaf
    return None


def _flatten(tree, arrays):
    """The skeleton of `tree`, appending its array leaves to `arrays` in
    jax.tree.flatten's order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return (_DICT, keys, [_flatten(tree[k], arrays) for k in keys])
    if type(tree) is list:
        return (_LIST, [_flatten(x, arrays) for x in tree])
    if type(tree) is tuple:
        return (_TUPLE, [_flatten(x, arrays) for x in tree])
    if tree is None:
        return (_NONE,)
    arr = _as_array(tree)
    if arr is None:
        return (_PY, tree)
    arrays.append(arr)
    return (_ARRAY,)


def dumps(tree: Any) -> bytes:
    """The payload of `tree`, its arrays' bytes copied once (into the
    joined result)."""
    arrays = []
    skeleton = pickle.dumps(_flatten(tree, arrays))
    parts = [_U32.pack(len(skeleton)), skeleton]
    for arr in arrays:
        arr = arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)
        hdr = pickle.dumps((arr.dtype.name, arr.shape))
        parts += [_U32.pack(len(hdr)), hdr, arr.reshape(-1).view(np.uint8).data]
    return b"".join(parts)


def _unflatten(node, next_array):
    kind = node[0]
    if kind == _DICT:
        return {k: _unflatten(child, next_array) for k, child in zip(node[1], node[2])}
    if kind == _LIST:
        return [_unflatten(child, next_array) for child in node[1]]
    if kind == _TUPLE:
        return tuple(_unflatten(child, next_array) for child in node[1])
    if kind == _NONE:
        return None
    if kind == _PY:
        return node[1]
    return next_array()


def loads(data: bytes) -> Any:
    """The tree that `dumps` wrote. Unpickling runs code: take payloads only
    from this project's processes."""
    mv = memoryview(data)
    (skel_len,) = _U32.unpack_from(mv, 0)
    off = 4 + skel_len
    skeleton = pickle.loads(bytes(mv[4:off]))

    def next_array():
        nonlocal off
        (hdr_len,) = _U32.unpack_from(mv, off)
        off += 4
        dtype_name, shape = pickle.loads(bytes(mv[off: off + hdr_len]))
        off += hdr_len
        dtype = np.dtype(dtype_name)
        nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(mv[off: off + nbytes], dtype=dtype).reshape(shape)
        off += nbytes
        return arr.copy()

    return _unflatten(skeleton, next_array)


def digest(tree: Any) -> str:
    """A short hash of the tree's payload: equal for equal trees (structure,
    dtypes, shapes and bytes), what the two-process examples print for the
    params that the learner published and that the actor loaded."""
    return hashlib.sha256(dumps(tree)).hexdigest()[:16]
