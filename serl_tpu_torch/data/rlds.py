"""RLDS-format trajectory interchange, TensorFlow-free.

Port of `serl_tpu/data/rlds.py`, numpy only (this package keeps its own
copy): the TFRecord framing (length-prefixed records with masked CRC32C)
reader and writer, a minimal `tf.train.Example` protobuf codec (varint
wire format; Example > Features > map<string, Feature> with bytes, float
and int64 lists) and the RLDS step conventions (`observation/<key>`,
`action`, `reward`, `is_first` / `is_last` / `is_terminal`, `discount`).
Arrays are stored flattened (uint8 images as raw bytes) with a
`_shape/<key>` sidecar, so files round-trip losslessly, and both packages
write the same bytes for the same transitions and read each other's files.
`export_rlds` also takes tensors (copied to the host).

`populate_from_rlds` preloads a data store (the host ring's
`ReplayBufferDataStore`) from an RLDS file, the reading side of the
store's `rlds_logger` hook, which takes a `data/trajectory_log.py::
TrajectoryLogger`.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# ------------------------------------------------------------------ #
# crc32c (Castagnoli) — required for valid TFRecord framing
# ------------------------------------------------------------------ #

_CRC_TABLE = None


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------------ #
# TFRecord framing
# ------------------------------------------------------------------ #


def write_tfrecord(path: str, records: List[bytes]) -> None:
    """TFRecord file: [len u64][masked_crc(len) u32][data][masked_crc(data) u32]."""
    with open(path, "wb") as f:
        for rec in records:
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", _masked_crc(length)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))


def read_tfrecord(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw records. CRC verification is optional (costly in pure
    python; framing errors still raise via struct/length checks)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise ValueError(f"truncated TFRecord length header in {path}")
            (length,) = struct.unpack("<Q", header)
            len_crc = f.read(4)
            data = f.read(length)
            data_crc = f.read(4)
            if len(data) != length or len(data_crc) != 4:
                raise ValueError(f"truncated TFRecord record in {path}")
            if verify_crc:
                if struct.unpack("<I", len_crc)[0] != _masked_crc(header):
                    raise ValueError("TFRecord length CRC mismatch")
                if struct.unpack("<I", data_crc)[0] != _masked_crc(data):
                    raise ValueError("TFRecord data CRC mismatch")
            yield data


# ------------------------------------------------------------------ #
# Minimal protobuf wire codec for tf.train.Example
# ------------------------------------------------------------------ #


def _write_varint(n: int, out: bytearray) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int, out: bytearray) -> None:
    _write_varint(field << 3 | wire, out)


def _len_delim(field: int, payload: bytes, out: bytearray) -> None:
    _tag(field, 2, out)
    _write_varint(len(payload), out)
    out += payload


def _encode_feature(value) -> bytes:
    """Feature proto: 1=BytesList, 2=FloatList, 3=Int64List."""
    inner = bytearray()
    if isinstance(value, (bytes, bytearray)):
        bl = bytearray()
        _len_delim(1, bytes(value), bl)
        _len_delim(1, bytes(bl), inner)
    elif np.issubdtype(np.asarray(value).dtype, np.floating):
        arr = np.asarray(value, np.float32).reshape(-1)
        fl = bytearray()
        _tag(1, 2, fl)  # packed floats
        packed = arr.tobytes()
        _write_varint(len(packed), fl)
        fl += packed
        _len_delim(2, bytes(fl), inner)
    else:
        arr = np.asarray(value, np.int64).reshape(-1)
        il = bytearray()
        _tag(1, 2, il)  # packed varints
        packed = bytearray()
        for v in arr.tolist():
            _write_varint(v & 0xFFFFFFFFFFFFFFFF, packed)
        _write_varint(len(packed), il)
        il += packed
        _len_delim(3, bytes(il), inner)
    return bytes(inner)


def _decode_feature(buf: bytes):
    """-> bytes list | np.float32 array | np.int64 array."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        assert wire == 2, (field, wire)
        ln, pos = _read_varint(buf, pos)
        payload = buf[pos:pos + ln]
        pos += ln
        if field == 1:  # BytesList
            out, p = [], 0
            while p < len(payload):
                t, p = _read_varint(payload, p)
                sl, p = _read_varint(payload, p)
                out.append(payload[p:p + sl])
                p += sl
            return out
        if field == 2:  # FloatList
            vals, p = [], 0
            while p < len(payload):
                t, p = _read_varint(payload, p)
                if t & 7 == 2:  # packed
                    sl, p = _read_varint(payload, p)
                    vals.append(np.frombuffer(
                        payload[p:p + sl], np.float32))
                    p += sl
                else:  # unpacked fixed32
                    vals.append(np.frombuffer(
                        payload[p:p + 4], np.float32))
                    p += 4
            return np.concatenate(vals) if vals else np.zeros(0, np.float32)
        if field == 3:  # Int64List
            vals, p = [], 0
            while p < len(payload):
                t, p = _read_varint(payload, p)
                if t & 7 == 2:
                    sl, p = _read_varint(payload, p)
                    end = p + sl
                    while p < end:
                        v, p = _read_varint(payload, p)
                        if v >= 1 << 63:
                            v -= 1 << 64
                        vals.append(v)
                else:
                    v, p = _read_varint(payload, p)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    vals.append(v)
            return np.asarray(vals, np.int64)
    return None


def encode_example(features: Dict[str, object]) -> bytes:
    """dict -> serialized tf.train.Example."""
    fmap = bytearray()
    for key, value in features.items():
        entry = bytearray()
        _len_delim(1, key.encode("utf-8"), entry)
        _len_delim(2, _encode_feature(value), entry)
        _len_delim(1, bytes(entry), fmap)  # Features.feature map entry
    example = bytearray()
    _len_delim(1, bytes(fmap), example)  # Example.features
    return bytes(example)


def decode_example(data: bytes) -> Dict[str, object]:
    """serialized tf.train.Example -> {key: bytes list | float32 | int64}."""
    pos = 0
    out: Dict[str, object] = {}
    tag, pos = _read_varint(data, pos)
    assert tag >> 3 == 1, "not an Example"
    ln, pos = _read_varint(data, pos)
    features = data[pos:pos + ln]
    fpos = 0
    while fpos < len(features):
        tag, fpos = _read_varint(features, fpos)
        ln, fpos = _read_varint(features, fpos)
        entry = features[fpos:fpos + ln]
        fpos += ln
        # map entry: 1=key, 2=Feature
        epos = 0
        key, feat = None, None
        while epos < len(entry):
            t, epos = _read_varint(entry, epos)
            el, epos = _read_varint(entry, epos)
            payload = entry[epos:epos + el]
            epos += el
            if t >> 3 == 1:
                key = payload.decode("utf-8")
            else:
                feat = payload
        out[key] = _decode_feature(feat) if feat else None
    return out


# ------------------------------------------------------------------ #
# RLDS step conventions <-> serl_tpu transitions
# ------------------------------------------------------------------ #


def _flatten_obs(obs, prefix="observation") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(obs, dict):
        for k, v in obs.items():
            out.update(_flatten_obs(v, f"{prefix}/{k}"))
    else:
        out[prefix] = np.asarray(obs)
    return out


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):  # a torch tensor
        return tree.detach().cpu().numpy()
    return tree


def export_rlds(path: str, transitions: Dict, ep_ids) -> int:
    """Write a transitions tree (N-leading arrays or tensors + per-row
    `ep_ids`) as an RLDS-convention TFRecord of per-step Examples. Returns
    steps written.

    Step layout follows RLDS: is_first marks episode starts, is_last the
    final step, is_terminal = environment termination (mask 0)."""
    transitions = _host(transitions)
    ep_ids = np.asarray(_host(ep_ids))
    n = ep_ids.shape[0]
    obs_flat = _flatten_obs(transitions["observations"])
    records = []
    for i in range(n):
        feats: Dict[str, object] = {}
        for k, v in obs_flat.items():
            arr = v[i]
            if arr.dtype == np.uint8:
                feats[k] = arr.tobytes()
            else:
                feats[k] = arr
            feats[f"_shape/{k}"] = np.asarray(arr.shape, np.int64)
        feats["action"] = np.asarray(transitions["actions"][i])
        feats["reward"] = np.asarray(
            transitions["rewards"][i], np.float32
        ).reshape(-1)
        is_first = i == 0 or ep_ids[i] != ep_ids[i - 1]
        is_last = i == n - 1 or ep_ids[i] != ep_ids[i + 1]
        feats["is_first"] = np.asarray([int(is_first)])
        feats["is_last"] = np.asarray([int(is_last)])
        feats["is_terminal"] = np.asarray(
            [int(float(np.asarray(transitions["masks"][i])) < 0.5)]
        )
        feats["discount"] = np.asarray(
            [float(np.asarray(transitions["masks"][i]))], np.float32
        )
        feats["_ep_id"] = np.asarray([int(ep_ids[i])])
        records.append(encode_example(feats))
    write_tfrecord(path, records)
    return n


def import_rlds(
    path: str,
    image_spec: Optional[Dict[str, Tuple[int, ...]]] = None,
) -> Dict:
    """Read an RLDS TFRecord into a serl_tpu transitions dict
    (observations / actions / rewards / masks / dones / ep_ids), suitable
    for `ReplayBuffer.load_transitions` or `demos_to_buffer`.

    `image_spec`: {obs_key: shape} for raw-bytes image features written by
    external RLDS writers (files written by `export_rlds` are
    self-describing via `_shape/` sidecars and need no spec)."""
    steps = []
    for rec in read_tfrecord(path):
        steps.append(decode_example(rec))
    if not steps:
        raise ValueError(f"no records in {path}")

    obs_keys = sorted(
        k for k in steps[0]
        if k.startswith("observation") and not k.startswith("_")
    )

    def decode_obs(step, k):
        v = step[k]
        shape_key = f"_shape/{k}"
        if isinstance(v, list):  # bytes feature -> uint8 tensor
            raw = v[0]
            if shape_key in step:
                shape = tuple(int(x) for x in step[shape_key])
            elif image_spec and k in image_spec:
                shape = tuple(image_spec[k])
            elif image_spec and k.split("/", 1)[-1] in image_spec:
                shape = tuple(image_spec[k.split("/", 1)[-1]])
            else:
                raise ValueError(
                    f"raw-bytes feature {k!r} needs image_spec (no _shape "
                    f"sidecar in this file)"
                )
            return np.frombuffer(raw, np.uint8).reshape(shape)
        arr = np.asarray(v)
        if shape_key in step:
            arr = arr.reshape(tuple(int(x) for x in step[shape_key]))
        return arr

    n = len(steps)
    ep_ids = np.zeros(n, np.int64)
    cur = 0
    for i, s in enumerate(steps):
        if "_ep_id" in s:
            ep_ids[i] = int(np.asarray(s["_ep_id"])[0])
        else:
            if i > 0 and int(np.asarray(s["is_first"])[0]):
                cur += 1
            ep_ids[i] = cur

    def nest(flat: Dict[str, np.ndarray]):
        """observation/a/b keys -> nested dict."""
        out: Dict = {}
        for k, v in flat.items():
            parts = k.split("/")[1:]  # drop 'observation'
            if not parts:
                return v
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v
        return out

    obs_stack = {
        k: np.stack([decode_obs(s, k) for s in steps]) for k in obs_keys
    }
    masks = np.asarray(
        [1.0 - float(np.asarray(s["is_terminal"])[0]) for s in steps],
        np.float32,
    )
    dones = np.asarray(
        [float(np.asarray(s["is_last"])[0]) for s in steps], np.float32
    )
    return {
        "observations": nest(obs_stack),
        "actions": np.stack([np.asarray(s["action"]) for s in steps]),
        "rewards": np.asarray(
            [float(np.asarray(s["reward"])[0]) for s in steps], np.float32
        ),
        "masks": masks,
        "dones": dones,
        "ep_ids": ep_ids.astype(np.int32),
    }


def populate_from_rlds(store, path: str,
                       image_spec: Optional[Dict[str, Tuple[int, ...]]] = None) -> int:
    """Insert every step of the RLDS file at `path` (`import_rlds`) into
    `store` as a transition with next_observations (the next step's
    observation within its episode; the last step's own where the episode
    ends); returns the count."""
    data = import_rlds(path, image_spec)
    ep_ids = data.pop("ep_ids")
    n = len(ep_ids)

    def row(tree, i):
        return {k: row(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

    for i in range(n):
        j = i + 1 if i + 1 < n and ep_ids[i + 1] == ep_ids[i] else i
        tr = {k: row(v, i) for k, v in data.items()}
        tr["next_observations"] = row(data["observations"], j)
        store.insert(tr)
    return n
