"""RLDS TFRecords, trajectory logs and the static dataset's methods against
serl_tpu's, on the CPU.

- The TFRecord layer: masked CRC32C equal on random bytes; `export_rlds`
  of the same transitions (a pixel observation dict, uint8 frames, episodes
  of different lengths) writes the same bytes in both packages (and from
  tensors); each package's `import_rlds` reads the other's file to the same
  arrays; the reader's CRC check passes on both files and fails on a
  flipped byte; a file without `_shape` sidecars needs `image_spec`.
- Trajectory logs: both packages' `TrajectoryLogger`s, fed the same
  transitions at a frozen clock, write the same directory byte for byte
  (the manifest and every npz shard); each package loads the other's
  episodes exactly; `populate_from_trajectory_log` inserts the same rows.
- The host ring's `rlds_logger` hook: a `ReplayBufferDataStore` with a
  `TrajectoryLogger` logs what it inserts; `populate_from_rlds` preloads a
  store from an exported file.
- `Dataset.split` (the same permutation), `filter` (top percentile and
  threshold) and `normalize_returns`: exactly JAX's.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.data import rlds as jrlds
from serl_tpu.data import trajectory_log as jtlog
from serl_tpu.data.dataset import Dataset as JaxDataset
from serl_tpu_torch.data import rlds, trajectory_log
from serl_tpu_torch.data.dataset import Dataset
from serl_tpu_torch.data.host_buffer import ReplayBufferDataStore


def _transitions(n=9, seed=0):
    rng = np.random.default_rng(seed)
    tr = {"observations": {"state": rng.normal(size=(n, 7)).astype(np.float32),
                           "front": rng.integers(0, 256, (n, 4, 5, 3)).astype(np.uint8)},
          "actions": rng.uniform(-1, 1, (n, 4)).astype(np.float32),
          "rewards": rng.normal(size=(n,)).astype(np.float32),
          "masks": np.ones((n,), np.float32), "dones": np.zeros((n,), np.float32)}
    ep_ids = np.array([0, 0, 0, 1, 1, 4, 4, 4, 4], np.int64)[:n]
    for i in range(n):  # the last step of each episode; the first ends by termination
        if i == n - 1 or ep_ids[i + 1] != ep_ids[i]:
            tr["dones"][i] = 1.0
            tr["masks"][i] = 0.0 if ep_ids[i] == 0 else 1.0
    return tr, ep_ids


def _tree(fn, t):
    """fn over the leaves, the dicts' key order kept (jax.tree.map sorts)."""
    return {k: _tree(fn, v) for k, v in t.items()} if isinstance(t, dict) else fn(t)


def _equal(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}/{k}")
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)
    assert np.asarray(got).dtype == np.asarray(want).dtype, what


def test_torch_crc32c_matches_jax():
    rng = np.random.default_rng(1)
    for n in (0, 1, 7, 100, 4097):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert rlds._crc32c(data) == jrlds._crc32c(data)
        assert rlds._masked_crc(data) == jrlds._masked_crc(data)
    assert rlds._crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_torch_rlds_files_are_jax_byte_for_byte(tmp_path):
    tr, ep_ids = _transitions()
    ours, theirs = str(tmp_path / "ours.tfrecord"), str(tmp_path / "theirs.tfrecord")
    assert rlds.export_rlds(ours, tr, ep_ids) == jrlds.export_rlds(theirs, tr, ep_ids) == 9
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    tensors = str(tmp_path / "tensors.tfrecord")
    rlds.export_rlds(tensors, _tree(torch.from_numpy, tr), torch.from_numpy(ep_ids))
    with open(tensors, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    _equal(rlds.import_rlds(theirs), jrlds.import_rlds(ours), "import")
    got = rlds.import_rlds(ours)
    _equal(got["observations"], tr["observations"])
    np.testing.assert_array_equal(got["dones"], tr["dones"])
    np.testing.assert_array_equal(got["ep_ids"], ep_ids.astype(np.int32))
    for path in (ours, theirs):
        assert len(list(rlds.read_tfrecord(path, verify_crc=True))) == 9
    data = bytearray(open(ours, "rb").read())
    data[30] ^= 0xFF
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        list(rlds.read_tfrecord(bad, verify_crc=True))


def test_torch_rlds_external_writers_need_an_image_spec(tmp_path):
    steps = [{"observation/front": np.full((2, 3, 3), i, np.uint8).tobytes(),
              "observation/state": np.float32([i, -i]), "action": np.float32([0.5]),
              "reward": np.float32([i]), "is_first": np.asarray([int(i == 0)]),
              "is_last": np.asarray([int(i == 2)]), "is_terminal": np.asarray([0])}
             for i in range(3)]
    path = str(tmp_path / "external.tfrecord")
    rlds.write_tfrecord(path, [rlds.encode_example(s) for s in steps])
    with pytest.raises(ValueError, match="image_spec"):
        rlds.import_rlds(path)
    got = rlds.import_rlds(path, image_spec={"front": (2, 3, 3)})
    _equal(got, jrlds.import_rlds(path, image_spec={"front": (2, 3, 3)}))
    assert got["observations"]["front"].shape == (3, 2, 3, 3)


def _log(logger_cls, directory, transitions, n):
    """Each row as the store hands it over: its keys in insertion order (the
    JAX logger's tree map sorts them; the port's must, too)."""
    logger = logger_cls(directory, max_episodes_per_file=2)
    for i in range(n):
        logger.log_transition(_tree(lambda x: x[i], transitions))
    logger.close()


def test_torch_trajectory_logs_are_jax_byte_for_byte(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    tr, ep_ids = _transitions()
    tr = {**tr, "next_observations": tr["observations"]}
    assert list(tr) != sorted(tr)
    _log(trajectory_log.TrajectoryLogger, str(tmp_path / "ours"), tr, 8)  # the last episode open
    _log(jtlog.TrajectoryLogger, str(tmp_path / "theirs"), tr, 8)
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "theirs")) == [
        "manifest.json", "shard_00000.npz", "shard_00001.npz"]
    for name in names:
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes()
    got = trajectory_log.load_trajectory_dataset(str(tmp_path / "theirs"))
    want = jtlog.load_trajectory_dataset(str(tmp_path / "ours"))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _equal(a, b)
    assert got[-1]["step_type"].tolist()[-1] == int(trajectory_log.StepType.TRUNCATION)

    class Store(list):
        def insert(self, x):
            self.append(x)

    ours, theirs = Store(), Store()
    assert trajectory_log.populate_from_trajectory_log(ours, str(tmp_path / "theirs")) == 8
    assert jtlog.populate_from_trajectory_log(theirs, str(tmp_path / "ours")) == 8
    for a, b in zip(ours, theirs):
        _equal(a, jax.device_get(b))


def _example():
    return {"observations": np.zeros(7, np.float32), "actions": np.zeros(4, np.float32),
            "next_observations": np.zeros(7, np.float32), "rewards": np.float32(0),
            "masks": np.float32(0), "dones": np.float32(0)}


def test_torch_host_ring_hook_logs_and_preloads(tmp_path):
    rng = np.random.default_rng(3)
    logger = trajectory_log.TrajectoryLogger(str(tmp_path / "log"), max_episodes_per_file=1)
    store = ReplayBufferDataStore(_example(), 32, rlds_logger=logger)
    rows = []
    for i in range(6):
        tr = {k: (rng.normal(size=np.shape(v)).astype(np.float32) if np.ndim(v)
                  else np.float32(rng.normal())) for k, v in _example().items()}
        tr["dones"] = np.float32(i in (2, 5))
        store.insert(tr)
        rows.append(tr)
    logger.close()
    episodes = trajectory_log.load_trajectory_dataset(str(tmp_path / "log"))
    assert [len(e["rewards"]) for e in episodes] == [3, 3]
    np.testing.assert_array_equal(np.concatenate([e["actions"] for e in episodes]),
                                  np.stack([r["actions"] for r in rows]))
    # an exported RLDS file preloads a store, next_observations from the episode
    tr = {k: np.stack([r[k] for r in rows]) for k in ("observations", "actions", "rewards",
                                                      "masks")}
    ep_ids = np.array([0, 0, 0, 1, 1, 1])
    path = str(tmp_path / "steps.tfrecord")
    rlds.export_rlds(path, tr, ep_ids)
    fresh = ReplayBufferDataStore(_example(), 32)
    assert rlds.populate_from_rlds(fresh, path) == 6 and len(fresh) == 6
    batch = fresh.sample(64, np.random.default_rng(0))
    assert batch["observations"].shape == (64, 7)
    stored = fresh._storage
    np.testing.assert_array_equal(stored["next_observations"][:2], tr["observations"][1:3])
    np.testing.assert_array_equal(stored["next_observations"][2], tr["observations"][2])


def _dataset_data(seed=0):
    rng = np.random.default_rng(seed)
    n = 14
    dones = np.zeros(n, np.float32)
    dones[[2, 5, 9, 13]] = 1.0
    return {"observations": {"state": rng.normal(size=(n, 3)).astype(np.float32)},
            "actions": rng.normal(size=(n, 2)).astype(np.float32),
            "rewards": rng.normal(size=n).astype(np.float32), "dones": dones}


def test_torch_dataset_split_filter_normalize_match_jax():
    data = _dataset_data()
    np.random.seed(7)
    ja, jb = JaxDataset(data).split(0.6)
    np.random.seed(7)
    perm = np.random.permutation(14)
    ta, tb = Dataset(data, device="cpu").split(0.6, permutation=perm)
    for t, j in ((ta, ja), (tb, jb)):
        assert t.size == j.size
        _equal(jax.tree.map(lambda x: x.numpy(), t.data), jax.device_get(j.data))
    np.random.seed(7)
    tc, _ = Dataset(data, device="cpu").split(0.6)
    _equal(jax.tree.map(lambda x: x.numpy(), tc.data), jax.device_get(ja.data))
    # take_top 100: the threshold is the lowest return itself, kept (>=)
    for kw in ({"take_top": 50.0}, {"threshold": 0.0}, {"take_top": 10.0}, {"take_top": 100.0}):
        t, j = Dataset(data, device="cpu").filter(**kw), JaxDataset(data).filter(**kw)
        assert t.size == j.size and t.size > 0, kw
        _equal(jax.tree.map(lambda x: x.numpy(), t.data), jax.device_get(j.data), str(kw))
    assert Dataset(data, device="cpu").filter(take_top=100.0).size == 14
    t = Dataset(data, device="cpu").normalize_returns(10.0)
    j = JaxDataset(data).normalize_returns(10.0)
    np.testing.assert_array_equal(t.data["rewards"].numpy(), np.asarray(j.data["rewards"]))
    with pytest.raises(ValueError):
        Dataset(data, device="cpu").filter()


def test_torch_dataset_needs_cuda_unless_told(monkeypatch):
    """Dataset(data) without a device once landed on the CPU silently; an
    entry point runs on CUDA unless asked, and a CUDA request without CUDA
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Dataset(_dataset_data())
    assert Dataset(_dataset_data(), device="cpu").device == torch.device("cpu")
