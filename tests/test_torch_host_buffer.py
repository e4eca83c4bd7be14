"""The port's host replay ring (`serl_tpu_torch/data/host_buffer.py`)
against serl_tpu's on the same inserts, exactly: the wrap past capacity,
`sample` for equal `np.random.default_rng(seed)`, `download`,
`get_latest_data`, `latest_data_id`, `save`, `populate_data_store` from both
pickle formats (a list, and stacked arrays written by either package's
`save_demos`) and `get_iterator` on the CPU."""

import pickle
import threading

import numpy as np
import pytest
import torch

from serl_tpu.data import demos as jdemos
from serl_tpu.data import host_buffer as jhb
from serl_tpu_torch.data import demos as tdemos
from serl_tpu_torch.data import host_buffer as thb

CAP = 16


def _example(size=8):
    img = np.zeros((1, size, size, 3), np.uint8)
    obs = {"state": np.zeros(7, np.float32), "front": img, "wrist": img}
    return {"observations": obs, "actions": np.zeros(4, np.float32), "next_observations": obs,
            "rewards": np.float32(0), "masks": np.float32(0), "dones": np.float32(0)}


def _transition(rng, size=8):
    def obs():
        return {"state": rng.normal(size=7).astype(np.float32),
                "front": rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8),
                "wrist": rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)}
    return {"observations": obs(), "actions": rng.uniform(-1, 1, 4).astype(np.float32),
            "next_observations": obs(), "rewards": np.float32(rng.uniform()),
            "masks": np.float32(rng.uniform() > 0.1), "dones": np.float32(rng.uniform() > 0.9)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _leaves(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tree}


def assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert list(g) == list(w)
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _filled(n):
    rng = np.random.default_rng(0)
    trs = [_transition(rng) for _ in range(n)]
    port, ref = thb.ReplayBufferDataStore(_example(), CAP), jhb.ReplayBufferDataStore(_example(), CAP)
    for tr in trs:
        port.insert(tr)
        ref.insert(tr)
    return port, ref, trs


@pytest.mark.parametrize("n", [5, CAP, CAP + 7, 3 * CAP + 2])
def test_torch_host_ring_wraps_and_samples_as_jax(n):
    port, ref, trs = _filled(n)
    assert len(port) == len(ref) == min(n, CAP)
    assert port._insert_index == ref._insert_index == n % CAP
    assert_trees_equal(port._storage, ref._storage)
    # the newest CAP transitions sit at their ring slots
    for i, tr in enumerate(trs[-CAP:]):
        slot = (n - min(n, CAP) + i) % CAP
        assert_trees_equal(thb.map_tree(lambda b: b[slot], port._storage), tr)
    for seed in (0, 7):
        got = port.sample(32, np.random.default_rng(seed))
        assert_trees_equal(got, ref.sample(32, np.random.default_rng(seed)))


def test_torch_host_ring_download_latest_data_and_ids_as_jax():
    port, ref, _ = _filled(CAP - 3)
    for from_idx in (0, 4):
        (pi, pd), (ri, rd) = port.download(from_idx), ref.download(from_idx)
        assert pi == ri
        assert_trees_equal(pd, rd)
    assert port.latest_data_id() == ref.latest_data_id() == CAP - 3
    for from_id in (0, 5, CAP - 3):
        (ps, pd), (rs, rd) = port.get_latest_data(from_id), ref.get_latest_data(from_id)
        assert ps == rs
        assert_trees_equal(pd, rd)


def test_torch_host_ring_save_loads_to_jax_tree(tmp_path):
    port, ref, _ = _filled(CAP + 5)
    port.save(tmp_path / "port.pkl")
    ref.save(tmp_path / "ref.pkl")
    with open(tmp_path / "port.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    assert got["size"] == want["size"] == CAP
    assert_trees_equal(got["storage"], want["storage"])


def test_torch_data_store_logger_hook_and_lock():
    logged = []

    class Logger:
        def log_transition(self, tr):
            logged.append(tr)

    store = thb.ReplayBufferDataStore(_example(), CAP, rlds_logger=Logger())
    rng = np.random.default_rng(3)
    trs = [_transition(rng) for _ in range(40)]
    threads = [threading.Thread(target=lambda part: [store.insert(t) for t in part], args=(p,))
               for p in (trs[:20], trs[20:])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert store.latest_data_id() == 40 and len(store) == CAP and len(logged) == 40


def _stacked(trs):
    return {k: (_stacked([t[k] for t in trs]) if isinstance(trs[0][k], dict)
                else np.stack([t[k] for t in trs])) for k in trs[0]}


@pytest.mark.parametrize("source", ["list", "port save_demos", "jax save_demos"])
def test_torch_populate_data_store_reads_both_formats(tmp_path, source):
    rng = np.random.default_rng(5)
    trs = [_transition(rng) for _ in range(CAP + 3)]
    path = tmp_path / "demos.pkl"
    if source == "list":
        with open(path, "wb") as f:
            pickle.dump(trs, f)
    else:
        stacked = {**_stacked(trs), "ep_ids": np.zeros(len(trs), np.int32),
                   "success": np.ones(len(trs), np.float32)}
        if source == "port save_demos":
            tdemos.save_demos({k: thb.map_tree(torch.from_numpy, v) if isinstance(v, dict)
                               else torch.from_numpy(v) for k, v in stacked.items()}, str(path))
        else:
            jdemos.save_demos(stacked, str(path))
    port, ref = thb.ReplayBufferDataStore(_example(), CAP), jhb.ReplayBufferDataStore(_example(), CAP)
    assert thb.populate_data_store(port, str(path)) == jhb.populate_data_store(ref, str(path))
    assert len(port) == len(ref) == CAP and port.latest_data_id() == len(trs)
    assert_trees_equal(port._storage, ref._storage)


def test_torch_get_iterator_on_cpu_yields_the_numpy_samples():
    port, _, _ = _filled(CAP + 2)
    it = port.get_iterator(24, "cpu", prefetch=2, rng=np.random.default_rng(11))
    want_rng = np.random.default_rng(11)
    for _ in range(4):
        got, want = next(it), port.sample(24, want_rng)
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in _leaves(got).values())
        assert_trees_equal(thb.map_tree(lambda t: t.numpy(), got), want)
    to_cpu = thb.HostToDevice("cpu")
    batch = port.sample(4, np.random.default_rng(0))
    assert_trees_equal(thb.map_tree(lambda t: t.numpy(), to_cpu(batch)), batch)
