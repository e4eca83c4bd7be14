"""The JAX package's last public names and their counterparts in the port,
on the CPU, on the same numpy inputs.

  * `Normal.stddev`, `Normal.entropy`, `TanhNormal.stddev` (the bijector's
    forward of the base std, with and without bounds): DIST_ATOL.
  * `quat_rotate`: ROTATE_ATOL, and it keeps a vector's length.
  * `random_crop` on one (H, W, C) image with JAX's window offset: exact.
  * `Dataset.sample` with indices (exact), and its uniform draw: the rows at
    the indices it drew.
  * `RoutedReplayBuffer.total_rows` after masked inserts: exact.
  * `torch_profile` (the counterpart of `jax_profile`): both traces land in
    their logdir, and the block's result is the one it computes unprofiled;
    the port's trace.json holds the program's spans of the block on the
    timeline of its operations.
  * The aliases and constants: `WandBLogger` (the Logger, writing JAX's
    lines), `small_configs`, `CONTROL_DT`, `BCConfig`.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.agents import bc as jbc
from serl_tpu.common import distributions as jdist
from serl_tpu.common import logger as jlogger
from serl_tpu.data.dataset import Dataset as JaxDataset
from serl_tpu.data.routed_buffer import RoutedReplayBuffer as JaxRouted
from serl_tpu.envs.physics import engine as jengine
from serl_tpu.envs.physics import math3d as jmath3d
from serl_tpu.utils.timer import jax_profile
from serl_tpu.vision import augmentations as jaug
from serl_tpu.vision import encoders as jencoders
from serl_tpu_torch.agents import bc
from serl_tpu_torch.common import distributions as dist
from serl_tpu_torch.common import logger
from serl_tpu_torch.data.dataset import Dataset
from serl_tpu_torch.data.routed_buffer import RoutedReplayBuffer
from serl_tpu_torch.envs.physics import engine, math3d
from serl_tpu_torch.utils.timer import span, torch_profile
from serl_tpu_torch.vision import augmentations, encoders

DIST_ATOL = 1e-6
ROTATE_ATOL = 1e-6
PAD = 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed=0, shape=(5, 4)):
    g = np.random.default_rng(seed)
    loc = g.normal(size=shape).astype(np.float32)
    scale = np.exp(g.normal(size=shape)).astype(np.float32)
    return loc, scale


def test_torch_normal_stddev_and_entropy_match_jax():
    loc, scale = _inputs()
    for s in (scale, scale[0]):  # a per-row scale, and one broadcast over the rows
        want, got = jdist.Normal(jnp.asarray(loc), jnp.asarray(s)), dist.Normal(_t(loc), _t(s))
        assert got.stddev().shape == loc.shape and got.entropy().shape == loc.shape[:1]
        np.testing.assert_allclose(got.stddev().numpy(), np.asarray(want.stddev()),
                                   atol=DIST_ATOL, rtol=0)
        np.testing.assert_allclose(got.entropy().numpy(), np.asarray(want.entropy()),
                                   atol=DIST_ATOL, rtol=0)


@pytest.mark.parametrize("bounded", [False, True])
def test_torch_tanh_normal_stddev_matches_jax(bounded):
    loc, scale = _inputs(1)
    low, high = (np.full(4, -2.0, np.float32), np.full(4, 0.5, np.float32)) if bounded else \
        (None, None)
    want = jdist.TanhNormal(jnp.asarray(loc), jnp.asarray(scale),
                            None if low is None else jnp.asarray(low),
                            None if high is None else jnp.asarray(high))
    got = dist.TanhNormal(_t(loc), _t(scale), None if low is None else _t(low),
                          None if high is None else _t(high))
    np.testing.assert_allclose(got.stddev().numpy(), np.asarray(want.stddev()), atol=DIST_ATOL,
                               rtol=0)
    # the bijector's forward of the base std, not the squashed variable's std
    torch.testing.assert_close(got.stddev(), got._forward(_t(scale)), atol=0, rtol=0)


def test_torch_quat_rotate_matches_jax():
    g = np.random.default_rng(2)
    q = g.normal(size=(7, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = g.normal(size=(7, 3)).astype(np.float32)
    got = math3d.quat_rotate(_t(q), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmath3d.quat_rotate(q, v)),
                               atol=ROTATE_ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1),
                               np.linalg.norm(v, axis=-1), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_torch_random_crop_matches_jax(dtype):
    img = np.random.default_rng(3).integers(0, 256, (12, 10, 3)).astype(dtype)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jaug.random_crop(jnp.asarray(img), key, padding=PAD))
    offsets = _t(jax.random.randint(key, (1, 2), 0, 2 * PAD + 1)).long()
    for off in (offsets, offsets[0]):  # (1, 2) and (2,)
        got = augmentations.random_crop(_t(img), off, padding=PAD)
        np.testing.assert_array_equal(got.numpy(), want)


def _data(n=9):
    g = np.random.default_rng(5)
    return {"observations": g.normal(size=(n, 3)).astype(np.float32),
            "nested": {"x": g.normal(size=(n, 2)).astype(np.float32)},
            "rewards": g.normal(size=(n,)).astype(np.float32)}


def test_torch_dataset_sample_matches_jax():
    data = _data()
    jds, ds = JaxDataset(data), Dataset(data, device="cpu")
    indx = np.array([4, 0, 8, 4])
    want = jax.tree.map(np.asarray, jds.sample(4, indx=indx))
    got = ds.sample(4, indx=indx)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(b.numpy(), a), want, got)
    # without indices: JAX draws from its key, the port from the generator;
    # either gives the rows at the indices it drew
    key = jax.random.PRNGKey(6)
    drawn = np.asarray(jax.random.randint(key, (5,), 0, 9))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(b.numpy(), a),
                 jax.tree.map(np.asarray, jds.sample(5, rng=key)), ds.sample(5, indx=drawn))
    g = torch.Generator().manual_seed(7)
    idx = torch.randint(0, 9, (6,), generator=torch.Generator().manual_seed(7))
    got = ds.sample(6, generator=g)
    torch.testing.assert_close(got["rewards"], ds.data["rewards"][idx], atol=0, rtol=0)
    assert got["nested"]["x"].shape == (6, 2)


def test_torch_routed_total_rows_matches_jax():
    slots, streams = 3, 4
    ex = {"observations": np.zeros((2,), np.float32), "actions": np.zeros((1,), np.float32),
          "next_observations": np.zeros((2,), np.float32), "rewards": np.zeros((), np.float32),
          "masks": np.zeros((), np.float32), "dones": np.zeros((), np.float32)}
    jrb = JaxRouted(jax.tree.map(jnp.asarray, ex), capacity=slots * streams)
    trb = RoutedReplayBuffer(jax.tree.map(torch.from_numpy, ex), capacity=slots * streams,
                             device="cpu")
    js, ts = jrb.init_state(streams), trb.init_state(streams)
    assert int(trb.total_rows(ts)) == int(jrb.total_rows(js)) == 0
    g = np.random.default_rng(8)
    for mask in ([1, 0, 1, 1], [1, 0, 0, 1], [1, 1, 0, 1], [1, 0, 0, 1], [1, 0, 1, 0]):
        mask = np.asarray(mask, bool)
        tr = {k: g.normal(size=(streams,) + v.shape).astype(np.float32) for k, v in ex.items()}
        ep = np.arange(streams, dtype=np.int32)
        js = jrb.insert(js, jax.tree.map(jnp.asarray, tr), jnp.asarray(ep), mask=jnp.asarray(mask))
        ts = trb.insert(ts, jax.tree.map(torch.from_numpy, tr), torch.from_numpy(ep),
                        mask=torch.from_numpy(mask))
        got = trb.total_rows(ts)
        assert got.shape == () and int(got) == int(jrb.total_rows(js))
    assert int(got) == 3 + 1 + 2 + 3  # the first stream wrapped at 3 slots


def test_torch_profile_writes_a_trace_as_jax_profile_does(tmp_path):
    x = np.random.default_rng(9).normal(size=(16, 16)).astype(np.float32)
    with jax_profile(str(tmp_path / "jax")):
        want = np.asarray((jnp.asarray(x) @ jnp.asarray(x)).block_until_ready())
    with span("test.before"):
        pass
    with torch_profile(str(tmp_path / "torch")) as prof:
        with span("test.mm"):
            got = _t(x) @ _t(x)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    assert list((tmp_path / "jax").rglob("*.xplane.pb"))
    with open(tmp_path / "torch" / "trace.json") as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "program_span"]
    (mm,) = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    assert [e["name"] for e in spans] == ["test.mm"]
    assert spans[0]["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= spans[0]["ts"] + spans[0]["dur"]


def test_torch_aliases_and_constants_match_jax(tmp_path):
    assert logger.WandBLogger is logger.Logger and jlogger.WandBLogger is jlogger.Logger
    record = {"a": 1.5, "b": {"c": np.arange(3)}, "d": np.float32(2.0)}
    lines = []
    for cls, out in ((jlogger.WandBLogger, tmp_path / "jax"), (logger.WandBLogger,
                                                              tmp_path / "torch")):
        log = cls(description="names", output_dir=str(out), variant={"x": 1})
        log.log(record, step=3)
        log.close()
        (path,) = out.glob("*.jsonl")
        lines.append(path.read_text().splitlines())
    assert lines[0] == lines[1] and len(lines[0]) == 2
    assert sorted(encoders.small_configs) == sorted(jencoders.small_configs) == ["small"]
    assert encoders.small_configs["small"] is encoders.SmallEncoder
    assert math.isclose(engine.CONTROL_DT, jengine.CONTROL_DT) and engine.CONTROL_DT == \
        engine.DT * engine.N_SUBSTEPS
    assert bc.BCConfig().image_keys == jbc.BCConfig().image_keys == ()
    assert bc.BCConfig(("front",)).image_keys == jbc.BCConfig(image_keys=("front",)).image_keys
