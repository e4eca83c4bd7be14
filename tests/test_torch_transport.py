"""The port's transport (`serl_tpu_torch/distributed/transport.py` over its
own g++ build of `native/transport.cpp`): the cases of tests/test_transport.py
on the port's classes (push into the registered store, RPC, param
broadcast, the actor's queue, connect timeout, a client's disconnect and
mid-stream death, the actor surviving a learner restart), and a small torch
agent's published params reaching a client whose agent then acts bit for
bit as the learner's."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from serl_tpu_torch.distributed.transport import (
    QueuedDataStore,
    TrainerClient,
    TrainerConfig,
    TrainerServer,
    get_lib,
)
from serl_tpu_torch.native import build
from serl_tpu_torch.training.launcher import make_sac_agent
from serl_tpu_torch.utils.jax_params import load_sac_params, to_jax_layout
from tests.torch_ports import next_port_pair, retry_bind


class ListStore:
    def __init__(self):
        self.items = []
        self.lock = threading.Lock()

    def insert(self, tr):
        with self.lock:
            self.items.append(tr)

    def __len__(self):
        with self.lock:
            return len(self.items)


def _make_server(cb):
    def factory(port):
        cfg = TrainerConfig(port_number=port, broadcast_port=port + 1)
        return TrainerServer(cfg, request_callback=cb), cfg
    (server, cfg), _ = retry_bind(factory)
    return server, cfg


def _client(cfg, name="actor_env", capacity=100):
    return TrainerClient(name, "127.0.0.1", cfg, data_store=QueuedDataStore(capacity),
                         wait_for_server=True, timeout_s=10.0)


@pytest.fixture()
def pair():
    server, cfg = _make_server(lambda t, p: {"echo": t, "got": p})
    store = ListStore()
    server.register_data_store("actor_env", store)
    server.start(threaded=True)
    client = _client(cfg)
    yield server, client, store
    client.stop()
    server.stop()


def _wait(pred, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_torch_transport_builds_its_own_library():
    path = build.build_transport()
    assert os.path.dirname(path) == build.BUILD_DIR and "libserl_transport-" in path
    assert os.path.realpath(get_lib()._name) == os.path.realpath(path)
    assert "serl_tpu/native" not in path


def test_torch_push_inserts_into_registered_store(pair):
    server, client, store = pair
    tr = {"observations": np.arange(10, dtype=np.float32), "actions": np.zeros(4, np.float32),
          "rewards": np.float32(1.5), "masks": np.float32(1.0), "dones": np.float32(0.0)}
    for _ in range(7):
        client.data_store.insert(tr)
    assert client.update() == 7
    assert _wait(lambda: len(store) == 7), "server did not insert pushed transitions"
    got = store.items[0]
    np.testing.assert_array_equal(got["observations"], tr["observations"])
    assert float(got["rewards"]) == 1.5 and type(got["rewards"]) is np.float32
    assert len(client.data_store) == 0 and client.update() == 0


def test_torch_rpc_roundtrip(pair):
    server, client, store = pair
    resp = client.request("send-stats", {"eval": {"success": 0.5}})
    assert resp["echo"] == "send-stats"
    assert float(resp["got"]["eval"]["success"]) == 0.5


def test_torch_param_broadcast(pair):
    server, client, store = pair
    received, evt = [], threading.Event()
    client.recv_network_callback(lambda p: (received.append(p), evt.set()))
    time.sleep(0.3)  # let the poll thread attach
    params = {"actor": {"kernel": np.random.randn(8, 4).astype(np.float32)}, "step": np.int32(3)}
    assert server.publish_network(params) == 1
    assert evt.wait(5.0), "client never received the published params"
    np.testing.assert_array_equal(received[-1]["actor"]["kernel"], params["actor"]["kernel"])
    assert int(received[-1]["step"]) == 3


@pytest.mark.parametrize("case", ["capacity", "requeue"])
def test_torch_queued_data_store(case):
    q = QueuedDataStore(3)
    for i in range(5):
        q.insert({"i": i})
    assert len(q) == 3
    if case == "capacity":
        assert [it["i"] for it in q.drain()] == [2, 3, 4]  # the oldest dropped
    else:
        drained = q.drain()
        q.insert({"i": 5})
        q.requeue(drained)  # back at the front; the oldest beyond capacity dropped
        assert [it["i"] for it in q.drain()] == [3, 4, 5]


def test_torch_client_connect_timeout():
    port = next_port_pair()
    cfg = TrainerConfig(port_number=port, broadcast_port=port + 1)
    with pytest.raises(ConnectionError):
        TrainerClient("x", "127.0.0.1", cfg, wait_for_server=False, timeout_s=0.3)


@pytest.mark.parametrize("death", ["disconnect", "midstream"])
def test_torch_server_survives_client_death(death):
    """A client that stops, or whose sockets close mid-stream with no
    goodbye, leaves the server working for the other clients."""
    server, cfg = _make_server(lambda t, p: {"ok": 1})
    store = ListStore()
    server.register_data_store("a", store)
    server.start(threaded=True)
    try:
        c1, c2 = _client(cfg, "a", 50), _client(cfg, "a", 50)
        for i in range(5):
            c1.data_store.insert({"i": np.float32(i)})
        assert c1.update() == 5
        assert _wait(lambda: len(store) == 5)
        if death == "disconnect":
            c1.stop()
        else:
            c1._lib.ts_client_destroy(c1._handle)
            c1._handle, c1._running = None, False
        time.sleep(0.2)
        c2.data_store.insert({"i": np.float32(99)})
        assert c2.update() == 1
        assert _wait(lambda: len(store) == 6)
        assert c2.request("t", {}) == {"ok": 1}
        c3 = _client(cfg, "a", 10)  # a new client connects and works
        assert c3.request("t", {}) == {"ok": 1}
        c3.stop()
        c2.stop()
    finally:
        server.stop()


def test_torch_actor_survives_learner_restart():
    """The learner dies mid-stream: the actor's pushes are requeued, and once
    a new server binds the same ports the client re-dials and delivers them
    all; RPC and the param broadcast reach the new server's side too."""
    server, cfg = _make_server(lambda t, p: {"gen": 1})
    store1 = ListStore()
    server.register_data_store("a", store1)
    server.start(threaded=True)
    client = _client(cfg, "a")
    received, evt = [], threading.Event()
    client.recv_network_callback(lambda p: (received.append(p), evt.set()))
    time.sleep(0.3)
    client.data_store.insert({"i": np.float32(0)})
    assert client.update() == 1
    assert _wait(lambda: len(store1) == 1)

    server.stop()  # the learner dies
    time.sleep(0.2)
    for i in range(1, 4):
        client.data_store.insert({"i": np.float32(i)})
    assert client.update() == 0  # not delivered: requeued
    assert len(client.data_store) == 3

    server2 = TrainerServer(cfg, request_callback=lambda t, p: {"gen": 2})
    store2 = ListStore()
    server2.register_data_store("a", store2)
    server2.start(threaded=True)
    try:
        assert _wait(lambda: client.update() == 3, timeout=10.0), \
            "client did not reconnect and flush after the learner restarted"
        assert _wait(lambda: len(store2) == 3)
        assert sorted(float(t["i"]) for t in store2.items) == [1.0, 2.0, 3.0]
        assert _wait(lambda: (client.request("t", {}) or {}).get("gen") == 2, timeout=10.0)
        assert _wait(lambda: server2.publish_network({"w": np.float32(7)}) >= 1, timeout=10.0)
        assert evt.wait(10.0) and float(received[-1]["w"]) == 7.0
    finally:
        client.stop()
        server2.stop()


def test_torch_published_agent_acts_as_the_learners():
    """A torch agent's to_jax_layout tree is published; the client's agent,
    from another seed, loads it with load_sac_params and samples the same
    actions bit for bit, with the same noise."""
    torch.set_num_threads(1)
    learner = make_sac_agent(0, device="cpu")
    with torch.no_grad():  # params away from init, so a load really moves them
        for p in learner.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))
    actor = make_sac_agent(1, device="cpu")
    server, cfg = _make_server(None)
    server.start(threaded=True)
    client = _client(cfg)
    try:
        received, evt = [], threading.Event()
        client.recv_network_callback(lambda p: (received.append(p), evt.set()))
        time.sleep(0.3)
        assert server.publish_network(to_jax_layout(learner)) == 1
        assert evt.wait(5.0)
    finally:
        client.stop()
        server.stop()
    obs = torch.randn(5, 10, generator=torch.Generator().manual_seed(4))
    noise = torch.randn(5, 4, generator=torch.Generator().manual_seed(5))
    assert not torch.equal(actor.sample_actions(obs, noise=noise),
                           learner.sample_actions(obs, noise=noise))
    load_sac_params(actor, received[-1])
    assert torch.equal(actor.sample_actions(obs, noise=noise),
                       learner.sample_actions(obs, noise=noise))
    assert torch.equal(actor.sample_actions(obs, argmax=True),
                       learner.sample_actions(obs, argmax=True))
