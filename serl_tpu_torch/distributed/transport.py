"""TrainerServer / TrainerClient over the native C++ transport.

Port of `serl_tpu/distributed/transport.py`, the agentlace surface that SERL's
two-process mode uses:

  * `TrainerConfig(port_number, broadcast_port, request_types)`
  * `TrainerServer(config, request_callback)`, `.register_data_store(name,
    store)`, `.start(threaded=True)`, `.publish_network(params)`
  * `TrainerClient(name, ip, config, data_store, wait_for_server)`,
    `.recv_network_callback(cb)`, `.update()` (flush queued transitions),
    `.request(type, payload)`
  * `QueuedDataStore(capacity)`

The wire layer is the port's `native/transport.cpp` (TCP, length-prefixed
frames), built with g++ at first use (`native/build.py::build_transport`);
payloads use the numpy codec in `serialization.py`. A push is delivered
only when the server acknowledges it, after its inserts; a push that is not
acknowledged (the learner is down or restarting) is requeued at the front
of the actor's queue. One difference from the JAX package: the client's
poll thread pauses 10 ms after a poll that returned nothing, so a client
whose learner is gone (its re-dial failing at once) does not spin a core.
"""

from __future__ import annotations

import ctypes
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from serl_tpu_torch.distributed import serialization as ser

MSG_REQUEST = 1
MSG_PUSH = 3
_BYTES = ctypes.POINTER(ctypes.c_uint8)


def _load_lib():
    from serl_tpu_torch.native.build import build_transport

    lib = ctypes.CDLL(build_transport())
    lib.ts_server_create.restype = ctypes.c_void_p
    lib.ts_server_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ts_server_recv.restype = ctypes.c_int
    lib.ts_server_recv.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(_BYTES), ctypes.POINTER(ctypes.c_uint32)]
    lib.ts_server_respond.restype = ctypes.c_int
    lib.ts_server_respond.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                                      ctypes.c_char_p, ctypes.c_uint32]
    lib.ts_server_publish.restype = ctypes.c_int
    lib.ts_server_publish.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.ts_server_destroy.argtypes = [ctypes.c_void_p]
    lib.ts_client_create.restype = ctypes.c_void_p
    lib.ts_client_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ts_client_request.restype = ctypes.c_int
    lib.ts_client_request.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                                      ctypes.POINTER(_BYTES), ctypes.POINTER(ctypes.c_uint32)]
    lib.ts_client_push.restype = ctypes.c_int
    lib.ts_client_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.ts_client_poll.restype = ctypes.c_int
    lib.ts_client_poll.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_BYTES),
                                   ctypes.POINTER(ctypes.c_uint32)]
    lib.ts_client_destroy.argtypes = [ctypes.c_void_p]
    lib.ts_free.argtypes = [_BYTES]
    return lib


_LIB = None
_LIB_LOCK = threading.Lock()


def get_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _load_lib()
        return _LIB


def _take(lib, payload, length) -> bytes:
    """The bytes of a buffer the library allocated, which is then freed."""
    data = ctypes.string_at(payload, length.value)
    lib.ts_free(payload)
    return data


@dataclass
class TrainerConfig:
    port_number: int = 5488
    broadcast_port: int = 5489
    request_types: List[str] = field(default_factory=lambda: ["send-stats"])


class QueuedDataStore:
    """Actor-side bounded transition queue (agentlace QueuedDataStore)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._items: List[dict] = []

    def insert(self, transition: dict):
        with self._lock:
            self._items.append(transition)
            if len(self._items) > self.capacity:
                self._items.pop(0)

    def drain(self) -> List[dict]:
        with self._lock:
            items, self._items = self._items, []
        return items

    def requeue(self, items: List[dict]):
        """Put drained items back at the FRONT (a push failed, e.g. the
        learner is restarting); the oldest beyond capacity are dropped."""
        with self._lock:
            self._items = (items + self._items)[-self.capacity:]

    def __len__(self):
        with self._lock:
            return len(self._items)


class TrainerServer:
    """Learner-side endpoint: receives pushed transitions into registered
    data stores, answers RPCs, broadcasts params."""

    def __init__(self, config: TrainerConfig, request_callback: Optional[Callable] = None):
        self._lib = get_lib()
        self._handle = self._lib.ts_server_create(config.port_number, config.broadcast_port)
        if not self._handle:
            raise OSError(f"could not bind ports {config.port_number}/{config.broadcast_port}")
        self.config = config
        self.request_callback = request_callback
        self.data_stores: Dict[str, object] = {}
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def register_data_store(self, name: str, store):
        self.data_stores[name] = store

    def start(self, threaded: bool = True):
        self._running = True
        if threaded:
            self._thread = threading.Thread(target=self._serve, daemon=True)
            self._thread.start()
        else:
            self._serve()

    def _serve(self):
        lib = self._lib
        while self._running:
            kind, conn, tag = ctypes.c_uint8(), ctypes.c_uint64(), ctypes.c_uint64()
            payload, length = _BYTES(), ctypes.c_uint32()
            if not lib.ts_server_recv(self._handle, 100, ctypes.byref(kind), ctypes.byref(conn),
                                      ctypes.byref(tag), ctypes.byref(payload),
                                      ctypes.byref(length)):
                continue
            msg = ser.loads(_take(lib, payload, length))
            if kind.value == MSG_PUSH:
                store = self.data_stores.get(msg["store"])
                if store is not None:
                    for tr in msg["transitions"]:
                        store.insert(tr)
                # ack AFTER the inserts: the client counts a push as
                # delivered only on this round trip (a bare TCP write into a
                # dying connection succeeds locally and loses the data)
                lib.ts_server_respond(self._handle, conn.value, tag.value, b"\x01", 1)
            elif kind.value == MSG_REQUEST:
                resp = {}
                if self.request_callback is not None:
                    resp = self.request_callback(msg.get("type"), msg.get("payload"))
                out = ser.dumps(resp if resp is not None else {})
                lib.ts_server_respond(self._handle, conn.value, tag.value, out, len(out))

    def publish_network(self, params) -> int:
        """Broadcast `params` (a tree of numpy arrays or tensors) to every
        subscribed client; returns how many it reached."""
        data = ser.dumps(params)
        return self._lib.ts_server_publish(self._handle, data, len(data))

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=2)
        if self._handle:
            self._lib.ts_server_destroy(self._handle)
            self._handle = None


class TrainerClient:
    """Actor-side endpoint."""

    def __init__(self, name: str, server_ip: str, config: TrainerConfig,
                 data_store: Optional[QueuedDataStore] = None, wait_for_server: bool = True,
                 timeout_s: float = 30.0):
        self._lib = get_lib()
        self.name = name
        self.data_store = data_store
        deadline = time.time() + (timeout_s if wait_for_server else 0.5)
        while True:
            handle = self._lib.ts_client_create(server_ip.encode(), config.port_number,
                                                config.broadcast_port, 1)
            if handle or time.time() > deadline:
                break
            time.sleep(0.2)
        if not handle:
            raise ConnectionError(f"could not reach {server_ip}:{config.port_number}")
        self._handle = handle
        self._cb: Optional[Callable] = None
        self._cb_thread: Optional[threading.Thread] = None
        self._running = True

    def recv_network_callback(self, cb: Callable):
        """Register a callback, called on the poll thread with each published
        param tree."""
        self._cb = cb
        self._cb_thread = threading.Thread(target=self._poll_loop, daemon=True)
        self._cb_thread.start()

    def _poll_loop(self):
        lib = self._lib
        while self._running:
            payload, length = _BYTES(), ctypes.c_uint32()
            if not lib.ts_client_poll(self._handle, 200, ctypes.byref(payload),
                                      ctypes.byref(length)):
                time.sleep(0.01)
                continue
            data = _take(lib, payload, length)
            try:
                self._cb(ser.loads(data))
            except Exception:  # a callback's error must not kill the poller
                traceback.print_exc()

    def update(self) -> int:
        """Flush queued transitions to the server's registered data store;
        returns how many were delivered. If the push is not acknowledged
        (the learner down or restarting; the C++ layer has re-dialled once),
        the transitions are requeued and retried on the next update(): no
        loss across a learner restart up to the queue's capacity."""
        if self.data_store is None:
            return 0
        items = self.data_store.drain()
        if not items:
            return 0
        data = ser.dumps({"store": self.name, "transitions": items})
        if not self._lib.ts_client_push(self._handle, data, len(data)):
            self.data_store.requeue(items)
            return 0
        return len(items)

    def request(self, req_type: str, payload) -> Optional[dict]:
        data = ser.dumps({"type": req_type, "payload": payload})
        out, length = _BYTES(), ctypes.c_uint32()
        if not self._lib.ts_client_request(self._handle, data, len(data), ctypes.byref(out),
                                           ctypes.byref(length)):
            return None
        return ser.loads(_take(self._lib, out, length))

    def stop(self):
        self._running = False
        if self._cb_thread:
            self._cb_thread.join(timeout=2)
        if self._handle:
            self._lib.ts_client_destroy(self._handle)
            self._handle = None
