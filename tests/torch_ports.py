"""Port pairs for the port's transport tests.

`tests/_ports.py` keeps one counter per xdist worker, so two workers can
hand out the same pair. The port's tests take pairs from a range of their
own, 20000-23199 (below `_ports.py`'s 23500+ and below the Linux ephemeral
range), split by `PYTEST_XDIST_WORKER` into 400 ports a worker, and check
that both ports bind before handing them out.
"""

import itertools
import os
import socket

BASE, PER_WORKER = 20000, 400
_worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
_start = BASE + PER_WORKER * (int(_worker[2:]) % 8 if _worker[2:].isdigit() else 0)
_counter = itertools.count()


def _bindable(port: int) -> bool:
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
            return True
        except OSError:
            return False


def next_port_pair() -> int:
    """p such that p and p + 1 bind now and no other call of this worker
    returned them."""
    for _ in range(PER_WORKER // 2):
        port = _start + 2 * (next(_counter) % (PER_WORKER // 2))
        if _bindable(port) and _bindable(port + 1):
            return port
    raise RuntimeError("no free port pair")


def retry_bind(factory, tries: int = 10):
    """`factory(port)` (which binds port and port + 1) on fresh pairs until
    one binds; returns (its result, port)."""
    last = None
    for _ in range(tries):
        port = next_port_pair()
        try:
            return factory(port), port
        except OSError as exc:
            last = exc
    raise last
