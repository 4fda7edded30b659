"""The port's chaos proxy (``selftest/wire_chaos.py``) and the wire,
watchdog and hedging drills against a server process on CPU ranks: one
short cell per wire fault, each followed by the recovery checks."""

from __future__ import annotations

import socket
import sys
import threading

import pytest
import torch

from mpitest_tpu_torch.faults import parse_wire_faults
from mpitest_tpu_torch.selftest import drills
from mpitest_tpu_torch.selftest.wire_chaos import ChaosProxy

CPU_DRIVER = (sys.executable, "-c",
              "import sys, torch; torch.set_num_threads(1); "
              "from mpitest_tpu_torch import sort_server; "
              "sys.exit(sort_server.main(['s'], device='cpu'))")
SIZES = {"solo": 1 << 17, "mix_requests": 40, "clients": 4, "big": 1 << 16,
         "spill": 1 << 15, "spill_bytes": 1 << 16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def echo_upstream():
    """A one-line echo server: replies to each request line with it."""
    srv = socket.create_server(("127.0.0.1", 0))
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            try:
                c, _ = srv.accept()
            except OSError:
                return
            with c:
                data = b""
                while not data.endswith(b"\n"):
                    chunk = c.recv(1024)
                    if not chunk:
                        break
                    data += chunk
                try:
                    c.sendall(data)
                except OSError:
                    pass

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    yield srv.getsockname()[1]
    stop.set()
    srv.close()


def _roundtrip(port: int, payload: bytes, timeout: float = 1.0) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(payload)
        out = b""
        try:
            while True:
                chunk = s.recv(1024)
                if not chunk:
                    break
                out += chunk
        except OSError:
            pass
        return out


def test_proxy_applies_faults_on_their_connections(echo_upstream):
    """``:every`` picks the connections; the others relay cleanly; the
    log records each decision."""
    with ChaosProxy("127.0.0.1", echo_upstream, "wire_disconnect_response@3:2") as px:
        got = [_roundtrip(px.port, b"hello world\n") for _ in range(4)]
    assert got == [b"hello world\n", b"hel", b"hello world\n", b"hel"]
    assert px.log == [(0, None), (1, "wire_disconnect_response"), (2, None),
                      (3, "wire_disconnect_response")]
    assert px.faults == parse_wire_faults("wire_disconnect_response@3:2")


def test_proxy_torn_header_forwards_k_bytes(echo_upstream):
    with ChaosProxy("127.0.0.1", echo_upstream, "wire_torn_header@4") as px:
        assert _roundtrip(px.port, b"abcdefgh\n") == b""
    assert px.log == [(0, "wire_torn_header")]


def test_proxy_refuses_an_unknown_site():
    with pytest.raises(ValueError, match="wire_"):
        ChaosProxy("127.0.0.1", 1, "wire_nonsense@1")


def test_wire_leg(tmp_path):
    t = drills.wire_leg(tmp_path, SIZES, print, card=False, cmd=CPU_DRIVER)
    assert t["timeouts"] >= 2 and t["p99_ms"] >= t["p50_ms"] > 0


def test_watchdog_leg(tmp_path):
    t = drills.watchdog_leg(tmp_path, SIZES, print, card=False, cmd=CPU_DRIVER)
    assert 0 < t["trip_s"] < t["recover_s"]


def test_hedging_leg(tmp_path):
    t = drills.hedging_leg(tmp_path, SIZES, print, card=False, cmd=CPU_DRIVER)
    assert t["hedged_p99_ms"] < t["unhedged_p99_ms"]
