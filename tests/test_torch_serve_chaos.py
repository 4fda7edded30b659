"""Request-lifecycle robustness of the port's server on CPU ranks: the
twins of the reference's ``tests/test_zz_chaos.py`` — deadlines at each
lifecycle stage, the circuit breaker and the dispatch watchdog (against a
real wedged dispatch through the ``dispatch_stall`` fault site), wire
stalls and drips, client retries, deadline budgets, hedging, the reply
fingerprint and the chaos proxy (``bench/wire_chaos.py``).

The watchdog test does not depend on load: it sends its warm-up request
before the watchdog starts, stalls the dispatch eight times longer than
the dispatch timeout, and waits on state changes with generous deadlines
instead of fixed sleeps."""

from __future__ import annotations

import io
import json
import socket
import socketserver
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.serve.batching import ERR_DEADLINE, Batcher, ServeRequest
from mpitest_tpu_torch.serve.client import (ResilientClient, ServeClient, ServeReply,
                                            reply_fingerprint_ok)
from mpitest_tpu_torch.serve.watchdog import CircuitBreaker, DispatchWatchdog
from mpitest_tpu_torch.utils import flight_recorder as fr
from mpitest_tpu_torch.utils.spans import SpanLog

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_recorder(monkeypatch, tmp_path):
    monkeypatch.setenv("SORT_FLIGHT_RECORDER_DIR", str(tmp_path / "flight"))
    fr.reset()
    yield
    fr.reset()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def serve_core(monkeypatch):
    from mpitest_tpu_torch.serve.server import ServerCore

    made = []

    def make(P: int = 1, **env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        core = ServerCore(make_mesh(P, devices=["cpu"] * P))
        made.append(core)
        return core

    yield make
    for core in made:
        core.watchdog.stop()
        core.batcher.stop(timeout=10)


@contextmanager
def wire_server(core):
    from mpitest_tpu_torch.serve.server import SortServer

    srv = SortServer(core, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.bound_port
    finally:
        srv.shutdown()
        srv.server_close()


def _req(arr, **kw):
    defaults = dict(arr=arr, dtype=np.dtype(arr.dtype), algo="sample",
                    batchable=True, trace_id="t")
    defaults.update(kw)
    return ServeRequest(**defaults)


def wait_until(pred, timeout_s=10.0, interval=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


# ------------------------------------------------------------ deadlines

def test_serve_request_deadline_helpers():
    a = np.arange(4, dtype=np.int32)
    assert not _req(a).expired()
    r = _req(a, deadline=time.monotonic() - 0.01)
    assert r.expired()
    r.fail_deadline("queue")
    assert r.done.is_set()
    assert r.error[0] == ERR_DEADLINE == "deadline_exceeded"
    assert r.deadline_stage == "queue"


def test_deadline_expiry_at_admission_stage(rng, serve_core):
    core = serve_core(SORT_SERVE_BATCH_WINDOW_MS="0")
    a = rng.integers(-2**31, 2**31 - 1, size=256, dtype=np.int32)
    st, _detail, attrs = core.execute(a, deadline_ms=1e-4)
    assert st == "deadline_exceeded" and attrs["deadline_stage"] == "admission"
    assert core.admission.inflight_bytes == 0 and core.admission.inflight == 0
    ev = [s for s in core.tracer.spans.spans if s.name == "serve.deadline"]
    assert ev and ev[-1].attrs["stage"] == "admission"
    assert core.metrics.counter("sort_serve_deadline_exceeded_total").get(
        stage="admission") == 1
    st2, out, _ = core.execute(a)
    assert st2 == "ok" and np.array_equal(out, np.sort(a))


def test_deadline_expiry_in_queue_and_window_close():
    dispatched: list[str] = []

    def run_batch(reqs):
        dispatched.extend(r.trace_id for r in reqs)
        time.sleep(0.3)
        for r in reqs:
            r.complete(r.arr, batched=True, bucket=None)

    def run_solo(req):
        dispatched.append(req.trace_id)
        req.complete(req.arr, batched=False, bucket=None)

    a = np.arange(8, dtype=np.int32)
    b = Batcher(run_batch, run_solo, window_s=0.0, batch_keys=1 << 16)
    try:
        first = _req(a, trace_id="slow")
        b.submit(first)
        victim = _req(a, trace_id="victim", deadline=time.monotonic() + 0.05)
        b.submit(victim)
        assert victim.done.wait(5.0)
        assert victim.error[0] == ERR_DEADLINE and victim.deadline_stage == "queue"
        assert first.done.wait(5.0) and first.error is None
        assert "victim" not in dispatched and b.deadline_cancelled == 1
    finally:
        b.stop(timeout=5)

    t_dispatch: list[float] = []

    def run_batch2(reqs):
        t_dispatch.append(time.monotonic())
        for r in reqs:
            r.complete(r.arr, batched=True, bucket=None)

    b2 = Batcher(run_batch2, run_solo, window_s=10.0, batch_keys=1 << 16)
    try:
        t0 = time.monotonic()
        hurried = _req(a, trace_id="hurried", deadline=time.monotonic() + 0.15)
        b2.submit(hurried)
        assert hurried.done.wait(5.0) and hurried.error is None
        assert t_dispatch and t_dispatch[0] - t0 < 1.0
        assert hurried.window["closed_by"] == "deadline"
    finally:
        b2.stop(timeout=5)


def test_deadline_wire_parse_and_propagation(rng, serve_core):
    core = serve_core(SORT_SERVE_BATCH_WINDOW_MS="0")
    a = rng.integers(-2**31, 2**31 - 1, size=128, dtype=np.int32)

    def wire(hdr_extra):
        hdr = {"v": "sortserve.v1", "dtype": "int32", "n": int(a.size), **hdr_extra}
        return core.handle_wire(json.dumps(hdr).encode() + b"\n",
                                io.BytesIO(a.tobytes()))

    for bad in ("soon", -5, 0, float("nan"), True):
        resp, _p, keep = wire({"deadline_ms": bad})
        assert not resp["ok"] and resp["error"] == "bad_request" and keep, bad
    resp, payload, keep = wire({"deadline_ms": 60000})
    assert resp["ok"] and keep
    assert np.array_equal(np.frombuffer(payload, np.int32), np.sort(a))
    resp, payload, keep = wire({"deadline_ms": 1e-4})
    assert not resp["ok"] and resp["error"] == "deadline_exceeded"
    assert payload == b"" and keep and core.admission.inflight_bytes == 0


def test_executor_entry_deadline_gate(rng, serve_core):
    core = serve_core(SORT_SERVE_BATCH_WINDOW_MS="0")
    a = rng.integers(-2**31, 2**31 - 1, size=64, dtype=np.int32)
    req = _req(a, batchable=False, deadline=time.monotonic() - 0.01)
    core._run_solo(req)
    assert req.error[0] == ERR_DEADLINE and req.deadline_stage == "dispatch"


# ------------------------------------------------- watchdog + breaker

def test_circuit_breaker_state_machine():
    br = CircuitBreaker(backoff_s=0.05)
    assert br.state == "closed" and not br.engaged()
    assert br.trip() is True
    assert br.trip() is False
    assert br.engaged() and br.state == "open"
    assert not br.ready_to_probe()
    assert wait_until(br.ready_to_probe, 5.0)
    assert br.state == "half_open" and br.engaged()
    br.probe_failed()
    assert br.state == "open"
    assert br.snapshot()["backoff_s"] == pytest.approx(0.1)
    assert wait_until(br.ready_to_probe, 5.0)
    br.probe_succeeded()
    assert br.state == "closed" and not br.engaged()
    assert br.trips == 1 and br.recoveries == 1


def test_watchdog_trips_on_wedged_dispatch_and_recovers(rng, serve_core, tmp_path):
    """A per-request ``dispatch_stall`` wedges the real dispatch thread
    (eight ranks, supervisor dispatch) for 4 s against a 0.5 s dispatch
    timeout: the watchdog trips the breaker (typed fast rejections, a
    flight artifact), and the half-open probe recovers without a
    restart."""
    from mpitest_tpu_torch import report

    core = serve_core(8, SORT_SERVE_ALLOW_FAULTS="1",
                      SORT_FAULT_STALL_MS="4000",
                      SORT_SERVE_DISPATCH_TIMEOUT_S="0.5",
                      SORT_SERVE_BREAKER_BACKOFF_S="0.2",
                      SORT_SERVE_BATCH_WINDOW_MS="0",
                      SORT_SERVE_BATCH_KEYS="1024")
    a = rng.integers(-2**31, 2**31 - 1, size=2048, dtype=np.int32)
    st, out, _ = core.execute(a)            # warm, before the watchdog runs
    assert st == "ok" and np.array_equal(out, np.sort(a))
    core.start_watchdog()
    res: dict = {}

    def stalled():
        res["r"] = core.execute(a, faults_spec="dispatch_stall")

    t = threading.Thread(target=stalled, daemon=True)
    t.start()
    assert wait_until(lambda: core.breaker.state != "closed", 30.0), \
        "watchdog never tripped"
    st2, _detail, attrs = core.execute(a)
    if core.breaker.engaged():
        assert st2 == "backpressure" and attrs["reject"] == "breaker"
    assert wait_until(lambda: core.breaker.state == "closed", 60.0), \
        "breaker never recovered"
    t.join(timeout=60)
    assert res["r"][0] == "ok" and np.array_equal(res["r"][1], np.sort(a))
    st3, out3, _ = core.execute(a)
    assert st3 == "ok" and np.array_equal(out3, np.sort(a))
    events = [s.attrs.get("event") for s in core.tracer.spans.spans
              if s.name == "serve.watchdog"]
    assert "trip" in events and "recovered" in events
    assert core.breaker.trips == 1
    assert core.metrics.counter("sort_serve_watchdog_trips_total").get() == 1
    arts = sorted((tmp_path / "flight").glob("flight-*-watchdog-*.jsonl"))
    assert arts, "watchdog trip wrote no flight artifact"
    assert report.check_rows(report.load_rows(str(arts[-1]))) == []


def test_watchdog_fails_queued_requests_typed():
    import types

    from mpitest_tpu_torch.utils.trace import Tracer

    release = threading.Event()

    def run_solo(req):
        release.wait(10.0)
        req.complete(req.arr, batched=False, bucket=None)

    def run_batch(reqs):
        for r in reqs:
            run_solo(r)

    b = Batcher(run_batch, run_solo, window_s=0.0, batch_keys=1 << 16)
    core = types.SimpleNamespace(batcher=b, tracer=Tracer(), default_algo="sample")
    br = CircuitBreaker(backoff_s=30.0)
    wd = DispatchWatchdog(core, timeout_s=0.2, breaker=br)
    try:
        a = np.arange(8, dtype=np.int32)
        wedged = _req(a, trace_id="wedged", batchable=False)
        queued = _req(a, trace_id="queued", batchable=False)
        b.submit(wedged)
        b.submit(queued)
        wd.start()
        assert queued.done.wait(10.0), "queued request never failed"
        assert queued.error[0] == "internal" and "watchdog" in queued.error[1]
        assert br.state == "open" and br.trips == 1
        release.set()
        assert wedged.done.wait(5.0) and wedged.error is None
    finally:
        release.set()
        wd.stop()
        b.stop(timeout=5)


def test_batcher_stop_reports_wedged_thread():
    release = threading.Event()

    def run_solo(req):
        release.wait(10.0)
        req.complete(req.arr, batched=False, bucket=None)

    b = Batcher(lambda reqs: None, run_solo, window_s=0.0, batch_keys=1 << 16)
    try:
        req = _req(np.arange(4, dtype=np.int32), batchable=False)
        b.submit(req)
        assert wait_until(lambda: b.inflight_dispatch() is not None, 5.0)
        assert b.stop(timeout=0.2) is False
        release.set()
        assert b.stop(timeout=5.0) is True
    finally:
        release.set()


def test_call_soon_runs_on_the_dispatch_thread_and_survives_errors():
    ran: list[str] = []
    b = Batcher(lambda reqs: None, lambda r: r.complete(r.arr, False, None),
                window_s=0.0, batch_keys=1 << 16)
    try:
        b.call_soon(lambda: 1 / 0)
        b.call_soon(lambda: ran.append(threading.current_thread().name))
        req = _req(np.arange(4, dtype=np.int32), batchable=False)
        b.submit(req)
        assert req.done.wait(5.0) and req.error is None
        assert ran == ["serve-dispatch"]
    finally:
        b.stop(timeout=5)


# ------------------------------------------------------- wire timeouts

def test_stalled_mid_payload_disconnected_and_bytes_released(rng, serve_core):
    core = serve_core(SORT_SERVE_READ_TIMEOUT_S="0.5",
                      SORT_SERVE_BATCH_WINDOW_MS="0")
    with wire_server(core) as port:
        a = rng.integers(-2**31, 2**31 - 1, size=1 << 14, dtype=np.int32)
        hdr = json.dumps({"v": "sortserve.v1", "dtype": "int32",
                          "n": int(a.size)}).encode() + b"\n"
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(hdr + a.tobytes()[: a.nbytes // 2])
        assert wait_until(lambda: core.admission.inflight_bytes > 0, 10.0)
        assert wait_until(lambda: core.admission.inflight_bytes == 0, 10.0), \
            "admission bytes leaked on a stalled payload"
        assert core.metrics.counter("sort_serve_timeouts_total").get(kind="read") >= 1
        s.close()
        s2 = socket.create_connection(("127.0.0.1", port), timeout=10)
        s2.sendall(hdr + a.tobytes()[: a.nbytes // 2])
        s2.close()
        assert wait_until(lambda: core.admission.inflight_bytes == 0, 10.0)
        x = rng.integers(-2**31, 2**31 - 1, size=600, dtype=np.int32)
        with ServeClient("127.0.0.1", port, timeout=30) as c:
            r = c.sort(x)
        assert r.ok and np.array_equal(r.arr, np.sort(x))


def test_idle_connection_closed(serve_core):
    core = serve_core(SORT_SERVE_IDLE_TIMEOUT_S="0.3",
                      SORT_SERVE_BATCH_WINDOW_MS="0")
    with wire_server(core) as port:
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.settimeout(10.0)
        assert s.recv(1) == b""
        s.close()
        assert wait_until(lambda: core.metrics.counter(
            "sort_serve_timeouts_total").get(kind="idle") >= 1, 5.0)


def test_slow_drip_bounded_by_total_read_budget(serve_core):
    core = serve_core(SORT_SERVE_READ_TIMEOUT_S="0.5",
                      SORT_SERVE_BATCH_WINDOW_MS="0")
    with wire_server(core) as port:
        hdr = json.dumps({"v": "sortserve.v1", "dtype": "int32",
                          "n": 1 << 14}).encode() + b"\n"
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(hdr)
        shed = False
        try:
            for _ in range(80):
                s.sendall(b"\x01" * 100)
                time.sleep(0.12)
        except OSError:
            shed = True
        assert shed, "server never shed the drip"
        s.close()
        assert wait_until(lambda: core.admission.inflight_bytes == 0, 10.0)
        assert core.metrics.counter("sort_serve_timeouts_total").get(kind="read") >= 1


# ----------------------------------------------------- client resilience

class _FlakyHandler(socketserver.StreamRequestHandler):
    """Protocol-speaking flaky server: behavior by connection index via
    ``server.plan`` — 'die', 'backpressure', seconds to hold, or 'ok'."""

    def handle(self):
        srv = self.server
        with srv.lock:
            idx = srv.conn_seq
            srv.conn_seq += 1
        mode = srv.plan[min(idx, len(srv.plan) - 1)]
        if mode == "die":
            return
        while True:
            line = self.rfile.readline()
            if not line.strip():
                return
            hdr = json.loads(line)
            n, dt = hdr["n"], np.dtype(hdr["dtype"])
            arr = np.frombuffer(self.rfile.read(n * dt.itemsize), dt)
            if mode == "backpressure":
                self.wfile.write(json.dumps(
                    {"ok": False, "error": "backpressure", "detail": "induced",
                     "trace_id": hdr.get("trace_id")}).encode() + b"\n")
                self.wfile.flush()
                continue
            if isinstance(mode, (int, float)):
                time.sleep(float(mode))
            self.wfile.write(json.dumps(
                {"ok": True, "n": n, "dtype": dt.name,
                 "trace_id": hdr.get("trace_id")}).encode() + b"\n"
                + np.sort(arr).tobytes())
            self.wfile.flush()


@contextmanager
def flaky_server(plan):
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _FlakyHandler)
    srv.daemon_threads = True
    srv.plan = plan
    srv.conn_seq = 0
    srv.lock = threading.Lock()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()


def test_client_retries_connect_errors_with_backoff(rng):
    a = rng.integers(-2**31, 2**31 - 1, size=300, dtype=np.int32)
    with flaky_server(["die", "die", "ok"]) as port:
        c = ResilientClient("127.0.0.1", port, backoff_s=0.01, max_attempts=4)
        r = c.sort(a)
        assert r.ok and np.array_equal(r.arr, np.sort(a))
        assert c.stats["retries"] == 2 and c.stats["transport_errors"] == 2


def test_client_retries_typed_retryable_and_respects_budget(rng, serve_core):
    a = rng.integers(-2**31, 2**31 - 1, size=300, dtype=np.int32)
    with flaky_server(["backpressure", "ok"]) as port:
        c = ResilientClient("127.0.0.1", port, backoff_s=0.01, max_attempts=3)
        r = c.sort(a)
        assert r.ok and c.stats["retries"] == 1
    with flaky_server(["backpressure"]) as port:
        c = ResilientClient("127.0.0.1", port, backoff_s=0.01, max_attempts=2)
        r = c.sort(a)
        assert not r.ok and r.error == "backpressure" and c.stats["retries"] == 1
    core = serve_core(SORT_SERVE_BATCH_WINDOW_MS="0")
    with wire_server(core) as port:
        c = ResilientClient("127.0.0.1", port, max_attempts=3)
        r = c.sort(a, trace_id="bad id!")
        assert not r.ok and r.error == "bad_request" and c.stats["retries"] == 0


def test_client_deadline_budget_shrinks_across_retries(rng):
    a = rng.integers(-2**31, 2**31 - 1, size=64, dtype=np.int32)
    with flaky_server(["backpressure"]) as port:
        c = ResilientClient("127.0.0.1", port, backoff_s=0.06, jitter=0.0,
                            max_attempts=50)
        r = c.sort(a, deadline_ms=150)
        assert not r.ok and r.error == "deadline_exceeded"
        assert "client-side" in r.detail and c.stats["attempts"] < 50


def test_client_hedging_cuts_injected_tail(rng):
    a = rng.integers(-2**31, 2**31 - 1, size=300, dtype=np.int32)
    spanlog = SpanLog()
    with flaky_server([3.0, "ok", "ok"]) as port:
        c = ResilientClient("127.0.0.1", port, hedge_after_s=0.1,
                            read_timeout=10.0, spanlog=spanlog)
        t0 = time.perf_counter()
        r = c.sort(a, trace_id="hedge-unit")
        dt = time.perf_counter() - t0
        assert r.ok and np.array_equal(r.arr, np.sort(a))
        assert dt < 2.5, f"hedge did not cut the tail ({dt:.2f}s)"
        assert c.stats["hedges"] == 1 and c.stats["hedge_wins"] == 1
        hedge_spans = [s for s in spanlog.spans if s.name == "serve.hedge"]
        assert hedge_spans and hedge_spans[0].attrs["winner"] == "hedge"


def test_reply_fingerprint_rejects_foreign_bytes(rng):
    a = rng.integers(-2**31, 2**31 - 1, size=64, dtype=np.int32)
    assert reply_fingerprint_ok(a, ServeReply(True, {"ok": True}, np.sort(a)))
    assert not reply_fingerprint_ok(a, ServeReply(True, {}, np.sort(a)[:-1]))
    substituted = np.sort(a).copy()
    substituted[0] = substituted[0] ^ 1
    assert not reply_fingerprint_ok(a, ServeReply(True, {}, substituted))
    assert not reply_fingerprint_ok(a, ServeReply(False, {}))
    assert not reply_fingerprint_ok(a, ServeReply(True, {}, np.sort(a)[::-1].copy()))
    f = np.array([3.0, np.nan, 1.0])
    assert reply_fingerprint_ok(f, ServeReply(True, {}, np.sort(f)))


def test_chaos_proxy_torn_header_and_delay(rng, serve_core):
    """The reference's chaos proxy in front of the port's server."""
    sys.path.insert(0, str(REPO / "bench"))
    from wire_chaos import ChaosProxy

    a = rng.integers(-2**31, 2**31 - 1, size=200, dtype=np.int32)
    core = serve_core(SORT_SERVE_BATCH_WINDOW_MS="0")
    with wire_server(core) as port:
        with ChaosProxy("127.0.0.1", port, "wire_torn_header@4") as px:
            with pytest.raises((OSError, ConnectionError)):
                ServeClient("127.0.0.1", px.port, timeout=5).sort(a)
            assert px.log[0] == (0, "wire_torn_header")
        with ServeClient("127.0.0.1", port, timeout=10) as c:
            assert c.sort(a).ok
        with ChaosProxy("127.0.0.1", port, "wire_delay_response@300:2") as px:
            with ServeClient("127.0.0.1", px.port, timeout=10) as c:
                assert c.sort(a).ok
            with ServeClient("127.0.0.1", px.port, timeout=10) as c:
                t0 = time.perf_counter()
                r = c.sort(a)
                slow = time.perf_counter() - t0
            assert r.ok and np.array_equal(r.arr, np.sort(a))
            assert slow >= 0.28
