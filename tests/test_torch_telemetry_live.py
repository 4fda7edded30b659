"""The port's live telemetry (``mpitest_tpu_torch/utils/metrics_live.py``,
``serve/sentinel.py``, ``serve/telemetry.py``) against the reference's.

The registry and its exposition, the span-close bridge (the same span
sequence into both packages' bridges gives the same families and values),
the sentinel (the same span sequence raises the same alerts), the HTTP
side port of a core on CPU ranks, the profile hook, and the trace context
of served requests."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mpitest_tpu.serve import sentinel as ref_sentinel
from mpitest_tpu.utils import metrics_live as ref_ml
from mpitest_tpu.utils import spans as ref_spans
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.serve import sentinel as port_sentinel
from mpitest_tpu_torch.utils import flight_recorder as fr
from mpitest_tpu_torch.utils import metrics_live
from mpitest_tpu_torch.utils.metrics_live import (LiveMetrics, SpanMetricsBridge,
                                                  check_exposition, parse_prom_text)
from mpitest_tpu_torch.utils.spans import SpanLog


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


def _core(monkeypatch, P: int = 1, **env):
    """A core on P CPU ranks; ``env`` stays set for the rest of the test
    (the sorts read their knobs per call)."""
    from mpitest_tpu_torch.serve.server import ServerCore

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return ServerCore(make_mesh(P, devices=["cpu"] * P))


# ------------------------------------------------------ metrics registry

def test_counter_gauge_histogram_accuracy():
    m = LiveMetrics()
    c = m.counter("sort_serve_requests_total")
    c.inc(1, status="ok")
    c.inc(2, status="ok")
    c.inc(1, status="integrity")
    assert c.get(status="ok") == 3
    assert c.total() == 4
    with pytest.raises(ValueError):
        c.inc(-1)
    g = m.gauge("sort_serve_inflight")
    g.set(7)
    g.set(2)
    assert g.get() == 2
    h = m.histogram("sort_serve_request_latency_seconds")
    for v in (0.0004, 0.004, 0.04, 0.4, 400.0):
        h.observe(v)
    assert h.sample_count() == 5
    assert h.get() == pytest.approx(400.4444)


def test_unregistered_or_miskinded_metric_raises():
    m = LiveMetrics()
    with pytest.raises(KeyError):
        m.counter("sort_made_up_total")
    with pytest.raises(KeyError):
        m.gauge("sort_serve_requests_total")
    m.counter("sort_serve_requests_total").inc(1, status="ok")
    with pytest.raises(KeyError):
        m.gauge("sort_serve_requests_total")
    assert m.counter("sort_serve_requests_total").total() == 1


def test_exposition_roundtrip_and_escaping():
    m = LiveMetrics()
    m.counter("sort_faults_total").inc(1, site='we"ird\\site')
    m.histogram("sort_serve_batch_segments").observe(3)
    m.histogram("sort_serve_batch_segments").observe(100)
    text = m.render_prom()
    assert check_exposition(text) == []
    fams = parse_prom_text(text)
    (_n, labels, v), = fams["sort_faults_total"]["samples"]
    assert labels == {"site": 'we"ird\\site'} and v == 1
    cnt = [v for n, _l, v in fams["sort_serve_batch_segments"]["samples"]
           if n == "sort_serve_batch_segments_count"]
    assert cnt == [2]
    # the reference renders the same registry state to the same text
    rm = ref_ml.LiveMetrics()
    rm.counter("sort_faults_total").inc(1, site='we"ird\\site')
    rm.histogram("sort_serve_batch_segments").observe(3)
    rm.histogram("sort_serve_batch_segments").observe(100)
    assert rm.render_prom() == text


def test_check_exposition_flags_unregistered_and_bad_grammar():
    bad = "# TYPE nope_total counter\nnope_total 3\n"
    assert any("not registered" in e for e in check_exposition(bad))
    assert check_exposition("sort_serve_inflight notanumber\n")
    with pytest.raises(ValueError):
        parse_prom_text("sort_serve_inflight oops\n")


def test_registry_vocabulary_equals_reference():
    """Names, types and histogram buckets are the reference's (help texts
    may name the port's profiler)."""
    assert {k: v[0] for k, v in metrics_live.METRICS.items()} == \
        {k: v[0] for k, v in ref_ml.METRICS.items()}
    assert metrics_live._HISTOGRAM_BUCKETS == ref_ml._HISTOGRAM_BUCKETS
    for name, (kind, help_text) in metrics_live.METRICS.items():
        assert kind in ("counter", "gauge", "histogram") and help_text, name


# ------------------------------------------------------------ the bridge

def _span_sequence(log) -> None:
    log.record("serve.request", 0.0, 0.02, status="ok", batched=True,
               n=100, queue_s=0.003)
    log.record("serve.request", 0.0, 0.5, status="integrity")
    log.record("serve.request", 0.0, 0.0, status="backpressure",
               reject="inflight")
    log.record("serve.batch", 0.0, 0.01, segments=4, keys=1200)
    log.record("serve.compile_cache", 0.0, 0.0, hit=False, compile_s=0.7)
    log.record("serve.compile_cache", 0.0, 0.0, hit=True)
    log.record("serve.profile", 0.0, 0.1, trigger="endpoint")
    log.record("serve.deadline", 0.0, 0.0, stage="queue")
    log.record("serve.watchdog", 0.0, 0.0, event="trip")
    log.record("serve.watchdog", 0.0, 0.0, event="drain_timeout")
    log.record("serve.alert", 0.0, 0.0, rule="cap_thrash", severity="warn")
    log.record("verify", 0.0, 0.0, ok=False)
    log.record("phase:verify", 0.0, 0.25)
    log.record("supervisor_retry", 0.0, 0.0, attempt=1)
    log.record("fault", 0.0, 0.0, site="exchange_drop")
    log.record("external.run", 0.0, 0.0, bytes=4096)
    log.record("external.merge", 0.0, 0.5)
    log.record("external.recover", 0.0, 0.0)
    log.record("external.resume", 0.0, 0.0)
    log.record("external.gc", 0.0, 0.0, reclaimed=3)
    log.record("exchange_balance", 0.0, 0.0, recv_ratio=1.5,
               peer_ratio=2.0, negotiated_cap=256, worst_cap=2048,
               recv_bytes=[10, 20], send_bytes=[15, 15])
    log.record("sort.plan", 0.0, 0.0, algo="radix", regret=1.25,
               decisions={"cap": {"chosen": 256, "regret": 1.25},
                          "algo": {"chosen": "radix",
                                   "requested": "sample",
                                   "trigger": "skew_sniff",
                                   "regret": 0.0},
                          "planner": {"chosen": "window_auto",
                                      "predicted": {"applied": True},
                                      "regret": 0.5}})


def _samples(text: str) -> dict:
    return {(n, tuple(sorted(lbl.items()))): v
            for fam in parse_prom_text(text).values()
            for n, lbl, v in fam["samples"]}


def test_span_bridge_exposition_equals_reference():
    """The same span sequence through both packages' bridges: the same
    metric families with the same values."""
    m = LiveMetrics()
    log = SpanLog()
    log.observers.append(SpanMetricsBridge(m))
    _span_sequence(log)
    rm = ref_ml.LiveMetrics()
    rlog = ref_spans.SpanLog()
    rlog.observers.append(ref_ml.SpanMetricsBridge(rm))
    _span_sequence(rlog)
    text = m.render_prom()
    assert check_exposition(text) == []
    assert _samples(text) == _samples(rm.render_prom())
    assert set(parse_prom_text(text)) == set(parse_prom_text(rm.render_prom()))
    assert m.counter("sort_serve_requests_total").total() == 3
    assert m.counter("sort_serve_watchdog_trips_total").total() == 1
    assert m.counter("sort_plan_reroutes_total").get(trigger="skew_sniff") == 1
    assert m.counter("sort_planner_decisions_total").get(
        policy="window_auto", applied="true") == 1


def test_bridge_errors_never_escape_the_span_path():
    log = SpanLog()

    def bomb(_s):
        raise RuntimeError("observer bug")

    log.observers.append(bomb)
    with log.span("sort"):
        pass
    assert log.spans[0].name == "sort"


# -------------------------------------------------------------- sentinel

def _alert_sequence(log) -> None:
    # exchange imbalance past the warn factor, three samples
    for ratio in (2.0, 2.2, 2.4):
        log.record("exchange_balance", 0.0, 0.0, peer_ratio=ratio)
    # cap regrows accumulating in plan records
    for _ in range(2):
        log.record("sort.plan", 0.0, 0.0, algo="radix",
                   decisions={"cap": {"actual": {"regrows": 1}}})
    # breaker flapping
    for _ in range(2):
        log.record("serve.watchdog", 0.0, 0.0, event="trip")
    # error-budget burn: 8 requests, 4 of them failed
    for i in range(8):
        log.record("serve.request", 0.0, 0.01,
                   status="ok" if i % 2 else "internal")


def _alerts(sentinel) -> list[tuple]:
    return [(a["rule"], a["severity"], a["value"], a["threshold"],
             a["summary"]) for a in sentinel.snapshot()["alerts"]]


def test_sentinel_alerts_equal_reference(tmp_path):
    m = LiveMetrics()
    log = SpanLog()
    log.observers.append(SpanMetricsBridge(m))
    s = port_sentinel.SortSentinel(m, log, window_s=60.0, burn_rate=2.0)
    log.observers.append(s)
    _alert_sequence(log)
    rm = ref_ml.LiveMetrics()
    rlog = ref_spans.SpanLog()
    rlog.observers.append(ref_ml.SpanMetricsBridge(rm))
    rs = ref_sentinel.SortSentinel(rm, rlog, window_s=60.0, burn_rate=2.0)
    rlog.observers.append(rs)
    _alert_sequence(rlog)
    got = _alerts(s)
    assert got == _alerts(rs)
    assert {a[0] for a in got} == {"skew_imbalance", "cap_thrash",
                                   "breaker_flap", "deadline_burn"}
    assert m.counter("sort_alerts_total").total() == len(got)
    snap, rsnap = s.snapshot(), rs.snapshot()
    for d in (snap, rsnap):
        for a in d["alerts"]:
            a.pop("ts")
        d["series"].pop("p99_ms")
    assert snap == rsnap


def test_sentinel_raises_on_unregistered_rule():
    s = port_sentinel.SortSentinel(LiveMetrics(), SpanLog(), window_s=1.0,
                                   burn_rate=2.0)
    with pytest.raises(KeyError):
        s._alert("made_up_rule", "warn", "x", value=1.0, threshold=1.0)


# ------------------------------------------------------------ the core

def test_batched_requests_share_batch_id_keep_trace_ids(monkeypatch):
    rng = np.random.default_rng(3)
    core = _core(monkeypatch, SORT_SERVE_BATCH_WINDOW_MS="60")
    try:
        arrs = [rng.integers(-2**31, 2**31 - 1, size=300, dtype=np.int32)
                for _ in range(3)]
        res: dict = {}

        def send(i):
            res[i] = core.execute(arrs[i], trace_id=f"tt{i}")

        ts = [threading.Thread(target=send, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        for i in range(3):
            st, out, attrs = res[i]
            assert st == "ok" and np.array_equal(out, np.sort(arrs[i]))
            assert attrs["trace_id"] == f"tt{i}" and attrs["queue_s"] >= 0
        bids = {res[i][2]["batch_id"] for i in range(3)}
        assert len(bids) == 1
        batch = [s for s in core.tracer.spans.spans if s.name == "serve.batch"]
        assert sorted(batch[-1].attrs["trace_ids"]) == ["tt0", "tt1", "tt2"]
        assert batch[-1].attrs["batch_id"] == bids.pop()
    finally:
        core.batcher.stop(timeout=10)


def test_solo_request_stamps_every_sort_span(monkeypatch):
    rng = np.random.default_rng(4)
    core = _core(monkeypatch, SORT_SERVE_BATCH_KEYS="128")
    try:
        a = rng.integers(-2**31, 2**31 - 1, size=3000, dtype=np.int32)
        st, out, attrs = core.execute(a, trace_id="solo-t")
        assert st == "ok" and np.array_equal(out, np.sort(a))
        assert attrs["batched"] is False
        stamped = {s.name for s in core.tracer.spans.spans
                   if s.attrs.get("trace_id") == "solo-t"}
        assert {"serve.request", "sort", "verify"} <= stamped
        assert any(n.startswith("phase:") for n in stamped)
    finally:
        core.batcher.stop(timeout=10)


def test_retried_and_faulted_requests_keep_their_trace_id(monkeypatch):
    rng = np.random.default_rng(5)
    a = rng.integers(-2**31, 2**31 - 1, size=2048, dtype=np.int32)
    core = _core(monkeypatch, 8, SORT_SERVE_ALLOW_FAULTS="1", SORT_MAX_RETRIES="2",
                 SORT_FALLBACK="0", SORT_SERVE_BATCH_KEYS="512",
                 SORT_RETRY_BACKOFF="0")
    try:
        st, out, _ = core.execute(a, faults_spec="dispatch_error:1",
                                  trace_id="retry-t")
        assert st == "ok" and np.array_equal(out, np.sort(a))
        retries = [s for s in core.tracer.spans.spans
                   if s.name == "supervisor_retry"]
        assert retries and retries[-1].attrs["trace_id"] == "retry-t"
    finally:
        core.batcher.stop(timeout=10)
    core = _core(monkeypatch, 8, SORT_SERVE_ALLOW_FAULTS="1", SORT_MAX_RETRIES="0",
                 SORT_FALLBACK="0", SORT_SERVE_BATCH_KEYS="512")
    try:
        st, _detail, attrs = core.execute(a, faults_spec="result_swap:inf",
                                          trace_id="bad-t")
        assert st == "integrity" and attrs["trace_id"] == "bad-t"
        faulted = [s for s in core.tracer.spans.spans
                   if s.name == "fault" and s.attrs.get("trace_id") == "bad-t"]
        assert faulted, "fault events lost the request identity"
    finally:
        core.batcher.stop(timeout=10)


# ----------------------------------------------------- telemetry endpoints

def test_telemetry_http_endpoints(monkeypatch):
    from mpitest_tpu_torch.serve.telemetry import TelemetryServer

    rng = np.random.default_rng(6)
    core = _core(monkeypatch, SORT_SERVE_BATCH_WINDOW_MS="0")
    tel = TelemetryServer(core, "127.0.0.1", 0)
    tel.start()
    try:
        a = rng.integers(-100, 100, size=256, dtype=np.int32)
        assert core.execute(a, trace_id="ep-t")[0] == "ok"
        base = f"http://127.0.0.1:{tel.bound_port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.status, r.read()

        st, body = get("/metrics")
        assert st == 200 and check_exposition(body.decode()) == []
        fams = parse_prom_text(body.decode())
        (_n, lbl, v), = fams["sort_serve_requests_total"]["samples"]
        assert lbl == {"status": "ok"} and v == 1
        st, body = get("/healthz")
        hz = json.loads(body)
        assert st == 200 and hz["ok"] is True and hz["breaker"] == "closed"
        assert hz["requests_ok"] == 1
        st, body = get("/varz")
        vz = json.loads(body)
        assert vz["mesh"] == {"devices": 1, "platform": "cpu"}
        assert vz["requests"] == {"ok": 1, "err": 0}
        assert vz["plans"]["plans"] >= 1 and vz["plans"]["last"]["algo"]
        assert vz["knobs_set"]["SORT_FLIGHT_RECORDER_DIR"]
        assert vz["profiler"]["failed"] == 0
        st, body = get("/alerts")
        assert st == 200 and json.loads(body)["enabled"] is True
        st, body = get("/flightrecorder")
        rows = [json.loads(ln) for ln in body.decode().splitlines() if ln]
        assert any(r.get("name") == "serve.request" for r in rows)
        st, body = get("/profile?n=2")
        assert json.loads(body)["armed"] == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/profile?n=0", timeout=10)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert e.value.code == 404
        core.start_drain()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert e.value.code == 503
    finally:
        tel.shutdown()
        tel.server_close()
        core.batcher.stop(timeout=10)


# ----------------------------------------------------------- profile hook

def test_profile_hook_captures_a_dispatch(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    monkeypatch.setenv("SORT_PROFILE", str(tmp_path / "prof"))
    core = _core(monkeypatch, SORT_SERVE_BATCH_WINDOW_MS="0")
    try:
        core.profiler.arm(1)
        a = rng.integers(-100, 100, size=300, dtype=np.int32)
        st, out, _ = core.execute(a)
        assert st == "ok" and np.array_equal(out, np.sort(a))
        state = core.profiler.state()
        assert state["captures"] == 1 and state["failed"] == 0
        ev = [s for s in core.tracer.spans.spans if s.name == "serve.profile"]
        assert ev and ev[0].attrs["trigger"] == "endpoint"
        assert list((tmp_path / "prof").rglob("*.pt.trace.json"))
        assert core.metrics.counter("sort_profile_captures_total").total() == 1
    finally:
        core.batcher.stop(timeout=10)


def test_profiler_failure_never_fails_a_request(monkeypatch):
    from mpitest_tpu_torch.utils import trace

    def broken(logdir, devices=None):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(trace, "torch_profile", broken)
    rng = np.random.default_rng(8)
    core = _core(monkeypatch, SORT_SERVE_BATCH_WINDOW_MS="0", SORT_PROFILE_EVERY="1")
    try:
        a = rng.integers(-100, 100, size=300, dtype=np.int32)
        st, out, _ = core.execute(a)
        assert st == "ok" and np.array_equal(out, np.sort(a))
        assert core.profiler.state()["failed"] == 1
        assert core.profiler.state()["captures"] == 0
    finally:
        core.batcher.stop(timeout=10)
