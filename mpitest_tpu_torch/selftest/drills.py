"""The spawned-server gates of the reference, against the port's server
running as its own process.

Each leg spawns :class:`~mpitest_tpu_torch.selftest.spawned.Server`,
drives it only from outside (the wire protocol and the side port), and
raises ``AssertionError`` on the first gate that fails; it returns its
timings and the server's kernel launches.  The legs:

* :func:`telemetry_leg` -- ``bench/telemetry_live_selftest.py``: trace ids
  echoed and rebuilt by ``python -m mpitest_tpu_torch.report --trace-id``,
  ``/metrics`` valid and reconciled with the client's count, every side
  port route, a fault's flight dump through ``report --check``, a sampled
  stream through the schema check, and the explain leg;
* :func:`wire_leg` -- the mixed load's p50/p99 against a server process,
  then ``bench/chaos_serve_selftest.py``'s wire cells (torn header,
  stalled payload, RST mid-payload, slow drip, disconnect mid-response,
  connect-then-silence), each followed by the four recovery checks;
* :func:`watchdog_leg` and :func:`hedging_leg` -- its watchdog and hedging
  cells;
* :func:`kill_resume_leg` -- ``bench/durability_selftest.py``: SIGKILL at
  the merge stall once every run is journaled, restart, the same
  ``dataset_id`` answered byte for byte from the journal;
* :func:`sentinel_cells` -- ``bench/doctor_selftest.py``'s sentinel cells
  (clean, budget burn, skew), in process.

``sizes`` sets the requests: ``solo`` (one solo int32 request a leg),
``mix_requests`` and ``clients`` (the closed-loop mix), ``big`` (the RST
and drip cells), ``spill`` and ``spill_bytes`` (the kill drill).  With
``card`` each leg asserts the kernels its solo requests must launch in
the server (K1 on one rank, K6 and K7 on eight, K1 for the spill chunk
sorts).
"""

from __future__ import annotations

import glob
import io
import json
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time
from contextlib import redirect_stdout
from pathlib import Path
from typing import Callable

import numpy as np

from mpitest_tpu_torch import report
from mpitest_tpu_torch.report import percentile
from mpitest_tpu_torch.selftest.spawned import (DRIVER, HOST, Server, launch_delta,
                                                metric_total, mix_keys, run_load,
                                                wait_until)
from mpitest_tpu_torch.selftest.wire_chaos import ChaosProxy
from mpitest_tpu_torch.serve.client import ResilientClient, ServeClient

#: Server-side wire budget of the wire cells (the reference gate's).
READ_TIMEOUT_S = 2.0
#: The hedging cell's injected tail: every 4th connection's response held
#: this many ms (the reference gate's schedule and request count).
TAIL_DELAY_MS = 700
TAIL_EVERY = 4
HEDGE_REQUESTS = 24
#: The kill drill's dataset id and armed merge stall.
DATASET = "drill1"
STALL_MS = 30_000

K1 = ("bitonic_u32",)
K6_K7 = ("fused_pass_pack", "remote_a2a")

Log = Callable[[str], None]


def _gate(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _solo(srv: Server, x: np.ndarray, must: tuple[str, ...], card: bool,
          label: str, algo: str | None = None) -> tuple[float, dict]:
    """One solo request: bytes equal to ``np.sort``, its launches read
    from the server's ``/varz``; with ``card``, every kernel of ``must``
    launched."""
    before = srv.launches()
    t0 = time.perf_counter()
    with ServeClient(HOST, srv.port, timeout=600) as c:
        r = c.sort(x, algo=algo)
    wall = time.perf_counter() - t0
    _gate(r.ok, f"{label}: {r.header}")
    _gate(not r.header.get("batched"), f"{label}: a solo request was batched")
    _gate(np.array_equal(r.arr.view(np.uint8), np.sort(x).view(np.uint8)),
          f"{label}: reply differs from np.sort")
    got = launch_delta(before, srv.launches())
    if card:
        for k in must:
            _gate(got.get(k, 0) > 0, f"{label}: kernel {k} never launched ({got})")
    return wall, got


def _report(*args: str) -> tuple[int, str]:
    """``python -m mpitest_tpu_torch.report ARGS`` in this process."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = report.main(list(args))
    return rc, buf.getvalue()


# ------------------------------------------------------------ telemetry

def telemetry_leg(out: Path, sizes: dict, log: Log, *, card: bool,
                  cmd: "tuple[str, ...] | list[str]" = DRIVER,
                  mesh_for: Callable | None = None) -> dict:
    """The live-telemetry gates against an eight-rank server (the
    result-corruption fault sites live on the distributed path)."""
    from mpitest_tpu_torch import doctor
    from mpitest_tpu_torch.utils import metrics_live

    flight = out / "flight_telemetry"
    srv = Server(out, "telemetry", {
        "SORT_DEVICES": "8",
        "SORT_SERVE_BATCH_WINDOW_MS": "30",
        "SORT_SERVE_SHAPE_BUCKETS": "10,11,12,13",
        "SORT_SERVE_ALLOW_FAULTS": "1",
        "SORT_FALLBACK": "0",
        "SORT_MAX_RETRIES": "0",
        "SORT_FLIGHT_RECORDER_DIR": str(flight),
        # every 2nd root span and its subtree is dropped from the stream
        "SORT_TRACE_SAMPLE": "0.5",
    }, cmd)
    timings = {"start_s": srv.start_s}
    statuses: dict[str, int] = {}

    def count(r) -> None:
        st = "ok" if r.ok else str(r.error)
        statuses[st] = statuses.get(st, 0) + 1

    try:
        load = run_load(srv.port, 8, 8, 700, trace_prefix="live-req")
        _gate(not load["bad"], f"telemetry: replies or trace ids wrong {load['bad']}")
        for st, k in load["statuses"].items():
            statuses[st] = statuses.get(st, 0) + k
        _gate(statuses == {"ok": 8}, f"telemetry: statuses {statuses}")
        code, az = srv.get_json("/alerts")
        _gate(code == 200 and az.get("enabled") is True and "series" in az
              and az.get("alerts_total") == 0,
              f"telemetry: /alerts on the clean requests {az}")
        # one poisoned request: typed integrity and a flight dump
        rng = np.random.default_rng(7)
        x = rng.integers(-2**31, 2**31 - 1, size=4096, dtype=np.int32)
        with ServeClient(HOST, srv.port, timeout=600) as c:
            r = c.sort(x, faults="result_swap:inf", trace_id="live-bad")
            count(r)
            _gate(not r.ok and r.error == "integrity",
                  f"telemetry: poisoned request {r.header}")
            r2 = c.sort(x, trace_id="live-after")
            count(r2)
            _gate(r2.ok and np.array_equal(r2.arr, np.sort(x)),
                  "telemetry: the request after the poisoned one")
        dumps = sorted(glob.glob(str(flight / "flight-*.jsonl")))
        _gate(bool(dumps), "telemetry: the typed error left no flight dump")
        rc, text = _report("--check", dumps[0])
        _gate(rc == 0, f"telemetry: report --check rejected {dumps[0]}: {text[-500:]}")
        # /metrics: exposition, registry, exact reconciliation
        code, prom = srv.get("/metrics")
        (out / "scrape_telemetry.prom").write_text(prom)
        errs = metrics_live.check_exposition(prom)
        _gate(code == 200 and not errs, f"telemetry: /metrics {errs}")
        served = int(metric_total(prom, "sort_serve_requests_total"))
        _gate(served == sum(statuses.values()),
              f"telemetry: server counted {served}, clients {statuses}")
        fams = metrics_live.parse_prom_text(prom)
        for name in ("sort_serve_request_latency_seconds_count",
                     "sort_serve_queue_wait_seconds_count",
                     "sort_serve_batches_total", "sort_serve_cache_hits_total",
                     "sort_verify_runs_total", "sort_plans_total"):
            fam = fams.get(name.removesuffix("_count"), {"samples": []})
            _gate(sum(v for n, _l, v in fam["samples"] if n == name) > 0,
                  f"telemetry: /metrics {name} is zero")
        _gate("sort_plan_regret" in fams, "telemetry: no sort_plan_regret in the scrape")
        # the other routes
        code, hz = srv.get_json("/healthz")
        _gate(code == 200 and hz.get("ok") and hz.get("requests_ok", 0) >= 1,
              f"telemetry: /healthz {hz}")
        code, vz = srv.get_json("/varz")
        _gate(vz.get("cache", {}).get("prewarmed", 0) >= 1 and "knobs_set" in vz
              and vz["mesh"]["devices"] == 8, f"telemetry: /varz {sorted(vz)}")
        code, ring = srv.get("/flightrecorder")
        ring_path = out / "ring_telemetry.jsonl"
        ring_path.write_text(ring)
        ring_rows = [json.loads(ln) for ln in ring.splitlines() if ln]
        _gate(any(r.get("name") == "serve.request" for r in ring_rows),
              "telemetry: /flightrecorder has no serve.request")
        _gate(any(r.get("name") == "serve.batch" and r.get("attrs", {}).get("trace_ids")
                  for r in ring_rows),
              "telemetry: no serve.batch with trace_ids in the ring")
        code, pf = srv.get_json("/profile?n=1")
        _gate(code == 200 and pf.get("armed", 0) >= 1, f"telemetry: /profile {pf}")
        with ServeClient(HOST, srv.port, timeout=600) as c:
            x3 = rng.integers(-100, 100, size=256, dtype=np.int32)
            r3 = c.sort(x3)
            count(r3)
            _gate(r3.ok and np.array_equal(r3.arr, np.sort(x3)), "telemetry: r3")
        _gate(wait_until(lambda: metric_total(srv.get("/metrics")[1],
                                              "sort_profile_captures_total") > 0, 30),
              "telemetry: the armed /profile capture never fired")
        code, az = srv.get_json("/alerts")
        prom_alerts = metric_total(srv.get("/metrics")[1], "sort_alerts_total")
        _gate(az.get("alerts_total", -1) == prom_alerts,
              f"telemetry: /alerts total {az.get('alerts_total')} != {prom_alerts}")
        bad_rules = [a["rule"] for a in az.get("alerts", [])
                     if a.get("rule") not in doctor.DOCTOR_RULES]
        _gate(not bad_rules, f"telemetry: unregistered alert rules {bad_rules}")
        # the leg's solo request, on the eight ranks
        wall, got = _solo(srv, rng.integers(-2**31, 2**31 - 1, size=sizes["solo"],
                                            dtype=np.int32),
                          K6_K7, card, "telemetry solo, eight ranks")
        timings.update(solo_s=wall, launches=got)
    finally:
        rc = srv.stop()
    _gate(rc == 0, f"telemetry: server exited {rc} on SIGTERM: {srv.stderr_tail()}")

    # the sampled stream passes the schema check
    rc, text = _report("--check", "--require-registered-spans", str(srv.trace))
    _gate(rc == 0, f"telemetry: the sampled stream failed the check: {text[-800:]}")
    streamed = srv.spans()
    tids = [s["attrs"]["trace_id"] for s in streamed
            if s.get("name") == "serve.request"
            and str(s.get("attrs", {}).get("trace_id", "")).startswith("live-req-")]
    _gate(bool(tids), "telemetry: no live-req serve.request survived sampling")
    # a batched request rebuilt end to end by the report CLI as a user runs
    # it (the first; the others through the same main in this process)
    p = subprocess.run([sys.executable, "-m", "mpitest_tpu_torch.report",
                        "--trace-id", tids[0], str(srv.trace)],
                       capture_output=True, text=True, timeout=120)
    _gate(p.returncode == 0, f"telemetry: report --trace-id {tids[0]}: {p.stderr[-500:]}")
    views = {tids[0]: p.stdout}
    for tid in tids[1:]:
        rc, views[tid] = _report("--trace-id", tid, str(srv.trace))
        _gate(rc == 0, f"telemetry: report --trace-id {tid}: rc {rc}")
    for tid, view in views.items():
        for needle in ("serve.request", "status=ok", "queue_wait=", "batch="):
            _gate(needle in view, f"telemetry: --trace-id {tid} lacks {needle!r}")
    full = [t for t, v in views.items() if "serve.batch" in v]
    log(f"[3n] telemetry: --trace-id rebuilt {len(views)} request(s), "
        f"{len(full)} with their dispatch span in the sampled stream")
    # the explain leg, over the flight ring: the sampler keeps or drops
    # a batch's sort.plan event apart from its serve.batch span, the ring
    # keeps every span
    agg = report.explain_view([dict(s, kind="span") for s in ring_rows])
    _gate(agg is not None and "plan algo=packed" in agg, "telemetry: no plan in the ring")
    live = [f"live-req-{i}" for i in range(8)]
    _gate(all("plan algo=packed" in _report("--explain", "--trace-id", t,
                                            str(ring_path))[1] for t in live),
          "telemetry: a live-req trace id does not resolve to its batch's plan "
          "under --explain")
    if mesh_for is not None:
        timings["cap_regret"] = _cap_regret_comparison(mesh_for)
    timings["statuses"] = statuses
    return timings


def _cap_regret_comparison(mesh_for: Callable) -> tuple[float, float]:
    """The reference's acceptance comparison, in process on two ranks:
    the skewed input's cap regret is strictly larger with
    ``SORT_NEGOTIATE=off``, and the negotiated run's explain tree shows
    the restage decision."""
    from mpitest_tpu_torch.models.api import sort
    from mpitest_tpu_torch.utils import knobs
    from mpitest_tpu_torch.utils.metrics_live import LiveMetrics, SpanMetricsBridge
    from mpitest_tpu_torch.utils.trace import Tracer

    mesh = mesh_for(2)
    x = np.arange(1 << 15, dtype=np.int32)  # arrangement-skewed

    def one(**env):
        m = LiveMetrics()
        tr = Tracer()
        tr.spans.observers.append(SpanMetricsBridge(m))
        with knobs.scoped_env(SORT_RESTAGE_RATIO="1.5", SORT_TRACE_SAMPLE=None, **env):
            sort(x, algorithm="sample", mesh=mesh, tracer=tr)
        return m.gauge("sort_plan_cap_regret").get(), tr

    on, tr_on = one()
    off, _ = one(SORT_NEGOTIATE="off")
    _gate(off > on, f"telemetry: NEGOTIATE=off cap regret {off} not above {on}")
    view = report.explain_view([dict(s.to_dict(), kind="span") for s in tr_on.spans.spans])
    for needle in ("restage", "chosen=True", "peer_recv_bytes", "need="):
        _gate(view is not None and needle in view,
              f"telemetry: the negotiated explain tree lacks {needle!r}")
    return on, off


# ------------------------------------------------------------ the wire

def _assert_recovered(name: str, srv: Server, baseline_threads: int,
                      rng: np.random.Generator) -> None:
    """The contract after every wire cell: admission bytes back to 0 and
    the thread census back at its baseline within the read budget, the
    server alive, a clean follow-up answered byte for byte."""
    def inflight() -> float:
        return metric_total(srv.get("/metrics")[1], "sort_serve_inflight_bytes")

    _gate(wait_until(lambda: inflight() == 0, READ_TIMEOUT_S + 3.0),
          f"{name}: in-flight bytes {inflight()} not back to 0")

    def threads_ok() -> bool:
        return srv.get_json("/healthz")[1]["threads"] <= baseline_threads + 1

    _gate(wait_until(threads_ok, READ_TIMEOUT_S + 3.0),
          f"{name}: threads {srv.get_json('/healthz')[1]['threads']} > baseline "
          f"{baseline_threads} + 1")
    x = mix_keys(rng)
    with ServeClient(HOST, srv.port, timeout=60) as c:
        r = c.sort(x)
    _gate(r.ok and np.array_equal(r.arr, np.sort(x)), f"{name}: follow-up {r.header}")


def wire_leg(out: Path, sizes: dict, log: Log, *, card: bool,
             cmd: "tuple[str, ...] | list[str]" = DRIVER) -> dict:
    """The mixed load against a one-rank server process (p50/p99 with the
    load generator in this process and the server in its own), then the
    wire-chaos cells, then the leg's solo request."""
    srv = Server(out, "wire", {
        "SORT_SERVE_BATCH_WINDOW_MS": "8",
        "SORT_SERVE_READ_TIMEOUT_S": str(READ_TIMEOUT_S),
        "SORT_SERVE_IDLE_TIMEOUT_S": "60",
    }, cmd)
    timings: dict = {"start_s": srv.start_s}
    rng = np.random.default_rng(11)
    try:
        warm = run_load(srv.port, max(16, sizes["clients"]), sizes["clients"], 3026)
        cut = len(srv.spans())
        load = run_load(srv.port, sizes["mix_requests"], sizes["clients"], 2026)
        _gate(not warm["bad"] and not load["bad"], "wire: mix replies differ")
        _gate(load["statuses"] == {"ok": sizes["mix_requests"]},
              f"wire: mix statuses {load['statuses']}")
        lat = load["lat"]
        timings.update(p50_ms=1e3 * percentile(lat, 50), p99_ms=1e3 * percentile(lat, 99),
                       mix_wall_s=load["wall_s"])
        # where a request's time goes, from the server's own spans of the
        # measured window: its serve.request, the queue wait in it, and
        # the packed dispatch it rode
        window = srv.spans()[cut:]
        req = sorted(r["dt"] for r in window if r.get("name") == "serve.request")
        queue = sorted(float(r["attrs"].get("queue_s") or 0.0) for r in window
                       if r.get("name") == "serve.request")
        batch = sorted(r["dt"] for r in window if r.get("name") == "serve.batch")
        if req and batch:
            timings.update(server_p50_ms=1e3 * percentile(req, 50),
                           queue_p50_ms=1e3 * percentile(queue, 50),
                           batch_p50_ms=1e3 * percentile(batch, 50),
                           batches=len(batch))
        log(f"[3n] spawned server mix: p50 {timings['p50_ms']:.3f} ms, p99 "
            f"{timings['p99_ms']:.3f} ms over {sizes['mix_requests']} requests, "
            f"{sizes['clients']} clients; server side p50: serve.request "
            f"{timings.get('server_p50_ms', 0.0):.3f} ms, queue wait "
            f"{timings.get('queue_p50_ms', 0.0):.3f} ms, serve.batch "
            f"{timings.get('batch_p50_ms', 0.0):.3f} ms over "
            f"{timings.get('batches', 0)} batches")
        baseline = srv.get_json("/healthz")[1]["threads"]
        x = mix_keys(rng)

        # torn header
        with ChaosProxy(HOST, srv.port, "wire_torn_header@5") as px:
            try:
                ServeClient(HOST, px.port, timeout=5).sort(x)
                outcome = "reply"
            except (OSError, ConnectionError):
                outcome = "connection error"
        _gate(outcome != "reply", "wire_torn_header: a reply came back")
        _assert_recovered("wire_torn_header", srv, baseline, rng)

        # stalled payload (the slow-loris): shed within the read budget
        t0 = time.monotonic()
        with ChaosProxy(HOST, srv.port, "wire_stall_payload@64") as px:
            try:
                ServeClient(HOST, px.port, timeout=READ_TIMEOUT_S + 8).sort(x)
            except (OSError, ConnectionError):
                pass
            shed = time.monotonic() - t0
        _gate(shed <= READ_TIMEOUT_S + 3.0, f"wire_stall_payload: shed after {shed:.2f} s")
        _assert_recovered("wire_stall_payload", srv, baseline, rng)

        # killed mid-payload: a raw RST halfway through
        big = rng.integers(-2**31, 2**31 - 1, size=sizes["big"], dtype=np.int32)
        hdr = json.dumps({"v": "sortserve.v1", "dtype": "int32",
                          "n": int(big.size)}).encode() + b"\n"
        s = socket.create_connection((HOST, srv.port), timeout=10)
        s.sendall(hdr + big.tobytes()[: big.nbytes // 2])
        time.sleep(0.2)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        s.close()
        _assert_recovered("RST mid-payload", srv, baseline, rng)

        # slow drip: progress on every chunk, the total budget still binds
        with ChaosProxy(HOST, srv.port, "wire_slow_drip@300") as px:
            try:
                r = ServeClient(HOST, px.port, timeout=READ_TIMEOUT_S + 8).sort(big)
                _gate(not r.ok, "wire_slow_drip: served past the read budget")
            except (OSError, ConnectionError):
                pass
        _assert_recovered("wire_slow_drip", srv, baseline, rng)

        # disconnect mid-response: the client's problem
        with ChaosProxy(HOST, srv.port, "wire_disconnect_response@16") as px:
            try:
                ServeClient(HOST, px.port, timeout=10).sort(x)
                outcome = "reply"
            except (OSError, ConnectionError):
                outcome = "short response"
        _gate(outcome != "reply", "wire_disconnect_response: a whole reply came back")
        _assert_recovered("wire_disconnect_response", srv, baseline, rng)

        # connect-then-silence: the resilient client gives up, bounded
        with ChaosProxy(HOST, srv.port, "wire_connect_silence") as px:
            rc_ = ResilientClient(HOST, px.port, connect_timeout=1.0, read_timeout=1.0,
                                  max_attempts=2, backoff_s=0.05)
            t0 = time.monotonic()
            try:
                rc_.sort(x)
                bounded = False
            except (OSError, ConnectionError):
                bounded = time.monotonic() - t0 < 10.0
        _gate(bounded, "wire_connect_silence: the client did not give up in 10 s")
        _assert_recovered("wire_connect_silence", srv, baseline, rng)

        timeouts = metric_total(srv.get("/metrics")[1], "sort_serve_timeouts_total")
        _gate(timeouts >= 2, f"wire: sort_serve_timeouts_total {timeouts}")
        wall, got = _solo(srv, rng.integers(-2**31, 2**31 - 1, size=sizes["solo"],
                                            dtype=np.int32), K1, card,
                          "wire solo, one rank")
        timings.update(solo_s=wall, launches=got, timeouts=timeouts)
        log(f"[3n] wire cells: torn header, stalled payload (shed after {shed:.3f} s), "
            "RST mid-payload, slow drip, disconnect mid-response, connect-then-silence "
            "each recovered (bytes 0, threads at baseline, follow-up equal)")
    finally:
        rc = srv.stop()
    _gate(rc == 0, f"wire: server exited {rc} on SIGTERM: {srv.stderr_tail()}")
    return timings


def watchdog_leg(out: Path, sizes: dict, log: Log, *, card: bool,
                 cmd: "tuple[str, ...] | list[str]" = DRIVER) -> dict:
    """A per-request ``dispatch_stall`` wedges the server's dispatch
    thread past the watchdog bound on eight ranks: trip (``/healthz``
    503), typed fast rejection, half-open recovery without a restart,
    the stalled request served, a flight artifact through ``report
    --check``."""
    flight = out / "flight_watchdog"
    srv = Server(out, "watchdog", {
        "SORT_DEVICES": "8",
        "SORT_SERVE_SHAPE_BUCKETS": "10",
        "SORT_SERVE_ALLOW_FAULTS": "1",
        "SORT_FAULT_STALL_MS": "4000",
        "SORT_SERVE_DISPATCH_TIMEOUT_S": "1",
        "SORT_SERVE_BREAKER_BACKOFF_S": "0.5",
        "SORT_FLIGHT_RECORDER_DIR": str(flight),
    }, cmd)
    timings: dict = {"start_s": srv.start_s}
    rng = np.random.default_rng(13)
    x = rng.integers(-2**31, 2**31 - 1, size=700, dtype=np.int32)
    try:
        with ServeClient(HOST, srv.port) as c:
            _gate(c.sort(x).ok, "watchdog: warm-up")
        stalled: dict = {}

        def stalled_request() -> None:
            try:
                with ServeClient(HOST, srv.port, timeout=60) as c2:
                    stalled["reply"] = c2.sort(x, faults="dispatch_stall")
            except (OSError, ConnectionError) as e:
                stalled["exc"] = e

        t = threading.Thread(target=stalled_request, name="stalled-request",
                             daemon=True)
        t0 = time.perf_counter()
        t.start()
        _gate(wait_until(lambda: srv.get("/healthz")[0] == 503, 3.5),
              "watchdog: never tripped (/healthz stayed 200)")
        timings["trip_s"] = time.perf_counter() - t0
        with ServeClient(HOST, srv.port, timeout=10) as c:
            r = c.sort(x)
        _gate(not r.ok and r.error == "backpressure",
              f"watchdog: the open breaker did not reject typed: {r.header}")
        _gate(wait_until(lambda: srv.get("/healthz")[0] == 200, 20.0),
              "watchdog: the breaker never recovered")
        timings["recover_s"] = time.perf_counter() - t0
        t.join(timeout=30)
        r = stalled.get("reply")
        _gate(r is not None and r.ok and np.array_equal(r.arr, np.sort(x)),
              f"watchdog: the stalled request {stalled}")
        trips = metric_total(srv.get("/metrics")[1], "sort_serve_watchdog_trips_total")
        _gate(trips >= 1, "watchdog: sort_serve_watchdog_trips_total is 0")
        with ServeClient(HOST, srv.port, timeout=30) as c:
            r2 = c.sort(x)
        _gate(r2.ok and np.array_equal(r2.arr, np.sort(x)), "watchdog: after recovery")
        arts = sorted(flight.glob("flight-*-watchdog-*.jsonl"))
        _gate(bool(arts), "watchdog: no flight artifact")
        rc, text = _report("--check", str(arts[-1]))
        _gate(rc == 0, f"watchdog: report --check rejected {arts[-1].name}: {text[-500:]}")
        wall, got = _solo(srv, rng.integers(-2**31, 2**31 - 1, size=sizes["solo"],
                                            dtype=np.int32), K6_K7, card,
                          "watchdog solo, eight ranks")
        timings.update(solo_s=wall, launches=got)
        log(f"[3n] watchdog: tripped after {timings['trip_s']:.3f} s, typed rejection, "
            f"recovered after {timings['recover_s']:.3f} s, artifact passes --check")
    finally:
        rc = srv.stop()
    _gate(rc == 0, f"watchdog: server exited {rc} on SIGTERM: {srv.stderr_tail()}")
    return timings


def hedging_leg(out: Path, sizes: dict, log: Log, *, card: bool,
                cmd: "tuple[str, ...] | list[str]" = DRIVER) -> dict:
    """Injected tail (every 4th connection's response held 700 ms): the
    hedged p99 strictly below the unhedged p99 on the same schedule."""
    srv = Server(out, "hedge", {"SORT_SERVE_SHAPE_BUCKETS": "10",
                                "SORT_SERVE_BATCH_WINDOW_MS": "0"}, cmd)
    timings: dict = {"start_s": srv.start_s}
    rng = np.random.default_rng(17)
    try:
        with ServeClient(HOST, srv.port) as c:
            _gate(c.sort(mix_keys(rng)).ok, "hedging: warm-up")
        spec = f"wire_delay_response@{TAIL_DELAY_MS}:{TAIL_EVERY}"

        def run(hedge: float | None) -> list[float]:
            lats = []
            with ChaosProxy(HOST, srv.port, spec) as px:
                client = ResilientClient(HOST, px.port, read_timeout=30.0,
                                         max_attempts=1, hedge_after_s=hedge)
                for i in range(HEDGE_REQUESTS):
                    a = rng.integers(-2**31, 2**31 - 1, size=512, dtype=np.int32)
                    t0 = time.perf_counter()
                    r = client.sort(a)
                    lats.append(time.perf_counter() - t0)
                    _gate(r.ok and np.array_equal(r.arr, np.sort(a)),
                          f"hedging: reply {i} {r.header}")
            return sorted(lats)

        unhedged = run(None)
        hedged = run(0.1)
        p99_u = 1e3 * percentile(unhedged, 99)
        p99_h = 1e3 * percentile(hedged, 99)
        timings.update(unhedged_p99_ms=p99_u, hedged_p99_ms=p99_h)
        _gate(p99_h < p99_u, f"hedging: hedged p99 {p99_h:.1f} ms not below {p99_u:.1f}")
        wall, got = _solo(srv, rng.integers(-2**31, 2**31 - 1, size=sizes["solo"],
                                            dtype=np.int32), K1, card,
                          "hedging solo, one rank")
        timings.update(solo_s=wall, launches=got)
        log(f"[3n] hedging: p99 {p99_h:.3f} ms hedged < {p99_u:.3f} ms unhedged "
            f"({TAIL_DELAY_MS} ms on every {TAIL_EVERY}th connection)")
    finally:
        rc = srv.stop()
    _gate(rc == 0, f"hedging: server exited {rc} on SIGTERM: {srv.stderr_tail()}")
    return timings


# ------------------------------------------------------------ kill, resume

def journal_run_lines(mpath: Path) -> int:
    """Committed ``run`` lines of a manifest journal (a torn tail is
    skipped, as the loader skips it)."""
    try:
        raw = mpath.read_bytes()
    except OSError:
        return 0
    n = 0
    for ln in raw.split(b"\n"):
        try:
            row = json.loads(ln)
        except (json.JSONDecodeError, UnicodeDecodeError):
            continue
        if isinstance(row, dict) and row.get("kind") == "run":
            n += 1
    return n


def kill_resume_leg(out: Path, sizes: dict, log: Log, *, card: bool,
                    cmd: "tuple[str, ...] | list[str]" = DRIVER) -> dict:
    """An over-admission request reaches the spill tier under an armed
    ``merge_stall``; once every run line is in the journal the server is
    SIGKILLed; a second server on the same spill dir answers the same
    ``dataset_id`` byte for byte from the journal (``resumed: true``, no
    ``external.run`` span, at least one ``external.resume``), and the
    manifest is gone afterwards."""
    from mpitest_tpu_torch.store.external import spill_chunk_elems

    spill = out / "spill"
    shutil.rmtree(spill, ignore_errors=True)
    spill.mkdir(parents=True)
    rng = np.random.default_rng(19)
    x = rng.integers(-2**31, 2**31 - 1, size=sizes["spill"], dtype=np.int32)
    budget = sizes["spill_bytes"]
    n_runs = -(-x.size // spill_chunk_elems(budget, x.dtype, 0))
    mpath = spill / f"{DATASET}.mfst"
    common = {"SORT_SERVE_MAX_BYTES": str(budget), "SORT_MEM_BUDGET": str(budget),
              "SORT_SPILL_DIR": str(spill), "SORT_RESUME": "auto",
              "SORT_SERVE_BATCH_WINDOW_MS": "0", "SORT_SPILL_COMPRESS": "on",
              "SORT_SERVE_SHAPE_BUCKETS": "10"}
    timings: dict = {"runs": n_runs}
    srv1 = Server(out, "durability1", {**common, "SORT_FAULTS": "merge_stall",
                                       "SORT_FAULT_STALL_MS": str(STALL_MS),
                                       "SORT_SERVE_DISPATCH_TIMEOUT_S": "120"}, cmd)
    timings["start1_s"] = srv1.start_s
    victim: dict = {}

    def send_victim() -> None:
        try:
            with ServeClient(HOST, srv1.port, timeout=300) as c:
                victim["reply"] = c.sort(x, dataset_id=DATASET)
        except (OSError, ConnectionError) as e:
            victim["exc"] = e

    t = threading.Thread(target=send_victim, name="durability-victim", daemon=True)
    try:
        t0 = time.perf_counter()
        t.start()
        _gate(wait_until(lambda: journal_run_lines(mpath) >= n_runs
                         or srv1.proc.poll() is not None, 150.0),
              f"kill: {journal_run_lines(mpath)}/{n_runs} run lines journaled")
        _gate(journal_run_lines(mpath) >= n_runs,
              f"kill: the server died first: {srv1.stderr_tail()}")
        timings["journaled_s"] = time.perf_counter() - t0
        got1 = srv1.launches()
        if card:
            _gate(got1.get("bitonic_u32", 0) > 0, f"kill: no K1 chunk sort ({got1})")
    finally:
        srv1.kill()
    t.join(timeout=60)
    _gate("exc" in victim or not getattr(victim.get("reply"), "ok", False),
          f"kill: the victim request was answered {victim}")
    _gate(mpath.exists() and journal_run_lines(mpath) == n_runs,
          "kill: the journal did not survive the crash")

    srv2 = Server(out, "durability2", common, cmd)
    timings["start2_s"] = srv2.start_s
    try:
        t0 = time.perf_counter()
        with ServeClient(HOST, srv2.port, timeout=600) as c:
            r = c.sort(x, dataset_id=DATASET)
        timings["resume_s"] = time.perf_counter() - t0
        _gate(r.ok and np.array_equal(r.arr, np.sort(x)),
              f"resume: reply {getattr(r, 'header', None)}")
        _gate((r.plan or {}).get("resumed") is True, f"resume: plan {r.plan}")
    finally:
        rc = srv2.stop()
    _gate(rc == 0, f"resume: server exited {rc}: {srv2.stderr_tail()}")
    names = [s.get("name") for s in srv2.spans()]
    _gate(names.count("external.run") == 0,
          f"resume: {names.count('external.run')} external.run spans")
    _gate(names.count("external.resume") >= 1, "resume: no external.resume span")
    _gate(not mpath.exists(), "resume: the manifest was not retired")
    timings["launches1"] = got1
    log(f"[3n] kill-resume: {n_runs} runs journaled after {timings['journaled_s']:.3f} s, "
        f"SIGKILL, restart, resumed reply equal after {timings['resume_s']:.3f} s, "
        "no external.run span, manifest retired")
    return timings


# ------------------------------------------------------------ sentinel

def sentinel_cells(out: Path, log: Log) -> dict:
    """The sentinel wired to live metrics and a span log, as the server
    wires it: a clean window raises nothing, an error burst raises one
    critical ``deadline_burn`` with a flight artifact that passes the
    check and a cooldown, repeated skewed exchanges raise
    ``skew_imbalance``."""
    from mpitest_tpu_torch.serve.sentinel import SortSentinel
    from mpitest_tpu_torch.utils import flight_recorder, knobs
    from mpitest_tpu_torch.utils.metrics_live import LiveMetrics, SpanMetricsBridge
    from mpitest_tpu_torch.utils.spans import SpanLog

    out.mkdir(parents=True, exist_ok=True)

    def wired(trace_name: str):
        spans = SpanLog()
        spans.stream_path = str(out / trace_name)
        metrics = LiveMetrics()
        spans.observers.append(SpanMetricsBridge(metrics))
        s = SortSentinel(metrics, spans, window_s=60.0, burn_rate=2.0)
        spans.observers.append(s)
        return spans, metrics, s

    spans, metrics, s = wired("sentinel_clean.jsonl")
    for _ in range(30):
        spans.record("serve.request", time.perf_counter(), 0.01, status="ok", n=4096)
    _gate(not s.alerts, f"sentinel clean: {len(s.alerts)} alert(s)")
    _gate(not any(sp.name == "serve.alert" for sp in spans.spans),
          "sentinel clean: a serve.alert span")

    flight = out / "flight_sentinel"
    with knobs.scoped_env(SORT_FLIGHT_RECORDER_DIR=str(flight)):
        flight_recorder.reset()
        try:
            spans, metrics, s = wired("sentinel_burn.jsonl")
            for _ in range(12):
                spans.record("serve.request", time.perf_counter(), 0.01, status="ok",
                             n=4096)
            for _ in range(6):
                spans.record("serve.request", time.perf_counter(), 0.01,
                             status="deadline", n=4096)
            _gate([a["rule"] for a in s.alerts] == ["deadline_burn"],
                  f"sentinel burn: {[a['rule'] for a in s.alerts]}")
            _gate([a["severity"] for a in s.alerts] == ["critical"],
                  "sentinel burn: not critical")
            _gate('sort_alerts_total{rule="deadline_burn",severity="critical"} 1'
                  in metrics.render_prom(), "sentinel burn: not in sort_alerts_total")
            _gate(sum(1 for sp in spans.spans if sp.name == "serve.alert") == 1,
                  "sentinel burn: serve.alert spans")
            rec = flight_recorder.get()
            _gate(rec.dumps == 1, f"sentinel burn: {rec.dumps} flight dumps")
            dumps = sorted(Path(rec.directory).glob("*.jsonl"), key=lambda p: p.stat().st_mtime)
            _gate(bool(dumps) and report.check_rows(report.load_rows(str(dumps[-1]))) == [],
                  "sentinel burn: the flight artifact fails the check")
            for _ in range(6):
                spans.record("serve.request", time.perf_counter(), 0.01,
                             status="internal", n=4096)
            _gate(len(s.alerts) == 1, f"sentinel cooldown: {len(s.alerts)} alerts")
        finally:
            flight_recorder.reset()

    spans, metrics, s = wired("sentinel_skew.jsonl")
    for _ in range(4):
        spans.record("exchange_balance", time.perf_counter(), 0.0,
                     recv_bytes=[100.0, 100.0, 100.0, 400.0], send_bytes=[175.0] * 4,
                     peer_ratio=4.0, negotiated_cap=256)
    _gate([a["rule"] for a in s.alerts] == ["skew_imbalance"],
          f"sentinel skew: {[a['rule'] for a in s.alerts]}")
    snap = s.snapshot()
    _gate(snap.get("enabled") is True and snap["series"]["imbalance_ewma"] is not None,
          f"sentinel snapshot: {snap}")
    log("[3n] sentinel: clean window silent, burst -> one critical deadline_burn "
        "(flight artifact checked, cooldown held), skew -> skew_imbalance")
    return {"cells": 3}
