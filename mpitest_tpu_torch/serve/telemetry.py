"""Live telemetry endpoints + device profiling hook for the sort server
(port of ``mpitest_tpu/serve/telemetry.py``).

The serving process is observable while it serves: a side-port HTTP
server (``SORT_METRICS_PORT``) exposes

* ``GET /metrics`` — Prometheus text exposition of the live registry
  (``utils/metrics_live.py``);
* ``GET /healthz`` — liveness JSON; HTTP 200 while serving, 503 once
  draining or while the circuit breaker is open;
* ``GET /varz`` — configuration + internal state: every explicitly-set
  knob, the mesh, executor-cache/admission/batcher/flight-recorder
  state, the plan snapshot, the planner, the profiler and the kernel
  launch counts of the process (``kernels.launches``);
* ``GET /alerts`` — the sentinel's alert history and series;
* ``GET /flightrecorder`` — the in-memory span ring as span-schema
  JSONL (``?dump=1`` also writes a timestamped artifact to
  ``SORT_FLIGHT_RECORDER_DIR`` and reports its path);
* ``GET /profile?n=K`` — arm a ``torch.profiler`` capture of the next K
  dispatches (into ``SORT_PROFILE``, else ``<flight dir>/profile``).

The handler threads only read shared state; a scrape never touches the
card and never blocks a dispatch.

:class:`ProfileHook` is the dispatch-side half: an endpoint-armed or
every-Nth (``SORT_PROFILE_EVERY``) capture around exactly one dispatch
through ``utils/trace.torch_profile`` (the reference uses
``jax.profiler``), recorded as a ``serve.profile`` span event.  A
profiler failure (at start, or a capture of a card run that holds no
CUDA event) is counted in ``failed`` and shown in ``/varz``; it never
fails a request.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TYPE_CHECKING, Any, Iterator
from urllib.parse import parse_qs, urlparse

from mpitest_tpu_torch.utils import flight_recorder, knobs
from mpitest_tpu_torch.utils.metrics_live import PROM_CONTENT_TYPE

if TYPE_CHECKING:
    from mpitest_tpu_torch.serve.server import ServerCore
    from mpitest_tpu_torch.utils.spans import SpanLog


class ProfileHook:
    """Decides, per dispatch, whether to wrap it in a ``torch.profiler``
    capture; owns the armed-count (endpoint) and every-Nth
    (``SORT_PROFILE_EVERY``) triggers.  ``devices`` are the mesh's: a
    capture records CUDA activity when one of them is a card."""

    def __init__(self, spans: "SpanLog", devices: Any = None) -> None:
        self.spans = spans
        self.devices = devices
        self.every = knobs.get("SORT_PROFILE_EVERY")
        self.logdir = knobs.get("SORT_PROFILE") or os.path.join(
            knobs.get("SORT_FLIGHT_RECORDER_DIR"), "profile")
        self.captures = 0
        self.failed = 0
        self._armed = 0
        self._seq = 0
        self._lock = threading.Lock()

    def arm(self, n: int = 1) -> int:
        """Endpoint trigger: capture the next ``n`` dispatches."""
        with self._lock:
            self._armed += max(0, int(n))
            return self._armed

    def _should_capture(self) -> str | None:
        with self._lock:
            self._seq += 1
            if self._armed > 0:
                self._armed -= 1
                return "endpoint"
            if self.every and self._seq % self.every == 0:
                return "every"
        return None

    @contextlib.contextmanager
    def maybe_capture(self) -> Iterator[bool]:
        """Wrap one dispatch; yields True when a capture is live.  An
        exception of the dispatch itself propagates unchanged."""
        trigger = self._should_capture()
        if trigger is None:
            yield False
            return
        from mpitest_tpu_torch.utils.trace import torch_profile

        logdir = os.path.join(self.logdir, f"capture-{self._seq:05d}")
        try:
            cm = torch_profile(logdir, self.devices)
            cm.__enter__()
        except Exception:  # noqa: BLE001 — profiling never fails a request
            self.failed += 1
            yield False
            return
        t0 = time.perf_counter()
        exc: BaseException | None = None
        try:
            yield True
        except BaseException as e:
            exc = e
            raise
        finally:
            try:
                # the dispatch's own exception goes into the profiler's
                # exit and propagates unchanged
                cm.__exit__(type(exc) if exc else None, exc,
                            exc.__traceback__ if exc else None)
            except Exception:  # noqa: BLE001
                self.failed += 1
            self.captures += 1
            self.spans.record("serve.profile", t0,
                              time.perf_counter() - t0,
                              logdir=logdir, trigger=trigger,
                              seq=self._seq)

    def state(self) -> dict:
        with self._lock:
            return {"every": self.every, "logdir": self.logdir,
                    "armed": self._armed, "captures": self.captures,
                    "failed": self.failed}


def plan_snapshot(rows: "list[dict]") -> dict:
    """Rolling decision snapshot from the flight-recorder
    ring: fold the ring's recent ``sort.plan`` spans into plan counts
    per algorithm, mean/max regret per decision, and the latest plan's
    compact view — the traffic profile the self-tuning planner will
    consume, already shaped for ``/varz``."""
    from mpitest_tpu_torch.models.plan import fold_decision_stats

    plans = [r for r in rows if r.get("name") == "sort.plan"]
    by_algo: dict[str, int] = {}
    total_regret = 0.0
    for p in plans:
        attrs = p.get("attrs") or {}
        algo = str(attrs.get("algo", "?"))
        by_algo[algo] = by_algo.get(algo, 0) + 1
        total_regret += float(attrs.get("regret", 0.0) or 0.0)
    dec = fold_decision_stats([p.get("attrs") or {} for p in plans])
    out: dict = {
        "plans": len(plans),
        "by_algo": by_algo,
        "mean_regret": (round(total_regret / len(plans), 6)
                        if plans else 0.0),
        "decisions": {
            name: {"count": row["count"],
                   "mean_regret": round(row["regret_sum"] / row["count"],
                                        6),
                   "max_regret": round(row["regret_max"], 6)}
            for name, row in sorted(dec.items())},
    }
    if plans:
        last = plans[-1].get("attrs") or {}
        out["last"] = {"algo": last.get("algo"),
                       "regret": last.get("regret"),
                       "profile": last.get("profile")}
    return out


def _set_knobs() -> dict[str, str]:
    """Every registered knob explicitly set in this process's
    environment (raw values) — the /varz configuration view.  Defaults
    are documented in README; varz shows what this server was told."""
    out = {}
    for k in knobs.iter_knobs():
        raw = knobs.get_raw(k.name)
        if raw is not None:
            out[k.name] = raw
    return out


def _kernel_launches() -> dict[str, int]:
    """``ops/_build.LAUNCHES`` (a copy; the counts are plain ints)."""
    from mpitest_tpu_torch.ops import _build

    return dict(_build.LAUNCHES)


class _Handler(BaseHTTPRequestHandler):
    server: "TelemetryServer"  # type: ignore[assignment]

    #: silence the default per-request stderr logging (a scrape every
    #: few seconds would swamp the server log)
    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        pass

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj: object) -> None:
        self._reply(code, (json.dumps(obj, indent=1) + "\n").encode(),
                    "application/json")

    def do_GET(self) -> None:  # noqa: N802 — http.server contract
        try:
            url = urlparse(self.path)
            route = url.path.rstrip("/") or "/"
            if route == "/metrics":
                body = self.server.core.metrics.render_prom().encode()
                self._reply(200, body, PROM_CONTENT_TYPE)
            elif route == "/healthz":
                self._healthz()
            elif route == "/varz":
                self._varz()
            elif route == "/flightrecorder":
                self._flightrecorder(parse_qs(url.query))
            elif route == "/profile":
                self._profile(parse_qs(url.query))
            elif route == "/alerts":
                self._alerts()
            else:
                self._json(404, {"error": f"unknown path {route!r}",
                                 "routes": ["/metrics", "/healthz",
                                            "/varz", "/flightrecorder",
                                            "/profile", "/alerts"]})
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 — a scrape bug must not kill
            try:                # the handler thread pool
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            except OSError:
                pass

    def _healthz(self) -> None:
        core = self.server.core
        draining = core.admission.draining
        breaker = core.breaker.state
        # 503 while draining OR while the breaker is open/half-open
        #: load balancers must stop routing to a server
        # whose dispatch is wedged, not just one that is shutting down.
        healthy = not draining and breaker == "closed"
        self._json(200 if healthy else 503, {
            "ok": healthy,
            "draining": draining,
            "breaker": breaker,
            "uptime_s": round(time.time() - core.started, 3),
            "inflight": core.admission.inflight,
            "requests_ok": core.requests_ok,
            "requests_err": core.requests_err,
            # live thread census: the chaos gate asserts handler
            # threads are reclaimed after every wire-fault cell
            "threads": threading.active_count(),
            "pid": os.getpid(),
        })

    def _varz(self) -> None:
        core = self.server.core
        mesh_devs = list(core.mesh.devices)
        rec = flight_recorder.get()
        self._json(200, {
            "knobs_set": _set_knobs(),
            "mesh": {"devices": len(mesh_devs),
                     "platform": mesh_devs[0].type if mesh_devs
                     else "?"},
            "cache": core.cache.snapshot(),
            "admission": core.admission.snapshot(),
            "batcher": {"batches": core.batcher.batches,
                        "batched_requests": core.batcher.batched_requests,
                        "solo_requests": core.batcher.solo_requests,
                        "deadline_cancelled":
                            core.batcher.deadline_cancelled,
                        "window_s": core.batcher.window_s,
                        "batch_keys": core.batcher.batch_keys},
            "watchdog": core.watchdog.snapshot(),
            "flight_recorder": {"capacity": rec.capacity,
                                "recorded": rec.recorded,
                                "dumps": rec.dumps,
                                "dir": rec.directory},
            # rolling decision snapshot, fed from the ring —
            # the traffic profile the self-tuning planner consumes
            "plans": plan_snapshot(rec.snapshot()),
            # self-tuning planner state: mode + the serve
            # tuner's rolling-mix view and retune history
            "planner": {
                "mode": core.planner_mode,
                "tuner": (core.tuner.snapshot()
                          if core.tuner is not None else None),
                "window_retunes": core.batcher.window_retunes,
            },
            "profiler": core.profiler.state(),
            # kernel launches of this process, so a caller in another
            # process can see which kernels its requests ran
            "kernels": {"launches": _kernel_launches()},
            "requests": {"ok": core.requests_ok,
                         "err": core.requests_err},
            "uptime_s": round(time.time() - core.started, 3),
        })

    def _alerts(self) -> None:
        # streaming-sentinel snapshot: alert history + the
        # rolling-window series state; a router balances on this
        sentinel = getattr(self.server.core, "sentinel", None)
        if sentinel is None:
            self._json(200, {"enabled": False, "alerts": [],
                             "alerts_total": 0})
            return
        self._json(200, sentinel.snapshot())

    def _flightrecorder(self, query: dict) -> None:
        rec = flight_recorder.get()
        if query.get("dump", ["0"])[0] == "1":
            path = rec.dump("endpoint")
            self._json(200 if path else 409,
                       {"dumped": path is not None, "path": path,
                        "spans": len(rec.ring)})
            return
        body = "\n".join(json.dumps(d) for d in rec.snapshot())
        self._reply(200, (body + "\n").encode() if body else b"",
                    "application/jsonl")

    def _profile(self, query: dict) -> None:
        try:
            n = int(query.get("n", ["1"])[0])
        except ValueError:
            self._json(400, {"error": "n must be an integer"})
            return
        if not 1 <= n <= 1000:
            self._json(400, {"error": "n must be in [1, 1000]"})
            return
        armed = self.server.core.profiler.arm(n)
        self._json(200, {"armed": armed,
                         "logdir": self.server.core.profiler.logdir})


class TelemetryServer(ThreadingHTTPServer):
    """The side-port HTTP server.  Never binds the wire-protocol port;
    ``SORT_METRICS_PORT=0`` picks an ephemeral port (printed by the
    driver), ``-1`` disables construction entirely (the driver's
    choice, not this class's)."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, core: "ServerCore", host: str, port: int) -> None:
        super().__init__((host, port), _Handler)
        self.core = core

    @property
    def bound_port(self) -> int:
        return int(self.server_address[1])

    def start(self) -> None:
        t = threading.Thread(target=self.serve_forever,
                             name="serve-telemetry", daemon=True)
        t.start()
