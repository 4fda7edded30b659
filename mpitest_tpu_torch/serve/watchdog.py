"""Dispatch watchdog + circuit breaker: the server degrades loudly (port
of ``mpitest_tpu/serve/watchdog.py``).

The serving stack's worst failure mode is a dispatch that never returns:
the single dispatch thread blocks, handler threads pile up on completion
events, admission stays full and ``/healthz`` says 200.  This module makes
the wedge bounded:

* :class:`DispatchWatchdog` — a monotonic heartbeat on the dispatch
  thread (``Batcher._guarded`` brackets every executor call).  When a
  dispatch exceeds ``SORT_SERVE_DISPATCH_TIMEOUT_S`` the watchdog dumps
  the flight recorder (the incident artifact, stuck trace_ids included),
  fails every still-queued request typed ``internal``, and trips the
  breaker.  One trip per stuck dispatch.
* :class:`CircuitBreaker` — while open, ``/healthz`` serves 503 and
  admission turns into fast typed rejections (``backpressure`` with
  reason ``breaker``).  After ``SORT_SERVE_BREAKER_BACKOFF_S`` the
  breaker half-opens: the watchdog sends one tiny probe sort through the
  ordinary dispatch path (``batcher.submit``, so the probe too runs on
  the dispatch thread); success closes the breaker, failure re-opens it
  with doubled backoff (capped).

On the card a wedged CUDA stream cannot be cancelled from the host: the
watchdog can only trip the breaker, fail the queued work and probe.  A
sticky CUDA error (an illegal address) poisons the context for the
process; the request that met it gets ``internal``, and nothing here
tries to recover the context.

Every transition is a registered ``serve.watchdog`` span event
(trip/probe/recovered/reopen), and ``sort_serve_watchdog_trips_total``
counts trips in ``/metrics``.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING

import numpy as np

from mpitest_tpu_torch.utils import flight_recorder

if TYPE_CHECKING:
    from mpitest_tpu_torch.serve.server import ServerCore

#: Breaker backoff growth is capped at this multiple of the base — a
#: long outage probes every few minutes, never backs off to "never".
MAX_BACKOFF_FACTOR = 8.0

#: Probe request size: big enough to exercise a real dispatch, small
#: enough to be free (one cached-bucket packed sort).
PROBE_KEYS = 64


class CircuitBreaker:
    """Three-state breaker: ``closed`` (normal) -> ``open`` (fast
    rejections) -> ``half_open`` (one probe in flight) -> closed or
    back to open with doubled backoff.  All transitions under one lock;
    readers (`engaged`, `state`) are lock-cheap."""

    def __init__(self, backoff_s: float) -> None:
        self.base_backoff_s = float(backoff_s)
        self._lock = threading.Lock()
        self._state = "closed"
        self._backoff_s = self.base_backoff_s
        self._open_until = 0.0
        self.trips = 0
        self.recoveries = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def engaged(self) -> bool:
        """True while admission must fast-reject (open OR half-open —
        during a probe, normal traffic stays out)."""
        with self._lock:
            return self._state != "closed"

    def trip(self) -> bool:
        """Open the breaker; returns False when it was already open
        (the caller skips duplicate incident handling)."""
        with self._lock:
            if self._state != "closed":
                return False
            self._state = "open"
            self._backoff_s = self.base_backoff_s
            self._open_until = time.monotonic() + self._backoff_s
            self.trips += 1
            return True

    def ready_to_probe(self) -> bool:
        """True when the open backoff elapsed and a probe should fly;
        flips the state to half_open (one caller wins)."""
        with self._lock:
            if self._state != "open" or time.monotonic() < self._open_until:
                return False
            self._state = "half_open"
            return True

    def probe_succeeded(self) -> None:
        with self._lock:
            self._state = "closed"
            self._backoff_s = self.base_backoff_s
            self.recoveries += 1

    def probe_failed(self) -> None:
        """Back to open with doubled (capped) backoff."""
        with self._lock:
            self._state = "open"
            self._backoff_s = min(self._backoff_s * 2.0,
                                  self.base_backoff_s * MAX_BACKOFF_FACTOR)
            self._open_until = time.monotonic() + self._backoff_s

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state, "trips": self.trips,
                    "recoveries": self.recoveries,
                    "backoff_s": self._backoff_s,
                    "open_for_s": (round(self._open_until
                                         - time.monotonic(), 3)
                                   if self._state == "open" else 0.0)}


class DispatchWatchdog:
    """The monitor thread.  Started explicitly (``start()``) by the
    server driver and the tests that want it — ``ServerCore`` alone
    never spawns it, so in-process test cores stay thread-clean."""

    def __init__(self, core: "ServerCore", timeout_s: float,
                 breaker: CircuitBreaker) -> None:
        self.core = core
        self.timeout_s = float(timeout_s)
        self.breaker = breaker
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: heartbeat identity (start timestamp) of the dispatch we
        #: already tripped on — one trip per stuck dispatch.
        self._tripped_for: float | None = None
        self._probe_seq = 0

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-watchdog", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- the loop -----------------------------------------------------
    def _poll_interval(self) -> float:
        return max(0.05, min(1.0, self.timeout_s / 4.0))

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_interval()):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the watchdog must not die
                pass           # of a telemetry hiccup mid-incident

    def _tick(self) -> None:
        hb = self.core.batcher.inflight_dispatch()
        if hb is not None:
            age_s, kind, trace_ids = hb
            started_key = time.monotonic() - age_s
            # a spill (out-of-core) dispatch is legitimately long — it
            # streams many small device sorts + a disk merge — so it
            # ages against the COMPLETION bound, not the per-dispatch
            # wedge bound (a wedged device inside it still types out
            # through the per-chunk supervisor)
            bound = (max(self.timeout_s,
                         float(self.core.completion_timeout_s))
                     if kind == "spill" else self.timeout_s)
            if age_s >= bound and (
                    self._tripped_for is None
                    or abs(started_key - self._tripped_for) > 0.5):
                self._tripped_for = started_key
                self._trip(age_s, kind, trace_ids)
        else:
            self._tripped_for = None
        if self.breaker.ready_to_probe():
            self._probe()

    def _event(self, event: str, **attrs: object) -> None:
        self.core.tracer.spans.record("serve.watchdog",
                                      time.perf_counter(), 0.0,
                                      event=event, **attrs)

    def _trip(self, age_s: float, kind: str,
              trace_ids: list[str]) -> None:
        """The incident path, gated on the breaker transition: a wedge
        while the breaker is ALREADY open (e.g. the half-open probe's
        own dispatch wedging) is the SAME incident — no second trip
        event, so `sort_serve_watchdog_trips_total`, the report's trip
        count, `breaker.trips` and the driver exit line all agree."""
        if not self.breaker.trip():
            return
        # audit span first (so the flight dump carries it), then the
        # artifact and the queue purge
        self._event("trip", age_s=round(age_s, 3), kind=kind,
                    trace_ids=list(trace_ids),
                    timeout_s=self.timeout_s)
        self.core.tracer.verbose(
            f"watchdog: {kind} dispatch stuck for {age_s:.1f}s "
            f"(> {self.timeout_s:g}s; trace_ids={trace_ids}); tripping "
            "the circuit breaker")
        flight_recorder.dump_on_error("watchdog")
        failed = self.core.batcher.fail_queued(
            "internal",
            f"dispatch watchdog tripped: a {kind} dispatch exceeded "
            f"{self.timeout_s:g}s; queued work cancelled")
        if failed:
            self.core.tracer.verbose(
                f"watchdog: failed {failed} queued request(s) typed "
                "'internal'")

    def _probe(self) -> None:
        """Half-open probe: one tiny sort through the REAL dispatch
        path.  Completion proves the dispatch thread is alive again."""
        from mpitest_tpu_torch.serve.batching import ServeRequest

        self._probe_seq += 1
        tid = f"watchdog-probe-{self._probe_seq}"
        self._event("probe", trace_id=tid)
        req = ServeRequest(
            arr=np.arange(PROBE_KEYS, 0, -1, dtype=np.int32),
            dtype=np.dtype(np.int32), algo=self.core.default_algo,
            batchable=True, trace_id=tid)
        self.core.batcher.submit(req)
        ok = req.done.wait(max(self.timeout_s, 1.0)) and req.error is None
        if ok:
            self.breaker.probe_succeeded()
            self._event("recovered", trace_id=tid)
            self.core.tracer.verbose(
                "watchdog: probe sort completed; breaker closed")
        else:
            self.breaker.probe_failed()
            self._event("reopen", trace_id=tid,
                        detail=(req.error[1] if req.error
                                else "probe timed out"))
            self.core.tracer.verbose(
                "watchdog: probe failed; breaker re-opened "
                f"(backoff {self.breaker.snapshot()['backoff_s']:g}s)")

    def snapshot(self) -> dict:
        return {"enabled": self.enabled, "timeout_s": self.timeout_s,
                "running": self._thread is not None,
                "probes": self._probe_seq,
                **{f"breaker_{k}": v
                   for k, v in self.breaker.snapshot().items()}}
