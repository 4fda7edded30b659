"""Admission control: bounded in-flight work with typed backpressure
(port of ``mpitest_tpu/serve/admission.py``; stdlib only).

A server without admission control has a failure mode worse than
rejection: the queue grows until host memory (or the batch window's
latency SLO) dies.  This module bounds BOTH axes the sort server cares
about — concurrent request count (``SORT_SERVE_MAX_INFLIGHT``) and
total in-flight payload bytes (``SORT_SERVE_MAX_BYTES``) — and turns an
over-limit arrival into a :class:`AdmissionReject` whose ``reason`` is
machine-readable, so clients can tell "back off" (``inflight`` /
``bytes``) from "the server is going away" (``draining``).

The protocol maps a rejection to one typed error response; nothing
about an over-limit request ever reaches the device."""

from __future__ import annotations

import threading


class AdmissionReject(RuntimeError):
    """Typed backpressure rejection.  ``reason`` ∈ {"inflight",
    "bytes", "draining", "breaker"}; the wire protocol forwards it
    verbatim.  ("breaker" is raised by ``ServerCore._admit`` when the
    dispatch watchdog's circuit breaker is open — and is
    tallied here via :meth:`AdmissionControl.note_reject` so the
    rejected count covers breaker-open incidents too.)"""

    def __init__(self, reason: str, detail: str) -> None:
        super().__init__(detail)
        self.reason = reason


class AdmissionControl:
    """Counting admission gate.  ``admit(nbytes)`` either reserves
    capacity or raises :class:`AdmissionReject`; ``release(nbytes)``
    returns it (call exactly once per successful admit — the server's
    request handler does both in one try/finally)."""

    def __init__(self, max_inflight: int, max_bytes: int) -> None:
        self.max_inflight = int(max_inflight)
        self.max_bytes = int(max_bytes)
        self.inflight = 0
        self.inflight_bytes = 0
        self.rejected = 0
        self.admitted = 0
        self.draining = False
        #: observer called with (inflight, inflight_bytes) UNDER the
        #: admission lock on every admit/release — the server points it
        #: at the live in-flight gauges.  Publishing inside
        #: the lock means gauge writes are ordered exactly like the
        #: state changes; a read-then-set outside it could leave a
        #: phantom in-flight count exported forever on an idle server.
        self.on_change = None
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)

    def _changed(self) -> None:
        if self.on_change is not None:
            self.on_change(self.inflight, self.inflight_bytes)

    def admit(self, nbytes: int) -> None:
        with self._lock:
            if self.draining:
                self.rejected += 1
                raise AdmissionReject(
                    "draining", "server is draining (SIGTERM received); "
                    "not accepting new work")
            if self.inflight + 1 > self.max_inflight:
                self.rejected += 1
                raise AdmissionReject(
                    "inflight",
                    f"in-flight request limit reached "
                    f"({self.max_inflight}); retry with backoff")
            if self.inflight_bytes + nbytes > self.max_bytes:
                self.rejected += 1
                raise AdmissionReject(
                    "bytes",
                    f"in-flight byte limit reached ({self.max_bytes}); "
                    "retry with backoff")
            self.inflight += 1
            self.inflight_bytes += nbytes
            self.admitted += 1
            self._changed()

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.inflight -= 1
            self.inflight_bytes -= nbytes
            self._changed()
            if self.inflight == 0:
                self._idle.notify_all()

    def note_reject(self) -> None:
        """Count a rejection decided OUTSIDE this gate (the circuit
        breaker's fast path) so ``rejected`` stays the one total the
        driver's exit line and /varz report."""
        with self._lock:
            self.rejected += 1

    def snapshot(self) -> dict:
        """Point-in-time state for the live /varz endpoint."""
        with self._lock:
            return {"inflight": self.inflight,
                    "inflight_bytes": self.inflight_bytes,
                    "max_inflight": self.max_inflight,
                    "max_bytes": self.max_bytes,
                    "admitted": self.admitted,
                    "rejected": self.rejected,
                    "draining": self.draining}

    def start_drain(self) -> None:
        """Flip to draining: every subsequent admit is a typed
        rejection; in-flight work is unaffected."""
        with self._lock:
            self.draining = True

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until no requests are in flight (the SIGTERM drain
        barrier).  Returns False on timeout."""
        with self._lock:
            return self._idle.wait_for(lambda: self.inflight == 0,
                                       timeout=timeout)
