"""Streaming SLO sentinel: live anomaly detection over the span stream
(port of ``mpitest_tpu/serve/sentinel.py``).

``report.py --doctor`` diagnoses a trace after the run; a serving replica
needs the same verdicts while it serves.  The sentinel is a rolling
multi-window evaluator fed from the ``SpanLog.observers`` hook (appended
right after :class:`~mpitest_tpu_torch.utils.metrics_live.SpanMetricsBridge`
in ``ServerCore.__init__``), tracking

* error-budget **burn rate** over the rolling window plus **p99 drift**
  against a long-horizon EWMA (the ``deadline_burn`` rule);
* per-exchange **imbalance** (``exchange_balance`` peer ratios) with EWMA
  smoothing (``skew_imbalance``);
* capacity **regrow accumulation** (``sort.plan`` cap decisions)
  (``cap_thrash``);
* breaker **flapping** (``serve.watchdog`` trips) (``breaker_flap``,
  critical).

Every alert is a registered ``serve.alert`` span (so it rides the trace
stream, the flight-recorder ring and the bridge into
``sort_alerts_total{rule,severity}``) and is kept in a bounded deque the
``/alerts`` endpoint snapshots.  Critical alerts dump the flight
recorder.  Rule names and thresholds are the port's doctor's
(:data:`mpitest_tpu_torch.doctor.DOCTOR_RULES` and its constants), so
post-hoc and live diagnosis agree.

Knobs: ``SORT_SENTINEL={on,off}``, ``SORT_SENTINEL_WINDOW_S``,
``SORT_ALERT_BURN_RATE``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque

from mpitest_tpu_torch import doctor
from mpitest_tpu_torch.utils import span_schema
from mpitest_tpu_torch.utils.metrics_live import LiveMetrics
from mpitest_tpu_torch.utils.spans import Span, SpanLog

#: Minimum ok-latency samples before quantile drift is evaluated.
MIN_DRIFT_SAMPLES = 10
#: p99-vs-EWMA multiple that raises latency drift.
DRIFT_FACTOR = 2.0
#: EWMA smoothing weight (per evaluation, not per second — the window
#: already bounds the horizon).
EWMA_ALPHA = 0.3
#: Imbalance samples before the EWMA is trusted.
MIN_IMBALANCE_SAMPLES = 3
#: Bounded alert history the /alerts endpoint snapshots.
MAX_ALERTS = 256


def _p99(samples: list[float]) -> float:
    s = sorted(samples)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


class SortSentinel:
    """Span-close observer raising registered ``serve.alert`` events.

    Thread-safety: span closes arrive on every handler thread; one
    lock guards the series deques and alert history.  Emitting the
    alert span re-enters ``SpanLog._flush`` (observers run before the
    stream write, no lock is held), so the observer ignores its own
    ``serve.alert`` spans to terminate the recursion at depth one.
    """

    def __init__(self, metrics: LiveMetrics, spans: SpanLog, *,
                 window_s: float, burn_rate: float,
                 slo_target_pct: float = doctor.DEFAULT_SLO_TARGET_PCT,
                 ) -> None:
        self.metrics = metrics
        self.spans = spans
        self.window_s = float(window_s)
        self.burn_threshold = float(burn_rate)
        self.slo_target_pct = float(slo_target_pct)
        self.alerts: Deque[dict[str, Any]] = deque(maxlen=MAX_ALERTS)
        self._lock = threading.Lock()
        # rolling series: (monotonic t, payload)
        self._requests: Deque[tuple[float, bool, float]] = deque()
        self._regrows: Deque[tuple[float, int]] = deque()
        self._trips: Deque[float] = deque()
        self._p99_ewma: float | None = None
        self._imbalance_ewma: float | None = None
        self._imbalance_n = 0
        self._last_alert: dict[str, float] = {}
        self.alerts_total = 0

    # -- observer entry ----------------------------------------------
    def __call__(self, span: Span) -> None:
        name = getattr(span, "name", "")
        if name == span_schema.SERVE_ALERT_SPAN:
            return  # our own emission re-entering the flush hook
        attrs = getattr(span, "attrs", None) or {}
        now = time.monotonic()
        if name == span_schema.SERVE_REQUEST_SPAN:
            ok = str(attrs.get("status", "?")) == "ok"
            self._on_request(now, ok, float(span.dt or 0.0))
        elif name == span_schema.BALANCE_SPAN:
            self._on_balance(now, attrs)
        elif name == span_schema.PLAN_SPAN:
            self._on_plan(now, attrs)
        elif name == span_schema.SERVE_WATCHDOG_SPAN:
            if str(attrs.get("event", "?")) == "trip":
                self._on_trip(now)

    # -- per-signal detectors ----------------------------------------
    def _on_request(self, now: float, ok: bool, dt_s: float) -> None:
        with self._lock:
            self._requests.append((now, ok, dt_s))
            self._gc(self._requests, now)
            win = list(self._requests)
        n = len(win)
        if n < doctor.BURN_MIN_REQUESTS:
            return
        errors = sum(1 for _t, k, _d in win if not k)
        allowance = max(100.0 - self.slo_target_pct, 1e-9)
        burn = (100.0 * errors / n) / allowance
        if errors and burn >= self.burn_threshold:
            sev = ("critical" if burn >= 2 * self.burn_threshold
                   else "warn")
            self._alert(
                "deadline_burn", sev,
                f"burn rate {burn:.1f}x allowance ({errors}/{n} non-ok "
                f"in the last {self.window_s:g}s window)",
                value=round(burn, 4), threshold=self.burn_threshold)
            return
        lats = [d * 1e3 for _t, k, d in win if k]
        if len(lats) < MIN_DRIFT_SAMPLES:
            return
        p99 = _p99(lats)
        with self._lock:
            ewma = self._p99_ewma
            if ewma is None:
                self._p99_ewma = p99
                return
            drifted = p99 > DRIFT_FACTOR * ewma and ewma > 0
            self._p99_ewma = EWMA_ALPHA * p99 + (1 - EWMA_ALPHA) * ewma
        if drifted:
            self._alert(
                "deadline_burn", "warn",
                f"p99 latency drift: {p99:.1f}ms vs {ewma:.1f}ms "
                f"EWMA ({p99 / ewma:.1f}x)",
                value=round(p99 / ewma, 4), threshold=DRIFT_FACTOR)

    def _on_balance(self, now: float, attrs: dict) -> None:
        ratio = attrs.get("peer_ratio", attrs.get("recv_ratio"))
        if not isinstance(ratio, (int, float)) or ratio <= 0:
            return
        with self._lock:
            ewma = self._imbalance_ewma
            self._imbalance_ewma = (
                float(ratio) if ewma is None
                else EWMA_ALPHA * float(ratio) + (1 - EWMA_ALPHA) * ewma)
            self._imbalance_n += 1
            smoothed = self._imbalance_ewma
            samples = self._imbalance_n
        if samples >= MIN_IMBALANCE_SAMPLES and \
                smoothed >= doctor.SKEW_FACTOR_WARN:
            sev = ("critical" if smoothed >= doctor.SKEW_FACTOR_CRITICAL
                   else "warn")
            self._alert(
                "skew_imbalance", sev,
                f"exchange imbalance EWMA {smoothed:.2f}x over "
                f"{samples} exchanges",
                value=round(smoothed, 4),
                threshold=doctor.SKEW_FACTOR_WARN)

    def _on_plan(self, now: float, attrs: dict) -> None:
        decisions = attrs.get("decisions")
        cap = (decisions or {}).get("cap") \
            if isinstance(decisions, dict) else None
        actual = cap.get("actual") if isinstance(cap, dict) else None
        n = actual.get("regrows") if isinstance(actual, dict) else None
        if not isinstance(n, (int, float)) or n <= 0:
            return
        with self._lock:
            self._regrows.append((now, int(n)))
            self._gc(self._regrows, now)
            total = sum(k for _t, k in self._regrows)
        if total >= doctor.CAP_REGROW_GATE:
            self._alert(
                "cap_thrash", "warn",
                f"{total} exchange-cap regrow(s) in the last "
                f"{self.window_s:g}s window",
                value=float(total),
                threshold=float(doctor.CAP_REGROW_GATE))

    def _on_trip(self, now: float) -> None:
        with self._lock:
            self._trips.append(now)
            while self._trips and self._trips[0] < now - self.window_s:
                self._trips.popleft()
            trips = len(self._trips)
        if trips >= doctor.BREAKER_TRIP_GATE:
            self._alert(
                "breaker_flap", "critical",
                f"{trips} breaker trip(s) in the last "
                f"{self.window_s:g}s window",
                value=float(trips),
                threshold=float(doctor.BREAKER_TRIP_GATE))

    def _gc(self, series: Deque, now: float) -> None:
        cutoff = now - self.window_s
        while series and series[0][0] < cutoff:
            series.popleft()

    # -- alert emission ----------------------------------------------
    def _alert(self, rule: str, severity: str, summary: str, *,
               value: float, threshold: float) -> None:
        if rule not in doctor.DOCTOR_RULES:     # computed-name guard
            raise KeyError(f"unregistered doctor rule: {rule!r}")
        now = time.monotonic()
        with self._lock:
            last = self._last_alert.get(rule)
            if last is not None and now - last < self.window_s:
                return  # per-rule cooldown: one alert per window
            self._last_alert[rule] = now
            self.alerts_total += 1
            self.alerts.append({
                "ts": time.time(), "rule": rule, "severity": severity,
                "summary": summary, "value": value,
                "threshold": threshold, "window_s": self.window_s,
            })
        # registered span: rides the trace stream, the flight ring and
        # the bridge (sort_alerts_total) — observers ignore it here
        self.spans.record(
            "serve.alert", time.perf_counter(), 0.0,
            rule=rule, severity=severity, value=value,
            threshold=threshold, window_s=self.window_s,
            summary=summary)
        if severity == "critical":
            # evidence window to disk before anyone asks; the recorder
            # rate-limits and never raises
            from mpitest_tpu_torch.utils.flight_recorder import dump_on_error
            dump_on_error(f"sentinel_{rule}")

    # -- /alerts snapshot --------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            win = [r for r in self._requests]
            errors = sum(1 for _t, k, _d in win if not k)
            lats = [d * 1e3 for _t, k, d in win if k]
            return {
                "enabled": True,
                "window_s": self.window_s,
                "burn_threshold": self.burn_threshold,
                "slo_target_pct": self.slo_target_pct,
                "alerts_total": self.alerts_total,
                "alerts": list(self.alerts),
                "series": {
                    "window_requests": len(win),
                    "window_errors": errors,
                    "p99_ms": (round(_p99(lats), 3) if lats else None),
                    "p99_ewma_ms": (round(self._p99_ewma, 3)
                                    if self._p99_ewma is not None
                                    else None),
                    "imbalance_ewma": (round(self._imbalance_ewma, 4)
                                       if self._imbalance_ewma is not None
                                       else None),
                    "window_regrows": sum(k for _t, k in self._regrows),
                    "window_trips": len(self._trips),
                },
            }
