"""Live metrics registry — the scrapeable counterpart of the span stream
(port of ``mpitest_tpu/utils/metrics_live.py``).

The span/JSONL layer (``utils/spans.py``) is post-hoc: spans land in a
file and ``report.py`` reads it after the process exits.  A serving
process needs the live view (queue depth, cache hit ratio, p99 drift)
without being stopped first.  This module is that view: a stdlib-only
registry of counters, gauges and fixed-bucket latency histograms, updated
from the span-close path (:class:`SpanMetricsBridge`) and the serve hot
paths, rendered as Prometheus text exposition by the server's
``/metrics`` endpoint (``serve/telemetry.py``).

Metric names are registered here (:data:`METRICS`) with the reference's
names, types and buckets, so a scrape of the port's server and one of
the reference's carry the same families and values for the same span
sequence; an unregistered name is a ``KeyError``.

Updates take one registry lock around plain dict/float operations.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Iterator

#: Exposition content type (the Prometheus text format this module
#: renders and parses).
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Fixed latency buckets (seconds) — request latency / queue wait.
#: Spanning 1 ms .. 60 s: below serving resolution to far past any SLO.
LATENCY_BUCKETS_S: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: Fixed batch-occupancy buckets (segments packed per dispatch).
OCCUPANCY_BUCKETS: tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64)

#: The registered metric vocabulary: name -> (type, help).  Histograms
#: carry their bucket set in :data:`_HISTOGRAM_BUCKETS`.
METRICS: dict[str, tuple[str, str]] = {
    # serve request path
    "sort_serve_requests_total": (
        "counter", "Served requests by terminal status (label: status)."),
    "sort_serve_request_latency_seconds": (
        "histogram", "End-to-end request latency (successful requests)."),
    "sort_serve_queue_wait_seconds": (
        "histogram", "Admission-to-dispatch queue wait per request."),
    "sort_serve_rejected_total": (
        "counter", "Admission rejections by typed reason (label: reason)."),
    "sort_serve_inflight": (
        "gauge", "Requests currently admitted and in flight."),
    "sort_serve_inflight_bytes": (
        "gauge", "Payload bytes currently admitted and in flight."),
    # batching / dispatch
    "sort_serve_batches_total": (
        "counter", "Packed multi-tenant dispatches."),
    "sort_serve_batch_segments": (
        "histogram", "Segments (tenants) packed per dispatch."),
    "sort_serve_batch_keys_total": (
        "counter", "Keys dispatched through the packed path."),
    "sort_serve_batch_fallbacks_total": (
        "counter", "Whole-batch dispatch failures (every tenant re-ran "
                   "solo)."),
    "sort_serve_segment_requeues_total": (
        "counter", "Segments that failed verification and re-ran solo."),
    # request-lifecycle robustness
    "sort_serve_timeouts_total": (
        "counter", "Wire timeouts enforced (label: kind=idle|read|"
                   "write) — stalled/half-dead connections closed."),
    "sort_serve_deadline_exceeded_total": (
        "counter", "Requests cancelled before dispatch because their "
                   "deadline_ms expired (label: stage)."),
    "sort_serve_watchdog_trips_total": (
        "counter", "Dispatch-watchdog trips (a dispatch exceeded "
                   "SORT_SERVE_DISPATCH_TIMEOUT_S; breaker opened)."),
    "sort_serve_drain_timeout_total": (
        "counter", "SIGTERM drains that timed out with work still in "
                   "flight (the server exited rc=1)."),
    "sort_client_hedges_total": (
        "counter", "Client-side hedged requests (second attempt fired "
                   "after the latency threshold)."),
    # executor cache
    "sort_serve_cache_hits_total": (
        "counter", "Executor-cache hits."),
    "sort_serve_cache_misses_total": (
        "counter", "Executor-cache misses (AOT compiles on the request "
                   "path)."),
    "sort_serve_compile_seconds_total": (
        "counter", "Seconds spent compiling executors on cache misses."),
    # robustness (supervisor + verifier, span-close fed)
    "sort_verify_runs_total": ("counter", "Output verifications run."),
    "sort_verify_failures_total": (
        "counter", "Output verifications that FAILED."),
    "sort_verify_seconds_total": (
        "counter", "Wall seconds spent in output verification "
                   "(the verify overhead)."),
    "sort_retries_total": (
        "counter", "Supervisor dispatch retries."),
    "sort_faults_total": (
        "counter", "Injected faults fired (label: site)."),
    # scale-out exchange balance (the negotiation probe)
    "sort_exchange_recv_ratio": (
        "gauge", "Last exchange's recv max/mean byte ratio."),
    "sort_exchange_peer_ratio": (
        "gauge", "Last exchange's max single-peer/fair-share ratio."),
    "sort_exchange_negotiated_cap": (
        "gauge", "Last negotiated exchange capacity (keys per peer)."),
    "sort_exchange_worst_cap": (
        "gauge", "Worst-case exchange capacity the negotiation beat."),
    "sort_exchange_rank_recv_bytes": (
        "gauge", "Last exchange's per-rank received bytes (label: rank)."),
    "sort_exchange_rank_send_bytes": (
        "gauge", "Last exchange's per-rank sent bytes (label: rank)."),
    # profiling / flight recorder
    "sort_profile_captures_total": (
        "counter", "On-demand torch.profiler captures taken."),
    "sort_flight_dumps_total": (
        "counter", "Flight-recorder artifacts dumped."),
    # streaming sentinel: serve.alert spans bridged by rule + severity;
    # rule names are the doctor.DOCTOR_RULES vocabulary
    "sort_alerts_total": (
        "counter", "Sentinel anomaly alerts raised (labels: rule, "
                   "severity)."),
    # plan provenance: predicted-vs-actual regret per
    # decision, exported live so mis-sized caps / wasted restages /
    # wrong reroutes are visible in /metrics before they cost
    # throughput.  Fed from sort.plan span closes by the bridge.
    "sort_plans_total": (
        "counter", "Finished plan records (label: algo)."),
    "sort_plan_regret": (
        "gauge", "Last plan's total predicted-vs-actual regret."),
    "sort_plan_decision_regret": (
        "gauge", "Last plan's regret per decision (label: decision)."),
    "sort_plan_cap_regret": (
        "gauge", "Last plan's exchange-cap regret (|cap-need|/need + "
                 "overflow regrows) — rises when negotiation is off or "
                 "mis-predicts."),
    "sort_plan_reroutes_total": (
        "counter", "Plans whose algorithm was rerouted away from the "
                   "requested one (label: trigger)."),
    # self-tuning planner: the policy layer's own telemetry
    # — a bad policy is visible here before it costs throughput.
    "sort_planner_decisions_total": (
        "counter", "Planner policy decisions (labels: policy, "
                   "applied) — shadow decisions count with "
                   "applied=\"false\"."),
    "sort_planner_regret": (
        "gauge", "Last plan's planner-decision regret (the planner's "
                 "own cost: wasted passthrough verifies) — rises when "
                 "the policy chooses worse than the best-known "
                 "config."),
    "sort_serve_window_retunes_total": (
        "counter", "Serve batching-window re-sizes the tuner applied "
                   "(on mode; hysteresis-gated)."),
    "sort_serve_batch_window_ms": (
        "gauge", "Current (possibly auto-tuned) serve batching window "
                 "in milliseconds."),
    # out-of-core external sort: spill/merge volume and the
    # integrity-recovery tally, fed from external.* span closes; the
    # spilled-request counter is written by the serve spill tier.
    "sort_external_runs_total": (
        "counter", "Spill runs written by the external sort."),
    "sort_external_spill_bytes_total": (
        "counter", "Bytes written to spill runs (keys + payload + "
                   "framing)."),
    "sort_external_merge_seconds_total": (
        "counter", "Wall seconds spent in k-way merge passes."),
    "sort_external_recoveries_total": (
        "counter", "External-sort integrity recoveries (bad run "
                   "re-spilled / merge re-ran before a verified "
                   "result)."),
    "sort_external_spilled_requests_total": (
        "counter", "Serve requests routed to the out-of-core spill "
                   "tier (payload larger than the admission byte "
                   "bound)."),
    # crash-durable spill tier: manifest-replay resumes and
    # the startup orphan sweep, fed from external.resume / external.gc
    # span closes.
    "sort_external_resumes_total": (
        "counter", "External sorts that replayed a journaled spill "
                   "manifest and re-entered at the merge phase "
                   "(kill -9 / retried-request recovery)."),
    "sort_external_orphans_reclaimed_total": (
        "counter", "Orphaned spill files reclaimed by the age-gated "
                   "startup GC sweep (files no live manifest "
                   "references)."),
}

_HISTOGRAM_BUCKETS: dict[str, tuple[float, ...]] = {
    "sort_serve_request_latency_seconds": LATENCY_BUCKETS_S,
    "sort_serve_queue_wait_seconds": LATENCY_BUCKETS_S,
    "sort_serve_batch_segments": OCCUPANCY_BUCKETS,
}

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def cumulative_buckets(values: "list[float] | tuple[float, ...]",
                       bounds: tuple[float, ...],
                       ) -> list[tuple[float, int]]:
    """Cumulative ``(le_bound, count)`` pairs over fixed buckets — the
    ONE bucketing rule (``v <= bound``, first match) shared by the live
    histogram exposition and any client-side histogram that must line
    up against it 1:1 (a load generator's).  The ``+Inf`` bucket
    is the caller's ``len(values)``."""
    counts = [0] * len(bounds)
    for v in values:
        for i, b in enumerate(bounds):
            if v <= b:
                counts[i] += 1
                break
    out, cum = [], 0
    for b, c in zip(bounds, counts):
        cum += c
        out.append((b, cum))
    return out


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Series:
    """One (name, labelset) time series.  For histograms, ``value`` is
    the sum and ``buckets`` the cumulative-at-render counts."""

    __slots__ = ("value", "count", "buckets")

    def __init__(self, n_buckets: int = 0) -> None:
        self.value = 0.0
        self.count = 0
        self.buckets = [0] * n_buckets  # per-bucket (non-cumulative)


class Metric:
    """Handle for one registered metric family (all its label series).
    Obtained via :meth:`LiveMetrics.counter` / ``gauge`` /
    ``histogram`` — never constructed directly."""

    def __init__(self, name: str, kind: str, help_text: str,
                 buckets: tuple[float, ...], lock: threading.Lock) -> None:
        self.name = name
        self.kind = kind
        self.help = help_text
        self.bucket_bounds = buckets
        self._lock = lock
        self._series: dict[tuple[tuple[str, str], ...], _Series] = {}

    def _get(self, labels: dict[str, str] | None) -> _Series:
        key = tuple(sorted((k, str(v)) for k, v in (labels or {}).items()))
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _Series(len(self.bucket_bounds))
        return s

    # -- update API ---------------------------------------------------
    def inc(self, amount: float = 1.0, **labels: str) -> None:
        """Counter increment (negative amounts are a ValueError)."""
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        with self._lock:
            s = self._get(labels)
            s.value += amount
            s.count += 1

    def set(self, value: float, **labels: str) -> None:
        """Gauge assignment."""
        with self._lock:
            self._get(labels).value = float(value)

    def observe(self, value: float, **labels: str) -> None:
        """Histogram observation."""
        with self._lock:
            s = self._get(labels)
            s.value += value
            s.count += 1
            for i, bound in enumerate(self.bucket_bounds):
                if value <= bound:
                    s.buckets[i] += 1
                    break
            # above the last bound: counted only in +Inf (s.count)

    # -- read API (tests / varz) --------------------------------------
    def get(self, **labels: str) -> float:
        with self._lock:
            key = tuple(sorted((k, str(v)) for k, v in labels.items()))
            s = self._series.get(key)
            return s.value if s else 0.0

    def total(self) -> float:
        """Sum over every label series (counters/gauges)."""
        with self._lock:
            return sum(s.value for s in self._series.values())

    def sample_count(self, **labels: str) -> int:
        with self._lock:
            key = tuple(sorted((k, str(v)) for k, v in labels.items()))
            s = self._series.get(key)
            return s.count if s else 0


class LiveMetrics:
    """One live registry (the server owns one).  Lookup of an
    unregistered name raises ``KeyError`` — the metric vocabulary is
    closed (:data:`METRICS`), like the knob and span registries."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def _family(self, name: str, want_kind: str) -> Metric:
        # the kind check runs on EVERY lookup, not just family
        # creation — a warm registry must reject a miskinded accessor
        # exactly like a cold one (a gauge handle to a counter family
        # would let .set() overwrite an accumulated count)
        kind, help_text = METRICS[name]  # KeyError = unregistered
        if kind != want_kind:
            raise KeyError(
                f"metric {name!r} is registered as a {kind}, "
                f"not a {want_kind}")
        m = self._metrics.get(name)
        if m is None:
            buckets = _HISTOGRAM_BUCKETS.get(name, ())
            m = Metric(name, kind, help_text, buckets, self._lock)
            with self._lock:
                m = self._metrics.setdefault(name, m)
        return m

    def counter(self, name: str) -> Metric:
        return self._family(name, "counter")

    def gauge(self, name: str) -> Metric:
        return self._family(name, "gauge")

    def histogram(self, name: str) -> Metric:
        return self._family(name, "histogram")

    def families(self) -> Iterator[Metric]:
        with self._lock:
            out = sorted(self._metrics.values(), key=lambda m: m.name)
        return iter(out)

    # -- exposition ---------------------------------------------------
    def render_prom(self) -> str:
        """Prometheus text exposition of every touched family."""
        out: list[str] = []
        for m in self.families():
            out.append(f"# HELP {m.name} {_esc(m.help)}")
            out.append(f"# TYPE {m.name} {m.kind}")
            with self._lock:
                series = list(m._series.items())
            for key, s in sorted(series):
                lbl = ",".join(f'{k}="{_esc(v)}"' for k, v in key)
                if m.kind != "histogram":
                    out.append(f"{m.name}{{{lbl}}} {_fmt(s.value)}"
                               if lbl else f"{m.name} {_fmt(s.value)}")
                    continue
                cum = 0
                for bound, cnt in zip(m.bucket_bounds, s.buckets):
                    cum += cnt
                    le = f'le="{_fmt(bound)}"'
                    full = f"{lbl},{le}" if lbl else le
                    out.append(f"{m.name}_bucket{{{full}}} {cum}")
                le = 'le="+Inf"'
                full = f"{lbl},{le}" if lbl else le
                out.append(f"{m.name}_bucket{{{full}}} {s.count}")
                out.append(f"{m.name}_sum{{{lbl}}} {_fmt(s.value)}"
                           if lbl else f"{m.name}_sum {_fmt(s.value)}")
                out.append(f"{m.name}_count{{{lbl}}} {s.count}"
                           if lbl else f"{m.name}_count {s.count}")
        return "\n".join(out) + ("\n" if out else "")


# ------------------------------------------------------ scrape parsing

def parse_prom_text(text: str) -> dict[str, dict]:
    """Parse Prometheus text exposition into ``{base_name: {"type", "help",
    "samples": [(suffixed_name, labels_dict, value)]}}`` — the consumer
    half (``report.py --prom``, the load generator's reconciliation
    scrape).  Tolerant of unknown families; strict on line grammar
    (a malformed line raises ``ValueError`` naming it)."""
    fams: dict[str, dict] = {}

    def fam(name: str) -> dict:
        return fams.setdefault(name, {"type": "untyped", "help": "",
                                      "samples": []})

    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):].split(" ", 1)
            fam(rest[0])["help"] = rest[1] if len(rest) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) != 2:
                raise ValueError(f"line {lineno}: malformed TYPE line")
            fam(parts[0])["type"] = parts[1]
            continue
        if line.startswith("#"):
            continue
        m = _NAME_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: no metric name in {line!r}")
        name = m.group(0)
        rest = line[m.end():].strip()
        labels: dict[str, str] = {}
        if rest.startswith("{"):
            close = rest.find("}")
            if close < 0:
                raise ValueError(f"line {lineno}: unterminated label set")
            labels = {k: v.replace('\\"', '"').replace("\\\\", "\\")
                      for k, v in _LABEL_RE.findall(rest[1:close])}
            rest = rest[close + 1:].strip()
        val_str = rest.split()[0] if rest else ""
        try:
            value = float("inf") if val_str == "+Inf" else float(val_str)
        except ValueError:
            raise ValueError(
                f"line {lineno}: bad sample value {val_str!r}") from None
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in fams:
                base = name[:-len(suffix)]
                break
        fam(base)["samples"].append((name, labels, value))
    return fams


def check_exposition(text: str) -> list[str]:
    """Validate a ``/metrics`` scrape: parseable grammar AND every
    family name registered in :data:`METRICS` with the registered type.
    Returns a list of violations (empty = clean)."""
    errors: list[str] = []
    try:
        fams = parse_prom_text(text)
    except ValueError as e:
        return [str(e)]
    for name, f in fams.items():
        reg = METRICS.get(name)
        if reg is None:
            errors.append(f"metric {name!r} is not registered in "
                          "utils/metrics_live.py METRICS")
        elif f["type"] not in ("untyped", reg[0]):
            errors.append(f"metric {name!r} exposed as {f['type']}, "
                          f"registered as {reg[0]}")
        if not f["samples"]:
            errors.append(f"metric family {name!r} has no samples")
    return errors


# ------------------------------------------------- span-close bridge

class SpanMetricsBridge:
    """SpanLog observer: maps closed spans onto live metrics — the
    "updated from the existing span-close path" half of the design.
    Attach with ``spanlog.observers.append(SpanMetricsBridge(metrics))``;
    every mapping is attr-tolerant (telemetry must never take down the
    path it observes)."""

    def __init__(self, metrics: LiveMetrics) -> None:
        self.metrics = metrics

    def __call__(self, span: object) -> None:
        # span duck-typed: .name/.dt/.attrs
        name = getattr(span, "name", "")
        dt = float(getattr(span, "dt", 0.0) or 0.0)
        attrs = getattr(span, "attrs", None) or {}
        metrics = self.metrics
        if name == "serve.request":
            status = str(attrs.get("status", "?"))
            metrics.counter("sort_serve_requests_total").inc(
                1, status=status)
            if status == "ok":
                metrics.histogram(
                    "sort_serve_request_latency_seconds").observe(dt)
            reject = attrs.get("reject")
            if reject:
                metrics.counter("sort_serve_rejected_total").inc(
                    1, reason=str(reject))
            q = attrs.get("queue_s")
            if q is not None:
                metrics.histogram(
                    "sort_serve_queue_wait_seconds").observe(float(q))
        elif name == "serve.batch":
            metrics.counter("sort_serve_batches_total").inc(1)
            metrics.histogram("sort_serve_batch_segments").observe(
                float(attrs.get("segments", 0) or 0))
            metrics.counter("sort_serve_batch_keys_total").inc(
                float(attrs.get("keys", 0) or 0))
        elif name == "serve.compile_cache":
            if attrs.get("hit"):
                metrics.counter("sort_serve_cache_hits_total").inc(1)
            else:
                metrics.counter("sort_serve_cache_misses_total").inc(1)
                metrics.counter("sort_serve_compile_seconds_total").inc(
                    float(attrs.get("compile_s", 0.0) or 0.0))
        elif name == "serve.profile":
            metrics.counter("sort_profile_captures_total").inc(1)
        elif name == "external.run":
            metrics.counter("sort_external_runs_total").inc(1)
            metrics.counter("sort_external_spill_bytes_total").inc(
                float(attrs.get("bytes", 0) or 0))
        elif name == "external.merge":
            metrics.counter(
                "sort_external_merge_seconds_total").inc(dt)
        elif name == "external.recover":
            metrics.counter("sort_external_recoveries_total").inc(1)
        elif name == "external.resume":
            metrics.counter("sort_external_resumes_total").inc(1)
        elif name == "external.gc":
            metrics.counter(
                "sort_external_orphans_reclaimed_total").inc(
                float(attrs.get("reclaimed", 0) or 0))
        elif name == "serve.deadline":
            metrics.counter("sort_serve_deadline_exceeded_total").inc(
                1, stage=str(attrs.get("stage", "?")))
        elif name == "serve.watchdog":
            event = str(attrs.get("event", "?"))
            if event == "trip":
                metrics.counter("sort_serve_watchdog_trips_total").inc(1)
            elif event == "drain_timeout":
                metrics.counter("sort_serve_drain_timeout_total").inc(1)
        elif name == "serve.alert":
            # sentinel anomaly alerts — rule names are the
            # registered doctor.DOCTOR_RULES vocabulary (SL007)
            metrics.counter("sort_alerts_total").inc(
                1, rule=str(attrs.get("rule", "?")),
                severity=str(attrs.get("severity", "?")))
        # serve.hedge is deliberately NOT bridged: the ResilientClient
        # increments sort_client_hedges_total directly at hedge-launch
        # (semantics: hedges FIRED), and a client wired with both a
        # bridged spanlog and a metrics registry must not double-count.
        elif name == "verify":
            metrics.counter("sort_verify_runs_total").inc(1)
            if not attrs.get("ok", True):
                metrics.counter("sort_verify_failures_total").inc(1)
        elif name == "phase:verify":
            metrics.counter("sort_verify_seconds_total").inc(dt)
        elif name == "supervisor_retry":
            metrics.counter("sort_retries_total").inc(1)
        elif name == "fault":
            metrics.counter("sort_faults_total").inc(
                1, site=str(attrs.get("site", "?")))
        elif name == "sort.plan":
            metrics.counter("sort_plans_total").inc(
                1, algo=str(attrs.get("algo", "?")))
            r = attrs.get("regret")
            if r is not None:
                metrics.gauge("sort_plan_regret").set(float(r))
            decisions = attrs.get("decisions")
            if isinstance(decisions, dict):
                for dname, d in decisions.items():
                    if not isinstance(d, dict):
                        continue
                    dr = d.get("regret")
                    if dr is not None:
                        metrics.gauge("sort_plan_decision_regret").set(
                            float(dr), decision=str(dname))
                cap = decisions.get("cap")
                if isinstance(cap, dict) and cap.get("regret") is not None:
                    metrics.gauge("sort_plan_cap_regret").set(
                        float(cap["regret"]))
                algo_d = decisions.get("algo")
                if isinstance(algo_d, dict) and \
                        algo_d.get("requested") is not None and \
                        algo_d.get("chosen") != algo_d.get("requested"):
                    metrics.counter("sort_plan_reroutes_total").inc(
                        1, trigger=str(algo_d.get("trigger", "?")))
                pl = decisions.get("planner")
                if isinstance(pl, dict):
                    # the planner's own census + regret —
                    # `applied` distinguishes acting from shadow
                    applied = bool((pl.get("predicted") or {})
                                   .get("applied"))
                    metrics.counter("sort_planner_decisions_total").inc(
                        1, policy=str(pl.get("chosen", "?")),
                        applied=str(applied).lower())
                    if pl.get("regret") is not None:
                        metrics.gauge("sort_planner_regret").set(
                            float(pl["regret"]))
        elif name == "exchange_balance":
            for key, metric in (
                    ("recv_ratio", "sort_exchange_recv_ratio"),
                    ("peer_ratio", "sort_exchange_peer_ratio"),
                    ("negotiated_cap", "sort_exchange_negotiated_cap"),
                    ("worst_cap", "sort_exchange_worst_cap")):
                v = attrs.get(key)
                if v is not None:
                    metrics.gauge(metric).set(float(v))
            for key, metric in (
                    ("recv_bytes", "sort_exchange_rank_recv_bytes"),
                    ("send_bytes", "sort_exchange_rank_send_bytes")):
                vals = attrs.get(key)
                if isinstance(vals, (list, tuple)):
                    g = metrics.gauge(metric)
                    for rank, v in enumerate(vals):
                        g.set(float(v), rank=str(rank))
