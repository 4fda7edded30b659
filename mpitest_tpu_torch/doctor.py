"""Sort doctor: automated pathology diagnosis over the telemetry fold (port
of ``mpitest_tpu/doctor.py``, with its rule names, thresholds and texts).

A registered vocabulary of known pathologies (:data:`DOCTOR_RULES`), each
a pure function over one evidence snapshot (timeline fold + span census +
serve stats + plan attrs) returning a typed :class:`Finding`: severity,
the span/metric citations that justify it, and the knob to turn with a
direction.

Consumed two ways here:

* ``python -m mpitest_tpu_torch.report --doctor <trace>`` renders
  findings post hoc;
* ``SortPlan.digest()`` embeds a compact ``doctor`` block (plan-shaped
  rules only) so mis-planned runs self-describe.

The serve rules (``compile_storm``, ``window_misfit``'s occupancy branch,
``breaker_flap``, ``deadline_burn``) read serve spans; they are pure
functions over evidence and come with the rest.  One rule differs from
the reference by design: ``local_sort_lax`` fires on the port's
accelerator backend (``"cuda"``, the ranks' ``torch.device`` type), where
the reference fires on ``"tpu"``.

Stdlib only at import.  Span names consumed here are string literals
matched against the registered schema; they are read, never emitted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

DOCTOR_SCHEMA = "doctor.v1"

#: Severity ladder, mildest first (findings sort critical-first).
SEVERITIES = ("info", "warn", "critical")

#: The registered pathology vocabulary.  A literal rule name in the
#: package that is not a key here fails the vocabulary test.  Add the
#: rule function with :func:`_rule` in the same change — a key without
#: a diagnosis function fails the vocabulary test.
DOCTOR_RULES: dict[str, str] = {
    "skew_imbalance":
        "one rank exchanges far more bytes than the median — a "
        "straggler serializes every barrier behind it",
    "cap_thrash":
        "the negotiated exchange capacity repeatedly regrew mid-sort "
        "— each regrow is a recompile + retry of the exchange",
    "compile_storm":
        "persistent jit-cache misses in steady state — the shape mix "
        "is not covered by the serve bucket ladder",
    "window_misfit":
        "the serve batch window pads lanes it cannot fill (high "
        "padded-lane waste) or never packs more than one segment",
    "spill_bound":
        "external-sort wall time is dominated by disk spill/merge "
        "reads rather than compute",
    "verify_overhead_regression":
        "post-sort verification consumes an outsized share of the "
        "run wall time",
    "breaker_flap":
        "the serve circuit breaker trips repeatedly — capacity is "
        "oscillating instead of recovering",
    "deadline_burn":
        "the serve SLO budget is burning: errors/expired deadlines "
        "or drifting p99 exceed the error-budget burn-rate allowance",
    "local_sort_lax":
        "the local sort dominates the critical path while the engine "
        "resolved to the generic lax engine (torch.sort) on a CUDA "
        "backend — the fused radix kernel is one knob away",
    "spill_churn":
        "the external sort keeps re-spilling or crash-resuming — "
        "repeated integrity recoveries / manifest replays in one "
        "trace point at a failing spill volume",
}

# diagnosis thresholds — module constants so tests cite them and the
# sentinel reuses the same gates for its rolling windows
SKEW_FACTOR_WARN = 1.5
SKEW_FACTOR_CRITICAL = 3.0
CAP_REGROW_GATE = 2
COMPILE_MISS_MIN = 4
WINDOW_WASTE_GATE = 0.5
WINDOW_OCCUPANCY_MIN_BATCHES = 4
SPILL_FRACTION_GATE = 0.5
VERIFY_RATIO_GATE = 0.25
# absolute floor: tiny/cold runs legitimately spend most of their wall
# in verify (the verifier's first-call compile lands in phase:verify),
# and sub-second overhead is not worth a knob suggestion either way
VERIFY_MIN_SECONDS = 0.5
BREAKER_TRIP_GATE = 2
BURN_RATE_GATE = 1.0
BURN_MIN_REQUESTS = 8
DEFAULT_SLO_TARGET_PCT = 99.9
# local_sort_lax: the sort phase must both be the critical
# path's dominant phase AND carry at least this fraction of the phase
# wall before a lax-on-CUDA local engine is worth a knob suggestion
LOCAL_SORT_PHASE_GATE = 0.4
# spill_churn: integrity recoveries + manifest resumes in
# one trace before the spill volume itself is the suspect (one of
# either is normal operation: a single blamed run, a single restart)
SPILL_CHURN_GATE = 2
#: the plan's ``engine.actual.backend`` that local_sort_lax fires on: the
#: accelerator's ``torch.device`` type (the reference's is ``"tpu"``)
ACCELERATOR_BACKEND = "cuda"


@dataclass
class Finding:
    """One diagnosed pathology: what, how bad, why (citations into the
    span/metric evidence), and which knob to turn which way."""
    rule: str
    severity: str              # one of SEVERITIES
    summary: str
    evidence: list[str] = field(default_factory=list)
    knob: str | None = None    # registered SORT_* knob to adjust
    direction: str | None = None   # "raise" / "lower" / "set ..."
    value: float | None = None     # the measured signal
    threshold: float | None = None  # the gate it crossed

    def __post_init__(self) -> None:
        if self.rule not in DOCTOR_RULES:
            raise KeyError(f"unregistered doctor rule: {self.rule!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity: {self.severity!r}")

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"v": DOCTOR_SCHEMA, "rule": self.rule,
                               "severity": self.severity,
                               "summary": self.summary,
                               "evidence": list(self.evidence)}
        if self.knob:
            out["knob"] = self.knob
            out["direction"] = self.direction
        if self.value is not None:
            out["value"] = self.value
        if self.threshold is not None:
            out["threshold"] = self.threshold
        return out


_RULES: dict[str, Callable[[dict], "Finding | None"]] = {}


def _rule(name: str) -> Callable:
    """Register a diagnosis function under a vocabulary key."""
    if name not in DOCTOR_RULES:
        raise KeyError(f"unregistered doctor rule: {name!r}")

    def deco(fn: Callable[[dict], "Finding | None"]) -> Callable:
        _RULES[name] = fn
        return fn
    return deco


# -- evidence fold ----------------------------------------------------

def empty_evidence() -> dict[str, Any]:
    return {"timeline": {}, "spans": {}, "serve": {}, "plans": [],
            "watchdog": {}, "slo_target_pct": DEFAULT_SLO_TARGET_PCT}


def evidence_from_rows(rows: list[dict],
                       timeline: dict | None = None) -> dict[str, Any]:
    """Fold span-dict rows (report.py rows, flight-recorder snapshots,
    raw ``to_dict()`` output) into the evidence snapshot the rules
    consume.  ``timeline`` is the :func:`utils.timeline.build_timeline`
    fold when the caller already has it — the doctor itself stays
    import-light and never computes one."""
    ev = empty_evidence()
    ev["timeline"] = timeline or {}
    spans: dict[str, int] = ev["spans"]
    serve: dict[str, Any] = ev["serve"]
    serve.update(requests=0, ok=0, errors={}, deadline_expired=0,
                 cache_hits=0, cache_misses=0, batches=0,
                 batch_segments=0, latencies_ms=[])
    watchdog: dict[str, int] = ev["watchdog"]
    for r in rows:
        if not isinstance(r, dict):
            continue
        name = str(r.get("name", "?"))
        attrs = r.get("attrs") or {}
        spans[name] = spans.get(name, 0) + 1
        if name == "serve.request":
            serve["requests"] += 1
            status = str(attrs.get("status", "?"))
            if status == "ok":
                serve["ok"] += 1
                dt = float(r.get("dt", 0.0) or 0.0)
                serve["latencies_ms"].append(dt * 1e3)
            else:
                errs = serve["errors"]
                errs[status] = errs.get(status, 0) + 1
        elif name == "serve.deadline":
            serve["deadline_expired"] += 1
        elif name == "serve.compile_cache":
            if attrs.get("hit"):
                serve["cache_hits"] += 1
            else:
                serve["cache_misses"] += 1
        elif name == "serve.batch":
            serve["batches"] += 1
            segs = attrs.get("segments")
            if isinstance(segs, (int, float)):
                serve["batch_segments"] += int(segs)
        elif name == "serve.watchdog":
            ev_kind = str(attrs.get("event", "?"))
            watchdog[ev_kind] = watchdog.get(ev_kind, 0) + 1
        elif name == "sort.plan":
            if isinstance(attrs, dict) and attrs:
                ev["plans"].append(attrs)
    return ev


# -- the rules --------------------------------------------------------

@_rule("skew_imbalance")
def _r_skew(ev: dict) -> Finding | None:
    tl = ev.get("timeline") or {}
    f = tl.get("straggler_factor")
    if not isinstance(f, (int, float)) or f < SKEW_FACTOR_WARN:
        return None
    worst = None
    for p in tl.get("passes") or []:
        if p.get("straggler") == f:
            worst = p
            break
    cites = [f"exchange_balance: straggler factor {f:g}x "
             f"(max/median rank bytes)"]
    if worst is not None and worst.get("rank_bytes"):
        rb = worst["rank_bytes"]
        cites.append(f"exchange_balance[seq={worst['seq']}]: rank "
                     f"bytes max={max(rb):g} median-normalized over "
                     f"{len(rb)} ranks")
    sev = "critical" if f >= SKEW_FACTOR_CRITICAL else "warn"
    return Finding("skew_imbalance", sev,
                   f"rank data skew: the slowest rank carries {f:g}x "
                   f"the median exchange bytes",
                   evidence=cites, knob="SORT_RESTAGE",
                   direction="set auto (re-stage the skewed input)",
                   value=float(f), threshold=SKEW_FACTOR_WARN)


@_rule("cap_thrash")
def _r_cap_thrash(ev: dict) -> Finding | None:
    regrows = 0
    per_plan: list[str] = []
    for attrs in ev.get("plans") or []:
        cap = (attrs.get("decisions") or {}).get("cap") \
            if isinstance(attrs.get("decisions"), dict) else None
        actual = cap.get("actual") if isinstance(cap, dict) else None
        n = actual.get("regrows") if isinstance(actual, dict) else None
        if isinstance(n, (int, float)) and n > 0:
            regrows += int(n)
            per_plan.append(
                f"sort.plan: decisions.cap.actual.regrows={int(n)}"
                + (f" (negotiated cap {cap.get('chosen')})"
                   if isinstance(cap, dict) and "chosen" in cap else ""))
    if regrows < CAP_REGROW_GATE:
        return None
    return Finding("cap_thrash", "warn",
                   f"exchange capacity regrew {regrows}x — the "
                   f"negotiated cap is too tight for the real "
                   f"distribution",
                   evidence=per_plan or
                   [f"sort.plan: {regrows} cap regrow(s)"],
                   knob="SORT_CAP_FACTOR",
                   direction="raise (leave headroom over the probe)",
                   value=float(regrows), threshold=float(CAP_REGROW_GATE))


@_rule("compile_storm")
def _r_compile_storm(ev: dict) -> Finding | None:
    s = ev.get("serve") or {}
    hits = int(s.get("cache_hits", 0))
    misses = int(s.get("cache_misses", 0))
    if misses < COMPILE_MISS_MIN or misses <= hits:
        return None
    return Finding("compile_storm", "warn",
                   f"jit cache missing in steady state: {misses} "
                   f"miss(es) vs {hits} hit(s)",
                   evidence=[f"serve.compile_cache: hit=False x"
                             f"{misses}, hit=True x{hits}"],
                   knob="SORT_SERVE_SHAPE_BUCKETS",
                   direction="widen (cover the live shape mix)",
                   value=float(misses), threshold=float(COMPILE_MISS_MIN))


@_rule("window_misfit")
def _r_window_misfit(ev: dict) -> Finding | None:
    wastes: list[float] = []
    for attrs in ev.get("plans") or []:
        batch = (attrs.get("decisions") or {}).get("batch") \
            if isinstance(attrs.get("decisions"), dict) else None
        actual = batch.get("actual") if isinstance(batch, dict) else None
        w = actual.get("waste") if isinstance(actual, dict) else None
        if isinstance(w, (int, float)):
            wastes.append(float(w))
    if wastes:
        mean_waste = sum(wastes) / len(wastes)
        if mean_waste >= WINDOW_WASTE_GATE:
            return Finding(
                "window_misfit", "warn",
                f"batch window pads {100 * mean_waste:.0f}% of the "
                f"lane it packs",
                evidence=[f"sort.plan: decisions.batch.actual.waste "
                          f"mean {mean_waste:.2f} over "
                          f"{len(wastes)} plan(s)"],
                knob="SORT_SERVE_BATCH_WINDOW_MS",
                direction="lower (stop packing mismatched shapes)",
                value=round(mean_waste, 4),
                threshold=WINDOW_WASTE_GATE)
    s = ev.get("serve") or {}
    batches = int(s.get("batches", 0))
    segs = int(s.get("batch_segments", 0))
    if batches >= WINDOW_OCCUPANCY_MIN_BATCHES and segs <= batches:
        occ = segs / batches if batches else 0.0
        return Finding(
            "window_misfit", "info",
            f"batch window never packs: {segs} segment(s) over "
            f"{batches} batch(es) (occupancy {occ:.2f})",
            evidence=[f"serve.batch: {batches} batches, "
                      f"{segs} segments"],
            knob="SORT_SERVE_BATCH_WINDOW_MS",
            direction="raise (let arrivals coalesce)",
            value=round(occ, 4), threshold=1.0)
    return None


@_rule("spill_bound")
def _r_spill_bound(ev: dict) -> Finding | None:
    tl = ev.get("timeline") or {}
    ov = tl.get("overlap") or {}
    disk = float(ov.get("disk_s", 0.0) or 0.0)
    comp = float(ov.get("compute_s", 0.0) or 0.0)
    total = disk + comp
    if disk <= 0 or total <= 0:
        return None
    frac = disk / total
    if frac < SPILL_FRACTION_GATE:
        return None
    evidence = [f"external.run/external.merge: {disk:.3f}s "
                f"disk vs {comp:.3f}s compute "
                f"(overlap {ov.get('compute_disk_pct', 0)}%)"]
    # traces from the async merge carry the measured
    # read-ahead/write-behind concurrency; surface it when present so
    # the operator can tell "disk-bound AND synchronous" (fixable by
    # the IO engine) from "disk-bound at full overlap" (buy compression
    # or a faster disk) — older traces lack the key, behavior unchanged
    spill_ov = ov.get("spill_disk_overlap")
    if isinstance(spill_ov, (int, float)):
        evidence.append(
            f"final merge read-ahead/write-behind overlap "
            f"{100 * float(spill_ov):.0f}% "
            "(SORT_SPILL_COMPRESS shrinks the disk traffic itself)")
    return Finding("spill_bound", "warn",
                   f"disk spill/merge IO is {100 * frac:.0f}% of the "
                   f"compute+IO wall",
                   evidence=evidence,
                   knob="SORT_MERGE_FANIN",
                   direction="raise (fewer merge passes over the runs)",
                   value=round(frac, 4), threshold=SPILL_FRACTION_GATE)


@_rule("verify_overhead_regression")
def _r_verify(ev: dict) -> Finding | None:
    tl = ev.get("timeline") or {}
    phases = tl.get("phases") or {}
    verify = float(phases.get("verify", 0.0) or 0.0)
    total = sum(float(v) for v in phases.values())
    if verify < VERIFY_MIN_SECONDS or total <= 0:
        return None
    ratio = verify / total
    if ratio < VERIFY_RATIO_GATE:
        return None
    return Finding("verify_overhead_regression", "warn",
                   f"phase:verify is {100 * ratio:.0f}% of phase wall "
                   f"time",
                   evidence=[f"phase:verify {verify:.3f}s of "
                             f"{total:.3f}s total phase time"],
                   knob="SORT_VERIFY",
                   direction="lower (sampled or off once the fallback "
                             "ladder is trusted)",
                   value=round(ratio, 4), threshold=VERIFY_RATIO_GATE)


@_rule("local_sort_lax")
def _r_local_sort_lax(ev: dict) -> Finding | None:
    tl = ev.get("timeline") or {}
    if tl.get("critical_path_phase") != "sort":
        return None
    phases = tl.get("phases") or {}
    sort_s = float(phases.get("sort", 0.0) or 0.0)
    total = sum(float(v) for v in phases.values())
    if total <= 0:
        return None
    frac = sort_s / total
    if frac < LOCAL_SORT_PHASE_GATE:
        return None
    hits: list[str] = []
    for attrs in ev.get("plans") or []:
        eng = (attrs.get("decisions") or {}).get("engine") \
            if isinstance(attrs.get("decisions"), dict) else None
        actual = eng.get("actual") if isinstance(eng, dict) else None
        if not isinstance(actual, dict):
            continue
        if (actual.get("local_engine") == "lax"
                and actual.get("backend") == ACCELERATOR_BACKEND):
            hits.append("sort.plan: decisions.engine.actual"
                        f".local_engine=lax backend={ACCELERATOR_BACKEND}")
    if not hits:
        return None
    return Finding(
        "local_sort_lax", "warn",
        f"local sort is the critical-path phase ({100 * frac:.0f}% of "
        "phase wall) and ran the generic lax engine (torch.sort) on a "
        "CUDA backend",
        evidence=[f"timeline: critical_path_phase=sort "
                  f"({sort_s:.3f}s of {total:.3f}s)"] + hits[:3],
        knob="SORT_LOCAL_ENGINE",
        direction="set radix_pallas (the fused per-pass local radix "
                  "kernel K4; re-baseline on first use)",
        value=round(frac, 4), threshold=LOCAL_SORT_PHASE_GATE)


@_rule("spill_churn")
def _r_spill_churn(ev: dict) -> Finding | None:
    spans = ev.get("spans") or {}
    recovers = int(spans.get("external.recover", 0))
    resumes = int(spans.get("external.resume", 0))
    churn = recovers + resumes
    if churn < SPILL_CHURN_GATE:
        return None
    cites = []
    if recovers:
        cites.append(f"external.recover: {recovers} integrity "
                     "recovery(ies) — runs re-spilled from source")
    if resumes:
        cites.append(f"external.resume: {resumes} manifest replay(s) "
                     "— sorts re-entered at the merge phase")
    sev = "critical" if recovers >= SPILL_CHURN_GATE else "warn"
    return Finding("spill_churn", sev,
                   f"spill tier churning: {recovers} recovery(ies) + "
                   f"{resumes} crash resume(s) in one trace",
                   evidence=cites, knob="SORT_SPILL_DIR",
                   direction="set (move spill staging to a healthier "
                             "volume; check dmesg for media errors)",
                   value=float(churn), threshold=float(SPILL_CHURN_GATE))


@_rule("breaker_flap")
def _r_breaker_flap(ev: dict) -> Finding | None:
    wd = ev.get("watchdog") or {}
    trips = int(wd.get("trip", 0))
    if trips < BREAKER_TRIP_GATE:
        return None
    cites = [f"serve.watchdog: event=trip x{trips}"]
    for kind in ("recovered", "probe"):
        if wd.get(kind):
            cites.append(f"serve.watchdog: event={kind} x{wd[kind]}")
    return Finding("breaker_flap", "critical",
                   f"circuit breaker flapping: {trips} trip(s) in one "
                   f"trace — capacity oscillates instead of recovering",
                   evidence=cites,
                   knob="SORT_SERVE_DISPATCH_TIMEOUT_S",
                   direction="raise (or lower SORT_SERVE_MAX_INFLIGHT "
                             "to shed load before the breaker does)",
                   value=float(trips), threshold=float(BREAKER_TRIP_GATE))


@_rule("deadline_burn")
def _r_deadline_burn(ev: dict) -> Finding | None:
    s = ev.get("serve") or {}
    n = int(s.get("requests", 0))
    if n < BURN_MIN_REQUESTS:
        return None
    errors = sum(int(v) for v in (s.get("errors") or {}).values())
    if errors <= 0:
        return None
    target = float(ev.get("slo_target_pct", DEFAULT_SLO_TARGET_PCT))
    rate = 100.0 * errors / n
    allowance = max(100.0 - target, 1e-9)
    burn = rate / allowance
    if burn < BURN_RATE_GATE:
        return None
    expired = int(s.get("deadline_expired", 0))
    cites = [f"serve.request: {errors}/{n} non-ok "
             f"({rate:.2f}% vs {allowance:g}% allowance = "
             f"{burn:.1f}x burn)"]
    if expired:
        cites.append(f"serve.deadline: {expired} expired deadline(s)")
    by_status = ", ".join(f"{k}={v}" for k, v in
                          sorted((s.get("errors") or {}).items()))
    if by_status:
        cites.append(f"sort_requests_total status breakdown: {by_status}")
    sev = "critical" if burn >= 2 * BURN_RATE_GATE else "warn"
    return Finding("deadline_burn", sev,
                   f"error budget burning at {burn:.1f}x allowance "
                   f"({errors} error(s) in {n} request(s))",
                   evidence=cites, knob="SORT_SERVE_MAX_INFLIGHT",
                   direction="lower (shed load before deadlines expire)",
                   value=round(burn, 4), threshold=BURN_RATE_GATE)


# -- entry points -----------------------------------------------------

def run_rule(name: str, evidence: dict) -> Finding | None:
    """Run ONE registered rule (KeyError on a name outside
    :data:`DOCTOR_RULES` — the vocabulary test catches literal misuse,
    this catches computed names at run time)."""
    return _RULES[name](evidence)


def diagnose(evidence: dict) -> list[Finding]:
    """Run every registered rule over one evidence snapshot; findings
    sorted critical-first, then by rule name for determinism."""
    found = []
    for name in sorted(DOCTOR_RULES):
        f = _RULES[name](evidence)
        if f is not None:
            found.append(f)
    order = {s: i for i, s in enumerate(SEVERITIES)}
    found.sort(key=lambda f: (-order[f.severity], f.rule))
    return found


def plan_findings(plan_attrs: dict) -> list[dict]:
    """Compact doctor block for ``SortPlan.digest()``: only the
    plan-shaped rules (cap_thrash, window_misfit) evaluated over one
    plan's attrs — a mis-planned run self-describes in its digest."""
    ev = empty_evidence()
    ev["plans"] = [plan_attrs] if isinstance(plan_attrs, dict) else []
    out = []
    for name in ("cap_thrash", "window_misfit"):
        f = _RULES[name](ev)
        if f is not None:
            out.append({"rule": f.rule, "severity": f.severity,
                        "summary": f.summary})
    return out


def render(findings: list[Finding]) -> str:
    """Human-readable findings report (the ``report.py --doctor``
    output)."""
    if not findings:
        return "doctor: no findings — all registered pathology rules " \
               "are quiet"
    lines = [f"doctor: {len(findings)} finding(s)"]
    for f in findings:
        lines.append(f"\n[{f.severity.upper()}] {f.rule}: {f.summary}")
        for cite in f.evidence:
            lines.append(f"    evidence: {cite}")
        if f.knob:
            lines.append(f"    suggest : {f.knob} -> {f.direction}")
    return "\n".join(lines)
