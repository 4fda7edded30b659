"""Telemetry aggregation + regression CLI: ``python -m mpitest_tpu_torch.report``.

The consumer end of the unified telemetry layer (SURVEY.md §5 metrics
row): every producer in the repo emits JSONL with a self-identifying
shape, and this module reads them all —

* ``SORT_TRACE`` span streams (``{"v": "span.v1", ...}`` —
  utils/spans.py),
* ``COMM_STATS`` native backend records (``{"v": "comm_stats.v1", ...}``
  — comm/comm_stats.h),
* ``SORT_METRICS`` sidecars (``{"ts", "config", "metrics"}`` —
  utils/metrics.py),
* bench driver rows (``{"metric", "value", ...}`` — bench.py stdout and
  ``bench/BASELINE_RESULTS.jsonl``)

— and renders one per-phase / per-collective table in which native
(MPI/pthreads) and device runs line up on the comm.h collective vocabulary
(:data:`mpitest_tpu_torch.utils.spans.MPI_EQUIV`): the per-pass, per-collective
evidence the MPI-vs-ICI north star needs.

Modes:

* default — aggregate the given files (``bench/BASELINE_RESULTS.jsonl``
  when none given) and print the tables.
* ``--baseline FILE`` — flag metric regressions against pinned rows.  A
  baseline row carrying a ``"host"`` provenance fingerprint is only
  compared when it matches this machine (:func:`host_fingerprint`) — cross-host ratios are weather, not regressions
 .  Exit code 2 when any regression is flagged.
* ``--check`` — schema-validate the files (the ``make
  telemetry-selftest`` gate): span streams must parse, nest, and export
  to Chrome trace-event; comm_stats lines must carry
  calls/bytes/seconds per collective.  Exit 1 on any violation.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

from mpitest_tpu_torch.utils import span_schema
from mpitest_tpu_torch.utils.span_schema import (BALANCE_SPAN,
                                           BATCH_ID_ATTR,
                                           BATCH_TRACE_IDS_ATTR,
                                           FAULT_SPAN,
                                           INGEST_HOST_STAGES,
                                           INGEST_XFER_STAGES, PHASE_PREFIX,
                                           PLAN_SPAN,
                                           RESTAGE_SPAN, RETRY_SPAN,
                                           SERVE_BATCH_SPAN,
                                           SERVE_CACHE_SPAN,
                                           SERVE_DEADLINE_SPAN,
                                           SERVE_HEDGE_SPAN,
                                           SERVE_REQUEST_SPAN,
                                           SERVE_WATCHDOG_SPAN,
                                           TRACE_ID_ATTR, VERIFY_SPAN)
from mpitest_tpu_torch.utils.spans import (MPI_EQUIV, SCHEMA as SPAN_SCHEMA,
                                     merge_intervals, overlap_seconds)

COMM_STATS_SCHEMA = "comm_stats.v1"


def host_fingerprint() -> str:
    """Provenance identifier for host-dependent pinned numbers: CPU model
    and core count (the reference's ``utils/platform.host_fingerprint``,
    so rows pinned by either package compare)."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                k, v = k.strip(), v.strip()
                # first processor block only; VMs often report model
                # name "unknown", so keep vendor/family/model numbers too
                if k in ("vendor_id", "cpu family", "model", "model name"
                         ) and k not in fields:
                    fields[k] = v
    except OSError:
        pass
    name = fields.get("model name", "")
    if name and name != "unknown":
        cpu = name
    elif fields:
        cpu = "-".join(filter(None, (fields.get("vendor_id"),
                                     fields.get("cpu family"),
                                     fields.get("model"))))
    else:
        import platform as _platform

        cpu = _platform.processor() or _platform.machine() or "unknown-cpu"
    return f"{cpu}/{os.cpu_count()}c"

#: End-to-end ingest gate: sort_incl_ingest must hold at least
#: this fraction of the raw sort throughput.  The ONE definition —
#: bench/ingest_selftest.py asserts the same constant it records, and
#: ``--require-ingest-overlap`` re-checks it from the recorded
#: ``ingest_ratio`` metric when one is present.
INGEST_RATIO_GATE = 0.5

#: Default availability SLO target for the error-budget line:
#: at 99.9%, an 0.1% error rate burns the budget at exactly 1.0x.
DEFAULT_SLO_TARGET_PCT = 99.9

#: Absolute floor when comparing a CURRENT plan_regret against a pinned
#: one: a pin of 0.0 is the common clean-run value, and a
#: pure ratio band would either never flag (pin=0 skip) or flag on
#: meaningless near-zero jitter.  Same rationale as
#: tools/bench_history.py LOWER_BEST_FLOOR (kept separate: that tool is
#: import-light by design and must not pull this package).
PLAN_REGRET_FLOOR = 0.25


# --------------------------------------------------------------- loading

def load_rows(path: str) -> list[dict]:
    """All JSON objects in a JSONL file, each tagged with its source
    ``kind``: span | comm_stats | metrics | bench | unknown."""
    rows = []
    for lineno, line in enumerate(Path(path).read_text().splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            rows.append({"kind": "invalid", "path": path, "line": lineno,
                         "error": f"not valid JSON ({e})"})
            continue
        if not isinstance(obj, dict):
            # valid JSON, wrong shape (e.g. a bare list/number) — a
            # schema violation to report, never a crash in the checker
            rows.append({"kind": "invalid", "path": path, "line": lineno,
                         "error": "top-level value is not an object"})
            continue
        obj["_path"], obj["_line"] = path, lineno
        v = obj.get("v")
        if v == SPAN_SCHEMA:
            obj["kind"] = "span"
        elif v == COMM_STATS_SCHEMA:
            obj["kind"] = "comm_stats"
        elif "metrics" in obj and "config" in obj:
            obj["kind"] = "metrics"
        elif "metric" in obj and "value" in obj:
            obj["kind"] = "bench"
        else:
            obj["kind"] = "unknown"
        rows.append(obj)
    return rows


# ----------------------------------------------------------- aggregation

# Ingest/egress stage split: imported from utils/span_schema.py — the
# ONE registered vocabulary producers and this consumer share, enforced
# by tests/test_torch_span_names.py (a renamed span can no longer silently vanish
# from these tables).  Overlap is computed PER DIRECTION (the span
# name's prefix): ingest host work against ingest transfers, egress
# decode against egress fetches — pooling them would let egress-only
# overlap satisfy the --require-ingest-overlap gate after an ingest
# regression.  ``ingest.pipeline`` is the umbrella span and is
# excluded from per-stage sums (it would double-count its children).


def aggregate(rows: list[dict]) -> dict:
    """Fold rows into the report tables.

    Returns ``{"phases": {name: {"ms", "count"}},
               "collectives": {source: {coll: {calls, bytes, seconds}}},
               "metrics": {metric: latest bench/metrics value row},
               "spans": {name: count},
               "ingest": {stage: {seconds, count, bytes}},
               "robustness": {faults, fault_sites, retries, verify_runs,
                              verify_failures},
               "ingest_overlap"/"egress_overlap":
                   {host_s, transfer_s, overlap_s, pct} | None}``.
    Collective sources are ``tpu`` (span events, mapped through
    MPI_EQUIV) and ``native/<backend>x<ranks>`` (comm_stats records).
    """
    phases: dict[str, dict] = {}
    colls: dict[str, dict] = {}
    metrics: dict[str, dict] = {}
    span_counts: dict[str, int] = {}
    ingest: dict[str, dict] = {}
    # robustness events: injected faults, supervisor retries
    # and verification outcomes ride the same span stream — fold them
    # into one table so a chaos run's telemetry is one `report` away.
    robust = {"faults": 0, "fault_sites": {}, "retries": 0,
              "verify_runs": 0, "verify_failures": 0}
    # sort-as-a-service events: one serve.request span per
    # served request (its duration is the SLO latency unit), one
    # serve.batch per packed multi-tenant dispatch, one
    # serve.compile_cache point event per executor-cache lookup.
    serve = {"requests": [], "batches": 0, "batch_segments": 0,
             "batch_keys": 0, "cache_hits": 0, "cache_misses": 0,
             "compile_s": 0.0,
             # request-lifecycle robustness events
             "deadline_expired": {}, "watchdog": {}, "hedges": 0}
    # scale-out events: one exchange_balance event per
    # negotiated exchange (per-rank send/recv bytes, negotiated vs
    # worst-case capacity) + the restage count — the evidence row of
    # the multi-chip path.
    scaleout = {"balance": [], "restages": 0}
    # tooling state: bench rows stamp the lint/sanitizer gate
    # versions; the report surfaces the last-seen state so a table of
    # numbers names the rule set that guarded them.
    tooling: dict | None = None
    # encode engines seen on ingest.pipeline spans
    encode_engines: set = set()
    # overlap intervals grouped per (file, pid): t0 is a process-relative
    # perf_counter clock, so intervals from different runs appended to
    # one SORT_TRACE file live on unrelated timelines — comparing them
    # would manufacture phantom overlap (and green-light a serial
    # pipeline through --require-ingest-overlap).
    host_iv: dict[tuple, list] = {}
    xfer_iv: dict[tuple, list] = {}

    def add_coll(source: str, name: str, calls, nbytes, seconds) -> None:
        row = colls.setdefault(source, {}).setdefault(
            name, {"calls": 0, "bytes": 0, "seconds": 0.0})
        row["calls"] += int(calls)
        row["bytes"] += int(nbytes)
        row["seconds"] += float(seconds)

    for obj in rows:
        kind = obj.get("kind")
        if kind == "span":
            name = obj.get("name", "?")
            span_counts[name] = span_counts.get(name, 0) + 1
            if name.startswith(PHASE_PREFIX):
                p = phases.setdefault(name[len(PHASE_PREFIX):],
                                      {"ms": 0.0, "count": 0})
                p["ms"] += float(obj.get("dt", 0.0)) * 1e3
                p["count"] += 1
            elif name in MPI_EQUIV:
                add_coll("tpu", MPI_EQUIV[name], 1,
                         obj.get("attrs", {}).get("bytes", 0),
                         obj.get("dt", 0.0))
            elif name == FAULT_SPAN:
                robust["faults"] += 1
                site = obj.get("attrs", {}).get("site", "?")
                robust["fault_sites"][site] = \
                    robust["fault_sites"].get(site, 0) + 1
            elif name == RETRY_SPAN:
                robust["retries"] += 1
            elif name == BALANCE_SPAN:
                scaleout["balance"].append(obj.get("attrs", {}))
            elif name == RESTAGE_SPAN:
                scaleout["restages"] += 1
            elif name == SERVE_REQUEST_SPAN:
                a = obj.get("attrs", {})
                serve["requests"].append(
                    {"dt": float(obj.get("dt", 0.0)),
                     "status": str(a.get("status", "?")),
                     "batched": bool(a.get("batched")),
                     "n": int(a.get("n", 0) or 0)})
            elif name == SERVE_BATCH_SPAN:
                a = obj.get("attrs", {})
                serve["batches"] += 1
                serve["batch_segments"] += int(a.get("segments", 0) or 0)
                serve["batch_keys"] += int(a.get("keys", 0) or 0)
            elif name == SERVE_CACHE_SPAN:
                a = obj.get("attrs", {})
                if a.get("hit"):
                    serve["cache_hits"] += 1
                else:
                    serve["cache_misses"] += 1
                    serve["compile_s"] += float(a.get("compile_s", 0.0)
                                                or 0.0)
            elif name == SERVE_DEADLINE_SPAN:
                stage = str(obj.get("attrs", {}).get("stage", "?"))
                serve["deadline_expired"][stage] = \
                    serve["deadline_expired"].get(stage, 0) + 1
            elif name == SERVE_WATCHDOG_SPAN:
                event = str(obj.get("attrs", {}).get("event", "?"))
                serve["watchdog"][event] = \
                    serve["watchdog"].get(event, 0) + 1
            elif name == SERVE_HEDGE_SPAN:
                serve["hedges"] += 1
            elif name == VERIFY_SPAN:
                robust["verify_runs"] += 1
                if not obj.get("attrs", {}).get("ok", True):
                    robust["verify_failures"] += 1
            elif name == "ingest.pipeline":
                # umbrella span (excluded from stage sums): carries the
                # run's chosen encode engine (a degraded
                # SORT_NATIVE_ENCODE=auto is visible here, never silent)
                e = obj.get("attrs", {}).get("encode_engine")
                if e:
                    encode_engines.add(str(e))
            elif name in INGEST_HOST_STAGES or name in INGEST_XFER_STAGES:
                row = ingest.setdefault(
                    name, {"seconds": 0.0, "count": 0, "bytes": 0})
                dt = float(obj.get("dt", 0.0))
                t0 = float(obj.get("t0", 0.0))
                row["seconds"] += dt
                row["count"] += 1
                row["bytes"] += int(obj.get("attrs", {}).get("bytes", 0))
                run = (obj.get("_path"), obj.get("pid"),
                       name.split(".", 1)[0])
                (host_iv if name in INGEST_HOST_STAGES
                 else xfer_iv).setdefault(run, []).append((t0, t0 + dt))
        elif kind == "comm_stats":
            source = f"native/{obj.get('backend', '?')}x{obj.get('ranks', '?')}"
            for cname, c in obj.get("collectives", {}).items():
                add_coll(source, cname, c.get("calls", 0),
                         c.get("bytes", 0), c.get("seconds", 0.0))
        elif kind == "metrics":
            for mname, m in obj.get("metrics", {}).items():
                if mname.startswith("phase_") and mname.endswith("_ms"):
                    p = phases.setdefault(mname[len("phase_"):-len("_ms")],
                                          {"ms": 0.0, "count": 0})
                    p["ms"] += float(m.get("value", 0.0))
                    p["count"] += 1
                else:
                    metrics[mname] = {"value": m.get("value"),
                                      "unit": m.get("unit"),
                                      "config": obj.get("config")}
        elif kind == "bench":
            metrics[obj["metric"]] = {k: v for k, v in obj.items()
                                      if not k.startswith("_")}
            if isinstance(obj.get("tooling"), dict):
                tooling = obj["tooling"]
    def direction_overlap(direction: str) -> dict | None:
        runs = {r for r in set(host_iv) | set(xfer_iv) if r[2] == direction}
        if not runs:
            return None
        host_s = xfer_s = ov = 0.0
        for run in runs:
            hm = merge_intervals(host_iv.get(run, []))
            xm = merge_intervals(xfer_iv.get(run, []))
            host_s += sum(b - a for a, b in hm)
            xfer_s += sum(b - a for a, b in xm)
            ov += overlap_seconds(hm, xm)
        return {"host_s": host_s, "transfer_s": xfer_s, "overlap_s": ov,
                "pct": 100.0 * ov / xfer_s if xfer_s > 0 else 0.0}

    return {"phases": phases, "collectives": colls, "metrics": metrics,
            "spans": span_counts, "ingest": ingest, "robustness": robust,
            "scaleout": scaleout, "serve": serve, "tooling": tooling,
            "encode_engines": sorted(encode_engines),
            "ingest_overlap": direction_overlap("ingest"),
            "egress_overlap": direction_overlap("egress")}


# -------------------------------------------------------------- scale-out

#: Bench metric-name shape of a sorted-throughput row; the ``_8dev``
#: suffix marks the devices=8 scale-out row (bench.py).
_THROUGHPUT_RE = re.compile(
    r"^(radix|sample)_sort_mkeys_per_s_2e(\d+)_([a-z0-9]+?)(_8dev)?$")


def scaleout_throughput(metrics: dict) -> list[dict]:
    """Pair the 1-device and devices=8 throughput rows by (algo, dtype)
    for the scale-out table: each entry carries both values (where
    present) and their ratio when the scales match — comparing rows at
    different N would manufacture a fake speedup, so mismatched scales
    report the values but no ratio."""
    base: dict[tuple, dict] = {}
    multi: dict[tuple, dict] = {}
    for name, m in metrics.items():
        mt = _THROUGHPUT_RE.match(name)
        if not mt or m.get("value") is None:
            continue
        row = {"log2n": int(mt.group(2)), "value": float(m["value"])}
        (multi if mt.group(4) else base)[(mt.group(1), mt.group(3))] = row
    out = []
    for key in sorted(set(base) | set(multi)):
        b, p8 = base.get(key), multi.get(key)
        entry: dict = {"algo": key[0], "dtype": key[1], "p1": b, "p8": p8}
        if b and p8 and b["log2n"] == p8["log2n"] and b["value"] > 0:
            entry["speedup"] = round(p8["value"] / b["value"], 3)
        out.append(entry)
    return out


# ----------------------------------------------------------------- serve

def percentile(sorted_values: list, q: float) -> float:
    """Nearest-rank percentile of an ASCENDING-sorted list (the SLO
    convention: p99 is the smallest value >= 99% of the samples)."""
    if not sorted_values:
        return 0.0
    import math as _math

    rank = max(1, _math.ceil(q / 100.0 * len(sorted_values)))
    return float(sorted_values[rank - 1])


def error_budget(requests: int, errors: int,
                 target_pct: float = DEFAULT_SLO_TARGET_PCT) -> dict:
    """Error-budget / burn-rate arithmetic, shared by the
    span-derived SLO table and the ``--prom`` snapshot view: the budget
    is ``100 - target_pct`` percent of requests; burn is the measured
    error rate over that allowance (1.0x = exactly on budget)."""
    rate = 100.0 * errors / requests if requests else 0.0
    allowance = 100.0 - target_pct
    return {
        "slo_target_pct": target_pct,
        "error_rate_pct": round(rate, 4),
        "budget_burn": (round(rate / allowance, 2) if allowance > 0
                        else None),
    }


def serve_slo(serve: dict,
              slo_target: float = DEFAULT_SLO_TARGET_PCT) -> dict | None:
    """Fold the serve.* span census into the SLO table:
    p50/p99/mean request latency over SUCCESSFUL requests (an error is
    an error budget line, not a latency sample), error counts by typed
    code, the batched fraction, the executor-cache hit ratio, and the
    error-budget burn against ``slo_target``.
    None when no serve activity was recorded."""
    reqs = serve.get("requests", [])
    if not reqs and not serve.get("batches") \
            and not (serve.get("cache_hits") or serve.get("cache_misses")):
        return None
    ok = [r for r in reqs if r["status"] == "ok"]
    lat = sorted(r["dt"] for r in ok)
    errors: dict[str, int] = {}
    for r in reqs:
        if r["status"] != "ok":
            errors[r["status"]] = errors.get(r["status"], 0) + 1
    out = {
        "requests": len(reqs), "ok": len(ok), "errors": errors,
        "batched": sum(1 for r in ok if r["batched"]),
        "keys": sum(r["n"] for r in ok),
        "p50_ms": round(percentile(lat, 50) * 1e3, 3),
        "p99_ms": round(percentile(lat, 99) * 1e3, 3),
        "mean_ms": round(1e3 * sum(lat) / len(lat), 3) if lat else 0.0,
        "batches": serve.get("batches", 0),
        "batch_segments": serve.get("batch_segments", 0),
        "cache_hits": serve.get("cache_hits", 0),
        "cache_misses": serve.get("cache_misses", 0),
        "compile_s": round(serve.get("compile_s", 0.0), 4),
        "deadline_expired": dict(serve.get("deadline_expired") or {}),
        "watchdog": dict(serve.get("watchdog") or {}),
        "hedges": serve.get("hedges", 0),
    }
    out.update(error_budget(len(reqs), len(reqs) - len(ok), slo_target))
    return out


# ----------------------------------------------------- trace view (live)

def trace_view(rows: list[dict], trace_id: str) -> str | None:
    """Reconstruct ONE request end-to-end from its ``trace_id``: its ``serve.request`` span (queue wait, status, latency), the
    packed dispatch it shared (via ``batch_id`` — batchmates counted,
    never leaked), and every dispatch-side span stamped with either id
    (the ``sort`` umbrella, phases, retries, faults, verifications),
    rendered as one chronological timeline.  None when no span carries
    the id."""
    spans = [r for r in rows if r.get("kind") == "span"]
    direct = [s for s in spans
              if s.get("attrs", {}).get(TRACE_ID_ATTR) == trace_id]
    batch_ids = {s["attrs"][BATCH_ID_ATTR] for s in direct
                 if s.get("attrs", {}).get(BATCH_ID_ATTR) is not None}
    batchmates: set[str] = set()
    for s in spans:
        if s.get("name") == SERVE_BATCH_SPAN:
            tids = s.get("attrs", {}).get(BATCH_TRACE_IDS_ATTR) or []
            if trace_id in tids:
                bid = s["attrs"].get(BATCH_ID_ATTR)
                if bid is not None:
                    batch_ids.add(bid)
                batchmates.update(t for t in tids if t != trace_id)
    direct_keys = {(s.get("_path"), s.get("pid"), s.get("id"))
                   for s in direct}
    related = [
        s for s in spans
        if (s.get("_path"), s.get("pid"), s.get("id")) not in direct_keys
        and s.get("attrs", {}).get(BATCH_ID_ATTR) in batch_ids
        # a batchmate's own serve.request carries ITS trace_id — that
        # is someone else's request, not part of this timeline
        and s.get("attrs", {}).get(TRACE_ID_ATTR) in (None, trace_id)
    ]
    selected = direct + related
    if not selected:
        return None
    selected.sort(key=lambda s: (str(s.get("_path")), s.get("pid"),
                                 float(s.get("t0", 0.0))))
    t_base = min(float(s.get("t0", 0.0)) for s in selected)
    req = next((s for s in direct if s.get("name") == SERVE_REQUEST_SPAN),
               None)
    out = [f"request trace {trace_id}"]
    if req is not None:
        a = req.get("attrs", {})
        line = (f"  status={a.get('status')} n={a.get('n')} "
                f"dtype={a.get('dtype')} "
                f"latency={float(req.get('dt', 0.0)) * 1e3:.3f}ms")
        if a.get("queue_s") is not None:
            line += f" queue_wait={float(a['queue_s']) * 1e3:.3f}ms"
        if a.get(BATCH_ID_ATTR):
            line += (f" batch={a[BATCH_ID_ATTR]} "
                     f"(+{len(batchmates)} batchmate(s), "
                     f"bucket={a.get('bucket')})")
        else:
            line += " batched=" + str(bool(a.get("batched")))
        out.append(line)
    out.append(f"  {'t+ms':>10} {'dur ms':>10} {'span':<20} attrs")
    hidden = ("trace_id", "batch_id", "trace_ids")
    for s in selected:
        a = {k: v for k, v in s.get("attrs", {}).items()
             if k not in hidden and not isinstance(v, list)}
        attr_txt = " ".join(f"{k}={v}" for k, v in sorted(a.items()))
        out.append(
            f"  {(float(s.get('t0', 0.0)) - t_base) * 1e3:>10.3f} "
            f"{float(s.get('dt', 0.0)) * 1e3:>10.3f} "
            f"{s.get('name', '?'):<20} {attr_txt}"[:120])
    return "\n".join(out)


# --------------------------------------------------- EXPLAIN (plans)

def _fmt_kv(d: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(d.items()))


def render_plan(attrs: dict) -> list[str]:
    """One ``sort.plan`` record as an EXPLAIN-ANALYZE-style tree:
    decision → inputs → prediction → actual → regret, one branch per
    registered decision (models/plan.py vocabulary)."""
    head = (f"plan algo={attrs.get('algo')} n={attrs.get('n')} "
            f"dtype={attrs.get('dtype')} ranks={attrs.get('ranks')} "
            f"regret={attrs.get('regret')}")
    tid = attrs.get(TRACE_ID_ATTR)
    if tid:
        head += f" trace_id={tid}"
    out = [head]
    profile = attrs.get("profile") or {}
    if profile:
        out.append(f"  profile: {_fmt_kv(profile)}")
    decisions = attrs.get("decisions") or {}
    names = sorted(decisions)
    for i, name in enumerate(names):
        d = decisions[name]
        if not isinstance(d, dict):
            continue
        branch = "└─" if i == len(names) - 1 else "├─"
        line = f"  {branch} {name:<8} chosen={d.get('chosen')}"
        if d.get("requested") is not None \
                and d.get("requested") != d.get("chosen"):
            line += f" (requested={d['requested']})"
        if d.get("trigger") is not None:
            line += f" trigger={d['trigger']}"
        line += f" regret={d.get('regret', 0)}"
        out.append(line)
        pad = "     " if i == len(names) - 1 else "  │  "
        if d.get("predicted"):
            out.append(f"  {pad}predicted: {_fmt_kv(d['predicted'])}")
        if d.get("actual"):
            out.append(f"  {pad}actual:    {_fmt_kv(d['actual'])}")
    return out


def explain_view(rows: list[dict], trace_id: str | None = None,
                 ) -> str | None:
    """The ``--explain`` surface.  With a ``trace_id``:
    render every plan that request produced (its own dispatch, or the
    packed dispatch it shared via ``batch_id``) as full decision trees.
    Without one: every plan in the files as trees PLUS the aggregate
    regret table per decision — mis-sized caps and wasted restages as
    one ranked summary.  None when no ``sort.plan`` span is present."""
    plans = [r for r in rows if r.get("kind") == "span"
             and r.get("name") == PLAN_SPAN]
    if trace_id is not None:
        batch_ids = {
            s["attrs"][BATCH_ID_ATTR]
            for s in rows
            if s.get("kind") == "span"
            and s.get("attrs", {}).get(TRACE_ID_ATTR) == trace_id
            and s.get("attrs", {}).get(BATCH_ID_ATTR) is not None}
        for s in rows:
            if s.get("kind") == "span" and s.get("name") == SERVE_BATCH_SPAN:
                tids = s.get("attrs", {}).get(BATCH_TRACE_IDS_ATTR) or []
                bid = s.get("attrs", {}).get(BATCH_ID_ATTR)
                if trace_id in tids and bid is not None:
                    batch_ids.add(bid)
        plans = [p for p in plans
                 if p.get("attrs", {}).get(TRACE_ID_ATTR) == trace_id
                 or p.get("attrs", {}).get(BATCH_ID_ATTR) in batch_ids]
    if not plans:
        return None
    out: list[str] = []
    for p in plans:
        out.extend(render_plan(p.get("attrs") or {}))
        out.append("")
    if trace_id is None and len(plans) > 1:
        from mpitest_tpu_torch.models.plan import fold_decision_stats

        agg = fold_decision_stats([p.get("attrs") or {} for p in plans])
        out.append(f"aggregate regret over {len(plans)} plan(s)")
        out.append(f"  {'decision':<10} {'count':>6} {'mean':>10} "
                   f"{'max':>10}")
        for name, row in sorted(agg.items(),
                                key=lambda kv: -kv[1]["regret_sum"]):
            out.append(
                f"  {name:<10} {row['count']:>6} "
                f"{row['regret_sum'] / row['count']:>10.4f} "
                f"{row['regret_max']:>10.4f}")
        # planner policy census: which registered policies
        # the self-tuning planner chose across these plans, split by
        # whether it acted (on) or only logged (shadow)
        census: dict[tuple[str, bool], int] = {}
        for p in plans:
            d = ((p.get("attrs") or {}).get("decisions") or {}
                 ).get("planner")
            if not isinstance(d, dict):
                continue
            applied = bool((d.get("predicted") or {}).get("applied"))
            key = (str(d.get("chosen", "?")), applied)
            census[key] = census.get(key, 0) + 1
        if census:
            out.append("planner policies")
            for (pol, applied), cnt in sorted(census.items()):
                out.append(f"  {pol:<20} "
                           f"{'applied' if applied else 'shadow':<8} "
                           f"{cnt:>6}")
    return "\n".join(out).rstrip()


# --------------------------------------------- live metrics snapshots

def render_prom_snapshot(path: str, text: str,
                         slo_target: float = DEFAULT_SLO_TARGET_PCT,
                         ) -> str:
    """Render a scraped ``/metrics`` snapshot (Prometheus text) beside
    the span-derived tables: the live mode, for state sampled from a
    running server instead of a finished trace file.  Includes the
    error-budget line computed from the request counters."""
    from mpitest_tpu_torch.utils.metrics_live import parse_prom_text

    fams = parse_prom_text(text)
    out = [f"live metrics snapshot ({path})"]
    reqs = fams.get("sort_serve_requests_total")
    if reqs:
        by_status = {lbl.get("status", "?"): v
                     for name, lbl, v in reqs["samples"]}
        total = int(sum(by_status.values()))
        errs = int(sum(v for k, v in by_status.items() if k != "ok"))
        out.append("  requests " + ", ".join(
            f"{k}={int(v)}" for k, v in sorted(by_status.items())))
        eb = error_budget(total, errs, slo_target)
        burn = eb["budget_burn"]
        out.append(
            f"  error budget ({eb['slo_target_pct']}% target): "
            f"{eb['error_rate_pct']}% errors"
            + (f" -> burn {burn}x" if burn is not None else ""))
    lat = fams.get("sort_serve_request_latency_seconds")
    if lat:
        plain = {n: v for n, lbl, v in lat["samples"] if not lbl}
        cnt = plain.get("sort_serve_request_latency_seconds_count", 0)
        tot = plain.get("sort_serve_request_latency_seconds_sum", 0.0)
        if cnt:
            out.append(f"  latency mean {1e3 * tot / cnt:.3f} ms "
                       f"over {int(cnt)} request(s)")
    for name, label in (("sort_serve_inflight", "in flight"),
                        ("sort_serve_cache_hits_total", "cache hits"),
                        ("sort_serve_cache_misses_total", "cache misses"),
                        ("sort_retries_total", "dispatch retries"),
                        ("sort_verify_failures_total", "verify failures")):
        fam = fams.get(name)
        if fam and fam["samples"]:
            v = sum(v for _n, _l, v in fam["samples"])
            out.append(f"  {label}: {int(v)}")
    out.append(f"  families: {len(fams)}")
    return "\n".join(out)


# ------------------------------------------------------------ regression

def flag_regressions(current: dict, baseline_rows: list[dict],
                     threshold: float, host: str) -> list[dict]:
    """Compare the aggregated ``current["metrics"]`` against pinned
    baseline bench rows.  Higher is better (every repo metric is a
    throughput/ratio); a current value below ``threshold * pinned`` is a
    regression.  A baseline row with a ``host`` fingerprint that does
    not match this machine is reported as skipped, never compared."""
    findings = []
    for row in baseline_rows:
        if row.get("kind", "bench") != "bench":
            continue
        name = row["metric"]
        pinned = float(row["value"])
        row_host = row.get("host")
        if row_host and row_host != host:
            findings.append({"metric": name, "status": "skipped",
                             "reason": f"host mismatch (pinned on "
                                       f"{row_host!r})"})
            continue
        cur = current["metrics"].get(name)
        if cur is None or cur.get("value") is None:
            findings.append({"metric": name, "status": "missing",
                             "reason": "no current row for pinned metric"})
            continue
        # devices provenance: a row pinned at devices=8 only
        # gates a devices=8 measurement — a 1-device run "regressing"
        # against an 8-chip pin is a topology difference, not a
        # regression (and vice versa).
        row_dev = row.get("devices")
        if row_dev is not None and cur.get("devices") != row_dev:
            findings.append({"metric": name, "status": "skipped",
                             "reason": f"devices mismatch (pinned at "
                                       f"devices={row_dev}, current="
                                       f"{cur.get('devices')})"})
            continue
        val = float(cur["value"])
        if pinned > 0 and val < threshold * pinned:
            findings.append({"metric": name, "status": "REGRESSION",
                             "current": val, "pinned": pinned,
                             "ratio": round(val / pinned, 3)})
        else:
            findings.append({"metric": name, "status": "ok",
                             "current": val, "pinned": pinned,
                             "ratio": round(val / pinned, 3)
                             if pinned else None})
        # decision drift: a row that pinned its plan digest
        # also pins the DECISIONS behind the number — same throughput
        # from a different algo/cap/restage is drift worth flagging
        # even when no throughput gate fires.
        for key in ("restaged", "negotiated_cap", "plan_regret"):
            if key not in row:
                continue
            cur_v, pin_v = cur.get(key), row[key]
            if cur_v is None:
                findings.append({"metric": f"{name}.{key}",
                                 "status": "missing",
                                 "reason": "pinned plan field absent "
                                           "from the current row"})
            elif key == "restaged":
                if bool(cur_v) != bool(pin_v):
                    findings.append({
                        "metric": f"{name}.{key}", "status": "DRIFT",
                        "reason": f"restage decision flipped "
                                  f"(pinned {bool(pin_v)}, "
                                  f"current {bool(cur_v)})"})
            elif key == "plan_regret":
                # lower is better, and a clean pin of 0.0 must still
                # gate later regret — compare against pin-or-floor
                floor = max(float(pin_v), PLAN_REGRET_FLOOR)
                if float(cur_v) > floor / threshold:
                    findings.append({
                        "metric": f"{name}.{key}", "status": "DRIFT",
                        "reason": f"pinned {pin_v}, current {cur_v} "
                                  f"(allowed <= {floor / threshold:.3g})"})
            elif float(pin_v) > 0 and not (
                    threshold * float(pin_v) <= float(cur_v)
                    <= float(pin_v) / threshold):
                findings.append({
                    "metric": f"{name}.{key}", "status": "DRIFT",
                    "reason": f"pinned {pin_v}, current {cur_v} "
                              f"({float(cur_v) / float(pin_v):.2f}x)"})
    return findings


# ----------------------------------------------------------------- check

def check_rows(rows: list[dict]) -> list[str]:
    """Schema violations in loaded rows (empty list = clean).  This is
    the contract `make telemetry-selftest` enforces on both the
    SORT_TRACE stream and the COMM_STATS record."""
    errors = []
    spans_by_id: dict[tuple, dict] = {}
    for obj in rows:
        where = f"{obj.get('_path', obj.get('path'))}:{obj.get('_line', obj.get('line'))}"
        kind = obj.get("kind")
        if kind == "invalid":
            errors.append(f"{where}: {obj['error']}")
        elif kind == "span":
            for key in ("name", "id", "t0", "dt", "attrs"):
                if key not in obj:
                    errors.append(f"{where}: span missing {key!r}")
            if "attrs" in obj and not isinstance(obj["attrs"], dict):
                errors.append(f"{where}: span attrs must be an object")
            if isinstance(obj.get("dt"), (int, float)) and obj["dt"] < 0:
                errors.append(f"{where}: span dt < 0")
            spans_by_id[(obj.get("_path"), obj.get("id"))] = obj
        elif kind == "comm_stats":
            if not isinstance(obj.get("ranks"), int) or obj["ranks"] < 1:
                errors.append(f"{where}: comm_stats needs integer ranks >= 1")
            cols = obj.get("collectives")
            if not isinstance(cols, dict) or not cols:
                errors.append(f"{where}: comm_stats needs a non-empty "
                              "collectives object")
                continue
            for cname, c in cols.items():
                if not isinstance(c, dict):
                    errors.append(f"{where}: collective {cname!r} must be "
                                  "an object")
                    continue
                for key in ("calls", "bytes", "seconds"):
                    if key not in c:
                        errors.append(f"{where}: collective {cname!r} "
                                      f"missing {key!r}")
        elif kind == "unknown":
            errors.append(f"{where}: unrecognized record shape")
    # span parent links must resolve within the same stream
    for (path, _), obj in spans_by_id.items():
        parent = obj.get("parent")
        if parent is not None and (path, parent) not in spans_by_id:
            errors.append(f"{path}: span id={obj.get('id')} has dangling "
                          f"parent {parent}")
    return errors


# ---------------------------------------------------------------- tables

def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if b < 1024 or unit == "GiB":
            return f"{b:.1f}{unit}" if unit != "B" else f"{int(b)}B"
        b /= 1024
    return f"{b:.1f}GiB"


def render(agg: dict, slo_target: float = DEFAULT_SLO_TARGET_PCT) -> str:
    out = []
    if agg["phases"]:
        out.append("per-phase wall time")
        out.append(f"  {'phase':<16} {'ms':>12} {'count':>7}")
        for name, p in sorted(agg["phases"].items(),
                              key=lambda kv: -kv[1]["ms"]):
            out.append(f"  {name:<16} {p['ms']:>12.3f} {p['count']:>7}")
    if agg["collectives"]:
        out.append("")
        out.append("per-collective traffic (comm.h vocabulary)")
        out.append(f"  {'source':<18} {'collective':<12} {'calls':>7} "
                   f"{'bytes':>12} {'seconds':>11}")
        for source in sorted(agg["collectives"]):
            for cname, c in sorted(agg["collectives"][source].items()):
                out.append(
                    f"  {source:<18} {cname:<12} {c['calls']:>7} "
                    f"{_fmt_bytes(c['bytes']):>12} {c['seconds']:>11.6f}")
    if agg.get("ingest"):
        out.append("")
        out.append("ingest/egress pipeline (streamed host↔device)")
        out.append(f"  {'stage':<18} {'seconds':>11} {'count':>7} "
                   f"{'bytes':>12} {'GB/s':>8}")
        for name, r in sorted(agg["ingest"].items()):
            gbs = (r["bytes"] / r["seconds"] / 1e9) if r["seconds"] else 0.0
            out.append(f"  {name:<18} {r['seconds']:>11.6f} {r['count']:>7} "
                       f"{_fmt_bytes(r['bytes']):>12} {gbs:>8.2f}")
        for label, key in (("ingest parse/encode ∩ transfer",
                            "ingest_overlap"),
                           ("egress decode ∩ fetch", "egress_overlap")):
            ov = agg.get(key)
            if ov:
                out.append(
                    f"  {label} overlap: {ov['overlap_s']:.6f}s "
                    f"({ov['pct']:.1f}% of {ov['transfer_s']:.6f}s transfer)")
        # telemetry: the engine that encoded, its measured
        # throughput, and the end-to-end ratio (when recorded)
        engines = agg.get("encode_engines") or []
        if engines:
            out.append(f"  encode engine: {', '.join(engines)}")
        for mname, label in (("encode_gb_per_s", "encode throughput"),
                             ("encode_speedup", "native-vs-python encode"),
                             ("ingest_ratio", "incl-ingest / sort ratio")):
            m = agg["metrics"].get(mname)
            if m and m.get("value") is not None:
                unit = m.get("unit") or ""
                out.append(f"  {label}: {m['value']} {unit}".rstrip())
    so = agg.get("scaleout") or {}
    pairs = scaleout_throughput(agg["metrics"])
    if so.get("balance") or so.get("restages") or any(
            p.get("p8") for p in pairs):
        out.append("")
        out.append("scale-out (negotiated exchange + P=1 vs P=8)")
        for b in so.get("balance", []):
            neg, worst = b.get("negotiated_cap"), b.get("worst_cap")
            saving = (f" ({100.0 * (1 - neg / worst):.1f}% below worst-case "
                      f"{worst})" if neg and worst else "")
            out.append(
                f"  {b.get('algorithm', '?'):<7} ranks={b.get('ranks', '?')}"
                f" negotiated cap {neg}{saving}; recv max/mean "
                f"{b.get('recv_ratio')}x, peer/fair {b.get('peer_ratio')}x"
                + (" [re-staged]" if b.get("restaged") else "")
                + ("" if b.get("exact") else " [estimate]"))
        for p in pairs:
            if not p.get("p8"):
                continue
            p1 = (f"P=1 {p['p1']['value']} Mkeys/s (2^{p['p1']['log2n']})"
                  if p.get("p1") else "P=1 (no row)")
            line = (f"  throughput {p['algo']}/{p['dtype']}: {p1} vs "
                    f"P=8 {p['p8']['value']} Mkeys/s (2^{p['p8']['log2n']})")
            if "speedup" in p:
                line += f" -> {p['speedup']}x"
            out.append(line)
        if so.get("restages"):
            out.append(f"  skew re-stages: {so['restages']}")
    slo = serve_slo(agg.get("serve") or {}, slo_target)
    if slo:
        out.append("")
        out.append("sort-as-a-service (serve.* spans — request latency SLO)")
        out.append(f"  requests {slo['requests']} (ok {slo['ok']}, "
                   f"batched {slo['batched']}, {slo['keys']} keys)"
                   + ("; errors " + ", ".join(
                       f"{k}={v}" for k, v in sorted(slo["errors"].items()))
                      if slo["errors"] else ""))
        out.append(f"  latency p50 {slo['p50_ms']} ms, "
                   f"p99 {slo['p99_ms']} ms, mean {slo['mean_ms']} ms")
        if slo["requests"]:
            burn = slo["budget_burn"]
            out.append(
                f"  error budget ({slo['slo_target_pct']}% target): "
                f"{slo['error_rate_pct']}% errors"
                + (f" -> burn {burn}x" if burn is not None else ""))
        if slo["batches"]:
            segs = slo["batch_segments"] / slo["batches"]
            out.append(f"  batches {slo['batches']} "
                       f"({segs:.1f} segments/dispatch)")
        out.append(f"  executor cache: {slo['cache_hits']} hits, "
                   f"{slo['cache_misses']} misses "
                   f"({slo['compile_s']}s compiling)")
        # request-lifecycle robustness lines, only when the
        # events occurred — a clean run's table stays byte-unchanged
        if slo["deadline_expired"]:
            out.append("  deadlines expired pre-dispatch: " + ", ".join(
                f"{stage}={n}" for stage, n in
                sorted(slo["deadline_expired"].items())))
        if slo["watchdog"]:
            out.append("  watchdog: " + ", ".join(
                f"{ev}={n}" for ev, n in sorted(slo["watchdog"].items())))
        if slo["hedges"]:
            out.append(f"  client hedges: {slo['hedges']}")
    rb = agg.get("robustness") or {}
    if any(rb.get(k) for k in ("faults", "retries", "verify_runs")):
        out.append("")
        out.append("robustness (supervisor + verifier events)")
        out.append(f"  verify runs {rb['verify_runs']}, "
                   f"failures {rb['verify_failures']}; "
                   f"dispatch retries {rb['retries']}; "
                   f"faults injected {rb['faults']}"
                   + (" (" + ", ".join(f"{s}={c}" for s, c in
                                       sorted(rb["fault_sites"].items()))
                      + ")" if rb["fault_sites"] else ""))
    if agg["metrics"]:
        out.append("")
        out.append("metrics (latest row per name)")
        for name, m in sorted(agg["metrics"].items()):
            unit = m.get("unit") or ""
            out.append(f"  {name:<40} {m.get('value')} {unit}")
    if agg["spans"]:
        out.append("")
        out.append("span census: " + ", ".join(
            f"{n}={c}" for n, c in sorted(agg["spans"].items())))
    if agg.get("tooling"):
        out.append("")
        out.append("tooling state (lint/sanitizer gates of the bench rows): "
                   + ", ".join(f"{k}={v}" for k, v in
                               sorted(agg["tooling"].items())))
    return "\n".join(out) if out else "(no telemetry rows)"


# ------------------------------------------------------------------ main

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpitest_tpu_torch.report",
        description="Aggregate mpitest_tpu telemetry JSONL (SORT_TRACE "
                    "spans, COMM_STATS, SORT_METRICS, bench rows); flag "
                    "regressions against a pinned baseline.")
    ap.add_argument("files", nargs="*",
                    help="JSONL files (default: bench/BASELINE_RESULTS.jsonl"
                         " when present)")
    ap.add_argument("--check", action="store_true",
                    help="schema-validate the files; exit 1 on violations")
    ap.add_argument("--require-registered-spans", action="store_true",
                    help="with --check: also fail on span names outside "
                         "the registered schema (utils/span_schema.py) — "
                         "the telemetry-selftest gate that makes a "
                         "renamed span a loud failure instead of a "
                         "silently thinner report")
    ap.add_argument("--require-ingest-overlap", action="store_true",
                    help="exit 1 unless the ingest.* spans show nonzero "
                         "parse/encode ∩ transfer overlap (the `make "
                         "ingest-selftest` gate: proves the pipeline "
                         "genuinely overlapped host work with DMA in "
                         "this run; egress overlap does not count)")
    ap.add_argument("--baseline",
                    help="pinned baseline JSONL of bench rows; regressions "
                         "exit 2")
    ap.add_argument("--threshold", type=float, default=0.9,
                    help="regression threshold: flag when current < "
                         "THRESHOLD * pinned (default 0.9)")
    ap.add_argument("--trace-id",
                    help="live mode: reconstruct ONE request "
                         "end-to-end from its trace id — queue wait, "
                         "batch membership, dispatch, verify and reply "
                         "spans as a timeline; exit 1 when no span "
                         "carries the id")
    ap.add_argument("--explain", nargs="?", const="", default=None,
                    metavar="TRACE_ID|FILE",
                    help="plan provenance: render sort.plan "
                         "decision records as EXPLAIN-ANALYZE-style "
                         "trees (decision → prediction → actual → "
                         "regret).  The optional value is a trace id "
                         "(one request's plans) or a span file to read; "
                         "bare --explain renders every plan in the "
                         "given files plus the aggregate regret table. "
                         "Combine with --trace-id to scope; exit 1 when "
                         "no plan matches")
    ap.add_argument("--doctor", nargs="?", const="", default=None,
                    metavar="TRACE_ID|FILE",
                    help="sort doctor: diagnose known "
                         "pathologies over the trace — skew, cap "
                         "thrash, compile storms, window misfit, "
                         "spill-bound merges, verify overhead, breaker "
                         "flap, SLO burn — each finding citing its "
                         "evidence spans and the knob to turn.  The "
                         "optional value is a trace id (one request) "
                         "or a span file to read; exit 1 when the "
                         "files carry no spans.  Rule vocabulary: "
                         "mpitest_tpu_torch/doctor.py DOCTOR_RULES")
    ap.add_argument("--prom", action="append", default=[],
                    metavar="FILE",
                    help="live mode: render a scraped /metrics snapshot "
                         "(Prometheus text exposition) beside the tables, "
                         "including the error-budget line")
    ap.add_argument("--slo-target", type=float,
                    default=DEFAULT_SLO_TARGET_PCT,
                    help="availability target (%%) the error-budget/"
                         "burn-rate line is computed against "
                         f"(default {DEFAULT_SLO_TARGET_PCT})")
    args = ap.parse_args(argv)

    files = list(args.files)
    explain_tid: str | None = None
    if args.explain is not None and args.explain:
        # the one optional value is either a span FILE or a trace id;
        # a path-shaped value that does not exist is a missing file,
        # not a trace id (trace ids are [A-Za-z0-9_-]{1,64} — they can
        # never contain a slash or a .jsonl suffix)
        if Path(args.explain).exists():
            files.append(args.explain)
        elif "/" in args.explain or args.explain.endswith(".jsonl"):
            print(f"[ERROR] --explain: {args.explain}: no such file",
                  file=sys.stderr)
            return 1
        else:
            explain_tid = args.explain
    doctor_tid: str | None = None
    if args.doctor is not None and args.doctor:
        # same file-vs-trace-id disambiguation as --explain
        if Path(args.doctor).exists():
            files.append(args.doctor)
        elif "/" in args.doctor or args.doctor.endswith(".jsonl"):
            print(f"[ERROR] --doctor: {args.doctor}: no such file",
                  file=sys.stderr)
            return 1
        else:
            doctor_tid = args.doctor
    if not files and not args.prom:
        default = Path("bench/BASELINE_RESULTS.jsonl")
        if default.exists():
            files = [str(default)]
        else:
            ap.error("no files given and bench/BASELINE_RESULTS.jsonl "
                     "not found")
    rows: list[dict] = []
    for f in files:
        try:
            rows.extend(load_rows(f))
        except OSError as e:
            print(f"[ERROR] {f}: {e}", file=sys.stderr)
            return 1

    if args.explain is not None:
        tid = explain_tid or args.trace_id
        view = explain_view(rows, tid)
        if view is None:
            where = f" for trace_id {tid!r}" if tid else ""
            print(f"[ERROR] no sort.plan span{where} across "
                  f"{len(files)} file(s) (SORT_PLAN=off, or the run "
                  "predates plan provenance)", file=sys.stderr)
            return 1
        print(view)
        return 0

    if args.doctor is not None:
        tid = doctor_tid or args.trace_id
        span_rows = [r for r in rows if r.get("kind") == "span"]
        if tid:
            span_rows = [r for r in span_rows
                         if (r.get("attrs") or {}).get(
                             span_schema.TRACE_ID_ATTR) == tid]
        if not span_rows:
            where = f" carrying trace_id {tid!r}" if tid else ""
            print(f"[ERROR] --doctor: no spans{where} across "
                  f"{len(files)} file(s)", file=sys.stderr)
            return 1
        # lazy: the doctor is import-light but the timeline fold pulls
        # the span layer; neither belongs on the other report paths
        from mpitest_tpu_torch import doctor as doctor_mod
        from mpitest_tpu_torch.utils import timeline
        ev = doctor_mod.evidence_from_rows(
            span_rows, timeline=timeline.build_timeline(span_rows))
        ev["slo_target_pct"] = args.slo_target
        findings = doctor_mod.diagnose(ev)
        print(doctor_mod.render(findings))
        # a diagnosis is a report, not a gate — findings exit 0
        return 0

    if args.trace_id is not None:
        view = trace_view(rows, args.trace_id)
        if view is None:
            print(f"[ERROR] no span carries trace_id {args.trace_id!r} "
                  f"across {len(files)} file(s)", file=sys.stderr)
            return 1
        print(view)
        return 0

    # each gate runs standalone — --require-registered-spans without
    # --check must still check (a gate that silently skips is worse
    # than no gate)
    errors = check_rows(rows) if args.check else []
    if args.require_registered_spans:
        for r in rows:
            if (r.get("kind") == "span"
                    and not span_schema.is_registered(r.get("name", "?"))):
                errors.append(
                    f"{r.get('_path')}:{r.get('_line')}: span name "
                    f"{r.get('name')!r} is not in the registered "
                    "schema (utils/span_schema.py)")
    if errors:
        for e in errors:
            print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    if args.check or args.require_registered_spans:
        n_spans = sum(1 for r in rows if r.get("kind") == "span")
        n_stats = sum(1 for r in rows if r.get("kind") == "comm_stats")
        print(f"telemetry check OK: {len(rows)} rows "
              f"({n_spans} spans, {n_stats} comm_stats) across "
              f"{len(files)} file(s)")
        if not args.require_ingest_overlap:
            return 0

    agg = aggregate(rows)
    if args.require_ingest_overlap:
        ov = agg["ingest_overlap"]
        if not ov or ov["overlap_s"] <= 0:
            print("[ERROR] ingest spans show NO parse/encode ∩ transfer "
                  "overlap — the pipeline ran serially (or no ingest.* "
                  "spans were emitted)", file=sys.stderr)
            return 1
        print(f"ingest overlap OK: {ov['overlap_s']:.6f}s "
              f"({ov['pct']:.1f}% of transfer)")
        # when a run recorded its end-to-end ratio, re-check
        # the 0.5x gate here — the selftest's artifacts must not say
        # one thing while the gate says another.
        m = agg["metrics"].get("ingest_ratio")
        if m and m.get("value") is not None:
            ratio = float(m["value"])
            if ratio < INGEST_RATIO_GATE:
                print(f"[ERROR] recorded ingest_ratio {ratio} < "
                      f"{INGEST_RATIO_GATE} (sort_incl_ingest fell below "
                      "half the raw sort throughput)", file=sys.stderr)
                return 1
            print(f"ingest ratio OK: {ratio} >= {INGEST_RATIO_GATE}")
    print(render(agg, args.slo_target))
    for prom_file in args.prom:
        try:
            text = Path(prom_file).read_text()
        except OSError as e:
            print(f"[ERROR] {prom_file}: {e}", file=sys.stderr)
            return 1
        try:
            print("\n" + render_prom_snapshot(prom_file, text,
                                              args.slo_target))
        except ValueError as e:
            print(f"[ERROR] {prom_file}: {e}", file=sys.stderr)
            return 1

    if args.baseline:
        try:
            baseline_rows = load_rows(args.baseline)
        except OSError as e:
            print(f"[ERROR] {args.baseline}: {e}", file=sys.stderr)
            return 1
        findings = flag_regressions(agg, baseline_rows, args.threshold,
                                    host_fingerprint())
        print("\nbaseline comparison "
              f"(threshold {args.threshold:g}, host {host_fingerprint()!r})")
        bad = False
        for f in findings:
            if f["status"] == "REGRESSION":
                bad = True
                print(f"  REGRESSION {f['metric']}: {f['current']} vs "
                      f"pinned {f['pinned']} ({f['ratio']}x)")
            elif f["status"] == "ok":
                print(f"  ok         {f['metric']}: {f['current']} vs "
                      f"pinned {f['pinned']} ({f['ratio']}x)")
            else:
                print(f"  {f['status']:<10} {f['metric']}: {f['reason']}")
        if bad:
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
