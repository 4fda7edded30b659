"""Rank-resolved timeline reconstruction over the span stream (port of
``mpitest_tpu/utils/timeline.py``).

The span layer records what the HOST saw: one driver lane of nested
spans, plus byte-exact per-rank accounting on the ``exchange_balance``
events and worker-thread ingest/egress/disk intervals.  Nothing put
those back together: the Chrome export flattened every rank onto one
tid, and "which rank straggled / which phase is the critical path /
did compute actually overlap the DMA" required hand-correlating raw
JSONL.  This module is that fold, computed once and consumed three
ways:

* :func:`build_timeline` — the full reconstruction: estimated per-rank
  activity lanes (pass wall time distributed over ranks in proportion
  to their exchanged bytes — the one per-rank observable the SPMD
  model exposes), per-pass straggler factors (max/median rank time),
  critical-path phase attribution, and compute/DMA/disk overlap
  fractions on the shared interval math of ``utils/spans.py``.
* :func:`bench_fold` — the two trajectory scalars bench rows carry
  (``straggler_factor``, ``critical_path_phase``).
* :func:`chrome_events` — the Perfetto enrichment: one track per rank
  (stable tid), a disk-IO track, and counter tracks for inflight DMA
  bytes and exchange-capacity regrowth, appended to
  ``SpanLog.to_chrome_trace``'s host lane.

Lanes are *estimates* and say so (``"estimated": true`` on every
derived event): the ranks' work is enqueued on the card asynchronously,
so per-rank wall time is not host-observable — but per-rank bytes are
exact, and time-proportional-to-bytes is precisely the model the
capacity negotiation already plans with.

Input is duck-typed: span dicts (``report.py`` rows, flight-recorder
snapshots) or live :class:`~mpitest_tpu_torch.utils.spans.Span` objects
(a run's tracer folded directly) — anything with ``name/t0/dt/
attrs`` (+ optional ``id/parent/pid``).
"""

from __future__ import annotations

from typing import Any

from mpitest_tpu_torch.utils.spans import merge_intervals, overlap_seconds

#: Stable Perfetto tid layout: host driver on tid 1 (the historical
#: lane), disk IO on 900, rank R on 1000+R — ranks render side by side
#: instead of interleaved on the host lane.
HOST_TID = 1
DISK_TID = 900
RANK_TID_BASE = 1000

#: Span names folded into each activity class (registered names —
#: utils/span_schema.py; consumed by string match like report.py).
COMPUTE_SPANS = ("jit_compile_execute", "jit_execute")
DMA_SPANS = ("ingest.transfer", "egress.fetch")
DISK_SPANS = ("external.run", "external.merge")
BALANCE_SPAN = "exchange_balance"
PLAN_SPAN = "sort.plan"
PHASE_PREFIX = "phase:"


def _as_dict(s: Any) -> dict:
    """Span object or dict -> plain dict (no copy when already one)."""
    if isinstance(s, dict):
        return s
    return {"name": getattr(s, "name", "?"), "id": getattr(s, "id", None),
            "parent": getattr(s, "parent", None),
            "t0": float(getattr(s, "t0", 0.0)),
            "dt": float(getattr(s, "dt", 0.0) or 0.0),
            "attrs": getattr(s, "attrs", None) or {}}


def _rank_bytes(attrs: dict) -> list[float] | None:
    """Per-rank byte list of one balance event (recv preferred — the
    receive side is what a straggler waits on), tolerant of ragged /
    partially-missing lists: non-numeric entries are dropped, and a
    list with fewer than 2 usable ranks carries no imbalance signal."""
    for key in ("recv_bytes", "send_bytes"):
        raw = attrs.get(key)
        if isinstance(raw, (list, tuple)):
            vals = []
            for v in raw:
                try:
                    vals.append(float(v))
                except (TypeError, ValueError):
                    continue
            if len(vals) >= 2:
                return vals
    return None


def straggler_stats(rank_bytes: list[float]) -> dict[str, float] | None:
    """max/median straggler factor of one per-rank byte list.  Under
    the bytes-proportional time model, the byte ratio IS the time
    ratio.  Median 0 (most ranks idle) falls back to the mean; an
    all-zero list has no signal and returns None."""
    vals = sorted(v for v in rank_bytes if v >= 0)
    if len(vals) < 2 or vals[-1] <= 0:
        return None
    mid = len(vals) // 2
    median = (vals[mid] if len(vals) % 2
              else (vals[mid - 1] + vals[mid]) / 2.0)
    base = median if median > 0 else sum(vals) / len(vals)
    if base <= 0:
        return None
    return {"factor": round(vals[-1] / base, 4),
            "max": vals[-1], "median": median}


def _anchor(span: dict, by_id: dict[tuple, dict]) -> dict | None:
    """Nearest ancestor with real wall time (dt > 0) — the duration
    budget a point event's rank lanes are scaled into."""
    seen = 0
    cur: dict | None = span
    while cur is not None and seen < 64:
        if float(cur.get("dt", 0.0) or 0.0) > 0:
            return cur
        parent = cur.get("parent")
        if parent is None:
            return None
        cur = by_id.get((cur.get("pid"), parent))
        seen += 1
    return None


def build_timeline(spans: list[Any]) -> dict[str, Any]:
    """Fold a span stream into the rank-resolved timeline.

    Returns::

        {"passes":   [{seq, t0, dt, straggler, ranks, algorithm,
                       rank_bytes, anchor}],
         "lanes":    {rank: [{t0, dt, bytes, seq, estimated}]},
         "ranks":    sorted rank ids with a lane,
         "straggler_factor":   worst per-pass max/median (None = no
                               balance data),
         "phases":   {phase: wall seconds},
         "critical_path_phase": dominant phase (None = no phase spans),
         "overlap":  {compute_s, dma_s, disk_s, compute_dma_pct,
                      compute_disk_pct, spill_disk_overlap},
         "counters": {"inflight_bytes": [(t, value)],
                      "exchange_cap":   [(t, cap)],
                      "cap_regrows":    [(t, cumulative)]}}

    Missing inputs degrade to empty/None fields, never raise — the
    fold runs on partial traces (flight-recorder rings, single-request
    slices) by design.
    """
    rows = [_as_dict(s) for s in spans]
    by_id: dict[tuple, dict] = {}
    for r in rows:
        if r.get("id") is not None:
            by_id[(r.get("pid"), r["id"])] = r

    phases: dict[str, float] = {}
    spill_overlap: float | None = None
    passes: list[dict] = []
    lanes: dict[int, list[dict]] = {}
    comp_iv: dict[Any, list] = {}
    dma_iv: dict[Any, list] = {}
    disk_iv: dict[Any, list] = {}
    inflight: list[tuple[float, float]] = []   # (t, delta bytes)
    cap_series: list[tuple[float, float]] = []
    regrow_series: list[tuple[float, float]] = []
    regrow_total = 0.0

    for r in rows:
        name = str(r.get("name", "?"))
        t0 = float(r.get("t0", 0.0) or 0.0)
        dt = float(r.get("dt", 0.0) or 0.0)
        attrs = r.get("attrs") or {}
        pid = r.get("pid")
        if name.startswith(PHASE_PREFIX):
            phase = name[len(PHASE_PREFIX):]
            phases[phase] = phases.get(phase, 0.0) + dt
        if name in COMPUTE_SPANS and dt > 0:
            comp_iv.setdefault(pid, []).append((t0, t0 + dt))
        elif name in DMA_SPANS and dt > 0:
            dma_iv.setdefault(pid, []).append((t0, t0 + dt))
            nbytes = attrs.get("bytes")
            if isinstance(nbytes, (int, float)) and nbytes > 0:
                inflight.append((t0, float(nbytes)))
                inflight.append((t0 + dt, -float(nbytes)))
        elif name in DISK_SPANS and dt > 0:
            disk_iv.setdefault(pid, []).append((t0, t0 + dt))
            # the external sort's measured read-ahead/write-behind
            # concurrency rides the FINAL merge span; traces without
            # the attr render None, never 0
            if name == "external.merge" and attrs.get("final"):
                ov = attrs.get("disk_overlap")
                if isinstance(ov, (int, float)):
                    spill_overlap = float(ov)
        elif name == BALANCE_SPAN:
            bytes_by_rank = _rank_bytes(attrs)
            stats = (straggler_stats(bytes_by_rank)
                     if bytes_by_rank else None)
            cap = attrs.get("negotiated_cap")
            if isinstance(cap, (int, float)):
                cap_series.append((t0, float(cap)))
            anchor = _anchor(r, by_id)
            entry = {
                "seq": len(passes), "t0": t0, "dt": dt,
                "algorithm": attrs.get("algorithm"),
                "ranks": (len(bytes_by_rank) if bytes_by_rank
                          else attrs.get("ranks")),
                "rank_bytes": bytes_by_rank,
                "straggler": stats["factor"] if stats else None,
                "anchor": anchor.get("name") if anchor else None,
            }
            passes.append(entry)
            if bytes_by_rank and anchor is not None:
                # estimated lane: the anchor's wall time distributed
                # over ranks in proportion to exchanged bytes
                budget = float(anchor.get("dt", 0.0) or 0.0)
                start = float(anchor.get("t0", 0.0) or 0.0)
                peak = max(bytes_by_rank)
                if budget > 0 and peak > 0:
                    for rank, b in enumerate(bytes_by_rank):
                        lanes.setdefault(rank, []).append({
                            "t0": start,
                            "dt": budget * b / peak,
                            "bytes": b, "seq": entry["seq"],
                            "estimated": True,
                        })
        elif name == PLAN_SPAN:
            cap_d = ((attrs.get("decisions") or {}).get("cap")
                     if isinstance(attrs.get("decisions"), dict) else None)
            if isinstance(cap_d, dict):
                regrows = (cap_d.get("actual") or {}).get("regrows")
                if isinstance(regrows, (int, float)) and regrows > 0:
                    regrow_total += float(regrows)
                    regrow_series.append((t0, regrow_total))

    comp_s = dma_s = disk_s = ov_dma = ov_disk = 0.0
    for pid in set(comp_iv) | set(dma_iv) | set(disk_iv):
        cm = merge_intervals(comp_iv.get(pid, []))
        dm = merge_intervals(dma_iv.get(pid, []))
        km = merge_intervals(disk_iv.get(pid, []))
        comp_s += sum(b - a for a, b in cm)
        dma_s += sum(b - a for a, b in dm)
        disk_s += sum(b - a for a, b in km)
        ov_dma += overlap_seconds(cm, dm)
        ov_disk += overlap_seconds(cm, km)

    factors = [p["straggler"] for p in passes if p["straggler"]]
    inflight.sort(key=lambda tv: tv[0])
    level = 0.0
    inflight_series: list[tuple[float, float]] = []
    for t, delta in inflight:
        level += delta
        inflight_series.append((t, max(level, 0.0)))

    critical = max(phases, key=lambda k: phases[k]) if phases else None
    return {
        "passes": passes,
        "lanes": {r: lanes[r] for r in sorted(lanes)},
        "ranks": sorted(lanes),
        "straggler_factor": (round(max(factors), 4) if factors else None),
        "phases": {k: round(v, 9) for k, v in sorted(phases.items())},
        "critical_path_phase": critical,
        "overlap": {
            "compute_s": round(comp_s, 9),
            "dma_s": round(dma_s, 9),
            "disk_s": round(disk_s, 9),
            "compute_dma_pct": (round(100.0 * ov_dma / dma_s, 2)
                                if dma_s > 0 else 0.0),
            "compute_disk_pct": (round(100.0 * ov_disk / disk_s, 2)
                                 if disk_s > 0 else 0.0),
            "spill_disk_overlap": (round(spill_overlap, 4)
                                   if spill_overlap is not None
                                   else None),
        },
        "counters": {"inflight_bytes": inflight_series,
                     "exchange_cap": cap_series,
                     "cap_regrows": regrow_series},
    }


def bench_fold(spans: list[Any]) -> dict[str, Any]:
    """The two trajectory scalars a bench row carries: the worst
    per-pass straggler factor and the dominant phase.  Keys are present
    only when the trace carried the signal (a missing key is "no data",
    never 0)."""
    tl = build_timeline(spans)
    out: dict[str, Any] = {}
    if tl["straggler_factor"] is not None:
        out["straggler_factor"] = tl["straggler_factor"]
    if tl["critical_path_phase"] is not None:
        out["critical_path_phase"] = tl["critical_path_phase"]
    return out


def chrome_events(spans: list[Any]) -> list[dict]:
    """Perfetto enrichment events for ``SpanLog.to_chrome_trace``:
    thread-name metadata + one estimated activity track per rank, a
    disk-IO track, and ``"ph": "C"`` counter tracks (inflight DMA
    bytes, negotiated exchange capacity, cumulative cap regrows)."""
    tl = build_timeline(spans)
    events: list[dict] = []
    for rank in tl["ranks"]:
        tid = RANK_TID_BASE + int(rank)
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid,
                       "args": {"name": f"rank {rank} (estimated)"}})
        for ev in tl["lanes"][rank]:
            if ev["dt"] <= 0:
                continue
            events.append({
                "name": f"exchange pass {ev['seq']}", "ph": "X",
                "pid": 1, "tid": tid, "ts": ev["t0"] * 1e6,
                "dur": ev["dt"] * 1e6,
                "args": {"bytes": ev["bytes"], "estimated": True,
                         "seq": ev["seq"]},
            })
    disk = [(_as_dict(s)) for s in spans
            if str(_as_dict(s).get("name")) in DISK_SPANS]
    if disk:
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": DISK_TID, "args": {"name": "disk io"}})
        for r in disk:
            dt = float(r.get("dt", 0.0) or 0.0)
            if dt <= 0:
                continue
            events.append({
                "name": str(r.get("name")), "ph": "X", "pid": 1,
                "tid": DISK_TID, "ts": float(r.get("t0", 0.0)) * 1e6,
                "dur": dt * 1e6, "args": dict(r.get("attrs") or {}),
            })
    for counter, series, key in (
            ("inflight bytes", tl["counters"]["inflight_bytes"], "bytes"),
            ("exchange cap", tl["counters"]["exchange_cap"], "cap"),
            ("cap regrows", tl["counters"]["cap_regrows"], "regrows")):
        for t, v in series:
            events.append({"name": counter, "ph": "C", "pid": 1,
                           "ts": t * 1e6, "args": {key: v}})
    if events:
        # name the historical host lane only when enrichment tracks
        # exist beside it — a plain trace stays byte-identical
        events.insert(0, {"name": "thread_name", "ph": "M", "pid": 1,
                          "tid": HOST_TID,
                          "args": {"name": "host driver"}})
    return events
