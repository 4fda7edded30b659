"""Device time by the program's own ranges, from a ``torch.profiler`` trace.

    python3 -m sortbench.ranges --workload <name> --seed <n> [--calls <k>]

While a profiler records, ``mpitest_tpu_torch`` opens a
``record_function`` range for every timed span of its ``SpanLog``
(``sort``, ``phase:verify``, ``radix_pass``, …) and a ``host_sync:<what>``
range around every read of a device value on the host
(``utils/spans.py``).  This module reads them back from the chrome trace,
on the trace's own clock:

* the program's ranges are the ``user_annotation`` events other than the
  ``sortbench.call.<i>`` ranges the caller puts around each call;
* each device operation (kernel, memcpy, memset) is tied through its
  ``correlation`` id to its launch (a ``cuda_runtime`` or ``cuda_driver``
  event), and takes the chain of the program's ranges that enclose the
  launch on the launching thread, outermost first;
* an operation with no launch in the trace takes, by stream order, the
  chain its nearest placed neighbours before and after it on its stream
  share; one that still cannot be placed is unattributed;
* each idle gap of the device inside the calls is named by the ranges
  that cover its middle; a gap that begins inside a ``host_sync:*`` range
  and ends with an operation launched after it began is the device run
  dry while the host waited on it (a gap between operations already
  queued is not).

:func:`reduce` gives a :class:`RangeProfile`; :func:`verify_ms`,
:func:`host_syncs_per_sort` and :func:`sync_idle_ms` are the per-layer
numbers it yields, None where the trace holds no program range (a program
without the ranges).  The command profiles ``--calls`` steady calls of a
cell of ``BENCHMARK.json`` (after the harness's warm-up) and prints one
JSON line with them, the device ms launched under each range name
(``range_ms``), the host reads by name and the stage times of
``sortbench/tracing.py`` over the same calls.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Any

from sortbench import tracing
from sortbench.tracing import CALL_RANGE, DEVICE_CATS, Ev

#: Trace categories of host launch events.
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

#: Name prefix of the program's ranges around its host reads.
SYNC = "host_sync:"

#: Key of ``range_ms`` for device time no launch could place.
UNATTRIBUTED = "unattributed"

#: Name of device time launched, and of gaps, outside every program range.
OUTSIDE = "outside sort()"


@dataclass
class Op(Ev):
    """A device operation with its launch's correlation id and stream."""

    corr: int | None = None
    stream: int = 0


@dataclass
class Range:
    """One program range on the trace's clock (microseconds)."""

    name: str
    t0: float
    t1: float
    thread: tuple[Any, Any] = (0, 0)


@dataclass
class Parsed:
    """What :func:`parse` collects from a chrome trace."""

    ops: list[Op]
    calls: list[tuple[float, float]]
    ranges: list[Range]
    #: correlation id -> (time, thread) of its launch event
    launches: dict[int, tuple[float, tuple[Any, Any]]]
    #: the thread that held the ``sortbench.call.<i>`` ranges
    caller: tuple[Any, Any] | None = None


def _corr(args: dict[str, Any]) -> int | None:
    c = args.get("correlation")
    return int(c) if c is not None else None


def parse(trace: dict[str, Any]) -> Parsed:
    """Device operations, call ranges (in call order), program ranges and
    launch events of a ``torch.profiler`` chrome trace."""
    ops, ranges, launches, calls = [], [], {}, {}
    caller = None
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        name = str(ev.get("name", ""))
        t0 = float(ev.get("ts", 0.0))
        t1 = t0 + float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        thread = (ev.get("pid"), ev.get("tid"))
        if cat in DEVICE_CATS:
            dev = args.get("device", 0)
            ops.append(Op(name, DEVICE_CATS[cat], t0, t1,
                          int(dev) if dev is not None else 0,
                          _corr(args), int(args.get("stream", 0) or 0)))
        elif cat in LAUNCH_CATS:
            c = _corr(args)
            if c is not None:
                launches[c] = (t0, thread)
        elif cat == "user_annotation":
            if name.startswith(CALL_RANGE):
                calls[name] = (t0, t1)
                caller = thread
            else:
                ranges.append(Range(name, t0, t1, thread))
    order = sorted(calls, key=lambda n: int(n[len(CALL_RANGE):]))
    return Parsed(ops, [calls[n] for n in order], ranges, launches, caller)


def chains(ranges: list[Range], points: list[float]) -> list[tuple[str, ...]]:
    """For each time in ``points``, the names of the ranges that cover it,
    outermost first (ranges of one thread, properly nested)."""
    rs = sorted(ranges, key=lambda r: (r.t0, -r.t1))
    out: list[tuple[str, ...]] = [()] * len(points)
    stack: list[Range] = []
    i = 0
    for k in sorted(range(len(points)), key=points.__getitem__):
        t = points[k]
        while i < len(rs) and rs[i].t0 <= t:
            # what does not hold the new range has ended before it
            while stack and stack[-1].t1 < rs[i].t1:
                stack.pop()
            stack.append(rs[i])
            i += 1
        while stack and stack[-1].t1 < t:
            stack.pop()
        out[k] = tuple(r.name for r in stack)
    return out


def _by_thread(ranges: list[Range]) -> dict[tuple[Any, Any], list[Range]]:
    out: dict[tuple[Any, Any], list[Range]] = defaultdict(list)
    for r in ranges:
        out[r.thread].append(r)
    return out


def _shared(a: tuple[str, ...], b: tuple[str, ...]) -> tuple[str, ...]:
    """The longest common head of two chains."""
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return a[:n]


def attribute(parsed: Parsed) -> list[tuple[str, ...] | None]:
    """The chain of program ranges each operation was launched under (None:
    not placed).  By launch where the trace has it, else by stream order."""
    threads = _by_thread(parsed.ranges)
    want: dict[tuple[Any, Any], list[tuple[int, float]]] = defaultdict(list)
    for k, op in enumerate(parsed.ops):
        if op.corr in parsed.launches:
            t, thread = parsed.launches[op.corr]
            want[thread].append((k, t))
    out: list[tuple[str, ...] | None] = [None] * len(parsed.ops)
    for thread, pts in want.items():
        for (k, _), chain in zip(pts, chains(threads.get(thread, []), [t for _, t in pts])):
            out[k] = chain
    placed = list(out)
    streams: dict[tuple[int, int], list[int]] = defaultdict(list)
    for k, op in enumerate(parsed.ops):
        streams[(op.device, op.stream)].append(k)
    for ks in streams.values():
        ks.sort(key=lambda k: parsed.ops[k].t0)
        before: list[tuple[str, ...] | None] = []
        last = None
        for k in ks:
            before.append(last)
            last = placed[k] if placed[k] is not None else last
        last = None
        for j in reversed(range(len(ks))):
            k = ks[j]
            if placed[k] is None and before[j] is not None and last is not None:
                out[k] = _shared(before[j], last) or None
            last = placed[k] if placed[k] is not None else last
    return out


@dataclass
class RangeProfile:
    """The program's ranges over ``calls`` profiled calls of one cell."""

    calls: int
    chips: int
    #: program ranges inside the calls (0: a program without ranges)
    program_ranges: int
    #: device seconds launched under each range name (each operation counts
    #: once under every name of its chain)
    range_s: dict[str, float]
    unattributed_s: float
    device_s: float
    #: ``host_sync:*`` ranges inside the calls, and by name
    host_syncs: int
    syncs: dict[str, int]
    #: device idle seconds (summed over cards) in gaps that begin inside a
    #: ``host_sync:*`` range and end with an operation launched after they
    #: began (the queue ran dry), and in all gaps
    sync_idle_s: float
    idle_s: float
    idle_gaps: list[list[Any]] = field(default_factory=list)

    def range_ms(self) -> dict[str, float]:
        """Device ms per call under each range name, and unattributed."""
        out = {n: s * 1e3 / self.calls for n, s in sorted(self.range_s.items(),
                                                          key=lambda kv: -kv[1])}
        out[UNATTRIBUTED] = self.unattributed_s * 1e3 / self.calls
        return out


def reduce(parsed: Parsed, chips: int = 1) -> RangeProfile:
    """The :class:`RangeProfile` of the operations and ranges inside the calls."""
    lo, hi = parsed.calls[0][0], parsed.calls[-1][1]
    keep = [k for k, op in enumerate(parsed.ops) if op.t1 > lo and op.t0 < hi]
    chain_of = attribute(parsed)
    range_s: dict[str, float] = defaultdict(float)
    unattributed = device = 0.0
    per_device: dict[int, list[tuple[float, float]]] = defaultdict(list)
    for k in keep:
        op = parsed.ops[k]
        dt = (op.t1 - op.t0) * 1e-6
        device += dt
        per_device[op.device].append((op.t0, op.t1))
        chain = chain_of[k]
        if chain is None:
            unattributed += dt
            continue
        for name in set(chain) or {OUTSIDE}:
            range_s[name] += dt
    inside = [r for r in parsed.ranges if r.t0 >= lo and r.t1 <= hi]
    syncs = Counter(r.name[len(SYNC):] for r in inside if r.name.startswith(SYNC))
    held = [r for r in parsed.ranges if r.thread == parsed.caller]
    found, dry = [], []
    for dev, iv in per_device.items():
        busy = tracing.merge(tracing.clip(iv, lo, hi))
        after = sorted(((op.t0, parsed.launches.get(op.corr, (None,))[0])
                        for op in parsed.ops if op.device == dev), key=lambda x: x[0])
        begins = [t for t, _ in after]
        for c0, c1 in parsed.calls:
            for a, b in tracing.gaps(tracing.clip(busy, c0, c1), c0, c1):
                # dry: the operation that ends the gap was launched after it
                # began (an unknown launch counts as dry)
                j = bisect.bisect_left(begins, b)
                launched = after[j][1] if j < len(after) else None
                found.append((a, b))
                dry.append(launched is None or launched > a)
    starts = chains(held, [a for a, _ in found])
    middles = chains(held, [(a + b) / 2 for a, b in found])
    sync_idle = sum(b - a for (a, b), ch, d in zip(found, starts, dry)
                    if d and any(n.startswith(SYNC) for n in ch))
    named = sorted(((b - a, " > ".join(ch) or OUTSIDE) for (a, b), ch in zip(found, middles)),
                   key=lambda g: -g[0])
    return RangeProfile(
        calls=len(parsed.calls), chips=chips, program_ranges=len(inside),
        range_s=dict(range_s), unattributed_s=unattributed, device_s=device,
        host_syncs=sum(syncs.values()), syncs=dict(syncs),
        sync_idle_s=sync_idle * 1e-6, idle_s=sum(b - a for a, b in found) * 1e-6,
        idle_gaps=[[n, dt * 1e-6] for dt, n in named[:tracing.TOP]])


def verify_ms(p: RangeProfile) -> float | None:
    """Device ms per call launched inside a ``phase:verify`` range: the
    input fingerprint and the result check."""
    s = p.range_s.get("phase:verify", 0.0)
    return s * 1e3 / p.calls if p.program_ranges and s > 0 else None


def host_syncs_per_sort(p: RangeProfile) -> float | None:
    """``host_sync:*`` ranges per call."""
    return p.host_syncs / p.calls if p.program_ranges else None


def sync_idle_ms(p: RangeProfile) -> float | None:
    """Device idle ms per call, per card, in gaps that begin inside a
    ``host_sync:*`` range with the device's queue empty."""
    return p.sync_idle_s * 1e3 / p.calls / max(p.chips, 1) if p.program_ranges else None


def profile_calls(call: Any, pool: list[Any], card: Any, calls: int,
                  new_tracer: Any) -> tuple[dict[str, Any], list[Any]]:
    """Run ``calls`` calls under ``torch.profiler`` (CPU and CUDA), each in a
    ``sortbench.call.<i>`` range and ending in ``card.sync()``; returns the
    chrome trace and the calls' tracers."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tracers = []
    with profile(activities=activities) as prof:
        for i in range(calls):
            tracers.append(new_tracer())
            with record_function(f"{CALL_RANGE}{i}"):
                out = call(pool[i % len(pool)], tracers[-1])
                card.sync()
            del out
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f), tracers
    finally:
        os.remove(path)


def main(argv: list[str]) -> int:
    import torch

    from sortbench import generator, harness

    ap = argparse.ArgumentParser(prog="python3 -m sortbench.ranges",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=None,
                    help="profiled calls (default: the traffic's trace_calls)")
    args = ap.parse_args(argv)
    harness.cache_dirs()
    bench = harness.Bench.load()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    card = harness.Card("cuda", cell.chips)
    pool = generator.make_pool(cell.config, cell.traffic, args.seed, "cuda")
    call = harness.program(cell, "cuda")
    # the harness's warm-up: every array of the pool, the window's answers held
    held = [call(pool[i % len(pool)], harness.new_tracer())
            for i in range(max(len(pool), int(cell.traffic["check_calls"]) + 1))]
    card.sync()
    del held
    n = args.calls or int(cell.traffic["trace_calls"])
    trace, tracers = profile_calls(call, pool, card, n, harness.new_tracer)
    parsed = parse(trace)
    p = reduce(parsed, cell.chips)
    ev_ops, ev_calls = tracing.parse_chrome(trace)
    stages = tracing.reduce(
        tracing.Capture(ev_ops, [ev_calls[f"{CALL_RANGE}{i}"] for i in range(n)]),
        bench.stages(), key_bytes=cell.key_bytes, ranks=int(cell.config["ranks"]),
        chips=cell.chips, peaks=bench.peaks(torch.cuda.get_device_name(0)))
    attrs = sum(s.attrs.get("host_syncs", 0) for t in tracers for s in t.spans.spans)
    print(json.dumps({
        "workload": cell.name, "seed": args.seed, "calls": n,
        "card": harness.card_line(),
        "verify_ms": verify_ms(p), "host_syncs_per_sort": host_syncs_per_sort(p),
        "sync_idle_ms": sync_idle_ms(p),
        "host_syncs_attr_per_sort": attrs / n,
        "idle_ms": p.idle_s * 1e3 / n / cell.chips,
        "device_ms": p.device_s * 1e3 / n,
        "unattributed_pct": 100.0 * p.unattributed_s / p.device_s if p.device_s else None,
        "call_ms": stages.window_s * 1e3 / n,
        "kernels_per_sort": stages.kernels / n,
        "stage_ms": {str(k): stages.stage_ms(k) for k in stages.stage_s},
        "range_ms": p.range_ms(),
        "syncs_per_sort": {k: v / n for k, v in sorted(p.syncs.items())},
        "idle_gaps": p.idle_gaps,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
