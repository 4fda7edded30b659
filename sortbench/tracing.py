"""From a ``torch.profiler`` trace of a few steady calls to the numbers the
per-layer readers take.

:class:`Recorder` profiles calls of the program with CPU and CUDA
activity, each call inside a ``sortbench.call.<i>`` range, and keeps the
program's own host spans (its ``Tracer``), placed on the trace's clock by
that range.
``reduce`` turns the trace into a :class:`Profile`:

* each device operation (kernel, memcpy, memset) with its interval;
* the stage of each kernel, by the pattern files of
  ``sortbench/stages/<stage>/*.txt`` (one substring a line; the longest
  matching pattern decides; a kernel no pattern names is ``other``);
* the device's busy time as the union of its operations' intervals, so
  operations that overlap count once;
* the idle gaps inside the calls, each named by the innermost host span
  of the program that covers its middle.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterable

#: Trace categories of device operations, by the kind they are counted as.
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}

#: Entries of each list in ``breakdown``.
TOP = 10

#: Characters kept of a device operation's name in ``breakdown``.
NAME_CHARS = 160

CALL_RANGE = "sortbench.call."


@dataclass
class Ev:
    """One device operation of the trace (times in microseconds)."""

    name: str
    kind: str
    t0: float
    t1: float
    device: int = 0


@dataclass
class HostSpan:
    """One host span of the program, on the trace's clock."""

    name: str
    t0: float
    t1: float
    depth: int


@dataclass
class Capture:
    """What a profiled stretch of calls left: device operations, each
    call's host interval and the program's spans (microseconds)."""

    ops: list[Ev]
    calls: list[tuple[float, float]]
    spans: list[HostSpan] = field(default_factory=list)


def read_stages(folder: Path) -> dict[str, list[str]]:
    """``{stage: [pattern, ...]}`` from ``<folder>/<stage>/*.txt``."""
    stages: dict[str, list[str]] = {}
    if not folder.is_dir():
        return stages
    for d in sorted(p for p in folder.iterdir() if p.is_dir()):
        pats = []
        for f in sorted(d.glob("*.txt")):
            for line in f.read_text().splitlines():
                line = line.strip()
                if line and not line.startswith("#"):
                    pats.append(line)
        stages[d.name] = pats
    return stages


def stage_of(name: str, stages: dict[str, list[str]]) -> str | None:
    """The stage whose longest pattern is a substring of ``name``."""
    best, width = None, 0
    for stage, pats in stages.items():
        for p in pats:
            if p in name and len(p) > width:
                best, width = stage, len(p)
    return best


def merge(iv: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted, coalesced intervals."""
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(iv: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in iv if b > lo and a < hi]


def covered(iv: list[tuple[float, float]]) -> float:
    return sum(b - a for a, b in iv)


def gaps(merged: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval of ``merged`` covers."""
    out, t = [], lo
    for a, b in merged:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def name_gap(t: float, spans: list[HostSpan]) -> str:
    """The chain of the program's host spans that cover ``t``, outermost first."""
    chain = sorted((s for s in spans if s.t0 <= t <= s.t1), key=lambda s: s.depth)
    return " > ".join(s.name for s in chain) if chain else "outside sort()"


@dataclass
class Profile:
    """The reduced trace of ``calls`` profiled calls of one cell."""

    calls: int
    key_bytes: int
    ranks: int
    chips: int
    stage_s: dict[str | None, float]
    stage_kernels: dict[str | None, list[str]]
    kernels: int
    busy_s: float
    window_s: float
    device_ops: list[list[Any]]
    idle_gaps: list[list[Any]]
    peaks: dict[str, float] | None = None

    def stage_ms(self, stage: str | None) -> float | None:
        """Device ms per call of the operations in ``stage`` (None: no such
        operation ran)."""
        s = self.stage_s.get(stage, 0.0)
        return s * 1e3 / self.calls if s > 0 else None

    def roofline(self, stage: str, nbytes: float) -> float | None:
        """Share (%) of the least time the card's HBM needs to move
        ``nbytes`` a call, against the stage's device time a call."""
        ms = self.stage_ms(stage)
        bw = (self.peaks or {}).get("hbm_bytes_per_s")
        if not ms or not bw:
            return None
        return 100.0 * (nbytes / bw) / (ms / 1e3)


def reduce(cap: Capture, stages: dict[str, list[str]], *, key_bytes: int,
           ranks: int, chips: int, peaks: dict[str, float] | None) -> Profile:
    """The :class:`Profile` of a capture: operations inside the calls only."""
    lo, hi = cap.calls[0][0], cap.calls[-1][1]
    ops = [e for e in cap.ops if e.t1 > lo and e.t0 < hi]
    stage_s: dict[str | None, float] = defaultdict(float)
    stage_kernels: dict[str | None, set[str]] = defaultdict(set)
    by_name: dict[str, float] = defaultdict(float)
    per_device: dict[int, list[tuple[float, float]]] = defaultdict(list)
    kernels = 0
    for e in ops:
        dt = (e.t1 - e.t0) * 1e-6
        st = stage_of(e.name, stages) if e.kind == "kernel" else None
        stage_s[st] += dt
        stage_kernels[st].add(e.name)
        by_name[e.name] += dt
        per_device[e.device].append((e.t0, e.t1))
        kernels += e.kind == "kernel"
    busy = {d: merge(clip(iv, lo, hi)) for d, iv in per_device.items()}
    busy_s = sum(covered(iv) for iv in busy.values()) * 1e-6 / max(chips, 1)
    idle = []
    for iv in busy.values() or [[]]:
        for c0, c1 in cap.calls:
            idle += [(b - a, name_gap((a + b) / 2, cap.spans))
                     for a, b in gaps(clip(iv, c0, c1), c0, c1)]
    idle.sort(key=lambda g: -g[0])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Profile(
        calls=len(cap.calls), key_bytes=key_bytes, ranks=ranks, chips=chips,
        stage_s=dict(stage_s),
        stage_kernels={k: sorted(v) for k, v in stage_kernels.items()},
        kernels=kernels, busy_s=busy_s, window_s=(hi - lo) * 1e-6,
        device_ops=[[n[:NAME_CHARS], s] for n, s in top_ops],
        idle_gaps=[[n, dt * 1e-6] for dt, n in idle[:TOP]],
        peaks=peaks)


def _span_list(spans: Iterable[Any], offset_us: float) -> list[HostSpan]:
    """The program's spans (``utils/spans.Span``: perf_counter seconds) on
    the trace's clock; point events are left out."""
    spans = list(spans)
    parent = {s.id: s.parent for s in spans}
    out = []
    for s in spans:
        if s.dt <= 0:
            continue
        depth, p = 0, s.parent
        while p is not None:
            depth, p = depth + 1, parent.get(p)
        out.append(HostSpan(s.name, s.t0 * 1e6 + offset_us,
                            (s.t0 + s.dt) * 1e6 + offset_us, depth))
    return out


def parse_chrome(trace: dict[str, Any]) -> tuple[list[Ev], dict[str, tuple[float, float]]]:
    """Device operations and the ``sortbench.call.<i>`` ranges of a
    ``torch.profiler`` chrome trace."""
    ops, ranges = [], {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        t0, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev = (ev.get("args") or {}).get("device", 0)
            ops.append(Ev(str(ev.get("name", "")), DEVICE_CATS[cat], t0, t0 + dur,
                          int(dev) if dev is not None else 0))
        elif cat == "user_annotation" and str(ev.get("name", "")).startswith(CALL_RANGE):
            ranges[ev["name"]] = (t0, t0 + dur)
    return ops, ranges


class Recorder:
    """``torch.profiler`` over the first calls of a window: :meth:`call`
    runs one call inside a ``sortbench.call.<i>`` range and keeps its
    tracer; :meth:`stop` ends the profile and returns the :class:`Capture`."""

    def __init__(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.marks: list[tuple[float, Any]] = []
        self.prof = profile(activities=activities)
        self.prof.__enter__()

    def call(self, fn: Callable[[], Any], tracer: Any) -> Any:
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(f"{CALL_RANGE}{len(self.marks)}"):
            out = fn()
        self.marks.append((t0, tracer))
        return out

    def stop(self) -> Capture:
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        ops, ranges = parse_chrome(trace)
        calls = [ranges[f"{CALL_RANGE}{i}"] for i in range(len(self.marks))]
        spans: list[HostSpan] = []
        for (c0, _), (t0, tr) in zip(calls, self.marks):
            spans += _span_list(tr.spans.spans, c0 - t0 * 1e6)
        return Capture(ops, calls, spans)
