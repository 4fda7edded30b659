"""Structured span tracing, kept in memory (subset of the reference's
``mpitest_tpu/utils/spans.py``).

Nested ``Span`` events (name, parent, t0/dt, attrs) accumulate on a
:class:`SpanLog` that the :class:`~mpitest_tpu_torch.utils.trace.Tracer`
owns; :meth:`SpanLog.record` adds an interval timed by the caller (the
external sort's ``external.*`` spans).  :func:`merge_intervals` and
:func:`overlap_seconds` are the interval arithmetic of the merge's
disk/compute overlap.  JSONL streaming and Chrome trace export are not
carried yet.
Host spans time host work: a span around a CUDA launch times the enqueue
unless the code inside it synchronises.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator

#: In-memory retention cap per SpanLog; later spans are counted in
#: ``SpanLog.dropped`` instead of kept.
MAX_RETAINED_SPANS = 65_536


def merge_intervals(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted, coalesced ``(t0, t1)`` intervals."""
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_seconds(a: list[tuple[float, float]],
                    b: list[tuple[float, float]]) -> float:
    """Total intersection of two merged interval lists: the seconds the two
    activities ran concurrently (``perf_counter`` clocks of one process)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclass
class Span:
    """One event: a timed interval (``dt >= 0``) or a point event (``dt == 0``)."""

    name: str
    id: int
    parent: int | None
    t0: float               # seconds, process-relative (perf_counter)
    dt: float = 0.0
    attrs: dict[str, object] = field(default_factory=dict)


class SpanLog:
    """Accumulates nested spans.  Spans open and close on the calling
    thread; :meth:`record` may be called from any thread."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.dropped = 0
        self._stack: list[int] = []
        self._next_id = 0
        self._lock = threading.Lock()

    def _new(self, name: str, attrs: dict[str, object],
             t0: float | None = None, dt: float = 0.0) -> Span:
        with self._lock:
            s = Span(name=name, id=self._next_id,
                     parent=self._stack[-1] if self._stack else None,
                     t0=time.perf_counter() if t0 is None else t0, dt=dt,
                     attrs=attrs)
            self._next_id += 1
            if len(self.spans) < MAX_RETAINED_SPANS:
                self.spans.append(s)
            else:
                self.dropped += 1
        return s

    @contextmanager
    def span(self, name: str, **attrs: object) -> Iterator[Span]:
        """Open a nested span for the duration of the block."""
        s = self._new(name, attrs)
        self._stack.append(s.id)
        try:
            yield s
        finally:
            self._stack.pop()
            s.dt = time.perf_counter() - s.t0

    def record(self, name: str, t0: float, dt: float, **attrs: object) -> Span:
        """Record a completed interval the caller timed itself, under the
        innermost open span."""
        return self._new(name, attrs, t0=t0, dt=dt)

    def event(self, name: str, **attrs: object) -> Span:
        """Record a point event under the innermost open span."""
        return self._new(name, attrs)
