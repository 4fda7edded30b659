"""Structured span tracing, kept in memory (subset of the reference's
``mpitest_tpu/utils/spans.py``).

Nested ``Span`` events (name, parent, t0/dt, attrs) accumulate on a
:class:`SpanLog` that the :class:`~mpitest_tpu_torch.utils.trace.Tracer`
owns.  JSONL streaming and Chrome trace export are not carried yet.
Host spans time host work: a span around a CUDA launch times the enqueue
unless the code inside it synchronises.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator

#: In-memory retention cap per SpanLog; later spans are counted in
#: ``SpanLog.dropped`` instead of kept.
MAX_RETAINED_SPANS = 65_536


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
    """Accumulates nested spans; single-threaded by contract."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.dropped = 0
        self._stack: list[int] = []
        self._next_id = 0

    def _new(self, name: str, attrs: dict[str, object]) -> Span:
        s = Span(name=name, id=self._next_id,
                 parent=self._stack[-1] if self._stack else None,
                 t0=time.perf_counter(), attrs=attrs)
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

    def event(self, name: str, **attrs: object) -> Span:
        """Record a point event under the innermost open span."""
        return self._new(name, attrs)
