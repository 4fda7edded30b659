"""Debug-log + phase-timing contract (the reference's
``mpitest_tpu/utils/trace.py``).

Keeps the reference's log prefixes (``[COMMON]``, ``[MASTER]``,
``[SLAVE]``, ``[VERBOSE]``) and their debug levels, per-phase wall timers,
machine-readable ``counters`` and the nested span log.  Phase times are
host wall time: a phase that launches CUDA work without synchronising
times the enqueue.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator

from mpitest_tpu_torch.utils.spans import SpanLog


@dataclass
class Tracer:
    """Leveled logger + phase timer + counters + span log."""

    level: int = 0
    phases: dict[str, float] = field(default_factory=dict)
    counters: dict[str, object] = field(default_factory=dict)
    spans: SpanLog = field(default_factory=SpanLog)

    def common(self, msg: str, min_level: int = 1) -> None:
        """Any-rank step log."""
        if self.level >= min_level:
            print(f"[COMMON] {msg}")

    def master(self, msg: str, min_level: int = 2) -> None:
        """Root-rank protocol log."""
        if self.level >= min_level:
            print(f"[MASTER] {msg}")

    def slave(self, msg: str, min_level: int = 2) -> None:
        """Non-root protocol log."""
        if self.level >= min_level:
            print(f"[SLAVE] {msg}")

    def verbose(self, msg: str) -> None:
        if self.level >= 1:
            print(f"[VERBOSE] {msg}")

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        with self.spans.span(f"phase:{name}"):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.phases[name] = self.phases.get(name, 0.0) + dt
                if self.level >= 1:
                    print(f"[VERBOSE] phase {name}: {dt*1e3:.3f} ms")
