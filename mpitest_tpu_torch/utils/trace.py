"""Debug-log + phase-timing contract (the reference's
``mpitest_tpu/utils/trace.py``).

Keeps the reference's log prefixes (``[COMMON]``, ``[MASTER]``,
``[SLAVE]``, ``[VERBOSE]``, ``[ERROR]``) and their debug levels, per-phase
wall timers, machine-readable ``counters`` and the nested span log.  Phase
times are host wall time: a phase that launches CUDA work without reading
a result back times the enqueue (``utils/spans.py``).  :func:`torch_profile`
is the device-side view (``SORT_PROFILE``): under it every phase and span
is also a profiler range of its own name and every host read a
``host_sync:<what>`` range, so the trace gives the device time each
launched and the idle time after each read.
"""

from __future__ import annotations

import os
import sys
import time
from collections.abc import Iterable
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator

from mpitest_tpu_torch.utils.spans import SpanLog


@dataclass
class Tracer:
    """Leveled logger + phase timer + counters + span log."""

    level: int = 0
    phases: dict[str, float] = field(default_factory=dict)
    counters: dict[str, object] = field(default_factory=dict)
    #: every ``phase()`` opens a span here too; ``SORT_TRACE=<path>``
    #: streams it as JSONL (wired in models/api.py and store/external.py)
    spans: SpanLog = field(default_factory=SpanLog)
    #: the last finished decision record (``models/plan.SortPlan``), set
    #: by ``sort()`` and ``external_sort()`` at completion
    plan: object | None = None

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

    def error(self, msg: str) -> None:
        print(f"[ERROR] {msg}", file=sys.stderr)

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

    def span(self, name: str, **attrs: object) -> Any:
        """Nested structured span (:mod:`mpitest_tpu_torch.utils.spans`),
        the finer-grained sibling of :meth:`phase`."""
        return self.spans.span(name, **attrs)


@contextmanager
def torch_profile(logdir: str | None,
                  devices: Iterable[Any] | None = None) -> Iterator[None]:
    """``torch.profiler`` trace of the region into ``logdir`` (the port of
    the reference's ``jax_profile``; nothing when ``logdir`` is empty).

    CPU activity always, CUDA activity whenever a card takes part in the
    run: one of ``devices`` is a CUDA device, or, with ``devices`` None,
    CUDA is available.  The trace lands as ``<host>_<pid>.<ms>.pt.trace.json``
    (TensorBoard's profile plugin and Perfetto read it).  No fallback to a
    CPU-only trace: on a card run it raises when this build cannot record
    CUDA activity, or when the finished profile holds no device event."""
    if not logdir:
        yield
        return
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if devices is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = any(torch.device(d).type == "cuda" for d in devices)
    activities = [ProfilerActivity.CPU]
    if cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError(
                f"SORT_PROFILE={logdir!r}: this torch build cannot record CUDA "
                "activity; unset SORT_PROFILE or run on the CPU")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    with prof:
        yield
    if cuda and not any(e.device_type == DeviceType.CUDA for e in prof.events()):
        raise RuntimeError(
            f"SORT_PROFILE={logdir!r}: the profile of a run on a card holds no "
            "CUDA event (the profiler recorded no device activity)")
