"""Structured span tracing (port of ``mpitest_tpu/utils/spans.py``).

Nested ``Span`` events (name, parent, t0/dt, attrs) accumulate on a
:class:`SpanLog` that the :class:`~mpitest_tpu_torch.utils.trace.Tracer`
owns, and leave it three ways:

* **JSONL event stream**: one self-contained JSON object per completed
  span, appended live to ``SORT_TRACE=<path>`` (schema ``span.v1``, the
  reference's, so its ``report.py`` reads the port's files);
* **Chrome trace-event export**: :meth:`SpanLog.to_chrome_trace` gives
  the ``{"traceEvents": [...]}`` JSON that chrome://tracing and Perfetto
  open (``SORT_TRACE_CHROME``), with ``utils/timeline.py``'s per-rank
  lanes beside the host lane;
* **in process**: ``SpanLog.spans`` for tests and the report, and every
  completed span also lands in the flight recorder's ring
  (``utils/flight_recorder.py``).

What a span's time means on a card: host wall time.  PyTorch launches
CUDA work asynchronously, so a span around a kernel launch, a radix pass
or a program dispatch times its enqueue, not its execution; the device
time of a call lands in whichever later span first reads a result back
to the host (``int(max_cnt)``, the verifier's verdict, the decode).  The
reference has the same semantics, since JAX dispatch is asynchronous too.
Tracing adds no ``torch.cuda.synchronize()``, no ``.item()`` and no
other host read: a span that synchronised would change what it measures.

Device time: while a ``torch.profiler`` records (``SORT_PROFILE``,
``utils/trace.torch_profile``, or any caller's profiler), every timed
span is also a ``record_function`` range of the same name, on the
profiler's clock, so each kernel and copy in the trace can be traced
back through its launch to the spans that enclosed it.  With no profiler
recording a span costs one flag check more.  :func:`host_sync` marks the
program's device-to-host reads: each adds ``host_syncs`` and
``host_sync_s`` (wall seconds) to the innermost open span, always, and
under a profiler opens a ``host_sync:<what>`` range, where the device's
idle time after the read shows.

Collectives and passes: the port has no trace time, so
``parallel/collectives.py`` and the distributed sorts emit their point
events (``dt == 0``, exact byte counts) on every run, nested under the
``radix_pass`` / ``splitter_round`` / ``negotiate_probe`` span of the
code that called them; the reference emits them once per compile.

Every attribute must be JSON-serializable: emit sites convert tensors,
``torch.dtype`` and numpy scalars to Python ``int``, ``float`` or ``str``
(dtypes by their numpy names, ``"int32"``).

Thread model: one SpanLog per Tracer.  The nesting API (``span()`` /
``event()``) is used by the driver thread; pipeline worker threads (the
ingest and egress stages, the external sort's run writers) report
intervals they timed themselves through the thread-safe
:meth:`SpanLog.record`, which parents them under the driver's innermost
open span without touching the nesting stack.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Iterator

from torch.autograd import profiler as _autograd_profiler

from mpitest_tpu_torch.utils import knobs

#: In-memory retention cap per SpanLog; later spans still stream and
#: still reach the flight recorder, and ``SpanLog.dropped`` counts them.
MAX_RETAINED_SPANS = 65_536

#: Version tag stamped on every JSONL line.
SCHEMA = "span.v1"

#: Collective -> its native comm.h twin: the vocabulary the report lines
#: span rows up on against the C backends' COMM_STATS rows.
MPI_EQUIV = {
    "ragged_all_to_all": "alltoallv",
    "all_to_all": "alltoall",
    "all_gather": "allgather",
    "psum": "allreduce",
    "pmax": "allreduce",
}


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
    #: transient: left out of the SORT_TRACE stream by the sampler
    #: (SORT_TRACE_SAMPLE < 1); never serialized.  A root's verdict holds
    #: for its whole subtree, so parent links in the stream resolve.
    stream_drop: bool = field(default=False, repr=False, compare=False)

    def to_dict(self) -> dict[str, object]:
        # pid scopes the process-relative clock: rows that several runs
        # appended to one file are never compared on t0
        return {
            "v": SCHEMA, "name": self.name, "id": self.id,
            "parent": self.parent, "t0": round(self.t0, 9),
            "dt": round(self.dt, 9), "pid": os.getpid(),
            "attrs": self.attrs,
        }


#: Stack of SpanLogs with an open span; :func:`emit` targets the top one,
#: so the collectives and the distributed sorts need no plumbed handle.
_ACTIVE: list["SpanLog"] = []


def current_log() -> "SpanLog | None":
    return _ACTIVE[-1] if _ACTIVE else None


def emit(name: str, **attrs: object) -> None:
    """Record a point event on the active SpanLog (no-op when no span is
    open)."""
    log = current_log()
    if log is not None:
        log.event(name, **attrs)


def add_to_open_span(**amounts: float) -> None:
    """Add ``amounts`` to the attrs of the innermost open span of the
    active log, summed per key (no-op when no span is open): how a layer
    below the tracer records what it measured on the span that encloses
    it, under no span name of its own."""
    log = current_log()
    if log is not None:
        log.add_to_open(**amounts)


def _open_range(name: str) -> "_autograd_profiler.record_function | None":
    """A ``record_function`` range ``name``, entered, while a profiler
    records; None (and no dispatcher call) otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    rf = _autograd_profiler.record_function(name)
    rf.__enter__()
    return rf


@contextmanager
def host_sync(what: str) -> Iterator[None]:
    """Mark a device-to-host read (``int(t)``, ``bool(t)``, ``.cpu()``, …)
    inside the block: the host waits there until the device's queue has
    drained.  Adds ``host_syncs=1`` and ``host_sync_s`` (the block's wall
    seconds) to the innermost open span of the active log, and opens a
    ``host_sync:<what>`` range while a profiler records."""
    rf = _open_range(f"host_sync:{what}")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if rf is not None:
            rf.__exit__(None, None, None)
        add_to_open_span(host_syncs=1, host_sync_s=dt)


def maybe_span(
    name: str, **attrs: object,
) -> "contextlib.AbstractContextManager[Span | None]":
    """Span twin of :func:`emit`: a span on the active log, or a no-op
    context manager when no span is open."""
    log = current_log()
    if log is None:
        return contextlib.nullcontext()
    return log.span(name, **attrs)


#: Thread-local request context: attributes merged into every span the
#: current thread creates while a context is open.
_TRACE_CTX = threading.local()


@contextmanager
def trace_context(**attrs: object) -> Iterator[None]:
    """Attach ``attrs`` (e.g. ``trace_id=...``, ``batch_id=...``) to every
    span this thread creates inside the block.  Nests: inner contexts merge
    over outer ones; explicit span attrs win over context attrs."""
    prev: dict[str, object] | None = getattr(_TRACE_CTX, "attrs", None)
    _TRACE_CTX.attrs = {**prev, **attrs} if prev else dict(attrs)
    try:
        yield
    finally:
        _TRACE_CTX.attrs = prev


def current_trace_context() -> dict[str, object] | None:
    """The attrs the current thread's open :func:`trace_context` would
    stamp (None outside any context)."""
    return getattr(_TRACE_CTX, "attrs", None)


#: Flight-recorder hook, bound at the first flush so importing this
#: module reads no knob.
_flight_record: "Callable[[Span], None] | None" = None


def _flight(s: Span) -> None:
    global _flight_record
    if _flight_record is None:
        from mpitest_tpu_torch.utils import flight_recorder

        _flight_record = flight_recorder.record
    _flight_record(s)


class SpanLog:
    """Accumulates nested spans; exports JSONL and Chrome trace-event.

    ``stream_path``: when set, every completed span appends one JSON line
    at once (the ``SORT_TRACE`` contract: a crash loses only the spans
    still open, and several runs append like any JSONL)."""

    def __init__(self, stream_path: str | None = None) -> None:
        self.spans: list[Span] = []
        self.stream_path = stream_path
        self.dropped = 0       # spans past MAX_RETAINED_SPANS (streamed only)
        #: called with every completed span; their exceptions are
        #: swallowed, telemetry never takes down the traced path
        self.observers: list[Callable[[Span], None]] = []
        self._stack: list[int] = []
        self._open: list[Span] = []          # the open spans, mirrors _stack
        self._drop_stack: list[bool] = []   # sampler verdicts, mirrors _stack
        #: the trace context of each open span's opener (mirrors _stack);
        #: worker-thread record()s inherit the innermost one
        self._ctx_stack: list[dict[str, object] | None] = []
        self._next_id = 0
        # SORT_TRACE_SAMPLE: stream about `rate` of the root spans, each
        # with its whole subtree; retention, observers and the flight
        # recorder see everything.  Error diffusion keeps root k iff
        # floor((k+1)*rate) != floor(k*rate), so every rate in (0, 1)
        # thins the stream by exactly that fraction in the long run.
        try:
            rate = float(knobs.get("SORT_TRACE_SAMPLE"))
        except ValueError:
            rate = 1.0
        self._sample_rate = min(rate, 1.0)
        self._sample_seq = 0
        #: guards id allocation, retention and the stacks' read pairs
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------
    def _new(self, name: str, attrs: dict[str, object],
             t0: float | None = None, dt: float = 0.0) -> Span:
        ctx = current_trace_context()
        with self._lock:
            if ctx is None and self._ctx_stack:
                # a worker thread reporting under the driver's innermost
                # open span inherits that span's trace context
                ctx = self._ctx_stack[-1]
            if ctx:
                attrs = {**ctx, **attrs}
            s = Span(
                name=name, id=self._next_id,
                parent=self._stack[-1] if self._stack else None,
                t0=time.perf_counter() if t0 is None else t0,
                dt=dt, attrs=attrs,
            )
            self._next_id += 1
            if self._sample_rate < 1.0:
                if self._stack:
                    s.stream_drop = (self._drop_stack[-1]
                                     if self._drop_stack else False)
                else:
                    seq = self._sample_seq
                    self._sample_seq += 1
                    keep = (int((seq + 1) * self._sample_rate)
                            != int(seq * self._sample_rate))
                    s.stream_drop = not keep
        return s

    def _retain(self, s: Span) -> None:
        with self._lock:
            if len(self.spans) < MAX_RETAINED_SPANS:
                self.spans.append(s)
            else:
                self.dropped += 1

    def record(self, name: str, t0: float, dt: float,
               **attrs: object) -> Span:
        """Record a completed interval the caller timed itself, under the
        driver thread's innermost open span; any thread may call it."""
        s = self._new(name, attrs, t0=t0, dt=dt)
        self._retain(s)
        self._flush(s)
        return s

    def add_to_open(self, **amounts: float) -> None:
        """Add ``amounts`` to the innermost open span's attrs, summed per
        key (no-op when none is open)."""
        with self._lock:
            if self._open:
                attrs = self._open[-1].attrs
                for k, v in amounts.items():
                    attrs[k] = attrs.get(k, 0) + v

    def event(self, name: str, **attrs: object) -> Span:
        """Point event (dt=0) under the innermost open span."""
        s = self._new(name, attrs)
        self._retain(s)
        self._flush(s)
        return s

    @contextmanager
    def span(self, name: str, **attrs: object) -> Iterator[Span]:
        """Timed interval, nested under the enclosing open span.  The
        outermost span activates this log for module-level :func:`emit`."""
        s = self._new(name, attrs)
        self._retain(s)
        # push under the lock _new reads under: a worker's record() must
        # see the (parent id, drop verdict) pair consistently, or it
        # could stream a kept span under a dropped parent
        opener_ctx = current_trace_context()
        with self._lock:
            if opener_ctx is None and self._ctx_stack:
                opener_ctx = self._ctx_stack[-1]
            self._stack.append(s.id)
            self._open.append(s)
            self._drop_stack.append(s.stream_drop)
            self._ctx_stack.append(opener_ctx)
            outermost = len(self._stack) == 1
        if outermost:
            _ACTIVE.append(self)
        rf = None
        try:
            rf = _open_range(name)
            yield s
        finally:
            if rf is not None:
                rf.__exit__(None, None, None)
            s.dt = time.perf_counter() - s.t0
            with self._lock:
                self._stack.pop()
                self._open.pop()
                self._drop_stack.pop()
                self._ctx_stack.pop()
            if outermost and _ACTIVE and _ACTIVE[-1] is self:
                _ACTIVE.pop()
            self._flush(s)

    #: serializes stream appends across threads
    _flush_lock = threading.Lock()

    def _flush(self, s: Span) -> None:
        _flight(s)
        for cb in self.observers:
            try:
                cb(s)
            except Exception:  # noqa: BLE001 — observers never break the path
                pass
        if self.stream_path and not s.stream_drop:
            with self._flush_lock, open(self.stream_path, "a") as f:
                f.write(json.dumps(s.to_dict()) + "\n")

    # -- export -------------------------------------------------------
    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(s.to_dict()) for s in self.spans)

    def dump(self, path: str) -> None:
        """Append all retained spans as JSONL (for logs not opened
        streaming)."""
        if self.spans:
            with open(path, "a") as f:
                f.write(self.to_jsonl() + "\n")

    def to_chrome_trace(self) -> dict[str, object]:
        """Chrome trace-event JSON (chrome://tracing, Perfetto).

        Timed spans become ``"ph": "X"`` complete events and point events
        ``"ph": "i"`` instants, in microseconds on the spans' clock, on
        the host driver lane (tid 1); ``utils/timeline.py`` adds one lane
        per rank (estimated from the exchange byte accounting), a disk
        lane and counter tracks."""
        events: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 1,
            "args": {"name": "mpitest_tpu"},
        }]
        for s in self.spans:
            args = dict(s.attrs)
            args["span_id"] = s.id
            if s.parent is not None:
                args["parent_id"] = s.parent
            if s.dt:
                events.append({
                    "name": s.name, "ph": "X", "pid": 1, "tid": 1,
                    "ts": s.t0 * 1e6, "dur": s.dt * 1e6, "args": args,
                })
            else:
                events.append({
                    "name": s.name, "ph": "i", "s": "t", "pid": 1,
                    "tid": 1, "ts": s.t0 * 1e6, "args": args,
                })
        try:
            # lazy: timeline imports this module's interval helpers
            from mpitest_tpu_torch.utils import timeline

            events.extend(timeline.chrome_events(list(self.spans)))
        except Exception:  # noqa: BLE001 — the host lane stands alone
            pass
        return {"traceEvents": events, "displayTimeUnit": "ms"}
