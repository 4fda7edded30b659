"""Flight recorder: a bounded in-memory ring of recent spans (port of
``mpitest_tpu/utils/flight_recorder.py``).

Every completed span of every :class:`SpanLog` in the process
(``utils/spans.py`` feeds it from its flush path) lands in one
``collections.deque(maxlen=...)`` ring, costing an append, and the last
``SORT_FLIGHT_RECORDER_SIZE`` spans are dumped to a timestamped JSONL
artifact under ``SORT_FLIGHT_RECORDER_DIR`` when something goes wrong: a
typed sort error (:class:`SortIntegrityError` and the other
``SortFaultError`` types, hooked where they leave ``sort()`` and the
external sort), or a caller's own ``get().dump(reason)``.

Dumps are span-schema JSONL plus one metrics-kind header line naming the
trigger, so the reference's ``python -m mpitest_tpu.report --check
<dump>`` validates them.  Parent links to spans the ring already evicted
are nulled at dump time (a dangling parent is a schema violation).

Dumps are rate-limited per reason (:data:`MIN_DUMP_INTERVAL_S`) and
capped per process (:data:`MAX_DUMPS`), so a fault storm leaves a few
artifacts, never a full disk.  ``SORT_FLIGHT_RECORDER_SIZE=0`` turns
recording off.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import TYPE_CHECKING, Any

from mpitest_tpu_torch.utils import knobs

if TYPE_CHECKING:
    from mpitest_tpu_torch.utils.spans import Span

#: At most one dump per distinct reason per this many seconds — a
#: persistent fault loop documents itself once, not once per firing.
MIN_DUMP_INTERVAL_S = 30.0

#: Hard per-process artifact cap (incident evidence, not a trace log).
MAX_DUMPS = 32


class FlightRecorder:
    """The ring + dump mechanics.  One per process (module singleton via
    :func:`get`); tests may construct their own."""

    def __init__(self, capacity: int, directory: str) -> None:
        self.capacity = int(capacity)
        self.directory = directory
        self.ring: "collections.deque[Any]" = collections.deque(
            maxlen=max(self.capacity, 1))
        self.dumps = 0
        self.recorded = 0
        self._seq = 0
        self._last_dump: dict[str, float] = {}
        # reentrant: dump() snapshots while holding it (rate-limit +
        # ring copy must be one atomic decision)
        self._lock = threading.RLock()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def add(self, span: "Span") -> None:
        """Hot path: one deque append under the ring lock (``list(deque)``
        in a concurrent :meth:`snapshot` raises ``RuntimeError: deque
        mutated during iteration`` against a bare append)."""
        if self.capacity > 0:
            with self._lock:
                self.ring.append(span)
                self.recorded += 1

    def snapshot(self, last_n: int | None = None,
                 kinds: "tuple[str, ...] | None" = None) -> list[dict]:
        """The ring as span dicts: the bounded, lock-consistent read API
        (callers never iterate the deque raw against concurrent appends).
        ``kinds``
        filters by span name (e.g. ``("sort.plan",)``); ``last_n``
        keeps only the newest N rows AFTER filtering.  Parent links are
        sanitized: a parent the ring evicted (or the filter dropped)
        becomes ``None``, so the snapshot passes ``report.py --check``
        (dangling parents are schema errors)."""
        with self._lock:
            spans = list(self.ring)
        if kinds is not None:
            want = frozenset(kinds)
            spans = [s for s in spans if getattr(s, "name", None) in want]
        if last_n is not None and last_n >= 0:
            spans = spans[-last_n:] if last_n else []
        dicts = [s.to_dict() for s in spans]
        present = {(d.get("pid"), d.get("id")) for d in dicts}
        for d in dicts:
            if d.get("parent") is not None and \
                    (d.get("pid"), d.get("parent")) not in present:
                d["parent"] = None
        return dicts

    def dump(self, reason: str, rate_limit: bool = False) -> str | None:
        """Write the ring to ``<dir>/flight-<pid>-<seq>-<reason>.jsonl``;
        returns the path (None when disabled, empty, rate-limited or
        past the cap).  Never raises — an incident artifact that cannot
        be written must not compound the incident."""
        if not self.enabled:
            return None
        reason = "".join(c if c.isalnum() or c in "_-" else "_"
                         for c in reason)[:48] or "unknown"
        with self._lock:
            now = time.monotonic()
            if self.dumps >= MAX_DUMPS:
                return None
            if rate_limit and \
                    now - self._last_dump.get(reason, -1e9) \
                    < MIN_DUMP_INTERVAL_S:
                return None
            self._last_dump[reason] = now
            self._seq += 1
            seq = self._seq
            rows = self.snapshot()
            if not rows:
                return None
            self.dumps += 1
        ts = time.strftime("%Y%m%dT%H%M%S")
        path = os.path.join(
            self.directory,
            f"flight-{os.getpid()}-{seq:03d}-{reason}-{ts}.jsonl")
        try:
            os.makedirs(self.directory, exist_ok=True)
            header = {"config": {"driver": "flight_recorder",
                                 "reason": reason, "pid": os.getpid(),
                                 "ts": time.time()},
                      "metrics": {"flight_spans": {"value": len(rows)}}}
            with open(path, "w") as f:
                f.write(json.dumps(header) + "\n")
                for d in rows:
                    f.write(json.dumps(d) + "\n")
        except OSError:
            return None
        return path


_SINGLETON: FlightRecorder | None = None
_SINGLETON_LOCK = threading.Lock()


def get() -> FlightRecorder:
    """The process-wide recorder, configured from the knobs at first
    use (``SORT_FLIGHT_RECORDER_SIZE`` / ``SORT_FLIGHT_RECORDER_DIR``)."""
    global _SINGLETON
    rec = _SINGLETON
    if rec is None:
        with _SINGLETON_LOCK:
            rec = _SINGLETON
            if rec is None:
                try:
                    cap = knobs.get("SORT_FLIGHT_RECORDER_SIZE")
                    directory = knobs.get("SORT_FLIGHT_RECORDER_DIR")
                except ValueError:
                    # garbage knob values: the drivers fail fast on
                    # these; a library user gets a disabled recorder,
                    # never a crash from the telemetry layer
                    cap, directory = 0, "."
                rec = _SINGLETON = FlightRecorder(cap, directory)
    return rec


def reset() -> None:
    """Drop the singleton so the next :func:`get` re-reads the knobs
    (tests reconfigure the recorder through ``knobs.scoped_env``)."""
    global _SINGLETON
    with _SINGLETON_LOCK:
        _SINGLETON = None


def record(span: "Span") -> None:
    """SpanLog flush hook (called for every completed span)."""
    get().add(span)


def dump_on_error(reason: str) -> str | None:
    """Incident chokepoint: dump the ring, rate-limited per reason.
    Never raises."""
    try:
        return get().dump(reason, rate_limit=True)
    except Exception:
        return None
