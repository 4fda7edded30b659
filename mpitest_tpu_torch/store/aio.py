"""Async spill IO for the merge phase: read-ahead + write-behind (port of
``mpitest_tpu/store/aio.py``).

A synchronous merge alternates between disk and compute: read a block,
decode it, merge it, encode the output, write it — the disk idles while
numpy runs and numpy idles while the disk runs.  This module overlaps
the two with bounded double buffering:

* :class:`ReadAhead` — one daemon thread (``spill-readahead``) per input
  run decodes the NEXT chunk (disk read + block decompression, both
  GIL-releasing in the native codec) while the merge consumes the
  current one, through a ``Queue(maxsize=2)``.  The thread puts a
  terminal ``None`` at EOF and the exception object itself on failure,
  so typed run-corruption errors (:class:`~mpitest_tpu_torch.store.runs.
  BlockIntegrityError`) surface in the consumer as the synchronous path
  raises them.
* :class:`WriteBehind` — one daemon thread (``spill-writebehind``)
  drains output chunks into a :class:`~mpitest_tpu_torch.store.runs.
  RunStreamWriter` (compression, throttle and writes behind the emit
  loop); writer errors re-raise at the next ``append_words`` / ``close``.
* :class:`MergeIO` — owns the threads of one merge, aggregates their
  disk-busy and consumer-stall intervals, and computes the **disk
  overlap**: how much of the disk's busy time ran concurrently with
  merge compute.

The threads run host code and the native codec only; no CUDA call is
made from them.  Shutdown: an abort event, bounded ``put(timeout=...)``
polls against it, and ``close()`` drains and joins, so an abandoned
merge never leaks a wedged producer.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

from mpitest_tpu_torch.store import runs as runlib
from mpitest_tpu_torch.utils.spans import merge_intervals, overlap_seconds

#: Bounded hand-off depth: one chunk in flight + one buffered is what
#: makes this double (not unbounded) buffering — memory stays at
#: O(queue depth × chunk) per run, same as the synchronous path's
#: single chunk up to a small constant.
QUEUE_DEPTH = 2

#: Poll granularity of abortable queue puts: block in small slices so
#: an abort is honored within ~50 ms.
_PUT_POLL_S = 0.05

#: Joins are bounded — a wedged thread is reported, never waited on
#: forever (the drill-friendly failure mode is loud, not hung).
_JOIN_TIMEOUT_S = 10.0

#: Stalls shorter than this are queue bookkeeping, not waiting.
_STALL_FLOOR_S = 1e-6


def subtract_intervals(span: tuple[float, float],
                       busy: list[tuple[float, float]],
                       ) -> list[tuple[float, float]]:
    """``[span] - busy``: the parts of one interval NOT covered by a
    MERGED (sorted, disjoint) interval list — how the merge's compute
    time is derived from its wall span minus its consumer stalls."""
    t0, t1 = span
    out: list[tuple[float, float]] = []
    cur = t0
    for a, b in busy:
        if b <= cur:
            continue
        if a >= t1:
            break
        if a > cur:
            out.append((cur, min(a, t1)))
        cur = max(cur, b)
        if cur >= t1:
            return out
    if cur < t1:
        out.append((cur, t1))
    return out


class ReadAhead:
    """Iterator over one run's chunks, decoded one chunk ahead.

    Drop-in for :func:`store.runs.read_run_chunks` — same items, same
    exceptions — plus ``close()`` (idempotent; also invoked by
    ``merge_runs``'s cursor cleanup) and stall/IO interval stats."""

    def __init__(self, info: "runlib.RunInfo", chunk_elems: int) -> None:
        self.info = info
        self.chunk_elems = int(chunk_elems)
        #: (t0, t1) spans the worker spent in disk read + decode
        self.io_intervals: list[tuple[float, float]] = []
        #: (t0, t1) spans the CONSUMER waited on an empty queue
        self.stall_intervals: list[tuple[float, float]] = []
        self._lock = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        self._abort = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._worker, name="spill-readahead", daemon=True)
        self._thread.start()

    # -- producer side -------------------------------------------------

    def _put(self, item: object) -> bool:
        while not self._abort.is_set():
            try:
                self._q.put(item, timeout=_PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            chunks = runlib.read_run_chunks(self.info, self.chunk_elems)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(chunks)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                with self._lock:
                    self.io_intervals.append((t0, t1))
                # the put-wait is NOT disk time: it is the consumer
                # lagging, excluded so overlap math sees real IO only
                if not self._put(item):
                    return
            self._put(None)
        except BaseException as e:  # re-raised at the consumer's next()
            self._put(e)

    # -- consumer side -------------------------------------------------

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        t1 = time.perf_counter()
        if t1 - t0 > _STALL_FLOOR_S:
            with self._lock:
                self.stall_intervals.append((t0, t1))
        if item is None:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        """Stop the worker, drain the queue, join — idempotent."""
        if self._closed:
            return
        self._closed = True
        self._abort.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=_JOIN_TIMEOUT_S)

    def snapshot(self) -> tuple[list, list]:
        with self._lock:
            return list(self.io_intervals), list(self.stall_intervals)


class WriteBehind:
    """Run-writer facade that moves the disk work off the emit loop.

    ``append_words`` enqueues the chunk and returns immediately; the
    worker thread performs the real ``RunStreamWriter.append_words``
    (encode + compress + throttle + write).  A writer failure parks the
    exception and aborts the queue; it re-raises — with the original
    type — at the caller's next ``append_words`` or ``close``."""

    def __init__(self, writer: "runlib.RunStreamWriter") -> None:
        self.writer = writer
        self.io_intervals: list[tuple[float, float]] = []
        self.stall_intervals: list[tuple[float, float]] = []
        self._lock = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        self._abort = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._worker, name="spill-writebehind", daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            kind, a, b = item
            t0 = time.perf_counter()
            try:
                if kind == "words":
                    self.writer.append_words(a, b)
                else:
                    self.writer.append(a, b)
            except BaseException as e:
                with self._lock:
                    self._err = e
                # unblock any producer stuck on a full queue
                self._abort.set()
                return
            t1 = time.perf_counter()
            with self._lock:
                self.io_intervals.append((t0, t1))

    def _raise_pending(self) -> None:
        with self._lock:
            err = self._err
            self._err = None
        if err is not None:
            raise err

    def _enqueue(self, item: tuple) -> None:
        self._raise_pending()
        t0 = time.perf_counter()
        while not self._abort.is_set():
            try:
                self._q.put(item, timeout=_PUT_POLL_S)
                t1 = time.perf_counter()
                if t1 - t0 > _STALL_FLOOR_S:
                    with self._lock:
                        self.stall_intervals.append((t0, t1))
                return
            except queue.Full:
                continue
        # abort set: the worker died — surface why
        self._raise_pending()
        raise RuntimeError("write-behind worker stopped")

    def append_words(self, key_words: tuple, payload_words: tuple,
                     ) -> None:
        self._enqueue(("words", key_words, payload_words))

    def append(self, keys, payload=None) -> None:
        self._enqueue(("rows", keys, payload))

    def close(self) -> "runlib.RunInfo":
        """Flush the queue, stop the worker, close the writer (final
        block flush + fsync/publish run on the CALLER, timed as disk
        work) and return the published :class:`RunInfo`."""
        self._raise_pending()
        while not self._abort.is_set():
            try:
                self._q.put(None, timeout=_PUT_POLL_S)
                break
            except queue.Full:
                continue
        self._thread.join(timeout=_JOIN_TIMEOUT_S)
        self._raise_pending()
        if self._thread.is_alive():  # pragma: no cover - wedge guard
            raise RuntimeError("write-behind worker failed to drain")
        t0 = time.perf_counter()
        info = self.writer.close()
        with self._lock:
            self.io_intervals.append((t0, time.perf_counter()))
        return info

    def abort(self) -> None:
        """Failed-merge cleanup: stop the worker, delete the partial."""
        self._abort.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        try:
            # wake an idle worker blocked in get(): without the sentinel
            # the join below waits out its whole timeout
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=_JOIN_TIMEOUT_S)
        self.writer.abort()

    def snapshot(self) -> tuple[list, list]:
        with self._lock:
            return list(self.io_intervals), list(self.stall_intervals)


class MergeIO:
    """The async-IO engine of ONE merge: read-ahead sources for its
    input runs, an optional write-behind sink, and the aggregated
    overlap stats the external sort stamps on its merge span."""

    def __init__(self) -> None:
        self.readers: list[ReadAhead] = []
        self.writers: list[WriteBehind] = []

    def source(self, info: "runlib.RunInfo", chunk_elems: int,
               ) -> ReadAhead:
        """Chunk iterator for ``merge_runs(..., io=self)``."""
        ra = ReadAhead(info, chunk_elems)
        self.readers.append(ra)
        return ra

    def wrap_writer(self, writer: "runlib.RunStreamWriter",
                    ) -> WriteBehind:
        wb = WriteBehind(writer)
        self.writers.append(wb)
        return wb

    def close(self) -> None:
        for ra in self.readers:
            ra.close()

    def stats(self, t0: float, t1: float) -> dict[str, float]:
        """Overlap accounting over the merge wall span ``[t0, t1]``.

        *disk* = union of every reader/writer IO interval.  *compute*
        = the wall span minus the union of consumer-side stalls (queue
        waits are neither disk nor compute).  ``disk_overlap`` is the
        concurrency fraction ``overlap / min(disk, compute)`` — 1.0
        means the scarcer activity was fully hidden behind the other,
        ~0 means the merge alternated (synchronous behavior)."""
        self.close()
        io_iv: list[tuple[float, float]] = []
        stall_iv: list[tuple[float, float]] = []
        for src in (*self.readers, *self.writers):
            io, stall = src.snapshot()
            io_iv.extend(io)
            stall_iv.extend(stall)
        disk = merge_intervals([(a, b) for a, b in io_iv if b > a])
        stalls = merge_intervals(
            [(a, b) for a, b in stall_iv if b > a])
        compute = subtract_intervals((t0, t1), stalls)
        total_disk = sum(b - a for a, b in disk)
        total_compute = sum(b - a for a, b in compute)
        ov = overlap_seconds(disk, compute)
        denom = min(total_disk, total_compute)
        frac = ov / denom if denom > 1e-9 else 0.0
        return {
            "disk_busy_s": total_disk,
            "overlap_s": ov,
            "disk_overlap": min(1.0, frac),
        }
