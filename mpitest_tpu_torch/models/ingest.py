"""Streamed ingest and egress: chunked, double-buffered host <-> device
transfer (port of ``mpitest_tpu/models/ingest.py``).

The ingest pipeline runs three stages over fixed-size chunks of host
keys:

* **parse** (one producer thread): materialize chunk k (a page-in for an
  mmap-backed SORTBIN1 file under the numpy engine, a slice view
  otherwise) and hand it to a bounded queue of depth 2.
* **encode** (``SORT_INGEST_THREADS`` workers): encode chunk k into
  uint32 words while chunk k-1 transfers, folding the chunk's per-word
  min and max (the radix pass planner's input), its maximum key (the
  pad) and its fingerprint (``utils/native_encode.encode_and_fold``, one
  C pass or the numpy passes), so the sort needs no second host pass.
  The fingerprint is folded from the host chunks, never from the device
  words.
* **transfer** (one thread, chunks in order): copy the encoded chunk
  into a pinned host staging buffer, then into each rank's preallocated
  shard at its offset (``parallel/mesh.alloc_shards``, no concatenate)
  with ``copy_(..., non_blocking=True)`` on a side CUDA stream the
  thread owns, and wait for that chunk's copy event.  A staging buffer
  is reused only after its last copy's event has completed.  Before the
  first copy the side stream waits on the stream that allocated the
  shards; at the end the caller's stream waits on the side stream's
  last work and each shard records the side stream
  (``record_stream``), so the sort reads complete words.  CPU ranks
  (the tests) copy directly.

Each stage records its ``ingest.*`` span, and ``ingest.pipeline`` closes
the run with its stage seconds and ``overlap_efficiency``.  The result is
a :class:`StagedIngest` that ``models.api.sort`` takes in place of raw
keys.  An exception in any worker thread propagates to the caller.

Egress (:func:`stream_result_to_numpy`) mirrors it: a fetch thread copies
shard k+1 device -> pinned host memory on its own stream while shard k
decodes, with ``egress.fetch`` and ``egress.decode`` spans.

The ``ingest_poison`` fault site (``faults.maybe_poison_chunk``) corrupts
an encoded chunk after its fingerprint fold, as in the reference.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from mpitest_tpu_torch import faults
from mpitest_tpu_torch.models.supervisor import verify_enabled
from mpitest_tpu_torch.models.verify import Fingerprint
from mpitest_tpu_torch.ops.keys import codec_for, numpy_dtype
from mpitest_tpu_torch.parallel.mesh import Mesh, alloc_shards, shard_bounds
from mpitest_tpu_torch.utils import io as kio
from mpitest_tpu_torch.utils import native_encode
from mpitest_tpu_torch.utils.spans import SpanLog, merge_intervals, overlap_seconds

if TYPE_CHECKING:
    from mpitest_tpu_torch.utils.trace import Tracer

Words = tuple[torch.Tensor, ...]

#: ``SORT_INGEST=auto`` streams only inputs of at least this many key
#: bytes; below it the one-shot encode and copy is cheaper than the
#: pipeline's threads.
STREAM_MIN_BYTES = 1 << 25

#: ``auto`` streamed-egress threshold (result bytes).
EGRESS_MIN_BYTES = 1 << 22

#: Pinned staging buffers of the transfer stage (double buffering).
_STAGING_BUFFERS = 2


def checked_device_put(x: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """Host array -> tensor on ``device`` that keeps its dtype, raising on
    any change.  uint32 words land as the port's int32 carriers (the same
    bits, ``ops/keys.py``); every other dtype lands as itself."""
    src = np.dtype(x.dtype)
    host = np.ascontiguousarray(x)
    if src == np.dtype(np.uint32):
        host = host.view(np.int32)
    out = torch.from_numpy(host).to(device)
    got = numpy_dtype(out.dtype)
    if got != host.dtype:
        raise TypeError(f"host->device copy changed dtype {src} -> {got}")
    return out


def use_stream(n_bytes: int) -> bool:
    """Resolve ``SORT_INGEST`` against the input size."""
    mode = kio.ingest_mode()
    if mode == "stream":
        return True
    if mode == "mono":
        return False
    return n_bytes >= STREAM_MIN_BYTES


@dataclass
class IngestStats:
    """Wall and stage accounting of one streamed ingest."""

    n: int = 0
    chunks: int = 0
    host_bytes: int = 0       # native key bytes read
    device_bytes: int = 0     # encoded word bytes shipped (pads included)
    parse_s: float = 0.0
    encode_s: float = 0.0
    transfer_s: float = 0.0
    wall_s: float = 0.0
    #: the encode engine that ran ("native" | "python")
    encode_engine: str = "python"
    host_iv: list = field(default_factory=list)  # (t0, t1) parse/encode
    xfer_iv: list = field(default_factory=list)  # (t0, t1) transfers

    def overlap_efficiency(self) -> float:
        """Fraction of transfer wall time hidden under host parse/encode
        work: interval intersection on one ``perf_counter`` timeline."""
        xm = merge_intervals(self.xfer_iv)
        xfer = sum(b - a for a, b in xm)
        if xfer <= 0:
            return 0.0
        return overlap_seconds(merge_intervals(self.host_iv), xm) / xfer


@dataclass
class StagedIngest:
    """Encoded, padded, per-rank key words plus what the sort needs to plan
    without another pass over the data; ``models.api.sort`` takes it in
    place of raw keys."""

    words: list                      # per rank: uint32 word planes, msw first
    n_valid: int                     # real keys (excludes padding)
    dtype: np.dtype
    word_diffs: tuple                # per-word max ^ min (pass-planner input)
    mesh: Mesh
    stats: IngestStats
    #: host source for rebuilds after a donated dispatch; None: the sort
    #: must not donate
    source: np.ndarray | None = None
    #: the pipeline configuration a rebuild replays
    tracer: object | None = None
    chunk_elems: int | None = None
    threads: int | None = None
    #: set by a donating sort: the words were dropped after its first
    #: dispatch, so the object is single-use (see :meth:`rebuild`)
    consumed: bool = False
    #: input-side fingerprint folded from the host chunks; None when
    #: verification was off during staging
    fingerprint: Fingerprint | None = None

    @property
    def size(self) -> int:
        """Key count, as ``ndarray.size``."""
        return self.n_valid

    def rebuild(self) -> "StagedIngest":
        if self.source is None:
            raise ValueError("StagedIngest has no source to re-stream from")
        return stream_to_mesh(self.source, self.mesh, tracer=self.tracer,
                              chunk_elems=self.chunk_elems, threads=self.threads)


class _StreamState:
    """Cross-thread accumulator of stats and planner inputs."""

    def __init__(self, n_words: int, fold_fp: bool = True) -> None:
        self.lock = threading.Lock()
        self.word_min: list = [None] * n_words
        self.word_max: list = [None] * n_words
        self.native_max: Any = None
        self.stats = IngestStats()
        #: running input fingerprint; ``fold_fp=False`` (SORT_VERIFY=0)
        #: skips the per-chunk folds
        self.fold_fp = fold_fp
        self.fp = Fingerprint(0, (0,) * n_words, (0,) * n_words) if fold_fp else None

    def apply_fold(self, los: list, his: list, m: object,
                   chunk_fp: Fingerprint | None, t0: float, dt_s: float) -> None:
        """Merge one chunk's reductions (computed by the encode worker
        outside the lock) into the running state."""
        with self.lock:
            self.stats.encode_s += dt_s
            self.stats.host_iv.append((t0, t0 + dt_s))
            if chunk_fp is not None:
                self.fp = self.fp.combine(chunk_fp)
            for i, (lo, hi) in enumerate(zip(los, his)):
                if self.word_min[i] is None or lo < self.word_min[i]:
                    self.word_min[i] = lo
                if self.word_max[i] is None or hi > self.word_max[i]:
                    self.word_max[i] = hi
            if m is not None and (self.native_max is None or m > self.native_max):
                self.native_max = m

    def word_diffs(self, n_words: int) -> tuple:
        return tuple((self.word_max[i] ^ self.word_min[i])
                     if self.word_min[i] is not None else 0
                     for i in range(n_words))


def _spans_of(tracer: "Tracer | None") -> SpanLog | None:
    return tracer.spans if tracer is not None else None


class _CardCopier:
    """The transfer stage's device side, used only from the transfer
    thread: pinned staging buffers, one side stream per card, and the
    copies of a chunk's pieces into the shards."""

    def __init__(self, n_words: int, elems: int,
                 ready: dict[torch.device, torch.cuda.Event]) -> None:
        self.n_words = n_words
        self.ready = ready
        self.streams: dict[torch.device, torch.cuda.Stream] = {}
        self.free: deque = deque(
            (torch.empty((n_words, elems), dtype=torch.int32, pin_memory=True), [])
            for _ in range(_STAGING_BUFFERS))
        self.used: set = set()

    def _stream(self, dev: torch.device) -> torch.cuda.Stream:
        s = self.streams.get(dev)
        if s is None:
            with torch.cuda.device(dev):
                s = torch.cuda.Stream(device=dev)
                # the shards were allocated on the caller's stream
                s.wait_event(self.ready[dev])
            self.streams[dev] = s
        return s

    def copy(self, words: tuple[np.ndarray, ...],
             pieces: list[tuple[tuple[torch.Tensor, ...], int, int, int]]) -> None:
        """Stage ``words`` in a pinned buffer and copy each piece
        ``(shard planes, dst offset, src offset, length)``; returns once
        the chunk's copies have completed."""
        buf, events = self.free.popleft()
        for ev in events:       # reuse only after the buffer's last copy
            ev.synchronize()
        clen = words[0].size
        for j, w in enumerate(words):
            buf[j, :clen].numpy().view(np.uint32)[:] = w
        events = []
        for planes, dst, src, ln in pieces:
            dev = planes[0].device
            s = self._stream(dev)
            with torch.cuda.device(dev), torch.cuda.stream(s):
                for j, p in enumerate(planes):
                    p[dst:dst + ln].copy_(buf[j, src:src + ln], non_blocking=True)
                    if id(p) not in self.used:
                        p.record_stream(s)
                        self.used.add(id(p))
                ev = torch.cuda.Event()
                ev.record(s)
            events.append(ev)
        self.free.append((buf, events))
        for ev in events:       # the chunk's copies complete, as the stage's time
            ev.synchronize()

    def finish(self) -> None:
        """The callers' streams wait on every side stream's work."""
        for dev, s in self.streams.items():
            torch.cuda.current_stream(dev).wait_stream(s)


def stream_to_mesh(x: np.ndarray, mesh: Mesh, tracer: "Tracer | None" = None,
                   chunk_elems: int | None = None,
                   threads: int | None = None) -> StagedIngest:
    """Run the parse -> encode -> transfer pipeline over host keys ``x`` (a
    numpy array, possibly mmap-backed) onto the ranks of ``mesh`` and
    return the :class:`StagedIngest` the sort consumes.

    Deterministic: chunk boundaries are fixed arithmetic, the encode is
    elementwise, and the one transfer thread lands chunks in order, so
    the shards hold the same words as the one-shot path's
    (``models/api._shard_input``).  On a mesh across processes every
    process encodes and folds the whole input (the planner's diffs, the
    pad and the fingerprint stay the same everywhere) and copies only
    the pieces of its own ranks' shards."""
    t_wall = time.perf_counter()
    x = np.asarray(x).reshape(-1)
    dtype = np.dtype(x.dtype)
    codec = codec_for(dtype)
    N = int(x.size)
    if N == 0:
        raise ValueError("cannot stream an empty key array")
    chunk_elems = chunk_elems or kio.ingest_chunk_elems()
    threads = threads or kio.ingest_threads()
    eng = native_encode.engine()   # resolved once a run
    n_ranks = mesh.size
    n = max(1, math.ceil(N / n_ranks))
    total = n_ranks * n
    bounds = shard_bounds(mesh, n)
    spans = _spans_of(tracer)
    state = _StreamState(codec.n_words, fold_fp=verify_enabled())
    state.stats.n = N
    state.stats.encode_engine = eng
    shards = alloc_shards(mesh, n, codec.n_words)
    cards = sorted({d for d in mesh.local_devices if d.type == "cuda"},
                   key=lambda d: d.index)
    if cards and len(cards) != len(set(mesh.local_devices)):
        raise ValueError("a mesh mixing cpu and cuda ranks cannot stream")
    ready = {}
    for d in cards:
        ready[d] = torch.cuda.Event()
        ready[d].record(torch.cuda.current_stream(d))
    copier: _CardCopier | None = None
    # the numpy engine pages an mmap-backed chunk in during parse; the C
    # engine reads the pages in place during its one pass
    materialize = False
    if eng != "native":
        b = x
        while b is not None:
            if isinstance(b, np.memmap):
                materialize = True
                break
            b = getattr(b, "base", None)

    abort = threading.Event()

    def _put(q: queue.Queue, item: object) -> bool:
        """Bounded put that gives up once the consumer aborted."""
        while not abort.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def parse_chunks(q: queue.Queue) -> None:
        try:
            off = 0
            k = 0
            while off < N:
                t0 = time.perf_counter()
                c = x[off:off + chunk_elems]
                if materialize:
                    c = np.array(c)
                dt = time.perf_counter() - t0
                with state.lock:
                    state.stats.parse_s += dt
                    state.stats.host_iv.append((t0, t0 + dt))
                    state.stats.chunks += 1
                    state.stats.host_bytes += c.nbytes
                if spans is not None:
                    spans.record("ingest.parse", t0, dt, chunk=k, n=int(c.size),
                                 bytes=int(c.nbytes))
                if not _put(q, (k, off, c)):
                    return
                off += c.size
                k += 1
            _put(q, None)
        except BaseException as e:  # the consumer raises it
            _put(q, e)

    def encode_one(k: int, chunk: np.ndarray) -> tuple[np.ndarray, ...]:
        t0 = time.perf_counter()
        words, los, his, m, chunk_fp = native_encode.encode_and_fold(
            chunk, codec, state.fold_fp, eng)
        dt = time.perf_counter() - t0
        state.apply_fold(los, his, m, chunk_fp, t0, dt)
        # SORT_FAULTS=ingest_poison: corrupt AFTER the fingerprint fold, so
        # the card receives bytes the fingerprint never saw
        words = faults.maybe_poison_chunk(words, k)
        if spans is not None:
            spans.record("ingest.encode", t0, dt, chunk=k, n=int(chunk.size),
                         engine=eng, bytes=int(sum(w.nbytes for w in words)))
        return words

    def transfer_one(k: int, off: int, words: tuple[np.ndarray, ...],
                     pad: bool = False) -> None:
        nonlocal copier
        t0 = time.perf_counter()
        clen = words[0].size
        pieces = []
        for d, (_dev, start, stop) in enumerate(bounds):
            a, b = max(off, start), min(off + clen, stop)
            if a < b:
                pieces.append((shards[d], a - start, a - off, b - a))
        if not pieces:
            return   # the chunk belongs to other processes' ranks
        if cards:
            if copier is None:
                # the pad chunk holds fewer than n_ranks keys
                copier = _CardCopier(codec.n_words,
                                     min(max(chunk_elems, n_ranks), total), ready)
            copier.copy(words, pieces)
        else:
            for planes, dst, src, ln in pieces:
                for p, w in zip(planes, words):
                    p[dst:dst + ln].copy_(torch.from_numpy(w[src:src + ln].view(np.int32)))
        nbytes = sum(ln for _, _, _, ln in pieces) * 4 * codec.n_words
        dt = time.perf_counter() - t0
        with state.lock:
            state.stats.transfer_s += dt
            state.stats.xfer_iv.append((t0, t0 + dt))
            state.stats.device_bytes += nbytes
        if spans is not None:
            attrs: dict[str, object] = {"chunk": k, "bytes": int(nbytes)}
            if pad:
                attrs["pad"] = True
            spans.record("ingest.transfer", t0, dt, **attrs)

    q: queue.Queue = queue.Queue(maxsize=2)
    producer = threading.Thread(target=parse_chunks, args=(q,),
                                name="ingest-parse", daemon=True)
    producer.start()
    enc_pool = ThreadPoolExecutor(threads, thread_name_prefix="ingest-enc")
    xfer_pool = ThreadPoolExecutor(1, thread_name_prefix="ingest-xfer")
    try:
        encodes: deque = deque()   # (k, off, future) in chunk order
        xfers: deque = deque()     # transfer futures in chunk order

        def drain_encode_front() -> None:
            k0, off0, ef = encodes.popleft()
            xfers.append(xfer_pool.submit(transfer_one, k0, off0, ef.result()))
            while len(xfers) > 2:   # at most two chunk transfers queued
                xfers.popleft().result()

        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            k, off, chunk = item
            encodes.append((k, off, enc_pool.submit(encode_one, k, chunk)))
            # a finished encode goes to the transfer thread at once; up to
            # `threads` encodes run before the oldest is waited for
            while encodes and (encodes[0][2].done() or len(encodes) > threads):
                drain_encode_front()
        while encodes:
            drain_encode_front()
        while xfers:
            xfers.popleft().result()
        producer.join()

        # the pad: the maximum real key (floats: the all-ones sentinel), a
        # tail chunk at offset N through the same transfer stage
        if total > N:
            if dtype.kind == "f":
                pad_words = codec.max_sentinel()
            else:
                pad_words = tuple(int(w[0]) for w in codec.encode(
                    np.asarray([state.native_max], dtype)))
            xfer_pool.submit(transfer_one, -1, N, tuple(
                np.full(total - N, pw, np.uint32) for pw in pad_words),
                True).result()
        if copier is not None:
            copier.finish()
    finally:
        # reap the producer first (it may be parked on a full queue)
        abort.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        producer.join(timeout=5.0)
        enc_pool.shutdown(wait=True)
        xfer_pool.shutdown(wait=True)

    state.stats.wall_s = time.perf_counter() - t_wall
    if spans is not None:
        spans.record("ingest.pipeline", t_wall, state.stats.wall_s,
                     n=N, chunks=state.stats.chunks, encode_engine=eng,
                     parse_s=round(state.stats.parse_s, 6),
                     encode_s=round(state.stats.encode_s, 6),
                     transfer_s=round(state.stats.transfer_s, 6),
                     overlap_efficiency=round(state.stats.overlap_efficiency(), 4))
    return StagedIngest(
        words=shards, n_valid=N, dtype=dtype,
        word_diffs=state.word_diffs(codec.n_words), mesh=mesh,
        stats=state.stats, source=x, tracer=tracer, chunk_elems=chunk_elems,
        threads=threads, fingerprint=state.fp)


def stream_result_to_numpy(shards: "tuple[Words, ...] | list[Words]", n_valid: int,
                           dtype: np.dtype | str,
                           tracer: "Tracer | None" = None) -> np.ndarray:
    """Streamed egress of a contiguous result (rank r's keys follow rank
    r-1's): a fetch thread copies shard k+1 device -> pinned host memory
    on its own stream while shard k decodes.  The decode is elementwise,
    so per-shard decode is exact; each shard is cut at ``n_valid``."""
    codec = codec_for(np.dtype(dtype))
    spans = _spans_of(tracer)
    out = np.empty(n_valid, np.dtype(dtype))
    starts = np.concatenate([[0], np.cumsum([int(s[0].numel()) for s in shards])])
    n_shards = len(shards)
    lens = [max(0, min(int(starts[i + 1]), n_valid) - int(starts[i]))
            for i in range(n_shards)]
    n_words = len(shards[0])
    on_card = shards[0][0].device.type == "cuda"
    ready: dict[torch.device, torch.cuda.Event] = {}
    bufs: list[torch.Tensor] = []
    if on_card:
        for s in shards:
            d = s[0].device
            if d not in ready:
                ready[d] = torch.cuda.Event()
                ready[d].record(torch.cuda.current_stream(d))
        # two pinned slots: fetch i + 2 reuses slot i % 2, and is submitted
        # only after shard i has decoded
        bufs = [torch.empty((n_words, max(max(lens), 1)), dtype=torch.int32,
                            pin_memory=True) for _ in range(min(2, n_shards))]
    streams: dict[torch.device, torch.cuda.Stream] = {}

    def fetch(i: int) -> tuple[np.ndarray, ...]:
        t0 = time.perf_counter()
        ln = lens[i]
        if on_card:
            dev = shards[i][0].device
            s = streams.get(dev)
            if s is None:
                with torch.cuda.device(dev):
                    s = streams[dev] = torch.cuda.Stream(device=dev)
                    s.wait_event(ready[dev])
            buf = bufs[i % len(bufs)]
            with torch.cuda.device(dev), torch.cuda.stream(s):
                for j, w in enumerate(shards[i]):
                    buf[j, :ln].copy_(w[:ln], non_blocking=True)
                    w.record_stream(s)
                ev = torch.cuda.Event()
                ev.record(s)
            ev.synchronize()
            host = tuple(buf[j, :ln].numpy().view(np.uint32) for j in range(n_words))
        else:
            host = tuple(w[:ln].numpy().view(np.uint32) for w in shards[i])
        dt = time.perf_counter() - t0
        if spans is not None:
            spans.record("egress.fetch", t0, dt, shard=i,
                         bytes=int(sum(h.nbytes for h in host)))
        return host

    def decode(i: int, host: tuple[np.ndarray, ...]) -> None:
        a, ln = int(starts[i]), lens[i]
        if ln <= 0:
            return
        t0 = time.perf_counter()
        out[a:a + ln] = codec.decode(host)
        dt = time.perf_counter() - t0
        if spans is not None:
            spans.record("egress.decode", t0, dt, shard=i, n=int(ln),
                         bytes=int(ln * out.itemsize))

    with ThreadPoolExecutor(1, thread_name_prefix="egress-fetch") as pool:
        nxt = pool.submit(fetch, 0)
        for i in range(n_shards):
            host = nxt.result()
            if i + 1 < n_shards:
                nxt = pool.submit(fetch, i + 1)
            decode(i, host)
    return out
