"""Executor cache: one warm packed-sort callable per shape bucket (port of
``mpitest_tpu/serve/executor_cache.py``).

The reference's cache hides XLA's compiler: each entry is an AOT-compiled
executable, built before the first request needs it (prewarm) or once on
the first miss.  PyTorch has no ahead-of-time compile, and the packed
sort is already a callable memoized per (word count, bucket)
(``models/segmented.compile_packed_sort``).  What a cold request pays on
the card is different, and this cache takes it off the request path:

* the lazy CUDA context and caching-allocator setup, and ``torch.sort``'s
  first call at a shape: a miss runs the bucket's packed sort once on the
  cache's device and reads it back, so the entry is warm when it is
  stored;
* on the solo path, the first-use ``nvcc`` build and load of the kernel
  sources (``ops/_build.py``): :meth:`ExecutorCache.prewarm` builds and
  loads every one of them when the device is a card, before the server
  prints its listening line, so a first solo request never meets a cold
  ``nvcc`` inside ``SORT_SERVE_DISPATCH_TIMEOUT_S``.

The build and the warm-up are timed as the miss event's ``compile_s``
(the kernel build rides the first prewarmed entry), so the
``serve.compile_cache`` stream and the ``sort_serve_compile_seconds_total``
counter carry them exactly where the reference carries its compiles.

Shape bucketing (:func:`bucket_for`) is the reference's: request and
batch sizes round up to powers of two, so an unbounded family of shapes
maps to a handful of entries.

The reference runs its prewarm behind a bounded topology probe (a TPU
compiler behind an unreachable tunnel would block forever holding the
GIL) and, when the probe fails, degrades to jit-on-first-use
(``mpitest_tpu/serve/executor_cache.py:198-200``).  Here the bound is the
build's own (``ops/_build.BUILD_TIMEOUT_S``): a build that *timed out*
(``KernelBuildTimeout``) is logged and skipped, the shape buckets still
warm (they run ``torch.sort``), and the first solo request builds the
kernels or raises.  Any other ``KernelBuildError`` keeps the server from
starting.  No path runs a plain version on a card.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from mpitest_tpu_torch.models.segmented import (MIN_BUCKET, PackedSort, bucket_for,
                                                compile_packed_sort,
                                                executable_stats)

if TYPE_CHECKING:
    from mpitest_tpu_torch.utils.spans import SpanLog

__all__ = ["CacheStats", "ExecutorCache", "MIN_BUCKET", "bucket_for"]


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    compile_s: float = 0.0
    prewarmed: int = 0
    buckets: set = field(default_factory=set)


class ExecutorCache:
    """Warm packed-sort callables keyed by (kind, bucket, dtype name,
    total word count), as in the reference: the callable depends on the
    word count and bucket only, so int32 and uint32 share one (through the
    memoized builder) while keeping distinct entries and telemetry.

    ``device`` is where entries warm up: the server process's first rank.
    Without one it is the card (``models/api.resolve_device``), never the
    CPU by default."""

    def __init__(self, spans: "SpanLog | None" = None,
                 device: torch.device | str | None = None) -> None:
        from mpitest_tpu_torch.models.api import resolve_device

        self.device = resolve_device(None, device)
        self._entries: dict[tuple, Callable[..., Any]] = {}
        self._lock = threading.Lock()
        self.stats = CacheStats()
        self.spans = spans

    def snapshot(self) -> dict:
        """Consistent point-in-time stats for the live /varz endpoint,
        copied under the cache lock."""
        with self._lock:
            return {"hits": self.stats.hits,
                    "misses": self.stats.misses,
                    "prewarmed": self.stats.prewarmed,
                    "compile_s": round(self.stats.compile_s, 4),
                    "buckets": sorted(self.stats.buckets)}

    # -- events -------------------------------------------------------
    def _event(self, **attrs: object) -> None:
        if self.spans is not None:
            self.spans.record("serve.compile_cache", time.perf_counter(),
                              0.0, **attrs)

    # -- build --------------------------------------------------------
    def _warm(self, n_words_total: int, bucket: int) -> PackedSort:
        """The bucket's packed sort, run once on the cache's device at its
        shape and read back (pad-only words: every lane the maximum)."""
        exe = compile_packed_sort(n_words_total, bucket)
        words = tuple(np.full(bucket, 0xFFFFFFFF, np.uint32)
                      for _ in range(n_words_total))
        out = exe(*words, device=self.device)
        out[0][-1:].cpu()       # the read-back syncs the device
        return exe

    def build_kernels(self) -> float:
        """Build and load every kernel source (``csrc/*.cu``: K1-K3 on the
        one-rank path, K4 under ``radix_pallas``, K5-K7 on several ranks,
        K8 in the spill tier's merge, the verifier's scan on every path)
        when the device is a card; returns the seconds it took (0 on the
        CPU, where the plain versions run).
        Once built, a call only hashes the sources."""
        if self.device.type != "cuda":
            return 0.0
        from mpitest_tpu_torch.ops import _build

        t0 = time.perf_counter()
        names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
        _build.build(*names)    # one nvcc per source, all started together
        for name in names:
            _build.load(name)
        return time.perf_counter() - t0

    # -- lookup -------------------------------------------------------
    def get_packed(self, bucket: int, dtype_name: str,
                   n_words_total: int) -> Callable[..., Any]:
        """The warm packed-batch callable for a shape bucket (the
        batcher's hot path).  The first call per key warms it (one
        ``serve.compile_cache`` miss event with the seconds); every later
        call is a dict lookup."""
        key = ("packed", bucket, dtype_name, n_words_total)
        with self._lock:
            exe = self._entries.get(key)
            if exe is not None:
                self.stats.hits += 1
                dt = None
            else:
                # warm under the lock: two threads racing on a cold key
                # would otherwise both pay it
                t0 = time.perf_counter()
                exe = self._warm(n_words_total, bucket)
                dt = time.perf_counter() - t0
                self._entries[key] = exe
                self.stats.misses += 1
                self.stats.compile_s += dt
                self.stats.buckets.add(bucket)
        # span observers (metrics bridge, sentinel) run on the emitting
        # thread: never emit while holding the cache lock
        if dt is None:
            self._event(hit=True, bucket=bucket, dtype=dtype_name)
        else:
            self._event(hit=False, bucket=bucket, dtype=dtype_name,
                        compile_s=round(dt, 6), **executable_stats(exe))
        return exe

    def missing_packed(self, buckets: "tuple[int, ...]",
                       dtype_names: "tuple[str, ...]",
                       ) -> "tuple[tuple[int, str], ...]":
        """The (bucket, dtype) pairs no warm entry exists for yet (the
        serve tuner checks this before scheduling a warm-up).  Entries are
        keyed per dtype, so an int32 entry at a bucket does not cover a
        uint64 mix at the same bucket."""
        from mpitest_tpu_torch.ops.keys import codec_for

        out: "list[tuple[int, str]]" = []
        with self._lock:
            for dn in dtype_names:
                nwt = 1 + codec_for(np.dtype(dn)).n_words
                for b in buckets:
                    if ("packed", b, dn, nwt) not in self._entries:
                        out.append((b, dn))
        return tuple(out)

    def _build_detached(self, bucket: int, dtype_name: str,
                        n_words_total: int, extra_s: float = 0.0) -> None:
        """Warm one entry without holding the cache lock for the warm-up;
        ``extra_s`` (the kernel build) is added to its miss event.  A
        racing ``get_packed`` may warm the same cold key; the first insert
        wins."""
        key = ("packed", bucket, dtype_name, n_words_total)
        with self._lock:
            hit = key in self._entries
            if hit:
                self.stats.hits += 1
        if hit:
            self._event(hit=True, bucket=bucket, dtype=dtype_name)
            return
        t0 = time.perf_counter()
        exe = self._warm(n_words_total, bucket)
        dt = time.perf_counter() - t0 + extra_s
        with self._lock:
            fresh = key not in self._entries
            if fresh:
                self._entries[key] = exe
                self.stats.misses += 1
                self.stats.compile_s += dt
                self.stats.buckets.add(bucket)
        if fresh:
            self._event(hit=False, bucket=bucket, dtype=dtype_name,
                        compile_s=round(dt, 6), **executable_stats(exe))

    # -- prewarm ------------------------------------------------------
    def prewarm(self, buckets: "tuple[int, ...]", dtype_names: tuple,
                log: Callable[[str], None] = lambda m: None) -> int:
        """Build and load the kernels (on a card), then warm the configured
        shape buckets before the first request (``SORT_SERVE_SHAPE_BUCKETS``
        x prewarm dtypes); the build's seconds ride the first miss event.
        A build that timed out is skipped (the kernels build on first use);
        any other build failure raises.  Returns the number of entries
        ensured."""
        from mpitest_tpu_torch.ops.keys import codec_for

        from mpitest_tpu_torch.ops import _build

        try:
            build_s = self.build_kernels()
        except _build.KernelBuildTimeout as e:
            log(f"kernel build skipped ({e}); the kernels build on first use")
            build_s = 0.0
        if build_s:
            log(f"built and loaded the kernels in {build_s:.3f} s")
        built = 0
        for dtype_name in dtype_names:
            n_words = codec_for(np.dtype(dtype_name)).n_words
            for b in buckets:
                self._build_detached(b, dtype_name, 1 + n_words,
                                     extra_s=build_s)
                build_s = 0.0
                built += 1
        # prewarm runs at startup and from the tuner's warm-ups
        with self._lock:
            self.stats.prewarmed += built
        log(f"prewarmed {built} executable(s) "
            f"(buckets {sorted(self.stats.buckets)})")
        return built
