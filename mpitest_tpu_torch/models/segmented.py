"""Segmented (multi-tenant) batched sort: pack, dispatch, split and verify
(port of ``mpitest_tpu/models/segmented.py``).

Many small requests sort in one device dispatch.  Request ``i``'s keys
encode through the order-preserving codec (``ops/keys.py``) and a
constant word holding the segment id ``i`` is prepended as the most
significant word, so one lexicographic sort of ``(seg, *key_words)``
orders by segment, then by key: every segment sorts independently, and
its slice of the output is byte-equal to sorting that request alone.
Pad lanes carry :data:`PAD_SEG` (the uint32 maximum) and sort to the
global tail.

Shapes are power-of-two buckets (:func:`bucket_for`), and the packed
sort is one callable per (word count, bucket), memoized by
:func:`compile_packed_sort`: there is no ahead-of-time compile in
PyTorch, so the shape-bucket key is the cache.  The sort is the
reference's ``lax.sort`` program, which in the port is ``torch.sort``
(``kernels.local_sort`` with the ``lax`` engine): no hand-written kernel
runs here.

Verification is per segment and on the host: each segment must be
lexicographically sorted and reproduce the fingerprint folded at pack
time, so one bad segment flags only itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Sequence

import numpy as np
import torch

from mpitest_tpu_torch.models.verify import Fingerprint, fingerprint_host
from mpitest_tpu_torch.ops import kernels
from mpitest_tpu_torch.ops.keys import KeyCodec, codec_for, to_device_words, to_host_words

#: Segment id of pad lanes: the uint32 maximum, above any real id, so
#: pads sort to the global tail past every segment.
PAD_SEG = 0xFFFFFFFF

#: Smallest bucket: below it more callables would cost more than the
#: padding wastes.
MIN_BUCKET = 1 << 10


def bucket_for(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Power-of-two shape bucket for ``n`` packed lanes: the smallest power
    of two >= max(n, min_bucket)."""
    if n < 0:
        raise ValueError(f"bucket_for: negative size {n}")
    target = max(n, max(int(min_bucket), 1))
    return 1 << (target - 1).bit_length() if target > 1 else 1


@dataclass(frozen=True)
class PackedBatch:
    """One packed batch on the host: the ``(seg, *words)`` uint32 arrays
    (padded to ``bucket``), per-segment geometry, and the per-segment
    input fingerprints the verification compares against."""

    words: tuple[np.ndarray, ...]      # (1 + n_words) uint32, len bucket
    sizes: tuple[int, ...]             # per-segment key counts
    offsets: tuple[int, ...]           # per-segment start lane
    fps: tuple[Fingerprint, ...]       # per-segment input fold (key words)
    dtype: np.dtype
    bucket: int

    @property
    def n_valid(self) -> int:
        return int(sum(self.sizes))

    @property
    def n_segments(self) -> int:
        return len(self.sizes)


def pack_segments(arrays: Sequence[np.ndarray], dtype: np.dtype,
                  bucket: int | None = None) -> PackedBatch:
    """Encode and pack request key arrays into one segment-prefixed word
    tuple padded to a shape bucket.  All arrays share ``dtype``; the
    segment order is the argument order (and the split order)."""
    codec: KeyCodec = codec_for(dtype)
    if len(arrays) >= PAD_SEG:
        raise ValueError(f"too many segments ({len(arrays)})")
    sizes = tuple(int(np.asarray(a).size) for a in arrays)
    total = sum(sizes)
    if bucket is None:
        bucket = bucket_for(total)
    if total > bucket:
        raise ValueError(f"segments hold {total} keys > bucket {bucket}")
    offsets = tuple(int(v) for v in np.cumsum((0,) + sizes)[:-1])

    seg = np.full(bucket, PAD_SEG, np.uint32)
    key_words = tuple(np.zeros(bucket, np.uint32) for _ in range(codec.n_words))
    fps = []
    for i, a in enumerate(arrays):
        w = codec.encode(np.asarray(a, dtype=dtype).reshape(-1))
        lo, hi = offsets[i], offsets[i] + sizes[i]
        seg[lo:hi] = np.uint32(i)
        for dst, src in zip(key_words, w):
            dst[lo:hi] = src
        fps.append(fingerprint_host(w))
    return PackedBatch((seg,) + key_words, sizes, offsets, tuple(fps),
                       np.dtype(dtype), bucket)


class PackedSort:
    """The packed-batch sort of ``n_words_total`` words of ``bucket``
    lanes: one lexicographic ``torch.sort`` program.  Two words (segment
    plus a one-word key) sort as one int64 ``(seg ^ 2^31) << 32 | key``
    (the reference's fused ``(seg << 32) | key`` in unsigned order, with
    the sign bit flipped so that ``PAD_SEG`` still sorts last); wider keys
    go through ``kernels.local_sort`` with the ``lax`` engine."""

    def __init__(self, n_words_total: int, bucket: int) -> None:
        self.n_words_total = n_words_total
        self.bucket = bucket

    def __call__(self, *words: Any, device: torch.device | str | None = None
                 ) -> tuple[torch.Tensor, ...]:
        """Sort host (uint32) or device (int32 carrier) words on
        ``device`` (default: the card, ``models/api.resolve_device``);
        returns the sorted words there."""
        if len(words) != self.n_words_total or any(
                int(w.shape[0]) != self.bucket for w in words):
            raise ValueError(f"packed sort of {self.n_words_total} words x "
                             f"{self.bucket} lanes called with "
                             f"{[tuple(w.shape) for w in words]}")
        from mpitest_tpu_torch.models.api import resolve_device

        dev = resolve_device(words[0], device)
        ws = tuple(w.to(dev) if isinstance(w, torch.Tensor)
                   else to_device_words(w, dev) for w in words)
        if self.n_words_total == 2:
            return kernels._lax_sort(ws, stable=False)
        return kernels.local_sort(ws, engine="lax")


@lru_cache(maxsize=64)
def compile_packed_sort(n_words_total: int, bucket: int) -> PackedSort:
    """The packed-batch sort for one (word count, bucket), memoized
    process-wide: the shape bucket is the cache key."""
    return PackedSort(n_words_total, bucket)


def executable_stats(exe: Any) -> dict[str, float]:
    """Cost statistics of a packed-sort callable.  The reference reads
    XLA's cost and memory analysis of its compiled executable; PyTorch
    has no such surface, so this returns what the reference returns when
    the surface is missing: ``{}``."""
    return {}


def run_packed(batch: PackedBatch, executable: PackedSort | None = None,
               device: torch.device | str | None = None,
               ) -> tuple[np.ndarray, ...]:
    """Dispatch the packed batch (through ``executable`` when the caller
    holds one, else the shared callable) on ``device`` (default the card)
    and return the sorted words on the host."""
    fn = executable if executable is not None else \
        compile_packed_sort(len(batch.words), batch.bucket)
    out = fn(*batch.words, device=device)
    return tuple(to_host_words(w) for w in out)


def lex_sorted_host(words: Sequence[np.ndarray]) -> bool:
    """Host lexicographic non-decreasing check over uint32 word arrays
    (msw first)."""
    n = int(words[0].size)
    if n < 2:
        return True
    lt = np.zeros(n - 1, bool)
    eq = np.ones(n - 1, bool)
    for w in words:
        a, b = w[:-1], w[1:]
        lt |= eq & (a < b)
        eq &= a == b
    return bool(np.all(lt | eq))


def split_segments(batch: PackedBatch, sorted_words: tuple[np.ndarray, ...],
                   ) -> list[np.ndarray]:
    """Each segment's slice of the sorted packed words, decoded to its
    request's dtype: segment ``i`` occupies lanes ``[offsets[i],
    offsets[i] + sizes[i])``."""
    codec = codec_for(batch.dtype)
    return [codec.decode(tuple(w[lo:lo + size] for w in sorted_words[1:]))
            for lo, size in zip(batch.offsets, batch.sizes)]


def verify_segments(batch: PackedBatch, sorted_words: tuple[np.ndarray, ...],
                    ) -> list[bool]:
    """One verdict per segment: its segment words are its id, its key
    words are lexicographically sorted, and its fingerprint equals the
    input-side fold.  A bad segment flags only itself."""
    seg_out = sorted_words[0]
    verdicts = []
    for i, (lo, size) in enumerate(zip(batch.offsets, batch.sizes)):
        ok = bool(np.all(seg_out[lo:lo + size] == np.uint32(i)))
        key_segs = tuple(w[lo:lo + size] for w in sorted_words[1:])
        ok = ok and lex_sorted_host(key_segs)
        ok = ok and fingerprint_host(key_segs) == batch.fps[i]
        verdicts.append(ok)
    return verdicts
