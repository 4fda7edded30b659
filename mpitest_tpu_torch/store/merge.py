"""Streamed k-way merge of sorted spill runs with bounded host memory
(port of ``mpitest_tpu/store/merge.py``).

The merge is **vectorized**: each run keeps a bounded read-ahead buffer
of encoded key words (+ payload words), and each round computes a *safe
boundary* — the lexicographic minimum, over every run with unread file
data, of the last key already buffered.  Any buffered key strictly below
it is globally safe to emit (every unread key of run ``r`` is >= the last
buffered key of ``r``, which is >= the boundary), so the round
concatenates those prefixes, orders them once (:func:`_order_for`, keyed
by the key words plus ``(run, pos)`` tiebreaks, so the merge is stable
across runs) and yields the result as one chunk.  Keys equal to the
boundary stream per run in ascending run order, refilling as needed, so
a dup-heavy input — every run one plateau of the same key — merges in
run order with the same bounded buffers.

The round's order is the host ``np.lexsort``, or, under
``SORT_LOCAL_ENGINE=radix_pallas`` and for rounds of 2..4096 records, the
merge-order kernel K8 (``ops/radix.merge_order_host``) on the external
sort's device — the same permutation, because the ``(run, pos)``
tiebreaks make every key unique.  A kernel that fails raises; no round
falls back to the host lexsort.

Integrity: every chunk read back from disk is folded
(:func:`store.runs.run_fingerprint`); at run exhaustion the fold must
equal the run's sidecar, or the typed :class:`RunIntegrityError` names
the run, which the external sort catches to re-spill that slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

import torch

from mpitest_tpu_torch.models.records import payload_to_words
from mpitest_tpu_torch.models.supervisor import SortIntegrityError
from mpitest_tpu_torch.ops import radix
from mpitest_tpu_torch.ops.keys import codec_for
from mpitest_tpu_torch.store import runs as runlib
from mpitest_tpu_torch.utils import knobs


class RunIntegrityError(SortIntegrityError):
    """A run's read-back fold disagreed with its fingerprint sidecar.
    Carries the offending :class:`~mpitest_tpu_torch.store.runs.RunInfo` so
    the external sort can blame and re-spill exactly that slice."""

    def __init__(self, info: "runlib.RunInfo", detail: str) -> None:
        super().__init__(detail)
        self.info = info


@dataclass
class _Cursor:
    """Read-ahead state of one run inside a merge."""

    info: runlib.RunInfo
    run_id: int
    chunks: Iterator
    #: buffered encoded key words (tuple of uint32 arrays, msw first)
    kw: tuple = ()
    #: buffered payload words (tuple of uint32 arrays; () = keys only)
    pw: tuple = ()
    #: global position (within the run) of the buffer's first element —
    #: the stable-merge `pos` tiebreak
    base: int = 0
    consumed_from_file: int = 0
    file_done: bool = False
    fold: "runlib.Fingerprint | None" = None
    _codec: object = None

    def __post_init__(self) -> None:
        self._codec = codec_for(self.info.dtype)

    @property
    def buffered(self) -> int:
        return int(self.kw[0].size) if self.kw else 0

    def refill(self) -> bool:
        """Append one more disk chunk to the buffer (folding it into
        the run's read-back fingerprint).  Returns False at EOF — and
        at EOF compares the accumulated fold against the sidecar,
        raising :class:`RunIntegrityError` on mismatch."""
        if self.file_done:
            return False
        try:
            keys, pay = next(self.chunks)
        except runlib.BlockIntegrityError as e:
            # a compressed block failed its framing/checksum mid-read:
            # surface it as the SAME typed blame the fold mismatch
            # raises, so the external sort's re-spill recovery covers
            # compressed corruption too
            raise RunIntegrityError(self.info, str(e)) from None
        except StopIteration:
            self.file_done = True
            fp = self.fold
            want = self.info.fingerprint
            if fp is None:
                ok = want.count == 0
            else:
                ok = fp == want
            if not ok:
                raise RunIntegrityError(
                    self.info,
                    f"run {self.info.path!r} read-back fingerprint "
                    "disagrees with its sidecar (disk corruption "
                    "between spill and merge)") from None
            return False
        arr = np.array(keys)
        kw = self._codec.encode(arr)
        pw = (payload_to_words(np.array(pay))
              if pay is not None else ())
        cfp = runlib.run_fingerprint(kw, pw)
        self.fold = cfp if self.fold is None else self.fold.combine(cfp)
        self.consumed_from_file += arr.size
        if self.kw:
            self.kw = tuple(np.concatenate([a, b])
                            for a, b in zip(self.kw, kw))
            self.pw = tuple(np.concatenate([a, b])
                            for a, b in zip(self.pw, pw))
        else:
            self.kw, self.pw = kw, pw
        return True

    def pop(self, m: int) -> tuple[tuple, tuple, np.ndarray]:
        """Remove the first ``m`` buffered records; returns their key
        words, payload words and global in-run positions."""
        pos = np.arange(self.base, self.base + m, dtype=np.uint32)
        kw = tuple(w[:m] for w in self.kw)
        pw = tuple(w[:m] for w in self.pw)
        self.kw = tuple(w[m:] for w in self.kw)
        self.pw = tuple(w[m:] for w in self.pw)
        self.base += m
        return kw, pw, pos


def _order_for(kws: tuple, rid: np.ndarray, pos: np.ndarray,
               device: torch.device | str | None = None) -> np.ndarray:
    """Sort order of one merge round: lexicographic over the key words
    (msw first) with the stable ``(run, pos)`` tiebreaks.

    Host ``np.lexsort`` by default.  Under ``SORT_LOCAL_ENGINE=
    radix_pallas`` a round of 1 < n <= ``MERGE_MAX_ELEMS`` records runs the
    merge-order kernel K8 on ``device`` (the card when None; the CPU
    device runs its plain version) over the same planes; the bounded
    read-ahead and safe-boundary logic stay in :func:`merge_runs`.  Larger
    rounds take the host lexsort; a kernel failure raises.
    """
    n = int(rid.size)
    if (knobs.get("SORT_LOCAL_ENGINE") == "radix_pallas"
            and 1 < n <= radix.MERGE_MAX_ELEMS):
        if device is None:
            from mpitest_tpu_torch.models.api import resolve_device

            device = resolve_device(None, None)
        return radix.merge_order_host(tuple(kws) + (rid, pos), device)
    # np.lexsort: LAST key is primary -> (pos, rid, lsw..msw)
    return np.lexsort((pos, rid) + tuple(reversed(kws)))


def _lex_below(words: tuple, bound: tuple[int, ...],
               inclusive: bool) -> int:
    """Count of the buffer's prefix lexicographically < ``bound``
    (or <= with ``inclusive``).  The buffer is sorted, so the boolean
    mask is a prefix and its popcount is the split point."""
    n = int(words[0].size)
    if n == 0:
        return 0
    lt = np.zeros(n, bool)
    eq = np.ones(n, bool)
    for w, b in zip(words, bound):
        lt |= eq & (w < np.uint32(b))
        eq &= w == np.uint32(b)
    mask = (lt | eq) if inclusive else lt
    return int(np.count_nonzero(mask))


def _last_key(cur: _Cursor) -> tuple[int, ...]:
    return tuple(int(w[-1]) for w in cur.kw)


def _first_key(cur: _Cursor) -> tuple[int, ...]:
    return tuple(int(w[0]) for w in cur.kw)


def merge_runs(infos: list["runlib.RunInfo"], chunk_elems: int,
               io=None, device: torch.device | str | None = None,
               ) -> Iterator[tuple[tuple, tuple]]:
    """Merge sorted runs, yielding ``(key_words, payload_words)``
    chunks in globally sorted (stable: key, then run, then in-run
    position) order.  Host memory is bounded by roughly
    ``len(infos) * chunk_elems`` records of buffer plus one output
    round.  Callers wanting a multi-pass (fan-in-limited) merge drive
    this through :func:`store.external` — this function merges every
    run it is handed in one pass.

    ``io`` is an optional :class:`store.aio.MergeIO`: when
    given, each cursor's chunk stream comes from ``io.source(info,
    chunk_elems)`` — a read-ahead thread that decodes the NEXT disk
    block while this loop consumes the current one — instead of the
    synchronous :func:`store.runs.read_run_chunks`.  The chunk
    contents are identical either way; only the overlap changes.

    ``device`` is where :func:`_order_for` runs the merge-order kernel
    under ``radix_pallas`` (the card when None)."""
    if not infos:
        return
    chunk_elems = max(1, int(chunk_elems))
    cursors = [
        _Cursor(info=ri, run_id=i,
                chunks=(io.source(ri, chunk_elems) if io is not None
                        else runlib.read_run_chunks(ri, chunk_elems)))
        for i, ri in enumerate(infos)
    ]
    try:
        yield from _merge_cursors(cursors, device)
    finally:
        # close every chunk source (sync generators AND read-ahead
        # threads) even when the consumer abandons the merge mid-way
        for c in cursors:
            close = getattr(c.chunks, "close", None)
            if close is not None:
                close()


def _merge_cursors(cursors: list[_Cursor],
                   device: torch.device | str | None,
                   ) -> Iterator[tuple[tuple, tuple]]:
    for c in cursors:
        c.refill()
    while True:
        for c in cursors:
            if not c.buffered and not c.file_done:
                c.refill()
        live = [c for c in cursors if c.buffered]
        if not live:
            return
        # safe boundary: lex-min of last-buffered keys over runs whose
        # FILE still has unread data (a fully-buffered run constrains
        # nothing — all its keys are visible)
        bounded = [c for c in live if not c.file_done]
        if not bounded:
            boundary = None            # everything visible: drain all
        else:
            boundary = min(_last_key(c) for c in bounded)
        pieces_kw: list[tuple] = []
        pieces_pw: list[tuple] = []
        pieces_rid: list[np.ndarray] = []
        pieces_pos: list[np.ndarray] = []
        total = 0
        for c in live:
            m = (c.buffered if boundary is None
                 else _lex_below(c.kw, boundary, inclusive=False))
            if m:
                kw, pw, pos = c.pop(m)
                pieces_kw.append(kw)
                pieces_pw.append(pw)
                pieces_rid.append(np.full(m, c.run_id, np.uint32))
                pieces_pos.append(pos)
                total += m
        if total:
            n_kw = len(pieces_kw[0])
            kws = tuple(np.concatenate([p[i] for p in pieces_kw])
                        for i in range(n_kw))
            n_pw = len(pieces_pw[0])
            pws = tuple(np.concatenate([p[i] for p in pieces_pw])
                        for i in range(n_pw))
            rid = np.concatenate(pieces_rid)
            pos = np.concatenate(pieces_pos)
            order = _order_for(kws, rid, pos, device)
            kws = tuple(w[order] for w in kws)
            pws = tuple(w[order] for w in pws)
            yield kws, pws
            continue
        if boundary is None:
            continue  # drained everything visible; loop refills
        # plateau: every safe-emittable key equals the boundary.
        # Stream the == boundary records per run in ascending run id
        # (the stable tie order), refilling inside each drain so the
        # buffers stay bounded even when one run is a single plateau.
        emitted_any = False
        for c in sorted(live, key=lambda c: c.run_id):
            while True:
                m = _lex_below(c.kw, boundary, inclusive=True)
                if m:
                    emitted_any = True
                    kw, pw, _pos = c.pop(m)
                    yield kw, pw
                # keep draining while the run may still hold == keys:
                # buffer exhausted with file data left, or the buffer
                # now starts above the boundary
                if c.buffered == 0:
                    if not c.refill():
                        break
                    continue
                if _first_key(c) > boundary:
                    break
                # buffered head == boundary still (m was limited by a
                # previous pop edge) — loop again
                if m == 0:
                    break
        if not emitted_any:
            # defensive: boundary came from a bounded run whose == keys
            # are all unread; force progress by refilling the min run
            for c in bounded:
                if _last_key(c) == boundary:
                    c.refill()
                    break
