"""Always-on output verification: sortedness + multiset fingerprint
(port of ``mpitest_tpu/models/verify.py``: the contiguous layout, over
one rank or the radix sort's per-rank shards, and the ragged layout of
sample sort).

Every ``sort()`` proves its own result:

1. **Sortedness**: the result words are lexicographically non-decreasing
   over the whole array (unsigned word order).
2. **Multiset fingerprint**: per encoded word, the XOR and the wrapping
   uint32 SUM over the valid keys, plus the exact count.  The input side
   is folded where the keys are first touched (host encode, or one
   reduction over device-resident input); the output side by the same
   reduction over the result.  Truncation moves the count, duplication
   the sum, corruption the XOR.

Sortedness plus fingerprint equality together imply the result is the
sorted input.  Both come from one read of each shard's words
(``ops/fold.py``: a hand-written CUDA kernel on a card, its plain
PyTorch version on the CPU): the fold, an order flag over the whole
shard, and the keys the seams between ranks need, one row a shard.  The
rows of one device are read to the host once a side: ``verify.fold``
(the input fingerprint) and ``verify.check`` (the result).  The
reference's reductions are plain XLA; in PyTorch they took some 90
launches and 7 host reads a one-rank call and a third of its device
time, where one pass at the card's memory rate does.

The external sort's spill runs fold on the host: :func:`fingerprint_host`
for bare keys, :func:`fingerprint_records` once a payload rides, and
:meth:`Fingerprint.combine` joins the runs' folds.

A result of a mesh across processes (``res.mesh``) holds only this
process's shards: each process folds and checks its own, and one round of
the control group carries every process's fold and each rank's first and
last key (``parallel.mesh.each_process``, which keeps them local on one
process), so the fingerprint, the seams between ranks of different
processes and the verdict are the same in every process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np
import torch

from mpitest_tpu_torch.ops import fold
from mpitest_tpu_torch.ops.keys import codec_for
from mpitest_tpu_torch.parallel import mesh as mesh_mod
from mpitest_tpu_torch.utils import spans

if TYPE_CHECKING:
    from collections.abc import Sequence

    from mpitest_tpu_torch.models.api import DistributedSortResult

_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Fingerprint:
    """Order-independent digest of a key-word multiset."""

    count: int
    xors: tuple            # per word, uint32
    sums: tuple            # per word, uint32 (wrapping)

    def combine(self, other: "Fingerprint") -> "Fingerprint":
        """The fingerprint of the union of two multisets."""
        return Fingerprint(
            self.count + other.count,
            tuple((a ^ b) & _U32 for a, b in zip(self.xors, other.xors)),
            tuple((a + b) & _U32 for a, b in zip(self.sums, other.sums)),
        )

    @staticmethod
    def from_reference(fp: object) -> "Fingerprint":
        """Build from the reference package's ``Fingerprint`` (or a dict
        of its fields), so the two can be compared field by field."""
        d = fp if isinstance(fp, dict) else vars(fp)
        return Fingerprint(int(d["count"]),
                           tuple(int(v) for v in d["xors"]),
                           tuple(int(v) for v in d["sums"]))


def fingerprint_host(words: "tuple[np.ndarray, ...]") -> Fingerprint:
    """Fold host uint32 word arrays (one numpy pass, memory-bound)."""
    words = tuple(np.asarray(w, dtype=np.uint32) for w in words)
    return Fingerprint(
        int(words[0].size),
        tuple(int(np.bitwise_xor.reduce(w)) if w.size else 0 for w in words),
        tuple(int(w.sum(dtype=np.uint64)) & _U32 for w in words),
    )


def _mix_mult(i: int) -> np.uint32:
    """Odd multiplier of word position ``i`` in :func:`record_mix` (odd, so
    a bijection on uint32; distinct per position)."""
    return np.uint32((0x9E3779B1 * (2 * i + 3)) & _U32 | 1)


def record_mix(words: "tuple[np.ndarray, ...]") -> np.ndarray:
    """Per-record binding word over a record's key and payload words: the
    XOR of each word scaled by its position's multiplier.  The per-word
    folds cannot see a payload gathered against the wrong key; the
    multiset of this word can."""
    mix = np.zeros(words[0].shape, np.uint32)
    for i, w in enumerate(words):
        mix ^= np.asarray(w, np.uint32) * _mix_mult(i)
    return mix


def fingerprint_records(key_words: "tuple[np.ndarray, ...]",
                        payload_words: "tuple[np.ndarray, ...]",
                        ) -> Fingerprint:
    """Fingerprint of key+payload records: the per-word fold over every
    key and payload word plus :func:`record_mix` as one more word."""
    words = tuple(key_words) + tuple(payload_words)
    return fingerprint_host(words + (record_mix(words),))


@dataclass(frozen=True)
class _Scan:
    """One shard's row of :func:`ops.fold.scan`, read to the host."""

    xors: tuple
    sums: tuple
    unsorted: bool
    first: tuple        # the key at 0, uint32 words msw first
    last: tuple         # the key at ``i_last``

    @staticmethod
    def of(row: "list[int]", k: int) -> "_Scan":
        """Parse a row of ``k`` words' columns (low 32 bits of each)."""
        v = [c & _U32 for c in row]
        return _Scan(tuple(v[:k]), tuple(v[k:2 * k]), bool(v[2 * k]),
                     tuple(v[2 * k + 1:3 * k + 1]), tuple(v[3 * k + 1:]))


#: One scan: ``(words, n_sorted, n_fold, i_last)`` (see ``ops/fold.py``).
_Job = tuple[tuple[torch.Tensor, ...], int, int, int]


def _scan(jobs: list[_Job], what: str) -> list[_Scan]:
    """Run every job, one launch each, into one zeroed ``[jobs, k]`` row
    tensor a device, then read each device's rows to the host in one
    ``host_sync(what)`` (all devices launch before the first read)."""
    by_dev: dict = {}
    for i, (words, n_sorted, n_fold, _) in enumerate(jobs):
        if fold.n_read(n_sorted, n_fold):
            by_dev.setdefault(words[0].device, []).append(i)
    rows = {}
    for dev, idx in by_dev.items():
        n_words = len(jobs[idx[0]][0])
        rows[dev] = torch.zeros((len(idx), fold.row_width(n_words)),
                                dtype=torch.int64, device=dev)
        for r, i in enumerate(idx):
            words, n_sorted, n_fold, i_last = jobs[i]
            fold.scan(tuple(w.reshape(-1).contiguous() for w in words),
                      n_sorted, n_fold, i_last, rows[dev][r])
    out = [_Scan.of([0] * fold.row_width(len(w)), len(w)) for w, *_ in jobs]
    for dev, idx in by_dev.items():
        with spans.host_sync(what):
            vals = rows[dev].tolist()
        for r, i in enumerate(idx):
            out[i] = _Scan.of(vals[r], len(jobs[i][0]))
    return out


def _combine(parts: "Sequence[Fingerprint | _Scan]", count: int) -> Fingerprint:
    """The fingerprint of ``count`` keys from the folds of their parts."""
    n_words = len(parts[0].xors)
    xors = [0] * n_words
    sums = [0] * n_words
    for part in parts:
        for k in range(n_words):
            xors[k] ^= part.xors[k]
            sums[k] = (sums[k] + part.sums[k]) & _U32
    return Fingerprint(count, tuple(xors), tuple(sums))


def _fold_counts(valid: "list[int]", n_valid: int) -> "list[int]":
    """Keys folded from each shard: the first ``valid[r]``, stopping once
    ``n_valid`` keys (in rank order) are folded."""
    out, left = [], n_valid
    for v in valid:
        v = max(0, min(v, left))
        out.append(v)
        left -= v
    return out


def _fold_shards(shards: "Sequence[tuple[torch.Tensor, ...]]", valid: "list[int]",
                 n_valid: int, what: str) -> Fingerprint:
    """Fold the first ``valid[r]`` words of each shard, stopping once
    ``n_valid`` keys (in rank order) are folded."""
    counts = _fold_counts(valid, n_valid)
    scans = _scan([(w, 0, min(v, int(w[0].numel())), -1)
                   for w, v in zip(shards, counts)], what)
    return _combine(scans, sum(counts))


def fingerprint_words(words: "tuple[torch.Tensor, ...]", n_valid: int) -> Fingerprint:
    """Fingerprint of the first ``n_valid`` keys of device words."""
    return _fold_shards([words], [n_valid], n_valid, "verify.fold")


def fingerprint_device_input(x: torch.Tensor, dtype: object) -> Fingerprint:
    """Fingerprint of raw device-resident keys (encode on the device).
    ``sort`` folds the words it encodes itself (:func:`fingerprint_words`);
    this form is the one the tests hold against the reference's."""
    return fingerprint_words(codec_for(dtype).encode_torch(x.reshape(-1)), x.numel())


def fingerprint_device(shards: "list[tuple[torch.Tensor, ...]]",
                       n_valid: int) -> Fingerprint:
    """Input-side fingerprint over per-rank padded shards: the first
    ``n_valid`` keys in rank order (pads sit at the global tail)."""
    return _fold_shards(shards, [int(s[0].numel()) for s in shards], n_valid,
                        "verify.fold")


def _valid_counts(res: "DistributedSortResult") -> "list[int]":
    if res.counts is None:
        return [int(s[0].numel()) for s in res.shards]
    return [int(c) for c in res.counts]


def _local_ranks(res: "DistributedSortResult") -> "Sequence[int]":
    """The global ranks of the shards a result holds here."""
    return res.mesh.local_ranks if res.mesh is not None else range(len(res.shards))


def _contiguous_valid(res: "DistributedSortResult") -> "list[int]":
    """Valid keys of each shard a contiguous result holds here: rank r
    holds global keys ``[r*n, (r+1)*n)``, valid below ``n_valid``."""
    n = int(res.shards[0][0].numel())
    return [max(0, min(n, res.n_valid - r * n)) for r in _local_ranks(res)]


def _contiguous_check(res: "DistributedSortResult") -> tuple[bool, Fingerprint]:
    """Sortedness and fingerprint of a contiguous result: each shard
    sorted, each seam between consecutive nonempty ranks in order, the
    first ``n_valid`` keys folded; one scan a shard (its whole order, its
    valid keys, its first and last key).  Across processes one
    control-group round carries every process's fold and its ranks' first
    and last keys."""
    valid = _contiguous_valid(res)
    sizes = [int(s[0].numel()) for s in res.shards]
    scans = _scan([(w, n, v, n - 1) for w, n, v in zip(res.shards, sizes, valid)],
                  "verify.check")
    mine = _combine(scans, sum(valid))
    ends = {r: (not sc.unsorted, sc.first, sc.last)
            for r, n, sc in zip(_local_ranks(res), sizes, scans) if n}
    parts = mesh_mod.each_process(res.mesh, (mine, ends))
    every: dict = {}
    for _, e in parts:
        every.update(e)
    ranks = sorted(every)
    ok = all(every[r][0] for r in ranks) and not any(
        every[b][1] < every[a][2] for a, b in zip(ranks, ranks[1:]))
    return ok, _combine([f for f, _ in parts], res.n_valid)


def _ragged_check(res: "DistributedSortResult") -> tuple[bool, Fingerprint]:
    """Sortedness and fingerprint of a ragged result (see
    :func:`verify_result`); one scan a shard (its whole order, its folded
    keys, its first key and its last valid one)."""
    counts = _valid_counts(res)
    folded = _fold_counts(counts, res.n_valid)
    jobs = []
    for words, c, v in zip(res.shards, counts, folded):
        n = int(words[0].numel())
        jobs.append((words, n, min(v, n), c - 1 if c > 0 else -1))
    scans = _scan(jobs, "verify.check")
    ok = not any(sc.unsorted for sc in scans)
    run_max = None
    for sc, c in zip(scans, counts):
        if c == 0:
            continue
        if run_max is not None and sc.first < run_max:
            ok = False
        run_max = sc.last if run_max is None else max(run_max, sc.last)
    return ok, _combine(scans, sum(folded))


def result_fingerprint(res: "DistributedSortResult") -> Fingerprint:
    """Fingerprint of a result's first ``n_valid`` keys in rank order
    (pads and the ragged layout's fill words left out); across processes,
    every process's folds combined (every process calls it together)."""
    if res.counts is None:
        fp = _fold_shards(list(res.shards), _contiguous_valid(res),
                          res.n_valid, "verify.check")
        folds = mesh_mod.each_process(res.mesh, fp)
        return _combine(folds, res.n_valid)
    return _fold_shards(list(res.shards), _valid_counts(res), res.n_valid,
                        "verify.check")


def result_sorted(res: "DistributedSortResult") -> bool:
    """Sortedness of a result in either layout (see :func:`verify_result`)."""
    return (_contiguous_check(res) if res.counts is None else _ragged_check(res))[0]


def verify_result(res: "DistributedSortResult",
                  input_fp: Fingerprint | None) -> tuple[bool, bool]:
    """Verify a result: returns ``(sorted_ok, fp_ok)``.  ``fp_ok`` is True
    when no input fingerprint is available (nothing to compare —
    sortedness still gates).

    Contiguous layout (one rank, or the radix shards in rank order): each
    shard sorted, each of the P-1 seams in order, and the first
    ``n_valid`` keys folded; pads (the maximum key) past them extend the
    order.  Ragged layout (sample sort: shard r holds ``counts[r]`` valid
    keys at the head of its slots, the maximum word after them): each
    whole shard sorted, each nonempty shard's first key at or above the
    running maximum of the earlier shards' last valid keys, and the valid
    keys folded up to ``n_valid`` in rank order.  Across processes
    (``res.mesh``) every process calls it together and gets the same
    verdict."""
    ok, out_fp = (_contiguous_check(res) if res.counts is None
                  else _ragged_check(res))
    return ok, input_fp is None or out_fp == input_fp
