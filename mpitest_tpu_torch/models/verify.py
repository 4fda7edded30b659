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
sorted input.  The reductions are plain PyTorch on the words' device.

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

from mpitest_tpu_torch.ops.keys import codec_for, unsigned_order
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


def _xor_reduce(w: torch.Tensor) -> int:
    """XOR of a flat word plane by a halving fold (PyTorch has no XOR
    reduction); O(n) work, O(log n) ops."""
    if w.numel() == 0:
        return 0
    while w.numel() > 1:
        n = w.numel()
        half = n // 2
        folded = w[:half] ^ w[half:2 * half]
        if n % 2:
            folded[0] ^= w[n - 1]
        w = folded
    with spans.host_sync("verify.xor"):
        return int(w[0]) & _U32


def _sum32(w: torch.Tensor) -> int:
    """Wrapping uint32 sum: the signed int32 sum differs from the unsigned
    one by a multiple of 2^32, and int64 cannot overflow below 2^32 keys."""
    total = w.sum(dtype=torch.int64)
    with spans.host_sync("verify.sum"):
        return int(total) & _U32


def _fold(words: "tuple[torch.Tensor, ...]", n_valid: int) -> Fingerprint:
    return Fingerprint(n_valid,
                       tuple(_xor_reduce(w[:n_valid]) for w in words),
                       tuple(_sum32(w[:n_valid]) for w in words))


def fingerprint_device_input(x: torch.Tensor, dtype: object) -> Fingerprint:
    """Fingerprint of raw device-resident keys (encode on the device)."""
    words = codec_for(dtype).encode_torch(x.reshape(-1))
    return _fold(words, x.numel())


def is_sorted_words(words: "tuple[torch.Tensor, ...]") -> bool:
    """Lexicographic non-decreasing check over whole word planes: a pair
    is in order iff the first differing word (msw first) increases."""
    total = words[0].numel()
    if total < 2:
        return True
    lt = torch.zeros(total - 1, dtype=torch.bool, device=words[0].device)
    eq = torch.ones_like(lt)
    for w in words:
        u = unsigned_order(w)
        a, b = u[:-1], u[1:]
        lt |= eq & (a < b)
        eq &= a == b
    ok = torch.all(lt | eq)
    with spans.host_sync("verify.sorted"):
        return bool(ok)


def fingerprint_device(shards: "list[tuple[torch.Tensor, ...]]",
                       n_valid: int) -> Fingerprint:
    """Input-side fingerprint over per-rank padded shards: the first
    ``n_valid`` keys in rank order (pads sit at the global tail)."""
    return _fold_shards(shards, [int(s[0].numel()) for s in shards], n_valid)


def _combine(fps: "list[Fingerprint]", count: int) -> Fingerprint:
    n_words = len(fps[0].xors)
    xors = [0] * n_words
    sums = [0] * n_words
    for fp in fps:
        for k in range(n_words):
            xors[k] ^= fp.xors[k]
            sums[k] = (sums[k] + fp.sums[k]) & _U32
    return Fingerprint(count, tuple(xors), tuple(sums))


def _fold_shards(shards: "list[tuple[torch.Tensor, ...]]", valid: "list[int]",
                 n_valid: int) -> Fingerprint:
    """Fold the first ``valid[r]`` words of each shard, stopping once
    ``n_valid`` keys (in rank order) are folded."""
    fps, left = [], n_valid
    for words, v in zip(shards, valid):
        v = max(0, min(v, left))
        fps.append(_fold(words, v))
        left -= v
    return _combine(fps, n_valid - left)


def _key_at(words: "tuple[torch.Tensor, ...]", i: int) -> "tuple[int, ...]":
    """Key ``i`` as a tuple of uint32 values, msw first (tuples compare
    lexicographically)."""
    out = []
    for w in words:
        with spans.host_sync("verify.key_at"):
            out.append(int(w[i]) & _U32)
    return tuple(out)


def _valid_counts(res: "DistributedSortResult") -> "list[int]":
    if res.counts is None:
        return [int(s[0].numel()) for s in res.shards]
    return [int(c) for c in res.counts]


def _local_ranks(res: "DistributedSortResult") -> "Sequence[int]":
    """The global ranks of the shards a result holds here."""
    return res.mesh.local_ranks if res.mesh is not None else range(len(res.shards))


def _contiguous_fold(res: "DistributedSortResult") -> Fingerprint:
    """The fold of the shards a contiguous result holds here: rank r holds
    global keys ``[r*n, (r+1)*n)``, valid below ``n_valid``."""
    n = int(res.shards[0][0].numel())
    valid = [max(0, min(n, res.n_valid - r * n)) for r in _local_ranks(res)]
    return _combine([_fold(w, v) for w, v in zip(res.shards, valid)], sum(valid))


def _contiguous_check(res: "DistributedSortResult") -> tuple[bool, Fingerprint]:
    """Sortedness and fingerprint of a contiguous result: each shard
    sorted, each seam between consecutive nonempty ranks in order, the
    first ``n_valid`` keys folded.  Across processes one control-group
    round carries every process's fold and its ranks' first and last
    keys."""
    ends = {r: (is_sorted_words(s), _key_at(s, 0), _key_at(s, -1))
            for r, s in zip(_local_ranks(res), res.shards) if s[0].numel()}
    parts = mesh_mod.each_process(res.mesh, (_contiguous_fold(res), ends))
    every: dict = {}
    for _, e in parts:
        every.update(e)
    ranks = sorted(every)
    ok = all(every[r][0] for r in ranks) and not any(
        every[b][1] < every[a][2] for a, b in zip(ranks, ranks[1:]))
    return ok, _combine([f for f, _ in parts], res.n_valid)


def result_fingerprint(res: "DistributedSortResult") -> Fingerprint:
    """Fingerprint of a result's first ``n_valid`` keys in rank order
    (pads and the ragged layout's fill words left out); across processes,
    every process's folds combined (every process calls it together)."""
    if res.counts is None:
        folds = mesh_mod.each_process(res.mesh, _contiguous_fold(res))
        return _combine(folds, res.n_valid)
    return _fold_shards(list(res.shards), _valid_counts(res), res.n_valid)


def result_sorted(res: "DistributedSortResult") -> bool:
    """Sortedness of a result in either layout (see :func:`verify_result`)."""
    if res.counts is None:
        return _contiguous_check(res)[0]
    ok = all(is_sorted_words(s) for s in res.shards)
    run_max = None
    for words, c in zip(res.shards, _valid_counts(res)):
        if c == 0:
            continue
        if run_max is not None and _key_at(words, 0) < run_max:
            ok = False
        last = _key_at(words, c - 1)
        run_max = last if run_max is None else max(run_max, last)
    return ok


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
    if res.counts is None:
        ok, out_fp = _contiguous_check(res)
    else:
        ok, out_fp = result_sorted(res), result_fingerprint(res)
    return ok, input_fp is None or out_fp == input_fp
