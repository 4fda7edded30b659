"""Always-on output verification: sortedness + multiset fingerprint
(port of ``mpitest_tpu/models/verify.py``, contiguous layout).

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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np
import torch

from mpitest_tpu_torch.ops.keys import codec_for, unsigned_order

if TYPE_CHECKING:
    from mpitest_tpu_torch.models.api import DistributedSortResult

_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Fingerprint:
    """Order-independent digest of a key-word multiset."""

    count: int
    xors: tuple            # per word, uint32
    sums: tuple            # per word, uint32 (wrapping)

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
    return int(w[0]) & _U32


def _sum32(w: torch.Tensor) -> int:
    """Wrapping uint32 sum: the signed int32 sum differs from the unsigned
    one by a multiple of 2^32, and int64 cannot overflow below 2^32 keys."""
    return int(w.sum(dtype=torch.int64)) & _U32


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
    return bool(torch.all(lt | eq))


def verify_result(res: "DistributedSortResult",
                  input_fp: Fingerprint | None) -> tuple[bool, bool]:
    """Verify a contiguous result: returns ``(sorted_ok, fp_ok)``.
    ``fp_ok`` is True when no input fingerprint is available (nothing to
    compare — sortedness still gates).  The words may carry pads (the
    maximum key) past ``n_valid``; they extend the order and are left out
    of the fingerprint."""
    total = int(res.words[0].numel())
    ok = is_sorted_words(res.words)
    out_fp = _fold(res.words, min(res.n_valid, total))
    out_fp = Fingerprint(res.n_valid, out_fp.xors, out_fp.sums)
    fp_ok = input_fp is None or out_fp == input_fp
    return ok, fp_ok
