"""The verifier's one-pass fold and order check of a shard's word planes.

:func:`scan` reads one shard's 1 or 2 word planes (``torch.int32``
tensors of uint32 bits, msw first) once and writes one row of
:func:`row_width` values: per plane the XOR and the wrapping uint32 sum
of words ``[0, n_fold)``, a flag set when some adjacent pair of
``[0, n_sorted)`` is out of order (unsigned, lexicographic across the
planes), the key at 0 and the key at ``i_last`` (-1: none).  The rows of
every shard on a device form one zeroed ``int64`` tensor, which the
verifier reads to the host once (``models/verify.py``).

The reference computes the same values with plain XLA reductions
(``mpitest_tpu/models/verify.py``), so this replaces no Pallas kernel: it
replaces PyTorch's chains of reductions, some 90 launches a one-rank call
and a host read for each value.  A CUDA tensor launches ``verify_scan``
of ``csrc/verify.cu``; a CPU tensor runs :func:`scan_plain`; anything
else raises, and nothing falls back from the kernel to the plain
version.  The row's sum columns may carry bits above the low 32 (the
kernel adds its blocks' uint32 partial sums); the reader keeps the low
32 bits of every column.
"""

from __future__ import annotations

import ctypes

import torch

from mpitest_tpu_torch.ops import _build
from mpitest_tpu_torch.ops.keys import unsigned_order

_U32 = 0xFFFFFFFF

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: Every entry of ``csrc/verify.cu``, the trailing stream included.
SIGNATURES = {"verify_scan": (_P, _P, _I, _L, _L, _L, _P, _P)}

#: Word planes the kernel takes.
MAX_PLANES = 2

_build.LAUNCHES["verify_scan"] = 0


def lib() -> ctypes.CDLL:
    """The loaded ``csrc/verify.cu`` library, every entry typed."""
    return _build.typed("verify", SIGNATURES)


def row_width(n_words: int) -> int:
    """Columns of one shard's row: XORs, sums, the order flag, the key at
    0 and the key at ``i_last``."""
    return 4 * n_words + 1


def n_read(n_sorted: int, n_fold: int) -> int:
    """Words of each plane a scan reads."""
    return max(n_sorted, n_fold)


def _check_args(words: tuple[torch.Tensor, ...], n_sorted: int, n_fold: int,
                i_last: int, row: torch.Tensor) -> bool:
    """Validate one scan; True for CUDA tensors, False for CPU ones."""
    if not words:
        raise ValueError("a scan needs at least one word plane")
    dev = words[0].device
    n = words[0].numel()
    for w in words:
        if w.dtype != torch.int32:
            raise TypeError(f"word planes are int32 bit patterns, got {w.dtype}")
        if w.dim() != 1 or w.numel() != n or not w.is_contiguous():
            raise ValueError(f"expected contiguous flat planes of {n}, got "
                             f"{tuple(w.shape)}")
        if w.device != dev:
            raise ValueError(f"planes on {dev} and {w.device}")
    if not 0 <= n_sorted <= n or not 0 <= n_fold <= n:
        raise ValueError(f"n_sorted={n_sorted} and n_fold={n_fold} must lie in "
                         f"[0, {n}]")
    if not -1 <= i_last < n_read(n_sorted, n_fold):
        raise IndexError(f"key index {i_last} out of range for a scan of "
                         f"{n_read(n_sorted, n_fold)} of {n} words")
    if (row.dtype != torch.int64 or row.shape != (row_width(len(words)),)
            or not row.is_contiguous() or row.device != dev):
        raise ValueError(f"row must be contiguous int64[{row_width(len(words))}] "
                         f"on {dev}, got {row.dtype}{tuple(row.shape)} on {row.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        if len(words) > MAX_PLANES:
            raise ValueError(f"the kernel takes 1..{MAX_PLANES} planes, got {len(words)}")
        return True
    raise ValueError(f"unsupported device {dev}: use cpu or cuda")


# ---------------------------------------------------------- plain version


def xor_fold_plain(w: torch.Tensor) -> torch.Tensor:
    """XOR of a flat word plane as a 0-dim tensor, by a halving fold
    (PyTorch has no XOR reduction); O(n) work, O(log n) ops."""
    if w.numel() == 0:
        return torch.zeros((), dtype=w.dtype, device=w.device)
    while w.numel() > 1:
        n = w.numel()
        half = n // 2
        folded = w[:half] ^ w[half:2 * half]
        if n % 2:
            folded[0] ^= w[n - 1]
        w = folded
    return w[0]


def unsorted_plain(words: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """0-dim bool: some adjacent pair of the planes is out of order (a pair
    is in order iff the first differing word, msw first, increases)."""
    total = words[0].numel()
    if total < 2:
        return torch.zeros((), dtype=torch.bool, device=words[0].device)
    lt = torch.zeros(total - 1, dtype=torch.bool, device=words[0].device)
    eq = torch.ones_like(lt)
    for w in words:
        u = unsigned_order(w)
        a, b = u[:-1], u[1:]
        lt |= eq & (a < b)
        eq &= a == b
    return ~torch.all(lt | eq)


def scan_plain(words: tuple[torch.Tensor, ...], n_sorted: int, n_fold: int,
               i_last: int) -> torch.Tensor:
    """Plain PyTorch version of ``verify_scan``: the row as an int64
    tensor, every column in ``[0, 2^32)``."""
    dev = words[0].device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    cols = [xor_fold_plain(w[:n_fold]).to(torch.int64) for w in words]
    cols += [w[:n_fold].sum(dtype=torch.int64) for w in words]
    cols.append(unsorted_plain(tuple(w[:n_sorted] for w in words)).to(torch.int64))
    some = n_read(n_sorted, n_fold) > 0
    cols += [w[0].to(torch.int64) if some else zero for w in words]
    cols += [w[i_last].to(torch.int64) if i_last >= 0 else zero for w in words]
    return torch.stack(cols) & _U32


# ----------------------------------------------------------------- wrapper


def scan(words: tuple[torch.Tensor, ...], n_sorted: int, n_fold: int,
         i_last: int, row: torch.Tensor) -> None:
    """Fold words ``[0, n_fold)``, check the order of ``[0, n_sorted)`` and
    take the keys at 0 and ``i_last`` into ``row``, an ``int64`` row of a
    tensor zeroed on the words' device (one launch on a card; nothing to
    do when neither count reaches a word)."""
    on_card = _check_args(words, n_sorted, n_fold, i_last, row)
    if n_read(n_sorted, n_fold) == 0:
        return
    if not on_card:
        row.copy_(scan_plain(words, n_sorted, n_fold, i_last))
        return
    p1 = words[1].data_ptr() if len(words) > 1 else 0
    _build.launch(lib(), "verify_scan", row.device, words[0].data_ptr(), p1,
                  len(words), n_sorted, n_fold, i_last, row.data_ptr())
