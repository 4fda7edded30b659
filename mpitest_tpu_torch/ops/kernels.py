"""Local sort kernels: the engine dispatch, the 64-bit pair engine and
the helpers of the distributed sorts (port of
``mpitest_tpu/ops/kernels.py``).

Words are ``torch.int32`` tensors of raw uint32 bits (``ops/keys.py``).
The ``lax`` engine is the reference's ``lax.sort``, which sits outside
any Pallas kernel: here it is ``torch.sort``, with a two-word key sorted
as one int64 built from the words.  The ``bitonic`` engine runs the CUDA
kernels of ``ops/bitonic.py`` and the ``radix_pallas`` engine the fused
radix kernel of ``ops/radix.py`` (or their plain versions on the CPU).
The helpers at the end (digits, histograms, step functions, splitter
search, samples) are plain torch ops, as the reference's are XLA ops.
"""

from __future__ import annotations

import torch

from mpitest_tpu_torch.ops import bitonic, radix
from mpitest_tpu_torch.ops.keys import SIGN_BIT, unsigned_order

Words = tuple[torch.Tensor, ...]

ENGINES = ("bitonic", "lax", "radix_pallas")


def _lax_sort(words: Words, stable: bool) -> Words:
    """``lax.sort`` of one or two words, lexicographic, msw first: one
    ``torch.sort`` of the ordered key."""
    return from_ordered_key(torch.sort(_ordered_key(words), stable=stable).values,
                            len(words))


def local_sort(words: Words, engine: str = "lax",
               diffs: tuple[int, ...] | None = None) -> Words:
    """Lexicographic sort of one- or two-word keys (msw first).

    ``engine="bitonic"`` routes one-word keys through the bitonic network
    (K1) and two-word keys through the pair engine (K2 + K3) with its
    residual fallback to the ``lax`` form.  ``engine="radix_pallas"``
    routes keys of up to ``radix.FUSED_MAX_WORDS`` words through the fused
    radix kernel (K4), one kernel call per planned pass; ``diffs``
    (msw-first per-word value spreads, host-static) compacts its pass plan
    and is ignored by the other engines.  ``words`` is always the full
    key, so stability is unobservable and the unstable network is an
    exact drop-in for the stable sort."""
    if engine not in ENGINES:
        raise ValueError(f"unknown local engine {engine!r}; use one of {ENGINES}")
    if engine == "radix_pallas":
        return radix.fused_radix_sort(words, diffs=diffs)
    if engine == "bitonic" and len(words) == 1:
        return (bitonic.bitonic_sort_u32(words[0]),)
    if engine == "bitonic" and len(words) == 2:
        hi_s, lo_s, bad = sort_two_words_bitonic(*words)
        if bool(bad):
            return _lax_sort(words, stable=False)
        return (hi_s, lo_s)
    return _lax_sort(words, stable=True)


def _fix_runs_oe(hi: torch.Tensor, lo: torch.Tensor, passes: int) -> torch.Tensor:
    """Segment-masked odd-even transposition: sort ``lo`` within every run
    of equal ``hi`` (already hi-sorted) of length <= ``passes``, over the
    whole array — the reference formulation and the oracle of K3."""
    return bitonic.odd_even_runs(hi.view(1, -1), lo.view(1, -1), passes).view(-1)


#: The boundary strips of phase B (the reference's ``_fix_boundary``).
_fix_boundary = bitonic.fix_boundary_plain


def sort_two_words_bitonic(hi: torch.Tensor, lo: torch.Tensor,
                           fix_passes: int = 16
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """64-bit local sort via the pair engine.

    Phase A sorts ``(hi, lo)`` pairs by hi with the key+payload network
    (K2); equal-hi runs then hold a permutation of their lo values, which
    phase B sorts with ``fix_passes`` segment-masked odd-even passes per
    block (K3) plus the boundary strips.  Runs longer than
    ``fix_passes`` may stay unsorted and set the residual flag; the
    caller then falls back to the ``lax`` sort.

    Returns ``(hi_sorted, lo_sorted, residual)``, residual a 0-dim bool
    tensor."""
    n = hi.numel()
    t = max((n - 1).bit_length(), bitonic.MIN_SORT_LOG2)
    n_pow2 = 1 << t
    if n < (1 << bitonic.MIN_SORT_LOG2) or n * 10 < n_pow2 * 6:
        hs, ls = _lax_sort((hi, lo), stable=False)
        return hs, ls, torch.zeros((), dtype=torch.bool, device=hi.device)
    b_log2 = min(bitonic.PAIR_BLOCK_LOG2, t)
    if n_pow2 != n:
        # (max, max) pad pairs sort to the global tail; real pairs equal
        # to them are indistinguishable, so the sliced prefix is exact
        pad = torch.full((n_pow2 - n,), -1, dtype=torch.int32, device=hi.device)
        hi = torch.cat([hi, pad])
        lo = torch.cat([lo, pad])
    hi_s, lo_r = bitonic.sort_pairs_padded(hi.contiguous(), lo.contiguous(),
                                           n_pow2, b_log2)
    lo_s, residual = bitonic.fix_runs_flag(hi_s, lo_r, fix_passes, b_log2)
    return hi_s[:n], lo_s[:n], residual


# ------------------------------------------- helpers of the distributed sorts


def _ordered_key(words: Words) -> torch.Tensor:
    """One signed tensor whose order is the lexicographic unsigned order
    of one or two words (msw first): the word with its sign bit flipped,
    or the int64 ``((hi ^ 2^31) << 32) | lo``."""
    if len(words) == 1:
        return unsigned_order(words[0])
    if len(words) != 2:
        raise ValueError(f"keys of 1 or 2 words, got {len(words)}")
    return ((unsigned_order(words[0]).to(torch.int64) << 32)
            | (words[1].to(torch.int64) & 0xFFFFFFFF))


def from_ordered_key(key: torch.Tensor, n_words: int) -> Words:
    """The words of :func:`_ordered_key` values."""
    if n_words == 1:
        return (unsigned_order(key),)
    w = key.view(torch.int32).view(-1, 2)  # little-endian: [:, 0] is the lsw
    return (w[:, 1] ^ SIGN_BIT, w[:, 0].contiguous())


def digit_at(word: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """The ``bits``-wide digit at bit offset ``shift`` of uint32 words
    (int32 result).  The shift is arithmetic on the int32 carrier; the
    mask after it keeps only bits that came from the word (at most
    ``32 - shift``), dropping the sign copies, so the digit is the
    unsigned one."""
    return (word >> shift) & ((1 << min(bits, 32 - shift)) - 1)


def histogram(digits: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Occurrences of each digit value in ``[0, n_bins)``; int32[n_bins]."""
    return torch.bincount(digits.to(torch.int64), minlength=n_bins)[:n_bins].to(torch.int32)


def histogram_sorted(sorted_digits: torch.Tensor, n_bins: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Histogram of an ascending digit array by binary search: ``(h, lo)``
    with ``h[b]`` the count of digit ``b`` and ``lo[b]`` the offset of its
    first occurrence (both int32[n_bins])."""
    edges = torch.searchsorted(
        sorted_digits.to(torch.int32).contiguous(),
        torch.arange(n_bins + 1, dtype=torch.int32, device=sorted_digits.device))
    edges = edges.to(torch.int32)
    return edges[1:] - edges[:-1], edges[:-1]


def piecewise_fill(starts: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """The step function ``out[..., j] = values[..., k]`` for
    ``starts[..., k] <= j < starts[..., k+1]`` over the last axis
    (``starts`` ascending, ``starts[..., 0] == 0``; empty segments and
    starts at ``n`` are fine): a K-element scatter-add of successive
    differences and a cumsum, as the reference builds it.  Leading axes
    are batch axes (the reference's ``vmap``)."""
    delta = torch.cat([values[..., :1], values[..., 1:] - values[..., :-1]], -1)
    arr = torch.zeros(values.shape[:-1] + (n + 1,), dtype=values.dtype,
                      device=values.device)
    # starts past the end land in the extra slot: the reference drops them
    arr.scatter_add_(-1, starts.clamp(0, n).to(torch.int64), delta)
    if arr.dim() == 1:
        return torch.cumsum(arr[:n], 0, dtype=values.dtype)
    # one 1-D scan per row: the batched innermost-dim scan of int32 on the
    # card is many times slower than the 1-D one
    rows = arr.reshape(-1, n + 1)
    out = torch.empty((rows.shape[0], n), dtype=values.dtype, device=values.device)
    for r in range(rows.shape[0]):
        torch.cumsum(rows[r, :n], 0, dtype=values.dtype, out=out[r])
    return out.reshape(values.shape[:-1] + (n,))


def searchsorted_words(sorted_bounds: Words, keys: Words) -> torch.Tensor:
    """For each key, how many bounds are lexicographically below it
    (``dest[i] = #{j : bounds[j] < key[i]}``, bounds ascending): the
    splitter bucketing of sample sort, one binary search per key on one
    ordered key of up to two words.  int32[n]."""
    n = keys[0].numel()
    if sorted_bounds[0].numel() == 0:
        return torch.zeros(n, dtype=torch.int32, device=keys[0].device)
    return torch.searchsorted(_ordered_key(sorted_bounds).contiguous(),
                              _ordered_key(keys), side="left").to(torch.int32)


def evenly_spaced_samples(sorted_words: Words, n_samples: int) -> Words:
    """``n_samples`` evenly spaced elements of a sorted shard, both ends
    included: index ``floor(i*(n-1)/d)``, d = n_samples - 1, in exact
    integer arithmetic (the reference's formula)."""
    n = sorted_words[0].numel()
    d = max(n_samples - 1, 1)
    if d * (d - 1) >= 2**31:
        raise ValueError(f"n_samples={n_samples} overflows the int32 index math "
                         "(and a sample that large defeats sampling)")
    q, r = divmod(n - 1, d)
    i = torch.arange(n_samples, dtype=torch.int64, device=sorted_words[0].device)
    idx = (i * q + (i * r) // d).clamp(0, n - 1)
    return tuple(w[idx] for w in sorted_words)
