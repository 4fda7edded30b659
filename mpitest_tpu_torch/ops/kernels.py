"""Local (single-card) sort kernels: the engine dispatch and the 64-bit
pair engine (port of ``mpitest_tpu/ops/kernels.py:20-195``).

Words are ``torch.int32`` tensors of raw uint32 bits (``ops/keys.py``).
The ``lax`` engine is the reference's ``lax.sort``, which sits outside
any Pallas kernel: here it is ``torch.sort``, with a two-word key sorted
as one int64 built from the words.  The ``bitonic`` engine runs the CUDA
kernels of ``ops/bitonic.py`` and the ``radix_pallas`` engine the fused
radix kernel of ``ops/radix.py`` (or their plain versions on the CPU).
"""

from __future__ import annotations

import torch

from mpitest_tpu_torch.ops import bitonic, radix
from mpitest_tpu_torch.ops.keys import SIGN_BIT, unsigned_order

Words = tuple[torch.Tensor, ...]

ENGINES = ("bitonic", "lax", "radix_pallas")


def _lax_sort(words: Words, stable: bool) -> Words:
    """``lax.sort`` of one or two words, lexicographic, msw first."""
    if len(words) == 1:
        s = torch.sort(unsigned_order(words[0]), stable=stable).values
        return (unsigned_order(s),)
    if len(words) != 2:
        raise ValueError(f"local sort takes 1 or 2 words, got {len(words)}")
    hi, lo = words
    # signed int64 order of ((hi ^ 2^31) << 32) | lo is the unsigned
    # lexicographic order of (hi, lo)
    key = (unsigned_order(hi).to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
    key = torch.sort(key, stable=stable).values
    w = key.view(torch.int32).view(-1, 2)  # little-endian: [:, 0] is the lsw
    return (w[:, 1] ^ SIGN_BIT, w[:, 0].contiguous())


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


def _fix_boundary(hi: torch.Tensor, lo: torch.Tensor, passes: int,
                  bsz: int) -> torch.Tensor:
    """Finish equal-hi runs that cross block boundaries: K3 sorts within
    blocks only.  A run of length <= ``passes`` that crosses boundary k
    lies inside the 2*passes-wide strip around it, so sorting the
    [nblk-1, 2*passes] strips with segment-masked odd-even passes and
    writing them back completes every such run."""
    n = hi.numel()
    nblk = n // bsz
    if nblk < 2:
        return lo
    W = passes
    hb = hi.view(nblk, bsz)
    lb = lo.view(nblk, bsz).clone()
    sh = torch.cat([hb[:-1, -W:], hb[1:, :W]], dim=1)
    sl = torch.cat([lb[:-1, -W:], lb[1:, :W]], dim=1)
    sl = bitonic.odd_even_runs(sh, sl, 2 * W)  # sorts the whole strip
    lb[:-1, -W:] = sl[:, :W]
    lb[1:, :W] = sl[:, W:]
    return lb.view(-1)


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
    lo_s = bitonic.fix_runs_pairs(hi_s, lo_r, fix_passes, b_log2)
    lo_s = _fix_boundary(hi_s, lo_s, fix_passes, 1 << b_log2)
    residual = torch.any((hi_s[1:] == hi_s[:-1])
                         & (unsigned_order(lo_s[1:]) < unsigned_order(lo_s[:-1])))
    return hi_s[:n], lo_s[:n], residual
