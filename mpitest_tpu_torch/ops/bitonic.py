"""Bitonic sort — the single-card local sort engine (port of
``mpitest_tpu/ops/bitonic.py``).

Three CUDA kernels in ``csrc/bitonic.cu`` carry it:

* **K1** ``bitonic_u32`` behind :func:`sort_padded` — an ascending sort of
  a padded power-of-two plane of uint32 words.  A one-word sort has one
  output, so K1 is a tile sort of ``2^KEY_TILE_LOG2`` keys followed by
  :func:`merge_rounds` merge-path rounds, each one read and one write of
  the plane, ping-ponging through a scratch plane the wrapper allocates;
* **K2** ``bitonic_pairs_u32`` behind :func:`sort_pairs_padded` — the
  standard bitonic network on (key, payload) pairs; the payload follows
  the key result (``out_k == k``: a position keeps its payload iff its key
  did not change, so ties keep their own).  The payload order inside an
  equal-key run is the network's own permutation, which the 64-bit
  caller's residual flag reads, so K2 keeps every comparator and changes
  only the schedule (:func:`network_plan`: one tile sort, staged passes of
  up to ``STAGE_LAYERS`` layers, one tail pass per stage);
* **K3** ``fix_runs_pairs`` behind :func:`fix_runs_pairs` — segment-masked
  odd-even transposition of the payload within runs of equal key, per
  block; behind :func:`fix_runs_flag` the same entry is the pair engine's
  whole phase B: K3, the boundary strips (a second kernel, in place) and
  the residual flag, one device byte, in one call.

Words are ``torch.int32`` tensors carrying raw uint32 bits (see
``ops/keys.py``).  Each wrapper checks its arguments, runs the plain
PyTorch version of its kernel when the tensor lies on the CPU, launches
the kernel on the current CUDA stream when it lies on a card, and raises
on anything else.  There is no fallback from the kernel to the plain
version.  Each kernel entry call adds one to :data:`LAUNCHES`, however
many CUDA launches it makes.

The TPU schedule of the reference (lane/sublane rolls, flip bookkeeping,
rotation relayout, 2^16-element VMEM blocks) is not ported; K2's logical
network, and so every output, is the same.  ``b_log2`` is kept in the
signatures: it sets the blocking of :func:`fix_runs_pairs`, whose result
depends on it, and is accepted unused by the two sort wrappers.
"""

from __future__ import annotations

import ctypes

import torch

from mpitest_tpu_torch.ops import _build
from mpitest_tpu_torch.ops.keys import unsigned_order

#: log2 of the reference's block (the ``b_log2`` the callers pass).
BLOCK_LOG2 = 16
#: below this the padded network does not pay for itself (reference rule).
MIN_SORT_LOG2 = 13
#: log2 of the reference pair-engine block (also K3's ``bsz``).
PAIR_BLOCK_LOG2 = 16

# The schedule constants of csrc/bitonic.cu (kPairTileLog2, kStageLayers,
# kKeyTileLog2, kMergeWinLog2 and the warp widths 5 + log2(regs)).
#: K2 tile: pairs sorted in shared memory by one block.
PAIR_TILE_LOG2 = 13
#: K2 layers one staged pass retires.
STAGE_LAYERS = 8
#: K1 tile: keys a block sorts before the merge rounds.
KEY_TILE_LOG2 = 14
#: K1 merge-round output window (keys per block).
MERGE_WINDOW_LOG2 = 13
_PAIR_WARP_LOG2 = 9    # 32 lanes x 16 pairs: the least K2 tile
_KEY_WARP_LOG2 = 10    # 32 lanes x 32 keys: the least K1 tile

#: Kernel launches per entry (the package-wide table of ``ops/_build.py``).
LAUNCHES = _build.LAUNCHES
LAUNCHES.update({"bitonic_u32": 0, "bitonic_pairs_u32": 0, "fix_runs_pairs": 0})
launches = _build.launches
reset_launches = _build.reset_launches


# ----------------------------------------------------------- schedule plan


def _log2_exact(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"length {n} is not a power of two")
    return n.bit_length() - 1


def network_plan(n: int) -> tuple[int, int, int]:
    """K2's passes through global memory for ``n`` pairs, as
    ``bitonic_pairs_u32`` launches them: ``(tile sorts, staged passes,
    tail passes)``.  Stage m above the tile takes ceil((m - tl) /
    STAGE_LAYERS) staged passes and one tail pass."""
    t = _log2_exact(n)
    tl = max(min(t, PAIR_TILE_LOG2), _PAIR_WARP_LOG2)
    staged = sum(-(-(m - tl) // STAGE_LAYERS) for m in range(tl + 1, t + 1))
    return 1, staged, max(t - tl, 0)


def merge_rounds(n: int) -> int:
    """K1's merge rounds after its tile sort of ``n`` keys (each one read
    and one write of the plane)."""
    t = _log2_exact(n)
    return max(t - max(min(t, KEY_TILE_LOG2), _KEY_WARP_LOG2), 0)


def scratch_words(n: int) -> int:
    """Words of scratch K1 needs for ``n`` keys: a second plane and one
    merge-path start per output window, or nothing without merge rounds."""
    return n + (n >> MERGE_WINDOW_LOG2) if merge_rounds(n) else 0


# ------------------------------------------------------------ kernel glue

_P = ctypes.c_void_p
_SIGNATURES = {
    "bitonic_u32": (_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P),
    "bitonic_pairs_u32": (_P, _P, _P, _P, ctypes.c_longlong, _P),
    "fix_runs_pairs": (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_longlong, _P),
}


def _lib() -> ctypes.CDLL:
    return _build.typed("bitonic", _SIGNATURES)


def _launch(name: str, device: torch.device, *args: int) -> None:
    """Call kernel entry ``name`` on the current stream of ``device``;
    raise if the launch was refused."""
    _build.launch(_lib(), name, device, *args)


def _on_card(*ts: torch.Tensor, n: int) -> bool:
    """Validate word planes; True for CUDA tensors, False for CPU ones."""
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"word planes are int32 bit patterns, got {t.dtype}")
        if t.dim() != 1 or t.numel() != n:
            raise ValueError(f"expected a flat plane of {n}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("word planes must be contiguous")
        if t.device != dev:
            raise ValueError(f"planes on {dev} and {t.device}")
    if n < 1 or n & (n - 1):
        raise ValueError(f"length {n} is not a power of two")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"unsupported device {dev}: use cpu or cuda")


# ---------------------------------------------------------- plain versions


def _network_plain(k: torch.Tensor, p: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The standard bitonic network with reshapes: for layer distance
    ``d`` the array is viewed as ``[-1, 2, d]``; group ``g`` holds the
    pairs (i, i + d) and sorts descending where bit ``m`` of i (bit
    ``m - j - 1`` of g) is set.  The payload follows ``out_k == k``."""
    n = k.numel()
    t = n.bit_length() - 1
    k = unsigned_order(k)  # signed compares in unsigned order
    for m in range(1, t + 1):
        for j in range(m - 1, -1, -1):
            d = 1 << j
            kv = k.view(-1, 2, d)
            a, b = kv[:, 0], kv[:, 1]
            g = torch.arange(kv.shape[0], device=k.device)
            desc = ((g >> (m - j - 1)) & 1).bool().view(-1, 1)
            lo, hi = torch.minimum(a, b), torch.maximum(a, b)
            na, nb = torch.where(desc, hi, lo), torch.where(desc, lo, hi)
            if p is not None:
                pv = p.view(-1, 2, d)
                pa, pb = pv[:, 0], pv[:, 1]
                p = torch.stack([torch.where(na == a, pa, pb),
                                 torch.where(nb == b, pb, pa)], 1).reshape(-1)
            k = torch.stack([na, nb], 1).reshape(-1)
    return unsigned_order(k), p


def sort_padded_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1."""
    return _network_plain(x)[0]


def sort_pairs_padded_plain(k: torch.Tensor, p: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2."""
    ks, ps = _network_plain(k, p)
    assert ps is not None
    return ks, ps


def odd_even_runs(hi: torch.Tensor, lo: torch.Tensor,
                  passes: int) -> torch.Tensor:
    """``passes`` segment-masked odd-even transposition passes along the
    last axis of ``[rows, w]`` planes (the reference's ``_fix_runs_oe``
    per row): pass t compares (i, i+1) for i of parity t & 1 and swaps lo
    when hi[i] == hi[i+1] and lo[i] > lo[i+1] (unsigned).  The last
    column pairs with nothing.  Returns the new lo."""
    w = hi.shape[-1]
    same = hi[..., :-1] == hi[..., 1:]
    lo = lo.clone()
    for t in range(passes):
        par = t & 1
        a, b = lo[..., par:w - 1:2], lo[..., par + 1:w:2]
        act = same[..., par:w - 1:2] & (unsigned_order(a) > unsigned_order(b))
        na, nb = torch.where(act, b, a), torch.where(act, a, b)
        lo[..., par:w - 1:2] = na
        lo[..., par + 1:w:2] = nb
    return lo


def fix_runs_pairs_plain(hi: torch.Tensor, lo: torch.Tensor, passes: int,
                         b_log2: int) -> torch.Tensor:
    """Plain PyTorch version of K3: :func:`odd_even_runs` per block."""
    bsz = 1 << b_log2
    nblk = hi.numel() // bsz
    return odd_even_runs(hi.view(nblk, bsz), lo.view(nblk, bsz),
                         passes).reshape(-1)


def fix_boundary_plain(hi: torch.Tensor, lo: torch.Tensor, passes: int,
                       bsz: int) -> torch.Tensor:
    """Finish equal-hi runs that cross block boundaries: K3 sorts within
    blocks only.  A run of length <= ``passes`` that crosses boundary k
    lies inside the 2*passes-wide strip around it, so sorting the
    [nblk-1, 2*passes] strips with segment-masked odd-even passes and
    writing them back completes every such run (the reference's
    ``kernels._fix_boundary``).  ``passes == 0`` leaves no strip (the
    reference's ``-0`` slice takes whole blocks there and fails)."""
    n = hi.numel()
    nblk = n // bsz
    if nblk < 2 or passes == 0:
        return lo
    W = passes
    hb = hi.view(nblk, bsz)
    lb = lo.view(nblk, bsz).clone()
    sh = torch.cat([hb[:-1, -W:], hb[1:, :W]], dim=1)
    sl = torch.cat([lb[:-1, -W:], lb[1:, :W]], dim=1)
    sl = odd_even_runs(sh, sl, 2 * W)  # sorts the whole strip
    lb[:-1, -W:] = sl[:, :W]
    lb[1:, :W] = sl[:, W:]
    return lb.view(-1)


def residual_plain(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The pair engine's residual flag: some adjacent pair has equal hi
    and descending lo (unsigned).  A 0-dim bool tensor."""
    return torch.any((hi[1:] == hi[:-1])
                     & (unsigned_order(lo[1:]) < unsigned_order(lo[:-1])))


def fix_runs_flag_plain(hi: torch.Tensor, lo: torch.Tensor, passes: int,
                        b_log2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of phase B (:func:`fix_runs_flag`): K3's plain
    version, the boundary strips and the residual expression."""
    fixed = fix_runs_pairs_plain(hi, lo, passes, b_log2)
    fixed = fix_boundary_plain(hi, fixed, passes, 1 << b_log2)
    return fixed, residual_plain(hi, fixed)


# ----------------------------------------------------------------- wrappers


def sort_padded(x: torch.Tensor, n_pow2: int, b_log2: int) -> torch.Tensor:
    """Sort a flat power-of-two word plane of ``n_pow2`` uint32 bit
    patterns ascending (K1: tile sort, then :func:`merge_rounds` merge-path
    rounds through a scratch plane of :func:`scratch_words`).  ``x`` is not
    written.  Returns a new tensor."""
    if not _on_card(x, n=n_pow2):
        return sort_padded_plain(x)
    out = torch.empty_like(x)
    words = scratch_words(n_pow2)
    scratch = torch.empty(words, dtype=torch.int32, device=x.device) if words else None
    _launch("bitonic_u32", x.device, x.data_ptr(), out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), words, n_pow2)
    return out


def sort_pairs_padded(k: torch.Tensor, p: torch.Tensor, n_pow2: int,
                      b_log2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Bitonic-sort ``(k, p)`` pairs by the key plane only (K2, in the
    passes of :func:`network_plan`).

    Equal keys keep their own payloads at every comparator, so within an
    equal-key run the payload order is the network's deterministic
    permutation, byte-equal to :func:`sort_pairs_padded_plain`; the 64-bit
    caller fixes runs afterwards.  Returns new tensors."""
    if not _on_card(k, p, n=n_pow2):
        return sort_pairs_padded_plain(k, p)
    ko, po = torch.empty_like(k), torch.empty_like(p)
    _launch("bitonic_pairs_u32", k.device, k.data_ptr(), p.data_ptr(),
            ko.data_ptr(), po.data_ptr(), n_pow2)
    return ko, po


#: most passes the K3 kernel takes (``kFixMaxPasses``; its halo is 36).
FIX_MAX_PASSES = 32


def _check_fix(hi: torch.Tensor, passes: int, b_log2: int) -> int:
    n = hi.numel()
    if not 0 <= passes <= FIX_MAX_PASSES:
        raise ValueError(f"passes={passes}: use 0..{FIX_MAX_PASSES}")
    if b_log2 < 1 or n % (1 << b_log2):
        raise ValueError(f"length {n} is not a multiple of 2^{b_log2}")
    return n


def fix_runs_pairs(hi: torch.Tensor, lo: torch.Tensor, passes: int,
                   b_log2: int) -> torch.Tensor:
    """Sort ``lo`` within equal-``hi`` runs of length <= ``passes`` inside
    each ``2^b_log2`` block (K3); runs that cross blocks are the caller's
    boundary-strip job.  Returns the new lo plane."""
    n = _check_fix(hi, passes, b_log2)
    if not _on_card(hi, lo, n=n):
        return fix_runs_pairs_plain(hi, lo, passes, b_log2)
    out = torch.empty_like(lo)
    _launch("fix_runs_pairs", hi.device, hi.data_ptr(), lo.data_ptr(),
            out.data_ptr(), 0, n, passes, 1 << b_log2)
    return out


def fix_runs_flag(hi: torch.Tensor, lo: torch.Tensor, passes: int,
                  b_log2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The pair engine's phase B in one K3 call: :func:`fix_runs_pairs`,
    the boundary strips of :func:`fix_boundary_plain` and the residual
    flag of :func:`residual_plain` on the result.  With two blocks or
    more the block must exceed ``2 * passes`` (the strips must not
    touch).  Returns ``(lo, residual)``, residual a 0-dim bool tensor."""
    n = _check_fix(hi, passes, b_log2)
    if not _on_card(hi, lo, n=n):
        return fix_runs_flag_plain(hi, lo, passes, b_log2)
    if n > 1 << b_log2 and 1 << b_log2 <= 2 * passes:
        raise ValueError(f"block 2^{b_log2} must exceed 2 * passes = {2 * passes}")
    out = torch.empty_like(lo)
    flag = torch.empty((), dtype=torch.bool, device=hi.device)
    _launch("fix_runs_pairs", hi.device, hi.data_ptr(), lo.data_ptr(),
            out.data_ptr(), flag.data_ptr(), n, passes, 1 << b_log2)
    return out, flag


def bitonic_sort_u32(x: torch.Tensor) -> torch.Tensor:
    """Sort a flat word plane ascending (unsigned order).

    Pads to the next power of two with the max sentinel (pads sort to the
    tail and are sliced off).  Below ``2^MIN_SORT_LOG2``, and where the
    padding would exceed the break-even (``n*10 < n_pow2*6``), the exact
    n goes to ``torch.sort`` instead — the reference's ``lax.sort`` rule."""
    n = x.numel()
    if n == 0:
        return x
    t = max((n - 1).bit_length(), MIN_SORT_LOG2)
    if n < (1 << MIN_SORT_LOG2) or n * 10 < (1 << t) * 6:
        return unsigned_order(torch.sort(unsigned_order(x)).values)
    b_log2 = min(BLOCK_LOG2, t)
    n_pow2 = 1 << t
    if n_pow2 != n:
        pad = torch.full((n_pow2 - n,), -1, dtype=torch.int32, device=x.device)
        xp = torch.cat([x, pad])
    else:
        xp = x.contiguous()
    out = sort_padded(xp, n_pow2, b_log2)
    return out[:n] if n_pow2 != n else out
