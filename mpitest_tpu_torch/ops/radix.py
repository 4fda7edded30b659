"""Fused radix engine — LSD radix sort, one kernel call per planned pass
(port of the K4 half of ``mpitest_tpu/ops/radix_pallas.py``).

:func:`fused_radix_sort` sorts up to :data:`FUSED_MAX_WORDS` word planes
lexicographically (``words[0]`` most significant) with one stable
counting pass per entry of :func:`pass_plan`: the digit histogram, its
exclusive prefix and the stable scatter of every plane.  The plan comes
from host-static per-word value spreads (``diffs``), so range-narrow keys
sort in fewer, narrower passes and constant words are skipped.

Words are ``torch.int32`` tensors carrying uint32 bits (``ops/keys.py``).
A CUDA tensor runs the onesweep kernels of ``csrc/radix.cu``: one
``radix_histogram`` launch a sort (the digit counts of every planned
pass) and one ``radix_pass`` launch a pass (rank, decoupled look-back,
stable scatter), through one scratch buffer of :func:`scratch_words`
words; a CPU tensor runs :func:`radix_pass_plain`, a stable
``torch.sort`` of the digit and a gather, once a pass.  A tensor on any
other device raises; nothing falls back from the kernel to the plain
version.

Three counters: :func:`pass_launches` adds one per planned pass that
ran, in either form (the reference's ``_PASS_LAUNCHES``); ``LAUNCHES
["radix_pass"]`` and ``LAUNCHES["radix_histogram"]`` (``ops/_build.py``)
add one per kernel call only.

:func:`merge_order` (K8) is the inner loop of the external sort's k-way
merge under ``radix_pallas`` (``store/merge.py``): the permutation that
sorts at most :data:`MERGE_MAX_ELEMS` multi-plane keys lexicographically,
by rank of comparison.  A CUDA tensor runs the kernel ``merge_order`` of
``csrc/merge.cu`` (counted in ``LAUNCHES["merge_order"]``), a CPU tensor
:func:`merge_order_plain`.  :func:`merge_order_host` is the store's round
trip: host planes in, host order out, through one reused pinned staging
buffer.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mpitest_tpu_torch.ops import _build
from mpitest_tpu_torch.ops.keys import unsigned_order

Words = tuple[torch.Tensor, ...]

#: Digit width of one fused pass (the kernel takes up to 8 bits).
DIGIT_BITS = 8

#: Envelope the sort API routes to this engine (``models/api.py``): the
#: reference's VMEM-resident cap, kept so users get the same engine.
FUSED_MAX_ELEMS = 1 << 20

#: Widest key (in u32 words) the fused engine accepts.
FUSED_MAX_WORDS = 4

_PAD_WORD = 0xFFFFFFFF

#: Largest digit the CUDA pass takes (its shared histogram has 256 bins).
_KERNEL_MAX_BITS = 8

# Tiling of the onesweep kernels, mirrored from the constants at the top
# of csrc/radix.cu (change both together).
#: Threads of one onesweep block (``kThreads``).
TILE_THREADS = 512
#: Keys a lane ranks in one tile (``kItems``).
TILE_ITEMS = 16
#: Keys of one tile.
TILE = TILE_THREADS * TILE_ITEMS
#: Bins a pass's status row and histogram hold (``kBins``).
STATUS_BINS = 1 << _KERNEL_MAX_BITS
#: Passes one sort's scratch has tile counters for (``kMaxPasses``).
MAX_PASSES = 128

#: Merge-order element cap per merge round (the reference's
#: ``MERGE_MAX_ELEMS``): the rank is O(n^2) compares, so larger rounds go
#: to the host lexsort.
MERGE_MAX_ELEMS = 1 << 12

#: Most planes one merge-order call takes (the kernel's template range).
MERGE_MAX_PLANES = 8

#: Rows per block of the plain merge order's boolean planes.
_MERGE_PLAIN_ROWS = 512

_PASS_LAUNCHES = 0

_build.LAUNCHES["radix_pass"] = 0
_build.LAUNCHES["radix_histogram"] = 0
_build.LAUNCHES["merge_order"] = 0


def pass_launches() -> int:
    """Passes run so far (kernel or plain version)."""
    return _PASS_LAUNCHES


def pass_plan(diffs: tuple[int, ...] | None,
              n_words: int,
              digit_bits: int = DIGIT_BITS,
              ) -> tuple[tuple[int, int, int], ...]:
    """Plan the fused passes for a key whose per-word value ranges are
    known.

    ``diffs`` is msw-first (``diffs[0]`` is the most significant word),
    each entry the XOR-fold / max-min spread of that word — the same
    shape ``models/api.py`` feeds ``_passes_from_diffs``.  ``None``
    means "unknown": plan full-width passes for every word.

    Returns ``((word_idx, shift, bits), ...)`` in execution order
    (least-significant word first — LSD radix), where ``bits`` may be
    narrower than ``digit_bits`` on the top pass of a word.  Words
    whose range is constant are skipped entirely: that is the
    key-width-compaction win.
    """
    if diffs is None:
        diffs = (_PAD_WORD,) * n_words
    if len(diffs) != n_words:
        raise ValueError(
            f"pass_plan: {len(diffs)} diffs for {n_words} words")
    plan: list[tuple[int, int, int]] = []
    for wi in range(n_words - 1, -1, -1):       # lsw -> msw
        width = int(diffs[wi]).bit_length()
        shift = 0
        while shift < width:
            bits = min(digit_bits, width - shift)
            plan.append((wi, shift, bits))
            shift += bits
    return tuple(plan)


def tiles(n: int) -> int:
    """Onesweep tiles of ``n`` keys."""
    return -(-n // TILE)


def status_words(n: int) -> int:
    """32-bit words of the look-back status: one 64-bit word per tile and
    bin."""
    return tiles(n) * STATUS_BINS * 2


def scratch_words(n: int, passes: int) -> int:
    """32-bit words of one sort's scratch: the status, a tile counter per
    possible pass, and one histogram per planned pass."""
    return status_words(n) + MAX_PASSES + passes * STATUS_BINS


# ------------------------------------------------------------ kernel glue

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "radix_histogram": (_P, _P, _P, _P, _I, _L, _P, _I, _P, _L, _P),
    "radix_pass": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I,
                   _P, _L, _P),
}
MERGE_SIGNATURES = {
    "merge_order": (_P, _I, _I, _P, _P),
}


def _lib() -> ctypes.CDLL:
    return _build.typed("radix", _SIGNATURES)


def _ptrs(planes: Words) -> list[int | None]:
    return [t.data_ptr() for t in planes] + [None] * (4 - len(planes))


def _launch_histogram(device: torch.device, src: Words, n: int,
                      plan: tuple[tuple[int, int, int], ...],
                      scratch: torch.Tensor) -> None:
    triples = (ctypes.c_int * (3 * len(plan)))(*(v for p in plan for v in p))
    _build.launch(_lib(), "radix_histogram", device, *_ptrs(src), len(src), n,
                  triples, len(plan), scratch.data_ptr(), scratch.numel())


def _launch(device: torch.device, src: Words, dst: Words, n: int, widx: int,
            shift: int, bits: int, k: int, scratch: torch.Tensor) -> None:
    _build.launch(_lib(), "radix_pass", device, *_ptrs(src), *_ptrs(dst),
                  len(src), n, widx, shift, bits, k, scratch.data_ptr(),
                  scratch.numel())


def _on_card(words: Words, n: int, max_words: int = FUSED_MAX_WORDS,
             what: str = "fused radix sort") -> bool:
    """Validate word planes; True for CUDA tensors, False for CPU ones."""
    if not 1 <= len(words) <= max_words:
        raise ValueError(f"{what} takes 1..{max_words} "
                         f"word planes, got {len(words)}")
    dev = words[0].device
    for t in words:
        if t.dtype != torch.int32:
            raise TypeError(f"word planes are int32 bit patterns, got {t.dtype}")
        if t.dim() != 1 or t.numel() != n:
            raise ValueError(f"expected a flat plane of {n}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("word planes must be contiguous")
        if t.device != dev:
            raise ValueError(f"planes on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"unsupported device {dev}: use cpu or cuda")


# ---------------------------------------------------------- plain version


def radix_pass_plain(planes: Words, widx: int, shift: int, bits: int) -> Words:
    """Plain PyTorch version of one K4 pass: a stable sort of the
    unsigned digit ``(planes[widx] >> shift) & (2^bits - 1)`` and a gather
    of every plane.  Returns new tensors."""
    u = planes[widx].to(torch.int64) & 0xFFFFFFFF
    digit = (u >> shift) & ((1 << bits) - 1)
    order = torch.sort(digit, stable=True).indices
    return tuple(p[order] for p in planes)


# ----------------------------------------------------------------- wrapper


def fused_radix_sort(words: Words,
                     diffs: tuple[int, ...] | None = None,
                     digit_bits: int = DIGIT_BITS) -> Words:
    """Sort u32 word planes lexicographically (``words[0]`` most
    significant) with one kernel call per radix pass, after one
    histogram call a sort on a card.

    Bit-identical to a stable lexicographic sort for any ``diffs`` that
    covers the data (``None`` always does): each pass is a stable
    counting sort by the planned digit, and constant bits never
    discriminate.  ``n <= 1`` or an empty plan returns ``words`` as
    given.  Otherwise returns new tensors; the inputs are not modified.
    The wrapper allocates the double buffers and the scratch once per
    call.
    """
    global _PASS_LAUNCHES
    words = tuple(words)
    n = int(words[0].numel())
    plan = pass_plan(diffs, len(words), digit_bits)
    if n <= 1 or not plan:
        # zero/one element, or every word constant: already sorted
        return words
    if not _on_card(words, n):
        planes = words
        for widx, shift, bits in plan:
            planes = radix_pass_plain(planes, widx, shift, bits)
            _PASS_LAUNCHES += 1
        return planes
    if digit_bits > _KERNEL_MAX_BITS:
        raise ValueError(f"digit_bits={digit_bits}: the CUDA pass takes "
                         f"digits of at most {_KERNEL_MAX_BITS} bits")
    if n >= 1 << 31:
        raise ValueError(f"n={n}: the CUDA pass takes fewer than 2^31 keys")
    if len(plan) > MAX_PASSES:
        raise ValueError(f"{len(plan)} passes: the CUDA sort takes at most "
                         f"{MAX_PASSES}")
    dev = words[0].device
    bufs = [tuple(torch.empty_like(w) for w in words)
            for _ in range(min(2, len(plan)))]
    scratch = torch.empty(scratch_words(n, len(plan)), dtype=torch.int32,
                          device=dev)
    _launch_histogram(dev, words, n, plan, scratch)
    src = words
    for k, (widx, shift, bits) in enumerate(plan):
        dst = bufs[k % 2]
        _launch(dev, src, dst, n, widx, shift, bits, k, scratch)
        _PASS_LAUNCHES += 1
        src = dst
    return src


# ------------------------------------------------------ K8: merge order


def _check_merge_envelope(n_planes: int, n: int) -> None:
    if not 1 <= n_planes <= MERGE_MAX_PLANES:
        raise ValueError(f"merge_order takes 1..{MERGE_MAX_PLANES} planes, "
                         f"got {n_planes}")
    if n > MERGE_MAX_ELEMS:
        raise ValueError(
            f"merge_order: n={n} above MERGE_MAX_ELEMS={MERGE_MAX_ELEMS}"
            " — O(n^2) ranking; use the host lexsort")


def merge_order_plain(planes: Words) -> torch.Tensor:
    """Plain PyTorch version of K8: rank by comparison as broadcast boolean
    planes and a row sum, in blocks of rows.  ``rank_i = #{j : key_j <lex
    key_i} + #{j < i : key_j == key_i}`` (unsigned words, plane 0 most
    significant) and ``order[rank_i] = i``, which is ``np.lexsort`` of the
    reversed planes."""
    n = int(planes[0].numel())
    u = [unsigned_order(p) for p in planes]
    idx = torch.arange(n, dtype=torch.int32, device=planes[0].device)
    order = torch.empty(n, dtype=torch.int32, device=planes[0].device)
    for r0 in range(0, n, _MERGE_PLAIN_ROWS):
        rows = slice(r0, min(n, r0 + _MERGE_PLAIN_ROWS))
        lt = torch.zeros((rows.stop - r0, n), dtype=torch.bool,
                         device=planes[0].device)
        eq = torch.ones_like(lt)
        for w in u:
            a, b = w[rows, None], w[None, :]      # key_i down, key_j across
            lt |= eq & (b < a)
            eq &= b == a
        lt |= eq & (idx[None, :] < idx[rows, None])
        order[lt.sum(dim=1)] = idx[rows]
    return order


def _merge_lib() -> ctypes.CDLL:
    return _build.typed("merge", MERGE_SIGNATURES)


def _launch_merge(device: torch.device, stacked: torch.Tensor, k: int, n: int,
                  out: torch.Tensor) -> None:
    _build.launch(_merge_lib(), "merge_order", device, stacked.data_ptr(), k, n,
                  out.data_ptr())


def merge_order(planes: Words) -> torch.Tensor:
    """The int32 permutation that sorts ``planes`` lexicographically (plane
    0 most significant, unsigned words): ``np.lexsort`` of the reversed
    planes, stable on ties.  Up to :data:`MERGE_MAX_PLANES` int32 planes of
    the same ``n <= MERGE_MAX_ELEMS`` on one device; a larger ``n`` raises
    ``ValueError``.  ``n <= 1`` returns zeros without a launch.  CUDA
    planes run the kernel (stacked into one ``[k, n]`` buffer), CPU planes
    the plain version."""
    planes = tuple(planes)
    n = int(planes[0].numel())
    _check_merge_envelope(len(planes), n)
    on_card = _on_card(planes, n, MERGE_MAX_PLANES, "merge_order")
    dev = planes[0].device
    if n <= 1:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    if not on_card:
        return merge_order_plain(planes)
    stacked = torch.stack(planes)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    _launch_merge(dev, stacked, len(planes), n, out)
    return out


class _Staging:
    """Pinned host and device buffers of one card's merge-order round
    trip, sized for the largest round and reused by every round."""

    def __init__(self, device: torch.device) -> None:
        cap = MERGE_MAX_PLANES * MERGE_MAX_ELEMS
        self.pin_in = torch.empty(cap, dtype=torch.int32, pin_memory=True)
        self.pin_out = torch.empty(MERGE_MAX_ELEMS, dtype=torch.int32,
                                   pin_memory=True)
        self.dev_in = torch.empty(cap, dtype=torch.int32, device=device)
        self.dev_out = torch.empty(MERGE_MAX_ELEMS, dtype=torch.int32,
                                   device=device)


_STAGING: dict[torch.device, _Staging] = {}


def merge_order_host(planes: "tuple[np.ndarray, ...]",
                     device: torch.device | str) -> np.ndarray:
    """:func:`merge_order` of host uint32 planes on ``device``; returns the
    int32 order on the host.

    On a card: the planes are stacked into a pinned ``[k, n]`` staging
    buffer, copied to the card in one copy, ranked by one kernel launch on
    the current stream, and the order comes back in one copy; the stream
    is synchronised, since the caller gathers by the order at once.  The
    staging buffers are allocated once per card and reused.  On the CPU:
    the plain version."""
    device = torch.device(device)
    k = len(planes)
    n = int(np.asarray(planes[0]).size)
    _check_merge_envelope(k, n)
    if device.type == "cpu":
        host = tuple(torch.from_numpy(np.ascontiguousarray(p, np.uint32)
                                      .view(np.int32)) for p in planes)
        return merge_order(host).numpy()
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}: use cpu or cuda")
    if n <= 1:
        return np.zeros(n, np.int32)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    st = _STAGING.get(device)
    if st is None:
        st = _STAGING[device] = _Staging(device)
    view = st.pin_in[:k * n].numpy().view(np.uint32).reshape(k, n)
    for row, p in zip(view, planes):
        row[...] = p
    with torch.cuda.device(device):
        st.dev_in[:k * n].copy_(st.pin_in[:k * n], non_blocking=True)
        _launch_merge(device, st.dev_in, k, n, st.dev_out)
        st.pin_out[:n].copy_(st.dev_out[:n], non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
    return st.pin_out[:n].numpy().copy()
