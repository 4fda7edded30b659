"""Fused radix engine — LSD radix sort, one kernel call per planned pass
(port of the K4 half of ``mpitest_tpu/ops/radix_pallas.py``).

:func:`fused_radix_sort` sorts up to :data:`FUSED_MAX_WORDS` word planes
lexicographically (``words[0]`` most significant) with one stable
counting pass per entry of :func:`pass_plan`: the digit histogram, its
exclusive prefix and the stable scatter of every plane.  The plan comes
from host-static per-word value spreads (``diffs``), so range-narrow keys
sort in fewer, narrower passes and constant words are skipped.

Words are ``torch.int32`` tensors carrying uint32 bits (``ops/keys.py``).
A CUDA tensor runs each pass as the kernel ``radix_pass`` of
``csrc/radix.cu`` (three CUDA launches: tile histogram, per-bin scan,
stable scatter); a CPU tensor runs :func:`radix_pass_plain`, a stable
``torch.sort`` of the digit and a gather.  A tensor on any other device
raises; nothing falls back from the kernel to the plain version.

Two counters: :func:`pass_launches` adds one per planned pass that ran,
in either form (the reference's ``_PASS_LAUNCHES``); ``LAUNCHES
["radix_pass"]`` (``ops/_build.py``) adds one per kernel call only.

The reference's merge-order kernel (K8, ``merge_order``) is not part of
this module yet.
"""

from __future__ import annotations

import ctypes

import torch

from mpitest_tpu_torch.ops import _build

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

_PASS_LAUNCHES = 0

_build.LAUNCHES["radix_pass"] = 0


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


# ------------------------------------------------------------ kernel glue

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "radix_pass": (_P, _P, _P, _P, _P, _P, _P, _P, _I, ctypes.c_longlong,
                   _I, _I, _I, _P, _P, _P),
}


def _lib() -> ctypes.CDLL:
    lib = _build.typed("radix", _SIGNATURES)
    lib.radix_hist_words.argtypes = [ctypes.c_longlong]
    lib.radix_hist_words.restype = ctypes.c_longlong
    return lib


def _launch(device: torch.device, src: Words, dst: Words, n: int, widx: int,
            shift: int, bits: int, hist: torch.Tensor,
            totals: torch.Tensor) -> None:
    pad = [None] * (4 - len(src))
    ins = [t.data_ptr() for t in src] + pad
    outs = [t.data_ptr() for t in dst] + pad
    _build.launch(_lib(), "radix_pass", device, *ins, *outs, len(src), n,
                  widx, shift, bits, hist.data_ptr(), totals.data_ptr())


def _on_card(words: Words, n: int) -> bool:
    """Validate word planes; True for CUDA tensors, False for CPU ones."""
    if not 1 <= len(words) <= FUSED_MAX_WORDS:
        raise ValueError(f"fused radix sort takes 1..{FUSED_MAX_WORDS} "
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
    significant) with one kernel call per radix pass.

    Bit-identical to a stable lexicographic sort for any ``diffs`` that
    covers the data (``None`` always does): each pass is a stable
    counting sort by the planned digit, and constant bits never
    discriminate.  ``n <= 1`` or an empty plan returns ``words`` as
    given.  Otherwise returns new tensors; the inputs are not modified.
    The kernel allocates its double buffers and scratch once per call.
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
    dev = words[0].device
    bufs = [tuple(torch.empty_like(w) for w in words)
            for _ in range(min(2, len(plan)))]
    hist = torch.empty(int(_lib().radix_hist_words(n)), dtype=torch.int32,
                       device=dev)
    totals = torch.empty(1 << _KERNEL_MAX_BITS, dtype=torch.int32, device=dev)
    src = words
    for k, (widx, shift, bits) in enumerate(plan):
        dst = bufs[k % 2]
        _launch(dev, src, dst, n, widx, shift, bits, hist, totals)
        _PASS_LAUNCHES += 1
        src = dst
    return src
