"""Segment pack (K5) — port of ``mpitest_tpu/ops/pallas_kernels.py``.

:func:`segment_pack` spreads P contiguous ragged segments of one word
plane, ``data[starts[p] : starts[p] + cnts[p]]``, into the ``[P, cap]``
send matrix of an exchange, with ``fill`` past each count:

    out[p, c] = c < cnts[p] ? data[starts[p] + c] : fill

(a lane inside its count whose source lies past the data reads 0, as the
reference's zero-padded input does).  Lanes past ``cap`` are dropped; the
caller detects that from the counts and regrows the cap.  It is the pack
of the ``lax`` exchange engine (``parallel/collectives.py``).

Words are ``torch.int32`` tensors of uint32 bits.  A CUDA tensor launches
``segment_pack`` of ``csrc/exchange.cu``; a CPU tensor runs
:func:`segment_pack_plain`; anything else raises, and nothing falls back
from the kernel to the plain version.  This module also holds the ctypes
glue of every entry of ``csrc/exchange.cu`` (K6 and K7 live in
``ops/exchange.py``), so one table sets every signature.
"""

from __future__ import annotations

import ctypes

import torch

from mpitest_tpu_torch.ops import _build

#: Cap alignment of the pallas pack (the reference's (8, 128) DMA chunk);
#: sort() rounds exchange caps to it.
CHUNK = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong
#: Every entry of ``csrc/exchange.cu``, the trailing stream included.
SIGNATURES = {
    "segment_pack": (_P, _P, _P, _P, _L, _I, _I, _U, _P),
    "fused_pass_pack": (_P, _P, _P, _P, _P, _P, _P, _P, _U, _U, _U, _U, _I,
                        _P, _P, _L, _I, _I, _P),
    "remote_a2a": (_P, _P, _I, _I, _I, _P),
}

_build.LAUNCHES["segment_pack"] = 0


def lib() -> ctypes.CDLL:
    """The loaded ``csrc/exchange.cu`` library, every entry typed."""
    out = _build.typed("exchange", SIGNATURES)
    if not hasattr(out, "peer_typed"):
        out.exchange_enable_peer_access.argtypes = [_I, _I]
        out.exchange_enable_peer_access.restype = _I
        out.peer_typed = True
    return out


def fill_word(fill: int) -> int:
    """A uint32 fill value as the int32 bit pattern the planes carry."""
    fill &= 0xFFFFFFFF
    return fill - (1 << 32) if fill >= 1 << 31 else fill


def check_pack_args(arrays: tuple[torch.Tensor, ...], starts: torch.Tensor,
                    cnts: torch.Tensor, cap: int, n_ranks: int) -> bool:
    """Validate a pack's planes and segment table; True for CUDA tensors,
    False for CPU ones."""
    if cap % CHUNK or cap < CHUNK:
        raise ValueError(f"cap={cap} is not a positive multiple of {CHUNK}")
    if n_ranks * cap >= 1 << 31:
        raise ValueError(f"P*cap = {n_ranks * cap} must stay below 2^31")
    dev = arrays[0].device
    n = arrays[0].numel()
    for t in arrays:
        if t.dtype != torch.int32:
            raise TypeError(f"word planes are int32 bit patterns, got {t.dtype}")
        if t.dim() != 1 or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"expected contiguous flat planes of {n}, got "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"planes on {dev} and {t.device}")
    for name, t in (("starts", starts), ("cnts", cnts)):
        if t.dtype != torch.int32 or t.shape != (n_ranks,) or t.device != dev:
            raise ValueError(f"{name} must be int32[{n_ranks}] on {dev}, got "
                             f"{t.dtype}{tuple(t.shape)} on {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"unsupported device {dev}: use cpu or cuda")


# ---------------------------------------------------------- plain version


def segment_pack_plain(data: torch.Tensor, starts: torch.Tensor,
                       cnts: torch.Tensor, cap: int, n_ranks: int,
                       fill: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K5: one gather over the ``[P, cap]`` lane
    grid."""
    n = data.numel()
    c = torch.arange(cap, dtype=torch.int64, device=data.device)
    src = starts.to(torch.int64)[:, None] + c
    inside = c < cnts.to(torch.int64)[:, None]
    in_data = (src >= 0) & (src < n)
    vals = (data[src.clamp(0, n - 1)] if n
            else torch.zeros(src.shape, dtype=torch.int32, device=data.device))
    vals = torch.where(in_data, vals, torch.zeros((), dtype=torch.int32,
                                                  device=data.device))
    return torch.where(inside, vals,
                       torch.full((), fill_word(fill), dtype=torch.int32,
                                  device=data.device))


# ----------------------------------------------------------------- wrapper


def segment_pack(data: torch.Tensor, starts: torch.Tensor, cnts: torch.Tensor,
                 cap: int, n_ranks: int, fill: int = 0) -> torch.Tensor:
    """Spread the ragged segments of one plane into its ``[P, cap]`` send
    matrix (K5); ``cap`` a multiple of :data:`CHUNK`.  Returns a new
    tensor."""
    if not check_pack_args((data,), starts, cnts, cap, n_ranks):
        return segment_pack_plain(data, starts, cnts, cap, n_ranks, fill)
    out = torch.empty((n_ranks, cap), dtype=torch.int32, device=data.device)
    _build.launch(lib(), "segment_pack", data.device, data.data_ptr(),
                  out.data_ptr(), starts.data_ptr(), cnts.data_ptr(),
                  data.numel(), n_ranks, cap, fill & 0xFFFFFFFF)
    return out
