"""Key codecs: map key dtypes to tuples of sortable uint32 words.

Every key dtype is encoded as a tuple of **uint32 words, most-significant
first**, such that lexicographic unsigned comparison of the word tuple
equals the native comparison of the original keys (the biased encoding
flips the sign bit, so signed keys sort correctly; floats use the IEEE
totalOrder flip).  The host side works on numpy ``uint32`` arrays.

Device words are ``torch.int32`` tensors that carry the raw uint32 bit
pattern: ``torch.uint32`` lacks ``+`` and ``>>``, so one representation
serves every device op.  Unsigned order is recovered by XOR with
``0x80000000`` before a signed compare (:func:`unsigned_order`); wrapping
sums are taken in int64 and masked; the host view of a device word is
``.cpu().numpy().view(np.uint32)`` (:func:`to_host_words`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_SIGN32 = np.uint32(0x80000000)

#: ``0x80000000`` as the int32 scalar that XORs the sign bit of a device word.
SIGN_BIT = -(2**31)

#: All-ones uint32 word — the pad fill that sorts to the tail.
MAX_WORD = 0xFFFFFFFF

_NARROW = (np.dtype(np.int16), np.dtype(np.uint16),
           np.dtype(np.int8), np.dtype(np.uint8))


def unsigned_order(w: torch.Tensor) -> torch.Tensor:
    """Signed int32 tensor whose order is the unsigned order of ``w``."""
    return w ^ SIGN_BIT


def to_host_words(w: torch.Tensor) -> np.ndarray:
    """Device word -> host uint32 array (same bits)."""
    return w.cpu().numpy().view(np.uint32)


def to_device_words(w: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """Host uint32 array -> device word (same bits)."""
    host = torch.from_numpy(np.ascontiguousarray(w, np.uint32).view(np.int32))
    return host.to(device)


@dataclass(frozen=True)
class KeyCodec:
    """Encode/decode a numeric dtype to/from uint32 word tuples.

    Floats use the IEEE total-order flip (negative values: all bits
    inverted; non-negative: sign bit set), a bit-preserving bijection, so
    NaNs, infinities, -0.0 < +0.0 and NaN payloads all sort in
    ``totalOrder`` and decode back to their exact input bits.  This is a
    documented divergence from ``np.sort`` (which moves every NaN to
    the tail and treats ±0.0 as equal); the sorted multiset of bit
    patterns is identical.
    """

    dtype: np.dtype
    n_words: int

    def _split64(self, u: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return (
            (u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        )

    def encode(self, x: np.ndarray) -> tuple[np.ndarray, ...]:
        """Host array -> tuple of uint32 word arrays, most-significant first."""
        x = np.asarray(x, dtype=self.dtype)
        if self.dtype in _NARROW:
            # narrow ints widen losslessly into the 32-bit paths
            wide = np.int32 if self.dtype.kind == "i" else np.uint32
            return codec_for(wide).encode(x.astype(wide))
        if self.dtype == np.dtype(np.int32):
            return ((x.view(np.uint32) ^ _SIGN32),)
        if self.dtype == np.dtype(np.uint32):
            return (x.copy(),)
        if self.dtype == np.dtype(np.float32):
            u = x.view(np.uint32)
            return (np.where(u & _SIGN32, ~u, u ^ _SIGN32),)
        if self.dtype == np.dtype(np.int64):
            return self._split64(x.view(np.uint64) ^ np.uint64(0x8000000000000000))
        if self.dtype == np.dtype(np.uint64):
            return self._split64(x)
        if self.dtype == np.dtype(np.float64):
            u = x.view(np.uint64)
            s = np.uint64(0x8000000000000000)
            return self._split64(np.where(u & s, ~u, u ^ s))
        raise TypeError(f"unsupported key dtype: {self.dtype}")

    def decode(self, words: tuple[np.ndarray, ...]) -> np.ndarray:
        """Tuple of uint32 word arrays (msw first) -> host array of dtype."""
        words = tuple(np.asarray(w, dtype=np.uint32) for w in words)
        if len(words) != self.n_words:
            raise ValueError(f"expected {self.n_words} words, got {len(words)}")
        if self.dtype in _NARROW:
            wide = np.int32 if self.dtype.kind == "i" else np.uint32
            return codec_for(wide).decode(words).astype(self.dtype)
        if self.dtype == np.dtype(np.int32):
            return (words[0] ^ _SIGN32).view(np.int32)
        if self.dtype == np.dtype(np.uint32):
            return words[0].copy()
        if self.dtype == np.dtype(np.float32):
            e = words[0]
            return np.where(e & _SIGN32, e ^ _SIGN32, ~e).view(np.float32)
        u = (words[0].astype(np.uint64) << np.uint64(32)) | words[1].astype(np.uint64)
        if self.dtype == np.dtype(np.int64):
            return (u ^ np.uint64(0x8000000000000000)).view(np.int64)
        if self.dtype == np.dtype(np.float64):
            s = np.uint64(0x8000000000000000)
            return np.where(u & s, u ^ s, ~u).view(np.float64)
        return u  # uint64

    def encode_torch(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Device-side encode of a tensor of this codec's dtype: bit views
        and sign-bias XORs only, on the tensor's own device.

        A 64-bit tensor is viewed as int32 ``[..., 2]``; the minor word is
        the least significant (little-endian, as on every CUDA host), so
        the split into (hi, lo) words is a relayout with no 64-bit
        arithmetic."""
        if numpy_dtype(x.dtype) != self.dtype:
            raise TypeError(f"tensor has dtype {x.dtype}, expected {self.dtype}")
        if self.dtype in _NARROW:
            # int32 holds every narrow value exactly; the unsigned ones are
            # then already their own uint32 bit pattern
            w = x.to(torch.int32)
            return (w ^ SIGN_BIT,) if self.dtype.kind == "i" else (w,)
        if self.dtype == np.dtype(np.int32):
            return (x ^ SIGN_BIT,)
        if self.dtype == np.dtype(np.uint32):
            return (x.view(torch.int32).clone(),)
        if self.dtype == np.dtype(np.float32):
            u = x.view(torch.int32)
            return (torch.where(u < 0, ~u, u ^ SIGN_BIT),)
        if self.n_words == 2:
            w = x.contiguous().view(torch.int32).view(-1, 2)
            lo, hi = w[:, 0], w[:, 1]
            if self.dtype == np.dtype(np.int64):
                hi = hi ^ SIGN_BIT
            elif self.dtype == np.dtype(np.float64):
                neg = hi < 0
                hi, lo = torch.where(neg, ~hi, hi ^ SIGN_BIT), torch.where(neg, ~lo, lo)
            return (hi.contiguous(), lo.contiguous())
        raise TypeError(f"device-side encode unsupported for {self.dtype}")

    def max_sentinel(self) -> tuple[int, ...]:
        """Word values that encode the maximum representable key (sorts
        last); the per-word pad fill (see :data:`MAX_WORD`)."""
        return (MAX_WORD,) * self.n_words


_CODECS = {
    np.dtype(np.int8): KeyCodec(np.dtype(np.int8), 1),
    np.dtype(np.uint8): KeyCodec(np.dtype(np.uint8), 1),
    np.dtype(np.int16): KeyCodec(np.dtype(np.int16), 1),
    np.dtype(np.uint16): KeyCodec(np.dtype(np.uint16), 1),
    np.dtype(np.int32): KeyCodec(np.dtype(np.int32), 1),
    np.dtype(np.uint32): KeyCodec(np.dtype(np.uint32), 1),
    np.dtype(np.int64): KeyCodec(np.dtype(np.int64), 2),
    np.dtype(np.uint64): KeyCodec(np.dtype(np.uint64), 2),
    np.dtype(np.float32): KeyCodec(np.dtype(np.float32), 1),
    np.dtype(np.float64): KeyCodec(np.dtype(np.float64), 2),
}


def numpy_dtype(dtype: object) -> np.dtype:
    """``np.dtype`` of a numpy dtype, a dtype name or a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def codec_for(dtype: object) -> KeyCodec:
    dt = numpy_dtype(dtype)
    if dt not in _CODECS:
        raise TypeError(
            f"unsupported key dtype {dt}; supported: {sorted(str(k) for k in _CODECS)}"
        )
    return _CODECS[dt]
