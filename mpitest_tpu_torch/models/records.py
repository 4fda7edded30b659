"""Record payloads as uint32 word columns — the host helpers of the
reference's ``mpitest_tpu/models/records.py`` that the external sort's
spill runs use.

A record is a key plus an opaque ``width``-byte payload.  The payload
packs into little-endian uint32 columns, zero-padded to a word multiple,
so that the run fingerprint (``models/verify.fingerprint_records``) and
the merge carry it as words beside the key words.  The record sort itself
(``sort_records``) is not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np

#: Payload bytes pack into this many-byte words (uint32 columns).
_WORD_BYTES = 4


def payload_width_words(width: int) -> int:
    """uint32 words per record for a ``width``-byte payload."""
    return (int(width) + _WORD_BYTES - 1) // _WORD_BYTES


def as_payload_matrix(payload: Any, n: int) -> np.ndarray:
    """Canonicalize a payload argument to a ``(n, width)`` uint8 matrix.

    Accepts ``bytes`` / 1-D uint8 of ``n * width`` bytes (width inferred),
    a ``(n, width)`` uint8 matrix, or any fixed-itemsize array of ``n``
    elements (viewed as its raw little-endian bytes)."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        payload = np.frombuffer(bytes(payload), np.uint8)
    arr = np.asarray(payload)
    if arr.dtype != np.uint8:
        if arr.ndim != 1 or arr.shape[0] != n:
            raise ValueError(
                f"payload array must be 1-D with one element per record "
                f"(got shape {arr.shape} for {n} records)")
        arr = np.ascontiguousarray(arr).view(np.uint8).reshape(n, -1)
    if arr.ndim == 1:
        if n == 0:
            return arr.reshape(0, 0)
        if arr.size % n:
            raise ValueError(
                f"payload of {arr.size} bytes is not a multiple of the "
                f"record count {n}")
        arr = arr.reshape(n, arr.size // n)
    if arr.ndim != 2 or arr.shape[0] != n:
        raise ValueError(
            f"payload must be (n, width) bytes; got shape {arr.shape} "
            f"for {n} records")
    return np.ascontiguousarray(arr)


def payload_to_words(payload: np.ndarray) -> tuple[np.ndarray, ...]:
    """``(n, width)`` uint8 payload -> per-record uint32 word columns
    (little-endian, zero-padded to a word multiple); no columns for a
    zero-width payload."""
    n, width = payload.shape
    pw = payload_width_words(width)
    if pw == 0:
        return ()
    padded = payload
    if width % _WORD_BYTES:
        padded = np.zeros((n, pw * _WORD_BYTES), np.uint8)
        padded[:, :width] = payload
    cols = padded.reshape(n, pw, _WORD_BYTES).view(np.uint32)[..., 0]
    return tuple(np.ascontiguousarray(cols[:, j]) for j in range(pw))


def words_to_payload(words: tuple[np.ndarray, ...], n: int,
                     width: int) -> np.ndarray:
    """Inverse of :func:`payload_to_words`: word columns -> ``(n, width)``
    uint8 payload (the zero pad dropped)."""
    pw = payload_width_words(width)
    if pw == 0:
        return np.zeros((n, 0), np.uint8)
    mat = np.empty((n, pw), np.uint32)
    for j, w in enumerate(words):
        mat[:, j] = w
    return mat.view(np.uint8).reshape(n, pw * _WORD_BYTES)[:, :width].copy()
