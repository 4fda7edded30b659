"""Record sorts: key+payload sorting with the payload permuted on the
device (port of ``mpitest_tpu/models/records.py``).

A record is a key plus an opaque ``width``-byte payload.  The payload
packs into little-endian uint32 columns, zero-padded to a word multiple
(:func:`payload_to_words`); the external sort's spill runs carry the same
columns.

:func:`sort_records` is an argsort-gather, the reference's ``lax.sort``
program, which in the port is ``torch.sort`` plus a gather (no
hand-written kernel runs here):

1. the keys encode through the order-preserving codec (``ops/keys.py``)
   and a lane index joins them as the least significant sort word, so
   one lexicographic sort of ``(*key_words, idx)`` yields the sorted keys
   and the permutation that sorted them; the index tiebreak makes the
   sort stable, byte-equal to a host ``np.argsort(kind="stable")``
   gather at any duplication;
2. every payload word is gathered by that permutation on the device
   (``index_select`` on int32 carriers).

One-word keys fuse ``(key << 32) | idx`` into one int64 sort key, with
the key's sign bit flipped so that signed order is the unsigned one
(the reference's uint64 key); two-word keys sort their ordered int64 key
with a stable ``torch.sort``, whose ``indices`` are the permutation (the
index tiebreak is what stability gives).  Inputs pad to the power-of-two
shape bucket of ``models/segmented.bucket_for``.

Verification is always on with ``SORT_VERIFY`` and runs on the host: the
output must be lexicographically sorted and reproduce the record
fingerprint (``models/verify.fingerprint_records``: every key and payload
word plus a per-record binding word).  A failure re-dispatches once and
then raises :class:`SortIntegrityError`.  The sort runs on the card
unless the caller passes ``device="cpu"`` or a mesh of CPU ranks.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Callable

import numpy as np
import torch

from mpitest_tpu_torch.models import verify as vfy
from mpitest_tpu_torch.models.ingest import checked_device_put
from mpitest_tpu_torch.models.segmented import bucket_for, lex_sorted_host
from mpitest_tpu_torch.models.supervisor import SortIntegrityError, verify_enabled
from mpitest_tpu_torch.ops import kernels
from mpitest_tpu_torch.ops.keys import (
    SIGN_BIT,
    KeyCodec,
    codec_for,
    to_host_words,
    unsigned_order,
)

#: Hard bound on records per sort: the lane index takes the low 32 bits
#: of the fused one-word key.
MAX_RECORDS = 1 << 31

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


Words = tuple[torch.Tensor, ...]


@lru_cache(maxsize=32)
def _compile_record_sort(n_key_words: int, n_payload_words: int,
                         n: int) -> Callable[..., tuple[Words, Words, torch.Tensor]]:
    """The record program for one shape: sort ``(*key_words, idx)``
    lexicographically, then gather every payload word by the sorted index.
    ``n`` is a shape bucket (callers pad, see :func:`_dispatch`).  The
    callable takes device words (int32 carriers) and returns ``(sorted key
    words, gathered payload words, perm)``."""
    n_words = n_key_words + n_payload_words

    def gather(perm: torch.Tensor, payload: Words) -> Words:
        return tuple(torch.index_select(w, 0, perm) for w in payload)

    def f(*arrs: torch.Tensor) -> tuple[Words, Words, torch.Tensor]:
        if len(arrs) != n_words or any(a.numel() != n for a in arrs):
            raise ValueError(f"record program of {n_words} words x {n} lanes "
                             f"called with {[tuple(a.shape) for a in arrs]}")
        kw, payload = arrs[:n_key_words], arrs[n_key_words:]
        if n_key_words == 1:
            idx = torch.arange(n, dtype=torch.int64, device=kw[0].device)
            u = (unsigned_order(kw[0]).to(torch.int64) << 32) | idx
            s = torch.sort(u).values
            perm = s & 0xFFFFFFFF
            keys = ((s >> 32).to(torch.int32) ^ SIGN_BIT,)
        else:
            perm = torch.sort(kernels._ordered_key(kw), stable=True).indices
            keys = tuple(torch.index_select(w, 0, perm) for w in kw)
        return keys, gather(perm, payload), perm.to(torch.int32)

    return f


def _dispatch(codec: KeyCodec, key_words: tuple[np.ndarray, ...],
              payload_words: tuple[np.ndarray, ...], n: int,
              device: torch.device) -> tuple[tuple[np.ndarray, ...],
                                             tuple[np.ndarray, ...]]:
    """One record dispatch: pad to the shape bucket, copy to ``device``
    (through the dtype guard ``checked_device_put``), run the record
    program, fetch and slice the sorted words on the host.

    Pad lanes carry all-ones key words (the lexicographic maximum) and
    lane indices >= n, so they sort after every real record (a real
    all-ones key wins its tie by index) and the first ``n`` output lanes
    are the sorted real records."""
    bucket = bucket_for(n)
    if bucket > n:
        pad = bucket - n
        key_words = tuple(np.concatenate([w, np.full(pad, 0xFFFFFFFF, np.uint32)])
                          for w in key_words)
        payload_words = tuple(np.concatenate([w, np.zeros(pad, np.uint32)])
                              for w in payload_words)
    fn = _compile_record_sort(codec.n_words, len(payload_words), bucket)
    dev_args = tuple(checked_device_put(w, device) for w in key_words + payload_words)
    out_kw, out_pw, _perm = fn(*dev_args)
    return (tuple(to_host_words(w[:n]) for w in out_kw),
            tuple(to_host_words(w[:n]) for w in out_pw))


def sort_records(keys: np.ndarray, payload: Any, mesh: Any = None,
                 tracer: Any = None, *,
                 device: torch.device | str | None = None,
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Sort ``keys`` with their per-record ``payload`` permuted along
    (stable by key).  Returns ``(sorted_keys, sorted_payload)``, the
    payload as a ``(n, width)`` uint8 matrix.  Runs on the first rank of
    ``mesh``, else on ``device``, else on the card.

    Verified whenever ``SORT_VERIFY`` is on: sorted, and the record
    fingerprint (key + payload + binding word) equal to the input's; one
    retry, then :class:`SortIntegrityError`."""
    from mpitest_tpu_torch.models.api import resolve_device

    keys = np.asarray(keys).reshape(-1)
    n = int(keys.size)
    if n >= MAX_RECORDS:
        raise ValueError(f"record sort supports < 2^31 records, got {n}")
    dtype = np.dtype(keys.dtype)
    codec = codec_for(dtype)
    pay = as_payload_matrix(payload, n)
    width = int(pay.shape[1])
    if mesh is not None and device is not None:
        raise ValueError("pass either device or mesh, not both")
    dev = resolve_device(None, mesh.devices[0] if mesh is not None else device)
    if n == 0:
        return np.empty(0, dtype), pay.reshape(0, width)

    verify_on = verify_enabled()
    key_words = codec.encode(keys)
    payload_words = payload_to_words(pay)
    fp_in = (vfy.fingerprint_records(key_words, payload_words)
             if verify_on else None)

    spans = tracer.spans if tracer is not None else None
    for attempt in range(2 if verify_on else 1):
        out_kw, out_pw = _dispatch(codec, key_words, payload_words, n, dev)
        if not verify_on:
            break
        sorted_ok = lex_sorted_host(out_kw)
        fp_ok = vfy.fingerprint_records(out_kw, out_pw) == fp_in
        ok = sorted_ok and fp_ok
        if spans is not None:
            spans.event("verify", ok=bool(ok), sorted_ok=bool(sorted_ok),
                        fp_ok=bool(fp_ok), n=n)
        if tracer is not None:
            tracer.count("verify_runs", 1)
        if ok:
            break
        if tracer is not None:
            tracer.count("verify_failures", 1)
        if attempt:
            raise SortIntegrityError(
                "record sort failed fingerprint verification twice "
                "(keys, payload, or their pairing corrupted)")
    return codec.decode(out_kw), words_to_payload(out_pw, n, width)
