"""Port verifier against the reference verifier: the ``Fingerprint`` of
the same words is equal field by field, and a truncated, duplicated,
corrupted or swapped result fails the same component
(``(sorted_ok, fp_ok)``) in both, in the contiguous layout (pads past
``n_valid`` included) and the ragged one, for every dtype of one and two
words.  The damage includes pairs across the seams of the card kernel's
vectors, warps and blocks (4095/4096) and the last pair.  The verifier's
one-pass scan (``ops/fold.py``) runs its plain version here; its row is
held to the reference's ``fingerprint_host`` and order check directly."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpitest_tpu.models import api as ref_api
from mpitest_tpu.models import verify as ref_verify
from mpitest_tpu.ops import keys as ref_keys
from mpitest_tpu_torch.models import api, verify
from mpitest_tpu_torch.ops import fold, keys

DTYPES = [np.int32, np.uint32, np.float32, np.int64, np.uint64, np.float64]


def _input(dtype, n=3001, seed=5):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.standard_normal(n).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_fingerprint_host_matches_reference(dtype):
    words = ref_keys.codec_for(dtype).encode(_input(dtype))
    got = verify.fingerprint_host(words)
    want = ref_verify.fingerprint_host(words)
    assert got == verify.Fingerprint.from_reference(want)
    assert got == verify.Fingerprint.from_reference(
        {"count": want.count, "xors": want.xors, "sums": want.sums})


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_fingerprint_device_input_matches_reference(dtype):
    x = _input(dtype)
    got = verify.fingerprint_device_input(torch.from_numpy(x), dtype)
    want = ref_verify.fingerprint_host(ref_keys.codec_for(dtype).encode(x))
    assert got == verify.Fingerprint.from_reference(want)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 1024, 1025])
def test_xor_fold_any_length(n):
    rng = np.random.default_rng(n)
    w = rng.integers(0, 2**32, n, dtype=np.uint32)
    want = int(np.bitwise_xor.reduce(w)) if n else 0
    got = fold.xor_fold_plain(keys.to_device_words(w, "cpu"))
    assert int(got) & 0xFFFFFFFF == want


def _ref_sorted(words) -> bool:
    """The reference's order check of whole host word planes."""
    res = ref_api.DistributedSortResult(tuple(jnp.asarray(w) for w in words),
                                        int(words[0].size), np.dtype(np.uint32))
    return ref_verify.verify_result(res, None)[0] if words[0].size else True


@pytest.mark.parametrize("layout", ["whole", "prefix", "fold_only", "sorted_only"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_scan_row_matches_reference(dtype, layout):
    """One scan's row: the fold of words ``[0, n_fold)`` equals the
    reference's ``fingerprint_host`` of them, the order flag its check of
    words ``[0, n_sorted)``, the ends the words at 0 and ``i_last``."""
    codec = ref_keys.codec_for(dtype)
    x = _input(dtype, n=5003)
    x[:4100] = np.sort(x[:4100])          # sorted head, unsorted tail
    words = codec.encode(x)
    n = x.size
    n_sorted, n_fold = {"whole": (n, n), "prefix": (4100, 1234),
                        "fold_only": (0, 4097), "sorted_only": (4100, 0)}[layout]
    i_last = max(n_sorted, n_fold) - 1
    dev = tuple(keys.to_device_words(w, "cpu") for w in words)
    row = torch.zeros(fold.row_width(len(words)), dtype=torch.int64)
    fold.scan(dev, n_sorted, n_fold, i_last, row)
    got = [int(v) & 0xFFFFFFFF for v in row.tolist()]
    k = len(words)
    want_fp = ref_verify.fingerprint_host(tuple(w[:n_fold] for w in words))
    assert verify.Fingerprint(n_fold, tuple(got[:k]), tuple(got[k:2 * k])) == \
        verify.Fingerprint.from_reference(want_fp)
    assert bool(got[2 * k]) == (not _ref_sorted(tuple(w[:n_sorted] for w in words)))
    assert bool(got[2 * k]) == (layout in ("whole", "fold_only") and n_sorted > 4100)
    assert got[2 * k + 1:3 * k + 1] == [int(w[0]) for w in words]
    assert got[3 * k + 1:] == [int(w[i_last]) for w in words]


#: Damage at the card kernel's seams: 4095/4096 straddles a 16-byte
#: vector, a warp's 128 words and a block's 1024; the last pair is the
#: scan's last.
SEAM_KINDS = ["swapped_4095_4096", "swapped_last_pair", "corrupted_4096"]


def _damage(words, kind):
    """Apply one failure class to sorted host words; returns (words, n)."""
    words = [w.copy() for w in words]
    n = words[0].size
    if kind == "truncated":
        return [w[:-1] for w in words], n - 1
    if kind == "duplicated":
        for w in words:
            w[n // 2] = w[n // 2 - 1]
    elif kind == "corrupted":
        words[-1][n // 3] ^= np.uint32(0x00010000)
    elif kind == "swapped":
        for w in words:
            w[[10, n - 10]] = w[[n - 10, 10]]
    elif kind == "swapped_4095_4096":
        for w in words:
            w[[4095, 4096]] = w[[4096, 4095]]
    elif kind == "swapped_last_pair":
        for w in words:
            w[[n - 2, n - 1]] = w[[n - 1, n - 2]]
    elif kind == "corrupted_4096":
        words[-1][4096] ^= np.uint32(0x00010000)
    return words, n


@pytest.mark.parametrize("kind", ["clean", "truncated", "duplicated",
                                  "corrupted", "swapped"] + SEAM_KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_verify_result_fails_same_component(dtype, kind):
    x = _input(dtype, n=3001 if kind not in SEAM_KINDS else 3 * 4096 + 5)
    codec = ref_keys.codec_for(dtype)
    fp_in = ref_verify.fingerprint_host(codec.encode(x))
    sorted_words = codec.encode(np.sort(x))
    words, n_valid = _damage(sorted_words, kind)

    ref_res = ref_api.DistributedSortResult(
        tuple(jnp.asarray(w) for w in words), n_valid, np.dtype(dtype))
    want = ref_verify.verify_result(ref_res, fp_in)
    res = api.DistributedSortResult(
        tuple(keys.to_device_words(w, "cpu") for w in words), n_valid,
        np.dtype(dtype))
    got = verify.verify_result(res, verify.Fingerprint.from_reference(fp_in))
    assert got == want
    assert got == (True, True) if kind == "clean" else got != (True, True)
    assert verify.verify_result(res, None)[1] is True


def _ragged(dtype, kind, P=3, slots=2048):
    """A ragged (sample-sort) layout of sorted keys: shard r holds
    ``counts[r]`` valid keys at the head of its ``slots``, the all-ones
    word after them; then one damage.  Returns (shards, counts, n_valid,
    input fingerprint)."""
    counts = np.array([1500, 0, 1700][:P], np.int64)
    n = int(counts.sum())
    x = _input(dtype, n=n, seed=P)
    codec = ref_keys.codec_for(dtype)
    fp_in = ref_verify.fingerprint_host(codec.encode(x))
    words = codec.encode(np.sort(x))
    shards, at = [], 0
    for c in counts:
        shard = [np.full(slots, 0xFFFFFFFF, np.uint32) for _ in words]
        for s, w in zip(shard, words):
            s[:c] = w[at:at + c]
        shards.append(shard)
        at += c
    if kind == "seam":                      # shard 2 starts below shard 0's end
        for s0, s2 in zip(shards[0], shards[2]):
            s0[1499], s2[0] = s2[0], s0[1499]
    elif kind == "fill_lowered":            # a fill word past a count
        shards[0][-1][1600] = 0
    elif kind == "corrupted_valid":
        shards[2][-1][1024] ^= np.uint32(0x00010000)
    elif kind == "short_n_valid":           # the last valid key left unfolded
        n -= 1
    return shards, counts, n, fp_in


@pytest.mark.parametrize("kind", ["clean", "seam", "fill_lowered",
                                  "corrupted_valid", "short_n_valid"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_ragged_verify_matches_reference(dtype, kind):
    """The ragged layout: each whole shard ordered (fill words included),
    the seams between nonempty shards, the valid keys folded up to
    ``n_valid``: the same verdict and output fingerprint as the
    reference's."""
    shards, counts, n_valid, fp_in = _ragged(dtype, kind)
    slots = shards[0][0].size
    ref_res = ref_api.DistributedSortResult(
        tuple(jnp.asarray(np.concatenate(ws)) for ws in zip(*shards)),
        n_valid, np.dtype(dtype), counts=counts, shard_slots=slots)
    want = ref_verify.verify_result(ref_res, fp_in)
    res = api.DistributedSortResult(
        (), n_valid, np.dtype(dtype), counts=counts, shard_slots=slots,
        shards=tuple(tuple(keys.to_device_words(w, "cpu") for w in s)
                     for s in shards))
    got = verify.verify_result(res, verify.Fingerprint.from_reference(fp_in))
    assert got == want
    assert got == (True, True) if kind == "clean" else got != (True, True)
    assert verify.result_sorted(res) == got[0]


def test_verify_ignores_pads_past_n_valid():
    x = _input(np.uint32, n=1000)
    words = keys.codec_for(np.uint32).encode(np.sort(x))
    padded = np.concatenate([words[0], np.full(24, 0xFFFFFFFF, np.uint32)])
    res = api.DistributedSortResult((keys.to_device_words(padded, "cpu"),),
                                    1000, np.dtype(np.uint32))
    assert verify.verify_result(res, verify.fingerprint_host(words)) == (True, True)
