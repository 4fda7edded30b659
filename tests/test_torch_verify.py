"""Port verifier against the reference verifier: the ``Fingerprint`` of
the same words is equal field by field, and a truncated, duplicated,
corrupted or swapped result fails the same component
(``(sorted_ok, fp_ok)``) in both."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpitest_tpu.models import api as ref_api
from mpitest_tpu.models import verify as ref_verify
from mpitest_tpu.ops import keys as ref_keys
from mpitest_tpu_torch.models import api, verify
from mpitest_tpu_torch.ops import keys

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
    assert verify._xor_reduce(keys.to_device_words(w, "cpu")) == want


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
    return words, n


@pytest.mark.parametrize("kind", ["clean", "truncated", "duplicated",
                                  "corrupted", "swapped"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=["int32", "int64"])
def test_verify_result_fails_same_component(dtype, kind):
    x = _input(dtype)
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


def test_verify_ignores_pads_past_n_valid():
    x = _input(np.uint32, n=1000)
    words = keys.codec_for(np.uint32).encode(np.sort(x))
    padded = np.concatenate([words[0], np.full(24, 0xFFFFFFFF, np.uint32)])
    res = api.DistributedSortResult((keys.to_device_words(padded, "cpu"),),
                                    1000, np.dtype(np.uint32))
    assert verify.verify_result(res, verify.fingerprint_host(words)) == (True, True)
