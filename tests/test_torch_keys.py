"""Port codecs against the reference codecs: ``encode``, ``decode`` and
the device-side ``encode_torch`` give byte-identical words to
``mpitest_tpu.ops.keys`` for all 10 key dtypes, NaN, ±0, ±inf and the
integer extremes included.  Inputs are made with numpy from a seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpitest_tpu.ops import keys as ref_keys
from mpitest_tpu_torch.ops import keys

INT_DTYPES = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
              np.int64, np.uint64]
ALL_DTYPES = INT_DTYPES + [np.float32, np.float64]


def _keys(dtype, n=4096, seed=7):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = (rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n)).astype(dt)
        fi = np.finfo(dt)
        specials = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, fi.max,
                    fi.min, fi.tiny, -fi.tiny, fi.smallest_subnormal]
        x[: len(specials)] = np.array(specials, dt)
        # a NaN with a payload: the codec must keep its exact bits
        u = x.view(np.uint32 if dt.itemsize == 4 else np.uint64)
        u[len(specials)] = u[0] | 1
        return x
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    x[:4] = [info.min, info.max, 0, info.min + 1]
    return x


def _torch_tensor(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: np.dtype(d).name)
def test_encode_matches_reference(dtype):
    x = _keys(dtype)
    got = keys.codec_for(dtype).encode(x)
    want = ref_keys.codec_for(dtype).encode(x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, w)
    # the pad fill is the reference's and sorts after every real key
    sentinel = keys.codec_for(dtype).max_sentinel()
    assert sentinel == ref_keys.codec_for(dtype).max_sentinel()
    assert all(int(g.max()) <= s for g, s in zip(got, sentinel))


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: np.dtype(d).name)
def test_decode_matches_reference(dtype):
    x = _keys(dtype)
    words = ref_keys.codec_for(dtype).encode(x)
    got = keys.codec_for(dtype).decode(words)
    want = ref_keys.codec_for(dtype).decode(words)
    assert got.dtype == want.dtype == np.dtype(dtype)
    assert got.tobytes() == want.tobytes() == x.tobytes()


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: np.dtype(d).name)
def test_encode_torch_matches_reference(dtype):
    x = _keys(dtype)
    got = keys.codec_for(dtype).encode_torch(_torch_tensor(x))
    want = ref_keys.codec_for(dtype).encode(x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        np.testing.assert_array_equal(keys.to_host_words(g), w)


def test_encode_torch_rejects_other_dtype():
    with pytest.raises(TypeError):
        keys.codec_for(np.int64).encode_torch(torch.zeros(4, dtype=torch.int32))


def test_codec_for_unsupported_dtype():
    with pytest.raises(TypeError):
        keys.codec_for(np.complex64)
    assert keys.codec_for(torch.float64) is keys.codec_for(np.float64)


def test_word_roundtrip_and_unsigned_order():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    w[:3] = [0, 0x7FFFFFFF, 0xFFFFFFFF]
    t = keys.to_device_words(w, "cpu")
    np.testing.assert_array_equal(keys.to_host_words(t), w)
    order = torch.argsort(keys.unsigned_order(t), stable=True).numpy()
    np.testing.assert_array_equal(order, np.argsort(w, kind="stable"))
