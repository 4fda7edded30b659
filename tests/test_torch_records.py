"""The record sort, the segmented batch and the ``lax`` form of any width,
against the reference on the CPU.

* ``mpitest_tpu_torch.sort(x, payload=p, device="cpu")`` against
  ``mpitest_tpu.sort(x, payload=p)``: keys and payload byte-equal, and
  equal to the stable argsort-gather oracle (``np.lexsort`` over the
  encoded words), for all 10 dtypes, payload widths 0-10 and n around the
  1024-lane bucket, with duplicates and keys whose words are all ones
  (they tie with the pad lanes); the typed error after two failed
  verifications.
* ``models/segmented.py``: ``pack_segments``, ``run_packed``,
  ``split_segments`` and ``verify_segments`` against the reference on
  one-word and two-word dtypes, with a planted bad segment.
* ``ops/kernels.local_sort`` with the ``lax`` engine on 1-4 words against
  the reference's ``lax.sort(num_keys=k)``.

Inputs come from a seeded numpy generator; tolerance: exact bytes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mpitest_tpu_torch as mt
from mpitest_tpu.models import api as ref_api
from mpitest_tpu.models import records as ref_records
from mpitest_tpu.models import segmented as ref_seg
from mpitest_tpu.ops import kernels as ref_kernels
from mpitest_tpu_torch.models import records, segmented
from mpitest_tpu_torch.models.supervisor import SortIntegrityError
from mpitest_tpu_torch.models.verify import Fingerprint
from mpitest_tpu_torch.ops import kernels
from mpitest_tpu_torch.ops.keys import codec_for, to_host_words
from mpitest_tpu_torch.utils.trace import Tracer

DTYPES = ("int8", "uint8", "int16", "uint16", "int32", "uint32", "int64",
          "uint64", "float32", "float64")
WIDTHS = (0, 1, 3, 4, 8, 10)
SIZES = (0, 1, 1000, 1024, 1025)


def _keys(rng, dtype, n):
    """Seeded keys with duplicates and keys whose words are all ones (the
    pad lanes' key)."""
    dt = np.dtype(dtype)
    codec = codec_for(dt)
    if dt.kind == "f":
        x = (rng.standard_normal(n) * 10.0 ** rng.integers(-5, 5, n)).astype(dt)
    else:
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    if n >= 8:
        ones = codec.decode(tuple(np.full(1, 0xFFFFFFFF, np.uint32)
                                  for _ in range(codec.n_words)))[0]
        x[rng.integers(0, n, max(2, n // 50))] = ones
        x[n // 4: n // 4 + n // 10] = x[0]
    return x


def _stable_gather(x, pay):
    words = codec_for(x.dtype).encode(x)
    order = np.lexsort(tuple(reversed(words)))
    return x[order], pay[order]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_record_sort_equals_reference(dtype, width, n):
    rng = np.random.default_rng(DTYPES.index(dtype) * 100 + WIDTHS.index(width) * 10
                                + SIZES.index(n))
    x = _keys(rng, dtype, n)
    pay = rng.integers(0, 256, (n, width), dtype=np.uint8)
    tr = Tracer()
    got_k, got_p = mt.sort(x, payload=pay, device="cpu", tracer=tr)
    want_k, want_p = ref_api.sort(x, payload=pay)
    assert got_k.dtype == want_k.dtype and got_k.tobytes() == want_k.tobytes()
    assert got_p.shape == want_p.shape == (n, width)
    assert got_p.tobytes() == want_p.tobytes()
    ok, op = _stable_gather(x, pay)
    assert got_k.tobytes() == ok.tobytes() and got_p.tobytes() == op.tobytes()
    assert tr.counters.get("verify_runs", 0) == (1 if n else 0)
    sort_spans = [s for s in tr.spans.spans if s.name == "sort"]
    assert sort_spans and sort_spans[0].attrs["algorithm"] == "records"


@pytest.mark.parametrize("form", ["bytes", "uint64", "matrix"])
def test_payload_forms_equal_reference(form):
    """A payload given as raw bytes, a uint64 row-id array or a matrix."""
    rng = np.random.default_rng(11)
    x = _keys(rng, "int32", 3000)
    ids = np.arange(3000, dtype=np.uint64)
    pay = {"bytes": ids.tobytes(), "uint64": ids,
           "matrix": ids.view(np.uint8).reshape(3000, 8)}[form]
    got = records.sort_records(x, pay, device="cpu")
    want = ref_records.sort_records(x, pay)
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1].tobytes() == want[1].tobytes()
    order = np.argsort(x, kind="stable")
    assert np.array_equal(got[1].view(np.uint64).reshape(-1), order.astype(np.uint64))


def test_record_sort_of_a_tensor_and_on_a_cpu_mesh():
    from mpitest_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(12)
    x = _keys(rng, "int64", 2000)
    pay = rng.integers(0, 256, (2000, 5), dtype=np.uint8)
    want = ref_api.sort(x, payload=pay)
    got_t = mt.sort(torch.from_numpy(x), payload=pay, device="cpu")
    got_m = mt.sort(x, payload=pay, mesh=make_mesh(2, devices=["cpu"] * 2))
    for got in (got_t, got_m):
        assert got[0].tobytes() == want[0].tobytes()
        assert got[1].tobytes() == want[1].tobytes()


def _corrupt_payload(real):
    def bad(*a, **k):
        kw, pw = real(*a, **k)
        pw = tuple(w.copy() for w in pw)
        pw[0][[0, 1]] = pw[0][[1, 0]] ^ np.uint32(1)
        return kw, pw
    return bad


def test_two_failed_verifications_raise_typed(monkeypatch):
    """A dispatch whose payload comes back corrupted fails verification;
    the retry fails too, and both packages raise their typed error."""
    rng = np.random.default_rng(13)
    x = np.arange(2000, dtype=np.int32)
    pay = rng.integers(0, 256, (2000, 4), dtype=np.uint8)
    monkeypatch.setattr(records, "_dispatch", _corrupt_payload(records._dispatch))
    monkeypatch.setattr(ref_records, "_dispatch",
                        _corrupt_payload(ref_records._dispatch))
    tr = Tracer()
    with pytest.raises(SortIntegrityError, match="twice"):
        records.sort_records(x, pay, tracer=tr, device="cpu")
    with pytest.raises(ref_api.SortIntegrityError, match="twice"):
        ref_records.sort_records(x, pay)
    assert tr.counters["verify_runs"] == tr.counters["verify_failures"] == 2
    events = [s for s in tr.spans.spans if s.name == "verify"]
    assert [e.attrs["fp_ok"] for e in events] == [False, False]


def test_one_failed_verification_retries(monkeypatch):
    rng = np.random.default_rng(14)
    x = rng.integers(0, 100, 1500).astype(np.int32)
    pay = rng.integers(0, 256, (1500, 4), dtype=np.uint8)
    real = records._dispatch
    calls = {"n": 0}

    def once_bad(*a, **k):
        calls["n"] += 1
        return (_corrupt_payload(real) if calls["n"] == 1 else real)(*a, **k)

    monkeypatch.setattr(records, "_dispatch", once_bad)
    tr = Tracer()
    got = records.sort_records(x, pay, tracer=tr, device="cpu")
    ok, op = _stable_gather(x, pay)
    assert got[0].tobytes() == ok.tobytes() and got[1].tobytes() == op.tobytes()
    assert (tr.counters["verify_runs"], tr.counters["verify_failures"]) == (2, 1)


def test_verify_off_runs_once(monkeypatch):
    monkeypatch.setenv("SORT_VERIFY", "0")
    rng = np.random.default_rng(15)
    x = rng.integers(0, 100, 1500).astype(np.int32)
    pay = rng.integers(0, 256, (1500, 2), dtype=np.uint8)
    tr = Tracer()
    got = records.sort_records(x, pay, tracer=tr, device="cpu")
    assert "verify_runs" not in tr.counters
    assert got[1].tobytes() == _stable_gather(x, pay)[1].tobytes()


def test_record_sort_errors_match_reference():
    x = np.arange(10, dtype=np.int32)
    for pay, match in ((b"12345", "multiple"), (np.arange(5), "one element per record")):
        with pytest.raises(ValueError, match=match):
            records.sort_records(x, pay, device="cpu")
        with pytest.raises(ValueError, match=match):
            ref_records.sort_records(x, pay)
    assert records.MAX_RECORDS == ref_records.MAX_RECORDS


def test_record_sort_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.arange(10, dtype=np.int32)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mt.sort(x, payload=np.zeros(10, np.uint64))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        segmented.run_packed(segmented.pack_segments([x], np.int32))


@pytest.mark.parametrize("n_key_words", [1, 2])
def test_record_program_returns_the_permutation(n_key_words):
    """The program's third output is the sorting permutation."""
    rng = np.random.default_rng(16)
    words = tuple(torch.from_numpy(rng.integers(0, 8, 1024).astype(np.int32))
                  for _ in range(n_key_words))
    pay = (torch.arange(1024, dtype=torch.int32),)
    keys, gathered, perm = records._compile_record_sort(n_key_words, 1, 1024)(
        *words, *pay)
    order = np.lexsort(tuple(w.numpy() for w in reversed(words)))
    assert np.array_equal(perm.numpy(), order)
    assert np.array_equal(gathered[0].numpy(), order)
    assert records._compile_record_sort(n_key_words, 1, 1024) is \
        records._compile_record_sort(n_key_words, 1, 1024)


# ------------------------------------------------------------- segmented


def _requests(rng, dtype, sizes):
    return [_keys(rng, dtype, s) for s in sizes]


SEG_DTYPES = ("int32", "float32", "uint16", "int64", "uint64", "float64")


@pytest.mark.parametrize("dtype", SEG_DTYPES)
def test_packed_batch_equals_reference(dtype):
    rng = np.random.default_rng(17)
    sizes = (0, 1, 700, 33, 1500, 8, 0, 200)
    arrays = _requests(rng, dtype, sizes)
    batch = segmented.pack_segments(arrays, np.dtype(dtype))
    ref = ref_seg.pack_segments(arrays, np.dtype(dtype))
    assert batch.bucket == ref.bucket == 4096
    assert (batch.sizes, batch.offsets) == (ref.sizes, ref.offsets)
    assert batch.n_valid == ref.n_valid and batch.n_segments == ref.n_segments
    for a, b in zip(batch.words, ref.words):
        assert a.tobytes() == b.tobytes()
    assert list(batch.fps) == [Fingerprint.from_reference(f) for f in ref.fps]
    got = segmented.run_packed(batch, device="cpu")
    want = ref_seg.run_packed(ref)
    for a, b in zip(got, want):
        assert a.tobytes() == np.asarray(b).tobytes()
    parts = segmented.split_segments(batch, got)
    ref_parts = ref_seg.split_segments(ref, want)
    for a, req, b in zip(parts, arrays, ref_parts):
        assert a.tobytes() == b.tobytes()
        assert a.tobytes() == ref_api.sort(req).tobytes()
    assert segmented.verify_segments(batch, got) == ref_seg.verify_segments(ref, want)
    assert all(segmented.verify_segments(batch, got))


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_a_planted_bad_segment_flags_only_itself(dtype):
    rng = np.random.default_rng(18)
    arrays = _requests(rng, dtype, (300, 400, 500, 100))
    batch = segmented.pack_segments(arrays, np.dtype(dtype))
    ref = ref_seg.pack_segments(arrays, np.dtype(dtype))
    got = [w.copy() for w in segmented.run_packed(batch, device="cpu")]
    got[-1][batch.offsets[2] + 7] ^= np.uint32(1 << 9)   # segment 2's key bits
    want = [np.asarray(w).copy() for w in ref_seg.run_packed(ref)]
    want[-1][ref.offsets[2] + 7] ^= np.uint32(1 << 9)
    verdicts = segmented.verify_segments(batch, tuple(got))
    assert verdicts == [True, True, False, True]
    assert verdicts == ref_seg.verify_segments(ref, tuple(want))


def test_bucket_and_cache_follow_reference():
    for n in (0, 1, 2, 1023, 1024, 1025, 4096, 5000, 1 << 16):
        assert segmented.bucket_for(n) == ref_seg.bucket_for(n), n
        assert segmented.bucket_for(n, 1) == ref_seg.bucket_for(n, 1), n
    with pytest.raises(ValueError, match="negative"):
        segmented.bucket_for(-1)
    assert (segmented.PAD_SEG, segmented.MIN_BUCKET) == (ref_seg.PAD_SEG,
                                                          ref_seg.MIN_BUCKET)
    fn = segmented.compile_packed_sort(3, 2048)
    assert segmented.compile_packed_sort(3, 2048) is fn
    assert segmented.compile_packed_sort.cache_info().maxsize == 64
    assert segmented.executable_stats(fn) == {}
    with pytest.raises(ValueError, match="bucket"):
        segmented.pack_segments([np.arange(2000, dtype=np.int32)], np.int32, bucket=1024)
    with pytest.raises(ValueError, match="called with"):
        fn(*(np.zeros(1024, np.uint32),) * 3, device="cpu")


def test_packed_sort_takes_device_words():
    """Device words (int32 carriers) sort as host words do."""
    rng = np.random.default_rng(19)
    batch = segmented.pack_segments(_requests(rng, "int64", (100, 900)), np.int64)
    fn = segmented.compile_packed_sort(len(batch.words), batch.bucket)
    dev = tuple(torch.from_numpy(w.view(np.int32)) for w in batch.words)
    out = tuple(to_host_words(w) for w in fn(*dev, device="cpu"))
    want = segmented.run_packed(batch, device="cpu")
    assert all(a.tobytes() == b.tobytes() for a, b in zip(out, want))


# ------------------------------------------- F2: the lax form of any width


def _word_cases():
    rng = np.random.default_rng(20)
    n = 3000
    special = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0, 1], np.uint32)
    for k in (1, 2, 3, 4):
        words = [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
                 for _ in range(k)]
        yield f"random-{k}", words
        eq = [np.full(n, 0x80000000, np.uint32) for _ in range(k - 1)]
        eq.append(rng.choice(special, n))
        yield f"equal-high-{k}", eq
        yield f"special-{k}", [rng.choice(special, n) for _ in range(k)]


@pytest.mark.parametrize("name,words", list(_word_cases()),
                         ids=[c[0] for c in _word_cases()])
def test_lax_local_sort_of_any_width_equals_reference(name, words):
    got = kernels.local_sort(tuple(torch.from_numpy(w.view(np.int32)) for w in words),
                             engine="lax")
    want = ref_kernels.local_sort(tuple(words))
    assert len(got) == len(want) == len(words)
    for a, b in zip(got, want):
        assert to_host_words(a).tobytes() == np.asarray(b).tobytes()
    if len(words) > 2:   # bitonic keeps the lax form past two words
        again = kernels.local_sort(tuple(torch.from_numpy(w.view(np.int32))
                                         for w in words), engine="bitonic")
        assert all(to_host_words(a).tobytes() == to_host_words(b).tobytes()
                   for a, b in zip(again, got))


@pytest.mark.cuda
def test_record_sort_and_packed_batch_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    rng = np.random.default_rng(21)
    x = _keys(rng, "int64", 1 << 16)
    pay = rng.integers(0, 256, (1 << 16, 10), dtype=np.uint8)
    got = mt.sort(x, payload=pay)
    want = mt.sort(x, payload=pay, device="cpu")
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1].tobytes() == want[1].tobytes()
    batch = segmented.pack_segments(_requests(rng, "float32", (5000, 9000, 1)),
                                    np.float32)
    on_card = segmented.run_packed(batch)
    on_cpu = segmented.run_packed(batch, device="cpu")
    assert all(a.tobytes() == b.tobytes() for a, b in zip(on_card, on_cpu))
    assert all(segmented.verify_segments(batch, on_card))
