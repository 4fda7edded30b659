"""The streamed ingest and egress (``mpitest_tpu_torch/models/ingest.py``)
and the staged and streamed routes of ``sort()``, against the reference
on the CPU.

* ``stream_to_mesh`` on 1, 2, 3 and 8 CPU ranks against the reference's
  on a mesh of as many of its virtual CPU devices: the shards' bytes,
  ``word_diffs``, the ``Fingerprint`` and ``IngestStats.chunks``, under
  both encode engines.
* ``sort(StagedIngest)`` and ``sort(x)`` under ``SORT_INGEST=stream``:
  bytes, the result ``Fingerprint``, the route counters and the span
  names against the reference's.
* The ``auto`` routing (a P-rank host input of ``STREAM_MIN_BYTES`` or
  more streams, one rank never does), streamed egress against the plain
  gather, donation (a consumed staged input raises; retries rebuild),
  ``encode_and_fold`` of both engines against the reference's, worker
  errors propagating, and the ingest knobs' errors.

Inputs come from a seeded numpy generator at 2^10-2^16 keys; tolerance:
exact bytes and an equal ``Fingerprint``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mpitest_tpu_torch as mt
from mpitest_tpu.models import api as ref_api
from mpitest_tpu.models import ingest as ref_ingest
from mpitest_tpu.models import verify as ref_vfy
from mpitest_tpu.parallel.mesh import make_mesh as ref_mesh
from mpitest_tpu.utils import native_encode as ref_native
from mpitest_tpu.utils.trace import Tracer as RefTracer
from mpitest_tpu_torch.models import api, ingest, verify
from mpitest_tpu_torch.ops import radix
from mpitest_tpu_torch.ops.keys import codec_for, to_host_words
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.utils import knobs, native_encode
from mpitest_tpu_torch.utils.trace import Tracer

COUNTERS = ("negotiated_cap", "worst_cap", "exchange_cap", "exchange_passes",
            "exchange_retries", "skew_restage", "digit_bits", "local_engine",
            "sample_skew_fallback", "exchange_bytes", "pair_dup_reroute",
            "pair_residual_fallback")
_ENGINES = {"pallas_interpret": "pallas", "bitonic_interpret": "bitonic",
            "radix_pallas_interpret": "radix_pallas"}
INGEST_SPANS = {"ingest.parse", "ingest.encode", "ingest.transfer",
                "ingest.pipeline"}


def _cpu_mesh(p):
    return make_mesh(p, devices=["cpu"] * p)


def _keys(rng, dtype, n):
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


@pytest.fixture(scope="module")
def native_built():
    if not native_encode.build():
        pytest.skip("no C compiler to build the native encode library")
    return True


@pytest.fixture(params=["off", "on"])
def encode_engine(request, monkeypatch):
    """Both encode engines; the reference's follows the same knob."""
    if request.param == "on":
        request.getfixturevalue("native_built")
        if not ref_native.available() and not ref_native.build():
            pytest.skip("the reference's native library does not build")
    monkeypatch.setenv("SORT_NATIVE_ENCODE", request.param)
    return request.param


@pytest.fixture(autouse=True)
def _fresh_engine(monkeypatch):
    monkeypatch.delenv("SORT_LOCAL_ENGINE", raising=False)
    monkeypatch.delenv("SORT_INGEST", raising=False)
    monkeypatch.delenv("SORT_DONATE", raising=False)


def _ref_result_fp(res) -> verify.Fingerprint:
    """The reference verifier's output-side fingerprint of its result."""
    n_words = len(res.words)
    if res.counts is None:
        total = int(res.words[0].shape[0])
        _, xors, sums = ref_vfy._compile_contig(
            n_words, min(res.n_valid, total), total, True)(*res.words)
        count = res.n_valid
    else:
        _, count, xors, sums = ref_vfy._compile_ragged(
            n_words, res.n_valid, res.shard_slots, len(res.counts))(
            np.asarray(res.counts, np.int32), *res.words)
    return verify.Fingerprint(int(count), tuple(int(v) for v in xors),
                              tuple(int(v) for v in sums))


def _same_counters(pc, rc):
    for c in COUNTERS:
        assert _ENGINES.get(pc.get(c), pc.get(c)) == _ENGINES.get(rc.get(c), rc.get(c)), c
    assert _ENGINES.get(rc["exchange_engine"], rc["exchange_engine"]) == \
        pc["exchange_engine"]


# ------------------------------------------------------------ stream_to_mesh


@pytest.mark.parametrize("P", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float64", "uint16"])
def test_stream_to_mesh_equals_reference(P, dtype, encode_engine):
    rng = np.random.default_rng(P * 10 + len(dtype))
    x = _keys(rng, dtype, 10_007)
    got = ingest.stream_to_mesh(x, _cpu_mesh(P), chunk_elems=1000)
    want = ref_ingest.stream_to_mesh(x, ref_mesh(P), chunk_elems=1000)
    assert got.n_valid == want.n_valid == x.size
    assert got.word_diffs == want.word_diffs
    assert got.fingerprint == verify.Fingerprint.from_reference(want.fingerprint)
    assert got.stats.chunks == want.stats.chunks == 11
    assert got.stats.encode_engine == want.stats.encode_engine
    assert got.stats.device_bytes == want.stats.device_bytes
    assert len(got.words) == P
    for k in range(codec_for(x.dtype).n_words):
        mine = np.concatenate([to_host_words(s[k]) for s in got.words])
        assert mine.tobytes() == np.asarray(want.words[k]).tobytes()
    # the one-shot path lands the same shards
    n = -(-x.size // P)
    words_np = codec_for(x.dtype).encode(x)
    pad = api._host_pad_words(codec_for(x.dtype), x, x.dtype, P * n)
    mono = api._shard_input(words_np, _cpu_mesh(P), n, pad)
    for a, b in zip(got.words, mono):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_pipeline_spans_and_stats():
    x = _keys(np.random.default_rng(2), "int32", 20_000)
    tr = Tracer()
    st = api.ingest_to_mesh(x, mesh=_cpu_mesh(2), tracer=tr, chunk_elems=3000)
    names = [s.name for s in tr.spans.spans]
    assert INGEST_SPANS <= set(names) and "ingest" in names
    assert names.count("ingest.parse") == names.count("ingest.encode") == 7
    assert names.count("ingest.transfer") == 7     # 20000 = 2 x 10000, no pad
    pipe = next(s for s in tr.spans.spans if s.name == "ingest.pipeline")
    assert pipe.attrs["chunks"] == st.stats.chunks == 7
    assert 0.0 <= pipe.attrs["overlap_efficiency"] <= 1.0
    assert st.stats.host_bytes == x.nbytes
    assert st.size == x.size and st.source is not None
    assert st.word_diffs == api._word_diffs(codec_for(x.dtype).encode(x))


def test_overlap_efficiency_equals_reference():
    host = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    xfer = [(0.8, 1.5), (1.8, 3.2), (5.0, 6.0)]
    got = ingest.IngestStats(host_iv=host, xfer_iv=xfer).overlap_efficiency()
    want = ref_ingest.IngestStats(host_iv=host, xfer_iv=xfer).overlap_efficiency()
    assert got == pytest.approx(want, abs=0.0) and 0 < got < 1
    assert ingest.IngestStats().overlap_efficiency() == 0.0


def test_constants_and_errors_equal_reference():
    assert ingest.STREAM_MIN_BYTES == ref_ingest.STREAM_MIN_BYTES
    assert ingest.EGRESS_MIN_BYTES == ref_ingest.EGRESS_MIN_BYTES
    with pytest.raises(ValueError, match="empty key array"):
        ingest.stream_to_mesh(np.empty(0, np.int32), _cpu_mesh(2))
    with pytest.raises(ValueError, match="empty key array"):
        ref_ingest.stream_to_mesh(np.empty(0, np.int32), ref_mesh(2))
    out = ingest.checked_device_put(np.arange(8, dtype=np.uint32) | np.uint32(1 << 31),
                                    "cpu")
    assert out.dtype == torch.int32 and to_host_words(out)[0] == 1 << 31
    for dt in (np.int64, np.uint64, np.float64, np.float32):
        assert ingest.checked_device_put(np.arange(8, dtype=dt), "cpu").numpy().dtype == dt


@pytest.mark.parametrize("mode,n,expect", [
    ("stream", 1, True), ("mono", 1 << 30, False),
    ("auto", (1 << 25) - 1, False), ("auto", 1 << 25, True)])
def test_use_stream_follows_reference(mode, n, expect, monkeypatch):
    monkeypatch.setenv("SORT_INGEST", mode)
    assert ingest.use_stream(n) == ref_ingest.use_stream(n) == expect


# ------------------------------------------------------------ sort(staged)


def _sort_both(x, P, algo, monkeypatch, staged=False, chunk=1000, local="lax",
               **kw):
    monkeypatch.setenv("SORT_LOCAL_ENGINE", local)
    monkeypatch.setenv("SORT_INGEST_CHUNK", str(chunk))
    pt, rt = Tracer(), RefTracer()
    if staged:
        src, ref_src = api.ingest_to_mesh(x, mesh=_cpu_mesh(P), tracer=pt), \
            ref_api.ingest_to_mesh(x, mesh=ref_mesh(P), tracer=rt)
        pm, rm = None, None
    else:
        src, ref_src, pm, rm = x, x, _cpu_mesh(P), ref_mesh(P)
    ref_kw = dict(kw)
    eng = kw.pop("exchange_engine", "pallas")
    ref_kw["exchange_engine"] = "pallas_interpret" if eng == "pallas" else "lax"
    if eng == "lax":
        ref_kw.setdefault("pack", "pallas_interpret")
    want = ref_api.sort(ref_src, algorithm=algo, mesh=rm, tracer=rt,
                        return_result=True, **ref_kw)
    kw_mesh = {"mesh": pm} if pm is not None else {}
    got = mt.sort(src, algorithm=algo, tracer=pt, return_result=True,
                  exchange_engine=eng, **kw_mesh, **kw)
    return got, want, pt, rt


def _check_sorted(got, want, pt, rt, x):
    g = got.to_numpy(tracer=pt)
    w = want.to_numpy(tracer=rt)
    assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert verify.result_fingerprint(got) == _ref_result_fp(want)
    _same_counters(pt.counters, rt.counters)
    assert pt.counters["verify_runs"] == 1


@pytest.mark.parametrize("P", [1, 2, 3, 8])
@pytest.mark.parametrize("algo", ["radix", "sample"])
def test_sort_staged_equals_reference(P, algo, monkeypatch):
    rng = np.random.default_rng(30 + P)
    x = _keys(rng, "int32", 12_345)
    got, want, pt, rt = _sort_both(x, P, algo, monkeypatch, staged=True)
    _check_sorted(got, want, pt, rt, x)
    names_p = {s.name for s in pt.spans.spans}
    names_r = {s.name for s in rt.spans.spans}
    assert INGEST_SPANS <= names_p and INGEST_SPANS <= names_r


@pytest.mark.parametrize("dtype", ["int64", "float64", "float32"])
@pytest.mark.parametrize("P", [1, 8])
def test_sort_staged_wide_and_float_keys(dtype, P, monkeypatch):
    rng = np.random.default_rng(40 + P)
    x = _keys(rng, dtype, 9_001)
    got, want, pt, rt = _sort_both(x, P, "radix", monkeypatch, staged=True)
    _check_sorted(got, want, pt, rt, x)


@pytest.mark.parametrize("dtype,n", [("int32", 3000), ("int64", 3001)])
def test_staged_one_rank_radix_pallas_compacts_from_word_diffs(dtype, n, monkeypatch):
    """One rank under radix_pallas: K4 with the plan compacted from the
    ingest's word_diffs, bytes equal to the reference's."""
    rng = np.random.default_rng(50)
    x = (rng.integers(0, 1 << 20, n).astype(dtype) if dtype == "int32"
         else _keys(rng, dtype, n))
    before = radix.pass_launches()
    got, want, pt, rt = _sort_both(x, 1, "radix", monkeypatch, staged=True,
                                   local="radix_pallas")
    passes = radix.pass_launches() - before
    _check_sorted(got, want, pt, rt, x)
    diffs = api._word_diffs(codec_for(x.dtype).encode(x))
    plan = radix.pass_plan(tuple((1 << d.bit_length()) - 1 for d in diffs), len(diffs))
    assert passes == len(plan)
    if dtype == "int32":
        assert passes == 3


@pytest.mark.parametrize("P", [2, 8])
def test_staged_p_ranks_under_radix_pallas_run_k4_as_pass_one(P, monkeypatch):
    """P ranks under radix_pallas: the staged words feed the distributed
    radix, whose pass 1 is K4 on every rank (two 8-bit passes of the
    16-bit digit), with bytes and counters equal to the reference's."""
    x = _keys(np.random.default_rng(55 + P), "int32", 9000)
    before = radix.pass_launches()
    got, want, pt, rt = _sort_both(x, P, "radix", monkeypatch, staged=True,
                                   local="radix_pallas")
    passes = radix.pass_launches() - before
    _check_sorted(got, want, pt, rt, x)
    assert pt.counters["local_engine"] == "radix_pallas"
    assert passes == 2 * P


@pytest.mark.parametrize("algo", ["radix", "sample"])
@pytest.mark.parametrize("P", [2, 3, 8])
def test_forced_streaming_of_host_input(algo, P, monkeypatch):
    """``SORT_INGEST=stream`` at small sizes: the host input streams in both
    packages, with equal bytes, fingerprint and route counters."""
    monkeypatch.setenv("SORT_INGEST", "stream")
    rng = np.random.default_rng(60 + P)
    x = _keys(rng, "int32", 7_777)
    got, want, pt, rt = _sort_both(x, P, algo, monkeypatch, chunk=500)
    _check_sorted(got, want, pt, rt, x)
    assert "ingest.pipeline" in {s.name for s in pt.spans.spans}
    assert "ingest.pipeline" in {s.name for s in rt.spans.spans}


def test_forced_streaming_lax_engine_and_duplicates(monkeypatch):
    monkeypatch.setenv("SORT_INGEST", "stream")
    rng = np.random.default_rng(70)
    x = rng.choice(np.asarray([3, 7, 7, 7, 42], np.int32), 6000)
    got, want, pt, rt = _sort_both(x, 4, "sample", monkeypatch, chunk=700,
                                   exchange_engine="lax")
    _check_sorted(got, want, pt, rt, x)
    assert pt.counters["sample_skew_fallback"] == 1


def test_auto_streams_p_rank_host_input_at_the_threshold(monkeypatch):
    """Under ``auto`` a P-rank host input of STREAM_MIN_BYTES or more
    streams (here the threshold is lowered in both packages); one rank's
    host input never does, as in the reference."""
    x = _keys(np.random.default_rng(80), "int32", 4096)
    monkeypatch.setattr(ingest, "STREAM_MIN_BYTES", x.nbytes)
    monkeypatch.setattr(ref_ingest, "STREAM_MIN_BYTES", x.nbytes)
    for arr, streams in ((x, True), (x[:-1], False)):
        pt, rt = Tracer(), RefTracer()
        got = mt.sort(arr, mesh=_cpu_mesh(2), tracer=pt)
        want = ref_api.sort(arr, mesh=ref_mesh(2), tracer=rt)
        assert got.tobytes() == want.tobytes()
        assert ("ingest.pipeline" in {s.name for s in pt.spans.spans}) == streams
        assert ("ingest.pipeline" in {s.name for s in rt.spans.spans}) == streams
    pt = Tracer()
    mt.sort(x, device="cpu", tracer=pt)
    assert "ingest.pipeline" not in {s.name for s in pt.spans.spans}
    monkeypatch.setenv("SORT_INGEST", "mono")
    pt = Tracer()
    mt.sort(x, mesh=_cpu_mesh(2), tracer=pt)
    assert "ingest.pipeline" not in {s.name for s in pt.spans.spans}


def test_staged_mesh_and_device_errors():
    x = _keys(np.random.default_rng(90), "int32", 3000)
    st = api.ingest_to_mesh(x, mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="different mesh"):
        mt.sort(st, mesh=_cpu_mesh(3))
    with pytest.raises(ValueError, match="own mesh"):
        mt.sort(st, device="cpu")
    assert mt.sort(st, mesh=_cpu_mesh(2)).tobytes() == np.sort(x).tobytes()


def test_ingest_to_mesh_needs_a_card_without_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        api.ingest_to_mesh(np.arange(10, dtype=np.int32))


# ------------------------------------------------------------ egress


@pytest.mark.parametrize("P", [2, 3, 8])
def test_streamed_egress_equals_plain_gather(P, monkeypatch):
    x = _keys(np.random.default_rng(100 + P), "int64", 10_001)
    res = mt.sort(x, mesh=_cpu_mesh(P), return_result=True)
    monkeypatch.setenv("SORT_INGEST", "mono")
    plain = res.to_numpy()
    monkeypatch.setenv("SORT_INGEST", "stream")
    tr = Tracer()
    streamed = res.to_numpy(tracer=tr)
    assert streamed.tobytes() == plain.tobytes() == np.sort(x).tobytes()
    names = [s.name for s in tr.spans.spans]
    assert names.count("egress.fetch") == P and names.count("egress.decode") == P
    ref_res = ref_api.sort(x, mesh=ref_mesh(P), return_result=True)
    assert ref_res.to_numpy().tobytes() == streamed.tobytes()


def test_egress_auto_threshold_and_ragged_results(monkeypatch):
    x = _keys(np.random.default_rng(110), "int32", 5000)
    res = mt.sort(x, mesh=_cpu_mesh(4), return_result=True)
    tr = Tracer()
    res.to_numpy(tracer=tr)          # 20 KB < EGRESS_MIN_BYTES: plain
    assert not any(s.name.startswith("egress.") for s in tr.spans.spans)
    monkeypatch.setattr(api, "EGRESS_MIN_BYTES", x.nbytes)
    tr = Tracer()
    assert res.to_numpy(tracer=tr).tobytes() == np.sort(x).tobytes()
    assert any(s.name == "egress.fetch" for s in tr.spans.spans)
    monkeypatch.setenv("SORT_INGEST", "stream")
    ragged = mt.sort(x, "sample", mesh=_cpu_mesh(4), return_result=True)
    tr = Tracer()
    assert ragged.to_numpy(tracer=tr).tobytes() == np.sort(x).tobytes()
    assert not any(s.name.startswith("egress.") for s in tr.spans.spans)


# ------------------------------------------------------------ donation


@pytest.mark.parametrize("P", [1, 8])
def test_consumed_staged_input_raises(P, monkeypatch):
    """SORT_DONATE=1: the sort drops the staged words once its dispatch has
    read them; reusing the staged input raises the reference's error and
    a rebuild sorts again."""
    monkeypatch.setenv("SORT_DONATE", "1")
    x = _keys(np.random.default_rng(120 + P), "int32", 9000)
    st = api.ingest_to_mesh(x, mesh=_cpu_mesh(P))
    assert mt.sort(st).tobytes() == np.sort(x).tobytes()
    assert st.consumed and st.words == []
    with pytest.raises(ValueError, match="already consumed"):
        mt.sort(st)
    st2 = st.rebuild()
    assert not st2.consumed
    assert mt.sort(st2).tobytes() == np.sort(x).tobytes()


@pytest.mark.parametrize("donate", ["0", "auto"])
def test_no_donation_keeps_staged_input(donate, monkeypatch):
    """``0``, and ``auto`` on CPU ranks, leave the staged input reusable."""
    monkeypatch.setenv("SORT_DONATE", donate)
    x = _keys(np.random.default_rng(130), "int32", 9000)
    st = api.ingest_to_mesh(x, mesh=_cpu_mesh(2))
    a = mt.sort(st)
    b = mt.sort(st)
    assert not st.consumed and a.tobytes() == b.tobytes() == np.sort(x).tobytes()


@pytest.mark.parametrize("algo", ["radix", "sample"])
@pytest.mark.parametrize("source", ["staged", "stream", "mono", "device"])
def test_donated_overflow_retry_rebuilds(algo, source, monkeypatch):
    """A tiny cap overflows; under donation the retry rebuilds the dropped
    words (re-streaming, re-sharding or re-encoding) and the bytes stay
    exact, as in the reference's donated retry."""
    monkeypatch.setenv("SORT_NEGOTIATE", "off")
    monkeypatch.setenv("SORT_DONATE", "1")
    monkeypatch.setenv("SORT_INGEST", "mono" if source == "mono" else "stream")
    monkeypatch.setenv("SORT_INGEST_CHUNK", "4096")
    x = _keys(np.random.default_rng(140), "int32", 1 << 16)
    mesh = _cpu_mesh(4)     # 4096 keys a peer against a cap of 1024
    src = {"staged": lambda: api.ingest_to_mesh(x, mesh=mesh),
           "device": lambda: torch.from_numpy(x)}.get(source, lambda: x)()
    tr = Tracer()
    got = mt.sort(src, algorithm=algo, mesh=mesh, cap_factor=1e-9, tracer=tr)
    assert got.tobytes() == np.sort(x).tobytes()
    assert (tr.counters.get("exchange_retries", 0) >= 1
            or tr.counters.get("sample_skew_fallback", 0) >= 1), tr.counters
    assert tr.counters["verify_runs"] == 1


def test_donation_setting_follows_the_device(monkeypatch):
    cpu, card = (torch.device("cpu"),), (torch.device("cuda", 0),)
    assert not api._donation_enabled(cpu) and api._donation_enabled(card)
    monkeypatch.setenv("SORT_DONATE", "1")
    assert api._donation_enabled(cpu)
    monkeypatch.setenv("SORT_DONATE", "0")
    assert not api._donation_enabled(card)


# ------------------------------------------------------------ encode stage


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16", "int32",
                                   "uint32", "int64", "uint64", "float32",
                                   "float64"])
def test_encode_and_fold_equals_reference(dtype, native_built):
    from mpitest_tpu.ops.keys import codec_for as ref_codec

    if not ref_native.available() and not ref_native.build():
        pytest.skip("the reference's native library does not build")
    rng = np.random.default_rng(150)
    x = _keys(rng, dtype, 4097)[1:]            # a misaligned view
    for eng in ("python", "native"):
        got = native_encode.encode_and_fold(x, codec_for(x.dtype), True, eng)
        want = ref_native.encode_and_fold(x, ref_codec(x.dtype), True, eng)
        assert all(a.tobytes() == b.tobytes() for a, b in zip(got[0], want[0]))
        assert (got[1], got[2]) == (want[1], want[2])
        assert (got[3] is None) == (want[3] is None)
        if got[3] is not None:
            assert got[3] == want[3] and np.asarray(got[3]).dtype == x.dtype
        assert got[4] == verify.Fingerprint.from_reference(want[4])
        assert native_encode.encode_and_fold(x, codec_for(x.dtype), False, eng)[4] is None
        with pytest.raises(ValueError, match="empty chunk"):
            native_encode.encode_and_fold(x[:0], codec_for(x.dtype), True, eng)
        with pytest.raises(ValueError, match="empty chunk"):
            ref_native.encode_and_fold(x[:0], ref_codec(x.dtype), True, eng)


def test_worker_errors_propagate(monkeypatch):
    """An exception in an encode worker or in the transfer thread reaches
    the caller (nothing is swallowed), and the next pipeline runs clean."""
    x = _keys(np.random.default_rng(160), "int32", 5000)
    real = native_encode.encode_and_fold

    def boom(chunk, *a, **k):
        if chunk[0] == x[2000]:
            raise RuntimeError("encode worker failed")
        return real(chunk, *a, **k)

    monkeypatch.setattr(native_encode, "encode_and_fold", boom)
    with pytest.raises(RuntimeError, match="encode worker failed"):
        ingest.stream_to_mesh(x, _cpu_mesh(2), chunk_elems=1000)
    monkeypatch.setattr(native_encode, "encode_and_fold", real)

    def bad_copy(self, *a, **k):
        raise RuntimeError("transfer failed")

    monkeypatch.setattr(torch.Tensor, "copy_", bad_copy)
    with pytest.raises(RuntimeError, match="transfer failed"):
        ingest.stream_to_mesh(x, _cpu_mesh(2), chunk_elems=1000)
    monkeypatch.undo()
    st = ingest.stream_to_mesh(x, _cpu_mesh(2), chunk_elems=1000)
    assert np.concatenate([to_host_words(s[0]) for s in st.words]).tobytes() == \
        codec_for(x.dtype).encode(x)[0].tobytes()


# ------------------------------------------------------------ knobs


@pytest.mark.parametrize("knob,value", [("SORT_INGEST", "fast"), ("SORT_INGEST", ""),
                                        ("SORT_DONATE", "yes"), ("SORT_DONATE", "2")])
def test_ingest_knob_errors_match_reference(knob, value, monkeypatch):
    from mpitest_tpu.utils import knobs as ref_knobs

    monkeypatch.setenv(knob, value)
    with pytest.raises(knobs.KnobError) as ei:
        knobs.get(knob)
    with pytest.raises(ValueError) as ref_ei:
        ref_knobs.get(knob)
    assert str(ei.value) == str(ref_ei.value)


def test_ingest_knob_defaults_match_reference(monkeypatch):
    from mpitest_tpu.utils import io as ref_io
    from mpitest_tpu_torch.utils import io as kio

    for name in ("SORT_INGEST", "SORT_DONATE", "SORT_INGEST_CHUNK",
                 "SORT_INGEST_THREADS"):
        monkeypatch.delenv(name, raising=False)
    assert kio.ingest_mode() == ref_io.ingest_mode() == "auto"
    assert kio.donate_setting() == ref_io.donate_setting() == "auto"
    assert kio.INGEST_MODES == ref_io.INGEST_MODES
    assert kio.DONATE_MODES == ref_io.DONATE_MODES
    assert kio.ingest_chunk_elems() == ref_io.ingest_chunk_elems()
    assert kio.ingest_threads() == ref_io.ingest_threads()


def test_cli_streams_its_p_rank_input(tmp_path, capsys, monkeypatch):
    """The key-file CLI on two CPU ranks under ``SORT_INGEST=stream``: the
    input streams, the egress streams, and the probe is np.sort's."""
    from mpitest_tpu_torch import cli
    from mpitest_tpu_torch.utils import io as kio

    x = _keys(np.random.default_rng(170), "int32", 6000)
    p = str(tmp_path / "k.bin")
    kio.write_keys_binary(p, x)
    monkeypatch.setenv("SORT_INGEST", "stream")
    monkeypatch.setenv("SORT_INGEST_CHUNK", "1000")
    monkeypatch.setenv("SORT_RANKS", "2")
    monkeypatch.setenv("SORT_ALGO", "radix")
    tr = Tracer()
    assert cli.main(["cli", p], device="cpu", tracer=tr) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == [f"The n/2-th sorted element: {np.sort(x)[x.size // 2 - 1]}"]
    names = {s.name for s in tr.spans.spans}
    assert {"ingest.pipeline", "egress.fetch", "egress.decode"} <= names


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 8])
def test_streamed_ingest_and_egress_on_the_card(P, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    monkeypatch.setenv("SORT_INGEST", "stream")
    x = _keys(np.random.default_rng(180), "int64", (1 << 20) + 3)
    mesh = make_mesh(P)
    st = api.ingest_to_mesh(x, mesh=mesh, chunk_elems=1 << 16)
    ref = ingest.stream_to_mesh(x, _cpu_mesh(P), chunk_elems=1 << 16)
    for a, b in zip(st.words, ref.words):
        assert all(torch.equal(u.cpu(), v) for u, v in zip(a, b))
    assert st.fingerprint == ref.fingerprint and st.word_diffs == ref.word_diffs
    res = mt.sort(st, return_result=True)
    assert res.to_numpy(tracer=Tracer()).tobytes() == np.sort(x).tobytes()
