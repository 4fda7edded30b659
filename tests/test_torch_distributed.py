"""``mpitest_tpu_torch.sort(x, mesh=make_mesh(P, devices=["cpu"] * P))``
against ``mpitest_tpu.sort(x, mesh=make_mesh(P))`` on the reference's
cpu:P mesh.

Held equal: the output bytes, the result's ``Fingerprint`` (and the
input's), and the exchange counters.  The reference runs the same
engines in their interpreter forms, whose names map to the port's:
``pallas_interpret`` -> ``pallas``, ``bitonic_interpret`` -> ``bitonic``,
``radix_pallas_interpret`` -> ``radix_pallas``.  Its ``lax`` engine is
given ``pack="pallas_interpret"``, the pack it takes on a TPU, so caps
align to 1024 as the port's do.  Input classes are those of
``bench/multichip_selftest.py``; inputs come from a numpy seed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mpitest_tpu_torch as mt
from mpitest_tpu.models import api as ref_api
from mpitest_tpu.models import verify as ref_vfy
from mpitest_tpu.ops.keys import codec_for as ref_codec
from mpitest_tpu.parallel.mesh import make_mesh as ref_mesh
from mpitest_tpu.utils.trace import Tracer as RefTracer
from mpitest_tpu_torch.models import api, verify
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.utils.trace import Tracer

COUNTERS = ("negotiated_cap", "worst_cap", "exchange_cap", "exchange_passes",
            "exchange_retries", "skew_restage", "digit_bits", "exchange_engine",
            "local_engine", "exchange_peer_ratio", "exchange_balance_ratio",
            "sample_skew_fallback", "exchange_bytes")
_NAMES = {"pallas_interpret": "pallas", "bitonic_interpret": "bitonic",
          "radix_pallas_interpret": "radix_pallas"}


def _cpu_mesh(P):
    return make_mesh(P, devices=["cpu"] * P)


def _ref_fingerprint(res) -> verify.Fingerprint:
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


def _both(x, P, algo, engine, monkeypatch, local="lax", ref_x=None, **kw):
    """Sort ``x`` in both packages; returns (port result, reference
    result, port counters, reference counters)."""
    monkeypatch.setenv("SORT_LOCAL_ENGINE", local)
    rt, pt = RefTracer(), Tracer()
    ref_kw = dict(kw)
    if engine == "lax":
        ref_kw.setdefault("pack", "pallas_interpret")
    want = ref_api.sort(x if ref_x is None else ref_x, algorithm=algo,
                        mesh=ref_mesh(P), tracer=rt, return_result=True,
                        exchange_engine="pallas_interpret" if engine == "pallas" else "lax",
                        **ref_kw)
    got = mt.sort(x, algorithm=algo, mesh=_cpu_mesh(P), tracer=pt,
                  return_result=True, exchange_engine=engine, **kw)
    return got, want, pt.counters, rt.counters


def _check(x, P, algo, engine, monkeypatch, local="lax", **kw):
    got, want, pc, rc = _both(x, P, algo, engine, monkeypatch, local, **kw)
    g, w = got.to_numpy(), want.to_numpy()
    assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert verify.result_fingerprint(got) == _ref_fingerprint(want)
    for c in COUNTERS:
        assert _NAMES.get(pc.get(c), pc.get(c)) == _NAMES.get(rc.get(c), rc.get(c)), c
    assert pc["verify_runs"] == 1
    if P > 1:
        assert len(got.shards) == P
        if algo == "sample" and not pc.get("sample_skew_fallback"):
            assert got.counts is not None and got.shard_slots == P * pc["exchange_cap"]
    return got, pc


_RNG = np.random.default_rng(2026)
UNIFORM = _RNG.integers(-2**31, 2**31 - 1, 1 << 13, dtype=np.int32)


@pytest.mark.parametrize("engine", ["pallas", "lax"])
@pytest.mark.parametrize("algo", ["radix", "sample"])
@pytest.mark.parametrize("P", [1, 2, 3, 8])
def test_uniform_int32_matches_reference(P, algo, engine, monkeypatch):
    got, pc = _check(UNIFORM, P, algo, engine, monkeypatch)
    np.testing.assert_array_equal(got.to_numpy(), np.sort(UNIFORM))
    if P > 1:
        assert pc["exchange_cap"] % 1024 == 0


def _classes():
    rng = np.random.default_rng(7)
    return {
        "n_lt_p": rng.integers(0, 100, size=3, dtype=np.int32),
        "non_divisible": rng.integers(-2**31, 2**31 - 1, size=1000, dtype=np.int32),
        "sorted_skew": np.sort(rng.integers(0, 1 << 16, size=1 << 14).astype(np.int32)),
        "duplicate_skew": rng.choice(np.asarray([3, 7, 7, 7, 42], np.int32),
                                     size=1 << 13),
    }


@pytest.mark.parametrize("algo", ["radix", "sample"])
@pytest.mark.parametrize("name", ["n_lt_p", "non_divisible", "sorted_skew",
                                  "duplicate_skew"])
def test_input_classes_match_reference(name, algo, monkeypatch):
    x = _classes()[name]
    got, pc = _check(x, 8, algo, "pallas", monkeypatch)
    np.testing.assert_array_equal(got.to_numpy(), np.sort(x))
    if name == "sorted_skew":
        assert pc["skew_restage"] == 1
    if name == "duplicate_skew" and algo == "sample":
        assert pc["sample_skew_fallback"] == 1


def _keys(dtype, n, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = (rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)).astype(dt)
        x[:6] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf]
        return x
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


@pytest.mark.parametrize("algo", ["radix", "sample"])
@pytest.mark.parametrize("dtype", [np.uint32, np.float32, np.int64, np.float64,
                                   np.uint64, np.int16],
                         ids=lambda d: np.dtype(d).name)
def test_dtypes_match_reference(dtype, algo, monkeypatch):
    _check(_keys(dtype, 3001, 3), 3, algo, "pallas", monkeypatch)


def test_narrow_int64_takes_fewer_passes(monkeypatch):
    """int64 keys inside one 20-bit window: the plan skips the constant
    digits (2 passes of 16 bits, not 4)."""
    x = _RNG.integers(5 << 32, (5 << 32) + (1 << 20), 6000, dtype=np.int64)
    _, pc = _check(x, 4, "radix", "lax", monkeypatch)
    assert (pc["exchange_passes"], pc["digit_bits"]) == (2, 16)


@pytest.mark.parametrize("algo", ["radix", "sample"])
def test_digit_bits_and_cap_factor_match_reference(algo, monkeypatch):
    _check(UNIFORM, 4, algo, "pallas", monkeypatch, digit_bits=8, cap_factor=1.5)


def test_local_engines_match_reference(monkeypatch):
    """radix_pallas runs pass 1 of the radix sort with K4; bitonic sorts
    sample sort's shards and merge (K1 for one word)."""
    from mpitest_tpu_torch.ops import radix

    before = radix.pass_launches()
    _, pc = _check(UNIFORM, 8, "radix", "pallas", monkeypatch, local="radix_pallas")
    assert pc["local_engine"] == "radix_pallas"
    assert radix.pass_launches() - before == 8 * 2   # 16-bit digit: 2 K4 passes a rank
    _, pc = _check(UNIFORM, 4, "sample", "pallas", monkeypatch, local="bitonic")
    assert pc["local_engine"] == "bitonic"


def test_sample_bitonic_int64_matches_reference(monkeypatch):
    """64-bit sample sort under bitonic: the pair engine (K2 + K3)."""
    x = _keys(np.int64, 3000, 11)
    _, pc = _check(x, 2, "sample", "lax", monkeypatch, local="bitonic")
    assert pc["local_engine"] == "bitonic"


@pytest.mark.parametrize("algo", ["radix", "sample"])
def test_device_resident_input_matches_reference(algo, monkeypatch):
    """A torch tensor is encoded, padded and split on its device; the
    sample sniff and the pass planner run on the device words."""
    import jax

    x = _classes()["non_divisible"]
    _check(torch.from_numpy(x), 3, algo, "pallas", monkeypatch,
           ref_x=jax.device_put(x, jax.devices()[0]))
    dup = _classes()["duplicate_skew"]
    _, pc = _check(torch.from_numpy(dup), 8, algo, "pallas", monkeypatch,
                   ref_x=jax.device_put(dup, jax.devices()[0]))
    assert pc.get("sample_skew_fallback", 0) == (algo == "sample")


def test_device_resident_int64_and_float(monkeypatch):
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "lax")
    for dtype in (np.int64, np.float64):
        x = _keys(dtype, 2001, 5)
        for algo in ("radix", "sample"):
            got = mt.sort(torch.from_numpy(x), algorithm=algo, mesh=_cpu_mesh(2))
            assert got.tobytes() == ref_api.sort(x, algorithm=algo,
                                                 mesh=ref_mesh(2)).tobytes()


@pytest.mark.parametrize("algo", ["radix", "sample"])
def test_negotiation_and_restage_off_match_reference(algo, monkeypatch):
    """Without negotiation the cap starts at cap_factor and the regrow
    loop sizes it (``exchange_retries``); without re-stage the sorted
    input keeps its clustered shards."""
    monkeypatch.setenv("SORT_NEGOTIATE", "off")
    x = _classes()["sorted_skew"]
    _, pc = _check(x, 8, algo, "pallas", monkeypatch, cap_factor=0.5)
    assert pc.get("exchange_retries", 0) >= 1
    monkeypatch.setenv("SORT_NEGOTIATE", "auto")
    monkeypatch.setenv("SORT_RESTAGE", "off")
    _, pc = _check(x, 8, algo, "lax", monkeypatch)
    assert pc.get("skew_restage", 0) == 0


@pytest.mark.parametrize("negotiate", ["auto", "off"])
def test_sample_reroutes_past_the_sniff(negotiate, monkeypatch):
    """With both skew sniffs stubbed off, duplicate-heavy keys still reach
    radix: by the probe's estimate (negotiation on) or by the late cap
    overflow (negotiation off).  The recv bound drops to 2 fair shares in
    both packages: at 8 shares and P = 8 it equals a whole shard, which no
    exchange can exceed."""
    for mod in (ref_api, api):
        monkeypatch.setattr(mod, "_sample_skew_sniff", lambda *a: False)
        monkeypatch.setattr(mod, "SAMPLE_CAP_LIMIT_FACTOR", 2)
    monkeypatch.setenv("SORT_NEGOTIATE", negotiate)
    x = np.random.default_rng(8).choice(np.asarray([3, 7, 7, 7, 42], np.int32),
                                        size=1 << 16)
    got, pc = _check(x, 8, "sample", "pallas", monkeypatch)
    assert pc["sample_skew_fallback"] == 1 and got.counts is None


def test_median_probe_and_shards(monkeypatch):
    for algo in ("radix", "sample"):
        got, want, _, _ = _both(UNIFORM, 2, algo, "pallas", monkeypatch)
        assert got.median_probe() == want.median_probe()
        assert got.words == () and got.n_valid == UNIFORM.size


def test_input_fingerprint_equals_reference(monkeypatch):
    """The input side of the verifier: the reference's host fold of the
    encoded keys equals the port's fold over its padded device shards."""
    x = _classes()["non_divisible"]
    codec = api.codec_for(x.dtype)
    _, shards = api._device_shards(torch.from_numpy(x), codec, x.dtype,
                                   _cpu_mesh(8), 125)
    want = ref_vfy.fingerprint_host(ref_codec(x.dtype).encode(x))
    assert verify.fingerprint_device(shards, x.size) == \
        verify.Fingerprint.from_reference(want)


def test_interpreter_names_are_rejected(monkeypatch):
    with pytest.raises(mt.KnobError, match="use 'pallas'"):
        mt.sort(UNIFORM, mesh=_cpu_mesh(2), exchange_engine="pallas_interpret")
    with pytest.raises(mt.KnobError, match="use 'pallas'"):
        mt.sort(UNIFORM, mesh=_cpu_mesh(2), exchange_engine="lax",
                pack="pallas_interpret")
    monkeypatch.setenv("SORT_EXCHANGE_ENGINE", "pallas_interpret")
    with pytest.raises(mt.KnobError, match="SORT_EXCHANGE_ENGINE='pallas_interpret'"):
        mt.sort(UNIFORM, mesh=_cpu_mesh(2))
    monkeypatch.setenv("SORT_EXCHANGE_ENGINE", "warp")
    with pytest.raises(mt.KnobError, match="SORT_EXCHANGE_ENGINE='warp'"):
        mt.sort(UNIFORM, mesh=_cpu_mesh(2))
    monkeypatch.setenv("SORT_EXCHANGE_ENGINE", "auto")
    for knob, bad in (("SORT_NEGOTIATE", "maybe"), ("SORT_RESTAGE", "on"),
                      ("SORT_RESTAGE_RATIO", "1"), ("SORT_DEVICES", "0")):
        monkeypatch.setenv(knob, bad)
        with pytest.raises(mt.KnobError, match=knob):
            mt.sort(UNIFORM, mesh=_cpu_mesh(2)) if knob != "SORT_DEVICES" \
                else make_mesh()
        monkeypatch.delenv(knob)
    with pytest.raises(ValueError, match="either device or mesh"):
        mt.sort(UNIFORM, device="cpu", mesh=_cpu_mesh(2))


def test_auto_engine_resolves_to_pallas(monkeypatch):
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "lax")
    tr = Tracer()
    mt.sort(UNIFORM, mesh=_cpu_mesh(2), tracer=tr)
    assert tr.counters["exchange_engine"] == "pallas"
    assert tr.counters["exchange_cap"] % 1024 == 0


def test_verification_failure_is_typed(monkeypatch):
    from mpitest_tpu_torch.models import radix_sort

    real = radix_sort.radix_sort_spmd

    def corrupt(*a, **k):
        out, mc = real(*a, **k)
        return [tuple(w.flip(0) for w in s) for s in out], mc

    monkeypatch.setattr(radix_sort, "radix_sort_spmd", corrupt)
    with pytest.raises(mt.SortIntegrityError):
        mt.sort(UNIFORM, mesh=_cpu_mesh(3))


def test_a_cuda_mesh_without_cuda_raises(monkeypatch):
    from mpitest_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        mt.sort(UNIFORM, mesh=Mesh((torch.device("cuda", 0),) * 2))


def test_empty_input_on_a_mesh():
    out = mt.sort(np.empty(0, np.int64), mesh=_cpu_mesh(3))
    assert out.dtype == np.int64 and out.size == 0


# --------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["radix", "sample"])
@pytest.mark.parametrize("engine", ["pallas", "lax"])
def test_mesh_on_the_card_matches_reference(algo, engine, monkeypatch):
    """P = 8 ranks on the card: the kernels of the path launch, and the
    bytes equal the reference's."""
    from mpitest_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU form)")
    x = _RNG.integers(-2**31, 2**31 - 1, 1 << 16, dtype=np.int32)
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "auto")
    _build.reset_launches()
    got = mt.sort(x, algorithm=algo, mesh=make_mesh(8), exchange_engine=engine)
    kern = ("fused_pass_pack", "remote_a2a") if engine == "pallas" else ("segment_pack",)
    assert all(_build.launches(k) > 0 for k in kern)
    assert got.tobytes() == ref_api.sort(x, algorithm=algo, mesh=ref_mesh(8)).tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["radix", "sample"])
def test_mesh_across_cards_matches_torch_sort(algo):
    """Eight ranks round-robin over every card of the machine."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    mesh = make_mesh(8)
    assert len(set(mesh.devices)) == min(8, torch.cuda.device_count())
    x = _RNG.integers(-2**31, 2**31 - 1, (1 << 22) + 5, dtype=np.int32)
    tr = Tracer()
    got = mt.sort(x, algorithm=algo, mesh=mesh, tracer=tr)
    assert tr.counters["exchange_engine"] == "pallas"
    assert got.tobytes() == np.sort(x).tobytes()
