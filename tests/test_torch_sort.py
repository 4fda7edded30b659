"""``mpitest_tpu_torch.sort(x, device="cpu")`` against ``mpitest_tpu.sort(x)``
on a one-device mesh: byte-identical output and the same routing
(``local_engine`` counter, reroute / fallback counters).

Both run with ``SORT_LOCAL_ENGINE=bitonic`` (the knob has one name in
both packages), so the reference runs its Pallas kernels in interpret
mode and the port walks the same tree with its plain kernel versions.
The reference names the interpret form of its one-word engine
``bitonic_interpret``; the port's is ``bitonic``.  Under
``SORT_LOCAL_ENGINE=radix_pallas`` the reference on the CPU names its
fused engine ``radix_pallas_interpret``; the port's is ``radix_pallas``.
"""


from __future__ import annotations

import numpy as np
import pytest
import torch

import mpitest_tpu_torch as mt
from mpitest_tpu.models import api as ref_api
from mpitest_tpu.parallel.mesh import make_mesh
from mpitest_tpu.utils.trace import Tracer as RefTracer
from mpitest_tpu_torch.models import api
from mpitest_tpu_torch.utils.trace import Tracer

N = 15_000  # > 2^13, past the pad break-even of 2^14


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1)


def _engine(counters):
    eng = counters.get("local_engine")
    return {"bitonic_interpret": "bitonic",
            "radix_pallas_interpret": "radix_pallas"}.get(eng, eng)


_ROUTE_COUNTERS = ("pair_dup_reroute", "pair_residual_fallback")


def _both(x, mesh1, monkeypatch, engine="bitonic", **kw):
    monkeypatch.setenv("SORT_LOCAL_ENGINE", engine)
    rt, pt = RefTracer(), Tracer()
    want = ref_api.sort(x, algorithm="radix", mesh=mesh1, tracer=rt, **kw)
    got = mt.sort(x, device="cpu", tracer=pt, **kw)
    return got, want, pt.counters, rt.counters


def _check(x, mesh1, monkeypatch, engine="bitonic"):
    got, want, pc, rc = _both(x, mesh1, monkeypatch, engine)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    assert _engine(pc) == _engine(rc)
    for c in _ROUTE_COUNTERS:
        assert pc.get(c, 0) == rc.get(c, 0), c
    assert pc["verify_runs"] == 1
    return pc


def _keys(dtype, n, seed=11):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = (rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)).astype(dt)
        x[:6] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf]
        return x
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.uint16,
                                   np.int32, np.uint32, np.float32, np.int64,
                                   np.uint64, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_all_dtypes_match_reference(dtype, mesh1, monkeypatch):
    pc = _check(_keys(dtype, N), mesh1, monkeypatch)
    assert pc["local_engine"] == ("bitonic_pair" if np.dtype(dtype).itemsize == 8
                                  else "bitonic")


@pytest.mark.parametrize("n", [1, 2, 1000, 8191])
def test_below_min_sort_size(n, mesh1, monkeypatch):
    _check(_keys(np.int32, n), mesh1, monkeypatch)
    _check(_keys(np.int64, n), mesh1, monkeypatch)


def test_pad_heavy_takes_break_even_route(mesh1, monkeypatch):
    """2^13 + 5 keys pad to 2^14: past the break-even the exact n goes to
    the plain sort inside the bitonic engine, in both packages."""
    _check(_keys(np.uint32, (1 << 13) + 5), mesh1, monkeypatch)


def test_power_of_two_and_non_power_of_two(mesh1, monkeypatch):
    _check(_keys(np.int32, 1 << 14), mesh1, monkeypatch)
    _check(_keys(np.int32, 12_345), mesh1, monkeypatch)


@pytest.mark.parametrize("engine", ["auto", "lax"])
def test_auto_and_lax_engines(engine, mesh1, monkeypatch):
    """``auto`` routes exactly as the reference does on a TPU (bitonic
    for n >= 2^13) — the reference run here is forced to bitonic, which
    is that routing; ``lax`` is the plain sort in both."""
    x = _keys(np.int32, N)
    monkeypatch.setenv("SORT_LOCAL_ENGINE", engine)
    tr = Tracer()
    got = mt.sort(x, device="cpu", tracer=tr)
    np.testing.assert_array_equal(got, np.sort(x))
    assert tr.counters["local_engine"] == ("bitonic" if engine == "auto" else "lax")
    ref_engine = "bitonic" if engine == "auto" else "lax"
    _check(x, mesh1, monkeypatch, engine=ref_engine)


def test_constant_word_shortcuts(mesh1, monkeypatch):
    rng = np.random.default_rng(4)
    hi_const = rng.integers(0, 2**31, size=N, dtype=np.int64)
    assert _check(hi_const, mesh1, monkeypatch)["local_engine"] == "bitonic_1w1"
    lo_const = rng.integers(0, 2**30, size=N, dtype=np.int64) << 32
    assert _check(lo_const, mesh1, monkeypatch)["local_engine"] == "bitonic_1w0"
    same = np.full(N, -(7 << 40), np.int64)
    assert _check(same, mesh1, monkeypatch)["local_engine"] == "constant"


def test_hi_duplication_reroutes(mesh1, monkeypatch):
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 8, size=N).astype(np.int64)
    x = (hi << 33) | rng.integers(0, 2**32, size=N).astype(np.int64)
    pc = _check(x, mesh1, monkeypatch)
    assert pc["local_engine"] == "lax" and pc["pair_dup_reroute"] == 1


def _mid_runs(run, seed):
    rng = np.random.default_rng(seed)
    n_runs = -(-N // run)
    hi = np.repeat(np.arange(n_runs, dtype=np.int64) * 37 + 5, run)[:N]
    x = (hi << 32) | rng.integers(0, 2**32, size=N).astype(np.int64)
    rng.shuffle(x)
    return x


@pytest.mark.parametrize("run,fallback", [(9, False), (16, False), (24, True)])
def test_mid_runs_fix_and_residual_fallback(run, fallback, mesh1, monkeypatch):
    """Runs of 9-16 equal-hi keys ride the in-kernel fix-up; runs of 24
    leave residual runs and fall back.  The sniff is stubbed off in both
    packages so the miss is forced."""
    monkeypatch.setattr(ref_api, "_host_hi_dup_sniff", lambda hi: False)
    monkeypatch.setattr(api, "_host_hi_dup_sniff", lambda hi: False)
    pc = _check(_mid_runs(run, run), mesh1, monkeypatch)
    assert pc["local_engine"] == "bitonic_pair"
    assert pc.get("pair_residual_fallback", 0) == (1 if fallback else 0)


@pytest.mark.parametrize("dtype", [np.int32, np.float64], ids=["int32", "float64"])
def test_return_result_and_median_probe(dtype, mesh1, monkeypatch):
    x = _keys(dtype, N, seed=9)
    got, want, _, _ = _both(x, mesh1, monkeypatch, return_result=True)
    assert isinstance(got, api.DistributedSortResult)
    assert got.n_valid == want.n_valid == N
    assert got.to_numpy().tobytes() == want.to_numpy().tobytes()
    assert (np.asarray(got.median_probe_raw()).tobytes()
            == np.asarray(want.median_probe_raw()).tobytes())
    if dtype == np.int32:
        assert got.median_probe() == want.median_probe()


@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=["int32", "int64"])
def test_device_resident_tensor_input(dtype, mesh1, monkeypatch):
    """A torch tensor is the device-resident path (encode + fingerprint on
    its device); same bytes and route as the reference's device path."""
    import jax

    from mpitest_tpu import compat

    x = _keys(dtype, N, seed=3)
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "bitonic")
    rt, pt = RefTracer(), Tracer()
    with compat.enable_x64(True):
        want = ref_api.sort(jax.device_put(x, jax.devices()[0]), mesh=mesh1,
                            tracer=rt)
    got = mt.sort(torch.from_numpy(x), device="cpu", tracer=pt)
    assert got.tobytes() == want.tobytes()
    assert _engine(pt.counters) == _engine(rt.counters)


def test_tracer_records_phases_and_nested_spans(monkeypatch, capsys):
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "auto")
    tr = Tracer(level=1)
    mt.sort(_keys(np.int32, N), device="cpu", tracer=tr)
    assert set(tr.phases) == {"encode", "verify", "device_put", "sort", "decode"}
    root = tr.spans.spans[0]
    assert root.name == "sort" and root.parent is None
    assert root.attrs["n"] == N and root.attrs["device"] == "cpu"
    inner = tr.spans.spans[1:]
    # the local sort's dispatch carries the first-call split (which of the
    # two depends on whether this process ran the program before)
    jit = [s for s in inner if s.name in ("jit_compile_execute", "jit_execute")]
    assert len(jit) == 1 and jit[0].attrs["label"] == "local"
    assert {s.name for s in inner} - {jit[0].name} == \
        {f"phase:{p}" for p in tr.phases} | {"verify"}
    assert all(s.parent is not None for s in inner)
    assert [s.attrs["ok"] for s in inner if s.name == "verify"] == [True]
    assert "[VERBOSE] phase sort:" in capsys.readouterr().out


def test_empty_input(monkeypatch):
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "auto")
    out = mt.sort(np.empty(0, np.int64), device="cpu")
    assert out.dtype == np.int64 and out.size == 0
    res = mt.sort(np.empty(0, np.int32), device="cpu", return_result=True)
    assert res.n_valid == 0


def test_verification_failure_is_typed(monkeypatch):
    """A result that fails the verifier raises SortIntegrityError; there
    is no fallback rung on one card."""
    from mpitest_tpu_torch.ops import kernels

    real = kernels.local_sort

    def corrupt(words, engine="lax", diffs=None):
        out = real(words, engine, diffs)
        return (out[0].flip(0),) + tuple(out[1:])

    monkeypatch.setattr(kernels, "local_sort", corrupt)
    with pytest.raises(mt.SortIntegrityError):
        mt.sort(_keys(np.int32, 5000), device="cpu")
    monkeypatch.setenv("SORT_VERIFY", "0")
    mt.sort(_keys(np.int32, 5000), device="cpu")  # unverified: no raise


def test_knob_validation(monkeypatch):
    """``radix_pallas`` is accepted (the fused radix kernel, K4); its
    interpreter twin has no counterpart and is rejected by name."""
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    x = _keys(np.int32, 100)
    tr = Tracer()
    np.testing.assert_array_equal(mt.sort(x, device="cpu", tracer=tr), np.sort(x))
    assert tr.counters["local_engine"] == "radix_pallas"
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas_interpret")
    with pytest.raises(mt.KnobError, match="use 'radix_pallas'"):
        mt.sort(x, device="cpu")
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "warp")
    with pytest.raises(mt.KnobError, match="SORT_LOCAL_ENGINE='warp'"):
        mt.sort(_keys(np.int32, 100), device="cpu")
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "auto")
    monkeypatch.setenv("SORT_VERIFY", "yes")
    with pytest.raises(mt.KnobError, match="SORT_VERIFY"):
        mt.sort(_keys(np.int32, 100), device="cpu")


def test_bad_algorithm():
    with pytest.raises(ValueError, match="unknown algorithm"):
        mt.sort(np.arange(4), algorithm="bogo", device="cpu")


# ------------------------------------------------------- radix_pallas


def _passes(fn):
    from mpitest_tpu_torch.ops import radix

    before = radix.pass_launches()
    out = fn()
    return out, radix.pass_launches() - before


@pytest.fixture
def small_envelope(monkeypatch):
    """Shrink the fused envelope to 4096 keys in both packages, so both
    sides of it run at interpret-friendly sizes."""
    from mpitest_tpu.ops import radix_pallas as ref_rp
    from mpitest_tpu_torch.ops import radix

    monkeypatch.setattr(ref_rp, "FUSED_MAX_ELEMS", 4096)
    monkeypatch.setattr(radix, "FUSED_MAX_ELEMS", 4096)
    return 4096


@pytest.mark.parametrize("dtype,n", [(np.int32, 3000), (np.float32, 2048),
                                     (np.uint16, 1000), (np.int64, 3001),
                                     (np.float64, 1500)],
                         ids=lambda v: getattr(np.dtype(v), "name", str(v))
                         if not isinstance(v, int) else str(v))
def test_radix_pallas_host_input_matches_reference(dtype, n, mesh1, monkeypatch):
    """Host input inside the envelope (64-bit keys below 2^13 take the
    general route): K4 over every word, the pass plan compacted from the
    words' ranges, bytes and engine equal to the reference's."""
    from mpitest_tpu_torch.ops import radix

    x = _keys(dtype, n, seed=n)
    (got, want, pc, rc), passes = _passes(
        lambda: _both(x, mesh1, monkeypatch, engine="radix_pallas"))
    assert got.tobytes() == want.tobytes()
    assert _engine(pc) == _engine(rc) == "radix_pallas"
    words = api.codec_for(np.dtype(dtype)).encode(x)
    diffs = tuple((1 << d.bit_length()) - 1 for d in api._word_diffs(words))
    assert passes == len(radix.pass_plan(diffs, len(words)))


def test_radix_pallas_compacts_narrow_int32(mesh1, monkeypatch):
    """int32 keys in [0, 2^20): 3 passes (8 + 8 + 4 bits), not 4."""
    x = np.random.default_rng(20).integers(0, 1 << 20, 4000).astype(np.int32)
    (got, want, pc, _), passes = _passes(
        lambda: _both(x, mesh1, monkeypatch, engine="radix_pallas"))
    assert got.tobytes() == want.tobytes() and passes == 3
    assert pc["local_engine"] == "radix_pallas"


@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["int32", "float32"])
def test_radix_pallas_device_input_runs_full_plan(dtype, mesh1, monkeypatch):
    """Device-resident input runs the full plan (no range reduction on
    the device), as the reference's device program does."""
    import jax

    n = 2500
    x = _keys(dtype, n, seed=8)
    x[:100] = x[100]                 # narrow or not, the plan stays full
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    rt, pt = RefTracer(), Tracer()
    want = ref_api.sort(jax.device_put(x, jax.devices()[0]), mesh=mesh1, tracer=rt)
    got, passes = _passes(lambda: mt.sort(torch.from_numpy(x), device="cpu",
                                          tracer=pt))
    assert got.tobytes() == want.tobytes()
    assert _engine(pt.counters) == _engine(rt.counters) == "radix_pallas"
    assert passes == 4


def test_radix_pallas_device_input_64bit_general_route(mesh1, monkeypatch):
    """64-bit device input below 2^13 keys: the general route, K4 over
    both words with the full plan (8 passes).  The reference's interpret
    kernel cannot run under the x64 mode its 64-bit device input needs,
    so the bytes are held against its host-input run."""
    x = np.random.default_rng(9).integers(0, 1 << 20, 3000).astype(np.uint64)
    out, passes, c = _run_port(torch.from_numpy(x), monkeypatch)
    assert (c["local_engine"], passes) == ("radix_pallas", 8)
    assert out.tobytes() == ref_api.sort(x, mesh=mesh1).tobytes()


@pytest.mark.parametrize("side", ["inside", "outside"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=["int32", "int64"])
def test_radix_pallas_envelope(side, dtype, small_envelope, mesh1, monkeypatch):
    """At the envelope's edge the fused engine runs, one key past it the
    lax sort does, in both packages (64-bit keys below 2^13 take the
    general route there, as in the reference)."""
    n = small_envelope + (side == "outside")
    x = _keys(dtype, n, seed=n)
    (got, want, pc, rc), passes = _passes(
        lambda: _both(x, mesh1, monkeypatch, engine="radix_pallas"))
    assert got.tobytes() == want.tobytes()
    eng = "radix_pallas" if side == "inside" else "lax"
    assert _engine(pc) == _engine(rc) == eng
    assert (passes > 0) == (side == "inside")


@pytest.mark.parametrize("side", ["inside", "outside"])
def test_radix_pallas_envelope_device_input(side, small_envelope, mesh1,
                                            monkeypatch):
    import jax

    n = small_envelope + (side == "outside")
    x = _keys(np.int32, n, seed=n + 1)
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    rt = RefTracer()
    want = ref_api.sort(jax.device_put(x, jax.devices()[0]), mesh=mesh1, tracer=rt)
    out, passes, c = _run_port(torch.from_numpy(x), monkeypatch)
    assert out.tobytes() == want.tobytes()
    eng = "radix_pallas" if side == "inside" else "lax"
    assert _engine(c) == _engine(rt.counters) == eng
    assert passes == (4 if side == "inside" else 0)


def _run_port(x, monkeypatch, **kw):
    from mpitest_tpu_torch.ops import _build

    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    tr = Tracer()
    before = dict(_build.LAUNCHES)
    out, passes = _passes(lambda: mt.sort(x, device="cpu", tracer=tr, **kw))
    assert _build.LAUNCHES == before  # the CPU runs no kernel
    return out, passes, tr.counters


def test_radix_pallas_64bit_tpu_decision_table(mesh1, monkeypatch):
    """64-bit keys with n >= 2^13 under radix_pallas take the reference's
    TPU decisions (``api.py:1469-1473``): the host constant-word shortcut
    runs K4 on the varying word (full plan, counter ``bitonic_1w1``), the
    dup sniff goes to lax, otherwise the bitonic pair engine runs; the
    device form keeps the bitonic one-word engine (no K4 pass).  The CPU
    reference takes its general two-word route instead, so only the
    bytes are compared with it."""
    rng = np.random.default_rng(64)
    n = N
    window = rng.integers(5 << 32, 6 << 32, n, dtype=np.int64)
    out, passes, c = _run_port(window, monkeypatch)
    assert (c["local_engine"], passes) == ("bitonic_1w1", 4)
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    assert out.tobytes() == ref_api.sort(window, mesh=mesh1).tobytes()

    lo_const = rng.integers(0, 2**30, n, dtype=np.int64) << 32
    out, passes, c = _run_port(lo_const, monkeypatch)
    assert (c["local_engine"], passes) == ("bitonic_1w0", 4)
    assert out.tobytes() == np.sort(lo_const).tobytes()

    hi = rng.integers(0, 8, n).astype(np.int64)
    dup = (hi << 33) | rng.integers(0, 2**32, n).astype(np.int64)
    out, passes, c = _run_port(dup, monkeypatch)
    assert (c["local_engine"], passes, c["pair_dup_reroute"]) == ("lax", 0, 1)
    assert out.tobytes() == np.sort(dup).tobytes()

    full = _keys(np.int64, n, seed=65)
    out, passes, c = _run_port(full, monkeypatch)
    assert (c["local_engine"], passes) == ("bitonic_pair", 0)
    assert out.tobytes() == np.sort(full).tobytes()

    out, passes, c = _run_port(torch.from_numpy(window), monkeypatch)
    assert (c["local_engine"], passes) == ("bitonic_1w1", 0)
    assert out.tobytes() == np.sort(window).tobytes()


def test_radix_pallas_pair_shortcut_outside_envelope(small_envelope, monkeypatch):
    """Past the envelope the host constant-word shortcut's one-word sort
    resolves to lax: the counter stays ``bitonic_1w1``, no K4 pass."""
    x = np.random.default_rng(3).integers(5 << 32, 6 << 32, N, dtype=np.int64)
    out, passes, c = _run_port(x, monkeypatch)
    assert (c["local_engine"], passes) == ("bitonic_1w1", 0)
    assert out.tobytes() == np.sort(x).tobytes()
