"""``mpitest_tpu_torch.sort(x, device="cpu")`` against ``mpitest_tpu.sort(x)``
on a one-device mesh: byte-identical output and the same routing
(``local_engine`` counter, reroute / fallback counters).

Both run with ``SORT_LOCAL_ENGINE=bitonic`` (the knob has one name in
both packages), so the reference runs its Pallas kernels in interpret
mode and the port walks the same tree with its plain kernel versions.
The reference names the interpret form of its one-word engine
``bitonic_interpret``; the port's is ``bitonic``.
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
    return "bitonic" if eng == "bitonic_interpret" else eng


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
    assert {s.name for s in inner} == {f"phase:{p}" for p in tr.phases} | {"verify"}
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

    def corrupt(words, engine="lax"):
        out = real(words, engine)
        return (out[0].flip(0),) + tuple(out[1:])

    monkeypatch.setattr(kernels, "local_sort", corrupt)
    with pytest.raises(mt.SortIntegrityError):
        mt.sort(_keys(np.int32, 5000), device="cpu")
    monkeypatch.setenv("SORT_VERIFY", "0")
    mt.sort(_keys(np.int32, 5000), device="cpu")  # unverified: no raise


def test_knob_validation(monkeypatch):
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    with pytest.raises(mt.NotPortedError, match="K4"):
        mt.sort(_keys(np.int32, 100), device="cpu")
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
