"""The supervisor and the degradation ladder of the distributed sort
(``models/supervisor.py``, ``models/api.py``) against the reference's, on
eight CPU ranks and the reference's 8-virtual-device mesh — the port's
twin of ``tests/test_supervisor_faults.py``.

Per cell (device fault site x algorithm x exchange engine, plus the
persistent and fallback-off cells) both packages run the same input
under a registry of the same spec and seed, and must agree on the
outcome class (a verified result, ``SortRetryExhausted`` or
``SortIntegrityError``), the output bytes, the registry's ``fired`` list
and the robustness counters.  The engines are passed explicitly:
``pallas`` (the reference's interpreter form on the CPU) and ``lax`` with
the plain scatter pack (``pack="xla"``, 128-aligned caps in both, so
``cap_squeeze`` really overflows at these sizes).  Inputs are odd sizes
no other test compiles.

Also pinned: which failures the ladder absorbs (``DeviceDispatchError``
and ``torch.cuda.OutOfMemoryError``) and which propagate untouched
(``KernelLaunchError``, ``KernelBuildError``, any other error); the
ladder of CUDA ranks, which descends only on ``DeviceDispatchError``; the
one-rank path, where the dispatch sites fire nothing; the extra ``auto``
rung of the port on the CPU; donated words rebuilt for a retry; the host
rung.  ``cuda``-marked twins of the full-width cells skip here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mpitest_tpu as ref_mt
import mpitest_tpu_torch as mt
from mpitest_tpu import faults as ref_faults
from mpitest_tpu.models import api as ref_api
from mpitest_tpu.parallel.mesh import make_mesh as ref_mesh
from mpitest_tpu.utils.trace import Tracer as RefTracer
from mpitest_tpu_torch import faults
from mpitest_tpu_torch.models import api
from mpitest_tpu_torch.models import supervisor as supervision
from mpitest_tpu_torch.ops import _build, radix
from mpitest_tpu_torch.ops import exchange as xeng
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.utils.trace import Tracer

N = 20_011
KEYS = np.random.default_rng(2011).integers(-(2**31), 2**31 - 1, N, dtype=np.int32)
COUNTERS = ("faults_injected", "faults_dropped", "sort_retries", "verify_runs",
            "verify_failures", "exchange_retries", "exchange_engine_degraded",
            "local_engine_degraded", "degraded_to", "local_engine",
            "exchange_engine")
_NAMES = {"pallas_interpret": "pallas", "radix_pallas_interpret": "radix_pallas"}
DEVICE_SITES = ("dispatch_error", "dispatch_oom", "dispatch_stall",
                "exchange_corrupt", "exchange_drop", "cap_squeeze",
                "ingest_poison", "result_swap", "result_dup")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and the plain versions' many small ops otherwise spin on each other's
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _robust_env(monkeypatch):
    monkeypatch.setenv("SORT_RETRY_BACKOFF", "0")
    monkeypatch.setenv("SORT_FAULT_STALL_MS", "1")
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "lax")
    monkeypatch.setenv("SORT_NATIVE_ENCODE", "off")
    yield
    faults.install(None)
    ref_faults.install(None)


def _cpu_mesh(P):
    return make_mesh(P, devices=["cpu"] * P)


def _outcome(fn):
    try:
        return "verified", fn().to_numpy().tobytes()
    except (mt.SortIntegrityError, mt.SortRetryExhausted,
            ref_mt.SortIntegrityError, ref_mt.SortRetryExhausted) as e:
        return type(e).__name__, None


def _counters(tr):
    return {k: _NAMES.get(tr.counters.get(k), tr.counters.get(k)) for k in COUNTERS}


def _cell(spec, algo, engine, x=KEYS, P=8, seed=7, ref_x=None, **sort_kw):
    """Run ``x`` through both packages under ``spec``; returns
    ((outcome, bytes, fired, counters) port, (...) reference)."""
    kw = dict(exchange_engine=engine, **sort_kw)
    if engine == "lax":
        kw.setdefault("pack", "xla")
    out = []
    for pkg, mod, tracer, mesh, sort in (
            ("ref", ref_faults, RefTracer(), ref_mesh(P), ref_mt.sort),
            ("port", faults, Tracer(), _cpu_mesh(P), mt.sort)):
        reg = mod.FaultRegistry(spec, seed=seed)
        mod.install(reg)
        xin = ref_x if (pkg == "ref" and ref_x is not None) else x
        try:
            res = _outcome(lambda: sort(xin, algorithm=algo, mesh=mesh, tracer=tracer,
                                        return_result=True, **kw))
        finally:
            mod.install(None)
        out.append((*res, reg.fired, _counters(tracer)))
    ref, port = out
    return port, ref


def _assert_same(port, ref):
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]


@pytest.mark.parametrize("engine", ["pallas", "lax"])
@pytest.mark.parametrize("algo", ["radix", "sample"])
@pytest.mark.parametrize("site", DEVICE_SITES)
def test_device_site_grid_equals_reference(site, algo, engine, monkeypatch):
    if site == "ingest_poison":
        monkeypatch.setenv("SORT_INGEST", "stream")
        monkeypatch.setenv("SORT_INGEST_CHUNK", "4096")
    port, ref = _cell(site, algo, engine)
    _assert_same(port, ref)
    assert port[0] == "verified" and port[1] == np.sort(KEYS).tobytes()
    assert [s for s, _ in port[2]] == [site]
    c = port[3]
    if site in ("dispatch_error", "dispatch_oom"):
        assert c["sort_retries"] == 1 and c["verify_failures"] is None
    elif site in ("exchange_corrupt", "exchange_drop", "ingest_poison",
                  "result_swap", "result_dup"):
        assert c["verify_failures"] == 1 and c["verify_runs"] == 2
    elif site == "cap_squeeze" and engine == "lax":
        assert c["exchange_retries"] >= 1


@pytest.mark.parametrize("engine", ["pallas", "lax"])
@pytest.mark.parametrize("algo", ["radix", "sample"])
@pytest.mark.parametrize("spec,fallback,expect", [
    ("dispatch_oom:inf", "1", "verified"),
    ("dispatch_oom:inf", "0", "SortRetryExhausted"),
    ("result_dup:inf", "0", "SortIntegrityError"),
    ("result_dup:inf", "1", "verified"),
    ("dispatch_error:2,exchange_corrupt:3,cap_squeeze", "1", "verified"),
])
def test_persistent_and_fallback_cells_equal_reference(spec, fallback, expect, algo,
                                                       engine, monkeypatch):
    monkeypatch.setenv("SORT_FALLBACK", fallback)
    port, ref = _cell(spec, algo, engine, x=KEYS[:-6])
    _assert_same(port, ref)
    assert port[0] == expect
    if expect == "verified":
        assert port[1] == np.sort(KEYS[:-6]).tobytes()
    if spec.endswith(":inf") and fallback == "1":
        assert port[3]["degraded_to"] == "host"
        assert port[3]["exchange_engine_degraded"] == (1 if engine == "pallas" else None)


def test_armed_exchange_fault_is_dropped_when_its_dispatch_dies(monkeypatch):
    port, ref = _cell("dispatch_error,exchange_corrupt", "radix", "pallas",
                      x=KEYS[:-17])
    _assert_same(port, ref)
    assert port[3]["faults_dropped"] == 1 and port[3]["verify_failures"] is None
    assert not faults._PENDING_EXCHANGE


@pytest.mark.parametrize("spec", ["dispatch_error:inf,dispatch_oom,dispatch_stall",
                                  "exchange_corrupt,exchange_drop,cap_squeeze,"
                                  "result_swap,result_dup"])
def test_one_rank_paths_fire_no_dispatch_site(spec):
    """The one-rank paths keep no ladder and poll no dispatch, exchange or
    result site, in either package."""
    port, ref = _cell(spec, "radix", "pallas", P=1)
    _assert_same(port, ref)
    assert port[0] == "verified" and port[2] == []


def test_fused_local_engine_rung_equals_reference(monkeypatch):
    """A failing fused radix kernel (``radix_pallas``) degrades only the
    local engine; with the ladder off it is SortRetryExhausted."""
    from mpitest_tpu.ops import radix_pallas as rp

    import jax

    def ref_boom(*a, **k):
        raise jax.errors.JaxRuntimeError("INTERNAL: injected fused local-sort fault")

    def boom(*a, **k):
        raise faults.DeviceDispatchError("INTERNAL: injected fused local-sort fault")

    monkeypatch.setattr(rp, "fused_radix_sort", ref_boom)
    monkeypatch.setattr(radix, "fused_radix_sort", boom)
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    monkeypatch.setenv("SORT_MAX_RETRIES", "0")
    x = np.random.default_rng(31337).integers(-(2**31), 2**31 - 1, 31_337,
                                             dtype=np.int32)
    port, ref = _cell("", "radix", "pallas", x=x)
    _assert_same(port, ref)
    assert port[0] == "verified" and port[1] == np.sort(x).tobytes()
    assert port[3]["local_engine_degraded"] == 1 and port[3]["local_engine"] == "lax"
    assert port[3]["exchange_engine_degraded"] is None
    monkeypatch.setenv("SORT_FALLBACK", "0")
    y = np.random.default_rng(7771).integers(0, 100, 7_771, dtype=np.int32)
    port, ref = _cell("", "radix", "pallas", x=y)
    _assert_same(port, ref)
    assert port[0] == "SortRetryExhausted"


# ------------------------------------------------ what the ladder absorbs

def _launch_refused(*a, **k):
    raise _build.KernelLaunchError("CUDA kernel pack_rows failed: invalid argument (code 1)")


def _build_refused(*a, **k):
    raise _build.KernelBuildError("nvcc failed on csrc/exchange.cu (rc=1)")


def _generic(*a, **k):
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


def _dispatch(*a, **k):
    raise faults.DeviceDispatchError("INTERNAL: pack dispatch failed")


def _oom(*a, **k):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


@pytest.mark.parametrize("raiser,typ", [(_launch_refused, _build.KernelLaunchError),
                                        (_build_refused, _build.KernelBuildError),
                                        (_generic, RuntimeError)],
                         ids=["KernelLaunchError", "KernelBuildError", "RuntimeError"])
@pytest.mark.parametrize("algo", ["radix", "sample"])
def test_kernel_failures_propagate_unretried_and_undegraded(raiser, typ, algo,
                                                            monkeypatch):
    """With the ladder on, a kernel that fails to build or launch (and any
    error but the two transient ones) leaves sort() where it broke: no
    retry, no degraded engine, no host result."""
    monkeypatch.setenv("SORT_FALLBACK", "1")
    monkeypatch.setattr(xeng, "fused_pass_pack", raiser)
    tr = Tracer()
    with pytest.raises(typ) as ei:
        mt.sort(KEYS[:-29], algorithm=algo, mesh=_cpu_mesh(8), tracer=tr,
                exchange_engine="pallas")
    assert type(ei.value) is typ
    for c in ("sort_retries", "exchange_engine_degraded", "local_engine_degraded",
              "degraded_to", "verify_failures"):
        assert c not in tr.counters, c


@pytest.mark.parametrize("raiser", [_dispatch, _oom],
                         ids=["DeviceDispatchError", "OutOfMemoryError"])
@pytest.mark.parametrize("algo", ["radix", "sample"])
def test_transient_failures_are_retried_then_degraded(raiser, algo, monkeypatch):
    """DeviceDispatchError and torch.cuda.OutOfMemoryError are retried (the
    budget of 2), then the pallas exchange engine degrades to lax, whose
    pack never calls K6: a verified result on the requested algorithm."""
    monkeypatch.setattr(xeng, "fused_pass_pack", raiser)
    x = KEYS[:-29]
    tr = Tracer()
    got = mt.sort(x, algorithm=algo, mesh=_cpu_mesh(8), tracer=tr,
                  exchange_engine="pallas")
    assert got.tobytes() == np.sort(x).tobytes()
    assert tr.counters["sort_retries"] == 2
    assert tr.counters["exchange_engine_degraded"] == 1
    assert tr.counters["exchange_engine"] == "lax"
    assert "degraded_to" not in tr.counters
    assert sum(1 for s in tr.spans.spans if s.name == "supervisor_retry") == 2
    # every span of the lower rung names it
    assert any(s.attrs.get("rung") == f"{algo}/lax/lax" for s in tr.spans.spans)


@pytest.mark.parametrize("raiser,absorbed", [(_dispatch, True), (_launch_refused, False)],
                         ids=["DeviceDispatchError", "KernelLaunchError"])
def test_failure_outside_the_dispatch(raiser, absorbed, monkeypatch):
    """A device failure outside the supervised dispatch (the sample sort's
    skew sniff of device input) descends when transient, as the
    reference's does, and propagates otherwise."""
    monkeypatch.setattr(api, "_device_skew_sniff", raiser)
    x = torch.from_numpy(KEYS[:-41].copy())
    tr = Tracer()
    if absorbed:
        got = mt.sort(x, algorithm="sample", mesh=_cpu_mesh(8), tracer=tr,
                      exchange_engine="lax")
        assert got.tobytes() == np.sort(KEYS[:-41]).tobytes()
        assert tr.counters["degraded_to"] == "radix" and tr.counters["sort_retries"] == 1
    else:
        with pytest.raises(_build.KernelLaunchError):
            mt.sort(x, algorithm="sample", mesh=_cpu_mesh(8), tracer=tr,
                    exchange_engine="lax")
        assert "degraded_to" not in tr.counters


# ------------------------------------------ the ladder on a mesh of cards

def test_strict_ladder_is_the_rule_off_the_cpu():
    assert not supervision.strict_ladder("cpu")
    assert supervision.strict_ladder("cuda")


def _strict_cell(monkeypatch, spec="", raiser=None, where="dispatch", **sort_kw):
    """Run the ladder as it runs on CUDA ranks (strict_ladder true) on
    eight CPU ranks; returns (outcome, error or bytes, tracer)."""
    monkeypatch.setattr(supervision, "strict_ladder", lambda dev_type: True)
    if raiser is not None and where == "dispatch":
        monkeypatch.setattr(xeng, "fused_pass_pack", raiser)
    elif raiser is not None:
        monkeypatch.setattr(api, "_device_skew_sniff", raiser)
    faults.install(faults.FaultRegistry(spec, seed=7) if spec else None)
    x = KEYS[:-43]
    src = torch.from_numpy(x.copy()) if where == "sniff" else x
    tr = Tracer()
    try:
        got = mt.sort(src, mesh=_cpu_mesh(8), tracer=tr, exchange_engine="pallas",
                      **sort_kw)
    except (mt.SortIntegrityError, mt.SortRetryExhausted) as e:
        return type(e).__name__, e, tr
    assert got.tobytes() == np.sort(x).tobytes()
    return "verified", None, tr


_DEGRADED = ("exchange_engine_degraded", "local_engine_degraded", "degraded_to")


@pytest.mark.parametrize("algo", ["radix", "sample"])
def test_strict_ladder_ends_a_real_oom_on_its_rung(algo, monkeypatch):
    """On CUDA ranks a real OOM is retried on the same kernels, then ends
    in SortRetryExhausted: no rung swaps in the plain pack or the host."""
    out, err, tr = _strict_cell(monkeypatch, raiser=_oom, algorithm=algo)
    assert out == "SortRetryExhausted"
    assert isinstance(err.__cause__, torch.cuda.OutOfMemoryError)
    assert tr.counters["sort_retries"] == 2
    assert not [c for c in _DEGRADED if c in tr.counters]


def test_strict_ladder_ends_a_real_oom_outside_the_dispatch(monkeypatch):
    out, err, tr = _strict_cell(monkeypatch, raiser=_oom, where="sniff",
                                algorithm="sample")
    assert out == "SortRetryExhausted"
    assert isinstance(err.__cause__, torch.cuda.OutOfMemoryError)
    assert not [c for c in _DEGRADED + ("sort_retries",) if c in tr.counters]


@pytest.mark.parametrize("algo", ["radix", "sample"])
def test_strict_ladder_ends_a_twice_failed_verification_on_its_rung(algo, monkeypatch):
    """A result that fails its verification and its retry ends in
    SortIntegrityError on CUDA ranks; one failure is still re-run."""
    out, _, tr = _strict_cell(monkeypatch, "result_dup:2", algorithm=algo)
    assert out == "SortIntegrityError"
    assert tr.counters["verify_failures"] == 2
    assert not [c for c in _DEGRADED if c in tr.counters]
    faults.install(None)
    out, _, tr = _strict_cell(monkeypatch, "result_dup:1", algorithm=algo)
    assert out == "verified" and tr.counters["verify_failures"] == 1


@pytest.mark.parametrize("spec,raiser,descents", [
    ("", _oom, None), ("result_dup:2", None, None),
    ("dispatch_oom:inf", None, 2.0),
], ids=["real-oom", "twice-failed-verify", "dispatch_oom:inf"])
def test_strict_ladder_plan_counts_only_real_descents(spec, raiser, descents,
                                                      monkeypatch):
    """W6: on CUDA ranks (strict ladder, run here on CPU ranks) a real OOM
    or a twice-failed verification ends on its rung, and the plan record
    says so: the ladder stays on its first rung with no descent counted,
    and the retries are its regret; an injected DeviceDispatchError still
    descends, and each descent is counted."""
    out, _, tr = _strict_cell(monkeypatch, spec, raiser, algorithm="radix")
    ladder = tr.plan.to_attrs()["decisions"]["ladder"]
    assert ladder.get("actual", {}).get("rungs_descended") == descents
    if descents is None:
        assert out != "verified" and ladder["chosen"] == "radix"
        assert tr.plan.digest()["exchange_engine"] == "pallas"
        retries = tr.counters.get("sort_retries", 0)
        assert ladder.get("actual", {}).get("dispatch_retries", 0) == retries
        assert tr.plan.digest()["regret"] >= float(retries)
    else:
        assert out == "verified" and ladder["chosen"] == "host"
        assert tr.counters["plan_regret"] == tr.plan.digest()["regret"]


@pytest.mark.parametrize("spec,raiser,counters", [
    ("", _dispatch, {"exchange_engine_degraded": 1, "sort_retries": 2}),
    ("dispatch_oom:inf", None, {"exchange_engine_degraded": 1, "degraded_to": "host"}),
    ("dispatch_error:3", None, {"exchange_engine_degraded": 1, "sort_retries": 2}),
], ids=["DeviceDispatchError", "dispatch_oom:inf", "dispatch_error:3"])
def test_strict_ladder_descends_on_dispatch_errors(spec, raiser, counters, monkeypatch):
    """DeviceDispatchError, which only the fault sites and drills raise,
    still walks the whole ladder on CUDA ranks."""
    out, _, tr = _strict_cell(monkeypatch, spec, raiser, algorithm="radix")
    assert out == "verified"
    for k, v in counters.items():
        assert tr.counters.get(k) == v, k


# ------------------------------------------------------- port differences

def test_auto_engine_has_one_more_rung_on_the_cpu(monkeypatch):
    """``SORT_EXCHANGE_ENGINE=auto`` is ``pallas`` in the port everywhere,
    ``lax`` in the reference off a TPU: under a dead dispatch the port
    descends through one more rung (three more injected failures)."""
    monkeypatch.delenv("SORT_EXCHANGE_ENGINE", raising=False)
    port, ref = _cell("dispatch_oom:inf", "radix", None, x=KEYS[:-3])
    assert port[0] == ref[0] == "verified" and port[1] == ref[1]
    assert port[3]["exchange_engine_degraded"] == 1
    assert ref[3]["exchange_engine_degraded"] is None
    assert len(port[2]) == len(ref[2]) + 3 == 9


def _plan_view(tr):
    """The run's plan record (the ``sort.plan`` attrs, or the unfinished
    record a typed error left on the tracer) and its digest, with the
    reference's interpreter engine names mapped to the port's."""
    def norm(v):
        if isinstance(v, dict):
            return {k: norm(w) for k, w in v.items()}
        return _NAMES.get(v, v) if isinstance(v, str) else v
    return norm(tr.plan.to_attrs()), norm(tr.plan.digest())


@pytest.mark.parametrize("spec,algo", [
    ("dispatch_error", "radix"), ("dispatch_error", "sample"),
    ("cap_squeeze", "radix"), ("result_dup", "sample"),
    ("dispatch_oom:inf", "radix"), ("exchange_corrupt:2", "radix"),
], ids=["retry-radix", "retry-sample", "regrow", "reverify", "descent", "two-rungs"])
def test_plan_stamps_equal_reference(spec, algo):
    """The supervisor's and the ladder's stamps (dispatch retries, regrows,
    verify failures, rung descents with their triggers) give the same
    ``sort.plan`` attrs and digest as the reference's on CPU ranks."""
    x = KEYS[:-5]
    out = []
    for pkg, mod, tr, mesh, sort in (
            ("ref", ref_faults, RefTracer(), ref_mesh(8), ref_mt.sort),
            ("port", faults, Tracer(), _cpu_mesh(8), mt.sort)):
        mod.install(mod.FaultRegistry(spec, seed=7))
        try:
            got = sort(x, algorithm=algo, mesh=mesh, tracer=tr,
                       exchange_engine="lax", pack="xla")
        finally:
            mod.install(None)
        assert got.tobytes() == np.sort(x).tobytes()
        out.append((_plan_view(tr), [s.name for s in tr.spans.spans].count("sort.plan")))
    (ref_view, ref_n), (port_view, port_n) = out
    assert port_n == ref_n == 1
    assert port_view == ref_view
    attrs, digest = port_view
    if spec == "dispatch_error":
        assert attrs["decisions"]["ladder"]["actual"] == {"dispatch_retries": 1.0}
    if spec == "dispatch_oom:inf":
        assert digest["algo"] == "radix" and attrs["decisions"]["ladder"]["chosen"] == "host"
        assert attrs["decisions"]["ladder"]["actual"]["rungs_descended"] == 2.0


# ---------------------------------------------------------- rung mechanics

@pytest.mark.parametrize("inp", ["host", "device", "staged"])
def test_donated_words_are_rebuilt_for_the_retry(inp, monkeypatch):
    monkeypatch.setenv("SORT_DONATE", "1")
    x = KEYS[:-11]
    src = torch.from_numpy(x.copy()) if inp == "device" else x
    mesh = _cpu_mesh(8)
    if inp == "staged":
        monkeypatch.setenv("SORT_INGEST_CHUNK", "4096")
        src = api.ingest_to_mesh(x, mesh)
    faults.install(faults.FaultRegistry("dispatch_error"))
    tr = Tracer()
    got = mt.sort(src, mesh=mesh, tracer=tr, exchange_engine="pallas")
    assert got.tobytes() == np.sort(x).tobytes()
    assert tr.counters["sort_retries"] == 1 and "verify_failures" not in tr.counters
    if inp == "staged":
        assert src.consumed


def test_host_rung_is_canonical_for_floats(monkeypatch):
    rng = np.random.default_rng(997)
    x = np.concatenate([(rng.standard_normal(997) * 1e3).astype(np.float32),
                        np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf],
                                 np.float32)])
    clean = mt.sort(x, mesh=_cpu_mesh(8))
    port, ref = _cell("dispatch_oom:inf", "radix", "pallas", x=x)
    _assert_same(port, ref)
    assert port[3]["degraded_to"] == "host" and port[1] == clean.tobytes()


def test_host_rung_result_stays_on_the_mesh():
    x = KEYS[:-13]
    faults.install(faults.FaultRegistry("dispatch_oom:inf"))
    tr = Tracer()
    res = mt.sort(x, mesh=_cpu_mesh(8), tracer=tr, return_result=True,
                  exchange_engine="lax")
    assert tr.counters["degraded_to"] == "host" and len(res.shards) == 8
    assert res.to_numpy().tobytes() == np.sort(x).tobytes()


def test_host_rung_needs_the_staged_source(monkeypatch):
    x = KEYS[:-19]
    st = api.ingest_to_mesh(x, _cpu_mesh(8))
    ref_st = ref_api.ingest_to_mesh(x, mesh=ref_mesh(8))
    st.source = None
    ref_st.source = None
    port, ref = _cell("dispatch_oom:inf", "radix", "lax", x=st, ref_x=ref_st)
    assert port[0] == ref[0] == "SortIntegrityError"
    assert port[3] == ref[3] and port[2] == ref[2]


def test_failed_sort_dumps_the_flight_ring_and_counts_descents(monkeypatch, tmp_path):
    from mpitest_tpu_torch.utils import flight_recorder as fr

    monkeypatch.setenv("SORT_FLIGHT_RECORDER_DIR", str(tmp_path))
    fr.reset()
    try:
        faults.install(faults.FaultRegistry("result_dup:inf"))
        tr = Tracer()
        got = mt.sort(KEYS[:-23], mesh=_cpu_mesh(8), tracer=tr, exchange_engine="pallas")
        assert got.tobytes() == np.sort(KEYS[:-23]).tobytes()
        names = sorted(p.name for p in tmp_path.iterdir())
        # one dump per firing site and one per descent (pallas -> lax, the
        # other algorithm, the host)
        assert sum("fault_result_dup" in n for n in names) == 1
        assert sum("ladder_" in n for n in names) == 3
        assert tr.counters["verify_failures"] == 6
    finally:
        fr.reset()


# ----------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the full-width cells run the CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec,algo,counter", [
    ("dispatch_error", "radix", "sort_retries"),
    ("exchange_corrupt", "sample", "verify_failures"),
    ("result_dup", "radix", "verify_failures"),
])
def test_full_width_cell_on_the_card(card, spec, algo, counter, monkeypatch):
    """int32 2^28 on eight ranks of the card: the fault ends verified and
    byte-equal to torch.sort, counted once."""
    monkeypatch.delenv("SORT_LOCAL_ENGINE")
    g = torch.Generator(device=card).manual_seed(28)
    xd = torch.randint(-(2**31), 2**31, (1 << 28,), dtype=torch.int32, device=card,
                       generator=g)
    want = torch.sort(xd).values.cpu().numpy()
    x = xd.cpu().numpy()
    del xd
    faults.install(faults.FaultRegistry(spec, seed=7))
    tr = Tracer()
    got = mt.sort(x, algorithm=algo, mesh=make_mesh(8), tracer=tr)
    assert got.tobytes() == want.tobytes()
    assert tr.counters[counter] == 1 and tr.counters["faults_injected"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["radix", "sample"])
def test_card_ladder_ends_on_its_rung(card, algo, monkeypatch):
    """On eight ranks of the card a twice-failed verification ends in
    SortIntegrityError and a real OOM in SortRetryExhausted; neither
    descends to a plain version or the host."""
    x = KEYS[:-47]
    faults.install(faults.FaultRegistry("result_dup:2", seed=7))
    tr = Tracer()
    with pytest.raises(mt.SortIntegrityError):
        mt.sort(x, algorithm=algo, mesh=make_mesh(8), tracer=tr)
    assert not [c for c in _DEGRADED if c in tr.counters]
    faults.install(None)
    monkeypatch.setattr(xeng, "fused_pass_pack", _oom)
    tr = Tracer()
    with pytest.raises(mt.SortRetryExhausted):
        mt.sort(x, algorithm=algo, mesh=make_mesh(8), tracer=tr)
    assert tr.counters["sort_retries"] == 2
    assert not [c for c in _DEGRADED if c in tr.counters]
    # W6: the unfinished plan record says what happened and counts no
    # descent: first rung, the two retries as the ladder's regret
    ladder = tr.plan.to_attrs()["decisions"]["ladder"]
    assert ladder["chosen"] == algo and ladder["actual"] == {"dispatch_retries": 2.0}
    assert tr.plan.digest()["exchange_engine"] == "pallas"
