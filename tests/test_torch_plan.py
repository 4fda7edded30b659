"""Plan provenance (``mpitest_tpu_torch/models/plan.py`` and its stamps in
``models/api.py``, ``models/supervisor.py`` and ``store/external.py``)
against the reference's.

The pure layer: the regret rule and :class:`SortPlan` give equal records
and digests over the same call sequences; the profilers are equal on
seeded arrays of every dtype; ``fold_decision_stats`` is equal.  The
stamps: the ``sort.plan`` attrs and ``digest()`` of ``sort()`` equal the
reference's for every route (one rank with host, device and staged
input; radix and sample on eight CPU ranks, the reference on its cpu:8
mesh, with uniform and skewed input and a regrow forced by a low cap
factor; the external sort's ``external`` decision), a record sort mints
no plan, and a reused tracer carries no stranger's plan.  The
reference's interpreter engine names map to the port's
(``pallas_interpret`` -> ``pallas``).  Float fields are compared after
``_scalar``'s 6-digit rounding; the one wall-time field,
``external.actual.disk_overlap``, is left out.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

import mpitest_tpu as ref_mt
import mpitest_tpu_torch as mt
from mpitest_tpu.models import api as ref_api
from mpitest_tpu.models import plan as ref_plan
from mpitest_tpu.parallel.mesh import make_mesh as ref_mesh
from mpitest_tpu.store import external as ref_external
from mpitest_tpu.utils.trace import Tracer as RefTracer
from mpitest_tpu_torch.models import api
from mpitest_tpu_torch.models import plan
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.store import external
from mpitest_tpu_torch.utils.trace import Tracer

DTYPES = ("int8", "uint8", "int16", "uint16", "int32", "uint32", "int64",
          "uint64", "float32", "float64")
_NAMES = {"pallas_interpret": "pallas", "radix_pallas_interpret": "radix_pallas"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the reference's auto engine is lax off a TPU; pin it in both
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "lax")
    monkeypatch.setenv("SORT_NATIVE_ENCODE", "off")
    monkeypatch.delenv("SORT_PLAN", raising=False)
    monkeypatch.delenv("SORT_PLANNER", raising=False)


def _norm(v):
    if isinstance(v, dict):
        return {k: _norm(w) for k, w in v.items()}
    if isinstance(v, list):
        return [_norm(w) for w in v]
    return _NAMES.get(v, v) if isinstance(v, str) else v


def _view(tr):
    """(sort.plan attrs, digest, number of sort.plan spans) of a run."""
    n = [s.name for s in tr.spans.spans].count("sort.plan")
    return _norm(tr.plan.to_attrs()), _norm(tr.plan.digest()), n


def _cpu_mesh(p):
    return make_mesh(p, devices=["cpu"] * p)


# ------------------------------------------------------------ the pure layer

def test_constants_equal_reference():
    assert plan.PLAN_SCHEMA == ref_plan.PLAN_SCHEMA
    assert plan.PLAN_PROFILE_FIELDS == ref_plan.PLAN_PROFILE_FIELDS
    assert plan.PROFILE_SAMPLE == ref_plan.PROFILE_SAMPLE


@pytest.mark.parametrize("p,a", [(0, 0), (1, 0), (0.5, 0.25), (100, 90), (90, 100),
                                 (-3, 2), (1e9, 1), (7, 7)])
def test_relative_regret_equals_reference(p, a):
    assert plan.relative_regret(p, a) == ref_plan.relative_regret(p, a)


#: call sequences on a fresh plan: (method, args, kwargs)
_SEQUENCES = {
    "cap-exact": [("decide", ("cap",), dict(chosen=1024, trigger="exact", cap=1024,
                                           need=700, fair=512)),
                  ("actual", ("cap",), dict(cap=1024, need=901))],
    "cap-off": [("decide", ("cap",), dict(chosen=256, trigger="off", cap=256,
                                         fair=128)),
                ("actual", ("cap",), dict(need=1000)),
                ("bump", ("cap", "regrows"), {}), ("bump", ("cap", "regrows"), {})],
    "restage": [("decide", ("restage",), dict(chosen=True, trigger="probe",
                                             peer_ratio=5.0)),
                ("actual", ("restage",), dict(peer_ratio=6.0))],
    "late-reroute": [("decide", ("algo",), dict(chosen="sample", requested="sample")),
                     ("decide", ("algo",), dict(chosen="radix", trigger="cap_exceeded")),
                     ("actual", ("algo",), dict(late_reroute=True))],
    "passes-lied": [("decide", ("passes",), dict(chosen=2, trigger="planner", passes=2)),
                    ("decide", ("passes",), dict(chosen=3, digit_bits=8)),
                    ("actual", ("passes",), dict(passes=3))],
    "ladder": [("decide", ("ladder",), dict(chosen="radix")),
               ("bump", ("ladder", "dispatch_retries"), {}),
               ("decide", ("ladder",), dict(chosen="host")),
               ("bump", ("ladder", "rungs_descended"), {})],
    "batch": [("decide", ("batch",), dict(chosen=4096, waste=0.1)),
              ("actual", ("batch",), dict(waste=0.7))],
    "engines": [("decide", ("engine",), dict(chosen="pallas")),
                ("decide", ("engine",), dict(chosen="pallas", trigger="pallas_fault")),
                ("actual", ("engine",), dict(fallbacks=2, backend="cpu")),
                ("decide", ("exchange_engine",), dict(chosen="lax",
                                                      trigger="verify_failure"))],
    "planner-miss": [("decide", ("planner",), dict(chosen="verify_passthrough",
                                                   requested="static", trigger="sorted",
                                                   applied=True, margin=1.25)),
                     ("actual", ("planner",), dict(misses=1))],
    "external": [("decide", ("external",), dict(chosen="spill", trigger="budget",
                                               budget=4096, fanin=4)),
                 ("actual", ("external",), dict(runs=9, resumed=2)),
                 ("bump", ("external", "recoveries"), {"amount": 2.0})],
    "numpy-scalars": [("decide", ("cap",), dict(chosen=np.int64(512), cap=np.int64(512),
                                               need=np.float32(1.5), fair=np.uint32(3))),
                      ("actual", ("cap",), dict(need=np.float64(1 / 3)))],
    "thrash": [("decide", ("cap",), dict(chosen=128, cap=128)),
               ("actual", ("cap",), dict(regrows=3, cap=310))],
    "unmade": [("actual", ("ladder",), dict(misses=1))],
}


@pytest.mark.parametrize("name", sorted(_SEQUENCES))
def test_sort_plan_equals_reference_over_call_sequences(name):
    plans = []
    for mod in (plan, ref_plan):
        p = mod.SortPlan(algo="sample", n=1000, dtype="int32", ranks=8)
        p.profile.update(sortedness=0.5, dup_ratio=np.float64(0.25))
        for meth, args, kw in _SEQUENCES[name]:
            getattr(p, meth)(*args, **kw)
        plans.append(p)
    mine, ref = plans
    assert mine.algo == ref.algo
    assert mine.to_attrs() == ref.to_attrs()
    assert mine.digest() == ref.digest()
    assert mine.finalize() == ref.finalize()


def _seeded(dtype, kind, n=5000):
    rng = np.random.default_rng(zlib.crc32(f"{dtype}/{kind}".encode()))
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = rng.standard_normal(n).astype(dt)
    else:
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    if kind == "sorted":
        x = np.sort(x)
    elif kind == "reversed":
        x = np.sort(x)[::-1].copy()
    elif kind == "constant":
        x = np.full(n, x[0], dt)
    elif kind == "dups":
        x = x[rng.integers(0, 7, n)]
    elif kind == "narrow" and dt.kind in "iu":
        x = (x % 50).astype(dt)
    elif kind == "tiny":
        x = x[:1]
    elif kind == "empty":
        x = x[:0]
    return x


@pytest.mark.parametrize("kind", ["uniform", "sorted", "reversed", "constant", "dups",
                                  "narrow", "tiny", "empty"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_profile_host_array_equals_reference(dtype, kind):
    x = _seeded(dtype, kind)
    assert plan.profile_host_array(x) == ref_plan.profile_host_array(x)


@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("shape", ["uniform", "skewed", "one-peer", "zero"])
def test_profile_from_counts_equals_reference(p, shape):
    rng = np.random.default_rng(p * 31 + len(shape))
    c = rng.integers(0, 100, (p, p))
    if shape == "skewed":
        c[:, 0] *= 50
    elif shape == "one-peer":
        c[:] = 0
        c[:, -1] = 77
    elif shape == "zero":
        c[:] = 0
    fair = 64
    assert plan.profile_from_counts(c, fair) == ref_plan.profile_from_counts(c, fair)


def test_fold_decision_stats_equals_reference():
    rows = [
        {"decisions": {"cap": {"regret": 0.5}, "algo": {"regret": 0.0}}},
        {"decisions": {"cap": {"regret": 2.25}, "ladder": {"regret": "x"}}},
        {"decisions": "garbage"}, None, {},
        {"decisions": {"cap": "garbage", "planner": {"regret": None}}},
    ]
    assert plan.fold_decision_stats(rows) == ref_plan.fold_decision_stats(rows)


def test_enabled_reads_sort_plan(monkeypatch):
    for v in ("on", "off"):
        monkeypatch.setenv("SORT_PLAN", v)
        assert plan.enabled() == ref_plan.enabled() == (v == "on")


# ------------------------------------------------------------------ stamps

N = 1 << 14


def _keys(kind, n=N, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        x = np.concatenate([np.full(n * 7 // 10, 12345, np.int32),
                            rng.integers(-(2**31), 2**31 - 1, n - n * 7 // 10,
                                         dtype=np.int32)])
        rng.shuffle(x)
        return x
    if kind == "sorted-block":
        # a clustered arrangement of one-pass keys: each rank's block goes
        # to one peer, so the radix probe re-stages it
        return np.sort(rng.integers(0, 1 << 16, n, dtype=np.int32))
    return rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int32)


@pytest.mark.parametrize("form", ["host", "device", "staged", "int64-host"])
def test_one_rank_plan_equals_reference(form):
    x = _keys("uniform", N + 3)
    if form == "int64-host":
        x = x.astype(np.int64) * 65537
    tr, rt = Tracer(), RefTracer()
    if form == "staged":
        src = api.ingest_to_mesh(x, mesh=_cpu_mesh(1), chunk_elems=4096)
        ref_src = ref_api.ingest_to_mesh(x, mesh=ref_mesh(1), chunk_elems=4096)
    elif form == "device":
        import jax.numpy as jnp

        src, ref_src = torch.from_numpy(x.copy()), jnp.asarray(x)
    else:
        src = ref_src = x
    kw = {} if form == "staged" else {"device": "cpu"}
    got = mt.sort(src, tracer=tr, **kw)
    want = ref_mt.sort(ref_src, tracer=rt, mesh=ref_mesh(1))
    assert got.tobytes() == want.tobytes()
    assert _view(tr) == _view(rt)
    attrs, digest, n = _view(tr)
    assert n == 1 and attrs["ranks"] == 1
    assert attrs["decisions"]["ladder"]["chosen"] == "local"
    if form != "staged":   # the staged route records no local engine
        assert attrs["decisions"]["engine"]["actual"]["backend"] == "cpu"
    assert ("sortedness" in attrs["profile"]) == form.endswith("host")
    assert tr.counters["plan_regret"] == digest["regret"]


@pytest.mark.parametrize("algo,kind,cap_factor", [
    ("radix", "uniform", 2.0), ("sample", "uniform", 2.0),
    ("radix", "skewed", 2.0), ("sample", "skewed", 2.0),
    ("radix", "sorted-block", 2.0), ("sample", "uniform", 0.05),
], ids=["radix", "sample", "radix-skewed", "sample-sniffed", "radix-restaged",
        "sample-regrow"])
def test_mesh_plan_equals_reference(algo, kind, cap_factor, monkeypatch):
    """Eight ranks: cap, restage, passes, engines, ladder and the probe's
    profile; a low cap factor with negotiation off forces regrows (on the
    lax engine with the plain pack, whose caps are 128-aligned in both)."""
    kw = {"exchange_engine": "pallas"}
    ref_kw = {"exchange_engine": "pallas_interpret"}
    if cap_factor < 1:
        monkeypatch.setenv("SORT_NEGOTIATE", "off")
        kw = ref_kw = {"exchange_engine": "lax", "pack": "xla"}
    x = _keys(kind, N + 5)
    tr, rt = Tracer(), RefTracer()
    got = mt.sort(x, algorithm=algo, mesh=_cpu_mesh(8), tracer=tr,
                  cap_factor=cap_factor, **kw)
    want = ref_mt.sort(x, algorithm=algo, mesh=ref_mesh(8), tracer=rt,
                       cap_factor=cap_factor, **ref_kw)
    assert got.tobytes() == want.tobytes()
    assert _view(tr) == _view(rt)
    attrs, digest, n = _view(tr)
    assert n == 1 and attrs["ranks"] == 8
    if kind == "skewed" and algo == "sample":
        assert attrs["decisions"]["algo"]["trigger"] == "skew_sniff"
        assert digest["algo"] == "radix"
    if kind == "sorted-block":
        assert digest["restaged"] is True
    if cap_factor < 1:
        assert attrs["decisions"]["cap"]["actual"]["regrows"] >= 1
        assert attrs["decisions"]["cap"]["trigger"] == "off"


def test_record_sort_mints_no_plan():
    """The record path clears a reused tracer's earlier plan and emits no
    ``sort.plan``, as in the reference."""
    x = _keys("uniform", 2000)
    pay = np.arange(2000, dtype=np.uint32)
    tr, rt = Tracer(), RefTracer()
    mt.sort(x, tracer=tr, device="cpu")
    ref_mt.sort(x, tracer=rt, mesh=ref_mesh(1))
    assert tr.plan is not None and rt.plan is not None
    tr.spans.spans.clear()
    rt.spans.spans.clear()
    mt.sort(x, payload=pay, tracer=tr, device="cpu")
    ref_mt.sort(x, payload=pay, tracer=rt)
    assert tr.plan is None and rt.plan is None
    assert "sort.plan" not in {s.name for s in tr.spans.spans}


def test_sort_plan_off_mints_nothing(monkeypatch):
    monkeypatch.setenv("SORT_PLAN", "off")
    tr = Tracer()
    mt.sort(_keys("uniform", 3000), mesh=_cpu_mesh(8), tracer=tr)
    assert tr.plan is None
    assert "sort.plan" not in {s.name for s in tr.spans.spans}
    assert "plan_regret" not in tr.counters


def test_reused_tracer_stamps_per_run_fallbacks():
    """``fallbacks_base``: a tracer reused across runs stamps each run's
    own residual-fallback delta, not the running total."""
    tr = Tracer()
    tr.counters["pair_residual_fallback"] = 3
    mt.sort(_keys("uniform", 3000), tracer=tr, device="cpu")
    assert "fallbacks" not in tr.plan.to_attrs()["decisions"]["engine"].get("actual", {})
    assert tr.plan.fallbacks_base == 3


@pytest.mark.parametrize("n", [0, 1])
def test_tiny_inputs_plan_equals_reference(n):
    x = _keys("uniform", 8)[:n]
    tr, rt = Tracer(), RefTracer()
    mt.sort(x, tracer=tr, mesh=_cpu_mesh(8))
    ref_mt.sort(x, tracer=rt, mesh=ref_mesh(8), exchange_engine="pallas_interpret")
    assert _view(tr)[:2] == _view(rt)[:2]


def _external_view(tr):
    attrs, digest, n = _view(tr)
    attrs["decisions"]["external"]["actual"].pop("disk_overlap")
    return attrs, digest, n


@pytest.mark.parametrize("width", [0, 6])
def test_external_plan_equals_reference(width, tmp_path, monkeypatch):
    monkeypatch.setenv("SORT_SPILL_COMPRESS", "off")
    x = _keys("uniform", 6000)
    pay = (np.random.default_rng(2).integers(0, 256, (6000, width), dtype=np.uint8)
           if width else None)
    tr, rt = Tracer(), RefTracer()
    res = external.external_sort(x, pay, budget=8192, fanin=4,
                                 spill_dir=str(tmp_path / "p"), tracer=tr, device="cpu")
    ref = ref_external.external_sort(x, pay, budget=8192, fanin=4,
                                     spill_dir=str(tmp_path / "r"), tracer=rt)
    assert res.keys.tobytes() == ref.keys.tobytes()
    assert _external_view(tr) == _external_view(rt)
    attrs, digest, n = _external_view(tr)
    assert attrs["algo"] == "external" and digest["spilled"] is True
    assert digest["spill_runs"] == res.runs > 1
