"""The self-tuning planner (``mpitest_tpu_torch/models/planner.py`` and its
wiring in ``models/api.py``) against the reference's.

Pure functions: ``choose`` over a grid of profiles, ``learned_margin``
over the same planted flight rings (a fresh recorder in each package and
the memo cleared: both are process-global), ``ServeTuner`` over the same
arrival traces.  Wired: ``sort()`` under ``SORT_PLANNER=off``, ``shadow``
and ``on`` over the adversarial mix (sorted, near-sorted, duplicate-heavy,
range-narrow, uniform, and a sorted input with one descent hidden
between the profile's strided samples) at 2^13-2^14, on one CPU rank and
on eight, the reference on its cpu:8 mesh: the bytes, the result's
``Fingerprint``, the ``planner`` decision, the ``planner_*`` counters and
the plan digest.  ``SORT_LOCAL_ENGINE=lax`` in both (the reference's
``auto`` off a TPU).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import mpitest_tpu as ref_mt
import mpitest_tpu_torch as mt
from mpitest_tpu.models import planner as ref_planner
from mpitest_tpu.models import verify as ref_vfy
from mpitest_tpu.parallel.mesh import make_mesh as ref_mesh
from mpitest_tpu.utils import flight_recorder as ref_flight
from mpitest_tpu.utils.trace import Tracer as RefTracer
from mpitest_tpu_torch.models import api, plan, planner, verify
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.utils import flight_recorder, io as kio
from mpitest_tpu_torch.utils.trace import Tracer

_NAMES = {"pallas_interpret": "pallas", "radix_pallas_interpret": "radix_pallas"}
_COUNTERS = ("planner", "planner_policy", "planner_passthrough",
             "planner_passthrough_miss", "sample_skew_fallback")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """A fresh flight ring in each package and no memoized margin, so the
    margin policy learns from this test's runs alone."""
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "lax")
    monkeypatch.setenv("SORT_NATIVE_ENCODE", "off")
    for mod in (flight_recorder, ref_flight):
        rec = mod.FlightRecorder(256, str(tmp_path))
        monkeypatch.setattr(mod, "get", lambda rec=rec: rec)
    for mod in (planner, ref_planner):
        monkeypatch.setattr(mod, "_margin_memo", None)


def _norm(v):
    if isinstance(v, dict):
        return {k: _norm(w) for k, w in v.items()}
    return _NAMES.get(v, v) if isinstance(v, str) else v


# ------------------------------------------------------------- algo policy

_GRID = list(itertools.product(
    (None, 0.0, 0.5, 0.89, 0.9, 0.95, 0.999, 1.0),      # sortedness
    (None, 0.0, 0.1, 0.2499, 0.25, 0.5, 1.0),            # dup_ratio
    (None, 0, 1, 8, 16, 17, 20, 21, 32, 64)))            # key_width


@pytest.mark.parametrize("requested", ["radix", "sample"])
@pytest.mark.parametrize("verify_on", [True, False])
def test_choose_equals_reference_over_a_grid(requested, verify_on):
    for s, d, w in _GRID:
        prof = {k: v for k, v in (("sortedness", s), ("dup_ratio", d),
                                  ("key_width", w)) if v is not None}
        a = planner.choose(prof, requested, verify_on)
        b = ref_planner.choose(prof, requested, verify_on)
        assert (a.policy, a.trigger, a.algo, a.predicted) == \
            (b.policy, b.trigger, b.algo, b.predicted), prof


def test_constants_and_lookup_equal_reference():
    for name in ("PLANNER_SCHEMA", "SORTED_SORTEDNESS", "NEAR_SORTED_SORTEDNESS",
                 "DUP_RATIO_HEAVY", "NARROW_KEY_WIDTH_BITS", "NARROW_DIGIT_BITS",
                 "NARROW_WIDE_DIGIT_BITS", "MARGIN_MIN", "MARGIN_MAX", "MARGIN_PAD",
                 "MARGIN_MIN_SAMPLES", "MARGIN_REFRESH", "RETUNE_EVERY",
                 "MIN_OBSERVATIONS", "WINDOW_GAIN", "MIN_WINDOW_S", "MAX_WINDOW_S",
                 "MAX_GAP_S"):
        assert getattr(planner, name) == getattr(ref_planner, name), name
    for name in planner.PLANNER_POLICIES:
        assert planner.policy(name)
    with pytest.raises(KeyError):
        planner.policy("radix_wide")


@pytest.mark.parametrize("env", [
    {}, {"SORT_PLANNER": "shadow"}, {"SORT_PLANNER": "on"},
    {"SORT_PLANNER": "on", "SORT_PLAN": "off"},
    {"SORT_PLANNER_WINDOW": "64", "SORT_PLANNER_HYSTERESIS": "2.5"},
])
def test_mode_window_hysteresis_equal_reference(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert planner.mode() == ref_planner.mode()
    assert planner.window() == ref_planner.window()
    assert planner.hysteresis() == ref_planner.hysteresis()


# ------------------------------------------------------- cap/margin policy

class _FakeSpan:
    def __init__(self, seq: int, name: str, attrs: dict) -> None:
        self.name = name
        self._d = {"pid": 1, "id": seq, "parent": None, "name": name,
                   "attrs": attrs}

    def to_dict(self) -> dict:
        return dict(self._d)


def _estimate(seq, pred, act, trigger="estimate"):
    return _FakeSpan(seq, "sort.plan", {"decisions": {"cap": {
        "trigger": trigger, "predicted": {"need": pred}, "actual": {"need": act}}}})


_RINGS = {
    "too-few": [_estimate(i, 100, 104) for i in range(5)],
    "tight": [_estimate(i, 1000, 1000 + 5 * (i % 10)) for i in range(20)],
    "wild": [_estimate(i, 100, 500) for i in range(10)],
    "below-min": [_estimate(i, 1000, 900) for i in range(8)],
    "mixed": ([_estimate(0, 10, 99, "exact"), _FakeSpan(1, "sort.plan", {"decisions": "x"}),
               _FakeSpan(2, "verify", {}), _estimate(3, 0, 5), _estimate(4, "a", 5)]
              + [_estimate(10 + i, 500, 510 + i) for i in range(12)]),
}


@pytest.mark.parametrize("ring", sorted(_RINGS))
def test_learned_margin_equals_reference_over_planted_rings(ring):
    for span in _RINGS[ring]:
        flight_recorder.get().add(span)
        ref_flight.get().add(span)
    assert planner.learned_margin(1.25) == ref_planner.learned_margin(1.25)
    # the memo: one wild row under the refresh threshold changes nothing,
    # a refresh's worth of them does, in both
    for rows in ([_estimate(100, 1000, 5000)],
                 [_estimate(200 + i, 1000, 5000) for i in range(planner.MARGIN_REFRESH)]):
        for span in rows:
            flight_recorder.get().add(span)
            ref_flight.get().add(span)
        assert planner.learned_margin(1.25) == ref_planner.learned_margin(1.25)
    assert planner.learned_margin(1.5, last_n=4) == ref_planner.learned_margin(1.5, last_n=4)


# ------------------------------------------------------------- serve tuner

def _arrivals(kind, count=200, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "steady":
        gaps = np.full(count, 2e-3)
    elif kind == "burst":
        gaps = np.where(np.arange(count) % 40 < 30, 1e-4, 0.2)
    elif kind == "oscillating":
        gaps = np.where((np.arange(count) // 24) % 2 == 0, 1e-4, 5e-3)
    else:
        gaps = rng.exponential(3e-3, count)
    t = np.cumsum(gaps)
    sizes = rng.integers(1, 1 << 18, count)
    dtypes = rng.choice(["int32", "uint64", "float32"], count)
    return [(float(a), int(n), str(d)) for a, n, d in zip(t, sizes, dtypes)]


@pytest.mark.parametrize("kind", ["steady", "burst", "oscillating", "poisson"])
@pytest.mark.parametrize("window,hyst", [(16, 1.5), (64, 1.2), (256, 3.0)])
def test_serve_tuner_trace_equals_reference(kind, window, hyst):
    tuners = [mod.ServeTuner(window=window, hysteresis=hyst, batch_keys=1 << 16,
                             initial_window_s=2e-3) for mod in (planner, ref_planner)]
    traces: list[list] = [[], []]
    for t, n, dt in _arrivals(kind):
        for tuner, trace in zip(tuners, traces):
            if tuner.observe(t, n, dt):
                trace.append(tuner.evaluate())
    assert traces[0] == traces[1] and traces[0]
    assert tuners[0].snapshot() == tuners[1].snapshot()


# ----------------------------------------------------- sort() under a mode

def _mix(cell: str) -> tuple[np.ndarray, str]:
    """The adversarial mix at 2^13-2^14: (keys, requested algorithm)."""
    rng = np.random.default_rng(14)
    n = 1 << 14
    if cell == "sorted":
        return np.arange(-(n // 2), n - n // 2, dtype=np.int32), "radix"
    if cell == "near_sorted":
        runs = 32
        span = (1 << 31) // runs
        base = np.repeat(np.arange(runs, dtype=np.int64) * span, n // runs)
        off = np.sort(rng.integers(0, 2 * span, size=(runs, n // runs)), axis=1)
        return (base + off.reshape(-1) - (1 << 30)).astype(np.int32), "radix"
    if cell == "dup_heavy":
        return kio.generate_zipf(1 << 13, dtype=np.int32, seed=3), "sample"
    if cell == "range_narrow":
        return rng.integers(-(1 << 16), 1 << 16, n, dtype=np.int32), "sample"
    if cell == "uniform":
        return kio.generate_uniform(n, np.int32, seed=5), "radix"
    # lying: sorted, with one descent between the profile's strided samples
    x = np.arange(1 << 13, dtype=np.int32)
    x[5], x[6] = x[6], x[5]
    return x, "radix"


_EXPECTED = {"sorted": "verify_passthrough", "near_sorted": "merge_sample",
             "dup_heavy": "radix_narrow", "range_narrow": "radix_compact",
             "uniform": "static", "lying": "verify_passthrough"}


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


@pytest.mark.parametrize("cell", sorted(_EXPECTED))
@pytest.mark.parametrize("ranks", [1, 8])
@pytest.mark.parametrize("mode", ["off", "shadow", "on"])
def test_sort_under_planner_mode_equals_reference(mode, ranks, cell, monkeypatch):
    monkeypatch.setenv("SORT_PLANNER", mode)
    x, algo = _mix(cell)
    tr, rt = Tracer(), RefTracer()
    if ranks == 1:
        got = mt.sort(x, algorithm=algo, tracer=tr, return_result=True, device="cpu")
        want = ref_mt.sort(x, algorithm=algo, tracer=rt, return_result=True,
                           mesh=ref_mesh(1))
    else:
        got = mt.sort(x, algorithm=algo, mesh=make_mesh(8, devices=["cpu"] * 8),
                      tracer=tr, return_result=True, exchange_engine="pallas")
        want = ref_mt.sort(x, algorithm=algo, mesh=ref_mesh(8), tracer=rt,
                           return_result=True, exchange_engine="pallas_interpret")
    out = got.to_numpy()
    assert out.tobytes() == want.to_numpy().tobytes() == np.sort(x).tobytes()
    assert verify.result_fingerprint(got) == _ref_fingerprint(want)
    for k in _COUNTERS:
        assert tr.counters.get(k) == rt.counters.get(k), k
    assert _norm(tr.plan.digest()) == _norm(rt.plan.digest())
    assert _norm(tr.plan.to_attrs()) == _norm(rt.plan.to_attrs())
    d = tr.plan.decisions.get("planner")
    if mode == "off":
        assert d is None and "planner" not in tr.counters
        return
    assert d.chosen == _EXPECTED[cell]
    assert d.predicted["applied"] is (mode == "on")
    passthrough = mode == "on" and cell in ("sorted", "lying")
    assert tr.counters.get("planner_passthrough") == \
        (1 if passthrough and cell == "sorted" else None)
    assert tr.counters.get("planner_passthrough_miss") == \
        (1 if passthrough and cell == "lying" else None)
    if passthrough and cell == "lying":
        assert d.regret == 1.0
        assert tr.plan.decisions["ladder"].chosen == ("local" if ranks == 1 else algo)
    if mode == "on" and cell == "range_narrow" and ranks == 8:
        passes = tr.plan.decisions["passes"]
        assert passes.trigger == "planner"
        assert passes.predicted["passes"] == passes.actual["passes"] == 2


def test_shadow_is_byte_equal_to_off_on_the_mix(monkeypatch):
    """Shadow changes nothing but the record: the same bytes and the same
    plan as ``off`` apart from the logged ``planner`` decision."""
    mesh = make_mesh(8, devices=["cpu"] * 8)
    for cell in sorted(_EXPECTED):
        x, algo = _mix(cell)
        views = []
        for mode in ("off", "shadow"):
            monkeypatch.setenv("SORT_PLANNER", mode)
            tr = Tracer()
            out = mt.sort(x, algorithm=algo, mesh=mesh, tracer=tr)
            attrs = tr.plan.to_attrs()
            attrs["decisions"].pop("planner", None)
            views.append((out.tobytes(), attrs))
        assert views[0] == views[1], cell


def test_planner_needs_plan_provenance(monkeypatch):
    monkeypatch.setenv("SORT_PLANNER", "on")
    monkeypatch.setenv("SORT_PLAN", "off")
    x, algo = _mix("sorted")
    tr = Tracer()
    out = mt.sort(x, algorithm=algo, mesh=make_mesh(8, devices=["cpu"] * 8), tracer=tr)
    assert out.tobytes() == x.tobytes()
    assert tr.plan is None and "planner" not in tr.counters


def test_learned_margin_reaches_the_cap_decision(monkeypatch):
    monkeypatch.setenv("SORT_PLANNER", "on")
    monkeypatch.setattr(planner, "learned_margin", lambda default, last_n=None: (
        1.05, {"margin_samples": 20, "margin_learned": True}))
    x = kio.generate_uniform(1 << 13, np.int32, seed=9)
    tr = Tracer()
    out = mt.sort(x, algorithm="sample", mesh=make_mesh(8, devices=["cpu"] * 8),
                  tracer=tr)
    assert out.tobytes() == np.sort(x).tobytes()
    assert tr.plan.decisions["cap"].predicted["margin"] == 1.05
    assert tr.plan.decisions["planner"].chosen == "cap_margin"


def test_passthrough_keeps_donated_words_for_the_ladder(monkeypatch):
    """A miss under donation: the verify reads the staged words without
    consuming them, and the ladder still sorts that input."""
    monkeypatch.setenv("SORT_PLANNER", "on")
    monkeypatch.setenv("SORT_DONATE", "1")
    monkeypatch.setenv("SORT_INGEST_CHUNK", "4096")
    x, _ = _mix("lying")
    mesh = make_mesh(8, devices=["cpu"] * 8)
    for ingest in ("mono", "stream"):
        monkeypatch.setenv("SORT_INGEST", ingest)
        tr = Tracer()
        out = mt.sort(x, mesh=mesh, tracer=tr)
        assert out.tobytes() == np.sort(x).tobytes()
        assert tr.counters["planner_passthrough_miss"] == 1
        assert tr.counters["verify_runs"] == 2
    # a staged input carries no host profile: static, no passthrough
    st = api.ingest_to_mesh(x, mesh)
    tr = Tracer()
    assert mt.sort(st, mesh=mesh, tracer=tr).tobytes() == np.sort(x).tobytes()
    assert st.consumed and tr.plan.decisions["planner"].chosen == "static"
    assert "planner_passthrough_miss" not in tr.counters


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the passthrough runs on the card's words)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_passthrough_on_the_card_equals_torch_sort(card, monkeypatch):
    """One rank and eight ranks of the card: a sorted input verifies
    through, the lying one misses and the ladder's kernels sort it; both
    byte-equal to torch.sort."""
    monkeypatch.delenv("SORT_LOCAL_ENGINE")
    monkeypatch.setenv("SORT_PLANNER", "on")
    n = 1 << 22
    x = np.arange(n, dtype=np.int32) - n // 2
    lying = x.copy()
    lying[5], lying[6] = lying[6], lying[5]
    for mesh in (None, make_mesh(8)):
        for inp, counter in ((x, "planner_passthrough"),
                             (lying, "planner_passthrough_miss")):
            want = torch.sort(torch.from_numpy(inp).to(card)).values.cpu().numpy()
            tr = Tracer()
            got = mt.sort(inp, mesh=mesh, tracer=tr)
            assert got.tobytes() == want.tobytes()
            assert tr.counters[counter] == 1
            if counter == "planner_passthrough_miss":
                # the ladder's sort ran a local engine on the card
                engine = tr.plan.to_attrs()["decisions"]["engine"]
                assert engine["actual"]["backend"] == "cuda"


def test_plan_profile_drives_the_choice():
    """The one-rank mix cells land on the policies the scorer promises from
    the profile the plan records."""
    for cell, want in _EXPECTED.items():
        x, algo = _mix(cell)
        assert planner.choose(plan.profile_host_array(x), algo, True).policy == want
