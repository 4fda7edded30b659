"""The sort doctor (``mpitest_tpu_torch/doctor.py``) against the
reference's ``mpitest_tpu/doctor.py``.

Every rule runs over the evidence ``tests/test_doctor.py`` builds (one
minimal fixture per registered pathology, its below-gate variants and a
clean snapshot) in both packages: the findings (``to_dict()``), their
order, ``render`` and ``plan_findings`` are equal.  The planted traces of
``bench/doctor_selftest.py`` go through each package's own chain (its
``SpanLog`` stream, ``report.load_rows``, ``timeline.build_timeline``,
``diagnose``) to the same findings (the traces are phase 3l's,
``chip_smoke.plant_pathology``).  One rule differs by design and is
pinned on its own: ``local_sort_lax`` fires on the port's accelerator
backend, ``"cuda"``, where the reference's fires on ``"tpu"``.  A real
sort's trace raises no finding.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke

from mpitest_tpu import doctor as ref_doctor
from mpitest_tpu import report as ref_report
from mpitest_tpu.utils import timeline as ref_timeline
from mpitest_tpu.utils.spans import SpanLog as RefSpanLog
import mpitest_tpu_torch as mt
from mpitest_tpu_torch import doctor, report
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.utils import timeline
from mpitest_tpu_torch.utils import io as kio
from mpitest_tpu_torch.utils.spans import SpanLog
from mpitest_tpu_torch.utils.trace import Tracer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ev_timeline(tl):
    def build(mod):
        ev = mod.empty_evidence()
        ev["timeline"] = tl
        return ev
    return build


def _ev_rows(rows, tl=None):
    return lambda mod: mod.evidence_from_rows(rows, timeline=tl)


def _lax(backend, frac=(2.0, 0.5)):
    rows = [{"name": "sort.plan", "attrs": {"decisions": {"engine": {
        "chosen": "xla", "actual": {"local_engine": "lax", "backend": backend}}}}}]
    tl = {"critical_path_phase": "sort", "phases": {"sort": frac[0], "decode": frac[1]}}
    return _ev_rows(rows, tl)


_REQ = [{"name": "serve.request", "dt": 0.01, "attrs": {"status": "ok"}}]
#: the evidence of tests/test_doctor.py, plus its below-gate variants
EVIDENCE = {
    "clean": _ev_rows(_REQ * 20, {"straggler_factor": 1.1,
                                  "phases": {"sort": 1.0, "verify": 0.05}}),
    "empty": lambda mod: mod.empty_evidence(),
    "skew-critical": _ev_timeline({"straggler_factor": 4.0, "passes": [
        {"seq": 0, "straggler": 4.0, "rank_bytes": [100.0, 400.0]}]}),
    "skew-warn": _ev_timeline({"straggler_factor": 1.6, "passes": [
        {"seq": 3, "straggler": 1.6, "rank_bytes": [100.0, 160.0]}]}),
    "skew-below": _ev_timeline({"straggler_factor": 1.49}),
    "cap_thrash": _ev_rows([{"name": "sort.plan", "attrs": {
        "decisions": {"cap": {"chosen": 512, "actual": {"regrows": 3}}}}}]),
    "cap_thrash-below": _ev_rows([{"name": "sort.plan", "attrs": {
        "decisions": {"cap": {"chosen": 512, "actual": {"regrows": 1}}}}}]),
    "compile_storm": _ev_rows(
        [{"name": "serve.compile_cache", "attrs": {"hit": False}}] * 5
        + [{"name": "serve.compile_cache", "attrs": {"hit": True}}]),
    "window-waste": _ev_rows([{"name": "sort.plan", "attrs": {
        "decisions": {"batch": {"actual": {"waste": 0.7}}}}}]),
    "window-occupancy": _ev_rows([{"name": "serve.batch", "attrs": {"segments": 1}}] * 4),
    "spill_bound": _ev_timeline({"overlap": {"disk_s": 3.5, "compute_s": 0.5,
                                             "compute_disk_pct": 10.0,
                                             "spill_disk_overlap": 0.25}}),
    "verify": _ev_timeline({"phases": {"sort": 2.0, "verify": 1.0}}),
    "verify-floor": _ev_timeline({"phases": {"sort": 0.04, "verify": 0.25}}),
    "breaker_flap": _ev_rows(
        [{"name": "serve.watchdog", "attrs": {"event": "trip"}}] * 2
        + [{"name": "serve.watchdog", "attrs": {"event": "recovered"}}]),
    "spill-one": _ev_rows([{"name": "external.recover", "attrs": {"reason": "fp"}}]),
    "spill_churn": _ev_rows([{"name": "external.recover", "attrs": {}},
                             {"name": "external.resume", "attrs": {}}]),
    "spill_churn-critical": _ev_rows([{"name": "external.recover", "attrs": {}}] * 2),
    "deadline_burn": _ev_rows(
        _REQ * 12 + [{"name": "serve.request", "dt": 0.0,
                      "attrs": {"status": "deadline"}}] * 4
        + [{"name": "serve.deadline", "attrs": {}}] * 4),
    "burn-warn": _ev_rows(
        _REQ * 999 + [{"name": "serve.request", "dt": 0.0,
                       "attrs": {"status": "error"}}] * 1),
    "many": _ev_rows(
        [{"name": "sort.plan", "attrs": {"decisions": {
            "cap": {"chosen": 8, "actual": {"regrows": 4}},
            "batch": {"actual": {"waste": 0.9}}}}}]
        + [{"name": "serve.watchdog", "attrs": {"event": "trip"}}] * 3,
        {"straggler_factor": 5.0, "phases": {"sort": 2.0, "verify": 2.0}}),
    # the one rule with a backend: neither package fires on the CPU
    "lax-on-cpu": _lax("cpu"),
    "lax-below-gate": _lax("cuda", (1.0, 2.0)),
}


@pytest.mark.parametrize("case", sorted(EVIDENCE))
def test_diagnose_and_render_equal_reference(case):
    ev, ref_ev = EVIDENCE[case](doctor), EVIDENCE[case](ref_doctor)
    assert ev == ref_ev
    mine, ref = doctor.diagnose(ev), ref_doctor.diagnose(ref_ev)
    assert [f.to_dict() for f in mine] == [f.to_dict() for f in ref]
    assert doctor.render(mine) == ref_doctor.render(ref)
    for name in doctor.DOCTOR_RULES:
        a, b = doctor.run_rule(name, ev), ref_doctor.run_rule(name, ref_ev)
        assert (a and a.to_dict()) == (b and b.to_dict()), name


@pytest.mark.parametrize("attrs", [
    {}, {"decisions": {"cap": {"actual": {"regrows": 2}},
                       "batch": {"actual": {"waste": 0.9}}}},
    {"decisions": {"cap": {"actual": {"regrows": 1}}}}, "garbage",
])
def test_plan_findings_equal_reference(attrs):
    assert doctor.plan_findings(attrs) == ref_doctor.plan_findings(attrs)


def test_vocabulary_and_errors_equal_reference():
    assert set(doctor.DOCTOR_RULES) == set(doctor._RULES)
    assert doctor.SEVERITIES == ref_doctor.SEVERITIES
    assert doctor.DOCTOR_SCHEMA == ref_doctor.DOCTOR_SCHEMA
    for name in ("SKEW_FACTOR_WARN", "SKEW_FACTOR_CRITICAL", "CAP_REGROW_GATE",
                 "COMPILE_MISS_MIN", "WINDOW_WASTE_GATE", "SPILL_FRACTION_GATE",
                 "VERIFY_RATIO_GATE", "VERIFY_MIN_SECONDS", "BREAKER_TRIP_GATE",
                 "BURN_RATE_GATE", "BURN_MIN_REQUESTS", "DEFAULT_SLO_TARGET_PCT",
                 "LOCAL_SORT_PHASE_GATE", "SPILL_CHURN_GATE"):
        assert getattr(doctor, name) == getattr(ref_doctor, name), name
    with pytest.raises(KeyError):
        doctor.run_rule("bogus_rule", doctor.empty_evidence())
    with pytest.raises(KeyError):
        doctor.Finding("bogus_rule", "warn", "x")
    with pytest.raises(ValueError):
        doctor.Finding("skew_imbalance", "meh", "x")


def test_local_sort_lax_fires_on_the_cards_backend():
    """The port's ``local_sort_lax`` fires on ``backend="cuda"`` (the
    ranks' device type) where the reference's fires on ``"tpu"``: the same
    finding, its text naming the CUDA backend and the lax engine."""
    mine = doctor.diagnose(_lax("cuda")(doctor))
    ref = ref_doctor.diagnose(_lax("tpu")(ref_doctor))
    assert [f.rule for f in mine] == [f.rule for f in ref] == ["local_sort_lax"]
    a, b = mine[0].to_dict(), ref[0].to_dict()
    for k in ("rule", "severity", "knob", "value", "threshold"):
        assert a[k] == b[k], k
    assert a["direction"].startswith("set radix_pallas")
    assert "CUDA backend" in a["summary"]
    assert a["evidence"][1] == "sort.plan: decisions.engine.actual.local_engine=lax " \
                               "backend=cuda"
    assert doctor.diagnose(_lax("tpu")(doctor)) == []
    assert ref_doctor.diagnose(_lax("cuda")(ref_doctor)) == []


# ------------------------------------- the selftest's planted traces, both ways

@pytest.mark.parametrize("rule", sorted(doctor.DOCTOR_RULES))
def test_planted_trace_names_its_rule_in_both_chains(rule, tmp_path):
    """Each planted pathology, streamed by each package's ``SpanLog`` and
    read back by its own report and timeline, is diagnosed as exactly its
    rule, with equal findings (``local_sort_lax`` planted on each
    package's accelerator backend)."""
    out = []
    for tag, log_cls, rep, tl_mod, doc, backend in (
            ("port", SpanLog, report, timeline, doctor, "cuda"),
            ("ref", RefSpanLog, ref_report, ref_timeline, ref_doctor, "tpu")):
        log = log_cls()
        log.stream_path = str(tmp_path / f"{tag}.jsonl")
        chip_smoke.plant_pathology(log, rule, backend)
        rows = rep.load_rows(log.stream_path)
        ev = doc.evidence_from_rows(rows, timeline=tl_mod.build_timeline(rows))
        found = doc.diagnose(ev)
        assert [f.rule for f in found] == [rule], tag
        assert rep.main(["--check", "--require-registered-spans",
                         log.stream_path]) == 0
        out.append(found[0].to_dict())
    mine, ref = out
    if rule == "local_sort_lax":   # worded for each backend
        mine, ref = ({k: v for k, v in d.items()
                      if k not in ("summary", "evidence", "direction")}
                     for d in (mine, ref))
    assert mine == ref


@pytest.mark.parametrize("ranks", [1, 8])
def test_a_real_sorts_trace_raises_no_finding(ranks):
    """The doctor's false-positive gate: a clean sort's own spans (the
    sample sort, as the reference's selftest runs it) raise nothing."""
    x = kio.generate("uniform", 1 << 13, np.dtype(np.int32), seed=7)
    tr = Tracer()
    kw = ({"mesh": make_mesh(8, devices=["cpu"] * 8)} if ranks == 8
          else {"device": "cpu"})
    out = mt.sort(x, algorithm="sample", tracer=tr, **kw)
    assert out.tobytes() == np.sort(x).tobytes()
    rows = [s.to_dict() for s in tr.spans.spans]
    found = doctor.diagnose(doctor.evidence_from_rows(
        rows, timeline=timeline.build_timeline(rows)))
    assert found == [], [f.rule for f in found]
    assert "sort.plan" in {r["name"] for r in rows}
