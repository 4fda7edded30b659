"""The port's span layer (``mpitest_tpu_torch/utils/spans.py``,
``utils/timeline.py``, the span sites of the sorts and collectives)
against the reference's.

Mechanics mirror ``tests/test_spans.py``: nesting and ordering, the
active-log registry, the JSONL round trip and stream, the tracer's phase
spans.  The same inputs give the same output in both packages: the
Chrome export (timeline lanes included) under one fixed clock, the
``SORT_TRACE_SAMPLE`` keep pattern, ``build_timeline`` and ``bench_fold``.
A radix sort on eight ranks (``make_mesh(8, devices=["cpu"] * 8)``, the
reference on its cpu:8 mesh with ``exchange_engine="pallas_interpret"``
so its caps align to 1024 like the port's, at an n no other test
compiles) gives the same pass indices, exchange byte accounting and
collective totals.  ``SORT_TRACE`` files of library sorts pass the
reference's ``report.check_rows``, with the reference's set of names
(``sort.plan`` included: both run with ``SORT_PLAN`` at its default).
The port's own rule: collective events come on every run.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import mpitest_tpu_torch as mt
from mpitest_tpu import report
from mpitest_tpu.models import api as ref_api
from mpitest_tpu.parallel.mesh import make_mesh as ref_mesh
from mpitest_tpu.utils import spans as ref_spans
from mpitest_tpu.utils import timeline as ref_timeline
from mpitest_tpu.utils.trace import Tracer as RefTracer
from mpitest_tpu_torch.models import api
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.utils import spans, timeline
from mpitest_tpu_torch.utils.spans import MPI_EQUIV, SpanLog
from mpitest_tpu_torch.utils.trace import Tracer


_JIT = {"jit_compile_execute", "jit_execute"}


def _cpu_mesh(p: int = 8):
    return make_mesh(p, devices=["cpu"] * p)


def _keys(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(-(2**31), 2**31 - 1, size=n,
                                                dtype=np.int32)


# ------------------------------------------------------------- mechanics

def test_span_nesting_and_ordering():
    log = SpanLog()
    with log.span("outer", kind="test"):
        log.event("point", bytes=7)
        with log.span("inner"):
            pass
        with log.span("inner"):
            pass
    assert [s.name for s in log.spans] == ["outer", "point", "inner", "inner"]
    outer, point, in1, in2 = log.spans
    assert outer.parent is None
    assert point.parent == outer.id and point.dt == 0.0
    assert in1.parent == outer.id and in2.parent == outer.id and in1.id != in2.id
    assert [s.id for s in log.spans] == sorted(s.id for s in log.spans)
    assert outer.dt >= in1.dt >= 0.0


def test_active_log_registry():
    spans.emit("orphan", bytes=1)     # no active log: dropped
    log = SpanLog()
    assert spans.current_log() is None
    with log.span("outer"):
        assert spans.current_log() is log
        spans.emit("collected", bytes=2)
        with spans.maybe_span("inner") as s:
            assert s is not None and spans.current_log() is log
    assert spans.current_log() is None
    with spans.maybe_span("nothing") as s:
        assert s is None
    assert [s.name for s in log.spans] == ["outer", "collected", "inner"]


def test_jsonl_roundtrip_and_stream(tmp_path):
    stream = tmp_path / "stream.jsonl"
    log = SpanLog(stream_path=str(stream))
    with log.span("outer"):
        log.event("e", bytes=3)
    lines = [json.loads(line) for line in stream.read_text().splitlines()]
    assert [o["name"] for o in lines] == ["e", "outer"]   # completion order
    assert all(o["v"] == spans.SCHEMA == ref_spans.SCHEMA for o in lines)
    assert set(lines[0]) == {"v", "name", "id", "parent", "t0", "dt", "pid", "attrs"}
    full = tmp_path / "full.jsonl"
    log.dump(str(full))
    assert [json.loads(x)["name"] for x in full.read_text().splitlines()] == \
        ["outer", "e"]
    assert report.check_rows(report.load_rows(str(stream))) == []


def test_tracer_phase_spans_and_error(capsys):
    t = Tracer()
    with t.phase("alpha"):
        with t.phase("beta"):
            pass
    with t.span("verify", ok=True):
        pass
    assert "alpha" in t.phases and "beta" in t.phases and t.plan is None
    assert [s.name for s in t.spans.spans] == ["phase:alpha", "phase:beta", "verify"]
    assert t.spans.spans[1].parent == t.spans.spans[0].id
    t.error("boom")
    assert capsys.readouterr().err == "[ERROR] boom\n"


def test_trace_context_stamps_every_span():
    log = SpanLog()
    with spans.trace_context(batch_id="b1"):
        with spans.trace_context(trace_id="t1"):
            assert spans.current_trace_context() == {"batch_id": "b1",
                                                     "trace_id": "t1"}
            with log.span("sort"):
                log.record("ingest.parse", 0.0, 0.1, trace_id="override")
    log.record("verify", 0.0, 0.0)
    assert log.spans[0].attrs == {"batch_id": "b1", "trace_id": "t1"}
    assert log.spans[1].attrs["trace_id"] == "override"
    assert log.spans[2].attrs == {}
    assert spans.current_trace_context() is None


# ------------------------------------------- same inputs, same output

def _drive(mod, monkeypatch, ticks):
    """One fixed span sequence on ``mod``'s SpanLog under a fixed clock:
    a run with two exchange passes (per-rank byte lists), a disk span, an
    ingest transfer and a phase."""
    it = iter(ticks)
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it, 99.0))
    log = mod.SpanLog()
    with log.span("sort", n=8):
        with log.span("phase:sort"):
            with log.span("jit_compile_execute", label="radix_spmd"):
                for p in range(2):
                    with log.span("radix_pass", pass_index=p + 1):
                        log.event("ragged_all_to_all", bytes=4100 + p, cap=1024)
                log.event("exchange_balance", ranks=4, negotiated_cap=1024,
                          send_bytes=[40, 80, 40, 40], recv_bytes=[40, 40, 120, 0])
        log.record("external.run", 1.5, 0.25, run=0, n=8)
        log.record("ingest.transfer", 1.6, 0.1, bytes=4096)
        log.record("external.merge", 2.0, 0.5, final=True, disk_overlap=0.5)
        log.event("psum", bytes=4)
    return log


def test_chrome_trace_equals_reference(monkeypatch):
    ticks = [1.0 + 0.125 * i for i in range(40)]
    got = _drive(spans, monkeypatch, ticks).to_chrome_trace()
    want = _drive(ref_spans, monkeypatch, ticks).to_chrome_trace()
    assert got == want
    names = {e["name"] for e in got["traceEvents"]}
    # the enrichment is there: rank lanes, the disk lane and counters
    assert {"thread_name", "exchange pass 0", "inflight bytes",
            "exchange cap"} <= names
    json.loads(json.dumps(got))


def test_timeline_and_bench_fold_equal_reference(monkeypatch):
    ticks = [1.0 + 0.125 * i for i in range(40)]
    rows = [s.to_dict() for s in _drive(spans, monkeypatch, ticks).spans]
    for form in (rows, _drive(spans, monkeypatch, ticks).spans):
        assert timeline.build_timeline(form) == ref_timeline.build_timeline(form)
        assert timeline.bench_fold(form) == ref_timeline.bench_fold(form)
        assert timeline.chrome_events(form) == ref_timeline.chrome_events(form)
    tl = timeline.build_timeline(rows)
    assert tl["straggler_factor"] == 3.0 and tl["ranks"] == [0, 1, 2, 3]
    assert timeline.straggler_stats([1.0, 1.0, 4.0]) == \
        ref_timeline.straggler_stats([1.0, 1.0, 4.0])


@pytest.mark.parametrize("rate", ["0.1", "0.5", "0.9"])
def test_sample_keep_pattern_equals_reference(rate, tmp_path, monkeypatch):
    monkeypatch.setenv("SORT_TRACE_SAMPLE", rate)
    out = {}
    for tag, mod in (("port", spans), ("ref", ref_spans)):
        path = tmp_path / f"{tag}.jsonl"
        log = mod.SpanLog(stream_path=str(path))
        for i in range(40):
            with log.span("sort", i=i):
                with log.span("phase:encode"):
                    log.event("verify", ok=True)
        assert len(log.spans) == 120      # retention sees everything
        out[tag] = [(r["name"], r["id"], r["parent"], r["attrs"])
                    for r in map(json.loads, path.read_text().splitlines())]
        assert report.check_rows(report.load_rows(str(path))) == []
    assert out["port"] == out["ref"]
    assert len(out["port"]) == 3 * round(40 * float(rate))


# ------------------------------------- the radix run's span contract


@pytest.fixture(scope="module")
def radix_pair():
    """One radix sort on eight ranks in each package, same keys,
    ``digit_bits=16``, a fresh n for the reference's jit cache."""
    x = _keys(8 * 1213, 7)
    rt, pt = RefTracer(), Tracer()
    want = ref_api.sort(x, algorithm="radix", mesh=ref_mesh(8), digit_bits=16,
                        tracer=rt, exchange_engine="pallas_interpret")
    got = mt.sort(x, algorithm="radix", mesh=_cpu_mesh(), digit_bits=16, tracer=pt)
    assert got.tobytes() == want.tobytes()
    return pt, rt


def _collective_totals(sp):
    """Per-collective ``{calls, bytes, seconds}`` of a span list, keyed by
    the comm.h name: the reference's ``SpanLog.collective_totals``."""
    out = {}
    for s in sp:
        if s.name in MPI_EQUIV:
            row = out.setdefault(MPI_EQUIV[s.name], {"calls": 0, "bytes": 0, "seconds": 0.0})
            row["calls"] += 1
            row["bytes"] += int(s.attrs.get("bytes", 0))
            row["seconds"] += s.dt
    return out


def _chain(s, byid):
    out, p = [], s.parent
    while p is not None:
        out.append(byid[p].name)
        p = byid[p].parent
    return out


def test_radix_run_span_contract_equals_reference(radix_pair):
    pt, rt = radix_pair
    sp, rsp = pt.spans.spans, rt.spans.spans
    passes = [s.attrs["pass_index"] for s in sp if s.name == "radix_pass"]
    assert passes == [s.attrs["pass_index"] for s in rsp if s.name == "radix_pass"]
    assert passes == [1, 2]
    a2a = [s for s in sp if s.name == "ragged_all_to_all"]
    ra2a = [s for s in rsp if s.name == "ragged_all_to_all"]
    assert len(a2a) == len(passes) == len(ra2a)
    for a, b in zip(a2a, ra2a):
        for k in ("bytes", "wire_bytes", "cap", "n", "arrays", "ranks"):
            assert a.attrs[k] == b.attrs[k], k
        assert a.attrs["wire_bytes"] > 0
    assert _collective_totals(sp) == rt.spans.collective_totals()
    byid = {s.id: s for s in sp}
    colls = [s for s in sp if s.name in MPI_EQUIV]
    assert len(colls) >= 4
    for c in colls:
        chain = _chain(c, byid)
        assert "sort" in chain
        assert "radix_pass" in chain or "negotiate_probe" in chain
        assert c.attrs["bytes"] > 0 and c.dt == 0.0
    # the same structure: every pass under a first call of its program
    for s in sp:
        if s.name == "radix_pass":
            assert byid[s.parent].name == "jit_compile_execute"
            assert byid[s.parent].attrs["label"] == "radix_spmd"
    sort_span = next(s for s in sp if s.name == "sort")
    assert sort_span.attrs["dtype"] == "int32" and sort_span.attrs["ranks"] == 8
    # the CPU has no card memory to report
    assert "device_mem_peak_bytes" not in sort_span.attrs
    assert pt.counters["jit_first_calls"] >= 1


def test_collective_events_come_on_every_run():
    """The port has no trace time: a rerun of the same program emits the
    same collective events again, under ``jit_execute``; the reference
    emits them once per compile (``tests/test_spans.py``)."""
    x = _keys(8 * 1214, 8)
    t1, t2 = Tracer(), Tracer()
    mt.sort(x, mesh=_cpu_mesh(), digit_bits=16, tracer=t1)
    mt.sort(x, mesh=_cpu_mesh(), digit_bits=16, tracer=t2)
    names1 = [s.name for s in t1.spans.spans]
    names2 = [s.name for s in t2.spans.spans]
    assert "jit_compile_execute" in names1 and "jit_compile_execute" not in names2
    assert "jit_execute" in names2
    assert "jit_first_calls" in t1.counters and "jit_first_calls" not in t2.counters
    assert _collective_totals(t1.spans.spans) == _collective_totals(t2.spans.spans)
    assert names2.count("ragged_all_to_all") == names1.count("ragged_all_to_all") == 2


@pytest.mark.parametrize("algo,n", [("radix", 8 * 1215), ("sample", 8 * 1216)])
def test_sort_trace_file_passes_reference_check(algo, n, tmp_path, monkeypatch):
    """``SORT_TRACE`` from a library ``sort()`` in both packages: the
    port's file passes the reference's check, with the same set of names."""
    x = _keys(n, 9)
    names = {}
    for tag in ("port", "ref"):
        path = tmp_path / f"{tag}.jsonl"
        monkeypatch.setenv("SORT_TRACE", str(path))
        if tag == "port":
            mt.sort(x, algorithm=algo, mesh=_cpu_mesh())
        else:
            ref_api.sort(x, algorithm=algo, mesh=ref_mesh(8),
                         exchange_engine="pallas_interpret")
        rows = report.load_rows(str(path))
        assert rows and all(r["kind"] == "span" for r in rows)
        assert report.check_rows(rows) == []
        names[tag] = {r["name"] for r in rows}
        # which split of the first call shows depends on what the process
        # ran before; the n keeps the reference's compile (and with it its
        # collective events) fresh
        assert names[tag] & _JIT
        names[tag] -= _JIT
    assert names["port"] == names["ref"]
    assert {"sort", "sort.plan", "ragged_all_to_all", "negotiate_probe",
            "splitter_round" if algo == "sample" else "radix_pass"} <= names["port"]


# ------------------------------------------------------ dtype attributes


@pytest.mark.parametrize("dtype", ["int32", "uint32", "int64", "uint64",
                                   "float32", "float64"])
def test_dtype_attributes_carry_numpy_names(dtype):
    x = np.arange(300, dtype=dtype)[::-1].copy()
    forms = [x, torch.from_numpy(x)]
    for form in forms:
        tr = Tracer()
        mt.sort(form, device="cpu", tracer=tr)
        s = next(s for s in tr.spans.spans if s.name == "sort")
        assert s.attrs["dtype"] == dtype
        json.dumps([sp.to_dict() for sp in tr.spans.spans])
    tr = Tracer()
    mt.sort(torch.from_numpy(x), mesh=_cpu_mesh(2), tracer=tr)
    assert next(s for s in tr.spans.spans if s.name == "sort").attrs["dtype"] == dtype
    assert api._dtype_name(torch.zeros(1, dtype=torch.bfloat16)) == "bfloat16"
    assert api._dtype_name([1, 2]) is None


def test_every_attribute_streams_as_json(tmp_path, monkeypatch):
    """A traced run of every route streams: json.dumps never meets a
    tensor, a torch dtype or a numpy scalar."""
    path = tmp_path / "all.jsonl"
    monkeypatch.setenv("SORT_TRACE", str(path))
    x = _keys(1 << 13, 10)
    mt.sort(torch.from_numpy(x), device="cpu")
    mt.sort(x.astype(np.int64) << 20, device="cpu")
    mt.sort(x, mesh=_cpu_mesh(4), algorithm="sample")
    mt.sort(torch.from_numpy(x), mesh=_cpu_mesh(4))
    mt.sort(x, payload=np.arange(x.size, dtype=np.uint32), device="cpu")
    staged = api.ingest_to_mesh(x, mesh=make_mesh(1, devices=["cpu"]))
    mt.sort(staged)
    rows = report.load_rows(str(path))
    assert report.check_rows(rows) == []
    assert {r["attrs"].get("dtype") for r in rows if r["name"] == "sort"} == \
        {"int32", "int64"}
    names = {r["name"] for r in rows}
    assert {"ingest", "ingest.pipeline", "verify"} <= names
    assert {"jit_execute", "jit_compile_execute"} & names
