"""The port's telemetry layer beyond the span stream: the flight recorder
(``utils/flight_recorder.py``, mirroring ``tests/test_telemetry_live.py``),
the artifact a typed error leaves, the metrics sidecar
(``utils/metrics.py``), the knobs of the layer, the card memory
high-water, the first-call split, ``torch_profile`` and the thread safety
of ``SpanLog.record``; held against the reference's modules where they
have a counterpart.  One ``cuda``-marked test repeats the trace contract
on the card and skips without one.
"""

from __future__ import annotations

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import mpitest_tpu_torch as mt
from mpitest_tpu import report
from mpitest_tpu.utils import knobs as ref_knobs
from mpitest_tpu.utils import metrics as ref_metrics
from mpitest_tpu_torch.models import api
from mpitest_tpu_torch.models import verify as vfy
from mpitest_tpu_torch.parallel.mesh import Mesh, make_mesh
from mpitest_tpu_torch.utils import flight_recorder as fr
from mpitest_tpu_torch.utils import knobs
from mpitest_tpu_torch.utils.metrics import Metrics
from mpitest_tpu_torch.utils.spans import SpanLog
from mpitest_tpu_torch.utils.trace import Tracer, torch_profile


@pytest.fixture
def flight(tmp_path, monkeypatch):
    """A fresh process recorder writing under ``tmp_path``."""
    def make(size: str = "2048"):
        monkeypatch.setenv("SORT_FLIGHT_RECORDER_SIZE", size)
        monkeypatch.setenv("SORT_FLIGHT_RECORDER_DIR", str(tmp_path / "flight"))
        fr.reset()
        return fr.get()
    yield make
    fr.reset()


# -------------------------------------------------------- flight recorder

def test_flight_ring_bound_and_dump_sanitizes_parents(flight):
    rec = flight("8")
    log = SpanLog()
    with log.span("sort"):              # root: flushed last
        for _ in range(12):             # children flood the ring
            log.event("verify", ok=True)
    assert rec.capacity == 8 and len(rec.ring) == 8 and rec.recorded == 13
    path = rec.dump("unit_test")
    assert path is not None and os.path.basename(path).startswith(
        f"flight-{os.getpid()}-001-unit_test-")
    rows = report.load_rows(path)
    assert report.check_rows(rows) == []
    assert sum(1 for r in rows if r.get("kind") == "span") == 8
    assert rows[0]["kind"] == "metrics" and rows[0]["config"]["reason"] == "unit_test"
    # rate limit: the same reason at once again dumps nothing, another does
    assert rec.dump("unit_test", rate_limit=True) is None
    assert rec.dump("other reason!", rate_limit=True).endswith(".jsonl")
    snap = rec.snapshot(last_n=3, kinds=("verify",))
    assert len(snap) == 3 and all(d["parent"] is None for d in snap)


def test_flight_recorder_disabled_at_size_zero(flight):
    rec = flight("0")
    log = SpanLog()
    with log.span("sort"):
        pass
    assert not rec.enabled and rec.dump("nope") is None
    assert fr.dump_on_error("nope") is None


def test_flight_recorder_caps_dumps_per_process(flight):
    rec = flight("4")
    SpanLog().event("verify", ok=True)
    paths = [rec.dump(f"r{i}") for i in range(fr.MAX_DUMPS + 3)]
    assert sum(p is not None for p in paths) == fr.MAX_DUMPS


def test_flight_recorder_garbage_knob_is_a_disabled_recorder(monkeypatch):
    monkeypatch.setenv("SORT_FLIGHT_RECORDER_SIZE", "many")
    fr.reset()
    try:
        assert not fr.get().enabled
    finally:
        fr.reset()


def test_typed_error_leaves_an_artifact(flight, monkeypatch):
    """A verifier that reports a mismatch makes ``sort()`` raise
    SortIntegrityError; the dumped ring passes the reference's
    ``report.py --check`` and holds the failed verification."""
    rec = flight()
    monkeypatch.setattr(vfy, "verify_result", lambda res, fp: (True, False))
    # pinned to the requested path: the ladder's host rung would verify
    monkeypatch.setenv("SORT_FALLBACK", "0")
    x = np.random.default_rng(3).integers(-50, 50, 5000).astype(np.int32)
    with pytest.raises(mt.SortIntegrityError):
        mt.sort(x, mesh=make_mesh(4, devices=["cpu"] * 4))
    arts = sorted(os.listdir(rec.directory))
    assert len(arts) == 1 and "SortIntegrityError" in arts[0]
    path = os.path.join(rec.directory, arts[0])
    assert report.main(["--check", path]) == 0
    rows = [r for r in report.load_rows(path) if r["kind"] == "span"]
    verdicts = [r for r in rows if r["name"] == "verify"]
    assert verdicts and verdicts[-1]["attrs"]["ok"] is False
    # the dump runs inside the still-open sort span: its children are in
    # the ring, the sort span itself is not yet
    assert {"ragged_all_to_all", "phase:sort"} <= {r["name"] for r in rows}


def test_typed_error_of_the_external_sort_leaves_an_artifact(flight, monkeypatch,
                                                             tmp_path):
    """A merge whose every verification fails ends the external sort with
    SortIntegrityError after its recoveries; the ring is dumped."""
    from mpitest_tpu_torch.store import external

    rec = flight()
    monkeypatch.setattr(external, "lex_sorted_host", lambda kws: False)
    x = np.random.default_rng(4).integers(-(2**31), 2**31 - 1, 4096).astype(np.int32)
    with pytest.raises(mt.SortIntegrityError):
        mt.external_sort(x, budget=8192, spill_dir=str(tmp_path / "spill"),
                         device="cpu")
    arts = os.listdir(rec.directory)
    assert len(arts) == 1 and "SortIntegrityError" in arts[0]
    path = os.path.join(rec.directory, arts[0])
    assert report.main(["--check", path]) == 0
    assert "external.recover" in {r.get("name") for r in report.load_rows(path)}


# ---------------------------------------------------------------- metrics

def test_metrics_round_trip_equals_reference(tmp_path):
    tr = Tracer()
    tr.phases.update(sort=0.25, verify=0.0125)
    tr.counters.update(exchange_bytes=10**9, exchange_passes=2,
                       local_engine="lax")
    out = {}
    for tag, cls in (("port", Metrics), ("ref", ref_metrics.Metrics)):
        m = cls(config={"algo": "radix", "n": 1 << 20, "dtype": "int32"})
        m.record("wall_time_s", 0.5, "s")
        assert m.throughput("sort_mkeys_per_s", 1 << 20, 0.5) == (1 << 20) / 0.5e6
        m.record_tracer(tr)
        path = tmp_path / f"{tag}.jsonl"
        m.dump(str(path))
        m.dump(str(path))
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        assert len(lines) == 2
        out[tag] = {k: v for k, v in lines[0].items() if k != "ts"}
    assert out["port"] == out["ref"]
    assert out["port"]["metrics"]["exchange_gb_per_s"] == {"value": 4.0,
                                                           "unit": "GB/s"}
    assert report.check_rows(report.load_rows(str(tmp_path / "port.jsonl"))) == []


# ------------------------------------------------------------------ knobs

@pytest.mark.parametrize("name,raw", [
    ("SORT_TRACE_SAMPLE", "0"), ("SORT_TRACE_SAMPLE", "1.5"),
    ("SORT_TRACE_SAMPLE", "nan"), ("SORT_TRACE_SAMPLE", "often"),
    ("SORT_FLIGHT_RECORDER_SIZE", "-1"), ("SORT_FLIGHT_RECORDER_SIZE", "big"),
])
def test_garbage_telemetry_knobs_raise_the_reference_text(name, raw, monkeypatch):
    monkeypatch.setenv(name, raw)
    with pytest.raises(knobs.KnobError) as got:
        knobs.get(name)
    with pytest.raises(ref_knobs.KnobError) as want:
        ref_knobs.get(name)
    assert str(got.value) == str(want.value)


def test_telemetry_knob_defaults_follow_reference(monkeypatch):
    for name in ("SORT_TRACE", "SORT_TRACE_CHROME", "SORT_METRICS", "SORT_PROFILE",
                 "SORT_TRACE_SAMPLE", "SORT_FLIGHT_RECORDER_SIZE"):
        monkeypatch.delenv(name, raising=False)
        assert knobs.get(name) == ref_knobs.get(name), name
    monkeypatch.setenv("SORT_TRACE_SAMPLE", "0.25")
    assert knobs.get("SORT_TRACE_SAMPLE") == 0.25
    assert os.path.basename(knobs.get("SORT_FLIGHT_RECORDER_DIR")) == \
        os.path.basename(ref_knobs.get("SORT_FLIGHT_RECORDER_DIR"))
    with pytest.raises(KeyError):
        knobs.get("SORT_PROFILE_EVERY")   # the server's; not ported


# ------------------------------------------------- memory and first calls

def test_device_mem_peak_reads_the_cards_without_a_sync(monkeypatch):
    assert api.device_mem_peak(make_mesh(3, devices=["cpu"] * 3)) == 0
    peaks = {0: 5 << 20, 1: 7 << 20}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: peaks[torch.device(d).index])

    def no_sync(*a, **k):
        raise AssertionError("device_mem_peak synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    cards = Mesh((torch.device("cuda", 0), torch.device("cuda", 1),
                  torch.device("cuda", 0)))
    assert api.device_mem_peak(cards) == 7 << 20
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert api.device_mem_peak(None) == 7 << 20
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: (_ for _ in ()).throw(RuntimeError("no")))
    assert api.device_mem_peak(cards) == 0    # never raises


def test_first_call_split_keys_on_label_and_shape():
    tr = Tracer()
    key = ("test-only", object())      # a key no other call uses
    with tr.spans.span("sort"):
        assert api._traced_call(tr, "local", key, lambda a: a + 1, 1) == 2
        api._traced_call(tr, "local", key, lambda a: a, 1, n=5)
        api._traced_call(tr, "local_device", key, lambda a: a, 1)
    got = [(s.name, s.attrs) for s in tr.spans.spans[1:]]
    assert got == [("jit_compile_execute", {"label": "local"}),
                   ("jit_execute", {"label": "local", "n": 5}),
                   ("jit_compile_execute", {"label": "local_device"})]
    assert tr.counters["jit_first_calls"] == 2


# --------------------------------------------------------------- profile

def test_torch_profile_writes_a_trace_artifact(tmp_path):
    with torch_profile(None):
        pass
    with torch_profile(""):
        pass
    logdir = tmp_path / "prof"
    with torch_profile(str(logdir), [torch.device("cpu")]):
        torch.sort(torch.arange(1000, 0, -1))
    arts = os.listdir(logdir)
    assert len(arts) == 1 and arts[0].endswith(".pt.trace.json")
    events = json.loads((logdir / arts[0]).read_text())["traceEvents"]
    assert any("sort" in e.get("name", "") for e in events)


def test_torch_profile_never_drops_to_a_cpu_trace_on_a_card(tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot record CUDA"):
        with torch_profile(str(tmp_path / "p"), [torch.device("cuda", 0)]):
            pass


# ------------------------------------------------------------ threads

def test_worker_records_under_a_sampled_driver_keep_parents(tmp_path, monkeypatch):
    """Worker threads record() while the driver opens and closes sampled
    root spans: ids stay unique and every streamed parent resolves."""
    monkeypatch.setenv("SORT_TRACE_SAMPLE", "0.5")
    path = tmp_path / "stress.jsonl"
    log = SpanLog(stream_path=str(path))
    stop = threading.Event()

    def worker() -> None:
        while not stop.is_set():
            log.record("ingest.encode", 0.0, 0.0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=worker) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for _ in range(200):
            with log.span("sort"):
                with log.span("phase:sort"):
                    log.event("verify", ok=True)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    ids = [s.id for s in log.spans]
    assert len(ids) == len(set(ids))
    assert report.check_rows(report.load_rows(str(path))) == []


# ---------------------------------------------------- streams of entries

def test_ingest_and_external_sort_stream_sort_trace(tmp_path, monkeypatch):
    path = tmp_path / "t.jsonl"
    monkeypatch.setenv("SORT_TRACE", str(path))
    x = np.random.default_rng(5).integers(-(2**31), 2**31 - 1, 1 << 13).astype(np.int32)
    api.ingest_to_mesh(x, mesh=make_mesh(1, devices=["cpu"]))
    res = mt.external_sort(x, budget=8192, spill_dir=str(tmp_path / "s"),
                           device="cpu")
    assert res.keys.tobytes() == np.sort(x).tobytes()
    rows = report.load_rows(str(path))
    assert report.check_rows(rows) == []
    assert {"ingest", "ingest.pipeline", "external.run", "external.merge",
            "sort"} <= {r["name"] for r in rows}


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_trace_contract_on_the_card(tmp_path, monkeypatch):
    """On a card: a radix sort on eight ranks streams a file that passes
    the reference's check, one radix_pass and one exchange a planned
    pass, and the sort span's card memory high-water."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    path = tmp_path / "card.jsonl"
    monkeypatch.setenv("SORT_TRACE", str(path))
    x = torch.randint(-(2**31), 2**31 - 1, (1 << 20,), dtype=torch.int32,
                      device="cuda")
    tr = Tracer()
    got = mt.sort(x, mesh=make_mesh(8), tracer=tr, return_result=True)
    assert np.array_equal(got.to_numpy(), torch.sort(x).values.cpu().numpy())
    rows = report.load_rows(str(path))
    assert report.check_rows(rows) == []
    names = [r["name"] for r in rows]
    passes = int(tr.counters["exchange_passes"])
    assert names.count("radix_pass") == names.count("ragged_all_to_all") == passes
    sort_row = next(r for r in rows if r["name"] == "sort")
    assert sort_row["attrs"]["device_mem_peak_bytes"] > 0
    assert sort_row["attrs"]["dtype"] == "int32"
