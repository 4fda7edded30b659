"""The report views (``mpitest_tpu_torch/report.py``) and the CLI's
``--explain`` against the reference's ``mpitest_tpu/report.py`` and
``drivers/sort_cli.py``.

Each view renders the same text as the reference's on the same rows: the
aggregate tables, ``explain_view`` (all plans, one trace id), ``trace_view``,
``check_rows``, ``serve_slo``, ``scaleout_throughput`` and
``flag_regressions``, over three row sources (a port trace of eight-rank
sorts under ``SORT_PLANNER=shadow`` and ``on``, the reference's trace of
the same calls, and the planted rows of ``tests/test_report.py``).
``main`` gives the same exit code and output for ``--check``,
``--explain``, ``--doctor``, ``--trace-id`` and the default tables, and
runs as ``python -m mpitest_tpu_torch.report``; ``--prom`` renders the
reference's ``/metrics`` snapshot view.  The port CLI's
``--explain`` prints the reference's decision tree on the same file.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mpitest_tpu as ref_mt
import mpitest_tpu_torch as mt
from mpitest_tpu import report as ref_report
from mpitest_tpu.parallel.mesh import make_mesh as ref_mesh
from mpitest_tpu.utils import spans as ref_spans
from mpitest_tpu.utils.trace import Tracer as RefTracer
from mpitest_tpu_torch import cli, report
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.utils import io as kio
from mpitest_tpu_torch.utils import spans
from mpitest_tpu_torch.utils.trace import Tracer

_spec = importlib.util.spec_from_file_location(
    "ref_sort_cli_report", os.path.join(os.path.dirname(__file__), "..", "drivers",
                                        "sort_cli.py"))
ref_cli = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_cli)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write(path, rows):
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(path)


def _serve_req(i, dt, status="ok", tid=None):
    attrs = {"n": 512, "dtype": "int32", "status": status, "batched": True}
    if tid:
        attrs["trace_id"] = tid
    return {"v": "span.v1", "name": "serve.request", "id": 100 + i, "parent": None,
            "t0": float(i), "dt": dt, "pid": 1, "attrs": attrs}


PLANTED = (
    [{"v": "span.v1", "pid": 1, "name": "sort", "id": 0, "parent": None, "t0": 0.0, "dt": 2.0,
      "attrs": {"algorithm": "radix", "trace_id": "t1"}},
     {"v": "span.v1", "pid": 1, "name": "phase:sort", "id": 1, "parent": 0, "t0": 0.1,
      "dt": 1.5, "attrs": {"trace_id": "t1"}},
     {"v": "span.v1", "pid": 1, "name": "ragged_all_to_all", "id": 2, "parent": 1, "t0": 0.2,
      "dt": 0.0, "attrs": {"bytes": 4096, "ranks": 4}},
     {"v": "span.v1", "pid": 1, "name": "sort.plan", "id": 3, "parent": 0, "t0": 1.9, "dt": 0.0,
      "attrs": {"plan_v": "plan.v1", "algo": "sample", "n": 100, "dtype": "int32",
                "ranks": 4, "regret": 1.5, "trace_id": "t1",
                "decisions": {"cap": {"chosen": 128, "trigger": "estimate",
                                      "predicted": {"cap": 128, "need": 90},
                                      "actual": {"cap": 310, "regrows": 1},
                                      "regret": 1.5},
                              "planner": {"chosen": "merge_sample",
                                          "predicted": {"applied": True},
                                          "regret": 0.0}},
                "profile": {"sortedness": 0.93}}},
     {"v": "comm_stats.v1", "backend": "local", "ranks": 4,
      "collectives": {"alltoallv": {"calls": 16, "bytes": 320000, "seconds": 0.001}}},
     {"ts": 1.0, "config": {"algo": "radix"},
      "metrics": {"phase_sort_ms": {"value": 250.0, "unit": "ms"},
                  "sort_mkeys_per_s": {"value": 700.0, "unit": "Mkeys/s"}}},
     {"metric": "radix_sort_mkeys_per_s_2e28_int32", "value": 766.7,
      "unit": "Mkeys/s", "vs_baseline": 60.7},
     {"metric": "radix_sort_mkeys_per_s_2e28_int32_devices8", "value": 1200.0,
      "unit": "Mkeys/s"},
     {"v": "span.v1", "pid": 1, "name": "ingest.parse", "id": 10, "parent": None, "t0": 0.0,
      "dt": 0.4, "attrs": {"chunk": 0, "bytes": 1000}},
     {"v": "span.v1", "pid": 1, "name": "ingest.transfer", "id": 12, "parent": None,
      "t0": 0.2, "dt": 0.5, "attrs": {"chunk": 0, "bytes": 1000}}]
    + [_serve_req(i, dt, tid="t1" if i == 0 else None)
       for i, dt in enumerate([0.010, 0.020, 0.030, 0.040, 0.200])]
    + [_serve_req(9, 0.005, status="backpressure"),
       {"v": "span.v1", "name": "serve.batch", "id": 200, "parent": None, "t0": 0.0,
        "dt": 0.003, "pid": 1, "attrs": {"segments": 5, "keys": 2560, "bucket": 4096,
                                         "trace_ids": ["t1"]}}])


def _sort_trace(tmp_path, pkg):
    """A trace of eight-rank sorts (the planner in shadow, then on, the
    second under trace id ``req-7``) written by ``pkg``'s span layer."""
    path = str(tmp_path / f"{pkg}.jsonl")
    x = kio.generate_uniform(1 << 13, np.int32, seed=21)
    near = np.sort(x.reshape(16, -1), axis=1).reshape(-1)
    for mode, keys, tid in (("shadow", x, None), ("on", near, "req-7")):
        os.environ["SORT_PLANNER"] = mode
        try:
            if pkg == "port":
                tr = Tracer()
                tr.spans.stream_path = path
                ctx = spans.trace_context(trace_id=tid) if tid else _null()
                with ctx:
                    mt.sort(keys, mesh=make_mesh(8, devices=["cpu"] * 8), tracer=tr)
            else:
                tr = RefTracer()
                tr.spans.stream_path = path
                ctx = ref_spans.trace_context(trace_id=tid) if tid else _null()
                with ctx:
                    ref_mt.sort(keys, mesh=ref_mesh(8), tracer=tr)
        finally:
            del os.environ["SORT_PLANNER"]
    return path


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("report")
    os.environ["SORT_LOCAL_ENGINE"] = "lax"
    try:
        return {"port": _sort_trace(d, "port"), "ref": _sort_trace(d, "ref"),
                "planted": _write(d / "planted.jsonl", PLANTED)}
    finally:
        del os.environ["SORT_LOCAL_ENGINE"]


@pytest.mark.parametrize("src", ["port", "ref", "planted"])
def test_views_equal_reference(src, sources):
    path = sources[src]
    rows, ref_rows = report.load_rows(path), ref_report.load_rows(path)
    assert rows == ref_rows
    agg, ref_agg = report.aggregate(rows), ref_report.aggregate(rows)
    assert agg == ref_agg
    assert report.render(agg) == ref_report.render(ref_agg)
    assert report.render(agg, 99.0) == ref_report.render(ref_agg, 99.0)
    assert report.check_rows(rows) == ref_report.check_rows(rows)
    assert report.scaleout_throughput(agg["metrics"]) == \
        ref_report.scaleout_throughput(ref_agg["metrics"])
    assert report.serve_slo(agg["serve"]) == ref_report.serve_slo(ref_agg["serve"])
    for tid in (None, "t1", "req-7", "nope"):
        assert report.explain_view(rows, tid) == ref_report.explain_view(rows, tid)
        if tid:
            assert report.trace_view(rows, tid) == ref_report.trace_view(rows, tid)
    for r in rows:
        if r.get("name") == "sort.plan":
            assert report.render_plan(r["attrs"]) == ref_report.render_plan(r["attrs"])
    baseline = [{"kind": "bench", "metric": "radix_sort_mkeys_per_s_2e28_int32",
                 "value": 900.0, "host": "h/8c"},
                {"kind": "bench", "metric": "sort_mkeys_per_s", "value": 600.0},
                {"kind": "bench", "metric": "absent", "value": 1.0, "host": "h/8c"}]
    assert report.flag_regressions(agg, baseline, 0.9, "h/8c") == \
        ref_report.flag_regressions(ref_agg, baseline, 0.9, "h/8c")
    if src != "planted":
        view = report.explain_view(rows)
        assert view.count("plan algo=") == 2 and "planner" in view


@pytest.mark.parametrize("q", [0, 1, 50, 90, 99, 100])
def test_percentile_and_error_budget_equal_reference(q):
    vals = sorted([1.0, 2.0, 3.0, 4.0, 100.0, 7.5])
    assert report.percentile(vals, q) == ref_report.percentile(vals, q)
    assert report.percentile([], q) == ref_report.percentile([], q)
    for req, err in ((0, 0), (100, 1), (1000, 0), (7, 7)):
        assert report.error_budget(req, err, 99.0 + q / 100) == \
            ref_report.error_budget(req, err, 99.0 + q / 100)


_MODES = [["--check"], ["--check", "--require-registered-spans"], ["--explain"],
          ["--explain", "req-7"], ["--doctor"], [], ["--trace-id", "req-7"],
          ["--explain", "absent-id"], ["--trace-id", "t1"]]


@pytest.mark.parametrize("src", ["port", "planted"])
@pytest.mark.parametrize("argv", _MODES, ids=[" ".join(a) or "tables" for a in _MODES])
def test_main_equals_reference(argv, src, sources, capsys):
    path = sources[src]
    got = []
    for mod in (report, ref_report):
        rc = mod.main(argv + [path])
        out = capsys.readouterr()
        got.append((rc, out.out, out.err))
    assert got[0] == got[1]


def test_main_explain_and_doctor_take_a_file_argument(sources, capsys):
    """``--explain FILE`` / ``--doctor FILE``: the value may be the trace."""
    for flag in ("--explain", "--doctor"):
        outs = []
        for mod in (report, ref_report):
            rc = mod.main([flag, sources["port"]])
            outs.append((rc, capsys.readouterr().out))
        assert outs[0] == outs[1] and outs[0][0] == 0


def test_prom_raises_a_typed_error_naming_the_module(sources, tmp_path, capsys):
    """``--prom``: a scrape renders the reference's snapshot view (requests,
    error budget, latency, counters), and a malformed scrape is the same
    typed ``ValueError`` (naming the line) with exit 1 in both packages."""
    from mpitest_tpu.utils.metrics_live import LiveMetrics as RefLive
    from mpitest_tpu_torch.utils.metrics_live import LiveMetrics

    texts = []
    for live in (LiveMetrics(), RefLive()):
        live.counter("sort_serve_requests_total").inc(99, status="ok")
        live.counter("sort_serve_requests_total").inc(1, status="internal")
        live.histogram("sort_serve_request_latency_seconds").observe(0.003)
        live.gauge("sort_serve_inflight").set(2)
        live.counter("sort_serve_cache_hits_total").inc(5)
        texts.append(live.render_prom())
    assert texts[0] == texts[1]
    prom = tmp_path / "m.prom"
    prom.write_text(texts[0])
    got = report.render_prom_snapshot(str(prom), prom.read_text())
    assert got == ref_report.render_prom_snapshot(str(prom), prom.read_text())
    assert "requests internal=1, ok=99" in got and "burn 10.0x" in got
    outs = []
    for mod in (report, ref_report):
        rc = mod.main([sources["planted"], "--prom", str(prom)])
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[0][0] == 0
    bad = tmp_path / "bad.prom"
    bad.write_text("sort_serve_inflight oops\n")
    with pytest.raises(ValueError, match="line 1"):
        report.render_prom_snapshot(str(bad), bad.read_text())
    errs = []
    for mod in (report, ref_report):
        assert mod.main([sources["planted"], "--prom", str(bad)]) == 1
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1] and errs[0].startswith("[ERROR]")


def test_host_fingerprint_equals_reference():
    from mpitest_tpu.utils.platform import host_fingerprint

    assert report.host_fingerprint() == host_fingerprint()


def test_report_runs_as_a_program(sources):
    """``python -m mpitest_tpu_torch.report`` over a port trace: --explain,
    --doctor and --check, in one process each."""
    for argv, want in ((["--explain"], "plan algo="), (["--doctor"], "doctor:"),
                       (["--check"], "telemetry check OK")):
        out = subprocess.run([sys.executable, "-m", "mpitest_tpu_torch.report",
                              *argv, sources["port"]], cwd=REPO, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert want in out.stdout


# ------------------------------------------------------------ the CLI leg

@pytest.mark.parametrize("dtype,ranks", [("int32", "1"), ("float64", "1"),
                                         ("uint64", "1"), ("int32", "8")])
def test_cli_explain_equals_reference(dtype, ranks, tmp_path, capsys, monkeypatch):
    """``--explain`` after the sort: on one rank the port's stdout is the
    reference's line for line; on eight ranks (the reference's CPU engines
    differ: ``lax`` exchange, 128-aligned caps) the same tree of decisions
    with the same profile and the same algo, ladder and passes lines."""
    x = kio.generate_uniform(5000, dtype, seed=31)
    path = str(tmp_path / "k.bin")
    kio.write_keys_binary(path, x)
    for k, v in {"SORT_RANKS": ranks, "SORT_ALGO": "radix", "SORT_DTYPE": dtype,
                 "SORT_NATIVE_ENCODE": "off", "SORT_LOCAL_ENGINE": "lax"}.items():
        monkeypatch.setenv(k, v)
    assert cli.main(["sort_cli", path, "--explain"], device="cpu") == 0
    got = capsys.readouterr()
    assert ref_cli.main(["sort_cli", "--explain", path]) == 0
    want = capsys.readouterr()
    assert "[ERROR]" not in got.err
    if ranks == "1":
        assert got.out == want.out
        assert f"plan algo=radix n=5000 dtype={dtype} ranks=1" in got.out
        return
    mine, ref = got.out.splitlines(), want.out.splitlines()
    assert [ln.split()[:2] for ln in mine] == [ln.split()[:2] for ln in ref]
    for ln_m, ln_r in zip(mine, ref):
        if ln_m.lstrip("├└─ ").startswith(("algo", "ladder", "passes", "profile",
                                             "plan ", "The n/2")):
            assert ln_m.split("regret=")[0] == ln_r.split("regret=")[0]
