"""CPU tests of the benchmark's harness: discovery by name, the result
line, and what a run loads.

    python -m pytest sortbench/ -q
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from sortbench import generator, harness, reference, tracing

ROOT = Path(__file__).resolve().parents[1]

#: Keys per array in the CPU runs: small, so a run takes well under a second.
LOG2_N = 14

TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small(bench: harness.Bench, name: str) -> harness.Cell:
    cell = bench.cell(name)
    cell.config["log2_n"] = LOG2_N
    return cell


def cpu_run(bench: harness.Bench, name: str, trace: bool = False, **kw) -> dict:
    return harness.run(bench, small(bench, name), 2**40 + 17, 0.2, trace,
                       time.perf_counter(), device="cpu", **kw)


@pytest.fixture(scope="module")
def bench() -> harness.Bench:
    return harness.Bench.load()


@pytest.fixture
def tmp_bench(tmp_path: Path) -> harness.Bench:
    """A copy of ``BENCHMARK.json`` and the benchmark's data files under a
    temporary root."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "sortbench", tmp_path / "sortbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    return harness.Bench.load(tmp_path)


def test_every_named_file_exists(bench: harness.Bench) -> None:
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.config["name"] == w["config"]
        for kind in ("end_to_end", "per_layer"):
            for m in bench.metrics(w["name"], kind):
                assert callable(bench.reader(kind, m["name"]))
    assert set(bench.stages()) == {"local_sort", "exchange"}


@pytest.mark.parametrize("what", ["config", "traffic", "metric", "stage"])
def test_a_dropped_file_is_found_with_no_edit(tmp_bench: harness.Bench, what: str) -> None:
    home, spec = tmp_bench.home, tmp_bench.spec
    if what == "config":
        cfg = dict(json.loads((home / "configs" / "int32-2p28-r8.json").read_text()),
                   name="int64-2p12-r2", dtype="int64", log2_n=12, ranks=2,
                   keys={"distribution": "zipf", "exponent": 1.1, "values": 1000})
        (home / "configs" / "int64-2p12-r2.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": cfg["name"], "file": "sortbench/configs/int64-2p12-r2.json"})
        spec["workloads"].append({"name": "int64-2p12-r2.radix", "config": cfg["name"],
                                  "traffic": "radix", "chips": 1})
        cell = tmp_bench.cell("int64-2p12-r2.radix")
        assert (cell.keys, cell.key_bytes, cell.config["ranks"]) == (4096, 32768, 2)
        out = harness.run(tmp_bench, cell, 5, 0.1, False, time.perf_counter(), device="cpu")
        assert out["correct"] and out["metrics"]["mkeys_s"]["value"] > 0
        # the metrics with no ``workloads`` list; a footprint is reported once
        # the cell adds its name to the list of a ``peak_mem_gib`` metric
        assert set(out["metrics"]) == {"mkeys_s", "setup_s"}
    elif what == "traffic":
        (home / "traffic" / "burst.json").write_text(json.dumps(
            {"algorithm": "sample", "loop": "closed", "callers": 1, "think_ms": 0,
             "pool": 3, "check_calls": 1, "trace_calls": 2}))
        spec["workloads"].append({"name": "int32-2p28-r8.burst", "config": "int32-2p28-r8",
                                  "traffic": "burst", "chips": 1})
        cell = tmp_bench.cell("int32-2p28-r8.burst")
        assert cell.traffic["pool"] == 3 and cell.traffic["algorithm"] == "sample"
    elif what == "metric":
        (home / "metrics" / "calls_profiled.py").write_text(
            "def read(p):\n    return float(p.calls)\n")
        spec["per_layer"].append({"name": "calls_profiled", "unit": "calls", "better": "higher",
                                  "source": "device_trace", "layer": "device",
                                  "moves": "mkeys_s", "workloads": ["int32-2p30-r1.sort"]})
        out = cpu_run(tmp_bench, "int32-2p30-r1.sort", trace=True)
        assert out["metrics"]["calls_profiled"]["value"] == 3.0
    else:
        (home / "stages" / "local_sort" / "k8.txt").write_text("merge_rank_cluster\n")
        (home / "stages" / "codec").mkdir()
        (home / "stages" / "codec" / "keys.txt").write_text("# the key codec\nencode_words\n")
        stages = tmp_bench.stages()
        assert "merge_rank_cluster" in stages["local_sort"]
        assert stages["codec"] == ["encode_words"]
        assert tracing.stage_of("void merge_rank_cluster<4>(...)", stages) == "local_sort"


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(bench: harness.Bench, trace: bool) -> None:
    out = cpu_run(bench, "int32-2p28-r8.radix", trace=trace)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == TOP_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench.metrics("int32-2p28-r8.radix", kind)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert trace == ("busy_s" in dev and "window_s" in dev and "breakdown" in line)
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= tracing.TOP for v in line["breakdown"].values())
    assert set(line["checks"]) == {"mismatched_keys", "failed_calls", "answers_checked"}


def test_keys_repeat_by_seed_and_hold_their_range() -> None:
    cfg = {"dtype": "int32", "log2_n": 12,
           "keys": {"distribution": "uniform", "low": -2**31, "high": 2**31}}
    a = generator.make_keys(cfg, 2**33 + 5, 0, "cpu")
    assert torch.equal(a, generator.make_keys(cfg, 2**33 + 5, 0, "cpu"))
    assert not torch.equal(a, generator.make_keys(cfg, 2**33 + 5, 1, "cpu"))
    assert a.min() < -2**30 and a.max() > 2**30
    npb = generator.make_keys(dict(cfg, keys={"distribution": "npb_is", "max_key": 2**11}),
                              3, 0, "cpu")
    assert 0 <= int(npb.min()) and int(npb.max()) < 2**11
    z = generator.make_keys(dict(cfg, dtype="int64",
                                 keys={"distribution": "zipf", "exponent": 1.1, "values": 64}),
                            3, 0, "cpu")
    assert z.dtype == torch.int64 and torch.unique(z).numel() <= 64


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program() -> None:
    code = (
        "import sys, time, json; sys.path.insert(0, sys.argv[1]);"
        "from sortbench import reference;"
        "ref = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mpitest_tpu', 'mpitest_tpu_torch'));"
        "from sortbench import harness; b = harness.Bench.load();"
        "c = b.cell('int32-2p28-r8.radix'); c.config['log2_n'] = 12;"
        "out = harness.run(b, c, 3, 0.1, True, time.perf_counter(), device='cpu');"
        "print(json.dumps({'ref': ref, 'run': harness.forbidden_modules(),"
        " 'port': 'mpitest_tpu_torch' in sys.modules, 'correct': out['correct']}))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("SORT_")}
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                          text=True, timeout=300, env=env, check=True)
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen == {"ref": [], "run": [], "port": True, "correct": True}
    src = (ROOT / "sortbench" / "reference.py").read_text()
    imports = [ln.split()[1].split(".")[0] for ln in src.splitlines()
               if ln.startswith(("import ", "from "))]
    assert set(imports) <= {"__future__", "numpy", "torch"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch) -> None:
    monkeypatch.setitem(sys.modules, "mpitest_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_x", sys)
    assert "mpitest_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "mpitest_tpu.models", sys)
    assert {"jax.numpy", "mpitest_tpu.models"} <= set(harness.forbidden_modules())


def test_no_card_no_result(monkeypatch, capsys) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "int32-2p30-r1.sort", "--seed", "1", "--seconds", "1",
                       "--trace", "0"], time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_a_bare_checkout_of_the_benchmark_fails_without_a_result(tmp_path: Path) -> None:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "sortbench", tmp_path / "sortbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "sortbench/run.py", "--workload",
                           "int32-2p30-r1.sort", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_benchmark_json_keeps_to_its_shape(bench: harness.Bench) -> None:
    spec = bench.spec
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert set(spec) == {"command", "paths", "run_seconds", *KEYS}
    assert 1 <= spec["run_seconds"] <= 51
    for section, keys in KEYS.items():
        names = [e["name"] for e in spec[section]]
        assert len(names) == len(set(names))
        for e in spec[section]:
            assert keys <= set(e) <= keys | {"workloads"}
            assert NAME.fullmatch(e["name"])
            for k in ("why", "source", "layer"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


#: The kinds of end-to-end metric, each reported once by every cell; a
#: metric's kind is its name before the first dot (``peak_mem_gib.sample``).
E2E_KINDS = ["mkeys_s", "peak_mem_gib", "setup_s"]


def test_sizes_and_seeds_fit_the_contract(bench: harness.Bench) -> None:
    spec = bench.spec
    assert spec["command"] == ["python3", "sortbench/run.py"]
    cells = {w["name"] for w in spec["workloads"]}
    kind = {m["name"]: m["name"].split(".")[0] for m in spec["end_to_end"]}
    assert sorted(set(kind.values())) == E2E_KINDS
    for k in E2E_KINDS:
        alike = {(m["unit"], m["better"]) for m in spec["end_to_end"] if kind[m["name"]] == k}
        assert len(alike) == 1
    assert "workloads" not in next(m for m in spec["end_to_end"] if m["name"] == "setup_s")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m or m in spec["per_layer"]:
            assert m["workloads"] and set(m["workloads"]) <= cells
            assert len(m["workloads"]) == len(set(m["workloads"]))
    reports = {c: {m["name"] for m in bench.metrics(c, "end_to_end")} for c in cells}
    for c, names in reports.items():
        assert sorted(kind[n] for n in names) == E2E_KINDS
    for m in spec["per_layer"]:
        assert m["moves"] == "mkeys_s" and m["workloads"]
        assert all(m["moves"] in reports[c] for c in m["workloads"])
    assert all(w["chips"] == 1 for w in spec["workloads"])
    assert reference.count_mismatches(torch.arange(5).numpy(), torch.arange(4)) == 1
