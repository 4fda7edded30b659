"""The port's key-file CLI (``mpitest_tpu_torch/cli.py``, run with
``device="cpu"``) against the reference's (``drivers/sort_cli.py``), both
in process on the same files, with ``SORT_RANKS=1`` unless a test sets
more ranks (the reference then runs on its cpu:P mesh, the port on P
CPU ranks).

Held equal: the exit code, every stdout line but the ``[VERBOSE]`` phase
timings, and the stderr shape — the same lines, with the
``Endtime()-Starttime()`` value aside.  A file above ``SORT_MEM_BUDGET``
takes the external leg in both.  The observability sinks
(``SORT_METRICS``, ``SORT_TRACE``, ``SORT_TRACE_CHROME``, ``SORT_PROFILE``)
run in both; the sidecar carries the reference's config keys and metric
names, the plan-regret counters included (``SORT_PLAN`` at its default in
both).  ``SORT_FAULTS`` drills end with the reference's exit codes (3, 4,
and 1 for a garbage spec).  ``--explain`` prints the reference's decision
tree.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

import numpy as np
import pytest

from mpitest_tpu import report
from mpitest_tpu_torch import cli
from mpitest_tpu_torch.utils import io as kio
from mpitest_tpu_torch.utils.trace import Tracer

_spec = importlib.util.spec_from_file_location(
    "ref_sort_cli", os.path.join(os.path.dirname(__file__), "..", "drivers",
                                 "sort_cli.py"))
ref_cli = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_cli)

_TIME = re.compile(r"^Endtime\(\)-Starttime\(\) = \d+\.\d{5} sec$")


def _shape(err: str) -> list[str]:
    return ["Endtime()-Starttime() = T sec" if _TIME.match(line) else line
            for line in err.splitlines()]


def _stdout(out: str) -> list[str]:
    return [line for line in out.splitlines() if not line.startswith("[VERBOSE]")]


def _run_both(args, capsys, monkeypatch, **env):
    env = {"SORT_NATIVE_ENCODE": "off", "SORT_RANKS": "1", **env}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rrc = ref_cli.main(["sort_cli"] + args)
    ref = capsys.readouterr()
    rc = cli.main(["sort_cli"] + args, device="cpu")
    got = capsys.readouterr()
    return (rc, got), (rrc, ref)


def _check_same(args, capsys, monkeypatch, **env):
    (rc, got), (rrc, ref) = _run_both(args, capsys, monkeypatch, **env)
    assert rc == rrc
    assert _stdout(got.out) == _stdout(ref.out)
    assert _shape(got.err) == _shape(ref.err)
    return rc, got


@pytest.fixture
def int_file(tmp_path):
    x = np.random.default_rng(1).integers(-(2**31), 2**31 - 1, 1000, dtype=np.int32)
    p = tmp_path / "keys.txt"
    kio.write_keys_text(str(p), x)
    return str(p), x


@pytest.mark.parametrize("algo", ["sample", "radix"])
@pytest.mark.parametrize("debug", [None, "2", "3", "abc"])
def test_output_matches_reference(algo, debug, int_file, capsys, monkeypatch):
    path, x = int_file
    args = [path] + ([debug] if debug is not None else [])
    rc, got = _check_same(args, capsys, monkeypatch, SORT_ALGO=algo)
    assert rc == 0
    assert _stdout(got.out)[-1] == f"The n/2-th sorted element: {np.sort(x)[499]}"


@pytest.mark.parametrize("dtype", ["int64", "uint64", "float32", "float64", "int16"])
def test_dtypes_match_reference(dtype, tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(2)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = (rng.standard_normal(1001) * 10.0 ** rng.integers(-20, 20, 1001)).astype(dt)
        x[:2] = [0.0, -0.0]
    else:
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, 1001, dtype=dt, endpoint=True)
    p = tmp_path / "k.txt"
    kio.write_keys_text(str(p), x)
    rc, _ = _check_same([str(p), "3"], capsys, monkeypatch, SORT_DTYPE=dtype,
                        SORT_ALGO="radix")
    assert rc == 0


@pytest.mark.parametrize("engine", ["auto", "lax", "bitonic", "radix_pallas"])
def test_engines_and_sortbin1_match_reference(engine, tmp_path, capsys, monkeypatch):
    x = np.random.default_rng(3).integers(-(2**31), 2**31 - 1, 9000, dtype=np.int32)
    p = str(tmp_path / "k.bin")
    kio.write_keys_binary(p, x)
    rc, _ = _check_same([p], capsys, monkeypatch, SORT_LOCAL_ENGINE=engine)
    assert rc == 0
    tr = Tracer()
    monkeypatch.setenv("SORT_LOCAL_ENGINE", engine)
    assert cli.main(["sort_cli", p], device="cpu", tracer=tr) == 0
    capsys.readouterr()
    want = {"auto": "bitonic"}.get(engine, engine)
    assert tr.counters["local_engine"] == want
    assert tr.counters["encode_engine"] == "python"


@pytest.mark.parametrize("args", [[], ["a", "b", "c"]])
def test_usage_matches_reference(args, capsys, monkeypatch):
    rc, got = _check_same(args, capsys, monkeypatch)
    assert rc == 1 and got.err == "Usage: sort_cli <file: Data file to read>\n"


@pytest.mark.parametrize("content", [None, "", "1 2 zz 4\n", "1 99999999999999999999 3\n"])
def test_bad_files_match_reference(content, tmp_path, capsys, monkeypatch):
    p = tmp_path / "k.txt"
    if content is not None:
        p.write_text(content)
    rc, got = _check_same([str(p)], capsys, monkeypatch)
    assert rc == 1
    assert got.err == f"sort(): '{p}' is not a valid file for read.\n"


def test_bad_sortbin1_dtype_matches_reference(tmp_path, capsys, monkeypatch):
    p = str(tmp_path / "k.bin")
    kio.write_keys_binary(p, np.arange(100, dtype=np.int64))
    rc, _ = _check_same([p], capsys, monkeypatch, SORT_DTYPE="int32")
    assert rc == 1


@pytest.mark.parametrize("knob,value", [
    ("SORT_DTYPE", "garbage"), ("SORT_DTYPE", "complex64"), ("SORT_ALGO", "quick"),
    ("SORT_DIGIT_BITS", "0"), ("SORT_RANKS", "zero"), ("SORT_RANKS", "-3"),
    ("SORT_DIGIT_BITS", "33"), ("SORT_NATIVE_ENCODE", "maybe"),
    ("SORT_LOCAL_ENGINE", "warp"), ("SORT_VERIFY", "yes"),
    ("SORT_INGEST_THREADS", "0"), ("SORT_MEM_BUDGET", "-1"),
    ("SORT_INGEST", "fast"), ("SORT_DONATE", "yes"),
])
def test_knob_garbage_is_one_error_line(knob, value, int_file, capsys, monkeypatch):
    path, _ = int_file
    (rc, got), (rrc, ref) = _run_both([path], capsys, monkeypatch, **{knob: value})
    assert rc == rrc == 1
    assert got.out == ""
    lines = got.err.splitlines()
    assert len(lines) == 1 and lines[0].startswith("[ERROR] ")
    assert knob in lines[0] and repr(value) in lines[0]
    if knob not in ("SORT_NATIVE_ENCODE", "SORT_LOCAL_ENGINE"):
        assert got.err == ref.err   # the reference's own message


@pytest.mark.parametrize("env,argv_extra", [
    ({"SORT_RANKS": "2"}, []),   # ported now: held against the reference
    ({"SORT_MEM_BUDGET": "100"}, []),
    ({"SORT_FAULTS": "result_swap"}, []),
    ({"SORT_METRICS": "m.jsonl"}, []),
    ({"SORT_TRACE": "t.jsonl"}, []),
    ({"SORT_PROFILE": "prof"}, []),
    ({}, ["--explain"]),
], ids=["ranks", "mem_budget", "faults", "metrics", "trace", "profile", "explain"])
def test_unported_inputs_end_with_one_error_line(env, argv_extra, int_file, capsys,
                                                 monkeypatch, tmp_path):
    path, _ = int_file
    sink = next((k for k in ("SORT_METRICS", "SORT_TRACE", "SORT_PROFILE")
                 if k in env), None)
    if sink is not None:
        # refused before the telemetry layer was ported; it now runs, line
        # for line with the reference, and leaves its artifact
        target = str(tmp_path / env[sink])
        if sink == "SORT_PROFILE":   # the port alone: torch.profiler
            monkeypatch.setenv(sink, target)
            assert cli.main(["sort_cli", path], device="cpu") == 0
            capsys.readouterr()
            assert [f for f in os.listdir(target) if f.endswith(".pt.trace.json")]
            return
        rc, _ = _check_same([path], capsys, monkeypatch, **{sink: target})
        assert rc == 0
        rows = report.load_rows(target)
        assert len(rows) >= 2 and report.check_rows(rows) == []
        return
    if "SORT_RANKS" in env:
        # SORT_RANKS > 1 was refused before the distributed sort was
        # ported; it now runs and matches the reference line for line
        rc, _ = _check_same([path, "2"], capsys, monkeypatch, **env)
        assert rc == 0
        return
    if "SORT_FAULTS" in env:
        # refused before the fault layer was ported; now the reference's
        # exits, line for line: a recovered fault 0, a result that never
        # verifies 3, a dispatch that keeps failing 4, a garbage spec 1
        for extra, want in (({"SORT_RANKS": "8"}, 0),
                            ({"SORT_FAULTS": "result_dup:inf", "SORT_FALLBACK": "0",
                              "SORT_RANKS": "8"}, 3),
                            ({"SORT_FAULTS": "dispatch_oom:inf", "SORT_FALLBACK": "0",
                              "SORT_RANKS": "8"}, 4),
                            ({"SORT_FAULTS": "garbage_site"}, 1)):
            rc, got = _check_same([path], capsys, monkeypatch, SORT_RETRY_BACKOFF="0",
                                  **{**env, **extra})
            assert rc == want
            if want:
                lines = got.err.splitlines()
                assert len(lines) == 1 and lines[0].startswith("[ERROR] ")
                assert "Traceback" not in got.err
        return
    if "SORT_MEM_BUDGET" in env:
        # a file above the budget was refused before the external sort was
        # ported; it now takes the external leg, line for line
        rc, _ = _check_same([path], capsys, monkeypatch, **env)
        assert rc == 0
        return
    # --explain was refused before plan provenance was ported; it now
    # prints the reference's decision tree, line for line
    rc, got = _check_same([path] + argv_extra, capsys, monkeypatch, **env)
    assert rc == 0 and "[ERROR]" not in got.err
    assert "plan algo=sample n=1000 dtype=int32 ranks=1" in got.out


@pytest.mark.parametrize("ranks", ["2", "8"])
@pytest.mark.parametrize("algo", ["sample", "radix"])
@pytest.mark.parametrize("debug", [None, "2", "3"])
def test_ranks_match_reference(ranks, algo, debug, int_file, capsys, monkeypatch):
    """P ranks: the bucket line uses P, the protocol lines name every
    rank, the debug>2 dump labels each rank's block, and the probe is the
    same."""
    path, x = int_file
    args = [path] + ([debug] if debug is not None else [])
    rc, got = _check_same(args, capsys, monkeypatch, SORT_ALGO=algo, SORT_RANKS=ranks)
    assert rc == 0
    out = _stdout(got.out)
    assert out[-1] == f"The n/2-th sorted element: {np.sort(x)[499]}"
    if algo == "sample":
        assert f"Each bucket will be put {-(-1000 // int(ranks))} items." in out
    if debug is not None:
        assert f"[COMMON] Working {int(ranks) - 1}/{ranks}" in out


@pytest.mark.parametrize("engine", ["lax", "pallas"])
def test_ranks_with_engine_knobs_match_reference(engine, tmp_path, capsys, monkeypatch):
    x = np.random.default_rng(9).integers(-(2**31), 2**31 - 1, 5000, dtype=np.int64)
    p = str(tmp_path / "k.bin")
    kio.write_keys_binary(p, x)
    rc, _ = _check_same([p], capsys, monkeypatch, SORT_RANKS="3", SORT_DTYPE="int64",
                        SORT_EXCHANGE_ENGINE=engine if engine == "lax" else "auto",
                        SORT_CAP_FACTOR="1.5", SORT_OVERSAMPLE="9",
                        SORT_LOCAL_ENGINE="lax")
    assert rc == 0


@pytest.mark.parametrize("ranks", ["1", "2"])
@pytest.mark.parametrize("algo", ["sample", "radix"])
def test_external_leg_matches_reference(ranks, algo, tmp_path, capsys, monkeypatch):
    """A SORTBIN1 file of 4000 keys at a 4096-byte budget: four runs of 1024
    keys sorted on P ranks, merged in two passes at fan-in 2; the bucket
    line, the probe and the timing line as the reference prints them."""
    x = np.random.default_rng(11).integers(-(2**31), 2**31 - 1, 4000, dtype=np.int32)
    p = str(tmp_path / "k.bin")
    kio.write_keys_binary(p, x)
    rc, got = _check_same([p], capsys, monkeypatch, SORT_ALGO=algo, SORT_RANKS=ranks,
                          SORT_MEM_BUDGET="4096", SORT_MERGE_FANIN="2",
                          SORT_SPILL_DIR=str(tmp_path / "spill"),
                          SORT_SPILL_COMPRESS="on")
    assert rc == 0
    out = _stdout(got.out)
    assert out[-1] == f"The n/2-th sorted element: {np.sort(x)[1999]}"
    assert (f"Each bucket will be put {-(-4000 // int(ranks))} items." in out) == \
        (algo == "sample")
    tr = Tracer()
    assert cli.main(["sort_cli", p], device="cpu", tracer=tr) == 0
    capsys.readouterr()
    assert (tr.counters["external_runs"], tr.counters["external_merge_passes"]) == (4, 2)
    assert os.listdir(tmp_path / "spill") == []


_REF_CONFIG = {"in-memory": {"algo", "n", "dtype", "ranks", "digit_bits"},
               "external": {"algo", "n", "dtype", "ranks", "external"}}


@pytest.mark.parametrize("leg", ["in-memory", "external"])
@pytest.mark.parametrize("ranks", ["1", "2"])
def test_metrics_sidecar_matches_reference(leg, ranks, tmp_path, capsys, monkeypatch):
    """``SORT_METRICS`` on both legs: one line per run with the
    reference's config keys and values and its metric names, plus the
    port's ``encode_engine`` counter."""
    x = np.random.default_rng(12).integers(-(2**31), 2**31 - 1, 4000 + int(ranks),
                                           dtype=np.int32)
    p = str(tmp_path / "k.bin")
    kio.write_keys_binary(p, x)
    env = {"SORT_ALGO": "radix", "SORT_RANKS": ranks}
    if leg == "external":
        env.update(SORT_MEM_BUDGET="4096", SORT_MERGE_FANIN="2",
                   SORT_SPILL_DIR=str(tmp_path / "spill"), SORT_SPILL_COMPRESS="on")
    sides = {}
    for tag in ("port", "ref"):
        env["SORT_METRICS"] = str(tmp_path / f"{tag}.jsonl")
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        if tag == "port":
            assert cli.main(["sort_cli", p], device="cpu") == 0
        else:
            assert ref_cli.main(["sort_cli", p]) == 0
        capsys.readouterr()
        lines = (tmp_path / f"{tag}.jsonl").read_text().splitlines()
        assert len(lines) == 1
        sides[tag] = json.loads(lines[0])
    got, want = sides["port"], sides["ref"]
    assert set(got["config"]) == set(want["config"]) == _REF_CONFIG[leg]
    assert got["config"] == want["config"]
    # jit_first_calls appears only when this process meets the program
    # for the first time, in either package; and one name more: the
    # port's CLI counts the parser that read the file (encode_engine), the
    # reference records it on its ingest spans only
    warm = {"jit_first_calls"}
    assert set(got["metrics"]) - warm == (set(want["metrics"]) - warm) | \
        {"encode_engine"}
    assert got["metrics"]["sort_mkeys_per_s"]["unit"] == "Mkeys/s"
    # (exchange_bytes differs on the CPU: the reference's auto engine is
    # lax there, with 128-aligned caps; the port's is pallas, 1024)
    for name in ("exchange_passes", "digit_bits", "external_runs",
                 "external_merge_passes"):
        if name in want["metrics"]:
            assert got["metrics"][name]["value"] == want["metrics"][name]["value"]
    if ranks == "2" and leg == "in-memory":
        assert "exchange_gb_per_s" in got["metrics"]


_JIT = {"jit_compile_execute", "jit_execute"}


def test_trace_and_chrome_sinks_of_the_cli(tmp_path, capsys, monkeypatch):
    """``SORT_TRACE`` + ``SORT_TRACE_CHROME`` on two ranks: the JSONL passes
    the reference's check with the reference's names, the Chrome file is
    trace-event JSON.  The n is one no other test compiles: the reference
    emits its collective events only when it compiles (which split of the
    first call each package reports depends on what the process ran)."""
    x = np.random.default_rng(13).integers(-(2**31), 2**31 - 1, 1237, dtype=np.int32)
    path = str(tmp_path / "k.txt")
    kio.write_keys_text(path, x)
    names = {}
    for tag in ("port", "ref"):
        trace, chrome = tmp_path / f"{tag}.jsonl", tmp_path / f"{tag}.json"
        for k, v in {"SORT_RANKS": "2", "SORT_ALGO": "radix",
                     "SORT_TRACE": str(trace), "SORT_TRACE_CHROME": str(chrome)
                     }.items():
            monkeypatch.setenv(k, v)
        if tag == "port":
            assert cli.main(["sort_cli", path], device="cpu") == 0
        else:
            assert ref_cli.main(["sort_cli", path]) == 0
        capsys.readouterr()
        rows = report.load_rows(str(trace))
        assert report.check_rows(rows) == []
        names[tag] = {r["name"] for r in rows}
        assert names[tag] & _JIT
        names[tag] -= _JIT
        events = json.loads(chrome.read_text())["traceEvents"]
        assert events[0]["args"]["name"] == "mpitest_tpu"
        assert {"sort", "radix_pass"} <= {e["name"] for e in events}
    assert names["port"] == names["ref"]
    assert "sort.plan" in names["port"]


def test_external_leg_bad_file_matches_reference(tmp_path, capsys, monkeypatch):
    p = tmp_path / "k.txt"
    p.write_text("1 2 zz 4\n" * 100)
    rc, got = _check_same([str(p)], capsys, monkeypatch, SORT_MEM_BUDGET="16")
    assert rc == 1
    assert got.err == f"sort(): '{p}' is not a valid file for read.\n"


def test_mem_budget_below_the_file_with_debug_runs_in_memory(int_file, capsys,
                                                              monkeypatch):
    """The reference keeps the in-memory path for debug runs; so does the
    port, and the budget then changes nothing."""
    path, _ = int_file
    rc, _ = _check_same([path, "1"], capsys, monkeypatch, SORT_MEM_BUDGET="100")
    assert rc == 0
    rc, _ = _check_same([path], capsys, monkeypatch, SORT_MEM_BUDGET="100000000")
    assert rc == 0


def test_integrity_failure_exits_3(int_file, capsys, monkeypatch):
    from mpitest_tpu_torch.ops import kernels

    real = kernels.local_sort

    def corrupt(words, engine="lax", diffs=None):
        out = real(words, engine, diffs)
        return (out[0].flip(0),) + tuple(out[1:])

    monkeypatch.setattr(kernels, "local_sort", corrupt)
    rc = cli.main(["sort_cli", int_file[0]], device="cpu")
    got = capsys.readouterr()
    assert rc == cli.EXIT_INTEGRITY == 3
    assert got.err.startswith("[ERROR] sort integrity failure: ")
    assert len(got.err.splitlines()) == 1


def test_retries_exhausted_exits_4(int_file, capsys, monkeypatch):
    from mpitest_tpu_torch.models import api

    def fail(*a, **k):
        raise api.SortRetryExhausted("dispatch kept failing")

    monkeypatch.setattr(api, "sort", fail)
    rc = cli.main(["sort_cli", int_file[0]], device="cpu")
    got = capsys.readouterr()
    assert rc == cli.EXIT_RETRIES == 4
    assert got.err == "[ERROR] sort failed after retries: dispatch kept failing\n"


def test_no_card_is_one_error_line(int_file, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["sort_cli", int_file[0]])
    got = capsys.readouterr()
    assert rc == 1 and got.out == ""
    assert got.err.startswith("[ERROR] ") and "needs a CUDA device" in got.err


def test_native_engine_is_recorded(int_file, capsys, monkeypatch):
    from mpitest_tpu_torch.utils import native_encode

    if not native_encode.build():
        pytest.skip("no C compiler built the parser")
    monkeypatch.setenv("SORT_NATIVE_ENCODE", "auto")
    tr = Tracer()
    assert cli.main(["sort_cli", int_file[0]], device="cpu", tracer=tr) == 0
    capsys.readouterr()
    assert tr.counters["encode_engine"] == "native"


def test_radix_pass_states_are_stable_lsd_states():
    """Pass k's state is the input stably sorted by its low k digits."""
    x = np.random.default_rng(4).integers(-(2**31), 2**31 - 1, 500, dtype=np.int32)
    u = x.view(np.uint32) ^ np.uint32(0x80000000)
    states = list(cli.radix_pass_states(x, 8))
    assert [k for k, _ in states] == [1, 2, 3, 4]
    for k, state in states:
        low = u & np.uint32((1 << (8 * k)) - 1) if k < 4 else u
        np.testing.assert_array_equal(state, x[np.argsort(low, kind="stable")])


# --------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "radix_pallas"])
def test_cli_on_the_card_matches_reference(engine, tmp_path, capsys, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU form)")
    x = np.random.default_rng(6).integers(-(2**31), 2**31 - 1, 1 << 16, dtype=np.int32)
    p = str(tmp_path / "k.txt")
    kio.write_keys_text(p, x)
    monkeypatch.setenv("SORT_LOCAL_ENGINE", engine)
    monkeypatch.setenv("SORT_RANKS", "1")
    assert ref_cli.main(["sort_cli", p]) == 0
    ref = capsys.readouterr()
    assert cli.main(["sort_cli", p]) == 0
    got = capsys.readouterr()
    assert _stdout(got.out) == _stdout(ref.out)
    assert _shape(got.err) == _shape(ref.err)
