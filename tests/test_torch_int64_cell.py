"""The benchmark's 64-bit cell, ``int64-2p28-r1.sort``, and the route it
measures: ``sort(x)`` of device-resident int64 keys on one rank, where the
pair engine sorts (K2 orders the (hi, lo) word pairs by hi, K3 sorts the
lo words inside each run of equal hi, a run longer than its 16 passes
falls back to the library sort).

* The cell through the harness (``harness.run``) at 2^14 keys: the answer
  is correct, the pair engine ran, and a traced line reports only the
  cell's own per-layer metrics.
* The port against the plain reference (``sortbench/reference.py``) on
  keys whose high words repeat in runs: runs of 2-16 (K3 sorts them,
  also across its block seam at 2^17) and runs past 16 (the residual flag
  sends the call to the library sort, ``pair_residual_fallback``).  The
  high-word sniff would send such keys to the library sort before the
  pair engine, so it is patched off in these cases only.
* The fault of this route: K3 left out (its phase hands back the pair
  sort's lo words with no residual flag) with the program's verifier
  off, so the answer leaves the call: ``correct`` is false.  At 2^14 the
  cell's keys, uniform over the int64 range, hardly ever share a high
  word (about 1 pair in 32 arrays), so here the cell's range is narrowed
  to [-2^53, 2^53): about 1 key in 256 then shares its high word (1 in 16
  does at 2^28), and the sniff's 1024 picks of 2^22 high words rarely
  repeat; the line's engine shows the pair engine ran.
* On a card (``cuda``-marked, skipped here): the cell and the fault at
  2^24 with the cell's own keys.

Tolerance: exact (integer keys)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import mpitest_tpu_torch as port
from mpitest_tpu_torch.models import api
from mpitest_tpu_torch.ops import bitonic
from mpitest_tpu_torch.utils.trace import Tracer
from sortbench import harness, reference

torch.set_num_threads(1)

CELL = "int64-2p28-r1.sort"
#: The per-layer metrics of the cell.
PAIR_METRICS = {"pair_sort_ms", "pair_sort_roofline", "pair_glue_ms"}
LOG2_N = 14
SEED = 2**41 + 77
#: The cell's keys narrowed so that high words repeat at 2^14 (see above).
NARROW = {"distribution": "uniform", "low": -2**53, "high": 2**53}


def small(log2_n: int = LOG2_N, keys: dict | None = None) -> tuple[harness.Bench, harness.Cell]:
    bench = harness.Bench.load()
    cell = bench.cell(CELL)
    cell.config["log2_n"] = log2_n
    if keys is not None:
        cell.config["keys"] = keys
    return bench, cell


def run(cell_of: tuple[harness.Bench, harness.Cell], trace: bool = False,
        device: str = "cpu", seconds: float = 0.2) -> dict:
    bench, cell = cell_of
    return harness.run(bench, cell, SEED, seconds, trace, time.perf_counter(), device=device)


def k3_left_out(hi: torch.Tensor, lo: torch.Tensor, passes: int,
                b_log2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase B that does nothing: the pair sort's lo words, no residual."""
    return lo, torch.zeros((), dtype=torch.bool, device=hi.device)


def keys_in_runs(log2_n: int, shortest: int, longest: int, seed: int) -> torch.Tensor:
    """``2^log2_n`` int64 keys whose high words come in runs of
    ``shortest..longest`` equal values (the last run cut to fit), each run
    its own high word, the lo words random, the keys shuffled."""
    n = 1 << log2_n
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(shortest, longest + 1, (n // shortest + 1,), generator=g)
    runs = int((torch.cumsum(lens, 0) < n).sum()) + 1
    run_of = torch.repeat_interleave(torch.arange(runs), lens[:runs])[:n]
    # distinct high words spread over the int32 range: an odd multiplier
    # is a bijection of 32 bits
    hi = (torch.randperm(runs, generator=g) * 0x9E3779B1) % (1 << 32) - (1 << 31)
    lo = torch.randint(0, 1 << 32, (n,), generator=g, dtype=torch.int64)
    keys = hi[run_of] * (1 << 32) + lo
    return keys[torch.randperm(n, generator=g)]


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_the_pair_engine_and_is_correct(trace: bool) -> None:
    out = run(small(), trace=trace)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["mismatched_keys"] == {"value": 0, "limit": 0}
    assert out["engines"]["local_engine"] == "bitonic_pair"
    if trace:
        assert set(out["metrics"]) <= PAIR_METRICS
    else:
        assert set(out["metrics"]) == {"mkeys_s", "peak_mem_gib", "setup_s"}


def test_the_cell_is_the_sources_size_and_the_pair_metrics_only_its_own() -> None:
    bench, cell = small(log2_n=28)
    assert (cell.keys, cell.key_bytes, cell.config["ranks"], cell.chips) == (1 << 28, 1 << 31, 1, 1)
    assert cell.config["keys"] == {"distribution": "uniform", "low": -2**63, "high": 2**63 - 1}
    assert {m["name"] for m in bench.metrics(CELL, "per_layer")} == PAIR_METRICS
    for other in ("int32-2p30-r1.sort", "int32-2p28-r8.radix"):
        assert not PAIR_METRICS & {m["name"] for m in bench.metrics(other, "per_layer")}


@pytest.mark.parametrize("log2_n,shortest,longest,fallback", [
    (14, 2, 2, False), (14, 2, 16, False), (14, 16, 16, False), (17, 2, 16, False),
    (14, 17, 64, True), (14, 2, 64, True), (17, 40, 200, True)])
def test_the_pair_engine_matches_the_reference_on_equal_high_runs(
        log2_n: int, shortest: int, longest: int, fallback: bool, monkeypatch) -> None:
    monkeypatch.setattr(api, "_device_hi_dup_sniff", lambda hi: False)
    x = keys_in_runs(log2_n, shortest, longest, seed=log2_n * 1000 + longest)
    want = reference.sorted_keys(x)
    hi_sorted = want >> 32
    assert bool((hi_sorted[1:] == hi_sorted[:-1]).any())
    if log2_n > bitonic.PAIR_BLOCK_LOG2:
        seam = 1 << bitonic.PAIR_BLOCK_LOG2
        assert hi_sorted[seam - 1] == hi_sorted[seam]  # a run crosses K3's block seam
    tracer = Tracer()
    res = port.sort(x, "radix", return_result=True, device="cpu", tracer=tracer)
    got = res.to_numpy()
    assert got.dtype == np.int64
    assert reference.count_mismatches(got, want) == 0
    if fallback:
        assert tracer.counters["local_engine"] == "bitonic_pair+lax_fallback"
        assert tracer.counters["pair_residual_fallback"] == 1
    else:
        assert tracer.counters["local_engine"] == "bitonic_pair"
        assert "pair_residual_fallback" not in tracer.counters
    assert "pair_dup_reroute" not in tracer.counters


@pytest.mark.parametrize("k3", ["sound", "left_out"])
def test_k3_left_out_fails_the_comparison(k3: str, monkeypatch) -> None:
    monkeypatch.setenv("SORT_VERIFY", "0")
    if k3 == "left_out":
        monkeypatch.setattr(bitonic, "fix_runs_flag", k3_left_out)
    out = run(small(keys=NARROW))
    assert out["engines"]["local_engine"] == "bitonic_pair"
    assert out["correct"] is (k3 == "sound")
    assert (out["checks"]["mismatched_keys"]["value"] > 0) is (k3 == "left_out")


@pytest.fixture
def card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the pair engine's kernels have no CPU form)")


@pytest.mark.cuda
def test_on_the_card_the_cell_is_correct_and_the_pair_metrics_read(card: None) -> None:
    out = run(small(log2_n=24), trace=True, device="cuda", seconds=0.5)
    assert out["correct"] is True and out["device"]["busy_s"] > 0
    assert out["engines"]["local_engine"] == "bitonic_pair"
    assert set(out["metrics"]) == PAIR_METRICS
    names = out["stage_kernels"]["local_sort"]
    assert any("k2_" in k for k in names) and any("k3_" in k for k in names)


@pytest.mark.cuda
def test_on_the_card_k3_left_out_fails(card: None, monkeypatch) -> None:
    monkeypatch.setenv("SORT_VERIFY", "0")
    monkeypatch.setattr(bitonic, "fix_runs_flag", k3_left_out)
    out = run(small(log2_n=24), device="cuda", seconds=0.5)
    assert out["engines"]["local_engine"] == "bitonic_pair"
    assert out["correct"] is False and out["checks"]["mismatched_keys"]["value"] > 0

