"""The benchmark's sample-sort cell, ``int32-2p28-r8.sample``, and the route
it measures: ``sort(x, "sample", make_mesh(8))`` of device-resident int32
keys, where each rank sorts its shard (K1 on the card), splitters come
from evenly spaced samples, the cap from the probe's estimate, one ragged
exchange moves the buckets (K6/K7) and each rank sorts its received
``[P, cap]`` lanes (K1 again) before the ragged verifier.

* The cell through the harness (``harness.run``) at 2^14 keys on eight
  CPU ranks: the answer is correct, every call took the sample route (no
  call fell back to radix, ``sample_skew_fallback``), the untraced line
  reports ``mkeys_s``, the cell's own footprint metric and ``setup_s``, the
  traced line the int32 cells' per-layer metrics with the exchange's; the
  other cells keep the shared footprint.
* The faults of this route, with the program's verifier off so that the
  answer leaves the call: the merge's local sort handing back the received
  lanes as they came, and one rank's count off by one.  ``correct`` is
  false for each, and true for the same run with no fault.
* On a card (``cuda``-marked, skipped here): the cell at 2^24 with its
  per-layer metrics, and the merge fault.

The comparison's other faults (the control, an answer unchanged, half
left out, the exchange left out, one key altered) are held for this cell
in ``test_sortbench_control.py``.

    python -m pytest sortbench/ -q

Tolerance: exact (integer keys)."""

from __future__ import annotations

import time
from typing import Any

import pytest
import torch

from mpitest_tpu_torch.models import sample_sort
from mpitest_tpu_torch.ops import kernels
from sortbench import harness

torch.set_num_threads(1)

CELL = "int32-2p28-r8.sample"
#: The cells that report the shared end-to-end metrics.
SHARED = ["int32-2p30-r1.sort", "int32-2p28-r8.radix", "int64-2p28-r1.sort"]
E2E = {"mkeys_s", "peak_mem_gib.sample", "setup_s"}
#: The per-layer metrics the cell reports, the radix cell's too.
PER_LAYER = {"local_sort_ms", "local_sort_roofline", "exchange_ms", "exchange_roofline",
             "other_device_ms", "kernel_launches_per_sort", "device_idle_pct"}
LOG2_N = 14
SEED = 2**41 + 26


def small(name: str = CELL, log2_n: int = LOG2_N) -> tuple[harness.Bench, harness.Cell]:
    bench = harness.Bench.load()
    cell = bench.cell(name)
    cell.config["log2_n"] = log2_n
    return bench, cell


def run(cell_of: tuple[harness.Bench, harness.Cell], trace: bool = False,
        device: str = "cpu", seconds: float = 0.2) -> dict:
    bench, cell = cell_of
    return harness.run(bench, cell, SEED, seconds, trace, time.perf_counter(), device=device)


def tracers(monkeypatch) -> list[Any]:
    """Every tracer the harness hands the program, warm-up and window."""
    seen: list[Any] = []
    sound = harness.new_tracer

    def kept() -> Any:
        seen.append(sound())
        return seen[-1]

    monkeypatch.setattr(harness, "new_tracer", kept)
    return seen


def break_merge(monkeypatch) -> None:
    """The merge's local sort hands back each rank's received lanes as they
    came: in ``sample_sort_spmd`` the P shard sorts and the splitters' sort
    run as they are, every later local sort (the P merges) is left out."""
    sound_spmd, sound_sort = sample_sort.sample_sort_spmd, kernels.local_sort

    def spmd(words: Any, n_words: int, n_ranks: int, *a: Any, **kw: Any) -> Any:
        calls: list[int] = []

        def local_sort(w: Any, *a2: Any, **kw2: Any) -> Any:
            calls.append(1)
            return tuple(w) if len(calls) > n_ranks + 1 else sound_sort(w, *a2, **kw2)

        monkeypatch.setattr(kernels, "local_sort", local_sort)
        try:
            return sound_spmd(words, n_words, n_ranks, *a, **kw)
        finally:
            monkeypatch.setattr(kernels, "local_sort", sound_sort)

    monkeypatch.setattr(sample_sort, "sample_sort_spmd", spmd)


def shift_count(monkeypatch, delta: int) -> None:
    """Rank 0's count of valid keys comes back ``delta`` off."""
    sound = sample_sort.sample_sort_spmd

    def spmd(*a: Any, **kw: Any) -> Any:
        out, counts, max_cnt = sound(*a, **kw)
        return out, [counts[0] + delta, *counts[1:]], max_cnt

    monkeypatch.setattr(sample_sort, "sample_sort_spmd", spmd)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_takes_the_sample_route_and_is_correct(trace: bool, monkeypatch) -> None:
    seen = tracers(monkeypatch)
    out = run(small(), trace=trace)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["mismatched_keys"] == {"value": 0, "limit": 0}
    assert out["engines"]["exchange_passes"] == 1 and "digit_bits" not in out["engines"]
    assert seen and all("sample_skew_fallback" not in t.counters for t in seen)
    assert all(t.counters.get("exchange_passes") == 1 for t in seen)
    if trace:
        assert out["metrics"] and set(out["metrics"]) <= PER_LAYER
    else:
        assert set(out["metrics"]) == E2E


def test_the_cell_is_the_sources_size_and_its_metrics_only_its_own() -> None:
    bench, cell = small(log2_n=28)
    assert (cell.keys, cell.key_bytes, cell.config["ranks"], cell.chips) == (1 << 28, 1 << 30, 8, 1)
    assert cell.traffic["algorithm"] == "sample" and cell.traffic["pool"] == 16
    assert {m["name"] for m in bench.metrics(CELL, "end_to_end")} == E2E
    assert {m["name"] for m in bench.metrics(CELL, "per_layer")} == PER_LAYER
    assert PER_LAYER == {m["name"] for m in bench.metrics("int32-2p28-r8.radix", "per_layer")}
    assert all(m["moves"] == "mkeys_s" for m in bench.metrics(CELL, "per_layer"))
    for other in SHARED:
        assert "peak_mem_gib.sample" not in {m["name"] for m in bench.metrics(other, "end_to_end")}


@pytest.mark.parametrize("name", SHARED)
def test_the_other_cells_report_the_shared_metrics(name: str) -> None:
    out = run(small(name))
    assert out["correct"] is True
    assert set(out["metrics"]) == {"mkeys_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("merge", ["sound", "unsorted"])
def test_the_merge_handing_back_its_lanes_unsorted_fails(merge: str, monkeypatch) -> None:
    monkeypatch.setenv("SORT_VERIFY", "0")
    if merge == "unsorted":
        break_merge(monkeypatch)
    seen = tracers(monkeypatch)
    out = run(small())
    assert all("sample_skew_fallback" not in t.counters for t in seen)
    assert out["failed"] == 0
    assert out["correct"] is (merge == "sound")
    assert (out["checks"]["mismatched_keys"]["value"] > 0) is (merge == "unsorted")


@pytest.mark.parametrize("delta", [-1, 1])
def test_one_ranks_count_off_by_one_fails(delta: int, monkeypatch) -> None:
    monkeypatch.setenv("SORT_VERIFY", "0")
    shift_count(monkeypatch, delta)
    out = run(small())
    assert out["failed"] == 0
    assert out["correct"] is False and out["checks"]["mismatched_keys"]["value"] > 0


@pytest.fixture
def card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 and the exchange kernels have no CPU form)")


@pytest.mark.cuda
def test_on_the_card_the_cell_is_correct_and_its_metrics_read(card: None, monkeypatch) -> None:
    seen = tracers(monkeypatch)
    out = run(small(log2_n=24), trace=True, device="cuda", seconds=0.5)
    assert out["correct"] is True and out["device"]["busy_s"] > 0
    assert out["engines"]["local_engine"] == "bitonic"
    assert all("sample_skew_fallback" not in t.counters for t in seen)
    assert set(out["metrics"]) == PER_LAYER
    assert 0 < out["metrics"]["local_sort_roofline"]["value"] <= 100
    assert 0 < out["metrics"]["exchange_roofline"]["value"] <= 100
    assert any("k1_" in k for k in out["stage_kernels"]["local_sort"])
    assert any("a2a_push" in k for k in out["stage_kernels"]["exchange"])


@pytest.mark.cuda
def test_on_the_card_the_unsorted_merge_fails(card: None, monkeypatch) -> None:
    monkeypatch.setenv("SORT_VERIFY", "0")
    break_merge(monkeypatch)
    out = run(small(log2_n=24), device="cuda", seconds=0.5)
    assert out["engines"]["local_engine"] == "bitonic"
    assert out["correct"] is False and out["checks"]["mismatched_keys"]["value"] > 0
