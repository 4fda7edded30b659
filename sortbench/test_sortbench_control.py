"""The comparison that decides ``correct``: the sound program passes it,
and the control and the faults a cell can have fail it.

Each case drives the rest of a run (``harness.run``: pool, warm-up, a
short window, the kept answers decoded by the program and compared with
the reference) on the CPU at a small size, skipping only the look for a
card.  The faults break the timed path under the harness: either inside
the program (its local sort returning the keys unchanged, with the
program's own verifier off so the answer leaves the call) or in the
answer ``sort()`` returns.  The ``cuda`` case runs the control and the
program on the card.

    python -m pytest sortbench/ -q
"""

from __future__ import annotations

import time
from typing import Any, Callable

import pytest
import torch

import mpitest_tpu_torch as port
from mpitest_tpu_torch.models.api import DistributedSortResult
from mpitest_tpu_torch.ops import kernels
from mpitest_tpu_torch.ops.keys import SIGN_BIT, codec_for
from sortbench import harness, reference

#: The benchmark's int32 cells (the int64 cell's comparison is held in
#: ``tests/test_torch_int64_cell.py``).
CELLS = ["int32-2p30-r1.sort", "int32-2p28-r8.radix", "int32-2p28-r8.sample"]
LOG2_N = 14


def planes(res: DistributedSortResult) -> tuple[torch.Tensor, ...]:
    """The answer's valid words, every shard in rank order."""
    valid = res._valid()
    return tuple(torch.cat([s[k][:v] for s, v in zip(res.shards, valid)])
                 for k in range(len(res.shards[0])))


def answer(res: DistributedSortResult, words: tuple[torch.Tensor, ...]) -> DistributedSortResult:
    return DistributedSortResult(tuple(words), int(words[0].numel()), res.dtype)


def unchanged(x: torch.Tensor, res: DistributedSortResult, ranks: int) -> Any:
    """The sort hands back its input as it came."""
    return answer(res, codec_for(res.dtype).encode_torch(x.reshape(-1)))


def half_left_out(x: torch.Tensor, res: DistributedSortResult, ranks: int) -> Any:
    """Half of the keys never reach the answer."""
    w = planes(res)
    return answer(res, tuple(p[: p.numel() // 2] for p in w))


def exchange_left_out(x: torch.Tensor, res: DistributedSortResult, ranks: int) -> Any:
    """Each rank sorts its own shard and nothing crosses between ranks."""
    (w,) = codec_for(res.dtype).encode_torch(x.reshape(-1))
    parts = [torch.sort(c ^ SIGN_BIT).values ^ SIGN_BIT for c in w.chunk(ranks)]
    return answer(res, (torch.cat(parts),))


def altered(x: torch.Tensor, res: DistributedSortResult, ranks: int) -> Any:
    """One key of the answer is changed where it is produced."""
    w = planes(res)[0].clone()
    w[w.numel() // 3] ^= 1
    return answer(res, (w,))


FAULTS: dict[str, Callable[..., Any]] = {
    "unchanged": unchanged, "half_left_out": half_left_out,
    "exchange_left_out": exchange_left_out, "altered": altered}


def small(name: str) -> tuple[harness.Bench, harness.Cell]:
    """``name`` (``<config>.<traffic>``) at 2^14 keys; a pair that is not a
    cell of ``BENCHMARK.json`` is added to the loaded copy."""
    bench = harness.Bench.load()
    if all(w["name"] != name for w in bench.spec["workloads"]):
        config, traffic = name.rsplit(".", 1)
        bench.spec["workloads"].append({"name": name, "config": config,
                                        "traffic": traffic, "chips": 1})
    cell = bench.cell(name)
    cell.config["log2_n"] = LOG2_N
    return bench, cell


def cpu_run(name: str, **kw: Any) -> dict:
    bench, cell = small(name)
    return harness.run(bench, cell, 2**41 + 3, 0.2, False, time.perf_counter(),
                       device="cpu", **kw)


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_passes(name: str) -> None:
    out = cpu_run(name)
    assert out["correct"] is True
    assert out["checks"]["mismatched_keys"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name: str) -> None:
    out = cpu_run(name, make_call=lambda cell, device: reference.control_sort)
    assert out["correct"] is False
    assert out["checks"]["mismatched_keys"]["value"] > 0


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in FAULTS
    if not (fault == "exchange_left_out" and name.endswith("-r1.sort"))])
def test_a_fault_in_the_answer_fails(name: str, fault: str, monkeypatch) -> None:
    _, cell = small(name)
    ranks = int(cell.config["ranks"])
    sound = port.sort

    def broken(x: torch.Tensor, *a: Any, **kw: Any) -> Any:
        return FAULTS[fault](x, sound(x, *a, **kw), ranks)

    monkeypatch.setattr(port, "sort", broken)
    out = cpu_run(name)
    assert out["correct"] is False
    assert out["checks"]["mismatched_keys"]["value"] > 0


def test_a_local_sort_that_returns_its_input_fails(monkeypatch) -> None:
    monkeypatch.setenv("SORT_VERIFY", "0")
    monkeypatch.setattr(kernels, "local_sort", lambda words, *a, **kw: tuple(words))
    out = cpu_run("int32-2p30-r1.sort")
    assert out["correct"] is False
    assert out["checks"]["mismatched_keys"]["value"] > 0


def test_a_call_that_fails_in_the_window_fails(monkeypatch) -> None:
    sound, calls = port.sort, []
    traffic = small("int32-2p28-r8.radix")[1].traffic
    warm_up = max(traffic["pool"], traffic["check_calls"] + 1)

    def flaky(*a: Any, **kw: Any) -> Any:
        calls.append(1)
        if len(calls) > warm_up:
            raise RuntimeError("injected")
        return sound(*a, **kw)

    monkeypatch.setattr(port, "sort", flaky)
    out = cpu_run("int32-2p28-r8.radix")
    assert out["correct"] is False and out["failed"] >= 1
    assert out["checks"]["failed_calls"]["value"] == out["failed"]


@pytest.fixture
def card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card_the_program_passes_and_the_control_fails(card: None, name: str) -> None:
    bench, cell = small(name)
    cell.config["log2_n"] = 22
    ok = harness.run(bench, cell, 2**35 + 1, 0.5, True, time.perf_counter())
    bad = harness.run(bench, cell, 2**35 + 2, 0.5, False, time.perf_counter(),
                      make_call=lambda c, d: reference.control_sort)
    assert ok["correct"] is True and ok["device"]["busy_s"] > 0
    assert bad["correct"] is False
