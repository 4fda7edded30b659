"""The port's spans on a profiler's trace and its host reads counted
(``mpitest_tpu_torch/utils/spans.py``: ``SpanLog.span``'s
``record_function`` ranges, :func:`spans.host_sync`).

* The verifier reads its rows once a device a side: ``verify.fold``
  (the input fingerprint) and ``verify.check`` (the result).
* The sync guard: with ``torch.Tensor``'s reads to the host (``item``,
  ``__int__``, ``__float__``, ``__bool__``, ``cpu``, ``tolist``,
  ``numpy``) patched to count, a verified ``sort(..., return_result=True)``
  of device-resident keys makes none of them outside a ``host_sync``
  block, on one rank and on an eight-rank CPU mesh, and the
  ``host_syncs`` its spans carry add up to the blocks that read.
* Under a CPU ``torch.profiler`` every timed span is one ``user_annotation``
  range of its name, nested as the spans are, and every host read a
  ``host_sync:<what>`` range inside the range of the span it counts on.
* With no profiler recording, no ``record_function`` is made.
"""

from __future__ import annotations

import contextlib
import json
import traceback
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import mpitest_tpu_torch as mt
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.utils import spans
from mpitest_tpu_torch.utils.spans import SpanLog
from mpitest_tpu_torch.utils.trace import Tracer

#: ``torch.Tensor`` methods that copy a value to the host.
READS = ("item", "__int__", "__float__", "__bool__", "cpu", "tolist", "numpy")

#: The verifier's reads: the input fingerprint and the result's check,
#: each one read of its rows a device.
VERIFY = {"verify.fold", "verify.check"}

#: (algorithm, ranks, dtype, keys) of each path, and the ``what`` names it
#: reads under (int64 on one rank: the pair engine, from 2^13 keys).
PATHS = {
    "radix-r1": ("radix", 1, np.int32, 2125, VERIFY),
    "radix-r8": ("radix", 8, np.int32, 16461,
                 VERIFY | {"plan.diffs", "probe.counts", "dispatch.max_cnt"}),
    "sample-r8": ("sample", 8, np.int32, 16461,
                  VERIFY | {"sample.skew", "probe.counts", "dispatch.max_cnt",
                            "result.counts"}),
    "int64-r1": ("radix", 1, np.int64, 16307,
                 VERIFY | {"encode.same", "encode.dup", "pair.residual"}),
}


def _keys(n: int, dtype: type, seed: int) -> torch.Tensor:
    info = np.iinfo(dtype)
    x = np.random.default_rng(seed).integers(info.min, info.max, size=n, dtype=dtype)
    return torch.from_numpy(x)


def _sort(path: str, x: torch.Tensor, tracer: Tracer):
    algo, ranks = PATHS[path][:2]
    where = ({"device": "cpu"} if ranks == 1
             else {"mesh": make_mesh(ranks, devices=["cpu"] * ranks)})
    return mt.sort(x, algo, tracer=tracer, return_result=True, **where)


class Guard:
    """Counts the host reads made inside and outside ``host_sync`` blocks."""

    def __init__(self) -> None:
        self.depth = 0
        self.reads = 0
        self.unguarded: list[str] = []
        self.blocks: Counter[str] = Counter()
        self.empty_blocks: list[str] = []

    @contextlib.contextmanager
    def active(self, monkeypatch: pytest.MonkeyPatch):
        real_sync = spans.host_sync

        @contextlib.contextmanager
        def counting_sync(what: str):
            self.depth += 1
            before = self.reads
            try:
                with real_sync(what):
                    yield
            finally:
                self.depth -= 1
                self.blocks[what] += 1
                if self.reads == before:
                    self.empty_blocks.append(what)

        def patch(name: str):
            orig = getattr(torch.Tensor, name)

            def counted(t, *args, **kw):
                if self.depth:
                    self.reads += 1
                else:
                    self.unguarded.append(
                        f"{name}:\n" + "".join(traceback.format_stack(limit=4)[:-1]))
                return orig(t, *args, **kw)
            return counted

        with monkeypatch.context() as m:
            m.setattr(spans, "host_sync", counting_sync)
            for name in READS:
                m.setattr(torch.Tensor, name, patch(name))
            yield self


@pytest.mark.parametrize("path", list(PATHS))
def test_every_host_read_is_a_counted_host_sync(path, monkeypatch):
    _, _, dtype, n, names = PATHS[path]
    x = _keys(n, dtype, 11)
    want = np.sort(x.numpy())
    tr = Tracer()
    with Guard().active(monkeypatch) as g:
        res = _sort(path, x, tr)
    assert g.unguarded == []
    assert g.empty_blocks == []
    assert set(g.blocks) == names
    counted = sum(s.attrs.get("host_syncs", 0) for s in tr.spans.spans)
    assert counted == sum(g.blocks.values()) > 0
    assert all(s.attrs["host_sync_s"] >= 0 for s in tr.spans.spans if "host_syncs" in s.attrs)
    assert tr.counters["verify_runs"] >= 1
    assert np.array_equal(res.to_numpy(), want)


@pytest.mark.parametrize("path", list(PATHS))
def test_verifier_reads_once_a_device_a_side(path, monkeypatch):
    """A verified call reads the verifier's rows once a device for the
    input fingerprint and once for the result: one of each on one rank,
    and one of each on the CPU eight-rank mesh, whose ranks share the one
    CPU device."""
    x = _keys(PATHS[path][3], PATHS[path][2], 14)
    with Guard().active(monkeypatch) as g:
        _sort(path, x, Tracer())
    assert g.blocks["verify.fold"] == g.blocks["verify.check"] == 1


def test_host_sync_adds_to_the_innermost_open_span():
    log = SpanLog()
    with spans.host_sync("orphan"):   # no open span: nothing to count on
        pass
    with log.span("outer") as outer:
        with spans.host_sync("a"):
            pass
        with log.span("inner") as inner:
            for _ in range(3):
                with spans.host_sync("b"):
                    pass
    assert outer.attrs["host_syncs"] == 1 and inner.attrs["host_syncs"] == 3
    assert 0 <= inner.attrs["host_sync_s"] <= inner.dt
    # a read that raises still counts
    with log.span("failing") as failing, pytest.raises(RuntimeError):
        with spans.host_sync("c"):
            raise RuntimeError("read failed")
    assert failing.attrs["host_syncs"] == 1


def _ranges(prof: profile, tmp_path) -> list[dict]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"),
                  key=lambda e: (e["ts"], -e["dur"]))


def _inside(inner: dict, outer: dict) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("path", ["radix-r1", "radix-r8"])
def test_timed_spans_are_nested_profiler_ranges(path, tmp_path):
    x = _keys(PATHS[path][3], PATHS[path][2], 12)
    tr = Tracer()
    _sort(path, x, Tracer())      # the first call of each program key
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sort(path, x, tr)
    ranges = _ranges(prof, tmp_path)
    syncs = [r for r in ranges if r["name"].startswith("host_sync:")]
    ranges = [r for r in ranges if not r["name"].startswith("host_sync:")]
    timed = sorted((s for s in tr.spans.spans if s.dt > 0), key=lambda s: s.t0)
    assert [r["name"] for r in ranges] == [s.name for s in timed]
    assert {"sort", "phase:verify"} <= {s.name for s in timed}
    of = {s.id: r for s, r in zip(timed, ranges)}
    for s in timed:
        if s.parent is not None:
            assert _inside(of[s.id], of[s.parent]), s.name
    # each host_sync range lies in the range of the span it counted on,
    # and inside no range of a span nested in that one
    on: Counter[int] = Counter()
    for r in syncs:
        holders = [s for s in timed if _inside(r, of[s.id])]
        on[max(holders, key=lambda s: of[s.id]["ts"]).id] += 1
    assert on == Counter({s.id: s.attrs["host_syncs"] for s in timed
                          if "host_syncs" in s.attrs})
    assert sum(on.values()) > 0


class CountingRange(autograd_profiler.record_function):
    made = 0

    def __init__(self, *args, **kw):
        type(self).made += 1
        super().__init__(*args, **kw)


def test_no_record_function_without_a_profiler(monkeypatch):
    monkeypatch.setattr(autograd_profiler, "record_function", CountingRange)
    CountingRange.made = 0
    x = _keys(8 * 1024, np.int32, 13)
    assert not autograd_profiler._is_profiler_enabled
    _sort("radix-r8", x, Tracer())
    assert CountingRange.made == 0
    with profile(activities=[ProfilerActivity.CPU]):
        _sort("radix-r8", x, Tracer())
    assert CountingRange.made > 0
