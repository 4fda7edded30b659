"""The reduction from a profiler trace to the per-layer metrics, on a
synthetic trace: stage attribution, the union of overlapping intervals
for the idle share, the idle gaps' names and the roofline arithmetic.

    python -m pytest sortbench/ -q
"""

from __future__ import annotations

import pytest

from sortbench import harness, tracing
from sortbench.tracing import Capture, Ev, HostSpan

STAGES = {"local_sort": ["k1_", "cub::DeviceRadixSort"], "exchange": ["pack_rows", "a2a_push"]}
PEAKS = {"hbm_bytes_per_s": 1e12}


def capture() -> Capture:
    """Two calls of 1000 µs each.  Call 0: a K1 kernel 0-400 µs with a
    copy overlapping it at 300-500 µs, an exchange kernel 600-700 µs, idle
    500-600 and 700-1000.  Call 1 (1000-2000 µs): a library sort kernel
    1000-1800 on the device, a glue kernel 1800-1900 on a second stream
    overlapping nothing, idle 1900-2000.  A kernel before the calls is
    left out."""
    ops = [
        Ev("void k1_tile_sort<true>(unsigned int const*)", "kernel", 0, 400),
        Ev("Memcpy DtoD (Device -> Device)", "memcpy", 300, 500),
        Ev("(anonymous namespace)::pack_rows(PackPlanes)", "kernel", 600, 700),
        Ev("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>", "kernel", 1000, 1800),
        Ev("void at::native::vectorized_elementwise_kernel<4>", "kernel", 1800, 1900),
        Ev("warm-up kernel before the calls", "kernel", -500, -100),
    ]
    spans = [HostSpan("sort", 0, 990, 0), HostSpan("phase:verify", 650, 990, 1),
             HostSpan("sort", 1000, 1990, 0)]
    return Capture(ops, [(0.0, 1000.0), (1000.0, 2000.0)], spans)


def reduced(**kw: object) -> tracing.Profile:
    args = dict(key_bytes=10**6, ranks=8, chips=1, peaks=PEAKS)
    args.update(kw)
    return tracing.reduce(capture(), STAGES, **args)


def test_stage_of_takes_the_longest_pattern() -> None:
    stages = {"a": ["sort"], "b": ["DeviceRadixSort"]}
    assert tracing.stage_of("cub::DeviceRadixSortOnesweep", stages) == "b"
    assert tracing.stage_of("k9_unknown", stages) is None


def test_stage_times_and_launches_per_call() -> None:
    p = reduced()
    assert p.calls == 2 and p.kernels == 4
    assert p.stage_ms("local_sort") == pytest.approx((0.400 + 0.800) / 2)
    assert p.stage_ms("exchange") == pytest.approx(0.100 / 2)
    assert p.stage_ms(None) == pytest.approx((0.200 + 0.100) / 2)
    assert p.stage_kernels["exchange"] == ["(anonymous namespace)::pack_rows(PackPlanes)"]


def test_busy_time_is_the_union_of_overlapping_intervals() -> None:
    p = reduced()
    # 0-500 (K1 and the copy overlap), 600-700, 1000-1900: 1500 µs of 2000
    assert p.busy_s == pytest.approx(1500e-6)
    assert p.window_s == pytest.approx(2000e-6)
    assert harness.Bench.load().reader("per_layer", "device_idle_pct")(p) == pytest.approx(25.0)
    assert reduced(chips=2).busy_s == pytest.approx(750e-6)


def test_idle_gaps_are_named_by_the_spans_that_cover_them() -> None:
    gaps = [(n, round(s * 1e6)) for n, s in reduced().idle_gaps]
    # 700-1000 in call 0 (under verify), 500-600 in call 0, 1900-2000 in call 1
    assert gaps == [("sort > phase:verify", 300), ("sort", 100), ("sort", 100)]
    assert tracing.name_gap(995.0, capture().spans) == "outside sort()"


def test_roofline_arithmetic() -> None:
    bench = harness.Bench.load()
    p = reduced()
    local = bench.reader("per_layer", "local_sort_roofline")(p)
    # 2 x 1e6 bytes at 1e12 B/s = 2 µs, against 600 µs a call
    assert local == pytest.approx(100 * 2e-6 / 600e-6)
    exchange = bench.reader("per_layer", "exchange_roofline")(p)
    assert exchange == pytest.approx(100 * (2e6 * 7 / 8 / 1e12) / 50e-6)
    assert bench.reader("per_layer", "exchange_roofline")(reduced(ranks=1)) is None
    assert bench.reader("per_layer", "local_sort_roofline")(reduced(peaks=None)) is None
    assert bench.reader("per_layer", "kernel_launches_per_sort")(p) == 2.0


def test_a_reader_that_finds_nothing_returns_nothing() -> None:
    bench = harness.Bench.load()
    cap = capture()
    cap.ops = [e for e in cap.ops if "pack_rows" not in e.name]
    p = tracing.reduce(cap, STAGES, key_bytes=10**6, ranks=8, chips=1, peaks=PEAKS)
    assert bench.reader("per_layer", "exchange_ms")(p) is None
    assert bench.reader("per_layer", "exchange_roofline")(p) is None


def test_chrome_trace_parsing() -> None:
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k1_merge_round", "ts": 10.0, "dur": 5.0,
         "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 16.0, "dur": 1.0,
         "args": {"device": 0}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 9.0, "dur": 1.0},
        {"ph": "X", "cat": "user_annotation", "name": "sortbench.call.0", "ts": 8.0, "dur": 12.0},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 9.0},
    ]}
    ops, ranges = tracing.parse_chrome(trace)
    assert [(e.name, e.kind, e.t0, e.t1) for e in ops] == [
        ("k1_merge_round", "kernel", 10.0, 15.0), ("Memset (Device)", "memset", 16.0, 17.0)]
    assert ranges == {"sortbench.call.0": (8.0, 20.0)}
