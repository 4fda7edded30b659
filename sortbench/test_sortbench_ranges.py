"""Device time by the program's ranges (``sortbench/ranges.py``), on
synthetic chrome traces: launch attribution through ``correlation``, the
stream-order fallback and the unattributed rest, the idle gaps named from
in-trace ranges (the same names ``tracing.py`` gives the same spans), the
idle that begins in a host read with the device's queue empty, and the
three per-layer numbers, None without program ranges.

    python -m pytest sortbench/ -q
"""

from __future__ import annotations

import pytest

from sortbench import ranges, tracing
from sortbench.test_sortbench_tracing import STAGES, capture

PID, TID = 7, 70


def annotation(name: str, t0: float, t1: float, tid: int = TID) -> dict:
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": t0,
            "dur": t1 - t0, "pid": PID, "tid": tid}


def launch(corr: int, t: float, cat: str = "cuda_runtime", tid: int = TID) -> dict:
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": t, "dur": 2.0,
            "pid": PID, "tid": tid, "args": {"correlation": corr}}


def device_op(name: str, t0: float, t1: float, corr: int | None = None,
              cat: str = "kernel", stream: int = 7) -> dict:
    args = {"device": 0, "stream": stream}
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": t1 - t0,
            "pid": 0, "tid": stream, "args": args}


def sort_trace() -> dict:
    """One call 0-1000 µs: ``sort`` 10-990 holds ``phase:sort`` 20-400 and
    ``phase:verify`` 400-980, which holds ``host_sync:verify.sum``
    600-700.  Kernels: a sort kernel launched at 30 runs 40-300; a verify
    kernel launched at 410 runs 420-590; a copy launched at 610 runs
    620-640 (the read); a kernel launched at 720 runs 750-900.  The device
    idles 0-40, 300-420 (begins under ``phase:sort``), 590-620 (under
    verify), 640-750 (begins inside the host read) and 900-1000."""
    return {"traceEvents": [
        annotation("sortbench.call.0", 0, 1000),
        annotation("sort", 10, 990),
        annotation("phase:sort", 20, 400),
        annotation("phase:verify", 400, 980),
        annotation("host_sync:verify.sum", 600, 700),
        launch(1, 30), launch(2, 410), launch(3, 610, "cuda_driver"), launch(4, 720),
        device_op("k1_tile_sort", 40, 300, 1),
        device_op("reduce_kernel", 420, 590, 2),
        device_op("Memcpy DtoH", 620, 640, 3, cat="gpu_memcpy"),
        device_op("xor_kernel", 750, 900, 4),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 30.0},
    ]}


def test_parse_collects_ranges_launches_and_correlation() -> None:
    p = ranges.parse(sort_trace())
    assert p.calls == [(0.0, 1000.0)]
    assert [r.name for r in p.ranges] == ["sort", "phase:sort", "phase:verify",
                                          "host_sync:verify.sum"]
    assert p.launches[3] == (610.0, (PID, TID))
    assert [(o.name, o.kind, o.corr) for o in p.ops] == [
        ("k1_tile_sort", "kernel", 1), ("reduce_kernel", "kernel", 2),
        ("Memcpy DtoH", "memcpy", 3), ("xor_kernel", "kernel", 4)]
    assert p.caller == (PID, TID)


def test_operations_take_the_ranges_around_their_launch() -> None:
    p = ranges.parse(sort_trace())
    assert ranges.attribute(p) == [
        ("sort", "phase:sort"), ("sort", "phase:verify"),
        ("sort", "phase:verify", "host_sync:verify.sum"), ("sort", "phase:verify")]
    prof = ranges.reduce(p)
    ms = prof.range_ms()
    assert ms["sort"] == pytest.approx(0.260 + 0.170 + 0.020 + 0.150)
    assert ms["phase:sort"] == pytest.approx(0.260)
    assert ms["phase:verify"] == pytest.approx(0.340)
    assert ms["host_sync:verify.sum"] == pytest.approx(0.020)
    assert ms[ranges.UNATTRIBUTED] == 0.0
    assert ranges.verify_ms(prof) == pytest.approx(0.340)


def test_a_launch_on_another_thread_takes_that_thread_s_ranges() -> None:
    trace = sort_trace()
    trace["traceEvents"] += [annotation("egress.copy", 100, 200, tid=71),
                             launch(5, 150, tid=71), device_op("copy", 310, 320, 5, stream=9)]
    p = ranges.parse(trace)
    assert ranges.attribute(p)[-1] == ("egress.copy",)


def test_stream_order_places_what_has_no_launch() -> None:
    trace = sort_trace()
    trace["traceEvents"] += [
        # no launch event: between the two verify kernels on stream 7
        device_op("ctypes_kernel", 595, 615),
        # no launch, last on its stream: nothing after it to agree with
        device_op("late_kernel", 905, 945),
        # no launch, alone on stream 8
        device_op("lonely", 950, 960, stream=8),
    ]
    p = ranges.parse(trace)
    got = ranges.attribute(p)
    assert got[4] == ("sort", "phase:verify")     # shared head of both neighbours
    assert got[5] is None and got[6] is None
    prof = ranges.reduce(p)
    assert prof.unattributed_s == pytest.approx(50e-6)
    assert prof.range_ms()[ranges.UNATTRIBUTED] == pytest.approx(0.050)
    assert prof.device_s == pytest.approx((260 + 170 + 20 + 150 + 20 + 40 + 10) * 1e-6)


def test_stream_order_keeps_only_the_shared_head() -> None:
    trace = sort_trace()
    trace["traceEvents"].append(device_op("between", 350, 360))
    got = ranges.attribute(ranges.parse(trace))
    # after a phase:sort kernel and before a phase:verify one: only "sort"
    assert got[4] == ("sort",)


def test_sync_idle_counts_gaps_that_begin_inside_a_host_read() -> None:
    prof = ranges.reduce(ranges.parse(sort_trace()))
    # 640-750 begins inside host_sync:verify.sum (600-700); 590-620 ends
    # inside it but began before it, so it does not count
    assert prof.sync_idle_s == pytest.approx(110e-6)
    assert ranges.sync_idle_ms(prof) == pytest.approx(0.110)
    assert prof.idle_s == pytest.approx((40 + 120 + 30 + 110 + 100) * 1e-6)
    assert ranges.sync_idle_ms(ranges.reduce(ranges.parse(sort_trace()), chips=2)) == \
        pytest.approx(0.055)


def test_a_gap_between_queued_operations_is_no_sync_idle() -> None:
    """A kernel launched at 615, before the read's copy ends, runs 660-670:
    the gap 640-660 begins inside the read but the queue still held that
    kernel; 670-750 is the device run dry."""
    trace = sort_trace()
    trace["traceEvents"] += [launch(6, 615), device_op("queued_kernel", 660, 670, 6)]
    prof = ranges.reduce(ranges.parse(trace))
    assert prof.sync_idle_s == pytest.approx(80e-6)
    assert prof.idle_s == pytest.approx((40 + 120 + 30 + 20 + 80 + 100) * 1e-6)


def test_host_syncs_per_sort_counts_the_ranges_inside_the_calls() -> None:
    trace = sort_trace()
    trace["traceEvents"] += [
        annotation("sortbench.call.1", 1000, 2000),
        annotation("sort", 1010, 1990),
        annotation("host_sync:verify.sum", 1100, 1110),
        annotation("host_sync:verify.xor", 1200, 1210),
        annotation("host_sync:verify.xor", 1300, 1310),
        # before the first call: not counted
        annotation("host_sync:probe.counts", -50, -40),
    ]
    prof = ranges.reduce(ranges.parse(trace))
    assert prof.calls == 2
    assert ranges.host_syncs_per_sort(prof) == 2.0
    assert prof.syncs == {"verify.sum": 2, "verify.xor": 2}


def test_gap_names_from_in_trace_ranges_match_the_offset_path() -> None:
    """The spans and operations of ``test_sortbench_tracing.capture``,
    written as a chrome trace: the gaps get the names ``tracing.reduce``
    gave them from the offset-placed spans."""
    cap = capture()
    events = [annotation(f"sortbench.call.{i}", c0, c1) for i, (c0, c1) in enumerate(cap.calls)]
    events += [annotation(s.name, s.t0, s.t1) for s in cap.spans]
    for i, e in enumerate(cap.ops):
        cat = {"kernel": "kernel", "memcpy": "gpu_memcpy"}[e.kind]
        events += [launch(i, e.t0 - 1), device_op(e.name, e.t0, e.t1, i, cat=cat)]
    prof = ranges.reduce(ranges.parse({"traceEvents": events}))
    old = tracing.reduce(cap, STAGES, key_bytes=1, ranks=8, chips=1, peaks=None)
    assert prof.idle_gaps == old.idle_gaps
    assert [n for n, _ in prof.idle_gaps] == ["sort > phase:verify", "sort", "sort"]


def test_without_program_ranges_the_readers_return_nothing() -> None:
    trace = {"traceEvents": [e for e in sort_trace()["traceEvents"]
                             if e.get("cat") != "user_annotation"
                             or e["name"].startswith("sortbench.call.")]}
    prof = ranges.reduce(ranges.parse(trace))
    assert prof.program_ranges == 0
    assert ranges.verify_ms(prof) is None
    assert ranges.host_syncs_per_sort(prof) is None
    assert ranges.sync_idle_ms(prof) is None
    # launched, but outside every program range
    assert prof.range_ms()[ranges.OUTSIDE] == pytest.approx(0.600)
    assert [n for n, _ in prof.idle_gaps] == [ranges.OUTSIDE] * 5


def test_chains_of_nested_ranges() -> None:
    rs = [ranges.Range("a", 0, 100), ranges.Range("b", 10, 40), ranges.Range("c", 20, 30),
          ranges.Range("d", 50, 90)]
    assert ranges.chains(rs, [25, 5, 45, 60, 100, 150, 40]) == [
        ("a", "b", "c"), ("a",), ("a",), ("a", "d"), ("a",), (), ("a", "b")]
