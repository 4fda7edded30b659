"""The port's sort server (``mpitest_tpu_torch/serve/``) on CPU ranks: the
twins of the reference's serving tests (``tests/test_zz_serve.py``) —
the segmented core as the server drives it, the executor cache, admission,
batching, typed backpressure, per-request fault isolation, the spill tier,
the serve tuner's wiring, the knobs against the reference's, and the
driver (``python -m mpitest_tpu_torch.sort_server``) in a subprocess.  The
``cuda`` tests hold a served request to the kernels on a card."""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from mpitest_tpu.models import segmented as ref_sg
from mpitest_tpu.utils import knobs as ref_knobs
from mpitest_tpu_torch.models import segmented as sg
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.serve.admission import AdmissionControl, AdmissionReject
from mpitest_tpu_torch.serve.executor_cache import ExecutorCache
from mpitest_tpu_torch.utils import flight_recorder as fr
from mpitest_tpu_torch.utils import knobs
from mpitest_tpu_torch.utils.spans import SpanLog

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_recorder(monkeypatch, tmp_path):
    monkeypatch.setenv("SORT_FLIGHT_RECORDER_DIR", str(tmp_path / "flight"))
    fr.reset()
    yield
    fr.reset()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def serve_core(monkeypatch):
    """Factory of cores on CPU ranks configured through knobs (kept set for
    the test: the sorts read theirs per call); every core's dispatch
    thread is stopped at the end."""
    from mpitest_tpu_torch.serve.server import ServerCore

    made = []

    def make(P: int = 1, **env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        core = ServerCore(make_mesh(P, devices=["cpu"] * P))
        made.append(core)
        return core

    yield make
    for core in made:
        core.watchdog.stop()
        core.batcher.stop(timeout=10)


def _concurrent(core, arrs, **kw) -> dict:
    results: dict = {}

    def send(i):
        results[i] = core.execute(arrs[i], **kw)

    threads = [threading.Thread(target=send, args=(i,)) for i in range(len(arrs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


# ------------------------------------------------------- segmented core

def test_bucket_for_power_of_two_equals_reference():
    for n in (0, 1, 1023, 1024, 1025, 3000, 4096, 65536, 65537):
        assert sg.bucket_for(n) == ref_sg.bucket_for(n), n
    assert sg.MIN_BUCKET == ref_sg.MIN_BUCKET
    with pytest.raises(ValueError):
        sg.bucket_for(-1)


@pytest.mark.parametrize("dtype", ["int32", "uint64", "float64"])
def test_pack_sort_split_bit_parity(rng, dtype):
    """The packed dispatch on the CPU device is bit-identical to sorting
    each request alone, and every segment verifies."""
    dt = np.dtype(dtype)
    sizes = (307, 1, 900, 64)
    if dt.kind == "f":
        arrs = [rng.standard_normal(n) for n in sizes]
    else:
        info = np.iinfo(dt)
        arrs = [rng.integers(info.min, info.max, size=n, dtype=dt) for n in sizes]
    batch = sg.pack_segments(arrs, dt)
    sorted_words = sg.run_packed(batch, device="cpu")
    outs = sg.split_segments(batch, sorted_words)
    for a, o in zip(arrs, outs):
        assert np.array_equal(o.view(np.uint8), np.sort(a).view(np.uint8))
    assert all(sg.verify_segments(batch, sorted_words))


def test_verify_flags_only_the_corrupt_segment(rng):
    arrs = [rng.integers(-2**31, 2**31 - 1, size=256, dtype=np.int32)
            for _ in range(3)]
    batch = sg.pack_segments(arrs, np.dtype(np.int32))
    sw = tuple(w.copy() for w in sg.run_packed(batch, device="cpu"))
    sw[1][batch.offsets[1]] ^= 0x40
    assert sg.verify_segments(batch, sw) == [True, False, True]


# ------------------------------------------------------- executor cache

def test_executor_cache_hit_miss_and_bucket_reuse():
    log = SpanLog()
    cache = ExecutorCache(log, device="cpu")
    b1, b2 = sg.bucket_for(300), sg.bucket_for(900)
    assert b1 == b2
    cache.get_packed(b1, "int32", 2)
    cache.get_packed(b2, "int32", 2)
    assert cache.stats.misses == 1 and cache.stats.hits == 1
    cache.get_packed(sg.bucket_for(5000), "int32", 2)
    assert cache.stats.misses == 2
    events = [s for s in log.spans if s.name == "serve.compile_cache"]
    assert [e.attrs["hit"] for e in events] == [False, True, False]
    assert events[0].attrs["compile_s"] >= 0.0
    assert cache.snapshot()["buckets"] == [1024, 8192]


def test_executor_cache_prewarm_cpu_warms_on_its_device(monkeypatch):
    seen = []
    call = sg.PackedSort.__call__

    def spy(self, *words, device=None):
        seen.append((self.bucket, str(device)))
        return call(self, *words, device=device)

    monkeypatch.setattr(sg.PackedSort, "__call__", spy)
    cache = ExecutorCache(device="cpu")
    assert cache.build_kernels() == 0.0        # nothing is built for the CPU
    built = cache.prewarm((1024, 2048), ("int32",))
    assert built == 2
    assert cache.stats.buckets == {1024, 2048}
    assert seen == [(1024, "cpu"), (2048, "cpu")]
    cache.get_packed(1024, "int32", 2)
    assert cache.stats.hits == 1 and len(seen) == 2
    assert cache.missing_packed((1024, 4096), ("int32", "uint64")) == (
        (4096, "int32"), (1024, "uint64"), (4096, "uint64"))


def test_executor_cache_prewarm_builds_every_kernel_for_a_card(monkeypatch):
    """On a card the prewarm builds and loads every kernel source, and the
    build's seconds ride the first miss event's ``compile_s``."""
    import time

    from mpitest_tpu_torch.ops import _build

    calls = []

    def build(*names):
        time.sleep(0.05)
        calls.append(("build", names))

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build, "load", lambda name: calls.append(("load", name)))
    log = SpanLog()
    cache = ExecutorCache(log, device="cpu")
    cache.device = torch.device("cuda")        # what the build keys on
    monkeypatch.setattr(cache, "_warm", lambda nwt, b: sg.compile_packed_sort(nwt, b))
    assert cache.prewarm((1024, 2048), ("int32",)) == 2
    sources = ("bitonic", "exchange", "merge", "radix", "verify")
    assert calls == [("build", sources)] + [("load", n) for n in sources]
    misses = [s.attrs for s in log.spans if s.name == "serve.compile_cache"]
    assert misses[0]["compile_s"] >= 0.05 > misses[1]["compile_s"]
    assert cache.stats.compile_s >= 0.05


def test_executor_cache_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ExecutorCache()


# ---------------------------------------------------- admission control

def test_admission_typed_rejections():
    adm = AdmissionControl(max_inflight=2, max_bytes=1000)
    adm.admit(400)
    adm.admit(400)
    with pytest.raises(AdmissionReject) as e:
        adm.admit(10)
    assert e.value.reason == "inflight"
    adm.release(400)
    with pytest.raises(AdmissionReject) as e:
        adm.admit(700)
    assert e.value.reason == "bytes"
    adm.start_drain()
    with pytest.raises(AdmissionReject) as e:
        adm.admit(1)
    assert e.value.reason == "draining"
    adm.release(400)
    assert adm.wait_idle(timeout=1.0)
    assert adm.snapshot()["rejected"] == 3


# ----------------------------------------------------------- ServerCore

def test_core_batches_concurrent_requests(rng, serve_core):
    core = serve_core(SORT_SERVE_BATCH_WINDOW_MS="60")
    arrs = [rng.integers(-2**31, 2**31 - 1, size=400, dtype=np.int32)
            for _ in range(5)]
    results = _concurrent(core, arrs)
    for i, a in enumerate(arrs):
        st, out, _attrs = results[i]
        assert st == "ok" and np.array_equal(out, np.sort(a))
    assert any(r[2].get("batched") for r in results.values())
    assert core.batcher.batches < 5


def test_core_routes_large_requests_solo(rng, serve_core):
    core = serve_core(8, SORT_SERVE_BATCH_KEYS="512")
    a = rng.integers(-2**31, 2**31 - 1, size=2000, dtype=np.int32)
    st, out, attrs = core.execute(a)
    assert st == "ok" and np.array_equal(out, np.sort(a))
    assert attrs["batched"] is False and attrs["plan"]["algo"] == "sample"


def test_core_backpressure_typed(rng, serve_core):
    core = serve_core(SORT_SERVE_MAX_INFLIGHT="1",
                      SORT_SERVE_BATCH_WINDOW_MS="30")
    arrs = [rng.integers(-2**31, 2**31 - 1, size=256, dtype=np.int32)
            for _ in range(8)]
    statuses = [r[0] for r in _concurrent(core, arrs).values()]
    assert "backpressure" in statuses and "ok" in statuses
    assert set(statuses) <= {"backpressure", "ok"}
    a = rng.integers(-2**31, 2**31 - 1, size=64, dtype=np.int32)
    assert core.execute(a)[0] == "ok"
    assert core.metrics.counter("sort_serve_rejected_total").get(
        reason="inflight") >= 1


def test_per_request_fault_isolation(rng, serve_core):
    core = serve_core(8, SORT_SERVE_ALLOW_FAULTS="1", SORT_FALLBACK="0",
                      SORT_MAX_RETRIES="0")
    a = rng.integers(-2**31, 2**31 - 1, size=2048, dtype=np.int32)
    st, detail, _ = core.execute(a, faults_spec="result_swap:inf")
    assert st == "integrity", (st, detail)
    st2, out, _ = core.execute(a)
    assert st2 == "ok" and np.array_equal(out, np.sort(a))


def test_batch_fault_isolated_to_segment(rng, serve_core):
    core = serve_core(SORT_FAULTS="result_swap:1",
                      SORT_SERVE_BATCH_WINDOW_MS="60")
    arrs = [rng.integers(-2**31, 2**31 - 1, size=500, dtype=np.int32)
            for _ in range(4)]
    results = _concurrent(core, arrs)
    for i, a in enumerate(arrs):
        st, out, _attrs = results[i]
        assert st == "ok" and np.array_equal(out, np.sort(a))
    assert core.tracer.counters.get("serve_segment_requeues", 0) >= 1


def test_kernel_failure_is_internal_and_dumps_the_flight_ring(
        rng, serve_core, monkeypatch, tmp_path):
    """A kernel that fails to launch is never replaced by plain PyTorch:
    the request gets ``internal`` and the flight dump names the error."""
    from mpitest_tpu_torch.models import api
    from mpitest_tpu_torch.ops._build import KernelLaunchError

    core = serve_core(SORT_SERVE_BATCH_KEYS="128")

    def refuse(*a, **k):
        raise KernelLaunchError("CUDA kernel bitonic_u32 failed: test (code 7)")

    monkeypatch.setattr(api, "_sort_impl", refuse)
    a = rng.integers(-100, 100, size=500, dtype=np.int32)
    st, detail, _ = core.execute(a)
    assert st == "internal" and "KernelLaunchError" in detail
    assert core.tracer.counters.get("sort_retries", 0) == 0
    dumps = list((tmp_path / "flight").glob(
        "flight-*-serve_internal_KernelLaunchError-*.jsonl"))
    assert len(dumps) == 1
    names = [json.loads(ln).get("name") for ln in dumps[0].read_text().splitlines()]
    assert "sort" in names
    # the next request is served: one request's problem, not the server's
    monkeypatch.undo()
    st, out, _ = core.execute(a)
    assert st == "ok" and np.array_equal(out, np.sort(a))


def test_spill_tier_in_process_and_on_the_wire(rng, serve_core, monkeypatch, tmp_path):
    from mpitest_tpu_torch.serve.client import ServeClient
    from mpitest_tpu_torch.serve.server import SortServer

    monkeypatch.setenv("SORT_SPILL_DIR", str(tmp_path / "spill"))
    monkeypatch.setenv("SORT_SPILL_COMPRESS", "off")
    core = serve_core(SORT_SERVE_MAX_BYTES=str(1 << 14),
                      SORT_SERVE_BATCH_WINDOW_MS="0")
    a = rng.integers(-2**31, 2**31 - 1, size=1 << 13, dtype=np.int32)
    st, out, attrs = core.execute(a)
    assert st == "ok" and attrs["spilled"] is True
    assert np.array_equal(out, np.sort(a))
    assert attrs["plan"]["spilled"] is True
    srv = SortServer(core, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        with ServeClient("127.0.0.1", srv.bound_port, timeout=60) as c:
            r = c.sort(a)
            assert r.ok and r.spilled and np.array_equal(r.arr, np.sort(a))
            pay = rng.integers(0, 256, size=(a.size, 3), dtype=np.uint8)
            r = c.sort(a, payload=pay)
            order = np.argsort(a, kind="stable")
            assert r.ok and r.spilled
            assert np.array_equal(r.arr, a[order])
            assert np.array_equal(r.payload, pay[order])
    finally:
        srv.shutdown()
        srv.server_close()
    assert core.metrics.counter(
        "sort_external_spilled_requests_total").total() == 3
    assert not list((tmp_path / "spill").glob("in_*"))


@pytest.mark.parametrize("mode", ["shadow", "on"])
def test_serve_tuner_wiring(serve_core, mode):
    """``shadow`` logs the tuner's window decisions and changes nothing;
    ``on`` applies them to the batcher and warms the missing buckets on
    the dispatch thread."""
    core = serve_core(SORT_PLANNER=mode, SORT_SERVE_BATCH_WINDOW_MS="8",
                      SORT_SERVE_SHAPE_BUCKETS="10")
    warmed_on = []
    prewarm = core.cache.prewarm

    def spy(*a, **k):
        warmed_on.append(threading.current_thread().name)
        return prewarm(*a, **k)

    core.cache.prewarm = spy
    for _ in range(64):
        core._tuner_observe(50000, "int32")
    plans = [s.attrs for s in core.tracer.spans.spans if s.name == "sort.plan"
             and s.attrs.get("algo") == "serve_tuner"]
    chosen = {p["decisions"]["planner"]["chosen"] for p in plans}
    assert "window_auto" in chosen and "buckets_auto" in chosen
    applied = {p["decisions"]["planner"]["predicted"]["applied"] for p in plans}
    assert applied == {mode == "on"}
    if mode == "on":
        assert core.batcher.window_retunes >= 1
        assert core.batcher.window_s == pytest.approx(core.tuner.window_s)
        core.batcher.stop(timeout=10)           # runs the queued warm-up
        assert warmed_on and set(warmed_on) == {"serve-dispatch"}
        assert core.cache.stats.buckets >= {65536}
    else:
        assert core.batcher.window_s == pytest.approx(0.008)
        assert core.batcher.window_retunes == 0 and not warmed_on


# -------------------------------------------------------- knob contract

_SERVE_KNOBS = (
    "SORT_SERVE_PORT", "SORT_SERVE_HOST", "SORT_SERVE_MAX_INFLIGHT",
    "SORT_SERVE_MAX_BYTES", "SORT_SERVE_BATCH_WINDOW_MS",
    "SORT_SERVE_BATCH_KEYS", "SORT_SERVE_SHAPE_BUCKETS", "SORT_SERVE_PREWARM",
    "SORT_SERVE_ALLOW_FAULTS", "SORT_SERVE_IDLE_TIMEOUT_S",
    "SORT_SERVE_READ_TIMEOUT_S", "SORT_SERVE_DISPATCH_TIMEOUT_S",
    "SORT_SERVE_BREAKER_BACKOFF_S", "SORT_SERVE_COMPLETION_TIMEOUT_S",
    "SORT_SERVE_SPILL", "SORT_METRICS_PORT", "SORT_PROFILE_EVERY",
    "SORT_SENTINEL", "SORT_SENTINEL_WINDOW_S", "SORT_ALERT_BURN_RATE")

_RAWS = ("x", "-1", "0", "nan", "inf", "70000", "1.5", "2", "on", "auto",
         "10,zap", "14,10,14", "")


@pytest.mark.parametrize("name", _SERVE_KNOBS)
def test_serve_knob_equals_reference(name, monkeypatch):
    """Default, accepted values and the message of every bad value are the
    reference's."""
    monkeypatch.delenv(name, raising=False)
    assert knobs.get(name) == ref_knobs.get(name)
    for raw in _RAWS:
        monkeypatch.setenv(name, raw)
        got = want = None
        try:
            got = ("ok", knobs.get(name))
        except knobs.KnobError as e:
            got = ("err", str(e))
        try:
            want = ("ok", ref_knobs.get(name))
        except ref_knobs.KnobError as e:
            want = ("err", str(e))
        assert got == want, raw


def test_validate_iter_knobs_and_get_raw(monkeypatch):
    names = [k.name for k in knobs.iter_knobs()]
    assert names == sorted(names) and set(_SERVE_KNOBS) <= set(names)
    monkeypatch.setenv("SORT_SERVE_BATCH_KEYS", "77")
    assert knobs.get_raw("SORT_SERVE_BATCH_KEYS") == "77"
    monkeypatch.delenv("SORT_SERVE_PORT", raising=False)
    assert knobs.get_raw("SORT_SERVE_PORT") is None
    with pytest.raises(KeyError):
        knobs.get_raw("SORT_NOT_A_KNOB")
    knobs.validate("SORT_SERVE_BATCH_KEYS", "SORT_SERVE_PORT")
    monkeypatch.setenv("SORT_SERVE_PREWARM", "yes")
    with pytest.raises(knobs.KnobError, match="SORT_SERVE_PREWARM"):
        knobs.validate()


# ------------------------------------------- the driver, in a subprocess

_DRIVER = ("import sys; from mpitest_tpu_torch import sort_server; "
           "sys.exit(sort_server.main(['sort_server'], device='cpu'))")


def _driver_env(tmp_path, **extra) -> dict:
    env = dict(os.environ, SORT_SERVE_PORT="0", SORT_METRICS_PORT="0",
               SORT_SERVE_SHAPE_BUCKETS="10", OMP_NUM_THREADS="1",
               SORT_FLIGHT_RECORDER_DIR=str(tmp_path / "flight"),
               PYTHONPATH=str(REPO))
    env.update(extra)
    return env


def test_server_driver_wire_and_sigterm_drain(tmp_path):
    """Listening and metrics lines, a wire round trip, a typed bad-request
    error, a scrape, SIGQUIT (dump, keep serving), then SIGTERM -> drain,
    exit 0."""
    import urllib.request

    from mpitest_tpu_torch.serve.client import ServeClient
    from mpitest_tpu_torch.utils.metrics_live import parse_prom_text

    trace = tmp_path / "trace.jsonl"
    proc = subprocess.Popen([sys.executable, "-c", _DRIVER], cwd=tmp_path,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_driver_env(tmp_path, SORT_TRACE=str(trace)))
    try:
        line = proc.stdout.readline()
        m = re.search(r"^sort_server listening on 127\.0\.0\.1:(\d+)$", line.strip())
        assert m, f"no listening line: {line!r}"
        port = int(m.group(1))
        m2 = re.search(r"^sort_server metrics on 127\.0\.0\.1:(\d+)$",
                       proc.stdout.readline().strip())
        assert m2
        x = np.random.default_rng(3).integers(-2**31, 2**31 - 1, size=700,
                                              dtype=np.int32)
        with ServeClient("127.0.0.1", port, timeout=60) as c:
            r = c.sort(x, trace_id="wire-drill-1")
            assert r.ok and np.array_equal(r.arr, np.sort(x))
            assert r.trace_id == "wire-drill-1"
            bad = c.sort(np.arange(8, dtype=np.int32), algo="bogus")
            assert not bad.ok and bad.error == "bad_request"
            assert c.sort(x).ok
            bad_tid = c.sort(x, trace_id="spaces are not ok")
            assert not bad_tid.ok and bad_tid.error == "bad_request"
        with urllib.request.urlopen(f"http://127.0.0.1:{m2.group(1)}/metrics",
                                    timeout=10) as resp:
            fams = parse_prom_text(resp.read().decode())
        by_status = {lbl["status"]: v for _n, lbl, v in
                     fams["sort_serve_requests_total"]["samples"]}
        assert by_status == {"ok": 2.0}     # wire-level rejections: no request
        proc.send_signal(signal.SIGQUIT)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        err = proc.stderr.read()
        assert rc == 0, err[-2000:]
        assert "SIGQUIT: flight recorder dumped to" in err
        assert "drained=clean served_ok=2" in err
        names = {json.loads(ln)["name"] for ln in trace.read_text().splitlines()}
        assert {"serve.request", "serve.batch", "serve.compile_cache"} <= names
    finally:
        if proc.poll() is None:
            proc.kill()


def test_server_driver_refuses_bad_knobs_and_a_missing_card(tmp_path):
    """A bad knob is one [ERROR] line and exit 1; so is ``python -m
    mpitest_tpu_torch.sort_server`` on a machine without a card (it never
    serves from the CPU on its own)."""
    out = subprocess.run([sys.executable, "-c", _DRIVER], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=_driver_env(tmp_path, SORT_SERVE_MAX_INFLIGHT="0"))
    assert out.returncode == 1 and out.stdout == ""
    lines = out.stderr.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("[ERROR] SORT_SERVE_MAX_INFLIGHT=")
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "-m", "mpitest_tpu_torch.sort_server"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env=_driver_env(tmp_path))
    assert out.returncode == 1 and "listening" not in out.stdout
    lines = out.stderr.strip().splitlines()
    assert len(lines) == 1 and "needs a CUDA device" in lines[0]


# ------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU form)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_served_solo_request_launches_k1(card, monkeypatch):
    from mpitest_tpu_torch.ops import _build
    from mpitest_tpu_torch.serve.server import ServerCore

    monkeypatch.setenv("SORT_SERVE_BATCH_WINDOW_MS", "0")
    core = ServerCore(make_mesh(1))
    try:
        core.prewarm()
        a = np.random.default_rng(0).integers(-2**31, 2**31 - 1, size=1 << 20,
                                              dtype=np.int32)
        _build.reset_launches()
        st, out, attrs = core.execute(a)
        assert st == "ok" and attrs["batched"] is False
        assert np.array_equal(out, np.sort(a))
        assert _build.launches("bitonic_u32") >= 1
    finally:
        core.batcher.stop(timeout=30)


@pytest.mark.cuda
def test_served_eight_rank_request_launches_k6_k7(card, monkeypatch):
    from mpitest_tpu_torch.ops import _build
    from mpitest_tpu_torch.serve.server import ServerCore

    monkeypatch.setenv("SORT_SERVE_BATCH_WINDOW_MS", "0")
    core = ServerCore(make_mesh(8))
    try:
        core.prewarm()
        a = np.random.default_rng(1).integers(-2**31, 2**31 - 1, size=1 << 20,
                                              dtype=np.int32)
        _build.reset_launches()
        st, out, attrs = core.execute(a, algo="radix")
        assert st == "ok" and attrs["batched"] is False
        assert np.array_equal(out, np.sort(a))
        assert _build.launches("fused_pass_pack") >= 1
        assert _build.launches("remote_a2a") >= 1
    finally:
        core.batcher.stop(timeout=30)
