"""The port stands alone: importing it (the store included) pulls in
neither ``jax`` nor the reference package, no source file of it (nor
``chip_smoke.py``) imports them, and ``sort()`` never falls back to the
CPU on its own."""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mpitest_tpu)(\.|\s|$|,)",
                        re.MULTILINE)


def test_import_pulls_in_no_jax():
    code = ("import sys, mpitest_tpu_torch, mpitest_tpu_torch.ops.kernels, "
            "mpitest_tpu_torch.ops.radix, mpitest_tpu_torch.utils.io, "
            "mpitest_tpu_torch.utils.native_encode, mpitest_tpu_torch.cli, "
            "mpitest_tpu_torch.ops.pack, mpitest_tpu_torch.ops.exchange, "
            "mpitest_tpu_torch.parallel.mesh, mpitest_tpu_torch.parallel.collectives, "
            "mpitest_tpu_torch.models.radix_sort, mpitest_tpu_torch.models.sample_sort, "
            "mpitest_tpu_torch.store.external, mpitest_tpu_torch.store.merge, "
            "mpitest_tpu_torch.store.runs, mpitest_tpu_torch.store.compress, "
            "mpitest_tpu_torch.store.aio, mpitest_tpu_torch.store.manifest, "
            "mpitest_tpu_torch.models.records, mpitest_tpu_torch.models.segmented, "
            "mpitest_tpu_torch.models.ingest, mpitest_tpu_torch.utils.spans, "
            "mpitest_tpu_torch.utils.trace, mpitest_tpu_torch.utils.metrics, "
            "mpitest_tpu_torch.utils.timeline, mpitest_tpu_torch.utils.span_schema, "
            "mpitest_tpu_torch.utils.flight_recorder, mpitest_tpu_torch.faults, "
            "mpitest_tpu_torch.models.supervisor, mpitest_tpu_torch.models.plan, "
            "mpitest_tpu_torch.models.planner, mpitest_tpu_torch.doctor, "
            "mpitest_tpu_torch.report, mpitest_tpu_torch.utils.metrics_live, "
            "mpitest_tpu_torch.serve, mpitest_tpu_torch.serve.admission, "
            "mpitest_tpu_torch.serve.batching, mpitest_tpu_torch.serve.client, "
            "mpitest_tpu_torch.serve.executor_cache, mpitest_tpu_torch.serve.watchdog, "
            "mpitest_tpu_torch.serve.sentinel, mpitest_tpu_torch.serve.telemetry, "
            "mpitest_tpu_torch.serve.server, mpitest_tpu_torch.sort_server, "
            "mpitest_tpu_torch.utils.thread_registry, mpitest_tpu_torch.selftest, "
            "mpitest_tpu_torch.selftest.wire_chaos, mpitest_tpu_torch.selftest.spawned, "
            "mpitest_tpu_torch.selftest.drills\n"
            "from mpitest_tpu_torch.store.runs import InputStage, run_body_views\n"
            "mpitest_tpu_torch.external_sort\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mpitest_tpu' or "
            "m.startswith('mpitest_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_imports_jax_or_reference():
    files = sorted((REPO / "mpitest_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"mpitest_tpu_torch/ops/radix.py", "mpitest_tpu_torch/utils/io.py",
            "mpitest_tpu_torch/utils/native_encode.py",
            "mpitest_tpu_torch/cli.py", "mpitest_tpu_torch/ops/pack.py",
            "mpitest_tpu_torch/ops/exchange.py", "mpitest_tpu_torch/parallel/mesh.py",
            "mpitest_tpu_torch/parallel/collectives.py",
            "mpitest_tpu_torch/models/radix_sort.py",
            "mpitest_tpu_torch/models/sample_sort.py",
            "mpitest_tpu_torch/store/__init__.py", "mpitest_tpu_torch/store/external.py",
            "mpitest_tpu_torch/faults.py",
            "mpitest_tpu_torch/store/merge.py", "mpitest_tpu_torch/store/runs.py",
            "mpitest_tpu_torch/store/compress.py", "mpitest_tpu_torch/store/aio.py",
            "mpitest_tpu_torch/store/manifest.py", "mpitest_tpu_torch/models/records.py",
            "mpitest_tpu_torch/models/segmented.py",
            "mpitest_tpu_torch/models/ingest.py", "mpitest_tpu_torch/utils/spans.py",
            "mpitest_tpu_torch/utils/trace.py", "mpitest_tpu_torch/utils/metrics.py",
            "mpitest_tpu_torch/utils/timeline.py",
            "mpitest_tpu_torch/utils/span_schema.py",
            "mpitest_tpu_torch/utils/flight_recorder.py",
            "mpitest_tpu_torch/models/plan.py", "mpitest_tpu_torch/models/planner.py",
            "mpitest_tpu_torch/doctor.py", "mpitest_tpu_torch/report.py",
            "mpitest_tpu_torch/utils/metrics_live.py",
            "mpitest_tpu_torch/serve/__init__.py",
            "mpitest_tpu_torch/serve/admission.py",
            "mpitest_tpu_torch/serve/batching.py",
            "mpitest_tpu_torch/serve/client.py",
            "mpitest_tpu_torch/serve/executor_cache.py",
            "mpitest_tpu_torch/serve/watchdog.py",
            "mpitest_tpu_torch/serve/sentinel.py",
            "mpitest_tpu_torch/serve/telemetry.py",
            "mpitest_tpu_torch/serve/server.py",
            "mpitest_tpu_torch/sort_server.py",
            "mpitest_tpu_torch/utils/thread_registry.py",
            "mpitest_tpu_torch/selftest/wire_chaos.py",
            "mpitest_tpu_torch/selftest/spawned.py",
            "mpitest_tpu_torch/selftest/drills.py"} <= names
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} imports {hits}"


@pytest.mark.parametrize("rel", ["mpitest_tpu_torch/models/plan.py",
                                 "mpitest_tpu_torch/models/planner.py",
                                 "mpitest_tpu_torch/doctor.py",
                                 "mpitest_tpu_torch/utils/thread_registry.py"])
def test_vocabulary_modules_load_standalone_on_the_stdlib(rel):
    """plan.py, planner.py and doctor.py load by file path, with no
    package context, and import neither torch nor numpy (as in the
    reference: their registries must resolve without the package)."""
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('m', {rel!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "sys.modules['m'] = m\n"
            "spec.loader.exec_module(m)\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'mpitest_tpu', 'mpitest_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("rel", ["mpitest_tpu_torch/utils/metrics_live.py",
                                 "mpitest_tpu_torch/serve/admission.py",
                                 "mpitest_tpu_torch/serve/batching.py",
                                 "mpitest_tpu_torch/serve/client.py"])
def test_wire_and_registry_modules_load_without_torch(rel):
    """The client, admission, batching and the metrics registry load by
    file path with no package context and import no torch (the client
    imports nothing of the server stack, as in the reference)."""
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('m', {rel!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "sys.modules['m'] = m\n"
            "spec.loader.exec_module(m)\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('torch', 'jax', 'mpitest_tpu', 'mpitest_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_server_core_without_a_card_raises(monkeypatch):
    """``ServerCore()`` with no mesh serves from the card or not at all:
    without CUDA it raises and never falls back to CPU ranks."""
    from mpitest_tpu_torch.serve.server import ServerCore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ServerCore()


def test_only_the_dispatch_thread_calls_torch(monkeypatch):
    """Over real sockets, batched, solo, record and spill requests: every
    call that would touch the card (``sort()``, the packed sort, the
    external sort, the device read-back) runs on the batcher's dispatch
    thread, never on a handler thread."""
    import threading

    from mpitest_tpu_torch.models import api, segmented
    from mpitest_tpu_torch.ops import keys
    from mpitest_tpu_torch.parallel.mesh import make_mesh
    from mpitest_tpu_torch.serve.client import ServeClient
    from mpitest_tpu_torch.serve.server import ServerCore, SortServer
    from mpitest_tpu_torch.store import external

    seen: list[tuple[str, str]] = []

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            seen.append((name, threading.current_thread().name))
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(api, "sort")
    devices: list[str] = []
    packed_call = segmented.PackedSort.__call__

    def packed(self, *words, device=None):
        seen.append(("__call__", threading.current_thread().name))
        devices.append(str(device))
        return packed_call(self, *words, device=device)

    monkeypatch.setattr(segmented.PackedSort, "__call__", packed)
    spy(keys, "to_host_words")
    spy(segmented, "to_host_words")
    spy(external, "external_sort")
    monkeypatch.setenv("SORT_SERVE_BATCH_WINDOW_MS", "20")
    monkeypatch.setenv("SORT_SERVE_BATCH_KEYS", "4096")
    monkeypatch.setenv("SORT_SERVE_MAX_BYTES", str(1 << 16))
    monkeypatch.setenv("SORT_SPILL_COMPRESS", "off")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    core = ServerCore(make_mesh(2, devices=["cpu"] * 2))
    srv = SortServer(core, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    rng = np.random.default_rng(9)
    try:
        arrs = [rng.integers(-2**31, 2**31 - 1, size=n, dtype=np.int32)
                for n in (300, 700, 5000, 1 << 15)]
        errs: list = []

        def client(x):
            try:
                with ServeClient("127.0.0.1", srv.bound_port, timeout=60) as c:
                    r = c.sort(x)
                    assert r.ok and np.array_equal(r.arr, np.sort(x))
                    p = rng.integers(0, 256, size=(x.size, 2), dtype=np.uint8)
                    assert c.sort(x, payload=p).ok
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        cs = [threading.Thread(target=client, args=(x,)) for x in arrs]
        for c in cs:
            c.start()
        for c in cs:
            c.join()
        assert not errs, errs
    finally:
        srv.shutdown()
        srv.server_close()
        core.batcher.stop(timeout=10)
        torch.set_num_threads(threads)
    names = {n for n, _t in seen}
    assert {"sort", "__call__", "external_sort"} <= names, names
    assert {th for _n, th in seen} == {"serve-dispatch"}, seen
    # the batch runs on the mesh's first rank (here the CPU), never the
    # packed sort's default, the card
    assert devices and set(devices) == {"cpu"}


def test_pattern_catches_forbidden_imports():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from mpitest_tpu.ops import keys")
    assert _FORBIDDEN.search("    import mpitest_tpu")
    assert not _FORBIDDEN.search("from mpitest_tpu_torch.ops import keys")


def test_sort_without_device_needs_cuda(monkeypatch):
    import mpitest_tpu_torch as mt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mt.sort(np.arange(10, dtype=np.int32))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mt.sort(torch.arange(10, dtype=torch.int32))
    assert mt.sort(np.arange(10, dtype=np.int32)[::-1],
                   device="cpu").tolist() == list(range(10))


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke script exits non-zero and prints no result
    line; alone in a directory (without the package) it fails too."""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
