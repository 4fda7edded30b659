"""The port's concurrency registry under the reference's threadlint engine.

``mpitest_tpu_torch/utils/thread_registry.py`` registers every thread
root and lock of the port; ``tools.threadlint`` (the reference's engine,
unchanged) lints every ``.py`` file of ``mpitest_tpu_torch/`` against it
with ``torch`` as the device surface and the port's ``device_ok`` mapped
onto the engine's ``jax_ok``.  The port lints clean; planted faults in
copies of its own sources fire the rules; the two repairs the lint led
to (the kernel build and the spill codec build out of their locks) are
pinned at run time too.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from tools.registry_load import load_registry_module
from tools.threadlint import Registry, Root, lint_files

REPO = Path(__file__).resolve().parent.parent
REGISTRY_PATH = REPO / "mpitest_tpu_torch" / "utils" / "thread_registry.py"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _module():
    return load_registry_module("_port_thread_registry", REGISTRY_PATH, register=True)


def port_registry() -> Registry:
    """The engine's registry from the port's module: ``device_ok`` is the
    engine's ``jax_ok`` and ``torch`` its surface head."""
    mod = _module()
    return Registry(
        roots=[Root(r.name, r.kind, r.entry, r.device_ok) for r in mod.THREAD_ROOTS],
        locks=mod.LOCKS, lock_aliases=mod.LOCK_ALIASES,
        receiver_types=mod.RECEIVER_TYPES, attr_calls=mod.ATTR_CALLS,
        return_types=mod.RETURN_TYPES, extra_edges=mod.EXTRA_EDGES,
        jax_surface_heads=mod.DEVICE_SURFACE_HEADS,
        jax_surface_calls=mod.DEVICE_SURFACE_CALLS,
        blocking_calls=mod.BLOCKING_CALLS, compile_funcs=mod.COMPILE_FUNCS,
        gil_wedge_calls=mod.GIL_WEDGE_CALLS, gil_wedge_home=mod.GIL_WEDGE_HOME,
        atomic_ok=mod.ATOMIC_OK)


def port_files() -> dict[str, str]:
    return {p.relative_to(REPO).as_posix(): p.read_text()
            for p in sorted((REPO / "mpitest_tpu_torch").rglob("*.py"))}


def lint(files: dict[str, str], check_vocab: bool = True) -> list:
    return lint_files(files, port_registry(), check_vocab=check_vocab)


def planted(path: str, old: str, new: str) -> dict[str, str]:
    """The port's files with one source edited (``old`` must occur once)."""
    files = port_files()
    assert files[path].count(old) == 1, (path, old)
    files[path] = files[path].replace(old, new)
    return files


def test_registry_loads_on_the_stdlib_alone():
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('m', {str(REGISTRY_PATH)!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "sys.modules['m'] = m\n"
            "spec.loader.exec_module(m)\n"
            "print(len(m.THREAD_ROOTS), len(m.LOCKS), sorted(k for k in sys.modules "
            "if k.split('.')[0] in ('torch', 'numpy', 'jax', 'mpitest_tpu', "
            "'mpitest_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    roots, locks, mods = out.stdout.split(" ", 2)
    assert int(roots) > 10 and int(locks) > 10 and mods.strip() == "[]"


def test_the_port_lints_clean():
    findings = lint(port_files())
    assert findings == [], "\n".join(f.render() for f in findings)


def test_device_ok_roots_are_the_audited_list():
    mod = _module()
    ok = {r.name for r in mod.THREAD_ROOTS if r.device_ok}
    assert ok == {"serve-dispatch", "ingest-xfer", "egress-fetch", "server-main"}
    assert all(r.doc for r in mod.THREAD_ROOTS)
    assert all(r.kind in mod.ROOT_KINDS for r in mod.THREAD_ROOTS)
    ranks = [lk.rank for lk in mod.LOCKS]
    assert len(set(ranks)) == len(ranks)
    assert mod.DEVICE_SURFACE_HEADS == ("torch",)
    assert "launch" in mod.DEVICE_SURFACE_CALLS


_HANDLER = "mpitest_tpu_torch/serve/telemetry.py"
_HEALTHY = '        healthy = not draining and breaker == "closed"\n'


@pytest.mark.parametrize("what,new", [
    ("torch call", _HEALTHY + "        torch.cuda.synchronize()\n"),
    ("kernel launcher", _HEALTHY + "        _build.launch(None, 'x', None)\n"),
    ("through an error formatter", _HEALTHY + "        _describe_card()\n"),
])
def test_handler_reaching_the_device_fires_tl001(what, new):
    """A scrape handler that reaches ``torch.`` (directly, through the
    kernel launcher, or through a helper) is refused: the telemetry
    handler root is not device_ok."""
    files = planted(_HANDLER, _HEALTHY, new)
    files[_HANDLER] += ("\n\ndef _describe_card():\n"
                        "    return str(torch.cuda.memory_allocated())\n")
    found = [f for f in lint(files) if f.rule == "TL001"]
    mine = [f for f in found if f.path == _HANDLER]
    assert mine and "telemetry-http-handler" in mine[0].msg, found


_LOOP = "            req = item  # type: ignore[assignment]\n"
_BATCHING = "mpitest_tpu_torch/serve/batching.py"


def test_the_dispatch_thread_may_touch_the_device():
    """The same call on the dispatch thread's path is allowed."""
    files = planted(_BATCHING, _LOOP, "            torch.cuda.synchronize()\n" + _LOOP)
    assert [f for f in lint(files) if f.rule == "TL001"] == []


def test_unregistered_thread_and_lock_fire_tl010_tl011():
    files = port_files()
    files["mpitest_tpu_torch/serve/extra.py"] = (
        "import threading\n\n"
        "_GUARD = threading.Lock()\n\n\n"
        "def _spin():\n"
        "    pass\n\n\n"
        "def start():\n"
        "    threading.Thread(target=_spin, daemon=True).start()\n")
    rules = {f.rule for f in lint(files) if f.path.endswith("extra.py")}
    assert {"TL010", "TL011"} <= rules


def test_nvcc_build_under_the_build_lock_fires_tl003():
    """Pins the repair of ``ops/_build.load``: building under ``_lock``
    (as it did) is a compile reachable while a registered lock is held."""
    old = "        lib = ctypes.CDLL(str(build(name)[name]))\n"
    files = planted("mpitest_tpu_torch/ops/_build.py", old,
                    "        with _lock:\n    " + old)
    found = [f for f in lint(files) if f.rule == "TL003"]
    assert found and "build.loaded" in found[0].msg


def test_cc_build_under_the_codec_lock_fires_tl003():
    """Pins the repair of ``store/compress._load``: the cc build ran under
    ``_LOAD_LOCK``."""
    old = "    built_err = None if path.exists() else _build(path)\n"
    files = planted("mpitest_tpu_torch/store/compress.py", old,
                    "    with _LOAD_LOCK:\n    " + old)
    found = [f for f in lint(files) if f.rule == "TL003"]
    assert found and "compress.load" in found[0].msg


def test_lock_order_inversion_fires_tl002():
    """The heartbeat lock (rank 40) held while taking the pending lock
    (rank 10) on the dispatch thread inverts the global order."""
    files = planted(_BATCHING, _LOOP,
                    "            with self._hb_lock:\n"
                    "                with self._pending_lock:\n"
                    "                    pass\n" + _LOOP)
    found = [f for f in lint(files) if f.rule == "TL002"]
    assert found and "batcher.pending" in found[0].msg, found


def test_spill_codec_build_runs_outside_its_lock(tmp_path, monkeypatch):
    """A ``cc`` that hangs: the codec's load gives up at its bound with a
    reason, and another thread takes ``_LOAD_LOCK`` meanwhile."""
    from mpitest_tpu_torch.store import compress

    cc = tmp_path / "cc"
    cc.write_text("#!/bin/sh\nsleep 60\n")
    cc.chmod(0o755)
    monkeypatch.setattr(compress.shutil, "which", lambda name: str(cc))
    monkeypatch.setattr(compress, "lib_path", lambda: tmp_path / "libspillz-x.so")
    monkeypatch.setattr(compress, "CC_TIMEOUT_S", 2.0)
    monkeypatch.setattr(compress, "_LOADED", False)
    monkeypatch.setattr(compress, "_LIB", None)
    monkeypatch.setattr(compress, "_LIB_ERR", None)
    got: dict = {}

    def first_user() -> None:
        got["lib"] = compress._load()

    t = threading.Thread(target=first_user)
    t0 = time.monotonic()
    t.start()
    time.sleep(0.3)
    assert compress._LOAD_LOCK.acquire(timeout=1.0)  # not held by the build
    compress._LOAD_LOCK.release()
    t.join(timeout=30)
    assert got["lib"] is None and time.monotonic() - t0 < 20
    assert "did not finish within 2 s" in compress._LIB_ERR
    assert not list(tmp_path.glob("*.tmp"))
