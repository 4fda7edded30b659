"""Multi-process bring-up and the bounded kernel build of the port.

``parallel.multihost_init`` is the reference's ``multihost_init`` over
``torch.distributed``: the same no-op, the same fail-fast validation with
the same ``ValueError`` texts, then a process group (gloo here, where the
tests pass ``device="cpu"``; NCCL on a card of its own) and the gloo
control group.  A group of one process sorts on the mesh built after it;
in a group of several ``make_mesh`` builds one mesh of global ranks in
process order (``tests/test_torch_crossprocess.py`` holds its sorts
against the reference's), and a server core on it batches on the
process's own first rank.  ``ops/_build.py`` bounds every ``nvcc`` and
never holds its lock across a build (the counterpart of the reference's
bounded topology probe); a fake ``nvcc`` stands in for the compiler.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import mpitest_tpu
from mpitest_tpu.parallel import multihost_init as ref_multihost_init
from mpitest_tpu.parallel.mesh import make_mesh as ref_make_mesh
from mpitest_tpu_torch.ops import _build
from mpitest_tpu_torch.parallel import make_mesh, multihost_init

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(code: str, nprocs: int, tmp_path: Path, attempts: int = 3) -> list[str]:
    """Run ``code`` (formatted with ``port`` and ``rank``) in ``nprocs``
    processes that form one group; a port taken between probe and bind
    is retried with a new one, nothing else is."""
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}"
               + os.environ.get("PYTHONPATH", ""))
    for _ in range(attempts):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", code.format(port=port, rank=r, nprocs=nprocs,
                                               out=str(tmp_path))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=REPO) for r in range(nprocs)]
        outs = []
        for p in procs:
            try:
                o, e = p.communicate(timeout=180)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append((p.returncode, o, e))
        if all(rc == 0 for rc, _o, _e in outs):
            return [o for _rc, o, _e in outs]
        if not any("address already in use" in e.lower() for _rc, _o, e in outs):
            break
    raise AssertionError("\n".join(e[-2000:] for _rc, _o, e in outs))


def test_multihost_init_noop_single_process():
    """No arguments is the single-process case: a no-op, any number of
    times, and no process group."""
    import torch.distributed as dist

    multihost_init()
    multihost_init()
    assert not dist.is_initialized()


#: The reference's cases (tests/test_multihost.py), one per call.
_BAD = [
    ("127.0.0.1:9999", None, None),
    (None, 2, 0),
    (None, None, 1),
    *[(bad, 2, 0) for bad in ("coordinatorhost", ":1234", "host:", "host:notaport",
                              "host:0", "host:70000", "::1", "fe80::1")],
    ("h:1234", 0, 0),
    ("h:1234", 2, 2),
    ("h:1234", 2, -1),
    ("h:1234", 2, "0"),
    ("h:1234", 2.0, 0),
]


@pytest.mark.parametrize("args", _BAD, ids=[repr(a) for a in _BAD])
def test_validation_texts_equal_reference(args):
    """Every malformed call raises ``ValueError`` before any handshake,
    with the reference's text."""
    with pytest.raises(ValueError) as ref:
        ref_multihost_init(*args)
    with pytest.raises(ValueError) as got:
        multihost_init(*args)
    with pytest.raises(ValueError) as got_cpu:
        multihost_init(*args, device="cpu")
    assert str(got.value) == str(ref.value) == str(got_cpu.value)


def test_bracketed_ipv6_passes_validation(monkeypatch):
    """``[::1]:port`` is accepted, as in the reference: the call reaches
    ``init_process_group`` with its ``tcp://`` address and the control
    group's bounded timeout, then makes the control group."""
    import torch.distributed as dist

    from mpitest_tpu_torch.parallel import mesh as mesh_mod

    seen = {}

    def fake_init(backend, **kw):
        seen.update(kw, backend=backend)

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(mesh_mod, "_make_control_group",
                        lambda: seen.update(control=True))
    multihost_init("[::1]:8476", 1, 0, device="cpu")
    assert seen == {"backend": "gloo", "init_method": "tcp://[::1]:8476",
                    "world_size": 1, "rank": 0, "control": True,
                    "timeout": datetime.timedelta(seconds=mesh_mod.CONTROL_TIMEOUT_S)}


def test_unknown_device_is_refused():
    with pytest.raises(ValueError, match="not cuda or cpu"):
        multihost_init("h:1234", 1, 0, device="meta")


def test_no_card_and_no_cpu_raises_before_any_handshake(monkeypatch):
    """Without a card the default (nccl) raises at once; it never takes
    gloo on its own and never dials the coordinator."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_handshake(*a, **k):
        raise AssertionError("init_process_group was called")

    monkeypatch.setattr(dist, "init_process_group", no_handshake)
    with pytest.raises(RuntimeError, match="needs a CUDA device.*device='cpu'"):
        multihost_init("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()


_ONE = textwrap.dedent("""
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.parallel import make_mesh, multihost_init
    multihost_init("127.0.0.1:{port}", num_processes=1, process_id=0, device="cpu")
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        t = torch.ones(3)
        dist.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
        mesh = make_mesh(devices=["cpu"] * 8)
        assert mesh.size == 8
        x = np.load("{out}/x.npy")
        np.save("{out}/got.npy", mt.sort(x, "radix", mesh))
        np.save("{out}/got_sample.npy", mt.sort(x, "sample", mesh))
    finally:
        dist.destroy_process_group()
    print("MULTIHOST_OK", dist.is_initialized())
""")


def test_one_process_group_sorts_like_the_reference(tmp_path):
    """A real gloo group of one process (coordinator bind and handshake
    with itself), then radix and sample sorts on the eight CPU ranks made
    after it: bytes equal to the reference's on its cpu:8 mesh."""
    x = np.random.default_rng(5).integers(-2**31, 2**31 - 1, size=1 << 14,
                                          dtype=np.int32)
    np.save(tmp_path / "x.npy", x)
    out, = _run_group(_ONE, 1, tmp_path)
    assert "MULTIHOST_OK False" in out
    want = np.asarray(mpitest_tpu.sort(x, algorithm="radix", mesh=ref_make_mesh(8)))
    for name in ("got", "got_sample"):
        got = np.load(tmp_path / f"{name}.npy")
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


_TWO = textwrap.dedent("""
    import json
    import numpy as np, torch, torch.distributed as dist
    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.ops.keys import codec_for
    from mpitest_tpu_torch.parallel import make_mesh, multihost_init
    from mpitest_tpu_torch.parallel import mesh as mesh_mod
    torch.set_num_threads(1)
    multihost_init("127.0.0.1:{port}", {nprocs}, {rank}, device="cpu")
    try:
        t = torch.tensor([{rank} + 1.0])
        dist.all_reduce(t)
        assert t.item() == 3.0, t
        # the default group is gloo, so it is the control group too
        assert mesh_mod.control_group() is dist.group.WORLD
        mesh = make_mesh(devices=["cpu"] * (2 + {rank}))   # 2 + 3 ranks
        first = make_mesh(3, devices=["cpu"] * (2 + {rank}))
        alone = make_mesh(2, devices=["cpu"] * (2 + {rank}))
        x = np.random.default_rng(1).integers(-2**31, 2**31 - 1, 5000, dtype=np.int32)
        res = mt.sort(x, mesh=mesh, return_result=True)
        want = codec_for(x.dtype).encode(np.sort(x))[0].view(np.int32)
        ok = all(np.array_equal(s[0].numpy(), want[a:b])
                 for (_r, a, b), s in zip(res.addressable, res.shards))
        print(json.dumps({{"owners": mesh.owners, "local": mesh.local_ranks,
                          "size": mesh.size, "first": [first.owners, first.local_ranks],
                          "alone": [alone.owners, alone.local_ranks,
                                    alone.cross_process],
                          "sorted": ok, "median": int(res.median_probe())}}))
    finally:
        dist.destroy_process_group()
""")


def test_group_of_two_processes_refuses_a_mesh(tmp_path):
    """Two gloo processes each join the group (an all_reduce proves it) and
    build one mesh of global ranks: process 0's two ranks, then process
    1's three, each process driving its own; ``n_devices`` takes the first
    global ranks (three span both processes, two lie in process 0 alone);
    a radix sort over the uneven mesh gives each process its shards of the
    sorted keys and the same median."""
    outs = [json.loads(o.strip().splitlines()[-1]) for o in _run_group(_TWO, 2, tmp_path)]
    want_median = int(np.sort(np.random.default_rng(1).integers(
        -2**31, 2**31 - 1, 5000, dtype=np.int32))[2499])
    for rank, got in enumerate(outs):
        assert got["owners"] == [0, 0, 1, 1, 1] and got["size"] == 5
        assert got["local"] == ([0, 1] if rank == 0 else [2, 3, 4])
        assert got["first"] == [[0, 0, 1], [0, 1] if rank == 0 else [2]]
        assert got["alone"] == [[0, 0], [0, 1] if rank == 0 else [], False]
        assert got["sorted"] and got["median"] == want_median


def test_make_mesh_outside_a_group_is_unchanged():
    """Without a group the order key's process rank is 0: the mesh equals
    the one built by ranks alone."""
    assert make_mesh(devices=["cpu"] * 3).devices == (torch.device("cpu"),) * 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL has no CPU form)")
    return torch.device("cuda")


_NCCL = textwrap.dedent("""
    import numpy as np, torch, torch.distributed as dist
    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.ops import _build
    from mpitest_tpu_torch.parallel import make_mesh, multihost_init
    multihost_init("127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        assert t.tolist() == [1.0] * 4
        x = torch.randint(-2**31, 2**31 - 1, (1 << 20,), dtype=torch.int32, device="cuda")
        _build.reset_launches()
        got = mt.sort(x, "radix", make_mesh(8))
        assert np.array_equal(np.asarray(got), torch.sort(x).values.cpu().numpy())
        assert _build.launches("fused_pass_pack") and _build.launches("remote_a2a")
    finally:
        dist.destroy_process_group()
    print("NCCL_OK")
""")


@pytest.mark.cuda
def test_nccl_group_of_one_on_the_card(card, tmp_path):
    out, = _run_group(_NCCL, 1, tmp_path)
    assert "NCCL_OK" in out


# ------------------------------------------------------- the bounded build

_FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import os, subprocess, sys, time
    args = sys.argv[1:]
    out, src = args[args.index("-o") + 1], args[-1]
    name = os.path.basename(src)
    with open({log!r}, "a") as f:
        f.write(src + "\\n")
    if name.startswith("stuck"):
        # a compiler stage stuck in a child that holds nvcc's pipes and
        # would write the output once it ends
        cmd = "echo $$ > " + out + ".pid; sleep 120; : > " + out
        subprocess.Popen(["sh", "-c", cmd]).wait()
    if name.startswith("slow"):
        time.sleep(120)
    subprocess.run(["cc", "-shared", "-fPIC", "-x", "c", "-o", out, src], check=True)
""")


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """A fake nvcc (``slow*`` sources sleep two minutes, ``stuck*`` ones
    wait on a child that sleeps two minutes holding nvcc's pipes, others
    compile with cc), sources under ``tmp/csrc`` and libraries under
    ``tmp/kernels``; the bound is 3 s."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("slow", "stuck", "fast"):
        (csrc / f"{name}.cu").write_text("int kernel_probe(void) { return 7; }\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_TIMEOUT_S", 3.0)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_pending", {})
    return tmp_path, log


def _loader(name: str, results: dict) -> threading.Thread:
    def run() -> None:
        t0 = time.monotonic()
        try:
            results[name] = _build.load(name)
        except Exception as e:  # noqa: BLE001
            results[name] = e
        results[name + "_s"] = time.monotonic() - t0
    return threading.Thread(target=run)


def test_timed_out_build_raises_and_leaves_no_tmp(fake_toolchain):
    tmp, _log = fake_toolchain
    t0 = time.monotonic()
    with pytest.raises(_build.KernelBuildTimeout,
                       match=r"csrc/slow\.cu did not finish within the 3 s build bound"):
        _build.load("slow")
    assert time.monotonic() - t0 < 20
    assert isinstance(_build.KernelBuildTimeout("x"), _build.KernelBuildError)
    assert not list((tmp / "kernels").glob("*.tmp"))
    assert not list((tmp / "kernels").glob("*.so"))
    assert _build._pending == {} and "slow" not in _build._loaded


def _gone_or_zombie(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return True
    return state == "Z"


def test_timed_out_build_kills_the_compilers_nvcc_started(fake_toolchain):
    """A stuck compiler stage is a child of nvcc that inherits its pipes:
    the bound still holds, the child dies with nvcc, and no ``.tmp`` is
    left or written later."""
    tmp, _log = fake_toolchain
    t0 = time.monotonic()
    with pytest.raises(_build.KernelBuildTimeout, match=r"csrc/stuck\.cu did not finish"):
        _build.load("stuck")
    assert time.monotonic() - t0 < _build.BUILD_TIMEOUT_S + 8
    pidfile, = (tmp / "kernels").glob("*.tmp.pid")
    child = int(pidfile.read_text())
    deadline = time.monotonic() + 5
    while not _gone_or_zombie(child) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _gone_or_zombie(child)
    assert not list((tmp / "kernels").glob("*.tmp"))
    assert _build._pending == {} and "stuck" not in _build._loaded


def test_other_source_loads_while_one_build_hangs(fake_toolchain):
    """The lock is not held across a build: a second thread loads another
    source long before the hung build's bound runs out."""
    _tmp, _log = fake_toolchain
    results: dict = {}
    slow = _loader("slow", results)
    slow.start()
    time.sleep(0.3)
    fast = _loader("fast", results)
    fast.start()
    fast.join(timeout=30)
    assert "fast" in results and "slow" not in results
    assert results["fast"].kernel_probe() == 7
    assert results["fast_s"] < _build.BUILD_TIMEOUT_S
    slow.join(timeout=30)
    assert isinstance(results["slow"], _build.KernelBuildTimeout)


def test_second_loader_of_a_source_waits_for_the_first(fake_toolchain):
    """Two loaders of one hung source: one nvcc runs, and both get its
    timeout; a later load builds again."""
    _tmp, log = fake_toolchain
    results: dict = {}
    a = _loader("slow", results)
    a.start()
    time.sleep(0.3)
    results2: dict = {}
    b = _loader("slow", results2)
    b.start()
    a.join(timeout=30)
    b.join(timeout=30)
    assert isinstance(results["slow"], _build.KernelBuildTimeout)
    assert isinstance(results2["slow"], _build.KernelBuildTimeout)
    assert log.read_text().count("slow.cu") == 1
    with pytest.raises(_build.KernelBuildTimeout):
        _build.load("slow")
    assert log.read_text().count("slow.cu") == 2


def test_build_kills_the_others_when_one_times_out(fake_toolchain):
    """``build`` of several sources, one hung: the timeout raises, and no
    nvcc is left running and no partial output behind."""
    tmp, _log = fake_toolchain
    (tmp / "csrc" / "slow2.cu").write_text("int k(void) { return 1; }\n")
    with pytest.raises(_build.KernelBuildTimeout):
        _build.build("slow", "slow2")
    assert not list((tmp / "kernels").glob("*.tmp"))


def test_failed_build_is_not_a_timeout(fake_toolchain):
    tmp, _log = fake_toolchain
    (tmp / "csrc" / "broken.cu").write_text("this is not C\n")
    with pytest.raises(_build.KernelBuildError, match="nvcc failed on csrc/broken.cu") as e:
        _build.load("broken")
    assert not isinstance(e.value, _build.KernelBuildTimeout)


def test_prewarm_degrades_only_on_a_timed_out_build(monkeypatch):
    """A build that timed out is logged and skipped (the buckets still
    warm; the first request builds or raises); any other build failure
    keeps the server from starting."""
    from mpitest_tpu_torch.serve.executor_cache import ExecutorCache

    cache = ExecutorCache(device="cpu")

    def timed_out():
        raise _build.KernelBuildTimeout("nvcc on csrc/bitonic.cu did not finish")

    monkeypatch.setattr(cache, "build_kernels", timed_out)
    lines: list[str] = []
    assert cache.prewarm((1024, 2048), ("int32",), lines.append) == 2
    assert any("kernel build skipped" in ln and "build on first use" in ln
               for ln in lines), lines
    assert cache.snapshot()["buckets"] == [1024, 2048]

    def failed():
        raise _build.KernelBuildError("nvcc failed on csrc/bitonic.cu (rc=1)")

    monkeypatch.setattr(cache, "build_kernels", failed)
    with pytest.raises(_build.KernelBuildError, match="rc=1"):
        cache.prewarm((1024,), ("int32",))


def test_make_mesh_in_a_group_of_several_raises_typed(monkeypatch):
    """In-process view of a group of four processes: ``make_mesh`` orders
    the gathered device lists by process rank, this process (rank 2)
    drives its own ranks, ``n_devices`` takes the first global ranks and
    one that leaves a process out raises typed; an NCCL default group gets
    a gloo control group beside it; and the sort server on that mesh
    batches on this process's first rank (global rank 3), profiles its
    own ranks, and without a card cannot build the default mesh."""
    import torch.distributed as dist

    from mpitest_tpu_torch.parallel import mesh as mesh_mod
    from mpitest_tpu_torch.serve.server import ServerCore

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    lists = [["cpu"], ["cpu", "cpu"], ["cpu"] * 3, ["cpu"]]
    monkeypatch.setattr(mesh_mod, "gather_objects", lambda obj: lists)
    mesh = make_mesh(devices=["cpu"] * 3)
    assert mesh.owners == (0, 1, 1, 2, 2, 2, 3) and mesh.process == 2
    assert mesh.local_ranks == (3, 4, 5) and mesh.cross_process
    assert make_mesh(7, devices=["cpu"] * 3).size == 7
    with pytest.raises(ValueError, match="all 4 processes"):
        make_mesh(4, devices=["cpu"] * 3)        # processes 0..2 only
    with pytest.raises(ValueError, match="requested 8 devices, have 7"):
        make_mesh(8, devices=["cpu"] * 3)
    made = []
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(dist, "new_group", lambda **kw: made.append(kw) or "control")
    monkeypatch.setattr(mesh_mod, "_CONTROL", {})
    mesh_mod._make_control_group()
    assert made == [{"backend": "gloo",
                     "timeout": datetime.timedelta(seconds=mesh_mod.CONTROL_TIMEOUT_S)}]
    assert mesh_mod._CONTROL["group"] == "control"
    # each process's devices carry its rank as their index here, so the
    # first rank of the mesh and of this process differ
    lists = [["cpu:0"], ["cpu:1", "cpu:1"], ["cpu:2"] * 3, ["cpu:3"]]
    mesh = make_mesh(devices=["cpu"] * 3)
    core = ServerCore(mesh)
    try:
        assert core.device == mesh.devices[3] == torch.device("cpu", 2)
        assert core.device != mesh.devices[0]
        assert core.cache.device == core.device
        assert core.profiler.devices == mesh.local_devices == (torch.device("cpu", 2),) * 3
    finally:
        core.drain_and_stop(timeout=10)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ServerCore()
