"""The radix sort across processes: ``mpitest_tpu_torch.sort`` in a group
of two gloo processes with CPU ranks against ``mpitest_tpu.sort`` in a
group of two ``jax.distributed`` processes with gloo collectives.

One pair of reference processes (``XLA_FLAGS`` gives each four CPU
devices) and one pair of port processes run every case and write their
results to ``.npz`` files; the tests compare them.  Cases: int32, float32
and int64 keys at 2^13, an int32 input of 10001 keys (pads), and sorted
int32 at 2^14 (the re-stage), on meshes of 2 x 1 ranks (the first device
of each process) and 2 x 4 ranks.  Held equal, in every process: the
local shards' words and their global ranges, the exchange counters, the
median probe, and the classes that ``to_numpy()``, ``algorithm="sample"``
and the other entry points raise.  The port's result ``Fingerprint``
(combined over the control group) equals the input's.  The reference
runs its ``lax`` exchange engine with ``pack="pallas_interpret"`` so its
caps align to 1024 as the port's do (interpret mode runs across its
processes); the port runs ``lax`` (compared counter by counter) and
``pallas`` (compared by bytes and by every counter but the engine name).

A fault in one process only (a ``dispatch_error``, an OOM in the middle
of the dispatch, an error no retry absorbs) is agreed by both processes
over the control group: both retry together, or both end at once.

The ``cuda``-marked twins run the port across two processes sharing the
card: K6 and K7 launched in each, the skew re-stage of sorted keys moved
by K7 across the processes, K7 across processes byte-equal to the
host-staged transport, shards equal to ``torch.sort``.  Children keep
``torch.set_num_threads(1)``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

COUNTERS = ("negotiated_cap", "worst_cap", "exchange_cap", "exchange_passes",
            "exchange_retries", "skew_restage", "digit_bits", "exchange_engine",
            "local_engine", "exchange_peer_ratio", "exchange_balance_ratio",
            "exchange_bytes", "verify_runs")

#: (name, mesh, dtype, n): every case runs in both packages.
CASES = [(f"{dt}_{m}", m, dt, 1 << 13) for m in ("2x1", "2x4")
         for dt in ("int32", "float32", "int64")]
CASES += [("int32_pads_2x4", "2x4", "int32", 10001),
          ("int32_sorted_2x4", "2x4", "sorted", 1 << 14)]

#: Shared by both packages' children: the keys of a case, from a seed.
_KEYS = textwrap.dedent("""
    def keys(dtype, n, seed):
        rng = np.random.default_rng(seed)
        if dtype == "sorted":
            return np.sort(rng.integers(0, 1 << 16, size=n).astype(np.int32))
        dt = np.dtype(dtype)
        if dt.kind == "f":
            x = (rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)).astype(dt)
            x[:6] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf]
            return x
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


    def attempt(fn):
        try:
            fn()
        except Exception as e:
            return type(e).__name__
        return "ok"


    def served(core, x):
        # the status of a server core's reply, or the class it raised
        try:
            return core().execute(x)[0]
        except Exception as e:
            return type(e).__name__
""")

_REF = textwrap.dedent("""
    import json, os, sys, tempfile
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import jax
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    import numpy as np
    import mpitest_tpu
    from mpitest_tpu.parallel import multihost_init
    from mpitest_tpu.parallel.mesh import make_mesh
    from mpitest_tpu.utils.trace import Tracer
    multihost_init(f"127.0.0.1:{port}", 2, rank)
""") + _KEYS + textwrap.dedent("""
    cases, arrays, meta = json.loads(sys.argv[4]), {}, {}
    meshes = {"2x1": make_mesh(devices=[d for d in jax.devices() if d.id % 2048 == 0]),
              "2x4": make_mesh()}
    for i, (name, m, dtype, n) in enumerate(cases):
        x = keys(dtype, n, 100 + i)
        tr = Tracer()
        res = mpitest_tpu.sort(x, mesh=meshes[m], tracer=tr, return_result=True,
                               exchange_engine="lax", pack="pallas_interpret")
        ranges = []
        for k, w in enumerate(res.words):
            for j, s in enumerate(w.addressable_shards):
                arrays[f"{name}/w{k}/{j}"] = np.asarray(s.data).view(np.uint32)
                if k == 0:
                    ranges.append([s.index[0].start, s.index[0].stop])
        meta[name] = {"ranges": ranges, "counters": dict(tr.counters),
                      "median": repr(res.median_probe_raw()),
                      "to_numpy": attempt(res.to_numpy),
                      "sample": attempt(lambda: mpitest_tpu.sort(
                          x, algorithm="sample", mesh=meshes[m], return_result=True,
                          exchange_engine="lax", pack="pallas_interpret"))}
    x = keys("int32", 1 << 12, 7)
    from mpitest_tpu.store.external import external_sort
    from mpitest_tpu.serve.server import ServerCore
    meta["entry_points"] = {
        "records": attempt(lambda: mpitest_tpu.sort(x, payload=np.zeros((x.size, 4), np.uint8))),
        "external": attempt(lambda: external_sort(x, budget=1 << 14,
                                                  spill_dir=tempfile.mkdtemp())),
        "server": served(ServerCore, x)}
    np.savez(os.path.join(out, f"ref_{rank}.npz"), **arrays)
    with open(os.path.join(out, f"ref_{rank}.json"), "w") as f:
        json.dump(meta, f, default=str)
""")

_PORT = textwrap.dedent("""
    import json, os, sys, tempfile
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.models import verify as vfy
    from mpitest_tpu_torch.ops.keys import codec_for
    from mpitest_tpu_torch.parallel import make_mesh, multihost_init
    from mpitest_tpu_torch.utils.trace import Tracer
    multihost_init(f"127.0.0.1:{port}", 2, rank, device="cpu")
""") + _KEYS + textwrap.dedent("""
    cases, arrays, meta = json.loads(sys.argv[4]), {}, {}
    try:
        meshes = {"2x1": make_mesh(devices=["cpu"]), "2x4": make_mesh(devices=["cpu"] * 4)}
        for i, (name, m, dtype, n) in enumerate(cases):
            x = keys(dtype, n, 100 + i)
            for engine in ("lax", "pallas"):
                tr = Tracer()
                res = mt.sort(x, mesh=meshes[m], tracer=tr, return_result=True,
                              exchange_engine=engine)
                for k in range(len(res.shards[0])):
                    for j, shard in enumerate(res.shards):
                        arrays[f"{engine}/{name}/w{k}/{j}"] = shard[k].numpy().view(np.uint32)
                fp_in = vfy.fingerprint_host(codec_for(x.dtype).encode(x))
                meta[f"{engine}/{name}"] = {
                    "ranges": [[a, b] for _r, a, b in res.addressable],
                    "counters": dict(tr.counters), "median": repr(res.median_probe_raw()),
                    "fingerprint_ok": vfy.result_fingerprint(res) == fp_in,
                    "to_numpy": attempt(res.to_numpy),
                    "sample": attempt(lambda: mt.sort(
                        x, algorithm="sample", mesh=meshes[m], return_result=True,
                        exchange_engine=engine))}
        # device-resident input: every process holds the whole tensor
        x = keys("int64", 5000, 9)
        res = mt.sort(torch.from_numpy(x), mesh=meshes["2x4"], return_result=True)
        want = codec_for(x.dtype).encode(np.sort(x))
        meta["tensor_input_ok"] = all(
            np.array_equal(shard[k].numpy().view(np.uint32)[:max(0, min(b, x.size) - a)],
                           want[k][a:b])
            for (_r, a, b), shard in zip(res.addressable, res.shards) for k in range(2))
        x = keys("int32", 1 << 12, 7)
        from mpitest_tpu_torch.store.external import external_sort
        from mpitest_tpu_torch.serve.server import ServerCore
        meta["entry_points"] = {
            "records": attempt(lambda: mt.sort(x, payload=np.zeros((x.size, 4), np.uint8),
                                               mesh=meshes["2x4"])),
            "records_default": attempt(lambda: mt.sort(
                x, payload=np.zeros((x.size, 4), np.uint8), mesh=make_mesh(devices=["cpu"]))),
            "external": attempt(lambda: external_sort(x, budget=1 << 14, mesh=meshes["2x4"],
                                                      spill_dir=tempfile.mkdtemp())),
            "server": served(lambda: ServerCore(meshes["2x4"]), x)}
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out, f"port_{rank}.npz"), **arrays)
    with open(os.path.join(out, f"port_{rank}.json"), "w") as f:
        json.dump(meta, f, default=str)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(code: str, out: Path, args: list[str], env: dict[str, str],
             attempts: int = 3, timeout: float = 240.0) -> list[str]:
    """Run ``code`` in two processes that form one group (argv: rank,
    port, ``out``, ``args``); a port taken between probe and bind is
    retried with a new one, nothing else is."""
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}"
               + os.environ.get("PYTHONPATH", ""), **env)
    for _ in range(attempts):
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                                   str(out), *args],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True, env=env, cwd=REPO) for r in range(2)]
        outs = []
        try:
            for p in procs:
                o, e = p.communicate(timeout=timeout)
                outs.append((p.returncode, o, e))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(rc == 0 for rc, _o, _e in outs):
            return [o for _rc, o, _e in outs]
        if not any("address already in use" in e.lower() for _rc, _o, e in outs):
            break
    raise AssertionError("\n".join(e[-3000:] for _rc, _o, e in outs))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' results of every case, per process."""
    out = tmp_path_factory.mktemp("crossprocess")
    cases = json.dumps([list(c) for c in CASES])
    run_pair(_REF, out, [cases], {
        "JAX_PLATFORMS": "cpu", "SORT_LOCAL_ENGINE": "lax",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    run_pair(_PORT, out, [cases], {"SORT_LOCAL_ENGINE": "lax"})
    got = {}
    for who in ("ref", "port"):
        for r in range(2):
            with open(out / f"{who}_{r}.json") as f:
                meta = json.load(f)
            got[who, r] = (meta, dict(np.load(out / f"{who}_{r}.npz")))
    return got


def _shards(arrays: dict, prefix: str) -> dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
@pytest.mark.parametrize("engine", ["lax", "pallas"])
def test_local_shards_equal_reference(runs, name, engine):
    """Each process holds the same ranks' words, byte for byte, over the
    same global ranges as the reference's process of that rank."""
    for r in range(2):
        ref_meta, ref_arrays = runs["ref", r]
        port_meta, port_arrays = runs["port", r]
        assert port_meta[f"{engine}/{name}"]["ranges"] == ref_meta[name]["ranges"]
        want = _shards(ref_arrays, f"{name}/")
        got = _shards(port_arrays, f"{engine}/{name}/")
        assert want and sorted(got) == sorted(want)
        for key, w in want.items():
            assert got[key].tobytes() == w.tobytes(), (r, key)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_counters_and_median_equal_reference(runs, name):
    """The exchange counters (engine names included: both ``lax``) and the
    median probe are the reference's, in both processes; the pallas
    engine gives the same counters but its engine name."""
    for r in range(2):
        ref = runs["ref", r][0][name]
        meta = runs["port", r][0]
        for engine in ("lax", "pallas"):
            port = meta[f"{engine}/{name}"]
            for c in COUNTERS:
                if engine == "pallas" and c == "exchange_engine":
                    assert port["counters"][c] == "pallas"
                    continue
                assert port["counters"].get(c) == ref["counters"].get(c), (r, engine, c)
            assert port["median"] == ref["median"], (r, engine)
    if name.startswith("int32_sorted"):
        assert runs["port", 0][0][f"lax/{name}"]["counters"]["skew_restage"] == 1


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_fingerprint_combines_across_processes(runs, name):
    """The result fingerprint, folded per process and combined over the
    control group, equals the input's in both processes."""
    for r in range(2):
        for engine in ("lax", "pallas"):
            assert runs["port", r][0][f"{engine}/{name}"]["fingerprint_ok"], (r, engine)


def test_fetch_and_sample_raise_runtime_error_in_both(runs):
    """``to_numpy()`` of a result across processes and ``algorithm="sample"``
    raise ``RuntimeError`` in every process of both packages."""
    for r in range(2):
        for name, *_ in CASES:
            ref = runs["ref", r][0][name]
            assert ref["to_numpy"] == ref["sample"] == "RuntimeError", (r, name)
            for engine in ("lax", "pallas"):
                port = runs["port", r][0][f"{engine}/{name}"]
                assert port["to_numpy"] == port["sample"] == "RuntimeError", (r, name)


def test_other_entry_points_across_processes(runs):
    """The record sort runs on the mesh's first rank (process 0 sorts,
    process 1 raises ``ValueError`` in both packages); the external sort
    raises ``RuntimeError`` in both; the server of each process answers a
    batched request ``ok`` in both (``tests/test_torch_serve_crossprocess.py``
    holds every reply)."""
    for r in range(2):
        ref = runs["ref", r][0]["entry_points"]
        port = runs["port", r][0]["entry_points"]
        want_records = "ok" if r == 0 else "ValueError"
        assert ref["records"] == port["records"] == port["records_default"] == want_records
        assert ref["external"] == port["external"] == "RuntimeError"
        assert ref["server"] == port["server"] == "ok"
        assert runs["port", r][0]["tensor_input_ok"]


# ------------------------------------------------------- faults in one process

_FAULTS = textwrap.dedent("""
    import json, os, sys, time
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch import faults
    from mpitest_tpu_torch.ops.keys import codec_for
    from mpitest_tpu_torch.parallel import collectives, make_mesh, multihost_init
    from mpitest_tpu_torch.utils.trace import Tracer
    multihost_init(f"127.0.0.1:{port}", 2, rank, device="cpu")
    os.environ["SORT_RETRY_BACKOFF"] = "0"
    x = np.random.default_rng(5).integers(-2**31, 2**31 - 1, 1 << 13, dtype=np.int32)
    want = codec_for(x.dtype).encode(np.sort(x))
    a2a = collectives.ragged_all_to_all


    def fail_at_second_exchange(exc):
        calls = []

        def patched(*args, **kwargs):
            calls.append(1)
            if rank == 0 and len(calls) == 2:
                raise exc
            return a2a(*args, **kwargs)
        collectives.ragged_all_to_all = patched


    def run(name):
        tr = Tracer()
        t = time.perf_counter()
        try:
            res = mt.sort(x, mesh=mesh, tracer=tr, return_result=True)
            ok = all(np.array_equal(shard[0].numpy().view(np.uint32), want[0][a:b])
                     for (_r, a, b), shard in zip(res.addressable, res.shards))
            got = {"outcome": "ok" if ok else "wrong"}
        except Exception as e:
            got = {"outcome": type(e).__name__}
        collectives.ragged_all_to_all = a2a
        faults.install(None)
        got.update(seconds=time.perf_counter() - t,
                   retries=tr.counters.get("sort_retries", 0))
        meta[name] = got


    meta = {}
    try:
        mesh = make_mesh(devices=["cpu"] * 2)
        if rank == 0:   # fires before the dispatch, in this process only
            faults.install(faults.FaultRegistry("dispatch_error", seed=0))
        run("dispatch_error")
        fail_at_second_exchange(torch.cuda.OutOfMemoryError("injected in one process"))
        run("oom_mid_dispatch")
        fail_at_second_exchange(ValueError("injected in one process"))
        run("error_mid_dispatch")
        run("clean_after")
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"faults_{rank}.json"), "w") as f:
        json.dump(meta, f)
""")


def test_a_fault_in_one_process_is_agreed_by_both(tmp_path):
    """Faults in process 0 only, on a 2 x 2 mesh of CPU ranks: a
    ``dispatch_error`` before the dispatch and an OOM inside it (at the
    second exchange, while process 1 waits in that exchange's count
    gather) are agreed over the control group: both processes retry once
    and return their sorted shards.  An error no retry absorbs ends the
    run in process 0 and, through its abort, in process 1 at once
    (``PeerAbortedError``, well inside the control timeout); the next
    sort of the same processes runs clean."""
    run_pair(_FAULTS, tmp_path, [], {})
    got = [json.loads((tmp_path / f"faults_{r}.json").read_text()) for r in range(2)]
    for r in range(2):
        for case in ("dispatch_error", "oom_mid_dispatch"):
            assert got[r][case]["outcome"] == "ok", (r, case, got[r][case])
            assert got[r][case]["retries"] == 1, (r, case, got[r][case])
        assert got[r]["clean_after"] == {**got[r]["clean_after"], "outcome": "ok",
                                         "retries": 0}
        assert got[r]["error_mid_dispatch"]["seconds"] < 60
    assert got[0]["error_mid_dispatch"]["outcome"] == "ValueError"
    assert got[1]["error_mid_dispatch"]["outcome"] == "PeerAbortedError"


def _fake_rounds(monkeypatch, rounds):
    """Make the control group's rounds return ``rounds`` in turn."""
    from mpitest_tpu_torch.parallel import mesh as mesh_mod

    seen = []

    def fake(step, obj):
        seen.append((step, obj))
        return rounds.pop(0)
    monkeypatch.setattr(mesh_mod, "_all_gather", fake)
    return seen


@pytest.mark.parametrize("peer, raises", [
    (("verdict", "dispatch"), "PeerFailedError"),
    (("abort", None), "PeerAbortedError"),
    (("barrier", None), "RuntimeError")])
def test_a_control_step_meets_what_the_peer_is_at(monkeypatch, peer, raises):
    """A control-group step that meets a peer's failure report raises
    ``PeerFailedError``, a peer's abort ``PeerAbortedError``, and a peer at
    another step (a diverged run) ``RuntimeError``: no step hands a peer's
    verdict to a caller as its data."""
    from mpitest_tpu_torch.parallel import mesh as mesh_mod

    _fake_rounds(monkeypatch, [[("gather", {0: 1}), peer]])
    with pytest.raises(RuntimeError) as info:
        mesh_mod.gather_objects({0: 1})
    assert type(info.value).__name__ == raises


def test_agree_waits_for_a_peer_still_in_its_dispatch(monkeypatch):
    """``agree`` repeats its round until every process is at the verdict
    (the peer fails at its step and comes with its own report); the
    verdict lists every failure."""
    from mpitest_tpu_torch.parallel import mesh as mesh_mod

    seen = _fake_rounds(monkeypatch, [
        [("verdict", "oom"), ("gather", None)],
        [("verdict", "oom"), ("verdict", "dispatch")]])
    assert mesh_mod.agree("oom") == ["oom", "dispatch"]
    assert seen == [("verdict", "oom")] * 2


# ------------------------------------------------------------ on the card

_CARD = textwrap.dedent("""
    import json, sys
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.models import verify as vfy
    from mpitest_tpu_torch.ops import _build, exchange
    from mpitest_tpu_torch.ops.keys import codec_for
    from mpitest_tpu_torch.parallel import make_mesh, multihost_init
    from mpitest_tpu_torch.utils.trace import Tracer
    multihost_init(f"127.0.0.1:{port}", 2, rank)
    try:
        assert dist.get_backend() == "gloo"
        for local, dtype, n in ((4, np.int32, 1 << 20), (1, np.int64, 1 << 18)):
            info = np.iinfo(dtype)
            x = np.random.default_rng(local).integers(info.min, info.max, n, dtype=dtype)
            mesh = make_mesh(devices=["cuda"] * local)
            _build.reset_launches()
            res = mt.sort(x, mesh=mesh, return_result=True)
            assert _build.launches("fused_pass_pack") and _build.launches("remote_a2a")
            want = codec_for(x.dtype).encode(np.sort(x))
            for (_r, a, b), shard in zip(res.addressable, res.shards):
                for k, w in enumerate(shard):
                    assert np.array_equal(w.cpu().numpy().view(np.uint32), want[k][a:b])
            assert vfy.result_fingerprint(res) == vfy.fingerprint_host(
                codec_for(x.dtype).encode(x))
            assert res.median_probe() == np.sort(x)[n // 2 - 1]
        # sorted keys below 2^16 (one pass, every rank's keys stay on it)
        # take the skew re-stage, whose all-to-all is K7 across the
        # processes: a k7_exchanges attr on the restage span or under it
        x = np.cumsum(np.random.default_rng(3).integers(0, 2, 1 << 20), dtype=np.int32) >> 4
        tr = Tracer()
        res = mt.sort(x, mesh=make_mesh(devices=["cuda"] * 4), return_result=True, tracer=tr)
        assert tr.counters.get("skew_restage") == 1
        by_id = {s.id: s for s in tr.spans.spans}

        def inside(s):
            while s is not None and s.name != "restage":
                s = by_id.get(s.parent)
            return s is not None
        assert sum(s.attrs.get("k7_exchanges", 0) for s in tr.spans.spans if inside(s)) == 1
        want = codec_for(x.dtype).encode(np.sort(x))
        for (_r, a, b), shard in zip(res.addressable, res.shards):
            assert np.array_equal(shard[0].cpu().numpy().view(np.uint32), want[0][a:b])
        g = torch.Generator(device="cuda").manual_seed(rank)
        sends = [tuple(torch.randint(-2**31, 2**31 - 1, (8, 4096), dtype=torch.int32,
                                     device="cuda", generator=g) for _ in range(2))
                 for _ in range(4)]
        mesh = make_mesh(devices=["cuda"] * 4)
        got = [tuple(p.clone() for p in s) for s in exchange.remote_a2a_across(sends, mesh)]
        want = exchange.staged_a2a(sends, mesh)
        assert all(torch.equal(a, b) for s, t in zip(got, want) for a, b in zip(s, t))
        exchange.release_ipc()
    finally:
        dist.destroy_process_group()
    print("CARD_OK")
""")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA IPC and K7 run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_crossprocess_radix_on_the_card(card, tmp_path):
    """Two processes share the card: 2 x 4 ranks of int32 and 2 x 1 of
    int64 sort with K6 and K7 in each process, shards equal to np.sort;
    sorted int32 takes the skew re-stage through K7 across the processes;
    and K7 across processes equals the host-staged transport."""
    outs = run_pair(_CARD, tmp_path, [], {})
    assert all("CARD_OK" in o for o in outs)


def test_ipc_entries_are_typed_with_their_arity():
    """Every host entry of ``csrc/exchange.cu`` (peer access, CUDA IPC)
    has a ctypes signature with one type per C parameter."""
    import re

    from mpitest_tpu_torch.ops import _build, pack

    src = (Path(_build.CSRC) / "exchange.cu").read_text()
    for name, sig in pack.HOST_SIGNATURES.items():
        m = re.search(rf"int {name}\(([^)]*)\)", src)
        assert m is not None, name
        params = m.group(1).strip()
        assert len(sig) == (0 if params in ("", "void") else params.count(",") + 1), name


def test_failed_mapping_names_the_peer_and_frees_the_arena(monkeypatch):
    """A peer's receive buffer that cannot be mapped raises
    ``IpcMappingError`` naming the peer rank, its process and the CUDA
    error string; the arena allocated so far is freed, and nothing falls
    back to the staged copy."""
    import contextlib

    from mpitest_tpu_torch.ops import exchange
    from mpitest_tpu_torch.parallel import mesh as mesh_mod

    class FakeLib:
        freed: list = []

        def exchange_ipc_handle_bytes(self):
            return 64

        def exchange_ipc_alloc(self, nbytes, ref):
            ref._obj.value = 1 << 20
            return 0

        def exchange_ipc_handle(self, ptr, buf):
            return 0

        def exchange_ipc_open(self, handle, ref):
            return 201

        def exchange_ipc_close(self, ptr):
            return 0

        def exchange_ipc_free(self, ptr):
            self.freed.append(ptr.value)
            return 0

        def kernel_error_string(self, rc):
            return b"invalid device context"

    fake = FakeLib()
    monkeypatch.setattr(exchange, "lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(mesh_mod, "gather_objects", lambda obj: [obj, {1: b"h" * 64}])
    monkeypatch.setattr(exchange, "staged_a2a",
                        lambda *a: pytest.fail("the staged copy stood in for K7"))
    card = torch.device("cuda", 0)
    mesh = mesh_mod.Mesh((card, card), owners=(0, 1), process=0)
    with pytest.raises(exchange.IpcMappingError,
                       match=r"rank 1 \(process 1\) into process 0 failed: "
                             r"invalid device context \(code 201\)"):
        exchange._new_arena(mesh, card, 2 * 1024)
    assert fake.freed == [1 << 20]
