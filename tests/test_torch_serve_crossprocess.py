"""The sort server across processes: a ``ServerCore`` in each process of a
group of two, over the global mesh, in both packages.

One pair of reference processes (``jax.distributed`` with gloo
collectives, ``XLA_FLAGS`` giving four CPU devices each, ``ServerCore()``
over the global eight-device mesh) and one pair of port processes (gloo,
``ServerCore(make_mesh(devices=["cpu"] * 4))``) execute the same requests
under ``SORT_SERVE_BATCH_KEYS=16384`` and write their replies to ``.npz``
files.  Held equal, in each process: batched int32, int64 and float32
requests at 4096 and 16384 keys (bytes, ``batched``, ``bucket``); solo
radix and sample requests of 2^17 keys, ``internal`` in both; a record
request, ``ok`` in process 0 (bytes equal) and ``bad_request`` in
process 1; a spill request under ``SORT_SERVE_MAX_BYTES=262144``,
``internal`` in both.  The port's ``SortServer`` in each process answers
the port's client and the reference's with the replies ``execute`` gave.

Port only: a solo request sent to one process is refused at once, with
no control-group round and no breaker trip, while the peer serves a
batched request; a ``result_swap:1`` batch in one process gives its
touched segments ``internal`` and their batchmate ``ok``.  Each child
keeps its own spill and flight-recorder directories and
``torch.set_num_threads(1)``.  The ``cuda``-marked twin runs two port
processes on the card.
"""

from __future__ import annotations

import json
import textwrap

import numpy as np
import pytest
import torch

from test_torch_crossprocess import _KEYS, run_pair

#: (name, dtype, n, algo, payload width, spill): every request runs in
#: both packages, in both processes, in this order.
REQUESTS = [(f"batched_{dt}_{n}", dt, n, None, 0, False)
            for dt in ("int32", "int64", "float32") for n in (4096, 16384)]
REQUESTS += [("solo_radix", "int32", 1 << 17, "radix", 0, False),
             ("solo_sample", "int32", 1 << 17, "sample", 0, False),
             ("records", "int32", 1 << 17, None, 4, False),
             ("spill", "int32", 1 << 17, None, 0, True)]
BATCHED = [r[0] for r in REQUESTS if r[0].startswith("batched")]

#: The spill core's byte bound: the 2^17 int32 spill request (512 KiB)
#: exceeds it; the other requests go to a core with the default bound.
SPILL_BYTES = 262144

#: Shared by both packages' children: the requests, executed in order.
_SERVE = textwrap.dedent("""
    def payloads(n, width, seed):
        return np.random.default_rng(seed).integers(0, 256, (n, width), dtype=np.uint8)


    def request(i, req):
        name, dtype, n, algo, width, spill = req
        return keys(dtype, n, 200 + i), (payloads(n, width, 300 + i) if width else None)


    def serve_all(core, spill_core, reqs, arrays, meta):
        for i, req in enumerate(reqs):
            name, dtype, n, algo, width, spill = req
            x, pay = request(i, req)
            status, result, attrs = (spill_core if spill else core).execute(
                x, algo=algo, payload=pay)
            meta[name] = {"status": status, "batched": attrs.get("batched"),
                          "bucket": attrs.get("bucket")}
            if status == "ok":
                out, out_pay = result if width else (result, None)
                arrays[name] = np.asarray(out).view(np.uint8)
                if width:
                    arrays[name + "/payload"] = np.asarray(out_pay)
            else:
                meta[name]["detail"] = str(result)[:400]


    def flight_reasons(path):
        return sorted(f for f in os.listdir(path)) if os.path.isdir(path) else []
""")

_REF = textwrap.dedent("""
    import json, os, sys
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["SORT_FLIGHT_RECORDER_DIR"] = os.path.join(out, f"ref_flight_{rank}")
    os.environ["SORT_SPILL_DIR"] = os.path.join(out, f"ref_spill_{rank}")
    import jax
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    import numpy as np
    from mpitest_tpu.parallel import multihost_init
    from mpitest_tpu.serve.server import ServerCore
    multihost_init(f"127.0.0.1:{port}", 2, rank)
""") + _KEYS + _SERVE + textwrap.dedent("""
    reqs, spill_bytes = json.loads(sys.argv[4]), sys.argv[5]
    arrays, meta = {}, {}
    core = ServerCore()
    os.environ["SORT_SERVE_MAX_BYTES"] = spill_bytes
    spill_core = ServerCore()
    del os.environ["SORT_SERVE_MAX_BYTES"]
    meta["mesh_devices"] = len(core.mesh.devices.flat)
    serve_all(core, spill_core, reqs, arrays, meta)
    meta["flight"] = flight_reasons(os.environ["SORT_FLIGHT_RECORDER_DIR"])
    core.drain_and_stop()
    spill_core.drain_and_stop()
    np.savez(os.path.join(out, f"ref_{rank}.npz"), **arrays)
    with open(os.path.join(out, f"ref_{rank}.json"), "w") as f:
        json.dump(meta, f)
""")

_PORT = textwrap.dedent("""
    import importlib.util, json, os, sys, threading, time
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["SORT_FLIGHT_RECORDER_DIR"] = os.path.join(out, f"port_flight_{rank}")
    os.environ["SORT_SPILL_DIR"] = os.path.join(out, f"port_spill_{rank}")
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from mpitest_tpu_torch.ops import exchange
    from mpitest_tpu_torch.parallel import make_mesh, multihost_init
    from mpitest_tpu_torch.parallel import mesh as mesh_mod
    from mpitest_tpu_torch.serve.client import ServeClient
    from mpitest_tpu_torch.serve.server import ServerCore, SortServer
    # the reference's client is stdlib + numpy: loaded by path, without jax
    spec = importlib.util.spec_from_file_location(
        "ref_client", os.path.join("mpitest_tpu", "serve", "client.py"))
    ref_client = sys.modules["ref_client"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_client)
    multihost_init(f"127.0.0.1:{port}", 2, rank, device="cpu")
""") + _KEYS + _SERVE + textwrap.dedent("""
    reqs, spill_bytes = json.loads(sys.argv[4]), sys.argv[5]
    arrays, meta, rounds, servers = {}, {}, [], []


    def serving(core):
        srv = SortServer(core, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return srv.bound_port


    try:
        mesh = make_mesh(devices=["cpu"] * 4)
        core = ServerCore(mesh)
        core.start_watchdog()
        os.environ["SORT_SERVE_MAX_BYTES"] = spill_bytes
        spill_core = ServerCore(mesh)
        del os.environ["SORT_SERVE_MAX_BYTES"]
        meta["device"] = str(core.device)
        meta["mesh_devices"] = len(core.mesh.devices)
        # every control-group round from here on is counted
        gather = mesh_mod._all_gather
        mesh_mod._all_gather = lambda step, obj: rounds.append(step) or gather(step, obj)
        serve_all(core, spill_core, reqs, arrays, meta)
        # the wire: both packages' clients against this process's servers
        ports = {False: serving(core), True: serving(spill_core)}
        wire = meta["wire"] = {}
        for label, client in (("port", ServeClient), ("ref", ref_client.ServeClient)):
            for i, req in enumerate(reqs):
                name, dtype, n, algo, width, spill = req
                x, pay = request(i, req)
                with client("127.0.0.1", ports[spill], timeout=60) as c:
                    r = c.sort(x, algo=algo, payload=pay)
                got = {"status": "ok" if r.ok else r.error,
                       "batched": r.header.get("batched"), "bucket": r.header.get("bucket")}
                if r.ok:
                    got["bytes_equal"] = (np.asarray(r.arr).view(np.uint8).tobytes()
                                          == arrays[name].tobytes()) and (
                        not width or r.payload.tobytes() == arrays[name + "/payload"].tobytes())
                wire[f"{label}/{name}"] = got
        # a solo request in process 0 only, while process 1 serves a batch
        t = time.perf_counter()
        x = keys("int32", 1 << 17 if rank == 0 else 4096, 9)
        status, result, attrs = core.execute(x, algo="radix")
        meta["one_sided"] = {
            "status": status, "seconds": time.perf_counter() - t,
            "batched": attrs.get("batched"), "breaker": core.breaker.engaged(),
            "trips": core.breaker.trips,
            "sorted_ok": status == "ok" and np.array_equal(result, np.sort(x))}
        if rank == 0:
            # a result_swap:1 batch of three members in this process only
            os.environ["SORT_SERVE_BATCH_WINDOW_MS"] = "500"
            fcore = ServerCore(mesh)
            del os.environ["SORT_SERVE_BATCH_WINDOW_MS"]
            os.environ["SORT_FAULTS"] = "result_swap:1"
            xs = [keys("int32", 1024, 40 + j) for j in range(3)]
            got = [None] * 3

            def one(j):
                got[j] = fcore.execute(xs[j])
            threads = [threading.Thread(target=one, args=(j,)) for j in range(3)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            del os.environ["SORT_FAULTS"]
            meta["swap"] = [{"status": st, "batch_id": at.get("batch_id"),
                             "sorted_ok": st == "ok" and np.array_equal(res, np.sort(x))}
                            for (st, res, at), x in zip(got, xs)]
            meta["swap_requeues"] = fcore.tracer.counters.get("serve_segment_requeues", 0)
            fcore.drain_and_stop()
        meta["control_rounds"] = list(rounds)
        meta["flight"] = flight_reasons(os.environ["SORT_FLIGHT_RECORDER_DIR"])
        # shutdown makes no collective call: process 1 leaves first
        t = time.perf_counter()
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        meta["drained"] = core.drain_and_stop(timeout=30) and spill_core.drain_and_stop(
            timeout=30)
        meta["shutdown_s"] = time.perf_counter() - t
    finally:
        exchange.release_ipc()
        dist.destroy_process_group()
    np.savez(os.path.join(out, f"port_{rank}.npz"), **arrays)
    with open(os.path.join(out, f"port_{rank}.json"), "w") as f:
        json.dump(meta, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' replies to every request, per process."""
    out = tmp_path_factory.mktemp("serve_crossprocess")
    args = [json.dumps([list(r) for r in REQUESTS]), str(SPILL_BYTES)]
    common = {"SORT_SERVE_BATCH_KEYS": "16384", "SORT_SPILL_COMPRESS": "off"}
    run_pair(_REF, out, args, {
        **common, "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    run_pair(_PORT, out, args, common)
    got = {}
    for who in ("ref", "port"):
        for r in range(2):
            meta = json.loads((out / f"{who}_{r}.json").read_text())
            got[who, r] = (meta, dict(np.load(out / f"{who}_{r}.npz")))
    return got


@pytest.mark.parametrize("name", BATCHED)
def test_batched_replies_equal_reference(runs, name):
    """A batched request is served by the process's own core: ``ok`` in
    both processes, bytes, ``batched`` and ``bucket`` the reference's."""
    for r in range(2):
        ref, ref_arrays = runs["ref", r]
        port, port_arrays = runs["port", r]
        assert ref[name]["status"] == port[name]["status"] == "ok", (r, ref[name], port[name])
        assert ref[name]["batched"] is port[name]["batched"] is True
        assert ref[name]["bucket"] == port[name]["bucket"] == int(name.rsplit("_", 1)[1])
        assert port_arrays[name].tobytes() == ref_arrays[name].tobytes(), r


@pytest.mark.parametrize("name", ["solo_radix", "solo_sample"])
def test_solo_requests_are_internal_in_both(runs, name):
    """A solo key request on a mesh across processes gets ``internal`` in
    every process of both packages: the reference sorts and fails to fetch
    the result, the port refuses with the same class before the sort, and
    its flight dump names ``RuntimeError``."""
    for r in range(2):
        ref, port = runs["ref", r][0], runs["port", r][0]
        assert ref[name]["status"] == port[name]["status"] == "internal", (r, ref[name])
        assert "RuntimeError" in ref[name]["detail"] and "RuntimeError" in port[name]["detail"]
        assert not port[name]["batched"]
        assert any("serve_internal_RuntimeError" in f for f in port["flight"]), port["flight"]


def test_record_request_runs_in_the_process_of_rank_0(runs):
    """A record request runs on the mesh's rank 0: ``ok`` in process 0
    with the reference's keys and payload, ``bad_request`` in process 1,
    in both packages."""
    ref, ref_arrays = runs["ref", 0]
    port, port_arrays = runs["port", 0]
    assert ref["records"]["status"] == port["records"]["status"] == "ok"
    for key in ("records", "records/payload"):
        assert port_arrays[key].tobytes() == ref_arrays[key].tobytes(), key
    for who in ("ref", "port"):
        assert runs[who, 1][0]["records"]["status"] == "bad_request", who


def test_spill_request_is_internal_in_both(runs):
    """A request above ``SORT_SERVE_MAX_BYTES`` spills, and the external
    sort across processes gets ``internal`` in both packages."""
    for r in range(2):
        ref, port = runs["ref", r][0], runs["port", r][0]
        assert ref["spill"]["status"] == port["spill"]["status"] == "internal", (r, ref["spill"])
        assert "RuntimeError" in port["spill"]["detail"]


def test_mesh_and_device_of_each_core(runs):
    """``/varz`` counts the global mesh (eight ranks in both packages); the
    port batches on the process's own first rank."""
    for r in range(2):
        assert runs["ref", r][0]["mesh_devices"] == runs["port", r][0]["mesh_devices"] == 8
        assert runs["port", r][0]["device"] == "cpu"


@pytest.mark.parametrize("client", ["port", "ref"])
def test_wire_replies_equal_execute(runs, client):
    """Each process's ``SortServer`` answers the port's client and the
    reference's with the replies ``execute`` gave: statuses, ``batched``,
    ``bucket`` and bytes."""
    for r in range(2):
        meta = runs["port", r][0]
        for name, *_ in REQUESTS:
            got = meta["wire"][f"{client}/{name}"]
            assert got["status"] == meta[name]["status"], (r, name, got)
            if got["status"] == "ok":
                assert got["bytes_equal"], (r, name)
                assert bool(got["batched"]) is bool(meta[name]["batched"])
                assert got["bucket"] == meta[name]["bucket"]


def test_one_sided_solo_is_refused_without_a_control_round(runs):
    """A solo request that reaches process 0 only gets ``internal`` within
    10 s; no control-group round runs once the cores are built, the
    breaker stays closed, and process 1 meanwhile serves its batch."""
    p0, p1 = runs["port", 0][0], runs["port", 1][0]
    assert p0["one_sided"]["status"] == "internal" and p0["one_sided"]["seconds"] < 10
    assert not p0["one_sided"]["breaker"] and not p0["one_sided"]["trips"]
    assert p1["one_sided"]["status"] == "ok" and p1["one_sided"]["batched"]
    assert p1["one_sided"]["sorted_ok"] and not p1["one_sided"]["breaker"]
    assert p0["control_rounds"] == p1["control_rounds"] == []


def test_poisoned_segment_is_internal_and_its_batchmate_ok(runs):
    """``result_swap:1`` in process 0 corrupts one packed batch of three
    members: the two touched segments fail verification, re-run solo and
    are refused (``internal``); the middle member's verified result
    returns ``ok`` from the same batch."""
    meta = runs["port", 0][0]
    assert sorted(m["status"] for m in meta["swap"]) == ["internal", "internal", "ok"]
    ok = next(m for m in meta["swap"] if m["status"] == "ok")
    assert ok["sorted_ok"] and ok["batch_id"]
    assert meta["swap_requeues"] == 2


def test_shutdown_makes_no_collective_call(runs):
    """Both processes drain and close at once, process 0 after its peer
    has left the group."""
    for r in range(2):
        meta = runs["port", r][0]
        assert meta["drained"] and meta["shutdown_s"] < 10, (r, meta["shutdown_s"])


# ------------------------------------------------------------ on the card

_CARD = textwrap.dedent("""
    import json, os, sys
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["SORT_FLIGHT_RECORDER_DIR"] = os.path.join(out, f"flight_{rank}")
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from mpitest_tpu_torch.ops import _build, exchange
    from mpitest_tpu_torch.parallel import multihost_init
    from mpitest_tpu_torch.serve.server import ServerCore
    multihost_init(f"127.0.0.1:{port}", 2, rank)
""") + _KEYS + textwrap.dedent("""
    try:
        assert dist.get_backend() == "gloo"
        core = ServerCore()
        assert core.mesh.cross_process and core.device.type == "cuda"
        core.prewarm()
        _build.reset_launches()
        for i, (dtype, n) in enumerate((("int32", 4096), ("int64", 16384),
                                        ("float32", 1 << 16))):
            x = keys(dtype, n, 60 + i)
            status, got, attrs = core.execute(x)
            k = x
            if x.dtype.kind == "f":
                # IEEE totalOrder (NaN of each sign, -0 before +0) by bit pattern
                u = x.view(np.uint32).astype(np.int64)
                k = np.where(u >> 31 == 1, ~u & 0xFFFFFFFF, u | 0x80000000)
            order = torch.sort(torch.from_numpy(k).cuda(), stable=True).indices.cpu().numpy()
            want = x[order]
            assert status == "ok" and attrs["batched"], (dtype, status, got)
            assert got.view(np.uint8).tobytes() == want.view(np.uint8).tobytes(), dtype
        status, _, _ = core.execute(keys("int32", 1 << 20, 7))
        assert status == "internal", status
        assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)
        assert core.drain_and_stop(timeout=30)
    finally:
        exchange.release_ipc()
        dist.destroy_process_group()
    print("CARD_OK")
""")


@pytest.mark.cuda
def test_serve_crossprocess_on_the_card(tmp_path):
    """Two processes share the card, each with ``ServerCore()`` over the
    global mesh: batched int32, int64 and float32 replies equal
    ``torch.sort`` on the card (of the float keys' totalOrder words); a
    solo request is ``internal`` with no kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the server's ranks are the card's)")
    outs = run_pair(_CARD, tmp_path, [], {})
    assert all("CARD_OK" in o for o in outs)
