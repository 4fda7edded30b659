"""The port's server against the reference's on CPU ranks: the same
request streams (made from a numpy seed) into a reference ``ServerCore``
on the virtual CPU mesh and a port ``ServerCore`` on as many CPU ranks
give the same reply bytes and the same reply header (``ok``, ``n``,
``dtype``, ``batched``, ``bucket``, ``payload_bytes``, ``spilled`` and the
``plan`` digest), and the same typed error codes.  Each package's client
talks to the other package's server.

One reference core and one port core per rank count, for the module.  Both
pin ``SORT_EXCHANGE_ENGINE=lax``, and the reference's exchange pack is
its TPU choice (the 1024-aligned Pallas pack, in interpret mode on the
CPU) as the port's is, so the negotiated caps in the digests align."""

from __future__ import annotations

import io
import json
import threading
import zlib
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from mpitest_tpu.models import api as ref_api
from mpitest_tpu.parallel.mesh import make_mesh as ref_make_mesh
from mpitest_tpu.serve import client as ref_client
from mpitest_tpu.serve import server as ref_server
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.serve import client as port_client
from mpitest_tpu_torch.serve import server as port_server

ENV = {"SORT_EXCHANGE_ENGINE": "lax", "SORT_SERVE_BATCH_WINDOW_MS": "0",
       "SORT_SERVE_BATCH_KEYS": "2048", "SORT_SERVE_ALLOW_FAULTS": "0",
       "SORT_PLANNER": "off", "SORT_SENTINEL": "on"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cores(tmp_path_factory):
    """{P: (reference core, port core)} for P = 1 and 8, built and used
    under one environment."""
    mp = pytest.MonkeyPatch()
    for k, v in ENV.items():
        mp.setenv(k, v)
    mp.setenv("SORT_FLIGHT_RECORDER_DIR", str(tmp_path_factory.mktemp("flight")))
    orig = ref_api._resolve_pack
    mp.setattr(ref_api, "_resolve_pack",
               lambda pack: orig("pallas_interpret" if pack is None else pack))
    out = {P: (ref_server.ServerCore(mesh=ref_make_mesh(P)),
               port_server.ServerCore(make_mesh(P, devices=["cpu"] * P)))
           for P in (1, 8)}
    yield out
    for rc, pc in out.values():
        rc.batcher.stop(timeout=10)
        pc.batcher.stop(timeout=10)
    mp.undo()


def _keys(rng, dtype: str, n: int) -> np.ndarray:
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = rng.standard_normal(n).astype(dt)
        x[::97] = -0.0
        return x
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=n, dtype=dt, endpoint=True)


def _wire(core, hdr: dict, body: bytes) -> tuple[dict, bytes, bool]:
    resp, payload, keep = core.handle_wire(
        json.dumps(hdr).encode() + b"\n", io.BytesIO(body))
    if isinstance(payload, list):
        payload = b"".join(bytes(v) for v in payload)
    return resp, bytes(payload), keep


def _same_reply(rc, pc, hdr: dict, body: bytes) -> dict:
    r = _wire(rc, hdr, body)
    p = _wire(pc, hdr, body)
    rh, ph = dict(r[0]), dict(p[0])
    for h in (rh, ph):
        h.pop("batch_id", None)
    if not rh["ok"]:
        rh.pop("detail"), ph.pop("detail")
    assert ph == rh
    assert p[1] == r[1] and p[2] == r[2]
    return ph


# (dtype, n, algo, payload width): n <= 2048 batches, larger runs solo
CASES = [
    ("int32", 700, None, 0),
    ("uint64", 1500, None, 0),
    ("float64", 900, None, 0),
    ("int32", 3000, "radix", 0),
    ("int32", 3000, "sample", 0),
    ("uint64", 4000, "radix", 0),
    ("float64", 3500, "sample", 0),
    ("int32", 2500, "radix", 5),
]


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-w{c[3]}")
def test_replies_equal_reference(cores, P, case):
    dtype, n, algo, width = case
    rc, pc = cores[P]
    rng = np.random.default_rng(zlib.crc32(repr((P, case)).encode()))
    x = _keys(rng, dtype, n)
    hdr = {"v": "sortserve.v1", "dtype": dtype, "n": n,
           "trace_id": f"par-{P}-{n}"}
    body = x.tobytes()
    if algo:
        hdr["algo"] = algo
    if width:
        hdr["payload_bytes"] = width
        body += rng.integers(0, 256, size=n * width, dtype=np.uint8).tobytes()
    h = _same_reply(rc, pc, hdr, body)
    assert h["ok"] and h["batched"] is (n <= 2048 and not width)
    if h["batched"]:
        assert h["bucket"] == 1 << (n - 1).bit_length()
        assert h["plan"]["algo"] == "packed"
    elif not width:
        assert h["plan"]["algo"] == algo
        assert ("exchange_engine" in h["plan"]) is (P > 1)


def test_batched_window_parity(cores, monkeypatch):
    """Concurrent requests packed by a window: every member's reply equals
    the reference's solo-equivalent bytes and the batch digest's shape."""
    rc, pc = cores[1]
    rng = np.random.default_rng(11)
    arrs = [_keys(rng, "int32", n) for n in (300, 500, 200)]
    for core in (rc, pc):
        core.batcher.set_window(0.2)
    try:
        got = {}
        for tag, core in (("ref", rc), ("port", pc)):
            res = {}

            def send(i, core=core, res=res):
                res[i] = core.execute(arrs[i])

            ts = [threading.Thread(target=send, args=(i,)) for i in range(3)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            got[tag] = res
        for i, a in enumerate(arrs):
            for tag in ("ref", "port"):
                st, out, attrs = got[tag][i]
                assert st == "ok" and np.array_equal(out, np.sort(a)), tag
        ref_b = {got["ref"][i][2]["bucket"] for i in range(3)}
        port_b = {got["port"][i][2]["bucket"] for i in range(3)}
        assert port_b == ref_b
        assert [got["port"][i][2]["batched"] for i in range(3)] == \
            [got["ref"][i][2]["batched"] for i in range(3)]
    finally:
        for core in (rc, pc):
            core.batcher.set_window(0.0)


def _hdr(**kw) -> dict:
    h = {"v": "sortserve.v1", "dtype": "int32", "n": 8, "trace_id": "err-1"}
    h.update(kw)
    return h


ERRORS = {
    "bad_version": (_hdr(v="sortserve.v0"), np.arange(8, dtype=np.int32).tobytes()),
    "bad_dtype": (_hdr(dtype="complex64"), b"\0" * 64),
    "bad_n": (_hdr(n=0), b""),
    "bad_trace_id": (_hdr(trace_id="no spaces"), np.arange(8, dtype=np.int32).tobytes()),
    "bad_algo": (_hdr(algo="bogus"), np.arange(8, dtype=np.int32).tobytes()),
    "faults_not_allowed": (_hdr(faults="result_swap"), np.arange(8, dtype=np.int32).tobytes()),
    "bad_deadline": (_hdr(deadline_ms=-1), np.arange(8, dtype=np.int32).tobytes()),
    "expired_deadline": (_hdr(deadline_ms=1e-6), np.arange(8, dtype=np.int32).tobytes()),
    "short_payload": (_hdr(n=16), np.arange(8, dtype=np.int32).tobytes()),
    "bad_payload_width": (_hdr(payload_bytes=-3), np.arange(8, dtype=np.int32).tobytes()),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_typed_errors_equal_reference(cores, name):
    rc, pc = cores[1]
    hdr, body = ERRORS[name]
    h = _same_reply(rc, pc, hdr, body)
    assert not h["ok"] and h["error"] in ("bad_request", "deadline_exceeded")


def test_garbage_header_equals_reference(cores):
    rc, pc = cores[1]
    for line in (b"not json\n", b"[1, 2]\n", b"\xff\xfe\n"):
        r = rc.handle_wire(line, io.BytesIO(b""))
        p = pc.handle_wire(line, io.BytesIO(b""))
        assert p[0]["error"] == r[0]["error"] == "bad_request"
        assert p[2] is r[2] is False


@contextmanager
def _tcp(core, module):
    srv = module.SortServer(core, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.bound_port
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("direction", ["ref_client_port_server",
                                       "port_client_ref_server"])
def test_clients_work_across_packages(cores, direction):
    rc, pc = cores[1]
    core, srv_mod, cli_mod = ((pc, port_server, ref_client)
                              if direction == "ref_client_port_server"
                              else (rc, ref_server, port_client))
    rng = np.random.default_rng(21)
    x = _keys(rng, "int32", 1000)
    big = _keys(rng, "uint64", 3000)
    pay = rng.integers(0, 256, size=(1000, 4), dtype=np.uint8)
    with _tcp(core, srv_mod) as port:
        with cli_mod.ServeClient("127.0.0.1", port, timeout=60) as c:
            r = c.sort(x, trace_id="x-1")
            assert r.ok and r.trace_id == "x-1" and r.header["batched"]
            assert np.array_equal(r.arr, np.sort(x))
            r = c.sort(big, algo="sample")
            assert r.ok and not r.header["batched"]
            assert np.array_equal(r.arr, np.sort(big))
            r = c.sort(x, payload=pay)
            order = np.argsort(x, kind="stable")
            assert r.ok and np.array_equal(r.payload, pay[order])
            bad = c.sort(x, algo="bogus")
            assert not bad.ok and bad.error == "bad_request"
        rcli = cli_mod.ResilientClient("127.0.0.1", port, max_attempts=2)
        r = rcli.sort(x, deadline_ms=60000)
        assert r.ok and cli_mod.reply_fingerprint_ok(x, r)


def test_spill_replies_equal_reference(tmp_path, monkeypatch):
    """An over-budget request served by both packages' spill tiers: the
    same bytes, ``spilled`` header and digest (runs included)."""
    monkeypatch.setenv("SORT_SERVE_MAX_BYTES", str(1 << 13))
    monkeypatch.setenv("SORT_SPILL_COMPRESS", "off")
    monkeypatch.setenv("SORT_SERVE_BATCH_WINDOW_MS", "0")
    monkeypatch.setenv("SORT_SPILL_DIR", str(tmp_path / "spill"))
    rc = ref_server.ServerCore(mesh=ref_make_mesh(1))
    pc = port_server.ServerCore(make_mesh(1, devices=["cpu"]))
    try:
        x = _keys(np.random.default_rng(31), "int32", 1 << 12)
        hdr = {"v": "sortserve.v1", "dtype": "int32", "n": x.size,
               "trace_id": "spill-1"}
        h = _same_reply(rc, pc, hdr, x.tobytes())
        assert h["ok"] and h["spilled"] is True and h["plan"]["spilled"] is True
        assert h["plan"]["spill_runs"] >= 2
    finally:
        rc.batcher.stop(timeout=10)
        pc.batcher.stop(timeout=10)
