"""The spawned-server harness and drills of the port on CPU ranks: the
telemetry leg, the kill-and-resume drill and the sentinel cells
(``mpitest_tpu_torch/selftest/``), each against a server process that
the test starts with ``device="cpu"``.  ``chip_smoke.py`` phase 3n runs
the same drills against a server on the card."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.selftest import drills
from mpitest_tpu_torch.selftest.spawned import HOST, Server, launch_delta, run_load
from mpitest_tpu_torch.serve.client import ServeClient

#: The port's driver on CPU ranks, one intra-op thread.
CPU_DRIVER = (sys.executable, "-c",
              "import sys, torch; torch.set_num_threads(1); "
              "from mpitest_tpu_torch import sort_server; "
              "sys.exit(sort_server.main(['s'], device='cpu'))")

#: Small sizes: the solo request must exceed SORT_SERVE_BATCH_KEYS (2^16)
#: to run solo; the spill request (2^17 bytes) twice its byte bound.
SIZES = {"solo": 1 << 17, "mix_requests": 40, "clients": 4, "big": 1 << 16,
         "spill": 1 << 15, "spill_bytes": 1 << 16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_server_harness_spawns_scrapes_and_drains(tmp_path):
    """Ephemeral ports, the listening and metrics lines, /varz's launch
    counts, a mix over the wire, SIGTERM drain with exit 0."""
    srv = Server(tmp_path, "plain", {"SORT_SERVE_SHAPE_BUCKETS": "10"}, CPU_DRIVER)
    try:
        assert srv.port > 0 and srv.metrics_port and srv.start_s > 0
        before = srv.launches()
        assert set(before) >= {"bitonic_u32", "fused_pass_pack", "remote_a2a"}
        load = run_load(srv.port, 12, 3, 5, trace_prefix="h")
        assert load["statuses"] == {"ok": 12} and not load["bad"]
        # CPU ranks run the plain versions: no kernel launches
        assert launch_delta(before, srv.launches()) == {}
        code, hz = srv.get_json("/healthz")
        assert code == 200 and hz["requests_ok"] == 12
    finally:
        assert srv.stop() == 0
    names = {r.get("name") for r in srv.spans()}
    assert {"serve.request", "serve.batch"} <= names


def test_server_that_never_listens_fails_at_startup(tmp_path):
    """A driver that refuses its knobs exits before the listening line:
    the harness raises with the stderr tail instead of waiting."""
    with pytest.raises(RuntimeError, match="(?s)did not come up.*SORT_SERVE_PORT"):
        Server(tmp_path, "bad", {"SORT_SERVE_PORT": "70000"}, CPU_DRIVER)


def test_telemetry_leg(tmp_path):
    t = drills.telemetry_leg(tmp_path, SIZES, print, card=False, cmd=CPU_DRIVER,
                             mesh_for=lambda p: make_mesh(p, devices=["cpu"] * p))
    assert t["statuses"] == {"ok": 10, "integrity": 1}
    on, off = t["cap_regret"]
    assert off > on


def test_kill_resume_leg(tmp_path):
    t = drills.kill_resume_leg(tmp_path, SIZES, print, card=False, cmd=CPU_DRIVER)
    assert t["runs"] == 8


def test_sentinel_cells(tmp_path):
    assert drills.sentinel_cells(tmp_path, print) == {"cells": 3}


def test_solo_gate_holds_launches_on_the_card(tmp_path):
    """``card=True`` against CPU ranks: the solo request is answered but
    launches no kernel, so the launch gate fails."""
    srv = Server(tmp_path, "solo", {"SORT_SERVE_SHAPE_BUCKETS": "10"}, CPU_DRIVER)
    try:
        x = np.random.default_rng(0).integers(-2**31, 2**31 - 1, size=SIZES["solo"],
                                              dtype=np.int32)
        with pytest.raises(AssertionError, match="kernel bitonic_u32 never launched"):
            drills._solo(srv, x, drills.K1, True, "solo")
        wall, got = drills._solo(srv, x, drills.K1, False, "solo")
        assert wall > 0 and got == {}
        with ServeClient(HOST, srv.port) as c:
            assert c.sort(x[:100]).ok
    finally:
        srv.stop()
