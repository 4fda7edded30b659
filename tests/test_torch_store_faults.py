"""The store's fault sites (``store/runs.py``, ``merge.py``, ``manifest.py``,
``external.py``) through ``external_sort(device="cpu")`` against the
reference's ``external_sort``, under registries of the same spec and seed.

Per site both packages must end the same way — the sorted bytes after the
same number of integrity recoveries, or the same typed error
(``SpillCapacityError`` for ``spill_enospc``) — with the same ``fired``
list, the same counters and the same spill-directory state.  The input
gives 16 runs, merged in one pass at fan-in 16, and in two passes at
fan-in 4 for the cells marked so (an intermediate-pass recovery costs the
reference a 10 s write-behind join, so only a few take it);
``SORT_SPILL_COMPRESS``
is pinned (the reference's ``auto`` depends on a git-ignored build),
``on`` for the block-garbage site and for a second pass over the
corruption sites.  One ``spill_corrupt`` cell runs the port under
``radix_pallas``, whose recovery merge orders its rounds with K8's plain
version.  A journal torn by ``manifest_torn`` and left by a crash replays
alike: the torn line skipped, the other runs resumed.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from mpitest_tpu import faults as ref_faults
from mpitest_tpu.models.supervisor import SortFaultError as RefFault
from mpitest_tpu.store import external as ref_external
from mpitest_tpu.store import manifest as ref_manifest
from mpitest_tpu.utils.trace import Tracer as RefTracer
from mpitest_tpu_torch import faults
from mpitest_tpu_torch.models.supervisor import SortFaultError
from mpitest_tpu_torch.store import external, manifest
from mpitest_tpu_torch.utils.trace import Tracer

N, BUDGET = 1 << 14, 1 << 13
X = np.random.default_rng(1 << 14).integers(-(2**31), 2**31 - 1, N, dtype=np.int32)
COUNTERS = ("faults_injected", "external_recoveries")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("SORT_SPILL_COMPRESS", "off")
    monkeypatch.setenv("SORT_FAULT_STALL_MS", "1")
    monkeypatch.setenv("SORT_RETRY_BACKOFF", "0")
    monkeypatch.delenv("SORT_LOCAL_ENGINE", raising=False)
    yield
    faults.install(None)
    ref_faults.install(None)


def _run(pkg, spec, tmp_path, seed=7, dataset=None, x=X, budget=BUDGET, fanin=16):
    """One external sort in ``pkg`` under ``spec``: (outcome, bytes,
    recoveries, fired, counters, files left in the spill directory)."""
    mod, tracer, sort = ((ref_faults, RefTracer(), ref_external.external_sort)
                         if pkg == "ref" else
                         (faults, Tracer(), external.external_sort))
    kw = {} if pkg == "ref" else {"device": "cpu"}
    spill = tmp_path / ("p" if pkg == "port" else "r")
    reg = mod.FaultRegistry(spec, seed=seed) if spec else None
    mod.install(reg)
    try:
        res = sort(x, budget=budget, fanin=fanin, spill_dir=str(spill), tracer=tracer,
                   dataset=dataset, **kw)
        out = ("ok", res.keys.tobytes(), res.recoveries, res.runs, res.merge_passes,
               res.resumed_runs)
    except (SortFaultError, RefFault, OSError) as e:
        out = (type(e).__name__, getattr(e, "errno", None))
    finally:
        mod.install(None)
    left = sorted(os.listdir(spill)) if spill.exists() else []
    return (out, reg.fired if reg else [],
            {k: tracer.counters.get(k) for k in COUNTERS}, left)


def _both(spec, tmp_path, **kw):
    return _run("port", spec, tmp_path, **kw), _run("ref", spec, tmp_path, **kw)


@pytest.mark.parametrize("spec,compress,fanin,expect", [
    ("spill_corrupt", "off", 4, "ok"),
    ("spill_corrupt", "on", 16, "ok"),
    ("merge_drop", "off", 4, "ok"),
    ("spill_torn_write", "off", 16, "ok"),
    ("spill_torn_write", "on", 16, "ok"),
    ("spill_enospc", "off", 4, "SpillCapacityError"),
    ("spill_bitrot", "off", 16, "ok"),
    ("spill_bitrot", "on", 16, "ok"),
    ("spill_block_garbage", "on", 16, "ok"),
    ("merge_stall", "off", 4, "ok"),
    ("spill_corrupt:2,merge_drop,spill_bitrot", "off", 16, "ok"),
    ("merge_drop:inf", "off", 16, "SortIntegrityError"),
])
def test_store_site_equals_reference(spec, compress, fanin, expect, tmp_path,
                                     monkeypatch):
    monkeypatch.setenv("SORT_SPILL_COMPRESS", compress)
    monkeypatch.setenv("SORT_FAULT_ENOSPC_AT", "5")
    port, ref = _both(spec, tmp_path, fanin=fanin)
    assert port == ref
    assert port[0][0] == expect
    assert len(port[1]) >= 1 and port[2]["faults_injected"] == len(port[1])
    if expect == "ok":
        assert port[0][1] == np.sort(X).tobytes()
        assert port[0][3] == 16 and port[0][4] == (2 if fanin == 4 else 1)
        if spec not in ("merge_stall",):
            assert port[0][2] >= 1 and port[2]["external_recoveries"] == port[0][2]
    assert port[3] == []   # no partial run survives, success or failure


def test_manifest_torn_equals_reference(tmp_path):
    port, ref = _both("manifest_torn", tmp_path, dataset="d1")
    assert port == ref
    assert port[0][0] == "ok" and port[0][1] == np.sort(X).tobytes()
    assert [s for s, _ in port[1]] == ["manifest_torn"]


def test_torn_journal_replays_like_the_reference(tmp_path, monkeypatch):
    """A crash after a torn journal line (the journal outlives the run):
    the retry of the same dataset skips the torn line loudly and resumes
    every other committed run, in both packages."""
    for mod in (manifest.ManifestWriter, ref_manifest.ManifestWriter):
        monkeypatch.setattr(mod, "delete", lambda self: self.close())
    from mpitest_tpu.store import runs as ref_runs
    from mpitest_tpu_torch.store import runs

    # the crash also leaves the committed runs on disk
    monkeypatch.setattr(runs, "remove_run", lambda r: None)
    monkeypatch.setattr(ref_runs, "remove_run", lambda r: None)
    first = _both("manifest_torn", tmp_path, dataset="d2")
    assert first[0][0] == first[1][0]
    monkeypatch.undo()
    monkeypatch.setenv("SORT_SPILL_COMPRESS", "off")
    port = _run("port", "", tmp_path, dataset="d2")
    ref = _run("ref", "", tmp_path, dataset="d2")
    assert port[0] == ref[0]
    assert port[0][0] == "ok" and port[0][1] == np.sort(X).tobytes()
    assert port[0][5] == 15   # 16 committed, the torn line's run re-sorted


def test_spill_corrupt_recovers_through_k8_under_radix_pallas(tmp_path, monkeypatch):
    """The port under radix_pallas (K4 chunk sorts, K8 merge rounds, their
    plain versions here) recovers a corrupt spill like the reference."""
    x = np.random.default_rng(6144).integers(-(2**31), 2**31 - 1, 6144 * 9,
                                             dtype=np.int32)
    ref = _run("ref", "spill_corrupt", tmp_path, x=x, budget=98304)
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    from mpitest_tpu_torch.ops import radix

    calls = []
    real = radix.merge_order_host
    monkeypatch.setattr(radix, "merge_order_host",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    port = _run("port", "spill_corrupt", tmp_path, x=x, budget=98304)
    assert port == ref
    assert port[0][0] == "ok" and port[0][2] == 1 and calls
