"""The port's fault registry and hooks (``mpitest_tpu_torch/faults.py``)
against the reference's (``mpitest_tpu/faults.py``).

Held equal: the spec grammar (counts, ``inf``, repeated sites) and the
text of every garbage-spec error; the splitmix64 corruption stream for
seeds 0, 3 and 7; ``parse_wire_faults``; the ``fired`` list and the bytes
each host hook (ingest, spill, commit, journal, merge) produces for the
same spec and seed; the exchange hook on every rank against the
reference's on one rank's buffers; the result hook against the
reference's global layout; and the robustness knobs' defaults and
error texts.  Plus the typed launch error of ``ops/_build.launch``.
"""

from __future__ import annotations

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpitest_tpu import faults as ref_faults
from mpitest_tpu.utils import knobs as ref_knobs
from mpitest_tpu_torch import faults
from mpitest_tpu_torch.models import supervisor
from mpitest_tpu_torch.models.api import DistributedSortResult
from mpitest_tpu_torch.ops import _build
from mpitest_tpu_torch.utils import knobs

#: site lists and spec strings the two registries must parse alike
SPECS = ["dispatch_error", "dispatch_error:2,result_dup", "dispatch_oom:inf",
         "exchange_corrupt,exchange_corrupt:3", "spill_enospc:inf,merge_drop",
         " cap_squeeze , ingest_poison:4 ,", "manifest_torn:1,merge_stall:inf"]
GARBAGE = ["nosuchsite", "dispatch_error:0", "dispatch_error:x", "kill:1@2",
           "garbage_site", "dispatch_error:-3", "result_dup:1.5", "wire_slow_drip"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and the plain versions' many small ops otherwise spin on each other's
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.install(None)
    ref_faults.install(None)
    faults.drop_pending()
    ref_faults.drop_pending()


def _both(spec, seed=0):
    return faults.FaultRegistry(spec, seed=seed), ref_faults.FaultRegistry(spec, seed=seed)


def test_site_vocabularies_are_the_reference_s():
    assert faults.SITES == ref_faults.SITES
    assert faults.EXCHANGE_SITES == ref_faults.EXCHANGE_SITES
    assert faults.WIRE_SITES == ref_faults.WIRE_SITES
    assert faults.WIRE_DEFAULT_PARAM == ref_faults.WIRE_DEFAULT_PARAM


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_like_the_reference(spec):
    got, want = _both(spec)
    assert {k: v.remaining for k, v in got.sites.items()} == \
        {k: v.remaining for k, v in want.sites.items()}
    for site in faults.SITES:
        for _ in range(6):
            assert got.would_fire(site) == want.would_fire(site)
            assert got.fire(site, k=1) == want.fire(site, k=1)
    assert got.fired == want.fired and got.injected == want.injected


def test_counts_and_inf():
    reg = faults.FaultRegistry("dispatch_error:2,result_dup", seed=1)
    assert reg.fire("dispatch_error") and reg.fire("dispatch_error")
    assert not reg.fire("dispatch_error")
    assert reg.fire("result_dup") and not reg.fire("result_dup")
    assert not reg.fire("cap_squeeze")
    assert reg.injected == 3
    inf = faults.FaultRegistry("dispatch_oom:inf", seed=3)
    assert all(inf.fire("dispatch_oom") for _ in range(50))
    assert [d["seq"] for _, d in inf.fired] == list(range(1, 51))


@pytest.mark.parametrize("bad", GARBAGE)
def test_garbage_spec_error_text_is_the_reference_s(bad):
    with pytest.raises(ValueError) as want:
        ref_faults.FaultRegistry(bad)
    with pytest.raises(ValueError) as got:
        faults.FaultRegistry(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_rand_word_stream_is_the_reference_s(seed):
    got, want = _both("exchange_corrupt", seed)
    words = [got.rand_word() for _ in range(64)]
    assert words == [want.rand_word() for _ in range(64)]
    assert all(0 < w <= 0xFFFFFFFF for w in words)
    # the stream advances only for the sites that fire
    a = faults.FaultRegistry("spill_corrupt", seed=seed)
    assert faults.arm_exchange(a) is None and not faults._PENDING_EXCHANGE
    assert a.rand_word() == words[0]


@pytest.mark.parametrize("spec", ["wire_torn_header", "wire_stall_payload@9:4",
                                  "wire_slow_drip@0,wire_delay_response:2",
                                  "wire_connect_silence, wire_disconnect_response@16"])
def test_parse_wire_faults_is_the_reference_s(spec):
    got = faults.parse_wire_faults(spec)
    want = ref_faults.parse_wire_faults(spec)
    assert [(f.site, f.param, f.every) for f in got] == \
        [(f.site, f.param, f.every) for f in want]
    assert [f.spec() for f in got] == [f.spec() for f in want]
    assert faults.parse_wire_faults(",".join(f.spec() for f in got)) == got
    assert [f.fires_on(i) for f in got for i in range(9)] == \
        [f.fires_on(i) for f in want for i in range(9)]


@pytest.mark.parametrize("bad", ["", "wire_nope", "wire_torn_header@x",
                                 "wire_torn_header@-1", "wire_slow_drip:0",
                                 "wire_slow_drip:y", "dispatch_error"])
def test_parse_wire_faults_garbage_text(bad):
    with pytest.raises(ValueError) as want:
        ref_faults.parse_wire_faults(bad)
    with pytest.raises(ValueError) as got:
        faults.parse_wire_faults(bad)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ knobs

ROBUST_KNOBS = ("SORT_FAULTS", "SORT_FAULTS_SEED", "SORT_FAULT_STALL_MS",
                "SORT_FAULT_ENOSPC_AT", "SORT_MAX_RETRIES", "SORT_RETRY_BACKOFF",
                "SORT_FALLBACK")


def test_robustness_knob_defaults_are_the_reference_s(monkeypatch):
    for name in ROBUST_KNOBS:
        monkeypatch.delenv(name, raising=False)
        assert knobs.get(name) == ref_knobs.get(name), name
    assert supervisor.max_retries() == 2 and supervisor.retry_backoff() == 0.05
    assert supervisor.fallback_enabled() is True
    assert faults.faults_seed() == 0 and faults.for_run() is None


@pytest.mark.parametrize("name,value", [
    ("SORT_FAULTS", "garbage_site"), ("SORT_FAULTS", "dispatch_error:0"),
    ("SORT_FAULTS_SEED", "x"), ("SORT_FAULT_STALL_MS", "0"),
    ("SORT_FAULT_STALL_MS", "soon"), ("SORT_FAULT_ENOSPC_AT", "0"),
    ("SORT_MAX_RETRIES", "-1"), ("SORT_RETRY_BACKOFF", "fast"),
    ("SORT_RETRY_BACKOFF", "inf"), ("SORT_FALLBACK", "2"),
])
def test_robustness_knob_error_text_is_the_reference_s(name, value, monkeypatch):
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError) as want:
        ref_knobs.get(name)
    with pytest.raises(ValueError) as got:
        knobs.get(name)
    assert str(got.value) == str(want.value)
    if name.startswith("SORT_FAULTS"):
        with pytest.raises(ValueError):
            faults.validate_env()


@pytest.mark.parametrize("name,value", [
    ("SORT_FAULTS", "result_dup:inf,cap_squeeze"), ("SORT_FAULTS_SEED", "-12"),
    ("SORT_FAULT_STALL_MS", "7"), ("SORT_FAULT_ENOSPC_AT", "3"),
    ("SORT_MAX_RETRIES", "0"), ("SORT_RETRY_BACKOFF", "0.5"), ("SORT_FALLBACK", "0"),
])
def test_robustness_knob_values_are_the_reference_s(name, value, monkeypatch):
    monkeypatch.setenv(name, value)
    assert knobs.get(name) == ref_knobs.get(name)


def test_for_run_parses_the_env_afresh_each_run(monkeypatch):
    monkeypatch.setenv("SORT_FAULTS", "dispatch_error:2")
    monkeypatch.setenv("SORT_FAULTS_SEED", "3")
    a, b = faults.for_run(), faults.for_run()
    assert a is not b and a.seed == 3 and a.sites["dispatch_error"].remaining == 2
    reg = faults.FaultRegistry("result_dup")
    faults.install(reg)
    assert faults.for_run() is reg


# ------------------------------------------------------------- host hooks

def _drive_host_hooks(mod, spec, seed, monkeypatch):
    """Every host hook of ``mod`` a few times under one active registry;
    returns (outputs, fired)."""
    monkeypatch.setenv("SORT_FAULT_ENOSPC_AT", "2")
    monkeypatch.setenv("SORT_FAULT_STALL_MS", "1")
    reg = mod.FaultRegistry(spec, seed=seed)
    out = []
    words = (np.arange(10, dtype=np.uint32), np.arange(10, 20, dtype=np.uint32))
    with mod.active(reg):
        assert mod.current() is reg
        for k in (1, 0, 0):
            out.append(tuple(w.tobytes() for w in mod.maybe_poison_chunk(words, k)))
        for raw in (b"\x01\x02\x03\x04\x05", b"\x00" * 3, b"\xff" * 8):
            out.append(mod.maybe_corrupt_spill(raw))
        for i in range(3):
            out.append(mod.should_drop_merge_chunk(i, 100 + i))
            out.append(mod.spill_tear_bytes(i * 5))
            out.append(mod.spill_bitrot_word())
            out.append(mod.spill_block_garbage_word())
            out.append(mod.manifest_tear_cut(i * 40 + 1))
            try:
                mod.maybe_spill_enospc(4096)
                out.append("written")
            except OSError as e:
                out.append((e.errno, str(e)))
            mod.maybe_merge_stall()
    assert mod.current() is None
    return out, reg.fired


@pytest.mark.parametrize("spec", [
    "ingest_poison,spill_corrupt,merge_drop,spill_torn_write,spill_bitrot,"
    "spill_block_garbage,manifest_torn,spill_enospc,merge_stall",
    "ingest_poison:inf,spill_corrupt:2,merge_drop:inf,spill_torn_write:inf,"
    "spill_bitrot:2,spill_block_garbage:inf,manifest_torn:inf,spill_enospc:inf",
    "spill_bitrot:inf",
])
@pytest.mark.parametrize("seed", [0, 7])
def test_host_hooks_are_the_reference_s(spec, seed, monkeypatch):
    got = _drive_host_hooks(faults, spec, seed, monkeypatch)
    want = _drive_host_hooks(ref_faults, spec, seed, monkeypatch)
    assert got == want


def test_hooks_are_no_ops_without_a_registry():
    words = (np.arange(4, dtype=np.uint32),)
    assert faults.maybe_poison_chunk(words, 0) is words
    assert faults.maybe_corrupt_spill(b"abcd") == b"abcd"
    assert not faults.should_drop_merge_chunk(0, 1)
    assert faults.spill_tear_bytes(99) == 0 and faults.manifest_tear_cut(99) == 0
    assert faults.spill_bitrot_word() is None and faults.spill_block_garbage_word() is None
    faults.maybe_spill_enospc(1)
    faults.maybe_merge_stall()
    faults.arm_exchange(None)
    recv = [(torch.zeros(2, 3, dtype=torch.int32),)]
    cnt = [torch.ones(2, dtype=torch.int32)]
    assert faults.apply_exchange_fault(recv, cnt) == (recv, cnt)


def test_ingest_poison_is_pinned_to_chunk_zero_across_threads():
    """The encode workers poll the site concurrently: the budget and the
    RNG stay under the registry's lock, and only chunk 0 is poisoned."""
    reg = faults.FaultRegistry("ingest_poison:inf", seed=5)
    words = (np.zeros(8, np.uint32),)
    hits = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with faults.active(reg):
            def work(k):
                out = faults.maybe_poison_chunk(words, k % 4)
                hits.append((k % 4, int(out[0][0])))
            threads = [threading.Thread(target=work, args=(k,)) for k in range(64)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert all(v == 0 for k, v in hits if k != 0)
    assert sum(1 for k, v in hits if k == 0 and v != 0) == 16 == reg.injected
    assert [d["seq"] for _, d in reg.fired] == list(range(1, 17))


def test_active_nests_and_clears_pending_at_teardown():
    outer, inner = faults.FaultRegistry("exchange_drop"), faults.FaultRegistry("cap_squeeze")
    with faults.active(outer):
        faults.arm_exchange(outer)
        with faults.active(inner):
            assert faults.current() is inner
        assert faults.current() is outer and len(faults._PENDING_EXCHANGE) == 1
    assert faults.current() is None and not faults._PENDING_EXCHANGE
    with faults.active(None) as r:
        assert r is None and faults.current() is None


# ----------------------------------------------------------- device hooks

@pytest.mark.parametrize("site", ["exchange_corrupt", "exchange_drop"])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_exchange_fault_lands_on_every_rank_as_in_the_reference(site, seed):
    """The reference applies the pending fault inside its SPMD program, so
    every rank's receive buffer is hit; the port applies it to each rank's
    planes.  Each rank's outcome equals the reference hook on that rank's
    buffers, the uint32 word reinterpreted on the int32 carriers."""
    P, cap, n_words = 4, 5, 2
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 2**32, (P, n_words, P, cap), dtype=np.uint64).astype(np.uint32)
    cnts = rng.integers(0, cap + 1, (P, P)).astype(np.int32)
    reg, rreg = _both(site, seed)
    faults.arm_exchange(reg)
    recv = [tuple(torch.from_numpy(planes[r, k].view(np.int32).copy())
                  for k in range(n_words)) for r in range(P)]
    recv_cnt = [torch.from_numpy(cnts[r].copy()) for r in range(P)]
    got_recv, got_cnt = faults.apply_exchange_fault(recv, recv_cnt)
    assert not faults._PENDING_EXCHANGE
    assert reg.fired == [(site, {"word": rreg.rand_word(), "seq": 1})]
    for r in range(P):
        ref_faults.drop_pending()
        ref_faults._PENDING_EXCHANGE.append({"site": site, "word": reg.fired[0][1]["word"]})
        want_recv, want_cnt = ref_faults.apply_exchange_fault(
            tuple(jnp.asarray(planes[r, k]) for k in range(n_words)),
            jnp.asarray(cnts[r]))
        for k in range(n_words):
            assert got_recv[r][k].numpy().view(np.uint32).tobytes() == \
                np.asarray(want_recv[k]).tobytes()
        assert got_cnt[r].numpy().tobytes() == np.asarray(want_cnt).tobytes()
        # the caller's buffers are untouched: the faulted ones are copies
        assert recv[r][0].numpy().view(np.uint32).tobytes() == planes[r, 0].tobytes()
    # one-shot: a second exchange of the same dispatch runs clean
    again = faults.apply_exchange_fault(recv, recv_cnt)
    assert again[0] is recv and again[1] is recv_cnt


def test_arm_then_drop_counts_the_dropped_fault():
    reg = faults.FaultRegistry("exchange_corrupt:2,exchange_drop", seed=1)
    faults.arm_exchange(reg)
    assert [s for s, _ in reg.fired] == ["exchange_corrupt"]
    assert faults.drop_pending() == 1 and faults.drop_pending() == 0
    faults.arm_exchange(reg)
    faults.arm_exchange(reg)
    faults.arm_exchange(reg)
    assert [s for s, _ in reg.fired] == ["exchange_corrupt", "exchange_corrupt",
                                         "exchange_drop"]
    assert faults.drop_pending() == 2


def _port_result(glob: np.ndarray, n_valid: int, ranks: int, ragged: bool):
    slots = glob.size // ranks
    shards = tuple((torch.from_numpy(glob[r * slots:(r + 1) * slots].view(np.int32).copy()),)
                   for r in range(ranks))
    if ragged:
        return DistributedSortResult((), n_valid, np.dtype(np.uint32),
                                     counts=np.full(ranks, slots), shard_slots=slots,
                                     shards=shards)
    return DistributedSortResult((), n_valid, np.dtype(np.uint32), shards=shards)


@pytest.mark.parametrize("site", ["result_swap", "result_dup"])
@pytest.mark.parametrize("ranks,slots,n_valid,ragged", [
    (8, 16, 128, False), (8, 16, 100, False), (8, 16, 1, False),
    (4, 48, 37, True), (4, 48, 191, True), (1, 2, 2, False)])
def test_result_hook_indexes_the_reference_s_global_layout(site, ranks, slots,
                                                           n_valid, ragged):
    """The reference swaps global element 0 with ``min(n_valid, size) - 1``
    (or copies 0 over 1) of its padded global array; the port maps global
    element i to shard i // slots, offset i % slots."""
    glob = np.random.default_rng(slots).integers(0, 2**32, ranks * slots,
                                                 dtype=np.uint64).astype(np.uint32)

    class RefRes:
        words = (jnp.asarray(glob),)

    RefRes.n_valid = n_valid
    reg, rreg = _both(site)
    want = ref_faults.maybe_corrupt_result(rreg, RefRes())
    got = faults.maybe_corrupt_result(reg, _port_result(glob, n_valid, ranks, ragged))
    flat = np.concatenate([s[0].numpy().view(np.uint32) for s in got.shards])
    assert flat.tobytes() == np.asarray(want.words[0]).tobytes()
    assert reg.fired == rreg.fired
    # a spent site leaves the result alone
    again = faults.maybe_corrupt_result(reg, got)
    assert np.concatenate([s[0].numpy().view(np.uint32) for s in again.shards]
                          ).tobytes() == flat.tobytes()


# --------------------------------------------------------- typed launch error

def test_launch_raises_the_typed_launch_error(monkeypatch):
    class Lib:
        @staticmethod
        def entry(*args):
            return 7

        @staticmethod
        def kernel_error_string(rc):
            return b"too many resources requested for launch"

    class Stream:
        cuda_stream = 0

    import contextlib

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    _build.LAUNCHES.setdefault("entry", 0)
    before = _build.LAUNCHES["entry"]
    with pytest.raises(_build.KernelLaunchError, match="code 7") as ei:
        _build.launch(Lib(), "entry", torch.device("cuda"), 1, 2)
    assert isinstance(ei.value, RuntimeError)   # old except-RuntimeError callers
    assert not isinstance(ei.value, supervisor.TRANSIENT)
    assert _build.LAUNCHES["entry"] == before   # a refused launch never counts
    del _build.LAUNCHES["entry"]


def test_transient_errors_are_the_two_the_ladder_absorbs():
    assert supervisor.TRANSIENT == (faults.DeviceDispatchError,
                                    torch.cuda.OutOfMemoryError)
    assert issubclass(faults.DeviceDispatchError, RuntimeError)
    for typ in (_build.KernelBuildError, _build.KernelLaunchError, RuntimeError):
        assert not issubclass(typ, supervisor.TRANSIENT)
