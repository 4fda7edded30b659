"""The port's external sort (``mpitest_tpu_torch/store/external.py``, run
with ``device="cpu"``) against the reference's (``mpitest_tpu/store/
external.py``) on the same seeded inputs: the sorted bytes, the run and
merge-pass counts, the spill ratio and the combined sidecar
``Fingerprint``, with budgets that force several merge passes at fan-in
4.  The port runs ``radix_pallas`` (K4's and K8's plain versions) in some
cases; the order is unique, so the bytes are the same as the reference's
default engine.  Then recovery, typed errors, the GC and the knobs.
"""

from __future__ import annotations

import errno
import os

import numpy as np
import pytest
import torch

from mpitest_tpu.store import external as ref_external
from mpitest_tpu.store import runs as ref_runs
from mpitest_tpu_torch.models.supervisor import SortIntegrityError
from mpitest_tpu_torch.models.verify import Fingerprint
from mpitest_tpu_torch.ops import radix
from mpitest_tpu_torch.store import external, manifest
from mpitest_tpu_torch.store import merge as mergelib
from mpitest_tpu_torch.store import runs as runlib
from mpitest_tpu_torch.utils import io as kio
from mpitest_tpu_torch.utils import knobs
from mpitest_tpu_torch.utils.trace import Tracer


def _keys(rng, dtype, n):
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (rng.standard_normal(n) * 10.0
                ** rng.integers(-10, 10, n)).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


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
def _pinned(monkeypatch):
    monkeypatch.setenv("SORT_SPILL_COMPRESS", "off")
    monkeypatch.delenv("SORT_LOCAL_ENGINE", raising=False)


def _capture_runs(monkeypatch, module):
    """Record every RunInfo ``module.write_run`` returns (the partition
    runs), so the combined sidecar fingerprint can be compared."""
    infos = []
    real = module.write_run

    def wrapped(*a, **k):
        info = real(*a, **k)
        infos.append(info)
        return info

    monkeypatch.setattr(module, "write_run", wrapped)
    return infos


def _combined(infos, convert=lambda fp: fp):
    fp = convert(infos[0].fingerprint)
    for r in infos[1:]:
        fp = fp.combine(convert(r.fingerprint))
    return fp


CASES = [
    # dtype, n, budget, compress, port engine: 16 runs and 2 merge passes
    # each; radix_pallas runs K4's and K8's plain versions
    ("int32", 1 << 14, 1 << 13, "off", "radix_pallas"),
    ("uint64", 1 << 14, 1 << 15, "on", "auto"),
    ("float32", 1 << 15, 1 << 15, "on", "auto"),
]

#: The reference's result per case, computed once per test process (the
#: three sinks of one case share it).
_REF: dict = {}


def _reference(case, x, tmp_path, monkeypatch):
    if case not in _REF:
        _, _, budget, comp, _ = case
        monkeypatch.setenv("SORT_SPILL_COMPRESS", comp)
        infos = _capture_runs(monkeypatch, ref_runs)
        res = ref_external.external_sort(x, budget=budget, fanin=4,
                                         spill_dir=str(tmp_path / "ref"))
        fp = _combined(infos, Fingerprint.from_reference)
        raw = ref_runs.write_run(str(tmp_path / "ref"), "out", res.keys,
                                 compress=False)
        _REF[case] = (res, fp, open(raw.path, "rb").read())
    return _REF[case]


@pytest.mark.parametrize("sink", ["array", "file", "callable"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_external_sort_equals_reference(case, sink, tmp_path, monkeypatch):
    dtype, n, budget, comp, engine = case
    x = _keys(np.random.default_rng(n), dtype, n)
    ref, ref_fp, ref_file = _reference(case, x, tmp_path, monkeypatch)
    monkeypatch.setenv("SORT_SPILL_COMPRESS", comp)
    monkeypatch.setenv("SORT_LOCAL_ENGINE", engine)
    infos = _capture_runs(monkeypatch, runlib)
    got = []
    tr = Tracer()
    res = external.external_sort(
        x, budget=budget, fanin=4, spill_dir=str(tmp_path / "port"),
        sink=(lambda k, p: got.append(k)) if sink == "callable" else sink,
        out_name="out", device="cpu", tracer=tr)
    assert res.merge_passes >= 2
    assert (res.n, res.runs, res.merge_passes, res.disk_bytes, res.recoveries) == \
        (ref.n, ref.runs, ref.merge_passes, ref.disk_bytes, ref.recoveries)
    assert res.spill_ratio == ref.spill_ratio
    assert _combined(infos) == ref_fp
    if sink == "array":
        assert res.keys.tobytes() == ref.keys.tobytes()
        assert res.keys.tobytes() == np.sort(x).tobytes()
    elif sink == "file":
        assert open(res.out_run.path, "rb").read() == ref_file
        assert runlib.verify_run(res.out_run) and not res.out_run.compressed
    else:
        assert np.concatenate(got).tobytes() == ref.keys.tobytes()
    assert tr.counters["external_runs"] == res.runs
    assert tr.counters["external_merge_passes"] == res.merge_passes
    names = [s.name for s in tr.spans.spans]
    assert names.count("external.run") == res.runs
    assert names.count("external.merge") >= res.merge_passes
    left = [f for f in os.listdir(tmp_path / "port") if not f.startswith("out")]
    assert left == []


RECORD_CASES = [
    # dtype, n, payload width, budget, compress, port engine
    ("int32", 1 << 13, 8, 1 << 14, "off", "radix_pallas"),
    ("int64", 1 << 13, 3, 1 << 14, "on", "auto"),
    ("float32", 5000, 10, 1 << 14, "off", "auto"),
    ("uint16", 6000, 1, 1 << 13, "on", "auto"),
]


@pytest.mark.parametrize("sink", ["array", "callable"])
@pytest.mark.parametrize("case", RECORD_CASES, ids=[c[0] for c in RECORD_CASES])
def test_external_record_sort_equals_reference(case, sink, tmp_path, monkeypatch):
    """``external_sort(x, payload)``: the chunk sorts are record sorts; keys,
    payload, runs, passes and the combined sidecar Fingerprint (key,
    payload and binding words) equal the reference's, and the records are
    the stable argsort-gather of the input (duplicate keys included)."""
    dtype, n, width, budget, comp, engine = case
    rng = np.random.default_rng(n + width)
    x = _keys(rng, dtype, n)
    x[n // 3: n // 3 + n // 8] = x[1]
    pay = rng.integers(0, 256, (n, width), dtype=np.uint8)
    monkeypatch.setenv("SORT_SPILL_COMPRESS", comp)
    ref_infos = _capture_runs(monkeypatch, ref_runs)
    ref = ref_external.external_sort(x, pay, budget=budget, fanin=4,
                                     spill_dir=str(tmp_path / "ref"))
    monkeypatch.setenv("SORT_LOCAL_ENGINE", engine)
    infos = _capture_runs(monkeypatch, runlib)
    got_k, got_p = [], []
    res = external.external_sort(
        x, pay, budget=budget, fanin=4, spill_dir=str(tmp_path / "port"),
        sink=((lambda k, p: (got_k.append(k), got_p.append(p)))
              if sink == "callable" else sink), device="cpu")
    assert res.merge_passes >= 2
    assert (res.n, res.runs, res.merge_passes, res.disk_bytes) == \
        (ref.n, ref.runs, ref.merge_passes, ref.disk_bytes)
    assert res.payload_width == ref.payload_width == width
    assert _combined(infos) == _combined(ref_infos, Fingerprint.from_reference)
    keys = res.keys if sink == "array" else np.concatenate(got_k)
    payload = res.payload if sink == "array" else np.concatenate(got_p)
    assert keys.tobytes() == ref.keys.tobytes()
    assert payload.tobytes() == ref.payload.tobytes()
    order = np.lexsort(tuple(reversed(runlib.codec_for(x.dtype).encode(x))))
    assert keys.tobytes() == x[order].tobytes()
    assert payload.tobytes() == pay[order].tobytes()


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_external_sort_file_equals_reference(fmt, tmp_path, rng, monkeypatch):
    x = _keys(rng, "int64", 8192)
    p = str(tmp_path / f"k.{fmt}")
    (kio.write_keys_binary if fmt == "binary" else kio.write_keys_text)(p, x)
    ref = ref_external.external_sort_file(p, np.int64, budget=1 << 15, fanin=4,
                                          spill_dir=str(tmp_path / "r"))
    sinks = []

    def factory(n):
        sinks.append(n)
        return lambda k, _p: None

    res = external.external_sort_file(p, np.int64, budget=1 << 15, fanin=4,
                                      spill_dir=str(tmp_path / "s"), device="cpu")
    assert (res.runs, res.merge_passes) == (ref.runs, ref.merge_passes)
    assert res.keys.tobytes() == ref.keys.tobytes() == np.sort(x).tobytes()
    res2 = external.external_sort_file(p, np.int64, budget=1 << 15, fanin=4,
                                       spill_dir=str(tmp_path / "s"), device="cpu",
                                       sink_factory=factory)
    assert sinks == [x.size] and res2.keys is None


def test_k8_leg_sizing():
    """The budget arithmetic that keeps merge rounds inside K8's envelope:
    int32 at fan-in 4 and 98304 B, int64 at 196608 B — chunks of 6144,
    per-run buffers of 1024, so a round holds at most 4 x 1024 records."""
    for dtype, budget in ((np.int32, 98304), (np.int64, 196608)):
        assert external.spill_chunk_elems(budget, np.dtype(dtype)) == 6144
        assert external.merge_chunk_elems(budget, np.dtype(dtype), 0, 4) == 1024
        assert 4 * 1024 <= radix.MERGE_MAX_ELEMS
    runs = -(-(1 << 24) // 6144)
    passes = 1
    while runs > 4:
        runs, passes = -(-runs // 4), passes + 1
    assert (-(-(1 << 24) // 6144), passes) == (2731, 6)


def test_k8_runs_every_small_round_under_radix_pallas(tmp_path, rng, monkeypatch):
    """Under radix_pallas every merge round of 2..4096 records goes to K8
    on the external sort's device, and the bytes are the sorted input."""
    x = _keys(rng, "int32", 12000)
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    rounds, calls = [], []
    real_for, real_k8 = mergelib._order_for, radix.merge_order_host

    def order_for(kws, rid, pos, device=None):
        rounds.append((int(rid.size), str(device)))
        return real_for(kws, rid, pos, device)

    monkeypatch.setattr(mergelib, "_order_for", order_for)
    monkeypatch.setattr(radix, "merge_order_host",
                        lambda planes, dev: calls.append(str(dev)) or real_k8(planes, dev))
    res = external.external_sort(x, budget=98304, fanin=4,
                                 spill_dir=str(tmp_path), device="cpu")
    assert res.keys.tobytes() == np.sort(x).tobytes()
    small = [n for n, _ in rounds if 1 < n <= radix.MERGE_MAX_ELEMS]
    assert small and len(calls) == len(small)
    assert {d for _, d in rounds} == {"cpu"} and set(calls) == {"cpu"}


# ----------------------------------------------------- recovery, errors


def _corrupting_write_run(monkeypatch, how_many):
    """Make the first ``how_many`` partition runs written bad on disk
    (one byte flipped after the sidecar was sealed)."""
    real = runlib.write_run
    state = {"left": how_many}

    def wrapped(*a, **k):
        info = real(*a, **k)
        if state["left"] > 0 and info.n > 0:
            state["left"] -= 1
            with open(info.path, "r+b") as f:
                f.seek(kio.BIN_HEADER_LEN + 8)
                b = f.read(1)
                f.seek(kio.BIN_HEADER_LEN + 8)
                f.write(bytes([b[0] ^ 0x5A]))
        return info

    monkeypatch.setattr(runlib, "write_run", wrapped)


def test_one_recovery_then_same_bytes(tmp_path, rng, monkeypatch):
    x = _keys(rng, "int32", 20000)
    _corrupting_write_run(monkeypatch, 1)
    tr = Tracer()
    res = external.external_sort(x, budget=1 << 15, fanin=4, device="cpu",
                                 spill_dir=str(tmp_path), tracer=tr)
    assert res.recoveries == 1 and tr.counters["external_recoveries"] == 1
    assert res.keys.tobytes() == np.sort(x).tobytes()
    assert [s.name for s in tr.spans.spans].count("external.recover") == 1
    assert os.listdir(tmp_path) == []


def test_two_failures_raise_typed(tmp_path, rng, monkeypatch):
    x = _keys(rng, "int32", 20000)
    _corrupting_write_run(monkeypatch, 10**6)
    with pytest.raises(SortIntegrityError, match="no verified result"):
        external.external_sort(x, budget=1 << 15, fanin=4, device="cpu",
                               spill_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []
    assert issubclass(mergelib.RunIntegrityError, SortIntegrityError)


def test_mid_merge_enospc_is_typed_and_partials_deleted(tmp_path, rng, monkeypatch):
    x = _keys(rng, "int32", 30000)
    real = runlib.RunStreamWriter.append
    seen = {"n": 0}

    def append(self, keys, payload=None):
        if os.path.basename(self.path).startswith("m"):   # an intermediate run
            seen["n"] += 1
            if seen["n"] == 3:
                raise OSError(errno.ENOSPC, "No space left on device")
        return real(self, keys, payload)

    monkeypatch.setattr(runlib.RunStreamWriter, "append", append)
    with pytest.raises(external.SpillCapacityError) as ei:
        external.external_sort(x, budget=1 << 15, fanin=4, device="cpu",
                               spill_dir=str(tmp_path), dataset="ds1")
    assert ei.value.errno == errno.ENOSPC and isinstance(ei.value, OSError)
    assert os.listdir(tmp_path) == []


def test_gc_reclaims_orphans_age_gated(tmp_path, rng):
    import time

    keys = np.sort(_keys(rng, "int32", 1000))
    runlib.write_run(str(tmp_path), "orphan_00000", keys)
    live = runlib.write_run(str(tmp_path), "live_00000", keys, durable=True)
    mw = manifest.ManifestWriter(str(tmp_path), "liveds", dtype="int32", n=1000,
                                 payload_width=0, algorithm="radix",
                                 chunk_elems=8192, budget=1 << 15, fanin=16)
    mw.commit_run(0, live)
    mw.close()
    (tmp_path / "stray.run.tmp").write_bytes(b"x")
    assert external.gc_spill_dir(str(tmp_path), age_s=3600) == 0
    old = time.time() - 7200
    for fn in os.listdir(tmp_path):
        os.utime(tmp_path / fn, (old, old))
    tr = Tracer()
    assert external.gc_spill_dir(str(tmp_path), age_s=3600, tracer=tr) == 3
    left = sorted(os.listdir(tmp_path))
    assert os.path.basename(live.path) in left and "liveds.mfst" in left
    assert not any(f.startswith(("orphan", "stray")) for f in left)
    assert [s.name for s in tr.spans.spans] == ["external.gc"]


@pytest.mark.parametrize("knob,value", [
    ("SORT_MERGE_FANIN", "1"), ("SORT_MERGE_FANIN", "many"),
    ("SORT_SPILL_COMPRESS", "zstd"), ("SORT_SPILL_THROTTLE_MBPS", "-2"),
    ("SORT_SPILL_THROTTLE_MBPS", "inf"), ("SORT_RESUME", "maybe"),
    ("SORT_SPILL_GC_AGE_S", "-1"), ("SORT_MEM_BUDGET", "-3"),
])
def test_knob_garbage_is_one_knob_error(knob, value, monkeypatch):
    from mpitest_tpu.utils import knobs as ref_knobs

    monkeypatch.setenv(knob, value)
    with pytest.raises(knobs.KnobError) as ei:
        knobs.get(knob)
    with pytest.raises(ValueError) as ref_ei:
        ref_knobs.get(knob)
    assert str(ei.value) == str(ref_ei.value)


def test_knob_defaults_match_reference(monkeypatch):
    from mpitest_tpu.utils import knobs as ref_knobs

    for name in ("SORT_SPILL_DIR", "SORT_MERGE_FANIN", "SORT_SPILL_COMPRESS",
                 "SORT_SPILL_THROTTLE_MBPS", "SORT_RESUME", "SORT_SPILL_GC_AGE_S",
                 "SORT_MEM_BUDGET"):
        monkeypatch.delenv(name, raising=False)
        assert knobs.get(name) == ref_knobs.get(name), name


def test_external_argument_errors(rng, monkeypatch):
    from mpitest_tpu_torch.parallel.mesh import make_mesh

    x = np.arange(10, dtype=np.int32)
    with pytest.raises(ValueError, match="budget"):
        external.external_sort(x, budget=0, device="cpu")
    with pytest.raises(ValueError, match="fan-in"):
        external.external_sort(x, budget=1 << 20, fanin=1, device="cpu")
    # a payload rides now (the record sort); a malformed one is refused as
    # in the reference
    with pytest.raises(ValueError, match="one element per record"):
        external.external_sort(x, payload=np.zeros(9, np.uint64), budget=1 << 20,
                               device="cpu")
    with pytest.raises(ValueError, match="either device or mesh"):
        external.external_sort(x, budget=1 << 20, device="cpu",
                               mesh=make_mesh(2, devices=["cpu"] * 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        external.external_sort(x, budget=1 << 20)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        external.external_sort_file("no-such-file", budget=1 << 20)


def test_external_on_a_cpu_mesh_equals_reference(tmp_path, rng):
    """Chunk sorts on a mesh of two CPU ranks; the merge on its first."""
    from mpitest_tpu_torch.parallel.mesh import make_mesh

    x = _keys(rng, "int32", 1 << 14)
    res = external.external_sort(x, algorithm="radix", budget=1 << 15, fanin=4,
                                 mesh=make_mesh(2, devices=["cpu"] * 2),
                                 spill_dir=str(tmp_path))
    assert res.runs == 8 and res.merge_passes == 2
    assert res.keys.tobytes() == np.sort(x).tobytes()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_external_sort_on_the_card_runs_k8(dtype, cuda_device, tmp_path, rng,
                                           monkeypatch):
    """On the card under radix_pallas: K4 sorts the chunks, K8 orders every
    merge round of 2..4096 records, and the bytes are the sorted input."""
    from mpitest_tpu_torch.ops import _build

    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    x = _keys(rng, dtype, 6144 * 9)
    budget = 98304 if dtype == "int32" else 196608
    _build.reset_launches()
    res = external.external_sort(x, budget=budget, fanin=4, spill_dir=str(tmp_path))
    assert (res.runs, res.merge_passes) == (9, 2)
    assert res.keys.tobytes() == np.sort(x).tobytes()
    assert _build.LAUNCHES["radix_pass"] > 0 and _build.LAUNCHES["merge_order"] > 0
