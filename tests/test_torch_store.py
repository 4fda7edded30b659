"""The port's out-of-core store (``mpitest_tpu_torch/store/``) and its
merge-order kernel K8 against the reference's (``mpitest_tpu/store/``,
``ops/radix_pallas.merge_order`` under interpret), on the CPU.

The bytes on disk are the state the two packages share: runs either one
writes (raw SORTBIN1 and compressed SORTRUN2, every key dtype, with and
without payload) open, verify and read back in the other, the block codec
packs the same bytes, and a journal either one wrote resumes in the other.
``SORT_SPILL_COMPRESS`` is pinned on both sides: the reference's ``auto``
depends on a native library that may be absent.  The ``cuda`` test holds
the K8 kernel against its plain version on a card and skips here.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mpitest_tpu.ops import radix_pallas as ref_rp
from mpitest_tpu.store import compress as ref_compress
from mpitest_tpu.store import external as ref_external
from mpitest_tpu.store import manifest as ref_manifest
from mpitest_tpu.store import merge as ref_merge
from mpitest_tpu.store import runs as ref_runs
from mpitest_tpu_torch.models import records
from mpitest_tpu_torch.models.verify import Fingerprint
from mpitest_tpu_torch.ops import _build, radix
from mpitest_tpu_torch.store import aio, compress, external, manifest
from mpitest_tpu_torch.store import merge as mergelib
from mpitest_tpu_torch.store import runs as runlib

ALL_DTYPES = ("int8", "uint8", "int16", "uint16", "int32", "uint32",
              "int64", "uint64", "float32", "float64")


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


# ------------------------------------------------------------ K8


def _merge_planes(rng, n, key_words):
    kw = tuple(rng.integers(0, 7, size=n).astype(np.uint32)      # dup-heavy
               for _ in range(key_words))
    rid = rng.integers(0, 4, size=n).astype(np.uint32)
    pos = np.arange(n, dtype=np.uint32)
    rng.shuffle(pos)
    return kw + (rid, pos)


@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 37, 300, 1000, 4096])
def test_merge_order_plain_matches_reference(n, key_words, rng):
    """The plain K8 equals the reference's Pallas kernel under interpret
    and np.lexsort on the planes store/merge.py hands it."""
    planes = _merge_planes(rng, n, key_words)
    got = radix.merge_order_host(planes, "cpu")
    want = np.asarray(ref_rp.merge_order(planes, interpret=True))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.lexsort(tuple(reversed(planes))))


def test_merge_order_unsigned_edges(rng):
    """Words at and above 0x80000000 order as unsigned (W1)."""
    n = 1000
    kw = rng.choice(np.asarray([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001,
                                0xFFFFFFFE, 0xFFFFFFFF], np.uint32), n)
    planes = (kw, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    got = radix.merge_order_host(planes, "cpu")
    np.testing.assert_array_equal(got, np.lexsort(tuple(reversed(planes))))
    np.testing.assert_array_equal(
        got, np.asarray(ref_rp.merge_order(planes, interpret=True)))


def test_merge_order_ties_are_stable(rng):
    """Without tiebreak planes, equal keys keep their index order: the
    permutation is the stable np.lexsort, so every row is written once."""
    kw = rng.integers(0, 3, size=777).astype(np.uint32)
    got = radix.merge_order(torch.from_numpy(kw.view(np.int32)).reshape(1, -1).unbind(0))
    np.testing.assert_array_equal(got.numpy(), np.lexsort((kw,)))


def test_merge_order_envelope_is_typed():
    n = radix.MERGE_MAX_ELEMS + 1
    planes = (np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    with pytest.raises(ValueError, match="merge_order"):
        radix.merge_order_host(planes, "cpu")
    with pytest.raises(ValueError, match="merge_order"):
        ref_rp.merge_order(planes, interpret=True)
    with pytest.raises(ValueError, match="merge_order"):
        radix.merge_order(tuple(torch.zeros(n, dtype=torch.int32) for _ in range(2)))
    with pytest.raises(ValueError, match="1..8 planes"):
        radix.merge_order_host(tuple(np.zeros(4, np.uint32) for _ in range(9)), "cpu")
    assert radix.merge_order_host((np.zeros(1, np.uint32),), "cpu").tolist() == [0]


@pytest.mark.parametrize("n", [600, 4096, 4097])
def test_order_for_radix_pallas_equals_host_lexsort(n, rng, monkeypatch):
    """_order_for under radix_pallas on the CPU (K8's plain version up to
    4096 records, the host lexsort above) equals the host lexsort and the
    reference's _order_for."""
    kws = (rng.integers(0, 9, size=n).astype(np.uint32),
           rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32))
    rid = rng.integers(0, 3, size=n).astype(np.uint32)
    pos = np.arange(n, dtype=np.uint32)
    want = np.lexsort((pos, rid) + tuple(reversed(kws)))
    ref = ref_merge._order_for(kws, rid, pos)            # reference default: host
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    calls = []
    real = radix.merge_order_host
    monkeypatch.setattr(radix, "merge_order_host",
                        lambda planes, dev: calls.append(str(dev)) or real(planes, dev))
    got = mergelib._order_for(kws, rid, pos, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    assert calls == (["cpu"] if n <= radix.MERGE_MAX_ELEMS else [])


def test_order_for_needs_a_device_under_radix_pallas(rng, monkeypatch):
    """Without an explicit device the merge order goes to the card, and
    raises where there is none; it never picks the CPU on its own."""
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kws = (np.arange(10, dtype=np.uint32),)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mergelib._order_for(kws, np.zeros(10, np.uint32),
                            np.arange(10, dtype=np.uint32))


def test_merge_signature_arity_matches_source():
    src = (Path(_build.CSRC) / "merge.cu").read_text()
    entries = re.findall(r"^int (\w+)\(([^)]*)\)", src, re.M)
    assert [e for e, _ in entries] == list(radix.MERGE_SIGNATURES) == ["merge_order"]
    for entry, params in entries:
        assert len(radix.MERGE_SIGNATURES[entry]) == params.count(",") + 1, entry
        assert "stream" in params.split(",")[-1], entry


def test_merge_constants_match_source():
    """csrc/merge.cu stages n / kSplits columns a CTA for n up to kMaxN:
    its envelope and plane range are the wrapper's."""
    src = (Path(_build.CSRC) / "merge.cu").read_text()
    c = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert int(c["kMaxN"]) == radix.MERGE_MAX_ELEMS == 4096
    assert int(c["kMaxPlanes"]) == radix.MERGE_MAX_PLANES == 8
    assert c["kMaxCols"] == "kMaxN / kSplits"
    assert radix.MERGE_MAX_ELEMS % int(c["kSplits"]) == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 255, 256, 257, 1000, 4095, 4096])
@pytest.mark.parametrize("key_words", [1, 2])
def test_merge_order_kernel_matches_plain(n, key_words, rng, cuda_device):
    planes = list(_merge_planes(rng, n, key_words))
    planes[0][::5] = 0xFFFFFFFF
    planes[0][1::7] = 0x80000000
    base = _build.LAUNCHES["merge_order"]
    got = radix.merge_order_host(tuple(planes), cuda_device)
    assert _build.LAUNCHES["merge_order"] == base + 1
    np.testing.assert_array_equal(got, radix.merge_order_host(tuple(planes), "cpu"))
    np.testing.assert_array_equal(got, np.lexsort(tuple(reversed(planes))))
    dev_planes = tuple(torch.from_numpy(p.view(np.int32)).to(cuda_device)
                       for p in planes)
    np.testing.assert_array_equal(radix.merge_order(dev_planes).cpu().numpy(), got)


def _k8_on_card(planes, device):
    """K8 on the card against its plain version and np.lexsort; one
    launch."""
    base = _build.LAUNCHES["merge_order"]
    got = radix.merge_order_host(planes, device)
    assert _build.LAUNCHES["merge_order"] == base + 1
    on_card = tuple(torch.from_numpy(np.ascontiguousarray(p).view(np.int32)).to(device)
                    for p in planes)
    np.testing.assert_array_equal(got, radix.merge_order_plain(on_card).cpu().numpy())
    np.testing.assert_array_equal(got, np.lexsort(tuple(reversed(planes))))


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("n", [2, 5, 8, 9, 255, 257, 1000, 1025, 2049, 4095, 4096])
def test_merge_order_kernel_every_plane_count(n, k, rng, cuda_device):
    """The cluster kernel at n = 2..4096 (column splits of 1 to 512, row
    blocks cut anywhere) and k = 1..8 planes of dup-heavy words."""
    planes = [rng.integers(0, 4, size=n).astype(np.uint32) for _ in range(k)]
    planes[0][::3] = 0xFFFFFFFF
    planes[-1][1::4] = 0x80000000
    _k8_on_card(tuple(planes), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 257, 4096])
@pytest.mark.parametrize("word", [0, 0xFFFFFFFF])
def test_merge_order_kernel_all_tied(n, word, cuda_device):
    """Every key equal (0 or 0xFFFFFFFF in every plane): the order is the
    identity, ties ranked by index across the column splits."""
    planes = tuple(np.full(n, word, np.uint32) for _ in range(3))
    _k8_on_card(planes, cuda_device)
    assert radix.merge_order_host(planes, cuda_device).tolist() == list(range(n))


# ------------------------------------------------- bytes on disk


def _files(info):
    out = {}
    for p in (info.path, info.pay_path, info.sidecar_path):
        if os.path.exists(p):
            out[os.path.basename(p)] = Path(p).read_bytes()
    return out


def _run_inputs(rng, dtype, payload):
    keys = np.sort(_keys(rng, dtype, 9000))
    pay = (rng.integers(0, 256, (keys.size, 7), dtype=np.uint8)
           if payload else None)
    return keys, pay


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "runz"])
@pytest.mark.parametrize("payload", [False, True], ids=["keys", "payload"])
@pytest.mark.parametrize("dtype", ALL_DTYPES)
def test_port_runs_read_in_reference(dtype, payload, compressed, tmp_path, rng):
    """A run the port writes is byte-identical to the reference's, and
    opens, verifies and reads back in the reference."""
    keys, pay = _run_inputs(rng, dtype, payload)
    mine = runlib.write_run(str(tmp_path / "a"), "r0", keys, pay, compress=compressed)
    theirs = ref_runs.write_run(str(tmp_path / "b"), "r0", keys, pay,
                                compress=compressed)
    assert _files(mine) == _files(theirs)
    info = ref_runs.open_run(mine.path)
    assert info.compressed == compressed and info.n == keys.size
    assert ref_runs.verify_run(info, chunk_elems=1000)
    assert Fingerprint.from_reference(info.fingerprint) == mine.fingerprint
    parts = list(ref_runs.read_run_chunks(info, 1000))
    assert np.array_equal(np.concatenate([k for k, _ in parts]), keys)
    if payload:
        assert np.array_equal(np.concatenate([p for _, p in parts]), pay)


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "runz"])
@pytest.mark.parametrize("payload", [False, True], ids=["keys", "payload"])
@pytest.mark.parametrize("dtype", ALL_DTYPES)
def test_reference_runs_read_in_port(dtype, payload, compressed, tmp_path, rng):
    keys, pay = _run_inputs(rng, dtype, payload)
    theirs = ref_runs.write_run(str(tmp_path), "r0", keys, pay, compress=compressed)
    info = runlib.open_run(theirs.path)
    assert info.compressed == compressed and info.n == keys.size
    assert info.disk_bytes == theirs.disk_bytes
    assert runlib.verify_run(info, chunk_elems=1000)
    assert info.fingerprint == Fingerprint.from_reference(theirs.fingerprint)
    parts = list(runlib.read_run_chunks(info, 1000))
    assert [len(k) for k, _ in parts] == [len(k) for k, _ in
                                          ref_runs.read_run_chunks(theirs, 1000)]
    assert np.array_equal(np.concatenate([k for k, _ in parts]), keys)
    if payload:
        assert np.array_equal(np.concatenate([p for _, p in parts]), pay)


@pytest.mark.parametrize("eng", ["native", "python"])
@pytest.mark.parametrize("shape", ["sorted", "constant", "single", "random",
                                   "wide"])
def test_pack_block_byte_equal_to_reference(eng, shape, rng):
    """Both of the port's engines pack the reference's bytes (its numpy
    engine, and its native one where its library is built)."""
    if eng == "native" and not compress.available():
        pytest.skip(f"native codec not built: {compress.unavailable_reason()}")
    vals = {"sorted": np.sort(rng.integers(0, 2**40, 4096, dtype=np.uint64)),
            "constant": np.full(100, 12345, np.uint64),
            "single": np.asarray([2**63 + 5], np.uint64),
            "random": rng.integers(0, 2**63, 3000, dtype=np.uint64),
            "wide": np.asarray([0, 2**64 - 1, 1, 2**63], np.uint64)}[shape]
    got = compress.pack_block(vals, eng=eng)
    assert got == ref_compress.pack_block(vals, eng="python")
    if ref_compress.available():
        assert got == ref_compress.pack_block(vals, eng="native")
    assert got == compress.pack_block(vals, eng="python")
    back, chk = compress.unpack_block(got[0], vals.size, got[1], got[2], eng=eng)
    assert np.array_equal(back, vals) and chk == got[3]


def test_block_corruption_is_typed_and_names_the_block(tmp_path, rng):
    keys = np.sort(_keys(rng, "int64", 20000))
    info = runlib.write_run(str(tmp_path), "r0", keys, compress=True)
    with open(info.path, "r+b") as f:
        f.seek(runlib.RUNZ_HEADER_LEN + 20)          # first block's checksum
        b = f.read(1)
        f.seek(runlib.RUNZ_HEADER_LEN + 20)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(runlib.BlockIntegrityError, match="block 0"):
        list(runlib.read_run_chunks(info, 4096))


def _plant(mw_cls, write_run, spill_dir, x, budget, dataset, chunks):
    """A killed sort's disk state: the chunks in ``chunks`` durably
    committed and journaled by ``mw_cls`` / ``write_run``."""
    chunk = external.spill_chunk_elems(budget, x.dtype, 0)
    mw = mw_cls(str(spill_dir), dataset, dtype=x.dtype.name, n=int(x.size),
                payload_width=0, algorithm="radix", chunk_elems=chunk,
                budget=budget, fanin=4)
    for ci in chunks:
        info = write_run(str(spill_dir), f"rdead_{ci:05d}",
                         np.sort(x[ci * chunk:(ci + 1) * chunk]), durable=True)
        mw.commit_run(ci, info)
    mw.close()
    return mw.path


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_journal_resumes_across_packages(direction, tmp_path, rng):
    """A journal (and its runs) one package committed before a crash
    resumes in the other: the committed chunks are not re-sorted and the
    bytes are the sorted input."""
    budget = 1 << 15
    x = _keys(rng, "int32", 12000)
    committed = [0, 1, 3]
    if direction == "reference_to_port":
        mpath = _plant(ref_manifest.ManifestWriter, ref_runs.write_run, tmp_path,
                       x, budget, "ds1", committed)
        assert manifest.load(mpath).runs[2].chunk == 3
        res = external.external_sort(x, budget=budget, spill_dir=str(tmp_path),
                                     dataset="ds1", fanin=4, device="cpu")
    else:
        mpath = _plant(manifest.ManifestWriter, runlib.write_run, tmp_path,
                       x, budget, "ds1", committed)
        assert ref_manifest.load(mpath).runs[2].chunk == 3
        res = ref_external.external_sort(x, budget=budget, spill_dir=str(tmp_path),
                                         dataset="ds1", fanin=4)
    assert res.resumed_runs == len(committed)
    assert np.array_equal(res.keys, np.sort(x))
    assert not os.path.exists(mpath)


def test_journal_lines_equal_reference(tmp_path, rng):
    keys = np.sort(_keys(rng, "int64", 3000))
    paths = []
    for sub, mw_cls, wr in (("a", manifest.ManifestWriter, runlib.write_run),
                            ("b", ref_manifest.ManifestWriter, ref_runs.write_run)):
        d = str(tmp_path / sub)
        mw = mw_cls(d, "ds", dtype="int64", n=3000, payload_width=0,
                    algorithm="radix", chunk_elems=1024, budget=1 << 14, fanin=4)
        mw.commit_run(0, wr(d, "r0", keys, durable=True))
        mw.close()
        paths.append(mw.path)
    a, b = (Path(p).read_text().replace(str(tmp_path / s), "D")
            for p, s in zip(paths, "ab"))
    assert a == b


# ------------------------------------------------------------ merge


def _write_both(tmp_path, runs, pays=None):
    infos = []
    for i, r in enumerate(runs):
        infos.append(runlib.write_run(str(tmp_path), f"r{i}", r,
                                      None if pays is None else pays[i]))
    return infos, [ref_runs.open_run(r.path) for r in infos]


def _chunks(it):
    return [(tuple(k.tolist() for k in kws), tuple(p.tolist() for p in pws))
            for kws, pws in it]


@pytest.mark.parametrize("io", [False, True], ids=["sync", "async_io"])
@pytest.mark.parametrize("case", ["stable_payload", "plateau", "mixed", "empty_run"])
def test_merge_runs_equals_reference(case, io, tmp_path, rng, monkeypatch):
    """merge_runs yields the reference's chunks: the same boundaries, the
    same keys, the payload in stable run order on equal keys; also under
    radix_pallas (K8's plain version on the CPU)."""
    pays = None
    if case == "stable_payload":
        runs = [np.sort(rng.integers(0, 20, 1200).astype(np.int32)) for _ in range(4)]
        pays = [np.full((r.size, 4), i, np.uint8) for i, r in enumerate(runs)]
    elif case == "plateau":
        runs = [np.full(2000, 7, np.int64) for _ in range(3)]
    elif case == "mixed":
        runs = [np.sort(_keys(rng, "float64", m)) for m in (1500, 1, 900, 1234)]
    else:
        runs = [np.sort(_keys(rng, "uint32", 1200)), np.empty(0, np.uint32),
                np.sort(_keys(rng, "uint32", 800))]
    mine, theirs = _write_both(tmp_path, runs, pays)
    want = _chunks(ref_merge.merge_runs(theirs, 300))
    mio = aio.MergeIO() if io else None
    got = _chunks(mergelib.merge_runs(mine, 300, io=mio, device="cpu"))
    assert got == want
    if mio is not None:
        assert {t.name for r in mio.readers for t in [r._thread]} == {"spill-readahead"}
        mio.close()
    monkeypatch.setenv("SORT_LOCAL_ENGINE", "radix_pallas")
    assert _chunks(mergelib.merge_runs(mine, 300, device="cpu")) == want
    if case == "stable_payload":
        keys = np.concatenate([np.asarray(k[0]) for k, _ in got])
        run_of = np.concatenate([np.asarray(p[0]) for _, p in got])
        order = np.lexsort((run_of, keys))
        assert np.array_equal(order, np.arange(keys.size))   # run order on ties


def test_merge_detects_a_corrupt_run(tmp_path, rng):
    keys = np.sort(_keys(rng, "int32", 5000))
    infos, _ = _write_both(tmp_path, [keys, keys])
    with open(infos[1].path, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0x5A]))
    assert not runlib.verify_run(infos[1])
    with pytest.raises(mergelib.RunIntegrityError) as ei:
        list(mergelib.merge_runs(infos, 1000, device="cpu"))
    assert ei.value.info == infos[1]


def test_writebehind_writes_the_same_run(tmp_path, rng):
    keys = np.sort(_keys(rng, "uint64", 10000))
    w = runlib.RunStreamWriter(str(tmp_path / "a"), "m", keys.dtype, compress=True)
    wb = aio.WriteBehind(w)
    assert wb._thread.name == "spill-writebehind"
    codec = runlib.codec_for(keys.dtype)
    for i in range(0, keys.size, 3000):
        wb.append_words(codec.encode(keys[i:i + 3000]), ())
    info = wb.close()
    ref = ref_runs.write_run(str(tmp_path / "b"), "m", keys, compress=True)
    assert _files(info) == _files(ref)


def test_payload_helpers_match_reference(rng):
    from mpitest_tpu.models import records as ref_records

    for width in (0, 1, 4, 7, 13):
        pay = rng.integers(0, 256, (50, width), dtype=np.uint8)
        words = records.payload_to_words(pay)
        ref = ref_records.payload_to_words(pay)
        assert len(words) == len(ref) == records.payload_width_words(width)
        assert all(np.array_equal(a, b) for a, b in zip(words, ref))
        assert np.array_equal(records.words_to_payload(words, 50, width), pay)
    ids = rng.integers(0, 2**63, 50, dtype=np.uint64)
    assert np.array_equal(records.as_payload_matrix(ids, 50),
                          ref_records.as_payload_matrix(ids, 50))
    assert records.as_payload_matrix(bytes(range(100)), 50).shape == (50, 2)
    with pytest.raises(ValueError, match="multiple"):
        records.as_payload_matrix(bytes(101), 50)
