"""The verifier's one-pass scan (``ops/fold.py``, ``csrc/verify.cu``).

* The plain version's row against numpy at sizes around the kernel's
  seams (its 4-word vectors, 128-word warps, 1024-word blocks), for one
  and two planes, with the fold shorter than the order check and the
  other way round.
* The glue: the ctypes signature against the C entry, the kernel's name
  outside every stage pattern of the benchmark (so its time stays in
  ``other_device_ms``), and with the library replaced, card tensors
  launch one scan a shard into one row tensor a device, read once, and
  never run the plain version.
* On a card (``cuda``-marked, skipped here): the kernel's row equals the
  plain version's on the same cases, on planes 1-3 words past a 16-byte
  boundary (alike, and different from plane to plane), and with faults
  planted at the seams.

Tolerance: exact (integer words)."""

from __future__ import annotations

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mpitest_tpu_torch.models import api, verify
from mpitest_tpu_torch.ops import _build, fold
from mpitest_tpu_torch.ops.keys import to_device_words
from mpitest_tpu_torch.utils import spans

U32 = 0xFFFFFFFF
ROOT = Path(__file__).resolve().parents[1]
SIZES = [0, 1, 2, 3, 4, 5, 127, 128, 129, 1023, 1024, 1025, 4095, 4096, 4097, 10007]


def _swap_at(n: int) -> int:
    """The first position of the pair :func:`_planes` swaps."""
    return min(3 * n // 4, n - 2)


def _planes(n: int, n_planes: int, seed: int) -> list[np.ndarray]:
    """Sorted planes (lexicographic, plane 0 first) with narrow high words,
    so ties in plane 0 make plane 1 decide; then one pair swapped past the
    middle, so the order check has something to find when it reaches it."""
    rng = np.random.default_rng(seed)
    ws = [rng.integers(0, 64 if p == 0 and n_planes > 1 else 2**32, n,
                       dtype=np.uint64).astype(np.uint32) for p in range(n_planes)]
    order = np.lexsort(ws[::-1]) if n else np.arange(0)
    ws = [w[order] for w in ws]
    if n >= 4:
        j = _swap_at(n)
        for w in ws:
            w[[j, j + 1]] = w[[j + 1, j]]
    return ws


def _row_np(ws: list[np.ndarray], n_sorted: int, n_fold: int, i_last: int) -> list[int]:
    """The scan's row by numpy."""
    k = len(ws)
    xors = [int(np.bitwise_xor.reduce(w[:n_fold])) if n_fold else 0 for w in ws]
    sums = [int(w[:n_fold].sum(dtype=np.uint64)) & U32 for w in ws]
    keys = list(zip(*(w[:n_sorted].tolist() for w in ws)))
    bad = int(any(a > b for a, b in zip(keys, keys[1:])))
    some = max(n_sorted, n_fold) > 0
    first = [int(w[0]) if some else 0 for w in ws]
    last = [int(w[i_last]) if i_last >= 0 else 0 for w in ws]
    row = xors + sums + [bad] + first + last
    assert len(row) == fold.row_width(k)
    return row


def _layouts(n: int) -> dict[str, tuple[int, int, int]]:
    """(n_sorted, n_fold, i_last) of each layout."""
    return {"whole": (n, n, n - 1),
            "fold_short": (n, n // 3, (n // 3) - 1),     # the ragged layout
            "fold_only": (0, n, -1),                     # the input side
            "check_only": (n, 0, n - 1)}


def _scan(ws: tuple[torch.Tensor, ...], n_sorted: int, n_fold: int,
          i_last: int) -> list[int]:
    row = torch.zeros(fold.row_width(len(ws)), dtype=torch.int64, device=ws[0].device)
    fold.scan(ws, n_sorted, n_fold, i_last, row)
    return [int(v) & U32 for v in row.tolist()]


@pytest.mark.parametrize("layout", ["whole", "fold_short", "fold_only", "check_only"])
@pytest.mark.parametrize("n_planes", [1, 2])
@pytest.mark.parametrize("n", SIZES)
def test_plain_scan_matches_numpy(n, n_planes, layout):
    ws = _planes(n, n_planes, n * 7 + n_planes)
    n_sorted, n_fold, i_last = _layouts(n)[layout]
    got = _scan(tuple(to_device_words(w, "cpu") for w in ws), n_sorted, n_fold, i_last)
    assert got == _row_np(ws, n_sorted, n_fold, i_last)


def test_scan_rejects_what_the_kernel_does_not_take():
    w = torch.zeros(8, dtype=torch.int32)
    row = torch.zeros(fold.row_width(1), dtype=torch.int64)
    with pytest.raises(TypeError):
        fold.scan((w.to(torch.int64),), 8, 8, 7, row)
    with pytest.raises(ValueError):
        fold.scan((w, w[:4]), 4, 4, 3, torch.zeros(fold.row_width(2), dtype=torch.int64))
    with pytest.raises(ValueError):
        fold.scan((w[::2],), 4, 4, 3, row)
    with pytest.raises(ValueError):
        fold.scan((w,), 9, 8, 7, row)
    with pytest.raises(IndexError):
        fold.scan((w,), 4, 2, 4, row)
    with pytest.raises(ValueError):
        fold.scan((w,), 8, 8, 7, row[:-1])
    with pytest.raises(ValueError):
        fold.scan((w,), 8, 8, 7, row.to(torch.int32))


def test_signature_arity_matches_source():
    """The ctypes signature names every parameter of the C entry, the
    trailing stream included, and every C entry has a signature."""
    src = (Path(_build.CSRC) / "verify.cu").read_text().split('extern "C"')[1]
    entries = re.findall(r"^int (\w+)\(([^)]*)\)", src, re.M)
    assert sorted(e for e, _ in entries) == sorted(fold.SIGNATURES) == ["verify_scan"]
    for entry, params in entries:
        assert len(fold.SIGNATURES[entry]) == params.count(",") + 1, entry


def test_kernel_names_fall_in_no_stage():
    """The benchmark files a kernel under a stage when a pattern of
    ``sortbench/stages/<stage>/*.txt`` is a substring of its name; the
    verifier's kernel matches none, so its time stays in
    ``other_device_ms``."""
    src = (Path(_build.CSRC) / "verify.cu").read_text()
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))?\s+(\w+)\(", src)
    assert kernels == ["verify_scan_kernel"]
    patterns = [line.strip() for f in sorted((ROOT / "sortbench" / "stages").glob("*/*.txt"))
                for line in f.read_text().splitlines()
                if line.strip() and not line.startswith("#")]
    assert patterns
    names = kernels + ["verify_scan"]
    assert not [(p, k) for p in patterns for k in names if p in k]


class _FakeLib:
    """Stands in for the loaded ``csrc/verify.cu``: records each call."""

    def __init__(self) -> None:
        self.calls: list[tuple] = []

        def verify_scan(*args):
            self.calls.append(args)
            return 0
        self.verify_scan = verify_scan


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors taken for card tensors: the wrapper launches the fake
    library through ``_build.launch``, and the plain version may not run;
    host reads are counted by name."""
    fake = _FakeLib()
    check = fold._check_args
    monkeypatch.setattr(fold, "_check_args", lambda *a: check(*a) or True)
    monkeypatch.setattr(fold, "lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())

    def boom(*a, **k):
        raise AssertionError("plain version ran for a card tensor")

    monkeypatch.setattr(fold, "scan_plain", boom)
    reads: list[str] = []
    real_sync = spans.host_sync

    @contextlib.contextmanager
    def counting_sync(what):
        reads.append(what)
        with real_sync(what):
            yield

    monkeypatch.setattr(spans, "host_sync", counting_sync)
    fake.reads = reads
    return fake


def test_card_input_fold_launches_a_shard_reads_once(fake_card):
    """The input fingerprint of 8 padded shards: one launch a shard that
    holds valid keys (the fold only, ``n_sorted`` 0), one host read."""
    n, n_valid = 1024, 8 * 1024 - 1500
    shards = [(torch.zeros(n, dtype=torch.int32),) for _ in range(8)]
    before = _build.launches("verify_scan")
    fp = verify.fingerprint_device(shards, n_valid)
    assert fp.count == n_valid
    assert _build.launches("verify_scan") - before == 7      # the last shard is all pad
    assert [c[2:6] for c in fake_card.calls] == \
        [(1, 0, n, -1)] * 6 + [(1, 0, n_valid - 6 * n, -1)]
    assert [c[0] for c in fake_card.calls] == [s[0].data_ptr() for s in shards[:7]]
    assert fake_card.reads == ["verify.fold"]


def test_card_result_check_launches_a_shard_reads_once(fake_card):
    """The check of a contiguous 4-rank result of two-word keys: one
    launch a shard over its whole order, its valid keys and its last key,
    both planes passed; one host read."""
    n, n_valid = 512, 4 * 512 - 100
    shards = tuple((torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32))
                   for _ in range(4))
    res = api.DistributedSortResult((), n_valid, np.dtype(np.int64), shards=shards)
    verify.verify_result(res, None)
    assert [c[2:6] for c in fake_card.calls] == \
        [(2, n, n, n - 1)] * 3 + [(2, n, n - 100, n - 1)]
    assert [c[:2] for c in fake_card.calls] == \
        [(s[0].data_ptr(), s[1].data_ptr()) for s in shards]
    assert fake_card.reads == ["verify.check"]


# ------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU form)")
    return torch.device("cuda")


def _both(ws: list[np.ndarray], n_sorted: int, n_fold: int, i_last: int,
          card: torch.device, offset: "int | tuple[int, ...]" = 0
          ) -> tuple[list[int], list[int]]:
    """The kernel's row and the plain version's, plane ``p`` starting
    ``offset`` words (``offset[p]`` for a tuple) into its allocation: an
    offset not a multiple of 4 takes the kernel's one-word head, and
    offsets that differ modulo 4 its one-word loop."""
    offs = offset if isinstance(offset, tuple) else (offset,)
    dev = tuple(to_device_words(np.concatenate([np.zeros(o, np.uint32), w]), card)[o:]
                for w, o in zip(ws, offs * len(ws)))
    host = tuple(to_device_words(w, "cpu") for w in ws)
    got = _scan(dev, n_sorted, n_fold, i_last)
    torch.cuda.synchronize()
    return got, _scan(host, n_sorted, n_fold, i_last)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3, (1, 2)])
@pytest.mark.parametrize("layout", ["whole", "fold_short", "fold_only", "check_only"])
@pytest.mark.parametrize("n_planes", [1, 2])
@pytest.mark.parametrize("n", SIZES[1:] + [(1 << 22) + 3])
def test_kernel_matches_plain(card, n, n_planes, layout, offset):
    ws = _planes(n, n_planes, n * 7 + n_planes)
    got, want = _both(ws, *_layouts(n)[layout], card, offset)
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("at", [0, 3, 4, 127, 128, 1023, 1024, 4095, 4096, -2])
@pytest.mark.parametrize("n_planes", [1, 2])
def test_kernel_finds_faults_at_seams(card, at, n_planes, offset):
    """Sorted planes with one pair swapped at the first pair, a vector
    (3/4), warp (127/128), block (1023/1024, 4095/4096) seam or the last
    pair, the planes aligned or 3 words past a 16-byte boundary (one word
    of head, then the seams shifted by one): the flag is set, and a word
    corrupted there moves the fold."""
    n = (1 << 20) + 1
    ws = [w.copy() for w in _planes(n, n_planes, 99)]
    k = _swap_at(n)
    for w in ws:                                   # undo the planted swap
        w[[k, k + 1]] = w[[k + 1, k]]
    clean, _ = _both(ws, n, n, n - 1, card, offset)
    assert clean[2 * n_planes] == 0
    j = at % n
    for w in ws:
        w[[j, j + 1]] = w[[j + 1, j]]
    if any(int(w[j]) != int(w[j + 1]) for w in ws):
        got, want = _both(ws, n, n, n - 1, card, offset)
        assert got == want and got[2 * n_planes] == 1
    ws[-1][j] ^= 0x10000
    got, want = _both(ws, n, n, n - 1, card, offset)
    assert got == want and got[:2 * n_planes] != clean[:2 * n_planes]
