"""The distributed radix's digit sort (``ops/radix.py`` ``digit_sort``,
``digit_count``; ``csrc/radix.cu`` ``digit_count`` + ``digit_scatter``).

On the CPU the wrappers run their plain versions, held here against an
independent yardstick: numpy's stable argsort of the digit, a gather of
every plane, and the digit's bincount and its exclusive sum.  Cases: a
bit field of one plane (bits 8, 11 and 16, shifts up to the top of the
word) and a plane of digits with sentinel lanes (``2^bits``: a dropped
peer's lanes and unfilled slots, which sort last in slot order and
count in no bin), 1-4 planes, n ragged, 0 and 1.  A stand-in library
applies the kernels' contract (the count's histogram, offsets and pass
histograms; one stable pass of at most 9 bits) through the pointers the
wrappers pass, so the launch path and the pass split are exercised and
the launches of one eight-rank sort are counted.  The route is pinned:
one wrapper call a rank a pass, one count a rank in the probe, outputs
those of the parent's sort-then-histogram.  The ``cuda`` tests hold the
kernels against the plain version on a card, byte for byte, and skip
here.  Tolerance: exact bytes.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from mpitest_tpu_torch.models import radix_sort
from mpitest_tpu_torch.ops import _build, exchange, kernels, radix
from mpitest_tpu_torch.parallel import collectives as coll

P8 = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(rng, n: int, n_planes: int, device="cpu"):
    return tuple(torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                                  .astype(np.int32)).to(device)
                 for _ in range(n_planes))


def _digit_plane(rng, n: int, bits: int, device="cpu", sentinel_share: float = 0.1):
    """A merge pass's digit plane: digits below 2^bits, and the sentinel
    ``2^bits`` on a share of the lanes (their words read 0, the fill of
    an unfilled slot, as ``slot_place`` leaves them)."""
    d = rng.integers(0, 1 << bits, n).astype(np.int32)
    d[rng.random(n) < sentinel_share] = 1 << bits
    return torch.from_numpy(d).to(device)


def _want(words, d: np.ndarray, bits: int):
    """The yardstick: numpy's stable argsort of the digit, every plane
    gathered by it, and ``(h, lo)`` from a bincount of the digits below
    ``2^bits``."""
    order = np.argsort(d, kind="stable")
    h = np.bincount(d[d < 1 << bits], minlength=1 << bits).astype(np.int32)
    lo = (np.cumsum(h) - h).astype(np.int32)
    return d[order], [w.cpu().numpy()[order] for w in words], h, lo


def _field(word: torch.Tensor, shift: int, bits: int) -> np.ndarray:
    u = word.cpu().numpy().view(np.uint32).astype(np.int64)
    return ((u >> shift) & ((1 << min(bits, 32 - shift)) - 1)).astype(np.int32)


def _check(got, want, with_digits: bool):
    sd, sw, (h, lo) = got
    wd, ww, wh, wlo = want
    if with_digits:
        assert sd.dtype == torch.int32 and np.array_equal(sd.cpu().numpy(), wd)
    else:
        assert sd is None
    assert len(sw) == len(ww)
    for g, w in zip(sw, ww):
        assert g.dtype == torch.int32 and g.cpu().numpy().tobytes() == w.tobytes()
    assert np.array_equal(h.cpu().numpy(), wh) and np.array_equal(lo.cpu().numpy(), wlo)


SIZES = [0, 1, 7, 5003]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits,shift", [(8, 0), (8, 24), (11, 0), (11, 22), (11, 28),
                                        (16, 0), (16, 16), (16, 24)])
def test_plain_bit_field_equals_stable_argsort(bits, shift, n):
    rng = np.random.default_rng(bits * 100 + shift + n)
    n_planes = 1 + (bits + shift + n) % 4
    words = _words(rng, n, n_planes)
    w_idx = n_planes - 1
    got = radix.digit_sort(words, bits, w_idx=w_idx, shift=shift)
    _check(got, _want(words, _field(words[w_idx], shift, bits), bits), False)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("n_words", [1, 2, 3])
@pytest.mark.parametrize("bits", [8, 11, 16])
def test_plain_digit_plane_sentinels_sort_last_and_count_nowhere(bits, n_words, n):
    rng = np.random.default_rng(bits * 10 + n_words + n)
    words = _words(rng, n, n_words)
    d = _digit_plane(rng, n, bits)
    words = tuple(torch.where(d == 1 << bits, 0, w) for w in words)
    got = radix.digit_sort(words, bits, digits=d)
    want = _want(words, d.numpy(), bits)
    _check(got, want, True)
    if n:
        sent = int((d == 1 << bits).sum())
        assert int(got[2][0].sum()) == n - sent
        assert torch.all(got[0][n - sent:] == 1 << bits)


@pytest.mark.parametrize("bits,shift,n", [(16, 0, 5003), (8, 8, 1), (11, 28, 0),
                                          (16, 24, 4096)])
def test_plain_count_equals_histogram_sorted_and_bincount(bits, shift, n):
    rng = np.random.default_rng(bits + shift + n)
    (w,) = _words(rng, n, 1)
    h, lo = radix.digit_count(w, shift, bits)
    d = kernels.digit_at(w, shift, bits)
    sh, slo = kernels.histogram_sorted(torch.sort(d).values, 1 << bits)
    assert torch.equal(h, sh) and torch.equal(lo, slo)
    assert torch.equal(h, kernels.histogram(d, 1 << bits))
    assert h.dtype == lo.dtype == torch.int32


def test_digit_sort_keeps_its_callers_signature():
    """``radix_sort._digit_sort(d, words)`` (the merge pass's sort
    without its histogram) is the digit sort's first two outputs."""
    rng = np.random.default_rng(3)
    words = _words(rng, 300, 2)
    d = _digit_plane(rng, 300, 8)
    sd, sw = radix_sort._digit_sort(d, words)
    want = radix.digit_sort(words, 8, digits=d)
    assert torch.equal(sd, want[0]) and all(torch.equal(a, b) for a, b in zip(sw, want[1]))


@pytest.mark.parametrize("key_bits,split", [(1, (1,)), (8, (8,)), (9, (9,)), (10, (5, 5)),
                                            (11, (5, 6)), (12, (6, 6)), (16, (8, 8)),
                                            (17, (8, 9))])
def test_sweep_split(key_bits, split):
    """One pass up to 9 bits, else two of at most 9, low first."""
    assert radix.sweep_split(key_bits) == split
    assert sum(split) == key_bits and max(split) <= radix.SWEEP_BITS


def test_constants_match_source():
    import re
    from pathlib import Path
    src = (Path(_build.CSRC) / "radix.cu").read_text()
    c = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert int(c["kSweepBits"]) == radix.SWEEP_BITS
    assert c["kSweepBins"] == "1 << kSweepBits"
    assert int(c["kDigitMaxBits"]) == radix.DIGIT_SORT_MAX_BITS
    assert c["kCountHead"] == "2 * kSweepBins + 4 + kCountSlices"
    assert c["kCountSlices"] == "(1 << kDigitMaxBits) / kCountSlice"
    assert c["kCountSlice"] == "4 * kCountThreads" and int(c["kCountThreads"]) == 1024
    assert radix.COUNT_HEAD == 2 * 512 + 4 + (1 << 16) // 4096 and radix.COUNT_HEAD % 4 == 0
    assert "long long sweep_status_words(long long n) { return tiles_for(n) * kSweepBins * 2; }" \
        in src
    assert radix.sweep_status_words(8193) == 2 * 512 * 2


def test_bad_arguments_raise():
    w = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="1..4"):
        radix.digit_sort((w,) * 4, 8, digits=w)
    with pytest.raises(TypeError, match="int32"):
        radix.digit_sort((w.to(torch.int64),), 8)
    with pytest.raises(ValueError, match="flat plane"):
        radix.digit_sort((w,), 8, digits=w[:5])
    with pytest.raises(ValueError, match="1..16"):
        radix._check_digit(17, 0, 10)
    with pytest.raises(ValueError, match="shift"):
        radix._check_digit(8, 32, 10)


# ------------------------------------------- the launch path, stood in for


class _DigitLib:
    """Stands in for the built library: ``digit_count`` and
    ``digit_scatter`` apply the kernels' contract through the pointers the
    wrappers pass (CPU memory here), and each scatter pass checks that
    the count gave it its digit's histogram."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _view(ptr: int, words: int) -> torch.Tensor:
        return torch.frombuffer((ctypes.c_int32 * words).from_address(ptr),
                                dtype=torch.int32)

    def digit_count(self, key_p, n, shift, key_bits, bits, low_bits, counts_p,
                    status_p, status_words, _stream):
        nb = 1 << bits
        counts = self._view(counts_p, radix.COUNT_HEAD + 2 * nb)
        counts.zero_()
        if status_p is not None:
            assert status_words >= radix.sweep_status_words(n)
            self._view(status_p, status_words).zero_()
        key = self._view(key_p, n).to(torch.int64) & 0xFFFFFFFF
        d = (key >> shift) & ((1 << key_bits) - 1)
        h = torch.bincount(d[d < nb], minlength=nb).to(torch.int32)
        counts[radix.COUNT_HEAD:radix.COUNT_HEAD + nb] = h
        counts[radix.COUNT_HEAD + nb:] = torch.cumsum(h, 0, dtype=torch.int32) - h
        low = d & ((1 << low_bits) - 1)
        counts[:radix.SWEEP_BINS] = torch.bincount(low, minlength=radix.SWEEP_BINS)
        if key_bits > low_bits:
            counts[radix.SWEEP_BINS:2 * radix.SWEEP_BINS] = torch.bincount(
                d >> low_bits, minlength=radix.SWEEP_BINS)
        self.calls.append(("digit_count", shift, key_bits, bits, low_bits))
        return 0

    def digit_scatter(self, *args):
        ins, outs = args[0:4], args[4:8]
        n_planes, n, widx, shift, bits, k, counts_p, _status, _sw, _stream = args[8:]
        assert bits <= radix.SWEEP_BITS and k in (0, 1)
        planes = [self._view(p, n) for p in ins[:n_planes]]
        key = planes[widx].to(torch.int64) & 0xFFFFFFFF
        d = (key >> shift) & ((1 << bits) - 1)
        hist = self._view(counts_p, 2 * radix.SWEEP_BINS)[k * radix.SWEEP_BINS:
                                                        (k + 1) * radix.SWEEP_BINS]
        assert torch.equal(hist, torch.bincount(d, minlength=radix.SWEEP_BINS)
                           .to(torch.int32)), "the count gave another pass histogram"
        order = torch.sort(d, stable=True).indices
        for p, o in zip(planes, outs[:n_planes]):
            self._view(o, n).copy_(p[order])
        self.calls.append(("digit_scatter", widx, shift, bits, k))
        return 0

    def kernel_error_string(self, code):
        return b"?"


@pytest.fixture
def fake_lib(monkeypatch):
    fake = _DigitLib()
    real_on_card = radix._on_card
    monkeypatch.setattr(radix, "_on_card",
                        lambda words, n, *a, **k: real_on_card(words, n, *a, **k) or True)
    monkeypatch.setattr(radix, "_lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    return fake


@pytest.mark.parametrize("n", [1, 7, 5003])
@pytest.mark.parametrize("kind,bits,shift", [("field", 16, 0), ("field", 16, 16),
                                             ("field", 11, 28), ("field", 8, 8),
                                             ("plane", 16, 0), ("plane", 11, 0),
                                             ("plane", 8, 0)])
def test_launch_path_equals_plain(fake_lib, kind, bits, shift, n):
    """Through ``_build.launch`` with the library stood in for: one count
    launch and one scatter launch a pass of ``sweep_split`` (the digit
    plane's sentinel adds its bit), bytes equal to the plain version."""
    rng = np.random.default_rng(n + bits + shift)
    words = _words(rng, n, 2)
    digits = _digit_plane(rng, n, bits) if kind == "plane" else None
    kw = dict(digits=digits) if digits is not None else dict(w_idx=1, shift=shift)
    base = dict(_build.LAUNCHES)
    got = radix.digit_sort(words, bits, **kw)
    key_bits = bits + 1 if digits is not None else min(bits, 32 - shift)
    split = radix.sweep_split(key_bits)
    assert _build.LAUNCHES["digit_count"] - base["digit_count"] == 1
    assert _build.LAUNCHES["digit_scatter"] - base["digit_scatter"] == len(split)
    assert [c[0] for c in fake_lib.calls] == ["digit_count"] + ["digit_scatter"] * len(split)
    assert fake_lib.calls[0][1:] == ((0 if digits is not None else shift), key_bits, bits,
                                     split[0])
    want = radix.digit_sort_plain(words, bits, **kw)
    assert (got[0] is None) == (want[0] is None)
    if got[0] is not None:
        assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert torch.equal(got[2][0], want[2][0]) and torch.equal(got[2][1], want[2][1])


def test_launch_path_empty_launches_nothing(fake_lib):
    w = torch.zeros(0, dtype=torch.int32)
    base = dict(_build.LAUNCHES)
    sd, sw, (h, lo) = radix.digit_sort((w,), 16, digits=w)
    h2, lo2 = radix.digit_count(w, 0, 16)
    assert sd.numel() == 0 and sw[0].numel() == 0
    assert all(int(t.abs().sum()) == 0 and t.numel() == 1 << 16 for t in (h, lo, h2, lo2))
    assert _build.LAUNCHES == base and fake_lib.calls == []


def _shards(rng, n: int, n_words: int):
    return [tuple(torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.int64)
                                   .astype(np.uint32).view(np.int32))
                  for _ in range(n_words)) for _ in range(P8)]


def _keys(shards):
    keys = np.zeros(sum(s[0].numel() for s in shards), np.uint64)
    for k in range(len(shards[0])):
        w = np.concatenate([s[k].numpy().view(np.uint32) for s in shards])
        keys = (keys << np.uint64(32)) | w.astype(np.uint64)
    return keys


def _old_probe(words, digit_bits, n_ranks):
    """The probe as it was: every shard's first digit sorted, then its
    histogram by binary search."""
    n = words[0][0].numel()
    hs = [kernels.histogram_sorted(torch.sort(kernels.digit_at(w[-1], 0, digit_bits)).values,
                                   1 << digit_bits)[0] for w in words]
    H = coll.all_gather(hs, None)
    mine = [coll.block_send_counts(H[i], n, r) for i, r in enumerate(range(n_ranks))]
    return coll.all_gather(mine, None)[0]


def _old_digit_sort(words, bits, digits=None, w_idx=0, shift=0):
    """The digit sort as it was: ``torch.sort(stable=True)`` of the digit,
    a gather, and ``histogram_sorted`` of the sorted digits."""
    d = digits if digits is not None else kernels.digit_at(words[w_idx], shift, bits)
    sd, order = torch.sort(d, stable=True)
    return sd, tuple(w[order] for w in words), kernels.histogram_sorted(sd, 1 << bits)


@pytest.mark.parametrize("n_words", [1, 2])
@pytest.mark.parametrize("engine", ["lax", "pallas"])
def test_route_one_wrapper_call_a_rank_a_pass(engine, n_words, monkeypatch):
    """One eight-rank radix sort of 16-bit digits (2 passes a word) calls
    ``digit_sort`` once a rank a pass and never ``digit_count``; the probe
    calls ``digit_count`` once a rank.  Their outputs are the parent's:
    the shards and the largest send count of the sort-then-histogram
    route, and its probe's [P, P] counts."""
    rng = np.random.default_rng(24 + n_words)
    shards = _shards(rng, 4096, n_words)
    calls = {"digit_sort": 0, "digit_count": 0}
    for name in calls:
        real = getattr(radix, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(radix, name, spy)
    out, max_cnt = radix_sort.radix_sort_spmd(shards, n_words, 16, P8, 1024,
                                              exchange_engine=engine)
    assert calls == {"digit_sort": P8 * 2 * n_words, "digit_count": 0}
    probe = radix_sort.radix_probe_spmd(shards, 16, P8)
    assert calls == {"digit_sort": P8 * 2 * n_words, "digit_count": P8}
    assert np.array_equal(_keys(out), np.sort(_keys(shards)))
    assert torch.equal(probe, _old_probe(shards, 16, P8))
    monkeypatch.setattr(radix, "digit_sort", _old_digit_sort)
    old_out, old_max = radix_sort.radix_sort_spmd(shards, n_words, 16, P8, 1024,
                                                  exchange_engine=engine)
    assert int(old_max) == int(max_cnt)
    for a, b in zip(out, old_out):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("bits", [8, 16])
def test_eight_rank_radix_launches_through_the_stand_in(fake_lib, bits, monkeypatch):
    """One eight-rank radix sort of one word and its probe through the
    real launch path with the library stood in for: the probe adds one
    count a rank; each pass one count a rank and one scatter a rank a
    sub-pass (16-bit digits: 2 each pass; 8-bit: 1, and the merge pass's
    sentinel bit makes 9, still one).  The answer is exact."""
    rng = np.random.default_rng(bits)
    shards = _shards(rng, 4096, 1)
    base = dict(_build.LAUNCHES)
    radix_sort.radix_probe_spmd(shards, bits, P8)
    out, max_cnt = radix_sort.radix_sort_spmd(shards, 1, bits, P8, 1024,
                                              exchange_engine="pallas")
    passes = 32 // bits
    per_pass = len(radix.sweep_split(bits))
    assert _build.LAUNCHES["digit_count"] - base["digit_count"] == P8 + P8 * passes
    assert _build.LAUNCHES["digit_scatter"] - base["digit_scatter"] == P8 * passes * per_pass
    assert int(max_cnt) <= 1024
    assert np.array_equal(_keys(out), np.sort(_keys(shards)))


# --------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU form)")
    return torch.device("cuda")


def _card_equal(got, want):
    assert (got[0] is None) == (want[0] is None)
    if got[0] is not None:
        assert torch.equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert torch.equal(got[2][0], want[2][0]) and torch.equal(got[2][1], want[2][1])


def _card_words(n: int, n_planes: int, dev, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                               generator=g) for _ in range(n_planes))


def _card_digits(n: int, bits: int, dev, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randint(0, 1 << bits, (n,), dtype=torch.int32, device=dev, generator=g)
    drop = torch.rand(n, device=dev, generator=g) < 0.05
    return torch.where(drop, torch.full_like(d, 1 << bits), d)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n_planes", [("field", 1), ("field", 2), ("plane", 1),
                                           ("plane", 2)])
def test_kernel_matches_plain_at_the_cell_shape(card, kind, n_planes):
    """2^25 keys a rank, 16-bit digits: pass 1's bit field (one word, and
    the low word of two) and the merge pass's digit plane with sentinel
    lanes; the launches move by one count and two scatters."""
    n = 1 << 25
    words = _card_words(n, n_planes, card, seed=n_planes)
    kw = (dict(digits=_card_digits(n, 16, card, seed=7)) if kind == "plane"
          else dict(w_idx=n_planes - 1, shift=0))
    base = dict(_build.LAUNCHES)
    got = radix.digit_sort(words, 16, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["digit_count"] - base["digit_count"] == 1
    assert _build.LAUNCHES["digit_scatter"] - base["digit_scatter"] == 2
    _card_equal(got, radix.digit_sort_plain(words, 16, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 33, radix.TILE - 1, radix.TILE, radix.TILE + 1,
                               3 * radix.TILE + 7, 100_003])
@pytest.mark.parametrize("kind,bits,shift", [("field", 16, 16), ("field", 11, 28),
                                             ("field", 8, 24), ("plane", 16, 0),
                                             ("plane", 11, 0), ("plane", 8, 0)])
def test_kernel_matches_plain_at_tile_edges(card, kind, bits, shift, n):
    words = _card_words(n, 2, card, seed=n + bits)
    kw = (dict(digits=_card_digits(n, bits, card, seed=n)) if kind == "plane"
          else dict(w_idx=0, shift=shift))
    got = radix.digit_sort(words, bits, **kw)
    torch.cuda.synchronize()
    _card_equal(got, radix.digit_sort_plain(words, bits, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("P,cap,n,empty", [(1, 8, 6, ()), (2, 12, 17, ()), (3, 16, 30, (1,)),
                                           (5, 8, 24, (0, 4)), (8, 1028, 4096, (2, 5))])
@pytest.mark.parametrize("shift,bits", [(0, 16), (16, 16), (24, 8), (28, 11)])
def test_kernel_merge_pass_matches_plain_on_the_placement_layouts(card, P, cap, n, empty,
                                                                  shift, bits):
    """The merge pass on receive buffers laid out as ``slot_place``'s
    tests lay them out, a row's count cut below its valid lanes (a
    dropped peer): placement, then the digit sort, kernel against plain."""
    rng = np.random.default_rng(P * 100 + n + shift)
    full = [r for r in range(P) if r not in empty]
    cnt = np.zeros(P, np.int32)
    cuts = np.sort(rng.integers(0, n + 1, len(full) - 1))
    cnt[full] = np.diff(np.concatenate([[0], cuts, [n]]))
    while cnt.max() > cap:
        cuts = np.sort(rng.integers(0, n + 1, len(full) - 1))
        cnt[full] = np.diff(np.concatenate([[0], cuts, [n]]))
    slot = np.full((P, cap), n, np.int32)
    perm = rng.permutation(n).astype(np.int32)
    off = 0
    for r in range(P):
        slot[r, :cnt[r]] = perm[off:off + cnt[r]]
        off += cnt[r]
    planes = tuple(torch.from_numpy(rng.integers(-2**31, 2**31, (P, cap), dtype=np.int64)
                                    .astype(np.int32)).to(card) for _ in range(2))
    cut = torch.from_numpy(cnt).to(card)
    cut[int(np.argmax(cnt))] //= 2
    d, *placed = exchange.slot_place(planes, torch.from_numpy(slot).to(card), n,
                                     digit=(1, shift, bits, cut))
    got = radix.digit_sort(tuple(placed), bits, digits=d)
    torch.cuda.synchronize()
    _card_equal(got, radix.digit_sort_plain(tuple(placed), bits, digits=d))


@pytest.mark.cuda
@pytest.mark.parametrize("keys", ["uniform", "one_value", "two_values"])
@pytest.mark.parametrize("n", [1 << 25, 100_003])
def test_count_matches_histogram_sorted_and_bincount(card, keys, n):
    """The count alone, one launch: equal to the sort-then-histogram and
    to the bincount, also where one bin takes every key (each block's
    16-bit counter hands on 2^15 keys at a time)."""
    (w,) = _card_words(n, 1, card, seed=n)
    if keys == "one_value":
        w = torch.full_like(w, 0x1234ABCD)
    elif keys == "two_values":
        w = torch.where(w < 0, 0x00010002, 0x7FFF0003).to(torch.int32)
    before = _build.launches("digit_count")
    h, lo = radix.digit_count(w, 0, 16)
    torch.cuda.synchronize()
    assert _build.launches("digit_count") == before + 1
    d = kernels.digit_at(w, 0, 16)
    sh, slo = kernels.histogram_sorted(torch.sort(d).values, 1 << 16)
    assert torch.equal(h, sh) and torch.equal(lo, slo)
    assert torch.equal(h, kernels.histogram(d, 1 << 16))


@pytest.mark.cuda
def test_kernel_all_equal_digits_and_all_sentinels(card):
    """Every key in one bin (each tile looks back along one chain, and each
    count block's counter hands on 2^15 keys at a time), and a digit plane
    of sentinels alone (nothing counted, order kept)."""
    n = 1 << 25
    words = _card_words(n, 2, card, seed=5)
    for kw in (dict(digits=torch.full((n,), 777, dtype=torch.int32, device=card)),
               dict(digits=torch.full((n,), 1 << 16, dtype=torch.int32, device=card)),
               dict(w_idx=0, shift=0)):
        ws = (torch.full_like(words[0], 0x5A5A),) + words[1:] if "w_idx" in kw else words
        got = radix.digit_sort(ws, 16, **kw)
        torch.cuda.synchronize()
        _card_equal(got, radix.digit_sort_plain(ws, 16, **kw))


@pytest.mark.cuda
def test_eight_rank_radix_sort_launches_the_digit_kernels(card):
    """One eight-rank radix sort of int32 keys on the card: 8 counts for
    the probe, and for each of the two 16-bit passes 8 counts and 16
    scatters; the answer equals ``torch.sort``."""
    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.parallel.mesh import make_mesh

    g = torch.Generator(device=card).manual_seed(25)
    x = torch.randint(-2**31, 2**31, (1 << 24,), dtype=torch.int32, device=card, generator=g)
    base = dict(_build.LAUNCHES)
    res = mt.sort(x, algorithm="radix", mesh=make_mesh(P8), return_result=True)
    got = torch.cat([s[0] for s in res.shards]) ^ -(2**31)
    assert torch.equal(got, torch.sort(x).values)
    assert _build.LAUNCHES["digit_count"] - base["digit_count"] == P8 + 2 * P8
    assert _build.LAUNCHES["digit_scatter"] - base["digit_scatter"] == 2 * 2 * P8
    assert _build.LAUNCHES["radix_pass"] == base["radix_pass"]
