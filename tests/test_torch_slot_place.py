"""``slot_place`` (``ops/exchange.py``, ``csrc/exchange.cu``) and the radix
sort's merges built on it (``models/radix_sort.py``).

On the CPU the wrapper runs its plain version.  It is held against what
it replaces: the sort by slot then a gather, on ragged layouts of 1-8
rows and 1-4 planes; and, with the digit plane, the merge pass (placement
then the stable digit sort) against the one sort keyed on ``(digit,
slot)`` over the whole receive buffer, on the exchanges of eight-rank
sorts under both exchange engines, clean, overflowed, and with a peer's
count dropped.  A stand-in library applies the plain version through the
pointers the wrapper passes, so the launches of one eight-rank sort are
counted.  The ``cuda`` tests hold the kernel against the plain version
on a card and skip here.  Tolerance: exact bytes.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from mpitest_tpu_torch.models import radix_sort
from mpitest_tpu_torch.ops import _build, exchange, kernels, radix

P8 = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layout(rng, P: int, cap: int, n: int, empty: tuple[int, ...], n_planes: int,
            device="cpu"):
    """Receive planes ``[P, cap]`` whose first ``cnt[r]`` lanes of row r
    carry the slots of a random permutation of ``[0, n)`` and the others
    the slot n; rows in ``empty`` receive nothing."""
    full = [r for r in range(P) if r not in empty]
    cnt = np.zeros(P, np.int32)
    while full:                                   # deal until every row fits
        cuts = np.sort(rng.integers(0, n + 1, len(full) - 1))
        cnt[full] = np.diff(np.concatenate([[0], cuts, [n]]))
        if cnt.max() <= cap:
            break
    slot = np.full((P, cap), n, np.int32)
    perm = rng.permutation(n).astype(np.int32)
    planes = rng.integers(-2**31, 2**31, (n_planes, P, cap), dtype=np.int64).astype(np.int32)
    off = 0
    for r in range(P):
        slot[r, :cnt[r]] = perm[off:off + cnt[r]]
        planes[:, r, cnt[r]:] = 0                 # the exchange's fill past a count
        off += cnt[r]
    return (tuple(torch.from_numpy(p).to(device) for p in planes),
            torch.from_numpy(slot).to(device), torch.from_numpy(cnt).to(device))


def _sort_by_slot(planes, slot, n):
    """The final merge as the reference makes it: a sort by slot, a gather."""
    order = torch.sort(slot.reshape(-1), stable=True).indices[:n]
    return tuple(p.reshape(-1)[order] for p in planes)


def _sort_merge(recv, recv_cnt, slot, w_idx, shift, digit_bits, n):
    """The merge pass as the reference makes it: one sort keyed on
    ``(digit, slot)`` over the whole receive buffer, lanes past their
    row's count carrying the digit ``2^bits``."""
    cap = slot.shape[1]
    d = kernels.digit_at(recv[w_idx], shift, digit_bits)
    c = torch.arange(cap, dtype=torch.int32, device=d.device)[None, :]
    d = torch.where(c < recv_cnt[:, None], d,
                    torch.full((), 1 << digit_bits, dtype=torch.int32, device=d.device))
    key = (d.to(torch.int64) << 32) | slot.to(torch.int64)
    ks, order = torch.sort(key.reshape(-1))
    order = order[:n]
    return (ks[:n] >> 32).to(torch.int32), tuple(r.reshape(-1)[order] for r in recv)


LAYOUTS = [(1, 8, 6, ()), (2, 12, 17, ()), (3, 16, 30, (1,)), (5, 8, 24, (0, 4)),
           (8, 1028, 4096, (2, 5)), (8, 4, 0, tuple(range(8)))]


@pytest.mark.parametrize("n_planes", [1, 2, 3, 4])
@pytest.mark.parametrize("P,cap,n,empty", LAYOUTS)
def test_plain_equals_the_sort_by_slot(P, cap, n, empty, n_planes):
    rng = np.random.default_rng(P * 1000 + cap + n_planes)
    planes, slot, _ = _layout(rng, P, cap, n, empty, n_planes)
    got = exchange.slot_place(planes, slot, n)
    want = _sort_by_slot(planes, slot, n)
    assert len(got) == n_planes
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (n,)
        assert torch.equal(g, w)


@pytest.mark.parametrize("P,cap,n,empty", LAYOUTS[:5])
@pytest.mark.parametrize("shift,bits", [(0, 16), (16, 16), (24, 8), (28, 11)])
def test_digit_plane_then_stable_sort_equals_the_sort_on_digit_and_slot(
        P, cap, n, empty, shift, bits):
    """With the digit plane, and a row's count cut below its valid lanes
    (a dropped peer): placement then the stable digit sort is the sort on
    ``(digit, slot)``, digits and words."""
    rng = np.random.default_rng(n + shift)
    planes, slot, cnt = _layout(rng, P, cap, n, empty, 2)
    cut = cnt.clone()
    cut[int(np.argmax(cnt.numpy()))] //= 2
    for counts in (cnt, cut):
        d, *placed = exchange.slot_place(planes, slot, n, digit=(1, shift, bits, counts))
        sd, words = radix_sort._digit_sort(d, tuple(placed))
        want_d, want_w = _sort_merge(planes, counts, slot, 1, shift, bits, n)
        assert torch.equal(sd, want_d)
        assert all(torch.equal(a, b) for a, b in zip(words, want_w))


def test_unfilled_slots_read_the_fill_and_sort_last():
    """An overflowed exchange leaves slots unfilled: their words read 0
    and their digit ``2^bits``, as the padding lanes of the sort on
    ``(digit, slot)`` do."""
    rng = np.random.default_rng(5)
    planes, slot, cnt = _layout(rng, 4, 64, 200, (), 1)
    lost = int(cnt[1])
    slot[1], planes[0][1], cnt[1] = 200, 0, 0      # row 1's lanes never arrived
    d, w = exchange.slot_place(planes, slot, 200, digit=(0, 0, 8, cnt))
    holes = torch.ones(200, dtype=torch.bool)
    holes[slot[slot < 200].long()] = False
    assert int(holes.sum()) == lost > 0
    assert torch.all(d[holes] == 256) and torch.all(w[holes] == 0)
    sd, words = radix_sort._digit_sort(d, (w,))
    want_d, want_w = _sort_merge(planes, cnt, slot, 0, 0, 8, 200)
    assert torch.equal(sd, want_d) and torch.equal(words[0], want_w[0])


def test_bad_arguments_raise():
    rng = np.random.default_rng(1)
    planes, slot, cnt = _layout(rng, 2, 8, 10, (), 1)
    with pytest.raises(ValueError, match="1..4 planes"):
        exchange.slot_place(planes * 5, slot, 10)
    with pytest.raises(ValueError, match="of one shape"):
        exchange.slot_place((planes[0][:1],), slot, 10)
    with pytest.raises(ValueError, match=r"\[8, cap\]"):
        exchange.slot_place(planes, slot[0], 10)
    with pytest.raises(ValueError, match="multiple of 4"):
        exchange.slot_place((planes[0][:, :6].contiguous(),), slot[:, :6].contiguous(), 10)
    with pytest.raises(ValueError, match="contiguous int32"):
        exchange.slot_place((planes[0].to(torch.int64),), slot, 10)
    with pytest.raises(ValueError, match="out of range"):
        exchange.slot_place(planes, slot, 10, digit=(1, 0, 16, cnt))
    with pytest.raises(ValueError, match="recv_cnt"):
        exchange.slot_place(planes, slot, 10, digit=(0, 0, 16, cnt.to(torch.int64)))


def _shards(rng, n: int, n_words: int):
    return [tuple(torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.int64)
                                   .astype(np.uint32).view(np.int32))
                  for _ in range(n_words)) for _ in range(P8)]


def _keys(shards):
    """Every rank's words as unsigned keys (``words[0]`` most
    significant), in rank order."""
    keys = np.zeros(sum(s[0].numel() for s in shards), np.uint64)
    for k in range(len(shards[0])):
        w = np.concatenate([s[k].numpy().view(np.uint32) for s in shards])
        keys = (keys << np.uint64(32)) | w.astype(np.uint64)
    return keys


@pytest.mark.parametrize("n_words", [1, 2])
@pytest.mark.parametrize("scenario", ["clean", "overflow", "drop"])
@pytest.mark.parametrize("engine", ["lax", "pallas"])
def test_merge_passes_equal_the_sort_on_digit_and_slot(engine, scenario, n_words,
                                                       monkeypatch):
    """Every merge of an eight-rank radix sort (2 passes of one word, 4 of
    two) gives the digits and words of the sort on ``(digit, slot)``, on
    the exchange as it came (clean; overflowed past a small cap) and with
    peer 0's count dropped after the slots were computed (the pallas
    engine's ``exchange_drop``).  After a short merge the ``lax`` engine's
    next exchange also sends the lanes past the histogram, as the
    reference's does, so the merge after it meets colliding slots and its
    order rests on a sort's tie rule; that dispatch is discarded (an
    overflow) or fails its check (a drop) either way, so under ``lax``
    only the merges of the first exchange are held there."""
    n = 8192 if scenario == "overflow" else 4096
    cap = 1024
    rng = np.random.default_rng({"clean": 1, "overflow": 2, "drop": 3}[scenario] + n_words)
    shards = _shards(rng, n, n_words)
    merges = []
    real = radix_sort._merge_pass

    def both(recv, recv_cnt, slot, w_idx, shift, digit_bits, n_):
        if scenario == "drop":
            recv_cnt = recv_cnt.clone()
            recv_cnt[0] = 0
        got = real(recv, recv_cnt, slot, w_idx, shift, digit_bits, n_)
        if engine == "pallas" or scenario == "clean" or len(merges) < P8:
            want = _sort_merge(recv, recv_cnt, slot, w_idx, shift, digit_bits, n_)
            assert torch.equal(got[0], want[0])
            assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
        merges.append(w_idx)
        return got

    monkeypatch.setattr(radix_sort, "_merge_pass", both)
    out, max_cnt = radix_sort.radix_sort_spmd(shards, n_words, 16, P8, cap,
                                              exchange_engine=engine)
    assert len(merges) == P8 * (2 * n_words - 1)
    if scenario == "overflow":
        assert int(max_cnt) > cap
    if scenario == "clean":
        assert int(max_cnt) <= cap
        assert np.array_equal(_keys(out), np.sort(_keys(shards)))


class _PlaceLib:
    """Stands in for the built library: ``slot_place`` applies the plain
    version through the pointers the wrapper passes (CPU memory here), as
    the kernel does on the card, and records the call."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _view(ptr: int, words: int) -> torch.Tensor:
        return torch.frombuffer((ctypes.c_int32 * words).from_address(ptr),
                                dtype=torch.int32)

    def slot_place(self, *args):
        ins, outs = args[0:4], args[4:8]
        (n_planes, slot_p, n, P, cap, d_out, d_plane, d_shift, d_bits, cnts_p,
         _stream) = args[8:]
        planes = tuple(self._view(p, P * cap).view(P, cap) for p in ins[:n_planes])
        slot = self._view(slot_p, P * cap).view(P, cap)
        digit = None if d_out is None else (d_plane, d_shift, d_bits,
                                            self._view(cnts_p, P))
        dst = ([] if d_out is None else [d_out]) + list(outs[:n_planes])
        for o, ptr in zip(exchange.slot_place_plain(planes, slot, n, digit), dst):
            self._view(ptr, n).copy_(o)
        self.calls.append(digit is not None)
        return 0

    def kernel_error_string(self, code):
        return b"?"


@pytest.mark.parametrize("engine", ["lax", "pallas"])
@pytest.mark.parametrize("local_engine", ["lax", "radix_pallas"])
def test_eight_rank_radix_launches_sixteen_placements(local_engine, engine, monkeypatch):
    """One eight-rank radix sort of two 16-bit passes, through the real
    launch path with the library replaced: 8 merge-pass placements (with
    the digit plane) and 8 final ones add exactly 16 to
    ``LAUNCHES["slot_place"]``; nothing reaches ``radix_pass``, and under
    ``radix_pallas`` K4 runs pass 1 only (its planned passes a rank)."""
    fake = _PlaceLib()
    real_check = exchange._check_place_args
    monkeypatch.setattr(exchange, "_check_place_args",
                        lambda *a: real_check(*a) or True)
    monkeypatch.setattr(exchange, "lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    rng = np.random.default_rng(22)
    shards = _shards(rng, 4096, 1)
    base = dict(_build.LAUNCHES)
    k4_before = radix.pass_launches()
    out, max_cnt = radix_sort.radix_sort_spmd(shards, 1, 16, P8, 1024,
                                              exchange_engine=engine,
                                              local_engine=local_engine)
    assert _build.LAUNCHES["slot_place"] - base["slot_place"] == 16
    assert fake.calls == [True] * P8 + [False] * P8
    assert _build.LAUNCHES["radix_pass"] == base["radix_pass"]
    k4 = len(radix.pass_plan(((1 << 16) - 1, 0), 2)) if local_engine == "radix_pallas" else 0
    assert radix.pass_launches() - k4_before == P8 * k4
    assert int(max_cnt) <= 1024
    assert np.array_equal(_keys(out), np.sort(_keys(shards)))


# --------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU form)")
    return torch.device("cuda")


def _runs_layout(P: int, cap: int, n: int, n_planes: int, dev, seed: int):
    """A receive buffer shaped as the radix exchange leaves it: row r
    holds ``n // P`` lanes (the last row the rest) cut into digit runs,
    each run a block of consecutive slots at a random place in ``[0, n)``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = n // P
    cnt = torch.full((P,), base, dtype=torch.int32, device=dev)
    cnt[-1] = n - base * (P - 1)
    runs = 4096
    # n lanes in `runs` blocks of consecutive slots, the blocks shuffled
    bounds = torch.linspace(0, n, runs + 1, dtype=torch.float64, device=dev).round().long()
    order = torch.randperm(runs, device=dev, generator=g)
    lens = bounds[1:] - bounds[:-1]
    starts = bounds[:-1][order]
    lens = lens[order]
    slots = torch.repeat_interleave(starts - torch.cumsum(lens, 0) + lens, lens) + \
        torch.arange(n, device=dev)
    slot = torch.full((P, cap), n, dtype=torch.int32, device=dev)
    off = 0
    for r in range(P):
        c = int(cnt[r])
        slot[r, :c] = slots[off:off + c].to(torch.int32)
        off += c
    planes = tuple(torch.randint(-2**31, 2**31, (P, cap), dtype=torch.int32, device=dev,
                                 generator=g) for _ in range(n_planes))
    return planes, slot, cnt


@pytest.mark.cuda
@pytest.mark.parametrize("P,cap,n,n_planes,digit", [
    (8, 8389632, 1 << 25, 1, None),
    (8, 8389632, 1 << 25, 1, (0, 16, 16)),
    (8, 4196352, 1 << 24, 2, (1, 0, 16)),
    (3, 4, 10, 1, None), (3, 4, 10, 4, (3, 28, 16)), (5, 1028, 3000, 2, (0, 8, 8)),
    (8, 4, 0, 4, (0, 0, 16)), (1, 4096, 4096, 3, None)])
def test_kernel_matches_plain(card, P, cap, n, n_planes, digit):
    planes, slot, cnt = _runs_layout(P, cap, n, n_planes, card, seed=P + n_planes + n)
    if n:
        cnt[P // 2] = max(0, int(cnt[P // 2]) - 3)   # lanes past a count
    dg = None if digit is None else (*digit, cnt)
    before = _build.launches("slot_place")
    got = exchange.slot_place(planes, slot, n, dg)
    torch.cuda.synchronize()
    assert _build.launches("slot_place") == before + 1
    want = exchange.slot_place_plain(planes, slot, n, dg)
    assert len(got) == len(want) == n_planes + (digit is not None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernel_all_lanes_invalid_writes_nothing(card):
    planes, slot, cnt = _runs_layout(4, 1024, 2048, 2, card, seed=3)
    slot.fill_(2048)
    d, *words = exchange.slot_place(planes, slot, 2048, (0, 0, 16, cnt))
    torch.cuda.synchronize()
    assert torch.all(d == 1 << 16) and all(torch.all(w == 0) for w in words)


@pytest.mark.cuda
def test_kernel_refuses_a_misaligned_plane(card):
    planes, slot, _ = _runs_layout(2, 1024, 1024, 1, card, seed=4)
    buf = torch.zeros(2 * 1024 + 1, dtype=torch.int32, device=card)
    shifted = buf[1:].view(2, 1024)
    with pytest.raises(_build.KernelLaunchError, match="invalid argument"):
        exchange.slot_place((shifted,), slot, 1024)


@pytest.mark.cuda
def test_overflowed_exchange_regrows_to_an_exact_verified_answer(card):
    """``cap_squeeze`` collapses the first cap: the first dispatch
    overflows, leaves slots unfilled and is discarded; the regrown one
    gives the exact answer, verified, with 16 placements a dispatch."""
    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch import faults
    from mpitest_tpu_torch.parallel.mesh import make_mesh
    from mpitest_tpu_torch.utils.trace import Tracer

    x = np.random.default_rng(22).integers(-2**31, 2**31 - 1, 1 << 20, dtype=np.int32)
    tr = Tracer()
    before = _build.launches("slot_place")
    faults.install(faults.FaultRegistry("cap_squeeze", seed=1))
    try:
        res = mt.sort(torch.from_numpy(x).to(card), algorithm="radix",
                      mesh=make_mesh(P8), tracer=tr, return_result=True,
                      exchange_engine="pallas")
    finally:
        faults.install(None)
    assert np.array_equal(res.to_numpy(), np.sort(x))
    assert tr.counters["exchange_retries"] >= 1
    assert tr.counters.get("verify_failures") is None
    assert _build.launches("slot_place") - before == \
        16 * (tr.counters["exchange_retries"] + 1)
