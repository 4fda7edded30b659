"""The fused radix engine (K4) of the port against the reference's Pallas
kernel (``mpitest_tpu/ops/radix_pallas.py``, ``interpret=True``).

* ``pass_plan`` is the reference's on a grid of diffs.
* The plain ``fused_radix_sort`` is byte-equal to the reference at n <=
  2048 over the dtype x input-class grid of ``tests/test_zz_localsort.py``,
  on compacted plans, and on the payload shape of the distributed first
  pass, ``(digit,) + words`` with ``diffs=(255, 0, ...)``, whose word
  planes ride as payload — there the order within one digit is visible
  and must be the stable order.
* ``pass_launches()`` adds one per planned pass.
* The glue of the onesweep kernels: the host mirrors of ``csrc/radix.cu``'s
  tiling constants, the scratch the wrapper allocates, every ctypes
  signature's arity, and the launches of one sort on a card (one
  histogram, one pass kernel a planned pass), with the kernels replaced.

Tolerance: exact bytes.  The CUDA kernel runs only on a card: the
``cuda`` tests hold it against the plain version there and skip here.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpitest_tpu.ops import radix_pallas as ref_rp
from mpitest_tpu.ops.keys import codec_for as ref_codec_for
from mpitest_tpu_torch.ops import _build, radix
from mpitest_tpu_torch.ops.keys import to_device_words, to_host_words


def _t(words):
    return tuple(to_device_words(w, "cpu") for w in words)


def _ref(words, diffs=None):
    out = ref_rp.fused_radix_sort(tuple(jnp.asarray(w) for w in words),
                                  diffs=diffs, interpret=True)
    return [np.asarray(o) for o in out]


def _port(words, diffs=None):
    return [to_host_words(o) for o in radix.fused_radix_sort(_t(words), diffs=diffs)]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint32
        assert g.tobytes() == w.tobytes()


def test_constants_match_reference():
    assert radix.DIGIT_BITS == ref_rp.DIGIT_BITS
    assert radix.FUSED_MAX_ELEMS == ref_rp.FUSED_MAX_ELEMS
    assert radix.FUSED_MAX_WORDS == ref_rp.FUSED_MAX_WORDS


_DIFF_GRID = [None, (0,), (1,), (0xFF,), (0x100,), (0xFFFFF,), (0xFFFFFFFF,),
              (0, 0), (0, 0xFFFFF), (0x3, 0xFFFFFFFF), (0xFFFFFFFF, 0),
              (0xFFFFFFFF, 0xFFFFFFFF), (255, 0, 0), (1, 2, 3, 0x80000000)]


@pytest.mark.parametrize("digit_bits", [8, 5, 16])
def test_pass_plan_matches_reference(digit_bits):
    for diffs in _DIFF_GRID:
        for n_words in ((1, 2, 4) if diffs is None else (len(diffs),)):
            assert (radix.pass_plan(diffs, n_words, digit_bits)
                    == ref_rp.pass_plan(diffs, n_words, digit_bits)), diffs
    with pytest.raises(ValueError, match="diffs"):
        radix.pass_plan((1,), 2)


@pytest.mark.parametrize("dtype", [np.int32, np.uint64, np.float32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("kind,n", [("uniform", 2048), ("dup", 2048),
                                    ("sorted", 2048), ("tiny", 5),
                                    ("nondiv", 1537)])
def test_plain_matches_reference_grid(dtype, kind, n):
    """The dtype x input-class grid of the reference's own kernel test."""
    rng = np.random.default_rng(1234 + n)
    if np.dtype(dtype).kind == "f":
        x = rng.normal(size=n).astype(dtype)
    else:
        info = np.iinfo(dtype)
        hi = 5 if kind == "dup" else info.max
        x = rng.integers(info.min if kind != "dup" else 0, hi,
                         size=n, dtype=dtype, endpoint=True)
    if kind == "sorted":
        x = np.sort(x)
    words = ref_codec_for(dtype).encode(x)
    _equal(_port(words), _ref(words))
    order = np.lexsort(tuple(reversed(words)))
    _equal(_port(words), [w[order] for w in words])


@pytest.mark.parametrize("seed", [0, 1])
def test_compacted_plan_matches_reference(seed):
    """Range-narrow words: the compacted plan sorts identically in fewer
    passes, and the launch counter adds exactly one per planned pass."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 20, size=2048, dtype=np.int64)
    words = ref_codec_for(np.int64).encode(x)
    diffs = tuple(int(w.max()) - int(w.min()) for w in words)
    plan = radix.pass_plan(diffs, 2)
    assert len(plan) == 3 < len(radix.pass_plan(None, 2))
    before = radix.pass_launches()
    got = _port(words, diffs)
    assert radix.pass_launches() - before == len(plan)
    _equal(got, _ref(words, diffs))


@pytest.mark.parametrize("n_payload", [1, 2, 3])
def test_payload_shape_is_stable(n_payload):
    """``(digit,) + words`` with ``diffs=(255, 0, ...)``: one pass on the
    digit, the words are payload; with ~8 keys per digit and equal digits
    among them, only a stable pass gives the reference's bytes."""
    rng = np.random.default_rng(7 + n_payload)
    n = 2000
    digit = rng.integers(0, 256, n).astype(np.uint32)
    payload = [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
               for _ in range(n_payload)]
    words = [digit] + payload
    diffs = (255,) + (0,) * n_payload
    assert radix.pass_plan(diffs, len(words)) == ((0, 0, 8),)
    got = _port(words, diffs)
    _equal(got, _ref(words, diffs))
    order = np.argsort(digit, kind="stable")
    _equal(got, [w[order] for w in words])


def test_four_words_and_top_digit_narrow():
    rng = np.random.default_rng(3)
    n = 1500
    words = [rng.integers(0, 8, n).astype(np.uint32),
             rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
             rng.integers(0, 1 << 11, n).astype(np.uint32),
             rng.integers(0, 3, n).astype(np.uint32)]
    diffs = (7, 0xFFFFFFFF, (1 << 11) - 1, 3)
    plan = radix.pass_plan(diffs, 4)
    assert [b for _, _, b in plan] == [2, 8, 3, 8, 8, 8, 8, 3]
    _equal(_port(words, diffs), _ref(words, diffs))
    _equal(_port(words), _ref(words))


def test_empty_plan_and_tiny_inputs_return_input():
    """n <= 1 or an all-zero plan: the input words come back unchanged and
    no pass runs (the reference's early return)."""
    w = (torch.tensor([5, 3, 9], dtype=torch.int32),)
    before = radix.pass_launches()
    assert radix.fused_radix_sort(w, diffs=(0,))[0] is w[0]
    one = (torch.tensor([7], dtype=torch.int32),)
    assert radix.fused_radix_sort(one)[0] is one[0]
    empty = (torch.empty(0, dtype=torch.int32),)
    assert radix.fused_radix_sort(empty)[0] is empty[0]
    assert radix.pass_launches() == before


def test_plain_pass_takes_the_digit_unsigned():
    """Words with the top bit set: an arithmetic shift would sign-extend
    into a wide digit; the pass takes bits [shift, shift+bits) unsigned."""
    w = to_device_words(np.array([0xF0000001, 0x00000002, 0x80000000,
                                  0x7FFFFFFF], np.uint32), "cpu")
    (out,) = radix.radix_pass_plain((w,), 0, 28, 4)
    assert to_host_words(out).tolist() == [0x00000002, 0x7FFFFFFF,
                                           0x80000000, 0xF0000001]


# ------------------------------------------------------------ wrappers


def test_wrapper_checks_arguments():
    x = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(TypeError):
        radix.fused_radix_sort((x.to(torch.int64),))
    with pytest.raises(ValueError, match="flat plane"):
        radix.fused_radix_sort((x, x[:32]))
    with pytest.raises(ValueError, match="contiguous"):
        radix.fused_radix_sort((torch.zeros(128, dtype=torch.int32)[::2],))
    with pytest.raises(ValueError, match="word planes"):
        radix.fused_radix_sort((x,) * 5, diffs=(1,) * 5)
    with pytest.raises(ValueError, match="unsupported device"):
        radix.fused_radix_sort((torch.zeros(64, dtype=torch.int32, device="meta"),))


def test_card_tensor_launches_kernel_never_plain(monkeypatch):
    """On a card each planned pass is one kernel call, after one histogram
    call over the input, with the double buffers and the scratch
    allocated once; the plain version is never called."""
    calls, hists = [], []
    monkeypatch.setattr(radix, "_on_card", lambda words, n: True)
    monkeypatch.setattr(radix, "_launch_histogram",
                        lambda dev, src, n, plan, scratch: hists.append((src, plan, scratch)))
    monkeypatch.setattr(radix, "_launch",
                        lambda dev, src, dst, *a: calls.append((src, dst, a[1:4], a[4:])))

    def boom(*a, **k):
        raise AssertionError("plain version ran for a card tensor")

    monkeypatch.setattr(radix, "radix_pass_plain", boom)
    w = (torch.zeros(100, dtype=torch.int32), torch.ones(100, dtype=torch.int32))
    before = radix.pass_launches()
    out = radix.fused_radix_sort(w, diffs=(0x3FF, 0xFFFF))
    plan = radix.pass_plan((0x3FF, 0xFFFF), 2)
    assert [c[2] for c in calls] == list(plan)
    assert radix.pass_launches() - before == len(plan) == 4
    assert len(hists) == 1 and hists[0][0] is w and hists[0][1] == plan
    scratch = hists[0][2]
    assert [c[3] for c in calls] == [(k, scratch) for k in range(4)]
    assert calls[0][0] is w                        # first pass reads the input
    assert calls[1][0] is calls[0][1]              # then ping-pongs two buffers
    assert calls[2][1] is calls[0][1] and calls[3][1] is calls[1][1]
    assert out is calls[-1][1]
    with pytest.raises(ValueError, match="digit_bits"):
        radix.fused_radix_sort(w, digit_bits=9)


def test_signature_arity_matches_source():
    """Each ctypes signature names every parameter of its C entry, the
    trailing stream included, and every C entry has a signature."""
    src = (Path(_build.CSRC) / "radix.cu").read_text()
    entries = re.findall(r"^int (\w+)\(([^)]*)\)", src, re.M)
    assert sorted(e for e, _ in entries) == sorted(radix._SIGNATURES) == [
        "radix_histogram", "radix_pass"]
    for entry, params in entries:
        assert len(radix._SIGNATURES[entry]) == params.count(",") + 1, entry
        assert "stream" in params.split(",")[-1], entry


def _constants(name):
    src = (Path(_build.CSRC) / name).read_text()
    return {k: v for k, v in re.findall(r"constexpr int (k\w+) = ([^;]+);", src)}


def test_tile_constants_match_source():
    """The host mirrors of csrc/radix.cu's tiling (threads, keys a lane,
    bins, passes) are the kernel's own numbers."""
    c = _constants("radix.cu")
    assert int(c["kThreads"]) == radix.TILE_THREADS == 512
    assert int(c["kItems"]) == radix.TILE_ITEMS
    assert c["kTile"] == "kWarps * kWarpSpan"
    assert c["kWarpSpan"] == "32 * kItems" and c["kWarps"] == "kThreads / 32"
    assert radix.TILE == int(c["kThreads"]) * int(c["kItems"]) == 8192
    assert c["kBins"] == "1 << kMaxBits"
    assert radix.STATUS_BINS == 1 << int(c["kMaxBits"]) == 256
    assert int(c["kMaxPasses"]) == radix.MAX_PASSES
    # the longest plan the wrapper can make (4 words of 1-bit digits) fits
    assert len(radix.pass_plan(None, radix.FUSED_MAX_WORDS, 1)) == radix.MAX_PASSES


@pytest.mark.parametrize("n,passes,tiles", [(1, 1, 1), (8191, 4, 1), (8192, 4, 1),
                                            (8193, 4, 2), (6144, 4, 1),
                                            (1 << 20, 3, 128), (1 << 28, 4, 32768),
                                            ((1 << 31) - 1, 16, 262144)])
def test_scratch_words(n, passes, tiles):
    """One 64-bit status word per tile and bin, 128 tile counters, one
    256-bin histogram per pass (the layout the C entries check)."""
    assert radix.tiles(n) == tiles
    assert radix.status_words(n) == tiles * 256 * 2
    assert radix.scratch_words(n, passes) == tiles * 512 + 128 + passes * 256
    src = (Path(_build.CSRC) / "radix.cu").read_text()
    assert "return tiles_for(n) * kBins * 2;" in src
    assert ("return status_words(n) + kMaxPasses + "
            "static_cast<long long>(n_passes) * kBins;") in src


def test_wrapper_allocates_the_scratch_it_passes(monkeypatch):
    """The scratch handed to the histogram and every pass is one int32
    buffer of scratch_words(n, passes) words."""
    seen = []
    monkeypatch.setattr(radix, "_on_card", lambda words, n: True)
    monkeypatch.setattr(radix, "_launch_histogram",
                        lambda dev, src, n, plan, scratch: seen.append(scratch))
    monkeypatch.setattr(radix, "_launch", lambda dev, src, dst, *a: seen.append(a[-1]))
    n = 3 * radix.TILE + 17
    w = (torch.zeros(n, dtype=torch.int32),) * 3
    radix.fused_radix_sort(w, diffs=(0xFFF, 0, 0xFF))
    assert len(seen) == 1 + 3
    assert all(s is seen[0] for s in seen)
    assert seen[0].dtype == torch.int32
    assert seen[0].numel() == radix.scratch_words(n, 3) == 4 * 512 + 128 + 3 * 256


class _FakeKernels:
    """Stands in for the built library: every entry succeeds and records
    its arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name == "kernel_error_string":
            return lambda code: b"?"
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("diffs,passes", [(None, 4), ((0xFFFFF,), 3), ((0x3,), 1)])
def test_one_sort_counts_one_histogram_and_a_launch_a_pass(diffs, passes, monkeypatch):
    """Through the real launch path (``_build.launch``) with the library
    replaced: one sort adds 1 to LAUNCHES["radix_histogram"] and one a
    planned pass to LAUNCHES["radix_pass"]; the passes get pass indices
    0.. in plan order and the histogram gets the whole plan."""
    fake = _FakeKernels()
    monkeypatch.setattr(radix, "_on_card", lambda words, n: True)
    monkeypatch.setattr(radix, "_lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    x = (torch.arange(5000, dtype=torch.int32),)
    base = dict(_build.LAUNCHES)
    radix.fused_radix_sort(x, diffs=diffs)
    assert _build.LAUNCHES["radix_histogram"] - base["radix_histogram"] == 1
    assert _build.LAUNCHES["radix_pass"] - base["radix_pass"] == passes
    names = [c[0] for c in fake.calls]
    assert names == ["radix_histogram"] + ["radix_pass"] * passes
    hist = fake.calls[0][1]
    plan = radix.pass_plan(diffs, 1)
    assert list(hist[6]) == [v for p in plan for v in p]     # the plan triples
    assert hist[7] == passes and hist[9] == radix.scratch_words(5000, passes)
    for k, (_, args) in enumerate(fake.calls[1:]):
        assert args[10:14] == plan[k] + (k,)


def test_launch_failure_raises_and_does_not_count(monkeypatch):
    class FakeLib:
        @staticmethod
        def radix_pass(*args):
            return 1

        @staticmethod
        def kernel_error_string(code):
            return b"invalid argument"

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    before = _build.launches("radix_pass")
    with pytest.raises(RuntimeError, match="invalid argument"):
        _build.launch(FakeLib(), "radix_pass", torch.device("cpu"), 0)
    assert _build.launches("radix_pass") == before


# --------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU form)")
    return torch.device("cuda")


def _plain(ws, diffs=None):
    planes = ws
    for widx, shift, bits in radix.pass_plan(diffs, len(ws)):
        planes = radix.radix_pass_plain(planes, widx, shift, bits)
    return planes


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_planes", [(1, 1), (2, 2), (8191, 1), (8193, 2),
                                        (100_000, 4), (1 << 20, 3)])
def test_k4_kernel_matches_plain(card, n, n_planes):
    rng = np.random.default_rng(n + n_planes)
    ws = tuple(to_device_words(rng.integers(0, 2**32, n, dtype=np.uint64)
                               .astype(np.uint32), card) for _ in range(n_planes))
    got = radix.fused_radix_sort(ws)
    want = _plain(ws)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_k4_kernel_payload_shape_matches_plain(card):
    rng = np.random.default_rng(5)
    n = 1 << 18
    ws = (to_device_words(rng.integers(0, 256, n).astype(np.uint32), card),
          to_device_words(rng.integers(0, 2**32, n, dtype=np.uint64)
                          .astype(np.uint32), card),
          to_device_words(np.arange(n, dtype=np.uint32), card))
    got = radix.fused_radix_sort(ws, diffs=(255, 0, 0))
    want = _plain(ws, (255, 0, 0))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _card_words(rng, n, card, high=2**32):
    return to_device_words(rng.integers(0, high, n, dtype=np.uint64).astype(np.uint32), card)


def _k4_equal(card, ws, diffs=None):
    """One K4 sort on the card: byte-equal to the plain passes, with one
    histogram launch and one pass launch a planned pass (none for n = 1,
    which is sorted as given)."""
    base = dict(_build.LAUNCHES)
    got = radix.fused_radix_sort(ws, diffs=diffs)
    torch.cuda.synchronize()
    passes = len(radix.pass_plan(diffs, len(ws))) if ws[0].numel() > 1 else 0
    assert _build.LAUNCHES["radix_histogram"] - base["radix_histogram"] == int(passes > 0)
    assert _build.LAUNCHES["radix_pass"] - base["radix_pass"] == passes
    want = _plain(ws, diffs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_k4_onesweep_all_equal_keys(card):
    """2^24 equal keys: every pass puts every key in one bin, so every tile
    looks back on that bin's chain."""
    _k4_equal(card, (torch.full((1 << 24,), 0x5A5A5A5A, dtype=torch.int32, device=card),))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "reversed"])
def test_k4_onesweep_sorted_and_reversed(card, order):
    rng = np.random.default_rng(11)
    x = np.sort(rng.integers(0, 2**32, 1 << 22, dtype=np.uint64).astype(np.uint32))
    if order == "reversed":
        x = x[::-1].copy()
    _k4_equal(card, (to_device_words(x, card), _card_words(rng, x.size, card)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", list(range(1, 34)) + [radix.TILE - 1, radix.TILE,
                                                    radix.TILE + 1, 3 * radix.TILE + 7])
def test_k4_onesweep_tile_edges(card, n):
    rng = np.random.default_rng(n)
    _k4_equal(card, tuple(_card_words(rng, n, card) for _ in range(2)))


@pytest.mark.cuda
@pytest.mark.parametrize("top_bits", range(1, 8))
def test_k4_onesweep_four_planes_narrow_top_digit(card, top_bits):
    """Four planes whose plans end in a digit of 1-7 bits (fewer bins
    than the status row holds)."""
    rng = np.random.default_rng(40 + top_bits)
    n = (1 << 20) + 333
    top = (1 << top_bits) - 1
    ws = (_card_words(rng, n, card, top + 1), _card_words(rng, n, card),
          _card_words(rng, n, card, 1 << 12), _card_words(rng, n, card))
    _k4_equal(card, ws, (top, 0xFFFFFFFF, 0xFFF, 0xFFFFFFFF))


@pytest.mark.cuda
def test_k4_onesweep_single_pass_three_payload_planes(card):
    """The distributed radix's pass 1: one 8-bit pass on the digit plane,
    three word planes riding as payload in stable order."""
    rng = np.random.default_rng(9)
    n = 1 << 22
    ws = (_card_words(rng, n, card, 256),) + tuple(_card_words(rng, n, card) for _ in range(3))
    _k4_equal(card, ws, (255, 0, 0, 0))
