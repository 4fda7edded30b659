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
    """On a card each planned pass is one kernel call, with the double
    buffers allocated once; the plain version is never called."""
    calls = []
    monkeypatch.setattr(radix, "_on_card", lambda words, n: True)
    monkeypatch.setattr(radix, "_lib", lambda: type(
        "L", (), {"radix_hist_words": staticmethod(lambda n: 256)})())
    monkeypatch.setattr(radix, "_launch",
                        lambda dev, src, dst, *a: calls.append((src, dst, a[1:4])))

    def boom(*a, **k):
        raise AssertionError("plain version ran for a card tensor")

    monkeypatch.setattr(radix, "radix_pass_plain", boom)
    w = (torch.zeros(100, dtype=torch.int32), torch.ones(100, dtype=torch.int32))
    before = radix.pass_launches()
    out = radix.fused_radix_sort(w, diffs=(0x3FF, 0xFFFF))
    plan = radix.pass_plan((0x3FF, 0xFFFF), 2)
    assert [c[2] for c in calls] == list(plan)
    assert radix.pass_launches() - before == len(plan) == 4
    assert calls[0][0] is w                        # first pass reads the input
    assert calls[1][0] is calls[0][1]              # then ping-pongs two buffers
    assert calls[2][1] is calls[0][1] and calls[3][1] is calls[1][1]
    assert out is calls[-1][1]
    with pytest.raises(ValueError, match="digit_bits"):
        radix.fused_radix_sort(w, digit_bits=9)


def test_signature_arity_matches_source():
    """Each ctypes signature names every parameter of its C entry, the
    trailing stream included."""
    src = (Path(_build.CSRC) / "radix.cu").read_text()
    m = re.search(r"int radix_pass\(([^)]*)\)", src)
    assert m is not None
    assert len(radix._SIGNATURES["radix_pass"]) == m.group(1).count(",") + 1


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
