"""The bitonic engine's plain PyTorch versions against the reference
Pallas kernels (``interpret=True``), and the wrappers' dispatch rules.

* K1 ``sort_padded_plain`` matches ``bitonic.sort_padded`` byte for byte.
* K2 ``sort_pairs_padded_plain`` matches ``bitonic.sort_pairs_padded`` on
  the key plane, the (key, payload) multiset per equal-key run, and —
  because both run the same logical network with the same tie rule — on
  the payload bytes too.
* K3 ``fix_runs_pairs_plain`` + ``_fix_boundary`` match
  ``bitonic.fix_runs_pairs`` + ``kernels._fix_boundary`` on the lo bytes
  and the residual flag; so does phase B's plain composition
  (``fix_runs_flag`` on the CPU), over planted runs of up to 40 and 0..17
  passes.

The CUDA kernels themselves run only on a card: the ``cuda`` tests hold
each kernel against its plain version there and skip here.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpitest_tpu.ops import bitonic as ref_bitonic
from mpitest_tpu.ops import kernels as ref_kernels
from mpitest_tpu_torch.ops import _build, bitonic, kernels
from mpitest_tpu_torch.ops.keys import to_device_words, to_host_words


def _t(a):
    return to_device_words(a, "cpu")


def _patterns(n, rng):
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    return {
        "random": x,
        "dups": rng.integers(0, 16, n).astype(np.uint32),
        "sorted": np.sort(x),
        "reversed": np.sort(x)[::-1].copy(),
        "extremes": rng.choice(np.array([0, 1, 0x7FFFFFFF, 0x80000000,
                                         0xFFFFFFFF], np.uint32), n),
    }


@pytest.mark.parametrize("n_log2,b_log2", [(10, 10), (13, 10), (15, 10)])
def test_sort_padded_plain_matches_reference(n_log2, b_log2):
    rng = np.random.default_rng(n_log2 * 31 + b_log2)
    n = 1 << n_log2
    for name, x in _patterns(n, rng).items():
        want = np.asarray(ref_bitonic.sort_padded(jnp.asarray(x), n, b_log2,
                                                  interpret=True))
        got = to_host_words(bitonic.sort_padded_plain(_t(x)))
        np.testing.assert_array_equal(got, want, err_msg=name)


def _run_multisets(k, p):
    """Sorted (key, payload) pairs: the multiset of payloads per key run."""
    order = np.lexsort((p, k))
    return k[order], p[order]


@pytest.mark.parametrize("n_log2,b_log2,span", [
    (10, 10, 32),        # one block, heavy duplication
    (13, 10, 256),       # merge stages and a 1-bit cross visit
    (15, 10, 64),        # 1-bit and 2-bit cross visits
])
def test_sort_pairs_padded_plain_matches_reference(n_log2, b_log2, span):
    rng = np.random.default_rng(n_log2 * 37 + b_log2)
    n = 1 << n_log2
    k = rng.integers(0, span, n).astype(np.uint32)
    p = rng.integers(0, 2**32, n, dtype=np.uint32)
    rk, rp = ref_bitonic.sort_pairs_padded(jnp.asarray(k), jnp.asarray(p), n,
                                           b_log2, interpret=True)
    rk, rp = np.asarray(rk), np.asarray(rp)
    gk, gp = bitonic.sort_pairs_padded_plain(_t(k), _t(p))
    gk, gp = to_host_words(gk), to_host_words(gp)
    np.testing.assert_array_equal(gk, rk)
    for a, b in zip(_run_multisets(gk, gp), _run_multisets(rk, rp)):
        np.testing.assert_array_equal(a, b)
    # same logical network + same tie rule => same payload permutation
    np.testing.assert_array_equal(gp, rp)


def _planted_runs(n, max_run, rng):
    lens, total = [], 0
    while total < n:
        ln = min(int(rng.integers(1, max_run + 1)), n - total)
        lens.append(ln)
        total += ln
    hi = np.repeat(np.arange(len(lens), dtype=np.uint32) * 11 + 3, lens)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return hi, lo


@pytest.mark.parametrize("max_run,passes", [(8, 8), (16, 16), (24, 16)])
def test_fix_runs_plain_and_boundary_match_reference(max_run, passes):
    rng = np.random.default_rng(max_run)
    n, b_log2 = 1 << 13, 10
    hi, lo = _planted_runs(n, max_run, rng)
    want = ref_bitonic.fix_runs_pairs(jnp.asarray(hi), jnp.asarray(lo),
                                      passes, b_log2, interpret=True)
    want = np.asarray(ref_kernels._fix_boundary(jnp.asarray(hi), want,
                                                passes, 1 << b_log2))
    got = bitonic.fix_runs_pairs(_t(hi), _t(lo), passes, b_log2)
    got = kernels._fix_boundary(_t(hi), got, passes, 1 << b_log2)
    np.testing.assert_array_equal(to_host_words(got), want)
    ref_resid = bool(np.any((hi[1:] == hi[:-1]) & (want[1:] < want[:-1])))
    got_h = to_host_words(got)
    assert bool(np.any((hi[1:] == hi[:-1]) & (got_h[1:] < got_h[:-1]))) == ref_resid
    assert ref_resid == (max_run > passes)


def _ref_phase_b(hi, lo, passes, b_log2):
    """The reference's phase B: its K3 under interpret, its boundary
    strips (none at 0 passes, where its ``-0`` slice takes whole blocks
    and fails), and its residual expression."""
    got = ref_bitonic.fix_runs_pairs(jnp.asarray(hi), jnp.asarray(lo), passes,
                                     b_log2, interpret=True)
    if passes:
        got = ref_kernels._fix_boundary(jnp.asarray(hi), got, passes, 1 << b_log2)
    got = np.asarray(got)
    return got, bool(np.any((hi[1:] == hi[:-1]) & (got[1:] < got[:-1])))


@pytest.mark.parametrize("passes", [0, 1, 16, 17])
@pytest.mark.parametrize("max_run", [8, 16, 24, 40])
def test_fix_runs_flag_plain_matches_reference(max_run, passes):
    """Phase B's plain composition (K3's plain version, the strips, the
    residual expression) against the reference's, lo bytes and flag."""
    rng = np.random.default_rng(1000 + 50 * max_run + passes)
    n, b_log2 = 1 << 13, 10
    hi, lo = _planted_runs(n, max_run, rng)
    want, want_bad = _ref_phase_b(hi, lo, passes, b_log2)
    before = dict(_build.LAUNCHES)
    got, bad = bitonic.fix_runs_flag(_t(hi), _t(lo), passes, b_log2)
    assert _build.LAUNCHES == before   # the CPU runs no kernel
    np.testing.assert_array_equal(to_host_words(got), want)
    assert bad.dtype == torch.bool and bad.dim() == 0
    assert bool(bad) == want_bad
    if passes >= max_run:   # every run fits the passes: nothing is left
        assert not want_bad


def test_fix_runs_flag_plain_is_the_composition():
    rng = np.random.default_rng(5)
    hi, lo = _planted_runs(1 << 12, 20, rng)
    h, low = _t(hi), _t(lo)
    got, bad = bitonic.fix_runs_flag_plain(h, low, 16, 9)
    want = kernels._fix_boundary(h, bitonic.fix_runs_pairs_plain(h, low, 16, 9), 16, 512)
    assert torch.equal(got, want)
    assert bool(bad) == bool(bitonic.residual_plain(h, want))
    assert torch.equal(kernels._fix_boundary(h, low, 0, 512), low)


def test_fix_runs_oe_is_whole_array_odd_even():
    rng = np.random.default_rng(2)
    hi, lo = _planted_runs(3000, 12, rng)
    want = np.asarray(ref_kernels._fix_runs_oe(jnp.asarray(hi), jnp.asarray(lo), 12))
    got = kernels._fix_runs_oe(_t(hi), _t(lo), 12)
    np.testing.assert_array_equal(to_host_words(got), want)


@pytest.mark.parametrize("max_run", [16, 24])
def test_sort_two_words_matches_reference(max_run, monkeypatch):
    """Multi-block pair engine end to end (network + fix + strips +
    residual) on shrunk engine constants, as the reference's own property
    test runs it."""
    rng = np.random.default_rng(max_run + 100)
    n = 3000
    hi, lo = _planted_runs(n, max_run, rng)
    hi = (hi * np.uint32(2654435761)) & np.uint32(0xFFFFFFFF)
    perm = rng.permutation(n)
    hi, lo = hi[perm], lo[perm]
    for mod in (ref_bitonic, bitonic):
        monkeypatch.setattr(mod, "MIN_SORT_LOG2", 8)
        monkeypatch.setattr(mod, "PAIR_BLOCK_LOG2", 9)
    rh, rl, rbad = ref_kernels.sort_two_words_bitonic(
        jnp.asarray(hi), jnp.asarray(lo), interpret=True)
    gh, gl, gbad = kernels.sort_two_words_bitonic(_t(hi), _t(lo))
    np.testing.assert_array_equal(to_host_words(gh), np.asarray(rh))
    np.testing.assert_array_equal(to_host_words(gl), np.asarray(rl))
    assert bool(gbad) == bool(rbad)
    if max_run <= 16:  # the fix-up depth guarantees a clean result
        assert not bool(gbad)


@pytest.mark.parametrize("n", [100, 8197, 9000, 16384, 20000])
def test_bitonic_sort_u32_routes_and_sorts(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    got = bitonic.bitonic_sort_u32(_t(x))
    np.testing.assert_array_equal(to_host_words(got), np.sort(x))


# ------------------------------------------------------------ wrappers


def test_wrappers_check_arguments():
    x = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(TypeError):
        bitonic.sort_padded(x.to(torch.int64), 1024, 10)
    with pytest.raises(ValueError, match="power of two"):
        bitonic.sort_padded(x[:1000], 1000, 10)
    with pytest.raises(ValueError, match="contiguous"):
        bitonic.sort_padded(torch.zeros(2048, dtype=torch.int32)[::2], 1024, 10)
    with pytest.raises(ValueError, match="passes"):
        bitonic.fix_runs_pairs(x, x, 33, 10)
    with pytest.raises(ValueError, match="unsupported device"):
        bitonic.sort_padded(torch.zeros(1024, dtype=torch.int32, device="meta"),
                            1024, 10)


def test_card_tensor_launches_kernel_never_plain(monkeypatch):
    """On a card the wrapper launches the kernel (or raises); the plain
    version is reserved for CPU tensors."""
    calls = []
    monkeypatch.setattr(bitonic, "_on_card", lambda *ts, n: True)
    monkeypatch.setattr(bitonic, "_launch",
                        lambda name, dev, *args: calls.append(name))

    def boom(*a, **k):
        raise AssertionError("plain version ran for a card tensor")

    for name in ("sort_padded_plain", "sort_pairs_padded_plain",
                 "fix_runs_pairs_plain"):
        monkeypatch.setattr(bitonic, name, boom)
    x = torch.zeros(1024, dtype=torch.int32)
    bitonic.sort_padded(x, 1024, 10)
    bitonic.sort_pairs_padded(x, x, 1024, 10)
    bitonic.fix_runs_pairs(x, x, 16, 10)
    assert calls == ["bitonic_u32", "bitonic_pairs_u32", "fix_runs_pairs"]


def test_launch_failure_raises(monkeypatch):
    class FakeFn:
        def __call__(self, *args):
            return 9

    class FakeLib:
        bitonic_u32 = FakeFn()

        @staticmethod
        def kernel_error_string(code):
            return b"invalid configuration argument"

    monkeypatch.setattr(bitonic, "_lib", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    before = bitonic.launches("bitonic_u32")
    with pytest.raises(RuntimeError, match="invalid configuration"):
        bitonic._launch("bitonic_u32", torch.device("cpu"), 0, 0, 1024)
    assert bitonic.launches("bitonic_u32") == before


def test_launch_on_the_current_card_skips_the_guard(monkeypatch):
    """On the current card the launch passes the raw stream handle and
    enters no device guard; on another card it switches devices."""
    got = []

    class FakeLib:
        @staticmethod
        def bitonic_u32(*args):
            got.append(args)
            return 0

    guards = []

    class Guard:
        def __init__(self, d):
            guards.append(d)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 2000})())
    before = bitonic.launches("bitonic_u32")
    _build.launch(FakeLib(), "bitonic_u32", torch.device("cuda", 0), 7, 8)
    _build.launch(FakeLib(), "bitonic_u32", torch.device("cuda", 1), 7, 8)
    assert got == [(7, 8, 1000), (7, 8, 2000)]
    assert guards == [torch.device("cuda", 1)]
    assert bitonic.launches("bitonic_u32") == before + 2


def test_build_failure_raises_with_stderr(monkeypatch, tmp_path):
    (tmp_path / "bad.cu").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    script = tmp_path / "fake_nvcc"
    script.write_text("#!/bin/sh\necho 'error: expected a declaration' >&2\nexit 2\n")
    script.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    with pytest.raises(_build.KernelBuildError, match="expected a declaration"):
        _build.build("bad")
    assert not list((tmp_path / "out").glob("*.so"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "nvcc")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build._nvcc()


def test_signature_arity_matches_source():
    """Each ctypes signature names every parameter of its C entry, the
    trailing stream included (K1's scratch pointer and size too, K3's
    flag byte), and every C entry has a signature."""
    src = (Path(_build.CSRC) / "bitonic.cu").read_text()
    for name, sig in bitonic._SIGNATURES.items():
        m = re.search(rf"int {name}\(([^)]*)\)", src)
        assert m is not None, name
        assert len(sig) == m.group(1).count(",") + 1, name
    entries = re.findall(r"^int (\w+)\(", src[src.index('extern "C"'):], re.M)
    assert sorted(entries) == sorted(bitonic._SIGNATURES)


def test_plan_constants_match_source():
    """The host plan mirrors the schedule constants of csrc/bitonic.cu."""
    src = (Path(_build.CSRC) / "bitonic.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None, name
        return int(m.group(1))

    assert const("kPairTileLog2") == bitonic.PAIR_TILE_LOG2
    assert const("kStageLayers") == bitonic.STAGE_LAYERS
    assert const("kKeyTileLog2") == bitonic.KEY_TILE_LOG2
    assert const("kMergeWinLog2") == bitonic.MERGE_WINDOW_LOG2
    assert 5 + const("kPairRegs").bit_length() - 1 == bitonic._PAIR_WARP_LOG2
    assert 5 + const("kKeyRegs").bit_length() - 1 == bitonic._KEY_WARP_LOG2


def test_fix_constants_match_source():
    """K3's pass limit mirrors ``kFixMaxPasses``; its halo covers the
    passes and the pair past the tile, in whole 16-byte quads."""
    src = (Path(_build.CSRC) / "bitonic.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None, name
        return int(m.group(1))

    assert const("kFixMaxPasses") == bitonic.FIX_MAX_PASSES
    assert const("kFixHalo") >= bitonic.FIX_MAX_PASSES + 1
    assert const("kFixHalo") % 4 == 0 and const("kFixRegs") % 4 == 0


def test_fix_runs_wrappers_pass_the_flag(monkeypatch):
    """K3 alone passes a null flag; phase B passes a one-byte bool flag,
    returns it as the residual, and refuses touching strips on a card."""
    calls = []
    monkeypatch.setattr(bitonic, "_on_card", lambda *ts, n: True)
    monkeypatch.setattr(bitonic, "_launch",
                        lambda name, dev, *args: calls.append((name, args)))
    x = torch.zeros(4096, dtype=torch.int32)
    bitonic.fix_runs_pairs(x, x, 16, 10)
    lo, bad = bitonic.fix_runs_flag(x, x, 16, 10)
    (n1, a1), (n2, a2) = calls
    assert n1 == n2 == "fix_runs_pairs"
    assert a1[3] == 0 and a2[3] == bad.data_ptr() != 0
    assert bad.dtype == torch.bool and bad.dim() == 0 and lo.shape == x.shape
    assert len(a1) + 1 == len(a2) + 1 == len(bitonic._SIGNATURES["fix_runs_pairs"])
    assert a2[4:] == (4096, 16, 1024)
    with pytest.raises(ValueError, match="exceed 2 \\* passes"):
        bitonic.fix_runs_flag(x, x, 32, 6)
    bitonic.fix_runs_flag(x, x, 32, 12)   # one block: no strip


@pytest.mark.parametrize("n_log2,plan,rounds", [
    (13, (1, 0, 0), 0),      # one tile: no stage above it
    (20, (1, 7, 7), 6),      # stages 14..20 take one staged pass each
    (27, (1, 20, 14), 13),   # stages 22..27 take two
    (28, (1, 22, 15), 14),
])
def test_plan_helpers_match_hand_counts(n_log2, plan, rounds):
    n = 1 << n_log2
    assert bitonic.network_plan(n) == plan
    assert bitonic.merge_rounds(n) == rounds
    assert bitonic.scratch_words(n) == (n + n // 8192 if rounds else 0)


def test_plan_helpers_small_and_invalid():
    for t in range(0, 14):
        assert bitonic.network_plan(1 << t) == (1, 0, 0)
    assert bitonic.merge_rounds(1 << 14) == 0 and bitonic.merge_rounds(1 << 15) == 1
    with pytest.raises(ValueError, match="power of two"):
        bitonic.network_plan(3000)


def test_k1_wrapper_passes_its_scratch(monkeypatch):
    """The K1 launch gets a scratch plane of ``scratch_words`` words when
    merge rounds run, and a null pointer without them; every launch passes
    one argument per C parameter but the stream."""
    calls = []
    monkeypatch.setattr(bitonic, "_on_card", lambda *ts, n: True)
    monkeypatch.setattr(bitonic, "_launch",
                        lambda name, dev, *args: calls.append((name, args)))
    for t in (13, 16):
        n = 1 << t
        bitonic.sort_padded(torch.zeros(n, dtype=torch.int32), n, 16)
    bitonic.sort_pairs_padded(torch.zeros(1024, dtype=torch.int32),
                              torch.zeros(1024, dtype=torch.int32), 1024, 10)
    (_, small), (_, big), (pname, pargs) = calls
    assert small[2] == 0 and small[3] == 0 and small[4] == 1 << 13
    assert big[2] != 0 and big[3] == bitonic.scratch_words(1 << 16) and big[4] == 1 << 16
    assert len(small) + 1 == len(bitonic._SIGNATURES["bitonic_u32"])
    assert len(pargs) + 1 == len(bitonic._SIGNATURES[pname])


# --------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU form)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_log2", [10, 16, 20])
def test_k1_kernel_matches_plain(card, n_log2):
    rng = np.random.default_rng(n_log2)
    for name, x in _patterns(1 << n_log2, rng).items():
        xc = to_device_words(x, card)
        got = bitonic.sort_padded(xc, 1 << n_log2, 16)
        want = bitonic.sort_padded_plain(xc)
        assert torch.equal(got, want), name


@pytest.mark.cuda
@pytest.mark.parametrize("n_log2", [12, 18])
def test_k2_kernel_matches_plain(card, n_log2):
    rng = np.random.default_rng(n_log2)
    n = 1 << n_log2
    k = to_device_words(rng.integers(0, 64, n).astype(np.uint32), card)
    p = to_device_words(rng.integers(0, 2**32, n, dtype=np.uint32), card)
    gk, gp = bitonic.sort_pairs_padded(k, p, n, 16)
    wk, wp = bitonic.sort_pairs_padded_plain(k, p)
    assert torch.equal(gk, wk) and torch.equal(gp, wp)


@pytest.mark.cuda
@pytest.mark.parametrize("max_run", [16, 24])
def test_k3_kernel_matches_plain(card, max_run):
    rng = np.random.default_rng(max_run)
    hi, lo = _planted_runs(1 << 18, max_run, rng)
    hc, lc = to_device_words(hi, card), to_device_words(lo, card)
    got = bitonic.fix_runs_pairs(hc, lc, 16, 16)
    want = bitonic.fix_runs_pairs_plain(hc, lc, 16, 16)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_log2", [16, 20, 24])
def test_k1_merge_rounds_match_plain(card, n_log2):
    """2, 6 and 10 merge rounds after the tile sort, over every pattern
    (ties, extremes, sorted and reversed runs reach the merge-path
    searches); the input plane is never written."""
    rng = np.random.default_rng(n_log2 + 1000)
    n = 1 << n_log2
    for name, x in _patterns(n, rng).items():
        xc = to_device_words(x, card)
        keep = xc.clone()
        got = bitonic.sort_padded(xc, n, 16)
        want = bitonic.sort_padded_plain(xc)
        assert torch.equal(got, want), name
        assert torch.equal(xc, keep), name


@pytest.mark.cuda
def test_k2_staged_passes_keys_and_payload_match_plain(card):
    """At 2^24 the stages above 2^21 need two staged passes; equal-key runs
    make the payload order the network's own permutation, which must be
    byte-equal to the plain version's."""
    rng = np.random.default_rng(24)
    n = 1 << 24
    k = to_device_words(rng.integers(0, 4096, n).astype(np.uint32), card)
    p = to_device_words(rng.integers(0, 2**32, n, dtype=np.uint32), card)
    gk, gp = bitonic.sort_pairs_padded(k, p, n, 16)
    wk, wp = bitonic.sort_pairs_padded_plain(k, p)
    assert torch.equal(gk, wk)
    assert torch.equal(gp, wp)


def _k3_inputs(n, b_log2, rng):
    """K3's adversaries: runs of 1..40 with runs of 40 planted across the
    warp tiles' edges (multiples of 440), the 4096-pair chunks of the
    earlier design and the blocks; every hi equal; no equal neighbours;
    runs already sorted."""
    hi, lo = _planted_runs(n, 40, rng)
    key = int(hi.max()) + 1
    for e in list(range(440, n, 440 * 37)) + list(range(4096, n, 4096 * 5)) + \
            list(range(1 << b_log2, n, 1 << b_log2)):
        a = max(e - int(rng.integers(1, 40)), 0)
        hi[a:a + 40] = key
        key += 1
    sorted_lo = lo.copy()
    for start in np.flatnonzero(np.r_[True, hi[1:] != hi[:-1]]):
        end = start + 1
        while end < n and hi[end] == hi[start]:
            end += 1
        sorted_lo[start:end] = np.sort(sorted_lo[start:end])
    return {"runs 1..40 across edges": (hi, lo),
            "all equal hi": (np.full(n, 7, np.uint32), lo),
            "no equal neighbours": (np.arange(n, dtype=np.uint32) * 3, lo),
            "runs already sorted": (hi, sorted_lo)}


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [0, 1, 15, 16, 17, 32])
@pytest.mark.parametrize("b_log2", [10, 12, 13, 16])
def test_k3_redesign_matches_plain(card, b_log2, passes):
    """K3 byte-equal to its plain version on every adversary, and phase B
    (K3, the strip kernel, the flag) byte-equal to its composition, lo
    and flag; the input planes are never written."""
    rng = np.random.default_rng(b_log2 * 100 + passes)
    n = 1 << 17
    for name, (hi, lo) in _k3_inputs(n, b_log2, rng).items():
        hc, lc = to_device_words(hi, card), to_device_words(lo, card)
        keep = lc.clone()
        before = _build.launches("fix_runs_pairs")
        got = bitonic.fix_runs_pairs(hc, lc, passes, b_log2)
        assert torch.equal(got, bitonic.fix_runs_pairs_plain(hc, lc, passes, b_log2)), name
        got, bad = bitonic.fix_runs_flag(hc, lc, passes, b_log2)
        want, want_bad = bitonic.fix_runs_flag_plain(hc, lc, passes, b_log2)
        assert _build.launches("fix_runs_pairs") == before + 2
        assert torch.equal(got, want), name
        assert bool(bad) == bool(want_bad), name
        assert torch.equal(lc, keep), name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 512, 1024])
def test_k3_small_planes_match_plain(card, n):
    """Planes smaller than one warp tile, and the scalar edge of the
    window (n below a quad)."""
    rng = np.random.default_rng(n)
    hi = to_device_words(rng.integers(0, 3, n).astype(np.uint32), card)
    lo = to_device_words(rng.integers(0, 2**32, n, dtype=np.uint32), card)
    for b_log2 in sorted({1, max(n.bit_length() - 1, 1)}):
        for passes in (0, 1, 16, 32):
            got = bitonic.fix_runs_pairs(hi, lo, passes, b_log2)
            assert torch.equal(got, bitonic.fix_runs_pairs_plain(hi, lo, passes, b_log2))
