"""The exchange kernels of the port (``ops/pack.py`` K5, ``ops/exchange.py``
K6 and K7) against the reference's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; they are held
byte for byte against ``segment_pack`` and ``fused_pass_pack`` with
``interpret=True``, and against ``remote_a2a(interpret=True)`` under
``shard_map`` on the reference's cpu:P mesh (its interpreter twin is
``lax.all_to_all``).  Inputs come from a numpy seed; tolerance is exact.
The ``cuda`` tests hold the CUDA kernels against the plain versions on a
card and skip here.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from mpitest_tpu import compat
from mpitest_tpu.ops import exchange as ref_x
from mpitest_tpu.ops import pallas_kernels as ref_pk
from mpitest_tpu.parallel.mesh import AXIS
from mpitest_tpu_torch.ops import _build, exchange, pack

CHUNK = pack.CHUNK


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _segments(rng, n: int, P: int, mode: str):
    """Ascending segment starts over ``[0, n)`` with ragged counts;
    ``mode`` plants empty segments or one segment above the cap, or puts
    start p at p*(n//P) + p % 4 (every residue mod 4: the 16-byte quads
    of the source never line up with those of the rows)."""
    if mode == "residues":
        starts = np.array([p * (n // P) + p % 4 for p in range(P)], np.int32)
        starts[0] = 0
        cnts = (np.append(starts[1:], n) - starts).astype(np.int32)
        return starts, cnts
    cuts = np.sort(rng.integers(0, n + 1, P - 1))
    starts = np.concatenate([[0], cuts]).astype(np.int32)
    cnts = (np.concatenate([cuts, [n]]) - starts).astype(np.int32)
    if mode == "empty":
        cnts[1::2] = 0
    return starts, cnts


@pytest.mark.parametrize("n,P,cap,mode", [
    (4 * CHUNK, 8, CHUNK, "ragged"),
    (3 * CHUNK + 517, 8, CHUNK, "empty"),        # n not a multiple of 1024
    (5 * CHUNK + 3, 3, 2 * CHUNK, "ragged"),
    (6 * CHUNK - 9, 2, CHUNK, "overflow"),       # cnt > cap: lanes dropped
    (1000, 4, CHUNK, "empty"),
    (6 * CHUNK + 13, 8, CHUNK, "residues"),      # starts at every residue mod 4
    (3 * CHUNK + 2, 4, CHUNK, "residues"),
], ids=["p8", "p8-odd-n-empty", "p3", "p2-overflow", "small-n", "p8-residues",
        "p4-residues"])
@pytest.mark.parametrize("fill", [0, 0xFFFFFFFF, 7])
def test_segment_pack_matches_reference(n, P, cap, mode, fill):
    rng = np.random.default_rng(n + P + fill)
    data = rng.integers(0, 2**32, n, dtype=np.uint32)
    starts, cnts = _segments(rng, n, P, mode)
    if mode == "overflow":
        assert cnts.max() > cap
    want = ref_pk.segment_pack(jnp.asarray(data), jnp.asarray(starts),
                               jnp.asarray(cnts), cap, P, fill=fill, interpret=True)
    before = dict(_build.LAUNCHES)
    got = pack.segment_pack(_t(data), _t(starts), _t(cnts), cap, P, fill=fill)
    assert _build.LAUNCHES == before   # the CPU runs no kernel
    np.testing.assert_array_equal(_u(got), np.asarray(want))


def test_segment_pack_past_the_data_reads_zero():
    """A count that runs past the data reads 0 there (the reference's
    zero padding), never out of bounds."""
    data = np.arange(1, 2001, dtype=np.uint32)
    starts = np.array([0, 1900], np.int32)
    cnts = np.array([1900, 600], np.int32)
    want = ref_pk.segment_pack(jnp.asarray(data), jnp.asarray(starts),
                               jnp.asarray(cnts), CHUNK, 2, fill=5, interpret=True)
    got = pack.segment_pack(_t(data), _t(starts), _t(cnts), CHUNK, 2, fill=5)
    np.testing.assert_array_equal(_u(got), np.asarray(want))
    assert (_u(got)[1, 100:600] == 0).all() and (_u(got)[1, 600:] == 5).all()


@pytest.mark.parametrize("n_planes", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["ragged", "empty", "residues"])
def test_fused_pass_pack_matches_reference(n_planes, mode):
    rng = np.random.default_rng(10 * n_planes + len(mode))
    n, P, cap = 4 * CHUNK + 77, 8, CHUNK
    planes = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(n_planes)]
    fills = tuple(int(v) for v in rng.integers(0, 2**32, n_planes))
    starts, cnts = _segments(rng, n, P, mode)
    want = ref_x.fused_pass_pack(tuple(jnp.asarray(p) for p in planes),
                                 jnp.asarray(starts), jnp.asarray(cnts), cap, P,
                                 fills=fills, interpret=True)
    got = exchange.fused_pass_pack(tuple(_t(p) for p in planes), _t(starts),
                                   _t(cnts), cap, P, fills)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g), np.asarray(w))


@pytest.mark.parametrize("P", [2, 3, 8])
def test_remote_a2a_matches_reference(P):
    """Plain K7 against the reference's interpreter twin under shard_map:
    ``recv[dst][s] = send[s][dst]``."""
    from mpitest_tpu.parallel.mesh import make_mesh

    cap = 256
    rng = np.random.default_rng(P)
    sends = rng.integers(0, 2**32, (P, P, cap), dtype=np.uint32)

    def f(x):
        return ref_x.remote_a2a(x.reshape(P, cap), P, AXIS, interpret=True)[None]

    want = jax.jit(compat.shard_map(f, mesh=make_mesh(P), in_specs=(PS(AXIS),),
                                    out_specs=PS(AXIS)))(sends.reshape(P * P, cap))
    want = np.asarray(want).reshape(P, P, cap)
    got = exchange.remote_a2a([_t(s) for s in sends])
    for r in range(P):
        np.testing.assert_array_equal(_u(got[r]), want[r])
    assert exchange.remote_a2a([_t(sends[0][:1])])[0].shape == (1, cap)


def test_pack_argument_checks():
    data = torch.zeros(100, dtype=torch.int32)
    st = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 1024"):
        pack.segment_pack(data, st, st, 1000, 2)
    with pytest.raises(ValueError, match=r"int32\[3\]"):
        pack.segment_pack(data, st, st, CHUNK, 3)
    with pytest.raises(TypeError, match="int32 bit patterns"):
        pack.segment_pack(data.to(torch.int64), st, st, CHUNK, 2)
    with pytest.raises(ValueError, match="1..4 planes"):
        exchange.fused_pass_pack((data,) * 5, st, st, CHUNK, 2)
    with pytest.raises(ValueError, match=r"\[2, cap\]"):
        exchange.remote_a2a([torch.zeros(3, 8, dtype=torch.int32)] * 2)
    assert exchange.is_pallas("pallas") and not exchange.is_pallas("lax")


def test_signature_arity_matches_source():
    """Each ctypes signature names every parameter of its C entry, the
    trailing stream included."""
    src = (Path(_build.CSRC) / "exchange.cu").read_text()
    for name, sig in pack.SIGNATURES.items():
        m = re.search(rf"int {name}\(([^)]*)\)", src)
        assert m is not None, name
        assert len(sig) == m.group(1).count(",") + 1, name
    m = re.search(r"int exchange_enable_peer_access\(([^)]*)\)", src)
    assert m is not None and m.group(1).count(",") == 1


def test_kernel_launch_is_counted(monkeypatch):
    """A wrapper given a CUDA tensor launches through ``_build.launch``
    (counted) and never runs the plain version."""
    calls = []
    monkeypatch.setattr(pack, "check_pack_args", lambda *a: True)
    monkeypatch.setattr(pack, "segment_pack_plain",
                        lambda *a, **k: pytest.fail("plain version on the card path"))
    monkeypatch.setattr(pack, "lib", lambda: "lib")
    monkeypatch.setattr(_build, "launch", lambda lib, name, dev, *a: calls.append(name))
    pack.segment_pack(torch.zeros(10, dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32), CHUNK, 2)
    assert calls == ["segment_pack"]


# --------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU form)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ragged", "empty", "overflow"])
def test_k5_k6_on_the_card_match_plain(card, mode):
    rng = np.random.default_rng(3)
    n, P, cap = (1 << 20) - 333, 8, 1 << 17
    starts, cnts = _segments(rng, n, P, "empty" if mode == "empty" else "ragged")
    if mode == "overflow":
        assert cnts.max() > cap
    planes = [_t(rng.integers(0, 2**32, n, dtype=np.uint32)).to(card) for _ in range(3)]
    st, ct = _t(starts).to(card), _t(cnts).to(card)
    before = _build.launches("segment_pack")
    got = pack.segment_pack(planes[0], st, ct, cap, P, fill=0xFFFFFFFF)
    assert _build.launches("segment_pack") == before + 1
    want = pack.segment_pack_plain(planes[0], st, ct, cap, P, fill=0xFFFFFFFF)
    assert torch.equal(got, want)
    got = exchange.fused_pass_pack(planes, st, ct, cap, P, (1, 2, 3))
    want = exchange.fused_pass_pack_plain(planes, st, ct, cap, P, (1, 2, 3))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["residues", "residues-empty", "residues-overflow"])
def test_k5_k6_residues_on_the_card_match_plain(card, mode):
    """Starts at every residue mod 4, n not a multiple of 4, empty
    segments (cnt = 0) and a segment past the cap (cnt > cap, past n)."""
    rng = np.random.default_rng(11)
    n, P, cap = (1 << 20) - 333, 8, 1 << 17
    starts, cnts = _segments(rng, n, P, "residues")
    if mode == "residues-empty":
        cnts[1::3] = 0
    if mode == "residues-overflow":
        cnts[3] = cap + 4099
        cnts[7] = n - starts[7] + 77               # runs past the data: zeros
    assert n % 4 and sorted(set(int(s) % 4 for s in starts)) == [0, 1, 2, 3]
    planes = [_t(rng.integers(0, 2**32, n, dtype=np.uint32)).to(card) for _ in range(4)]
    st, ct = _t(starts).to(card), _t(cnts).to(card)
    got = pack.segment_pack(planes[0], st, ct, cap, P, fill=0xFFFFFFFF)
    assert torch.equal(got, pack.segment_pack_plain(planes[0], st, ct, cap, P,
                                                    fill=0xFFFFFFFF))
    for w in (1, 2, 4):
        fills = (5, 0xFFFFFFFF, 0, 9)[:w]
        got = exchange.fused_pass_pack(planes[:w], st, ct, cap, P, fills)
        want = exchange.fused_pass_pack_plain(planes[:w], st, ct, cap, P, fills)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_k7_on_the_card_matches_plain(card):
    P, cap = 8, 1 << 16
    g = torch.Generator(device=card).manual_seed(7)
    sends = [torch.randint(-2**31, 2**31, (P, cap), dtype=torch.int32, device=card,
                           generator=g) for _ in range(P)]
    before = _build.launches("remote_a2a")
    got = exchange.remote_a2a(sends)
    assert _build.launches("remote_a2a") == before + P
    want = exchange.remote_a2a_plain(sends)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_k7_across_cards_matches_plain():
    """Ranks on several cards: K7 pushes into peers' memory (peer access
    from make_mesh, event fences between the cards' streams)."""
    from mpitest_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    mesh = make_mesh(2 * torch.cuda.device_count())   # two ranks a card
    P, cap = mesh.size, 1 << 16
    sends = [torch.randint(-2**31, 2**31, (P, cap), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(r)).to(d)
             for r, d in enumerate(mesh.devices)]
    got = exchange.remote_a2a(sends)
    want = exchange.remote_a2a_plain(sends)
    for g, w, d in zip(got, want, mesh.devices):
        assert g.device == d and torch.equal(g, w)
