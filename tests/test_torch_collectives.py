"""The port's mesh, collectives and distributed-sort helpers
(``parallel/mesh.py``, ``parallel/collectives.py``, the helpers of
``ops/kernels.py``) against the reference's, which run under
``shard_map`` on its cpu:P mesh.  Per-rank values of the port are lists,
one entry per rank; inputs come from a numpy seed; tolerance is exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from mpitest_tpu import compat
from mpitest_tpu.ops import kernels as ref_k
from mpitest_tpu.parallel import collectives as ref_c
from mpitest_tpu.parallel.mesh import AXIS
from mpitest_tpu.parallel.mesh import make_mesh as ref_mesh
from mpitest_tpu_torch.ops import kernels
from mpitest_tpu_torch.parallel import collectives as coll
from mpitest_tpu_torch.parallel import mesh as pmesh

CHUNK = 1024


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _spmd(P, f, in_specs, out_specs):
    return jax.jit(compat.shard_map(f, mesh=ref_mesh(P), in_specs=in_specs,
                                    out_specs=out_specs, check_vma=False))


# ------------------------------------------------------------------ mesh


def test_make_mesh_from_a_device_list():
    m = pmesh.make_mesh(3, devices=["cpu"] * 5)
    assert m.size == 3 and m.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="requested 4 devices, have 2"):
        pmesh.make_mesh(4, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="use cpu or cuda"):
        pmesh.make_mesh(1, devices=["meta"])
    assert pmesh.shard_bounds(m, 5) == [(torch.device("cpu"), 0, 5),
                                        (torch.device("cpu"), 5, 10),
                                        (torch.device("cpu"), 10, 15)]


def test_make_mesh_needs_a_card_unless_it_names_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        pmesh.make_mesh(2)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        pmesh.make_mesh(2, devices=["cuda"] * 2)


def test_make_mesh_places_ranks_round_robin_over_cards(monkeypatch):
    """Without a device list, P ranks go round-robin over the cards (all
    on the one card of a one-card machine); SORT_DEVICES sets P."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    from mpitest_tpu_torch.ops import exchange

    peers = []
    monkeypatch.setattr(exchange, "enable_peer_access", peers.append)
    m = pmesh.make_mesh(5)
    assert [d.index for d in m.devices] == [0, 1, 0, 1, 0]
    assert len(peers) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("SORT_DEVICES", "8")
    assert pmesh.make_mesh().devices == (torch.device("cuda", 0),) * 8
    monkeypatch.setenv("SORT_DEVICES", "auto")
    assert pmesh.make_mesh().size == 1


# ------------------------------------------------------------- collectives


def test_all_gather_psum_pmax_match_reference():
    P = 8
    x = np.arange(P * 4, dtype=np.int32) * 7 % 23

    def f(v):
        return ref_c.all_gather(v)[None], ref_c.psum(v), ref_c.pmax(v)

    g, s, m = _spmd(P, f, (PS(AXIS),), (PS(AXIS), PS(), PS()))(x)
    xs = [_t(r) for r in x.reshape(P, 4)]
    for r, got in enumerate(coll.all_gather(xs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(g).reshape(P, P, 4)[r])
    for got in coll.psum(xs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(s))
    for got in coll.pmax(xs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(m))


@pytest.mark.parametrize("P", [2, 3, 8])
def test_exscan_counts_matches_reference(P):
    B = 6
    hists = np.random.default_rng(P).integers(0, 100, (P, B)).astype(np.int32)

    def f(h):
        H, tot, rb = ref_c.exscan_counts(h.reshape(-1))
        return H[None], tot[None], rb[None]

    H, tot, rb = _spmd(P, f, (PS(AXIS),), (PS(AXIS),) * 3)(hists.reshape(-1))
    got = coll.exscan_counts([_t(h) for h in hists])
    for r in range(P):
        np.testing.assert_array_equal(got[0][r].numpy(), np.asarray(H)[r])
        np.testing.assert_array_equal(got[1][r].numpy(), np.asarray(tot)[r])
        np.testing.assert_array_equal(got[2][r].numpy(), np.asarray(rb)[r])
    np.testing.assert_array_equal(
        coll.exclusive_cumsum(_t(hists), 1).numpy(),
        np.asarray(ref_c.exclusive_cumsum(jnp.asarray(hists), axis=1)))


@pytest.mark.parametrize("P,bins", [(2, 16), (3, 256), (8, 256)])
def test_block_send_counts_and_segments_match_reference(P, bins):
    rng = np.random.default_rng(P * bins)
    n = 1000
    # every rank's histogram sums to its shard size n
    hists = np.stack([np.bincount(rng.integers(0, bins, n), minlength=bins)
                      for _ in range(P)]).astype(np.int32)

    def f(h):
        H = ref_c.all_gather(h.reshape(-1))
        me = jax.lax.axis_index(AXIS)
        tot = H.sum(axis=0)
        base = ref_c.exclusive_cumsum(tot) + ref_c.exclusive_cumsum(H, 0)[me]
        st, cn = ref_c.block_send_segments(h.reshape(-1), base, n, P)
        return ref_c.block_send_counts(H, n)[None], st[None], cn[None]

    cnt, st, cn = _spmd(P, f, (PS(AXIS),), (PS(AXIS),) * 3)(hists.reshape(-1))
    H = _t(hists)
    base = (coll.exclusive_cumsum(H.sum(0, dtype=torch.int32))[None]
            + coll.exclusive_cumsum(H, 0))
    for r in range(P):
        np.testing.assert_array_equal(coll.block_send_counts(H, n, r).numpy(),
                                      np.asarray(cnt)[r])
        s, c = coll.block_send_segments(H[r], base[r], n, P)
        np.testing.assert_array_equal(s.numpy(), np.asarray(st)[r])
        np.testing.assert_array_equal(c.numpy(), np.asarray(cn)[r])


@pytest.mark.parametrize("engine,pack", [("lax", "xla"), ("lax", "pallas"),
                                         ("pallas", "pallas")])
@pytest.mark.parametrize("seed,cap_mode", [(0, "fits"), (1, "fits"),
                                           (2, "overflow"), (3, "zeros")])
def test_ragged_all_to_all_matches_reference(engine, pack, seed, cap_mode):
    """Random ragged Alltoallv configurations, all-zero rows and one
    oversized segment: recv lanes, recv counts and the reported maximum
    equal the reference's."""
    P = 8
    rng = np.random.default_rng(seed)
    n = 4 * CHUNK
    hi = 0 if cap_mode == "zeros" else 2 * n // P
    cnts = np.minimum(rng.integers(0, max(hi, 1), (P, P)), n // P).astype(np.int32)
    cap = CHUNK
    if cap_mode == "overflow":
        cnts[0, :] = 0
        cnts[0, 3] = min(n, cap * 3)
    starts = (np.cumsum(cnts, axis=1) - cnts).astype(np.int32)
    data = rng.integers(0, 2**32, (P, n), dtype=np.uint32)
    data2 = rng.integers(0, 2**32, (P, n), dtype=np.uint32)
    fill = (0xFFFFFFFF, 5)
    ref_eng = "pallas_interpret" if engine == "pallas" else "lax"
    ref_pack = "pallas_interpret" if pack == "pallas" else "xla"

    def f(d, d2, st, ct):
        recv, rcnt, mx = ref_c.ragged_all_to_all(
            (d, d2), st.reshape(-1), ct.reshape(-1), cap, P, fill=fill,
            pack=ref_pack, engine=ref_eng)
        return recv[0][None], recv[1][None], rcnt[None], mx

    r0, r1, rcnt, mx = _spmd(P, f, (PS(AXIS),) * 4, (PS(AXIS),) * 3 + (PS(),))(
        data.reshape(-1), data2.reshape(-1), starts, cnts)
    recv, got_cnt, got_mx, pre = coll.ragged_all_to_all(
        [(_t(data[r]), _t(data2[r])) for r in range(P)],
        [_t(starts[r]) for r in range(P)], [_t(cnts[r]) for r in range(P)],
        cap, P, fill=fill, pack=pack, engine=engine,
        pre_exchange=lambda me, rc: (me, rc.sum().item()))
    assert int(got_mx) == int(mx)
    for r in range(P):
        np.testing.assert_array_equal(recv[r][0].numpy().view(np.uint32),
                                      np.asarray(r0)[r])
        np.testing.assert_array_equal(recv[r][1].numpy().view(np.uint32),
                                      np.asarray(r1)[r])
        np.testing.assert_array_equal(got_cnt[r].numpy(), np.asarray(rcnt)[r])
        assert pre[r] == (r, int(np.asarray(rcnt)[r].sum()))


# --------------------------------------------------------- kernel helpers


@pytest.mark.parametrize("shift,bits", [(0, 8), (8, 8), (24, 8), (16, 16),
                                        (22, 11), (30, 4), (0, 16)])
def test_digit_at_matches_reference(shift, bits):
    w = np.random.default_rng(shift + bits).integers(0, 2**32, 4096, dtype=np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = np.asarray(ref_k.digit_at(jnp.asarray(w), shift, bits))
    np.testing.assert_array_equal(kernels.digit_at(_t(w), shift, bits).numpy(), want)


def test_histograms_and_piecewise_fill_match_reference():
    rng = np.random.default_rng(5)
    d = rng.integers(0, 64, 3000).astype(np.int32)
    np.testing.assert_array_equal(kernels.histogram(_t(d), 64).numpy(),
                                  np.asarray(ref_k.histogram(jnp.asarray(d), 64)))
    s = np.sort(d)
    h, lo = kernels.histogram_sorted(_t(s), 70)
    rh, rlo = ref_k.histogram_sorted(jnp.asarray(s), 70)
    np.testing.assert_array_equal(h.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    starts = np.sort(rng.integers(0, 500, (4, 9)), axis=1).astype(np.int32)
    starts[:, 0] = 0
    starts[0, -2:] = 500                          # starts at n are dropped
    vals = rng.integers(-1000, 1000, (4, 9)).astype(np.int32)
    want = jax.vmap(ref_k.piecewise_fill, in_axes=(0, 0, None))(
        jnp.asarray(starts), jnp.asarray(vals), 500)
    np.testing.assert_array_equal(
        kernels.piecewise_fill(_t(starts), _t(vals), 500).numpy(), np.asarray(want))


@pytest.mark.parametrize("n_words", [1, 2])
def test_searchsorted_words_and_samples_match_reference(n_words):
    rng = np.random.default_rng(n_words)
    keys = tuple(rng.integers(0, 2**32, 2000, dtype=np.uint32) for _ in range(n_words))
    keys[0][:50] = 0xFFFFFFFF
    order = np.lexsort(tuple(reversed(keys)))
    skeys = tuple(k[order] for k in keys)
    bounds = tuple(k[[100, 700, 700, 1500, 1999]] for k in skeys)
    want = ref_k.searchsorted_words(tuple(jnp.asarray(b) for b in bounds),
                                    tuple(jnp.asarray(k) for k in keys))
    got = kernels.searchsorted_words(tuple(_t(b) for b in bounds),
                                     tuple(_t(k) for k in keys))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    empty = kernels.searchsorted_words(tuple(_t(b[:0]) for b in bounds),
                                       tuple(_t(k) for k in keys))
    assert not empty.any()
    for m in (1, 15, 64):
        want = ref_k.evenly_spaced_samples(tuple(jnp.asarray(k) for k in skeys), m)
        got = kernels.evenly_spaced_samples(tuple(_t(k) for k in skeys), m)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
