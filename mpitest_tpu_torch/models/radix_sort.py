"""Distributed LSD radix sort over a mesh — port of
``mpitest_tpu/models/radix_sort.py``.

The design is the reference's (its module docstring has the full
argument): keys stay sharded ``[P, n]`` across passes, only ``[P, bins]``
histograms are gathered, and every key moves to its exact global
digit-stable position, so every rank ends every pass with exactly n keys
whatever the skew.  The slot of each received lane (:func:`_lane_slots`)
comes from the gathered histograms alone.  The reference merges an
exchange by sorting on it (later passes sort on ``(digit, slot)``, the
last merge on the slot); here the valid slots, which tile ``[0, n)``
once, place the lanes in one launch (``slot_place``, ``ops/exchange.py``)
and the pass sorts only its n digits, stably, as pass 1 does: the same
order, from a scatter and a sort of n digits instead of a 64-bit sort of
``P * cap`` lanes.  The last pass's merge is one placement.

Every function here runs all ranks: per-rank values are lists (see
``parallel/collectives.py``).  On a mesh across processes (``mesh=``)
the lists hold this process's ranks and the loops run over
``mesh.local_ranks``, each rank keeping its global rank ``r`` in the
send-count, segment and lane-slot arithmetic; the gathered histograms
make every pass's decisions the same in every process.  Every digit
sort is ``radix.digit_sort`` (``ops/radix.py``), a stable counting sort
that also gives the digit's histogram, and the probe counts with its
count alone (``radix.digit_count``); the reference sorts there with
``lax.sort`` and takes the histogram from the sorted digits, which this
equals.  Under ``radix_pallas`` pass 1 runs the fused radix kernel (K4)
with the key words as payload planes.

Telemetry: each pass opens a ``radix_pass`` span and the count probe a
``negotiate_probe`` span on the active span log (``utils/spans.py``), so
the collectives' point events nest under them.  The spans time the host
enqueue of the pass, on every run.
"""

from __future__ import annotations

from collections.abc import Sequence

import contextlib

import torch

from mpitest_tpu_torch.ops import exchange as xeng
from mpitest_tpu_torch.ops import kernels, radix
from mpitest_tpu_torch.parallel import collectives as coll
from mpitest_tpu_torch.parallel.mesh import Mesh
from mpitest_tpu_torch.utils import spans

Words = tuple[torch.Tensor, ...]


def _pass_span(k: int, w_idx: int, shift: int, digit_bits: int, n: int, cap: int
               ) -> "contextlib.AbstractContextManager[spans.Span | None]":
    """Span of one radix pass, with the reference's attributes; the pass's
    collectives nest under it.  ``trace_time`` is False: the span is the
    host wall of enqueueing this pass on every run, not of tracing a
    compile."""
    return spans.maybe_span("radix_pass", pass_index=k, word=w_idx,
                            shift=shift, digit_bits=digit_bits, n=n,
                            cap=cap, trace_time=False)


def _lane_slots(recv_cnt: torch.Tensor, H: torch.Tensor, digit_base: torch.Tensor,
                rank_base: torch.Tensor, n: int, cap: int, me: int) -> torch.Tensor:
    """Local output slot of every received lane of rank ``me``, from the
    gathered histograms.

    Lane (s, c) holds element ``j0[s] + c`` of sender s's digit-sorted
    shard, ``j0[s]`` the start of s's segment toward me; its destination is
    ``base[s, d] + (j - lo[s, d])`` for its digit d, with ``base`` s's global
    run start of d and ``lo`` the run start inside s's shard.  Lanes of a
    row arrive digit-sorted, so ``base - lo`` is a step function of the
    lane whose steps sit at ``lo[s, :] - j0[s]`` (a K-element scatter and a
    cumsum; the digits are never read).

    Returns int32 ``[P, cap]``: the slot in ``[0, n)`` for valid lanes,
    ``n`` for the rest.  Valid slots tile ``[0, n)`` exactly once."""
    base = digit_base[None, :] + rank_base                     # [P, bins]
    lo = coll.exclusive_cumsum(H, 1)                            # [P, bins]
    j0 = torch.minimum((me * n - base).clamp(min=0), H).sum(1, dtype=torch.int32)
    starts = (lo - j0[:, None]).clamp(0, cap)
    steps = kernels.piecewise_fill(starts, base - lo, cap)      # [P, cap]
    c = torch.arange(cap, dtype=torch.int32, device=H.device)[None, :]
    slot = steps + j0[:, None] + c - me * n
    return torch.where(c < recv_cnt[:, None], slot,
                       torch.full((), n, dtype=torch.int32, device=H.device))


def _send_segments(sorted_dest: torch.Tensor, n: int,
                   n_ranks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Contiguous per-destination segments of a dest-monotone shard."""
    bounds = torch.arange(n_ranks, dtype=torch.int32, device=sorted_dest.device) * n
    send_start = torch.searchsorted(sorted_dest, bounds, side="left").to(torch.int32)
    seg_end = torch.cat([send_start[1:], send_start.new_full((1,), n)])
    return send_start, seg_end - send_start


def radix_probe_spmd(words: Sequence[Words], digit_bits: int,
                     n_ranks: int, mesh: Mesh | None = None) -> torch.Tensor:
    """Capacity-negotiation probe: the exact per-peer send counts of the
    first radix exchange (the least-significant digit of the
    least-significant word), with no key movement.  Returns the int32
    ``[P, P]`` matrix, row r the counts rank r sends (self included), on
    the first (local) rank's device."""
    n = words[0][0].numel()
    with spans.maybe_span("negotiate_probe", algorithm="radix",
                          ranks=n_ranks, n=n, trace_time=False):
        hs = [radix.digit_count(w[-1], 0, digit_bits)[0] for w in words]
        H = coll.all_gather(hs, mesh)                             # [P, bins]
        mine = [coll.block_send_counts(H[i], n, r)
                for i, r in enumerate(coll.local_ranks(n_ranks, mesh))]
        return coll.all_gather(mine, mesh)[0]                     # [P, P]


def _plan(n_words: int, digit_bits: int, passes: int | None) -> list[tuple[int, int]]:
    """``(word_idx, shift)`` of every pass, least-significant first."""
    per_word = (32 + digit_bits - 1) // digit_bits
    total = per_word * n_words if passes is None else passes
    plan = [(w, p * digit_bits) for w in range(n_words - 1, -1, -1)
            for p in range(per_word)]
    return plan[:total]


Hist = tuple[torch.Tensor, torch.Tensor]


def _digit_sort(d: torch.Tensor, words: Words) -> tuple[torch.Tensor, Words]:
    """Stable sort of a shard's words by their digits ``d`` (values in
    ``[0, 2^16]``: a digit of up to 16 bits or a merge pass's sentinel
    ``2^bits``): ``(sorted digits, words)``, the merge pass's sort without
    its histogram."""
    sd, sw, _ = radix.digit_sort(words, radix.DIGIT_SORT_MAX_BITS, digits=d)
    return sd, sw


def _first_pass(words: Words, w_idx: int, shift: int, digit_bits: int,
                local_engine: str) -> tuple[torch.Tensor | None, Words, Hist]:
    """Stable sort of one shard by one digit: ``(sorted digits or None,
    words, (h, lo))``."""
    if local_engine == "radix_pallas":
        # a stable counting sort: K4 with the words as payload planes
        # (diff 0: never a sort key)
        d = kernels.digit_at(words[w_idx], shift, digit_bits)
        fps = radix.fused_radix_sort((d,) + tuple(words),
                                     diffs=((1 << digit_bits) - 1,) + (0,) * len(words))
        return fps[0], tuple(fps[1:]), kernels.histogram_sorted(fps[0], 1 << digit_bits)
    return radix.digit_sort(words, digit_bits, w_idx=w_idx, shift=shift)


def _merge_pass(recv: Words, recv_cnt: torch.Tensor, slot: torch.Tensor,
                w_idx: int, shift: int, digit_bits: int, n: int
                ) -> tuple[torch.Tensor, Words, Hist]:
    """Merge a received exchange and group it by the next digit: place
    every valid lane at its slot with its digit (``slot_place``), then
    sort the n digits stably: ``(sorted digits, words, (h, lo))``.  A
    lane at or past its row's count (a dropped peer's, whose slot may
    still be valid) carries the digit ``2^bits``, as does a slot no lane
    fills (an overflowed exchange; its words read the exchange's fill):
    both sort past the valid lanes and count in no bin, as in the
    reference's sort on ``(digit, slot)``, so the n lanes and their digits
    are the reference's."""
    d, *placed = xeng.slot_place(recv, slot, n,
                                 digit=(w_idx, shift, digit_bits, recv_cnt))
    return radix.digit_sort(tuple(placed), digit_bits, digits=d)


def radix_sort_spmd(words: Sequence[Words], n_words: int, digit_bits: int,
                    n_ranks: int, cap: int, passes: int | None = None,
                    pack: str = "xla", exchange_engine: str = "lax",
                    local_engine: str = "lax", mesh: Mesh | None = None,
                    ) -> tuple[list[Words], torch.Tensor]:
    """Multi-pass radix sort of every rank's shard (``words[r]``, n keys
    each).

    ``passes`` limits the digit passes (the host found the high digits
    constant).  ``exchange_engine="lax"`` materializes each pass's
    destination plane and takes segments from a search over it;
    ``"pallas"`` takes them from the histogram's clip arithmetic
    (``block_send_segments``), packs with K6, moves with K7, and computes
    the next pass's lane slots in the ``pre_exchange`` window.  Both give
    the same bytes.  ``local_engine="radix_pallas"`` runs pass 1 with K4;
    the later passes' digit sorts are ``radix.digit_sort`` under either
    engine.

    Returns ``(sorted shards, max_send_cnt over passes)``; the latter above
    ``cap`` means an exchange overflowed and the caller regrows.  With a
    ``mesh`` across processes, ``words`` and the shards are this process's
    ranks' (``mesh.local_ranks``)."""
    n = words[0][0].numel()
    local = coll.local_ranks(n_ranks, mesh)
    pos = {r: i for i, r in enumerate(local)}
    fused = xeng.is_pallas(exchange_engine)
    dev0 = words[0][0].device
    max_cnt = torch.zeros((), dtype=torch.int32, device=dev0)
    plan = _plan(n_words, digit_bits, passes)
    if not plan:
        return [tuple(w) for w in words], max_cnt

    recv = recv_cnt = None
    prev = None          # lax engine: (H, digit_base, rank_base) per rank
    slot_carry = None    # pallas engine: the lane slots from pre_exchange
    for k, (w_idx, shift) in enumerate(plan):
        with _pass_span(k + 1, w_idx, shift, digit_bits, n, cap):
            sorted_words, hist = [], []
            for i, r in enumerate(local):
                if recv is None:
                    _, sw, h = _first_pass(words[i], w_idx, shift, digit_bits, local_engine)
                else:
                    slot = slot_carry[i] if fused else _lane_slots(
                        recv_cnt[i], *prev[i], n, cap, r)
                    _, sw, h = _merge_pass(recv[i], recv_cnt[i], slot, w_idx, shift,
                                           digit_bits, n)
                sorted_words.append(sw)
                hist.append(h)
            recv = slot_carry = None

            H, tot, rank_base = coll.exscan_counts([h for h, _ in hist], mesh)
            digit_base = [coll.exclusive_cumsum(t) for t in tot]
            base = [digit_base[i] + rank_base[i][r] for i, r in enumerate(local)]
            if fused:
                segs = [coll.block_send_segments(hist[i][0], base[i], n, n_ranks)
                        for i in range(len(local))]

                def _pre(r: int, rc: torch.Tensor, H=H, db=digit_base,
                         rb=rank_base) -> torch.Tensor:
                    i = pos[r]
                    return _lane_slots(rc, H[i], db[i], rb[i], n, cap, r)

                recv, recv_cnt, mc, slot_carry = coll.ragged_all_to_all(
                    sorted_words, [s for s, _ in segs], [c for _, c in segs], cap,
                    n_ranks, pack=pack, engine=exchange_engine, pre_exchange=_pre,
                    mesh=mesh)
            else:
                segs = []
                for i in range(len(local)):
                    _, lo_local = hist[i]
                    dest = (kernels.piecewise_fill(lo_local, base[i] - lo_local, n)
                            + torch.arange(n, dtype=torch.int32, device=lo_local.device))
                    segs.append(_send_segments(dest, n, n_ranks))
                recv, recv_cnt, mc = coll.ragged_all_to_all(
                    sorted_words, [s for s, _ in segs], [c for _, c in segs], cap,
                    n_ranks, pack=pack, engine=exchange_engine, mesh=mesh)
                prev = [(H[i], digit_base[i], rank_base[i]) for i in range(len(local))]
            del sorted_words
        max_cnt = torch.maximum(max_cnt, mc.to(dev0))

    out = []
    for i, r in enumerate(local):
        slot = slot_carry[i] if fused else _lane_slots(recv_cnt[i], *prev[i], n, cap, r)
        out.append(xeng.slot_place(recv[i], slot, n))
    return out, max_cnt
