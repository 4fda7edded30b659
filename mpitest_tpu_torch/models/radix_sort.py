"""Distributed LSD radix sort over a mesh — port of
``mpitest_tpu/models/radix_sort.py``.

The design is the reference's (its module docstring has the full
argument): keys stay sharded ``[P, n]`` across passes, only ``[P, bins]``
histograms are gathered, and every key moves to its exact global
digit-stable position, so every rank ends every pass with exactly n keys
whatever the skew.  Each pass is one local sort: pass 1 a stable sort by
the digit, later passes one sort keyed on ``(digit, slot)``, where the
slot of each received lane (:func:`_lane_slots`) comes from the gathered
histograms alone, so the sort both merges the pending exchange and groups
by the new digit.  The last pass's merge is one sort by slot.

Every function here runs all ranks: per-rank values are lists (see
``parallel/collectives.py``).  The local sorts are the reference's plain
sorts (``torch.sort``, stable where the reference asks for it); under
``radix_pallas`` pass 1 runs the fused radix kernel (K4) with the key
words as payload planes.

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
                     n_ranks: int) -> torch.Tensor:
    """Capacity-negotiation probe: the exact per-peer send counts of the
    first radix exchange (the least-significant digit of the
    least-significant word), with no key movement.  Returns the int32
    ``[P, P]`` matrix, row r the counts rank r sends (self included), on
    rank 0's device."""
    n = words[0][0].numel()
    n_bins = 1 << digit_bits
    with spans.maybe_span("negotiate_probe", algorithm="radix",
                          ranks=n_ranks, n=n, trace_time=False):
        hs = [kernels.histogram_sorted(
            torch.sort(kernels.digit_at(w[-1], 0, digit_bits)).values, n_bins)[0]
            for w in words]
        H = coll.all_gather(hs)                                   # [P, bins]
        mine = [coll.block_send_counts(H[r], n, r) for r in range(n_ranks)]
        return coll.all_gather(mine)[0]                           # [P, P]


def _plan(n_words: int, digit_bits: int, passes: int | None) -> list[tuple[int, int]]:
    """``(word_idx, shift)`` of every pass, least-significant first."""
    per_word = (32 + digit_bits - 1) // digit_bits
    total = per_word * n_words if passes is None else passes
    plan = [(w, p * digit_bits) for w in range(n_words - 1, -1, -1)
            for p in range(per_word)]
    return plan[:total]


def _first_pass(words: Words, w_idx: int, shift: int, digit_bits: int,
                local_engine: str) -> tuple[torch.Tensor, Words]:
    """Stable sort of one shard by one digit: ``(sorted digits, words)``."""
    d = kernels.digit_at(words[w_idx], shift, digit_bits)
    if local_engine == "radix_pallas":
        # a stable counting sort: K4 with the words as payload planes
        # (diff 0: never a sort key)
        fps = radix.fused_radix_sort((d,) + tuple(words),
                                     diffs=((1 << digit_bits) - 1,) + (0,) * len(words))
        return fps[0], tuple(fps[1:])
    sd, order = torch.sort(d, stable=True)
    return sd, tuple(w[order] for w in words)


def _merge_pass(recv: Words, recv_cnt: torch.Tensor, slot: torch.Tensor,
                w_idx: int, shift: int, digit_bits: int, n: int
                ) -> tuple[torch.Tensor, Words]:
    """Merge a received exchange and group it by the next digit with one
    sort keyed on ``(digit, slot)``, unique per valid lane; invalid lanes
    carry the digit ``2^bits`` and sort past the n valid ones."""
    cap = slot.shape[1]
    d = kernels.digit_at(recv[w_idx], shift, digit_bits)
    c = torch.arange(cap, dtype=torch.int32, device=d.device)[None, :]
    d = torch.where(c < recv_cnt[:, None], d,
                    torch.full((), 1 << digit_bits, dtype=torch.int32, device=d.device))
    key = (d.to(torch.int64) << 32) | slot.to(torch.int64)
    ks, order = torch.sort(key.reshape(-1))
    order = order[:n]
    return (ks[:n] >> 32).to(torch.int32), tuple(r.reshape(-1)[order] for r in recv)


def radix_sort_spmd(words: Sequence[Words], n_words: int, digit_bits: int,
                    n_ranks: int, cap: int, passes: int | None = None,
                    pack: str = "xla", exchange_engine: str = "lax",
                    local_engine: str = "lax",
                    ) -> tuple[list[Words], torch.Tensor]:
    """Multi-pass radix sort of every rank's shard (``words[r]``, n keys
    each).

    ``passes`` limits the digit passes (the host found the high digits
    constant).  ``exchange_engine="lax"`` materializes each pass's
    destination plane and takes segments from a search over it;
    ``"pallas"`` takes them from the histogram's clip arithmetic
    (``block_send_segments``), packs with K6, moves with K7, and computes
    the next pass's lane slots in the ``pre_exchange`` window.  Both give
    the same bytes.  ``local_engine="radix_pallas"`` runs pass 1 with K4.

    Returns ``(sorted shards, max_send_cnt over passes)``; the latter above
    ``cap`` means an exchange overflowed and the caller regrows."""
    n = words[0][0].numel()
    n_bins = 1 << digit_bits
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
            sds, sorted_words = [], []
            for r in range(n_ranks):
                if recv is None:
                    sd, sw = _first_pass(words[r], w_idx, shift, digit_bits, local_engine)
                else:
                    slot = slot_carry[r] if fused else _lane_slots(
                        recv_cnt[r], *prev[r], n, cap, r)
                    sd, sw = _merge_pass(recv[r], recv_cnt[r], slot, w_idx, shift,
                                         digit_bits, n)
                sds.append(sd)
                sorted_words.append(sw)
            recv = slot_carry = None

            hist = [kernels.histogram_sorted(sd, n_bins) for sd in sds]
            H, tot, rank_base = coll.exscan_counts([h for h, _ in hist])
            digit_base = [coll.exclusive_cumsum(t) for t in tot]
            base = [digit_base[r] + rank_base[r][r] for r in range(n_ranks)]
            if fused:
                segs = [coll.block_send_segments(hist[r][0], base[r], n, n_ranks)
                        for r in range(n_ranks)]

                def _pre(r: int, rc: torch.Tensor, H=H, db=digit_base,
                         rb=rank_base) -> torch.Tensor:
                    return _lane_slots(rc, H[r], db[r], rb[r], n, cap, r)

                recv, recv_cnt, mc, slot_carry = coll.ragged_all_to_all(
                    sorted_words, [s for s, _ in segs], [c for _, c in segs], cap,
                    n_ranks, pack=pack, engine=exchange_engine, pre_exchange=_pre)
            else:
                segs = []
                for r in range(n_ranks):
                    _, lo_local = hist[r]
                    dest = (kernels.piecewise_fill(lo_local, base[r] - lo_local, n)
                            + torch.arange(n, dtype=torch.int32, device=lo_local.device))
                    segs.append(_send_segments(dest, n, n_ranks))
                recv, recv_cnt, mc = coll.ragged_all_to_all(
                    sorted_words, [s for s, _ in segs], [c for _, c in segs], cap,
                    n_ranks, pack=pack, engine=exchange_engine)
                prev = [(H[r], digit_base[r], rank_base[r]) for r in range(n_ranks)]
            del sorted_words, sds
        max_cnt = torch.maximum(max_cnt, mc.to(dev0))

    out = []
    for r in range(n_ranks):
        slot = slot_carry[r] if fused else _lane_slots(recv_cnt[r], *prev[r], n, cap, r)
        order = torch.sort(slot.reshape(-1)).indices[:n]
        out.append(tuple(p.reshape(-1)[order] for p in recv[r]))
    return out, max_cnt
