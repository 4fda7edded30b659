"""The collectives over a mesh — port of ``mpitest_tpu/parallel/collectives.py``.

The reference calls these inside ``shard_map``, where each value is one
rank's.  Here the controller holds every rank's value: a per-rank value
is a list with one entry per rank, entry r on rank r's device, and each
function takes and returns such lists.  Replicated results (the gathered
histogram matrix, splitters) are one tensor per rank as well, so a rank
never reads another rank's device outside a collective.

:func:`ragged_all_to_all` is the exchange of both sorts: the explicit
count exchange, the pack of each rank's contiguous segments into a
``[P, cap]`` send matrix (K5, K6 or plain scatter), the transport (K7 or
per-block copies), and the overflow report (``max_send_cnt > cap``).

Telemetry: :func:`all_gather`, :func:`psum`, :func:`pmax` and
:func:`ragged_all_to_all` each record one point event on the active span
log (``utils/spans.py``) with the reference's byte accounting.  The port
has no trace time, so the events come on every run (the reference's once
per compile); they carry bytes, never time.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import torch

from mpitest_tpu_torch import faults
from mpitest_tpu_torch.ops import exchange as xeng
from mpitest_tpu_torch.ops import kernels, pack as kpack
from mpitest_tpu_torch.parallel.mesh import AXIS
from mpitest_tpu_torch.utils import spans

Words = tuple[torch.Tensor, ...]
PerRank = list


def _emit_collective(name: str, xs: Sequence[torch.Tensor], **attrs: object) -> None:
    """One point event per collective call: ``bytes`` is the per-rank
    payload entering it, ``bytes_out`` (all_gather) the per-rank result,
    ``ranks`` the participants.  Sizes come from shapes: no host read."""
    log = spans.current_log()
    if log is None:
        return
    b_in = int(xs[0].numel()) * xs[0].element_size()
    attrs.setdefault("ranks", len(xs))
    if name == "all_gather":
        attrs.setdefault("bytes_out", b_in * len(xs))
    log.event(name, bytes=b_in, axis=AXIS, **attrs)


def _on(xs: Sequence[torch.Tensor], t: torch.Tensor) -> PerRank:
    """``t`` replicated onto every rank's device (no copy where it already
    lies)."""
    return [t.to(x.device) for x in xs]


def all_gather(xs: Sequence[torch.Tensor]) -> PerRank:
    """``MPI_Allgather``: every rank gets the ``[P, ...]`` stack, in rank
    order."""
    _emit_collective("all_gather", xs)
    stacked = torch.stack([x.to(xs[0].device) for x in xs])
    return _on(xs, stacked)


def psum(xs: Sequence[torch.Tensor]) -> PerRank:
    """``MPI_Allreduce(SUM)``."""
    _emit_collective("psum", xs, op="sum")
    total = torch.stack([x.to(xs[0].device) for x in xs]).sum(0)
    return _on(xs, total.to(xs[0].dtype))


def pmax(xs: Sequence[torch.Tensor]) -> PerRank:
    """``MPI_Allreduce(MAX)``."""
    _emit_collective("pmax", xs, op="max")
    return _on(xs, torch.stack([x.to(xs[0].device) for x in xs]).amax(0))


def exclusive_cumsum(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Exclusive prefix sum along ``axis`` (dtype kept)."""
    return torch.cumsum(x, axis, dtype=x.dtype) - x


def exscan_counts(hs: Sequence[torch.Tensor]
                  ) -> tuple[PerRank, PerRank, PerRank]:
    """Global exclusive scan of per-rank count vectors: per rank
    ``(H, tot, rank_base)`` with ``H`` the ``[P, B]`` gathered histograms,
    ``tot[b] = sum_r H[r, b]`` and ``rank_base[r, b] = sum_{r'<r} H[r', b]``
    (the ``MPI_Exscan``, computed replicated after one all_gather)."""
    _emit_collective("all_gather", hs)
    H = torch.stack([h.to(hs[0].device) for h in hs])
    tot = H.sum(0, dtype=H.dtype)
    rank_base = exclusive_cumsum(H, 0)
    return _on(hs, H), _on(hs, tot), _on(hs, rank_base)


def _clip_cum(bounds: torch.Tensor, base: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``cum[s] = sum_d clip(bounds[s] - base[d], 0, h[d])`` in int64."""
    return torch.minimum((bounds[:, None] - base[None, :].to(torch.int64)).clamp(min=0),
                         h[None, :].to(torch.int64)).sum(1)


def block_send_counts(H: torch.Tensor, n: int, me: int) -> torch.Tensor:
    """Rank ``me``'s per-destination-block send counts of the next radix
    exchange, from the gathered ``[P, bins]`` histogram alone: its keys of
    digit d occupy global positions ``[base[d], base[d] + H[me, d])`` and
    block s is ``[s*n, (s+1)*n)``.  int32[P], self included."""
    n_ranks = H.shape[0]
    tot = H.sum(0, dtype=H.dtype)
    base = exclusive_cumsum(tot) + exclusive_cumsum(H, 0)[me]
    bounds = torch.arange(n_ranks + 1, dtype=torch.int64, device=H.device) * n
    cum = _clip_cum(bounds, base, H[me])
    return (cum[1:] - cum[:-1]).to(torch.int32)


def block_send_segments(h: torch.Tensor, base: torch.Tensor, n: int,
                        n_ranks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Contiguous per-destination send segments of a digit-sorted shard
    straight from its histogram ``h`` and global run starts ``base``
    (the same clipped-interval sum as :func:`block_send_counts`).
    Returns ``(send_start, send_cnt)``, both int32[P]."""
    bounds = torch.arange(n_ranks + 1, dtype=torch.int64, device=h.device) * n
    cum = _clip_cum(bounds, base, h).to(torch.int32)
    return cum[:-1].contiguous(), (cum[1:] - cum[:-1]).contiguous()


def _xla_pack(a: torch.Tensor, send_start: torch.Tensor, cap: int, n_ranks: int,
              fill: int) -> torch.Tensor:
    """The reference's XLA pack: element j goes to lane (p_j, j - s_j) of
    the segment that starts last at or before it, dropped past ``cap``."""
    n = a.numel()
    j = torch.arange(n, dtype=torch.int32, device=a.device)
    ranks = torch.arange(n_ranks, dtype=torch.int32, device=a.device)
    p_j = kernels.piecewise_fill(send_start, ranks, n)
    s_j = kernels.piecewise_fill(send_start, send_start, n)
    c_j = j - s_j
    slot = torch.where(c_j < cap, p_j.to(torch.int64) * cap + c_j,
                       torch.full((), n_ranks * cap, dtype=torch.int64, device=a.device))
    out = torch.full((n_ranks * cap + 1,), kpack.fill_word(fill), dtype=torch.int32,
                     device=a.device)
    out[slot] = a
    return out[:-1].view(n_ranks, cap)


def ragged_all_to_all(
    arrays: Sequence[Words],
    send_start: Sequence[torch.Tensor],
    send_cnt: Sequence[torch.Tensor],
    cap: int,
    n_ranks: int,
    fill: tuple[int, ...] | None = None,
    pack: str = "xla",
    engine: str = "lax",
    pre_exchange: Callable[[int, torch.Tensor], Any] | None = None,
) -> tuple[PerRank, PerRank, torch.Tensor] | tuple[PerRank, PerRank, torch.Tensor, PerRank]:
    """``MPI_Alltoallv`` for contiguous ragged segments.

    Rank r's word planes ``arrays[r]`` hold P contiguous segments
    ``[send_start[r][p], +send_cnt[r][p])``; segment p goes to rank p.
    ``engine="pallas"`` packs all planes with one fused launch (K6) and
    moves them with the rank-to-rank kernel (K7); ``engine="lax"`` packs
    each plane with ``pack`` (``"pallas"``: K5, ``"xla"``: plain scatter)
    and moves it with per-block copies.  ``pre_exchange(rank, recv_cnt)``
    runs for every rank after the count exchange and before the payload
    transport (the radix pass computes its next lane-slot plane there);
    its results come back as a fourth element.

    Returns ``(recv, recv_cnt, max_send_cnt[, pre_result])``: per rank a
    tuple of ``[P, cap]`` planes (row s holds the segment rank s sent,
    valid below ``recv_cnt[s]``), per rank the int32[P] counts (clipped to
    ``cap``), and the global maximum segment length as a 0-dim tensor —
    above ``cap`` means lanes were dropped and the caller regrows.
    """
    n_words = len(arrays[0])
    fills = tuple(fill) if fill is not None else (0,) * n_words
    use_pallas = xeng.is_pallas(engine)
    if use_pallas:
        pack = engine   # the engine owns its fused pack
    log = spans.current_log()
    if log is not None:
        # the padded exchange ships a [P, cap] block matrix per plane, of
        # which the self block never crosses a link, plus the int32[P]
        # count exchange
        itemsize = sum(a.element_size() for a in arrays[0])
        log.event("ragged_all_to_all",
                  bytes=n_ranks * cap * itemsize + n_ranks * 4,
                  wire_bytes=(n_ranks - 1) * cap * itemsize + (n_ranks - 1) * 4,
                  ranks=n_ranks, cap=cap, n=int(arrays[0][0].numel()),
                  arrays=n_words, pack=pack, engine=engine, axis=AXIS)
    # explicit count exchange: recv_cnt[me][s] = min(send_cnt[s][me], cap)
    sent = torch.stack([c.to(send_cnt[0].device) for c in send_cnt]).clamp(max=cap)
    recv_cnt = [sent[:, me].to(c.device).contiguous() for me, c in enumerate(send_cnt)]
    pre_result = ([pre_exchange(me, rc) for me, rc in enumerate(recv_cnt)]
                  if pre_exchange is not None else None)

    if use_pallas:
        sends = [xeng.fused_pass_pack(arrays[r], send_start[r], send_cnt[r], cap,
                                      n_ranks, fills) for r in range(n_ranks)]
        planes = [xeng.remote_a2a([sends[r][k] for r in range(n_ranks)])
                  for k in range(n_words)]
    else:
        planes = []
        for k in range(n_words):
            if pack == "xla":
                sends = [_xla_pack(arrays[r][k], send_start[r], cap, n_ranks, fills[k])
                         for r in range(n_ranks)]
            elif pack == "pallas":
                sends = [kpack.segment_pack(arrays[r][k], send_start[r], send_cnt[r],
                                            cap, n_ranks, fills[k])
                         for r in range(n_ranks)]
            else:
                raise ValueError(f"unknown pack {pack!r}; use 'xla' or 'pallas'")
            planes.append(xeng.remote_a2a_plain(sends) if n_ranks > 1 else sends)
    recv = [tuple(planes[k][r] for k in range(n_words)) for r in range(n_ranks)]
    # fault injection: an exchange fault armed for this dispatch lands here,
    # between the transport and the receivers' local sort or merge, on
    # every rank (after pre_exchange read the clean counts); no-op otherwise
    recv, recv_cnt = faults.apply_exchange_fault(recv, recv_cnt)
    max_send_cnt = torch.stack([c.max().to(send_cnt[0].device) for c in send_cnt]).max()
    if pre_exchange is not None:
        return recv, recv_cnt, max_send_cnt, pre_result
    return recv, recv_cnt, max_send_cnt
