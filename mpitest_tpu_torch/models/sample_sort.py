"""Distributed sample sort over a mesh — port of
``mpitest_tpu/models/sample_sort.py``.

The reference's design: each rank sorts its shard, evenly spaced samples
of every shard are gathered and sorted replicated, P-1 splitters picked
from them, every key bucketed by one lexicographic search against the
splitters (buckets are contiguous because the shard is sorted), one
ragged exchange, and one local sort of the received ``[P, cap]`` lanes,
whose invalid lanes carry the maximum word and sort to the tail.  The
cap is honest: the exchange reports its largest segment and the caller
regrows.  Per-rank values are lists (``parallel/collectives.py``).

Telemetry: the splitter selection opens a ``splitter_round`` span and the
count probe a ``negotiate_probe`` span on the active span log
(``utils/spans.py``); the sample all_gather nests under them.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from mpitest_tpu_torch.ops import kernels
from mpitest_tpu_torch.ops.keys import MAX_WORD
from mpitest_tpu_torch.parallel import collectives as coll
from mpitest_tpu_torch.utils import spans

Words = tuple[torch.Tensor, ...]


def select_splitters(sorted_words: Sequence[Words], n_ranks: int,
                     oversample: int) -> list[Words]:
    """``oversample`` evenly spaced samples per sorted shard, gathered in
    rank order, sorted (``lax``), and the P-1 picks at ``i*m // P`` —
    identical on every rank.  Returns the splitters per rank."""
    n_words = len(sorted_words[0])
    with spans.maybe_span("splitter_round", ranks=n_ranks, oversample=oversample,
                          trace_time=False,
                          sample_bytes=n_ranks * oversample * 4 * n_words):
        samples = [kernels.evenly_spaced_samples(sw, oversample)
                   for sw in sorted_words]
        gathered = tuple(coll.all_gather([s[k] for s in samples])[0].reshape(-1)
                         for k in range(n_words))
        gsorted = kernels.local_sort(gathered)
        m = n_ranks * oversample
        idx = (torch.arange(1, n_ranks, dtype=torch.int64, device=gsorted[0].device)
               * m) // n_ranks
        picks = tuple(w[idx] for w in gsorted)
        return [tuple(p.to(sw[0].device) for p in picks) for sw in sorted_words]


def _strided_sample(n: int, s: int) -> tuple[int, int, int]:
    """``(start, stride, count)`` of at most ``s`` picks over ``[0, n)``
    whose last pick is ``n - 1`` (ceil stride)."""
    if s <= 1:
        return 0, 1, s
    stride = -(-(n - 1) // (s - 1))
    count = (n - 1) // stride + 1
    return (n - 1) - (count - 1) * stride, stride, count


def sample_probe_spmd(words: Sequence[Words], n_ranks: int,
                      oversample: int) -> torch.Tensor:
    """Capacity-negotiation probe: ESTIMATED per-peer send counts of the
    splitter repartition, from splitters picked out of a strided sample of
    each unsorted shard.  Returns int32 ``[P, P]`` on rank 0's device."""
    n = words[0][0].numel()
    s = min(n, max(64, 32 * n_ranks))
    start, stride, s = _strided_sample(n, s)
    with spans.maybe_span("negotiate_probe", algorithm="sample",
                          ranks=n_ranks, n=n, trace_time=False):
        samp = [kernels.local_sort(tuple(w[start: start + (s - 1) * stride + 1: stride]
                                         for w in ws)) for ws in words]
        splitters = select_splitters(samp, n_ranks, min(oversample, s))
        hs = [kernels.histogram(kernels.searchsorted_words(sp, ws), n_ranks)
              for sp, ws in zip(splitters, words)]
        return coll.all_gather(hs)[0]


def sample_sort_spmd(words: Sequence[Words], n_words: int, n_ranks: int, cap: int,
                     oversample: int, pack: str = "xla", engine: str = "lax",
                     exchange_engine: str = "lax",
                     ) -> tuple[list[Words], list[torch.Tensor], torch.Tensor]:
    """Sample sort of every rank's shard.

    ``engine`` is the local engine of the two big sorts (the shard sort
    and the merge of the received lanes): ``bitonic`` runs K1 (one word)
    or the pair engine K2 + K3 with its residual fallback (two words),
    ``lax`` the plain sort; the splitter sample always takes ``lax``.

    Returns ``(out, count, max_send_cnt)``: per rank ``P*cap`` sorted slots
    whose first ``count[r]`` are its valid run, and the global largest
    segment (above ``cap`` means lanes were dropped)."""
    sorted_words = [kernels.local_sort(tuple(w), engine=engine) for w in words]
    splitters = select_splitters(sorted_words, n_ranks, oversample)
    # the shard is sorted, so its buckets are too: the binary-search
    # histogram equals the reference's scatter-add one
    hs = [kernels.histogram_sorted(kernels.searchsorted_words(sp, sw), n_ranks)[0]
          for sp, sw in zip(splitters, sorted_words)]
    recv, recv_cnt, max_cnt = coll.ragged_all_to_all(
        sorted_words, [coll.exclusive_cumsum(h) for h in hs], hs, cap, n_ranks,
        fill=(MAX_WORD,) * n_words, pack=pack, engine=exchange_engine)
    del sorted_words
    out = [kernels.local_sort(tuple(p.reshape(-1) for p in rv), engine=engine)
           for rv in recv]
    counts = [rc.clamp(max=cap).sum(dtype=torch.int32) for rc in recv_cnt]
    return out, counts, max_cnt
