"""Exchange engine — the fused pass pack (K6) and the rank-to-rank
all-to-all (K7); port of ``mpitest_tpu/ops/exchange.py``.

* :func:`fused_pass_pack` spreads every word plane of a shard into its
  ``[P, cap]`` send matrix in one launch (``fused_pass_pack`` of
  ``csrc/exchange.cu``): the addressing of :func:`ops.pack.segment_pack`
  computed once per lane for up to four planes, one fill per plane.  The
  segment table is the histogram's clip arithmetic
  (``collectives.block_send_segments``), so the radix pass never builds
  an n-element destination plane.
* :func:`remote_a2a` moves the send matrices between ranks: rank r's row
  ``dst`` lands in row r of rank dst's receive matrix.  On the card it is
  one ``remote_a2a`` launch per rank on that rank's device, each pushing
  all P rows (the self block included) through a device array of the
  receive buffers' addresses.  The reference's ready barrier becomes
  stream order: every rank's pack is enqueued before any push and every
  push before any read (one stream when all ranks share a card; events
  across cards, peer access enabled by ``parallel/mesh.make_mesh``).
  :func:`remote_a2a_plain` is the per-block copy; it is also the
  transport of the ``lax`` engine, standing in for ``lax.all_to_all``.

A CUDA tensor launches the kernel or raises; the plain versions run for
CPU tensors only.  Launches count in ``ops/_build.LAUNCHES`` under
``fused_pass_pack`` and ``remote_a2a``.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from mpitest_tpu_torch.ops import _build
from mpitest_tpu_torch.ops.pack import (
    check_pack_args,
    lib,
    segment_pack_plain,
)

#: Engine names of the exchange dispatch (the knob adds ``auto``).
ENGINES = ("lax", "pallas")

#: Most word planes one fused pack launch takes.
MAX_PLANES = 4

_build.LAUNCHES.update({"fused_pass_pack": 0, "remote_a2a": 0})


def is_pallas(engine: str) -> bool:
    """True for the pallas exchange engine (K6 pack, K7 transport)."""
    return engine == "pallas"


# ---------------------------------------------------------------- K6


def fused_pass_pack_plain(arrays: Sequence[torch.Tensor], starts: torch.Tensor,
                          cnts: torch.Tensor, cap: int, n_ranks: int,
                          fills: Sequence[int] = ()) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K6: K5's spread per plane."""
    fills = tuple(fills) or (0,) * len(arrays)
    return tuple(segment_pack_plain(a, starts, cnts, cap, n_ranks, f)
                 for a, f in zip(arrays, fills))


def fused_pass_pack(arrays: Sequence[torch.Tensor], starts: torch.Tensor,
                    cnts: torch.Tensor, cap: int, n_ranks: int,
                    fills: Sequence[int] = ()) -> tuple[torch.Tensor, ...]:
    """Spread every word plane's ragged segments into its ``[P, cap]``
    send matrix in one kernel launch (the fused pass pack); ``fills`` is
    one fill word per plane (default 0)."""
    arrays = tuple(arrays)
    fills = tuple(fills) or (0,) * len(arrays)
    if not 1 <= len(arrays) <= MAX_PLANES or len(fills) != len(arrays):
        raise ValueError(f"1..{MAX_PLANES} planes with one fill each, got "
                         f"{len(arrays)} planes and {len(fills)} fills")
    if not check_pack_args(arrays, starts, cnts, cap, n_ranks):
        return fused_pass_pack_plain(arrays, starts, cnts, cap, n_ranks, fills)
    dev = arrays[0].device
    outs = tuple(torch.empty((n_ranks, cap), dtype=torch.int32, device=dev)
                 for _ in arrays)
    pad = [None] * (MAX_PLANES - len(arrays))
    _build.launch(lib(), "fused_pass_pack", dev,
                  *[a.data_ptr() for a in arrays], *pad,
                  *[o.data_ptr() for o in outs], *pad,
                  *[f & 0xFFFFFFFF for f in fills], *[0] * len(pad),
                  len(arrays), starts.data_ptr(), cnts.data_ptr(),
                  arrays[0].numel(), n_ranks, cap)
    return outs


# ---------------------------------------------------------------- K7


def _check_sends(sends: Sequence[torch.Tensor]) -> bool:
    """Validate per-rank send matrices; True for CUDA tensors."""
    n_ranks = len(sends)
    shape = sends[0].shape
    if len(shape) != 2 or shape[0] != n_ranks:
        raise ValueError(f"send matrices must be [{n_ranks}, cap], got {tuple(shape)}")
    cap = shape[1]
    if cap % 4 or n_ranks * cap >= 1 << 31:
        raise ValueError(f"cap={cap} must be a multiple of 4 with P*cap < 2^31")
    types = {s.device.type for s in sends}
    for s in sends:
        if s.dtype != torch.int32 or s.shape != shape or not s.is_contiguous():
            raise ValueError("send matrices are contiguous int32 [P, cap] planes "
                             "of one shape")
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return True
    raise ValueError(f"send matrices on {sorted(types)}: use cpu or cuda, not both")


def remote_a2a_plain(sends: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """All-to-all of ``[P, cap]`` blocks by per-block copies:
    ``recv[dst][r] = sends[r][dst]`` (cross-device copies where ranks sit
    on different devices).  The plain version of K7 and the transport of
    the ``lax`` engine."""
    recvs = [torch.empty_like(s) for s in sends]
    for r, s in enumerate(sends):
        for dst, recv in enumerate(recvs):
            recv[r].copy_(s[dst])
    return recvs


def _fence(devices: Sequence[torch.device]) -> None:
    """Make every device's current stream wait for the work enqueued so
    far on every other's (no-op on one device)."""
    devs = list(dict.fromkeys(devices))
    if len(devs) < 2:
        return
    events = {}
    for d in devs:
        events[d] = torch.cuda.Event()
        events[d].record(torch.cuda.current_stream(d))
    for d in devs:
        stream = torch.cuda.current_stream(d)
        for other, ev in events.items():
            if other != d:
                stream.wait_event(ev)


def remote_a2a(sends: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Rank-to-rank bucket exchange: ``sends[r]`` is rank r's ``[P, cap]``
    matrix (row p for rank p) on rank r's device; returns each rank's
    receive matrix (row s is the bucket rank s sent) on the same device.
    One rank returns its matrix as it is, as the reference does."""
    sends = list(sends)
    if len(sends) == 1:
        return sends
    if not _check_sends(sends):
        return remote_a2a_plain(sends)
    n_ranks, cap = sends[0].shape
    devices = [s.device for s in sends]
    recvs = [torch.empty_like(s) for s in sends]
    # pinned + non_blocking: the address table rides the stream, no host sync
    ptrs_host = torch.tensor([r.data_ptr() for r in recvs],
                             dtype=torch.int64).pin_memory()
    ptrs = {d: ptrs_host.to(d, non_blocking=True) for d in dict.fromkeys(devices)}
    _fence(devices)      # every receive buffer is live before any push
    for me, s in enumerate(sends):
        _build.launch(lib(), "remote_a2a", s.device, s.data_ptr(),
                      ptrs[s.device].data_ptr(), me, n_ranks, cap)
    _fence(devices)      # every push lands before any read
    return recvs


def enable_peer_access(devices: Sequence[torch.device]) -> None:
    """Let every pair of distinct cards among ``devices`` address each
    other's memory (K7 pushes into peers' receive buffers); raises where
    a pair cannot."""
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    if len(cards) < 2:
        return
    exchange = lib()
    for a in cards:
        for b in cards:
            if a != b:
                rc = exchange.exchange_enable_peer_access(a, b)
                if rc != 0:
                    raise RuntimeError(
                        f"peer access cuda:{a} -> cuda:{b} failed: "
                        f"{exchange.kernel_error_string(rc).decode()} (code {rc})")
