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
* :func:`remote_a2a_across` is K7 across processes (a mesh built inside
  a group of several processes, ``parallel/mesh.py``): every process
  allocates its ranks' receive buffers in one arena of its own
  (``exchange_ipc_alloc``, a ``cudaMalloc`` per rank), publishes their
  CUDA IPC handles over the control group and maps every peer's; K7 then
  launches per local rank with the global pointer table, local ranks'
  buffers by direct pointer.  The arena serves every exchange shape that
  fits it; a larger one unmaps and frees it first, collectively, and
  :func:`release_ipc` does the same at the end.  The reference's ready
  barrier becomes a stream synchronisation and a control-group barrier
  before the pushes (every buffer's last reader has finished, in every
  process) and after them (every push has landed).  A failed mapping raises
  :class:`IpcMappingError` naming the peer.  :func:`staged_a2a` is the
  host-staged gloo all-to-all across processes: the transport of CPU
  ranks and of the ``lax`` engine, never a stand-in for K7.

* :func:`slot_place` is the receive side of the radix exchange: it writes
  every received lane of a rank's ``[P, cap]`` receive planes to the
  output slot the sort computed for it (``models/radix_sort._lane_slots``),
  in one launch (``slot_place`` of ``csrc/exchange.cu``), optionally with
  each lane's next radix digit.  The reference applies that permutation
  by sorting on the slot; the valid slots tile ``[0, n)`` once, so a
  scatter gives the same bytes in one pass.

A CUDA tensor launches the kernel or raises; the plain versions run for
CPU tensors only.  Launches count in ``ops/_build.LAUNCHES`` under
``fused_pass_pack``, ``remote_a2a`` and ``slot_place``.
"""

from __future__ import annotations

import ctypes
import time
from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import torch

from mpitest_tpu_torch.ops import _build, kernels
from mpitest_tpu_torch.utils import spans
from mpitest_tpu_torch.ops.pack import (
    check_pack_args,
    lib,
    segment_pack_plain,
)

#: Engine names of the exchange dispatch (the knob adds ``auto``).
ENGINES = ("lax", "pallas")

#: Most word planes one fused pack launch takes.
MAX_PLANES = 4

_build.LAUNCHES.update({"fused_pass_pack": 0, "remote_a2a": 0, "slot_place": 0})

if TYPE_CHECKING:
    from mpitest_tpu_torch.parallel.mesh import Mesh


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


def _check_planes(planes: Sequence[torch.Tensor], n_ranks: int) -> bool:
    """Validate exchange matrices (contiguous int32 ``[P, cap]`` planes of
    one shape); True for CUDA tensors, False for CPU ones."""
    shape = planes[0].shape
    if len(shape) != 2 or shape[0] != n_ranks:
        raise ValueError(f"exchange matrices must be [{n_ranks}, cap], got {tuple(shape)}")
    cap = shape[1]
    if cap % 4 or n_ranks * cap >= 1 << 31:
        raise ValueError(f"cap={cap} must be a multiple of 4 with P*cap < 2^31")
    types = {s.device.type for s in planes}
    for s in planes:
        if s.dtype != torch.int32 or s.shape != shape or not s.is_contiguous():
            raise ValueError("exchange matrices are contiguous int32 [P, cap] planes "
                             "of one shape")
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return True
    raise ValueError(f"exchange matrices on {sorted(types)}: use cpu or cuda, not both")


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
    if not _check_planes(sends, len(sends)):
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


# ---------------------------------------------------------------- slot placement

#: ``(word plane, shift, bits, recv_cnt)`` of :func:`slot_place`'s digit
#: plane: the digit of that plane for a lane before its row's count in
#: ``recv_cnt`` (int32[P]), ``2^bits`` from it on.
Digit = tuple[int, int, int, torch.Tensor]


def _check_place_args(planes: tuple[torch.Tensor, ...], slot: torch.Tensor, n: int,
                      digit: Digit | None) -> bool:
    """Validate a placement (receive planes and their slot plane, contiguous
    int32 ``[P, cap]`` of one shape; the digit's counts); True for CUDA
    tensors, False for CPU ones."""
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"1..{MAX_PLANES} planes, got {len(planes)}")
    if not 0 <= n < 1 << 31:
        raise ValueError(f"n={n} must lie in [0, 2^31)")
    on_card = _check_planes((slot,) + planes, slot.shape[0] if slot.dim() else 0)
    if len({t.device for t in (slot,) + planes}) != 1:
        raise ValueError("the planes and the slot plane lie on different devices")
    if digit is not None:
        w_idx, shift, bits, cnts = digit
        if not (0 <= w_idx < len(planes) and 0 <= shift < 32 and 1 <= bits <= 30):
            raise ValueError(f"digit (plane {w_idx}, shift {shift}, bits {bits}) "
                             f"out of range for {len(planes)} planes")
        if (cnts.dtype != torch.int32 or cnts.shape != slot.shape[:1]
                or cnts.device != slot.device or not cnts.is_contiguous()):
            raise ValueError(f"recv_cnt must be a contiguous int32[{slot.shape[0]}] on "
                             f"{slot.device}, got {cnts.dtype}{tuple(cnts.shape)} "
                             f"on {cnts.device}")
    return on_card


def _fills(n_planes: int, digit: Digit | None) -> tuple[int, ...]:
    """The word every output plane starts from: ``2^bits`` in the digit
    plane (if asked), the exchange's fill 0 in the word planes, so a slot
    that no lane fills reads as the padding lane it stands for."""
    words = (0,) * n_planes
    return words if digit is None else (1 << digit[2],) + words


def slot_place_plain(planes: Sequence[torch.Tensor], slot: torch.Tensor, n: int,
                     digit: Digit | None = None) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``slot_place``: one scatter per plane into
    n + 1 words, every lane whose slot lies outside ``[0, n)`` sent to the
    last one, which is dropped."""
    planes = tuple(planes)
    vals = planes
    if digit is not None:
        w_idx, shift, bits, cnts = digit
        c = torch.arange(slot.shape[1], dtype=torch.int32, device=slot.device)[None, :]
        d = torch.where(c < cnts[:, None], kernels.digit_at(planes[w_idx], shift, bits),
                        torch.full((), 1 << bits, dtype=torch.int32, device=slot.device))
        vals = (d,) + planes
    s = slot.reshape(-1).to(torch.int64)
    idx = torch.where((s >= 0) & (s < n), s, n)
    outs = []
    for v, fill in zip(vals, _fills(len(planes), digit)):
        out = torch.full((n + 1,), fill, dtype=torch.int32, device=slot.device)
        out[idx] = v.reshape(-1)
        outs.append(out[:n])
    return tuple(outs)


def slot_place(planes: Sequence[torch.Tensor], slot: torch.Tensor, n: int,
               digit: Digit | None = None) -> tuple[torch.Tensor, ...]:
    """Place the received lanes of 1-4 receive planes (``[P, cap]``) at
    their slots (``slot``, int32 ``[P, cap]``): plane k's lane l lands at
    ``out[k][slot[l]]`` where ``0 <= slot[l] < n``; other lanes are
    dropped, and a slot no lane fills reads 0.  Returns n-word planes, led
    by the digit plane when ``digit`` is given (``(word plane, shift,
    bits, recv_cnt)``: each placed lane's digit before its row's count,
    ``2^bits`` from it on and in unfilled slots).  One kernel launch."""
    planes = tuple(planes)
    if not _check_place_args(planes, slot, n, digit):
        return slot_place_plain(planes, slot, n, digit)
    outs = tuple(torch.full((n,), fill, dtype=torch.int32, device=slot.device)
                 for fill in _fills(len(planes), digit))
    words = outs if digit is None else outs[1:]
    if digit is None:
        d_args = (None, 0, 0, 0, None)
    else:
        w_idx, shift, bits, cnts = digit
        d_args = (outs[0].data_ptr(), w_idx, shift, bits, cnts.data_ptr())
    pad = [None] * (MAX_PLANES - len(planes))
    n_ranks, cap = slot.shape
    _build.launch(lib(), "slot_place", slot.device,
                  *[p.data_ptr() for p in planes], *pad,
                  *[o.data_ptr() for o in words], *pad,
                  len(planes), slot.data_ptr(), n, n_ranks, cap, *d_args)
    return outs


# ---------------------------------------------------------------- K7 across processes


class IpcMappingError(RuntimeError):
    """A peer process's receive buffer could not be mapped (or an arena
    could not be made): the cross-process exchange has no other route."""


class _DeviceBuffer:
    """A raw device allocation seen by ``torch.as_tensor`` through the
    CUDA array interface (int32 words)."""

    def __init__(self, ptr: int, words: int) -> None:
        self.__cuda_array_interface__ = {
            "shape": (words,), "typestr": "<i4", "data": (ptr, False),
            "version": 2, "strides": None}


@dataclass
class _Arena:
    """This process's receive buffers and its mappings of its peers':
    ``words`` int32 words a rank, laid out as ``[W, P, cap]`` per
    exchange shape (``layouts``: the pointer table and the local views)."""

    mesh: "Mesh"
    device: torch.device
    words: int
    own: dict[int, int] = field(default_factory=dict)      # rank -> cudaMalloc base
    mapped: dict[int, int] = field(default_factory=dict)   # rank -> IPC-mapped base
    layouts: dict[tuple[int, int], tuple[torch.Tensor, dict[int, torch.Tensor]]] = \
        field(default_factory=dict)

    def layout(self, n_words: int, cap: int) -> tuple[torch.Tensor, dict[int, torch.Tensor]]:
        """``([W, P] int64 push table, rank -> [W, P, cap] view)`` of one
        exchange shape."""
        key = (n_words, cap)
        if key not in self.layouts:
            p = self.mesh.size
            base = [self.own.get(r, self.mapped.get(r)) for r in range(p)]
            table = torch.tensor([[b + k * p * cap * 4 for b in base]
                                  for k in range(n_words)], dtype=torch.int64,
                                 device=self.device)
            views = {r: torch.as_tensor(_DeviceBuffer(ptr, n_words * p * cap),
                                        device=self.device).view(n_words, p, cap)
                     for r, ptr in self.own.items()}
            self.layouts[key] = (table, views)
        return self.layouts[key]


#: The current arena (one per process; it only grows).
_arena: _Arena | None = None


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = lib().kernel_error_string(rc).decode()
        raise IpcMappingError(f"{what} failed: {msg} (code {rc})")


def _new_arena(mesh: "Mesh", device: torch.device, words: int) -> _Arena:
    """Allocate every local rank's receive buffer of ``words`` int32
    words, publish the handles over the control group and map every
    peer's buffer (collective; its host seconds go to the innermost open
    span as ``ipc_open_s``)."""
    from mpitest_tpu_torch.parallel import mesh as mesh_mod

    ex = lib()
    arena = _Arena(mesh, device, words)
    handle_bytes = ex.exchange_ipc_handle_bytes()
    handles = {}
    t0 = time.perf_counter()
    with torch.cuda.device(device):
        try:
            for r in mesh.local_ranks:
                ptr = ctypes.c_void_p()
                _check(ex.exchange_ipc_alloc(words * 4, ctypes.byref(ptr)),
                       f"allocating the receive arena of rank {r} ({words * 4} bytes)")
                arena.own[r] = ptr.value
                buf = ctypes.create_string_buffer(handle_bytes)
                _check(ex.exchange_ipc_handle(ptr, buf),
                       f"exporting the IPC handle of rank {r}'s receive arena")
                handles[r] = buf.raw
            published = {}
            for part in mesh_mod.gather_objects(handles):
                published.update(part)
            for r in range(mesh.size):
                if r in arena.own:
                    continue
                ptr = ctypes.c_void_p()
                rc = ex.exchange_ipc_open(published[r], ctypes.byref(ptr))
                if rc != 0:
                    raise IpcMappingError(
                        f"mapping the receive buffer of rank {r} (process "
                        f"{mesh.owners[r]}) into process {mesh.process} failed: "
                        f"{ex.kernel_error_string(rc).decode()} (code {rc})")
                arena.mapped[r] = ptr.value
        except BaseException:
            _free(arena)
            raise
    spans.add_to_open_span(ipc_open_s=time.perf_counter() - t0)
    return arena


def _free(arena: _Arena) -> None:
    """Unmap the peers' buffers and free this process's (no barrier)."""
    ex = lib()
    arena.layouts.clear()
    with torch.cuda.device(arena.device):
        for ptr in arena.mapped.values():
            ex.exchange_ipc_close(ctypes.c_void_p(ptr))
        arena.mapped.clear()
        for ptr in arena.own.values():
            ex.exchange_ipc_free(ctypes.c_void_p(ptr))
        arena.own.clear()


def release_ipc() -> None:
    """Unmap every peer's receive buffers and free this process's, in
    every process together: a barrier after the last pushes, the unmaps,
    a barrier, then the frees (no owner frees a buffer a peer still
    maps).  A no-op where no arena was made."""
    global _arena
    from mpitest_tpu_torch.parallel import mesh as mesh_mod

    arena, _arena = _arena, None
    if arena is None:
        return
    torch.cuda.current_stream(arena.device).synchronize()
    mesh_mod.barrier()
    ex = lib()
    with torch.cuda.device(arena.device):
        for ptr in arena.mapped.values():
            _check(ex.exchange_ipc_close(ctypes.c_void_p(ptr)),
                   "unmapping a peer's receive buffer")
    arena.mapped.clear()
    mesh_mod.barrier()
    _free(arena)


def _arena_for(mesh: "Mesh", device: torch.device, words: int) -> _Arena:
    """The arena of ``mesh`` on ``device`` with at least ``words`` words a
    rank: the current one, or (collectively) a new one in its place."""
    global _arena
    if (_arena is not None and _arena.mesh == mesh and _arena.device == device
            and _arena.words >= words):
        return _arena
    release_ipc()
    _arena = _new_arena(mesh, device, words)
    return _arena


def remote_a2a_across(sends: Sequence[Sequence[torch.Tensor]],
                      mesh: "Mesh") -> list[tuple[torch.Tensor, ...]]:
    """K7 across processes: ``sends[i]`` holds local rank i's ``[P, cap]``
    send planes (``mesh.local_ranks[i]``); returns each local rank's
    receive planes (row s is what rank s sent), views of the receive
    arena that stay valid until the next exchange.  CPU ranks take
    :func:`staged_a2a`; CUDA ranks launch K7 or raise.  Where a span is
    open, its attrs gain the host seconds of the stream syncs and
    barriers on each side of the pushes (``ipc_wait_s``), the pushes'
    device milliseconds (``k7_device_ms``, CUDA events made only then)
    and one ``k7_exchanges``."""
    from mpitest_tpu_torch.parallel import mesh as mesh_mod

    flat = [pl for s in sends for pl in s]
    if not _check_planes(flat, mesh.size):
        return staged_a2a(sends, mesh)
    devices = {pl.device for pl in flat}
    if len(devices) != 1:
        raise ValueError("the cross-process exchange needs this process's ranks "
                         f"on one card, got {sorted(map(str, devices))}")
    dev = flat[0].device
    n_words = len(sends[0])
    p, cap = flat[0].shape
    table, views = _arena_for(mesh, dev, n_words * p * cap).layout(n_words, cap)
    stream = torch.cuda.current_stream(dev)
    ex = lib()
    timed = spans.current_log() is not None
    t0 = time.perf_counter()
    stream.synchronize()         # this process's readers of the arena are done
    mesh_mod.barrier()           # ... and every peer's: the buffers are ready
    wait = time.perf_counter() - t0
    if timed:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
    for i, me in enumerate(mesh.local_ranks):
        for k in range(n_words):
            _build.launch(ex, "remote_a2a", dev, sends[i][k].data_ptr(),
                          table[k].data_ptr(), me, p, cap)
    if timed:
        end.record(stream)
    t0 = time.perf_counter()
    stream.synchronize()         # every push of this process has landed
    mesh_mod.barrier()           # ... and every peer's
    if timed:
        spans.add_to_open_span(ipc_wait_s=wait + time.perf_counter() - t0,
                               k7_device_ms=start.elapsed_time(end), k7_exchanges=1)
    return [tuple(views[me][k] for k in range(n_words)) for me in mesh.local_ranks]


def staged_a2a(sends: Sequence[Sequence[torch.Tensor]],
               mesh: "Mesh") -> list[tuple[torch.Tensor, ...]]:
    """The host-staged all-to-all across processes: every local rank's
    ``[P, cap]`` send planes go to the host, one ``all_to_all_single``
    over the gloo control group moves each process's blocks to their
    owners, and the receive planes come back to the ranks' devices.  The
    transport of CPU ranks and of the ``lax`` engine, and the plain
    version that K7 across processes is held to."""
    from mpitest_tpu_torch.parallel import mesh as mesh_mod

    local = mesh.local_ranks
    n_words = len(sends[0])
    p, cap = sends[0][0].shape
    host = torch.stack([torch.stack([pl.detach().cpu() for pl in s]) for s in sends])
    # a mesh across processes holds ranks of every process of the group
    owned = [[r for r in range(p) if mesh.owners[r] == q]
             for q in sorted(set(mesh.owners))]
    # to process q: for each of its ranks d, for each local source i, the
    # W planes' row d
    inp = torch.cat([host[:, :, ranks, :].permute(2, 0, 1, 3).reshape(-1)
                     for ranks in owned])
    in_splits = [len(ranks) * len(local) * n_words * cap for ranks in owned]
    out_splits = [len(local) * len(ranks) * n_words * cap for ranks in owned]
    out = torch.empty(sum(out_splits), dtype=torch.int32)
    mesh_mod.all_to_all_single(out, inp, out_splits, in_splits)
    recv = torch.empty(len(local), n_words, p, cap, dtype=torch.int32)
    off = 0
    for ranks, size in zip(owned, out_splits):
        block = out[off:off + size].view(len(local), len(ranks), n_words, cap)
        recv[:, :, ranks, :] = block.permute(0, 2, 1, 3)
        off += size
    return [tuple(recv[i, k].to(sends[i][0].device) for k in range(n_words))
            for i in range(len(local))]
