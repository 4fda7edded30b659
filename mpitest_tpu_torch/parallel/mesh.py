"""The mesh of ranks — port of ``mpitest_tpu/parallel/mesh.py``.

The reference's mesh is single-controller: one process drives P devices
through ``shard_map``, and every multi-rank test of it runs 8 virtual CPU
devices in one process.  The port keeps that shape: a :class:`Mesh` is P
ranks, each a ``torch.device``, and one controller runs every SPMD step
for every rank (``parallel/collectives.py``).  Ranks may share a device:
on a machine with one H100 all P ranks sit on it, and the exchange
kernels run there at the reference's sizes; with several cards the same
code places ranks round-robin over them.

:func:`multihost_init` is the reference's ``MPI_Init`` across nodes over
``torch.distributed`` (NCCL on the card, gloo only when the caller asks
for the CPU).  After it, a group of one process builds the same mesh as
without one.  A group of several processes (one per card, the multi-node
shape) needs a cross-process exchange that the port does not have yet
(ROADMAP, Queue 1): :func:`make_mesh` raises :class:`CrossProcessMeshError`
there rather than build a local-only mesh that would sort each process's
copy on its own.

Rank order is deterministic: the mesh position is the rank, so the shard
of each rank, and with it every exchange count and the output bytes, is
reproducible.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import torch

from mpitest_tpu_torch.utils import knobs

#: Name of the mesh's one key axis (the reference's), carried by the
#: collectives' span events.
AXIS = "x"


@dataclass(frozen=True)
class Mesh:
    """P ranks; rank r runs on ``devices[r]``."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _normalize(d: torch.device | str) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d} needs CUDA and none is available")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported mesh device {d}: use cpu or cuda")
    return d


class CrossProcessMeshError(RuntimeError):
    """A mesh was asked for inside a process group of several processes."""


def _require_single_process() -> None:
    """Raise :class:`CrossProcessMeshError` inside an initialised group of
    several processes.  (The reference orders devices by (process_index,
    id); the process rank joins the order key with the cross-process
    exchange, when it can differ from 0.)"""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise CrossProcessMeshError(
            f"a mesh across processes needs the cross-process exchange; see "
            f"ROADMAP (this process is rank {dist.get_rank()} of "
            f"{dist.get_world_size()})")


def _device_order_key(d: torch.device) -> tuple[str, int]:
    """Stable total order over devices: (type, index)."""
    return (d.type, -1 if d.index is None else d.index)


def make_mesh(n_devices: int | None = None,
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A mesh of ``n_devices`` ranks (default: the ``SORT_DEVICES`` knob,
    auto = one rank per card).

    With ``devices`` given, the ranks are its first ``n_devices`` entries
    in (type, index) order; a list may name one card, or ``cpu``, P times.
    Without it the ranks go round-robin over the cards, so P ranks fit one
    card; no card raises.  Distinct cards of one mesh get peer access to
    each other (the exchange pushes into peers' memory).  Inside a
    ``torch.distributed`` group of several processes it raises
    :class:`CrossProcessMeshError`."""
    _require_single_process()
    if n_devices is None and devices is None:
        n_devices = knobs.get("SORT_DEVICES")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh needs a CUDA device and none is "
                               "available; pass devices=['cpu'] * P for the "
                               "plain PyTorch path")
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        p = len(cards) if n_devices is None else n_devices
        devs = [cards[r % len(cards)] for r in range(p)]
    else:
        devs = sorted((_normalize(d) for d in devices), key=_device_order_key)
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
            devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one rank")
    if len({d for d in devs if d.type == "cuda"}) > 1:
        from mpitest_tpu_torch.ops import exchange

        exchange.enable_peer_access(devs)
    return Mesh(tuple(devs))


def shard_bounds(mesh: Mesh, n_per_shard: int) -> list[tuple[torch.device, int, int]]:
    """Per-rank ``(device, start, stop)`` over the global padded key axis:
    rank r owns ``[r*n, (r+1)*n)``."""
    return [(d, i * n_per_shard, (i + 1) * n_per_shard)
            for i, d in enumerate(mesh.devices)]


def alloc_shards(mesh: Mesh, n_per_shard: int,
                 n_words: int) -> list[tuple[torch.Tensor, ...]]:
    """Preallocated per-rank word planes (int32 carriers of uint32 words),
    ``n_words`` of ``n_per_shard`` each on every rank's device: the
    port's sharded form of the keys, which the streamed ingest fills in
    place chunk by chunk (the counterpart of the reference's
    ``assemble_sharded``, which glues per-device pieces into one global
    array)."""
    return [tuple(torch.empty(n_per_shard, dtype=torch.int32, device=d)
                  for _ in range(n_words))
            for d in mesh.devices]


def multihost_init(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, *,
                   device: torch.device | str | None = None) -> None:
    """Multi-process bring-up: the reference's ``multihost_init`` (the
    TPU-native ``MPI_Init`` across nodes) over ``torch.distributed``.

    No arguments is the single-process case and does nothing.  The three
    arguments are required together and validated here, fail-fast, with
    the reference's messages: a malformed coordinator or an out-of-range
    process id must not surface minutes into a handshake.  Then
    ``torch.distributed.init_process_group`` joins the group at
    ``tcp://<coordinator>``: with the ``nccl`` backend on this process's
    card (the default; ``process_id`` modulo the local card count), or
    with ``gloo`` only when ``device="cpu"``.  Without a card and without
    ``device="cpu"`` it raises before any handshake.  The caller ends the
    group with ``torch.distributed.destroy_process_group()``."""
    if coordinator is None and num_processes is None and process_id is None:
        return  # single-process: nothing to do
    missing = [name for name, v in (("coordinator", coordinator),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id))
               if v is None]
    if missing:
        raise ValueError(
            "multihost_init needs coordinator, num_processes and "
            f"process_id together; missing: {', '.join(missing)} "
            "(call with no arguments for single-process)")
    host, sep, port = str(coordinator).rpartition(":")
    # host.endswith(':') catches port-less IPv6 typos ('::1', 'fe80::1'),
    # which rpartition would split into a host of colons and a digit-like
    # port; bracketed IPv6 ('[::1]:8476') parses fine
    if not sep or not host or host.endswith(":"):
        raise ValueError(
            f"multihost_init: coordinator {coordinator!r} is not "
            "'host:port' (e.g. '10.0.0.2:8476'; bracket IPv6 hosts as "
            "'[::1]:8476')")
    try:
        port_n = int(port)
    except ValueError:
        port_n = -1
    if not 1 <= port_n <= 65535:
        raise ValueError(
            f"multihost_init: coordinator port {port!r} is not in "
            "[1, 65535]")
    if not isinstance(num_processes, int) or num_processes < 1:
        raise ValueError(
            f"multihost_init: num_processes={num_processes!r} must be an "
            "integer >= 1")
    if not isinstance(process_id, int) or not 0 <= process_id < num_processes:
        raise ValueError(
            f"multihost_init: process_id={process_id!r} must be an integer "
            f"in [0, {num_processes})")
    kind = "cuda" if device is None else torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"multihost_init: device {device!r} is not cuda or cpu")
    import torch.distributed as dist

    if kind == "cpu":
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
        return
    if not torch.cuda.is_available():
        raise RuntimeError("multihost_init needs a CUDA device for the nccl "
                           "backend and none is available; pass device='cpu' "
                           "for gloo")
    card = torch.device("cuda", process_id % torch.cuda.device_count())
    torch.cuda.set_device(card)
    dist.init_process_group("nccl", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            device_id=card)
