"""The mesh of ranks — port of ``mpitest_tpu/parallel/mesh.py``.

The reference's mesh is single-controller: one process drives P devices
through ``shard_map``, and every multi-rank test of it runs 8 virtual CPU
devices in one process.  The port keeps that shape: a :class:`Mesh` is P
ranks, each a ``torch.device``, and one controller runs every SPMD step
for every rank (``parallel/collectives.py``).  Ranks may share a device:
on a machine with one H100 all P ranks sit on it, and the exchange
kernels run there at the reference's sizes; with several cards the same
code places ranks round-robin over them.  (Multi-process
``torch.distributed`` is not the model: NCCL refuses two ranks on one
GPU, and gloo would stage the transport through the host.)

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
    each other (the exchange pushes into peers' memory)."""
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
