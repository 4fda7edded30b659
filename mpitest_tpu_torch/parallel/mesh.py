"""The mesh of ranks — port of ``mpitest_tpu/parallel/mesh.py``.

The reference's mesh is single-controller: one process drives P devices
through ``shard_map``, and every multi-rank test of it runs 8 virtual CPU
devices in one process.  The port keeps that shape: a :class:`Mesh` is P
ranks, each a ``torch.device``, and one controller runs every SPMD step
for every rank it owns (``parallel/collectives.py``).  Ranks may share a
device: on a machine with one H100 all P ranks sit on it, and the
exchange kernels run there at the reference's sizes; with several cards
the same code places ranks round-robin over them.

:func:`multihost_init` is the reference's ``MPI_Init`` across nodes over
``torch.distributed``.  Beside the default group it makes the gloo
*control group* (:func:`control_group`) that carries host values between
processes: device lists, histograms, counts, IPC handles, fingerprints
and verdicts.  Inside a group of several processes :func:`make_mesh` is
the reference's multi-controller mesh: every process's local ranks
(its own card, or the devices it passes) are gathered over the control
group into one mesh of global ranks, ordered by (process rank, device),
and each process drives only its own ranks (:attr:`Mesh.local_ranks`).
The payload exchange between processes is K7 pushing into other
processes' receive buffers through CUDA IPC (``ops/exchange.py``).

Every control-group call is one round that carries its step's name: a
process whose dispatch failed reports it (:func:`agree`) and one that
ends its run says so (:func:`abort`), and a peer at any other step then
raises at once (:class:`PeerFailedError`, :class:`PeerAbortedError`)
instead of reading the report as its data or waiting out the timeout.

Rank order is deterministic: the mesh position is the rank, so the shard
of each rank, and with it every exchange count and the output bytes, is
reproducible.
"""

from __future__ import annotations

import time
from collections.abc import Sequence
from dataclasses import dataclass
from datetime import timedelta
from typing import Any

import numpy as np
import torch

from mpitest_tpu_torch.utils import knobs

#: Name of the mesh's one key axis (the reference's), carried by the
#: collectives' span events.
AXIS = "x"


#: Seconds a control-group operation (or the default gloo group's) may
#: wait for its peers before it fails: a peer that died or diverged ends
#: the run with an error instead of a hang.
CONTROL_TIMEOUT_S = 300.0

@dataclass(frozen=True)
class Mesh:
    """P ranks; rank r runs on ``devices[r]`` in process ``owners[r]``.

    ``owners`` is empty for a mesh of this process alone (every rank is
    local).  A mesh built inside a group of several processes names every
    rank's owner, and ``process`` is this process's rank there."""

    devices: tuple[torch.device, ...]
    owners: tuple[int, ...] = ()
    process: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_ranks(self) -> tuple[int, ...]:
        """The global ranks this process drives, in rank order."""
        if not self.owners:
            return tuple(range(len(self.devices)))
        return tuple(r for r, o in enumerate(self.owners) if o == self.process)

    @property
    def local_devices(self) -> tuple[torch.device, ...]:
        return tuple(self.devices[r] for r in self.local_ranks)

    @property
    def cross_process(self) -> bool:
        """True when the ranks belong to more than one process."""
        return len(set(self.owners)) > 1


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


def in_group() -> bool:
    """True inside an initialised ``torch.distributed`` group of several
    processes."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _device_order_key(d: torch.device, process: int = 0) -> tuple[int, str, int]:
    """Stable total order over devices: (process rank, type, index), the
    reference's (process_index, id)."""
    return (process, d.type, -1 if d.index is None else d.index)


#: The control group and the default group it was made for.
_CONTROL: dict[str, Any] = {}


def _make_control_group() -> None:
    """Make the gloo control group beside the default group (the default
    group itself when it is gloo).  Every process of the group calls it."""
    import torch.distributed as dist

    world = dist.group.WORLD
    if dist.get_backend() == "gloo":
        group = world
    else:
        group = dist.new_group(backend="gloo",
                               timeout=timedelta(seconds=CONTROL_TIMEOUT_S))
    _CONTROL.clear()
    _CONTROL.update(world=world, group=group)


def control_group() -> Any:
    """The gloo group that carries host values between the processes (made
    on first use when the caller initialised the group itself; every
    process must then reach this call together, as it does in
    :func:`make_mesh`)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed group is initialised; call "
                           "multihost_init first")
    if _CONTROL.get("world") is not dist.group.WORLD:
        _make_control_group()
    return _CONTROL["group"]


class PeerFailedError(RuntimeError):
    """A peer process left the run's collective sequence to report a
    failed dispatch (:func:`agree`) while this process was at another
    control-group step: this process's dispatch fails too, and every
    process agrees on a retry together."""


class PeerAbortedError(RuntimeError):
    """A peer process ended its run with an error that no retry absorbs
    (:func:`abort`): this process ends its run too."""


#: The step tags that leave the run's sequence (:func:`agree`,
#: :func:`abort`); every other control-group call carries its own step.
_VERDICT, _ABORT = "verdict", "abort"


def _timed_round(fn: Any, *args: Any, **kwargs: Any) -> None:
    """Run one control-group call and add its host seconds and one round
    to the innermost open span (``control_s``, ``control_rounds``)."""
    from mpitest_tpu_torch.utils import spans

    t0 = time.perf_counter()
    try:
        fn(*args, **kwargs)
    finally:
        spans.add_to_open_span(control_s=time.perf_counter() - t0, control_rounds=1)


def _all_gather(step: str, obj: Any) -> list[tuple[str, Any]]:
    """One round of the control group: every process's ``(step, obj)``,
    in process order."""
    import torch.distributed as dist

    out: list[Any] = [None] * dist.get_world_size()
    _timed_round(dist.all_gather_object, out, (step, obj), group=control_group())
    return out


def _in_step(step: str, got: list[tuple[str, Any]]) -> list[Any]:
    """The objects of a round in which every process was at ``step``;
    raises where a peer left the sequence or the processes diverged."""
    steps = [s for s, _ in got]
    if _ABORT in steps:
        raise PeerAbortedError(
            f"process {steps.index(_ABORT)} ended its run while this process "
            f"was at control step {step!r}")
    if _VERDICT in steps:
        raise PeerFailedError(
            f"a dispatch failed in process {steps.index(_VERDICT)} while this "
            f"process was at control step {step!r}")
    if len(set(steps)) > 1:
        raise RuntimeError(f"the processes are out of step on the control "
                           f"group: {steps}")
    return [o for _, o in got]


def gather_objects(obj: Any, step: str = "gather") -> list[Any]:
    """Every process's ``obj`` (picklable), in process order, over the
    control group.  Every process must be at the same ``step``: a peer
    that reports a failed dispatch instead raises :class:`PeerFailedError`
    here, one that ended its run :class:`PeerAbortedError`."""
    return _in_step(step, _all_gather(step, obj))


def each_process(mesh: Mesh | None, obj: Any) -> list[Any]:
    """``obj`` of every process that holds ranks of ``mesh``:
    :func:`gather_objects` on a mesh across processes, ``[obj]`` on a mesh
    of this process alone (or none)."""
    return gather_objects(obj) if mesh is not None and mesh.cross_process else [obj]


def broadcast_object(obj: Any, src: int) -> Any:
    """Process ``src``'s ``obj`` in every process, over the control group."""
    return gather_objects(obj, step="broadcast")[src]


def barrier() -> None:
    """Every process of the control group reaches this point."""
    gather_objects(None, step="barrier")


def all_to_all_single(out: torch.Tensor, inp: torch.Tensor, out_splits: list[int],
                      in_splits: list[int]) -> None:
    """``dist.all_to_all_single`` of host tensors over the control group:
    ``in_splits[q]`` elements of ``inp`` go to process q, ``out_splits[q]``
    of ``out`` come from it (after a round that checks every process is
    at this step)."""
    import torch.distributed as dist

    barrier()
    _timed_round(dist.all_to_all_single, out, inp, out_splits, in_splits,
                 group=control_group())


def agree(failure: str | None) -> list[str]:
    """Every process's dispatch failure (``failure`` is this process's,
    None where its dispatch succeeded): the verdict that every process
    acts on together.  A process whose dispatch failed may reach it while
    a peer is still inside its dispatch: the peer's next control-group
    step raises :class:`PeerFailedError`, the peer comes here with its
    failure, and the round repeats until every process is here."""
    while True:
        got = _all_gather(_VERDICT, failure)
        steps = [s for s, _ in got]
        if _ABORT in steps:
            _in_step(_VERDICT, got)            # raises PeerAbortedError
        if all(s == _VERDICT for s in steps):
            return [f for _, f in got if f is not None]


def abort() -> None:
    """Tell the peers that this process ends its run with an error no
    retry absorbs: their next control-group step raises
    :class:`PeerAbortedError` instead of waiting out the timeout."""
    _all_gather(_ABORT, None)


def gather_ranks(mesh: Mesh, rows: np.ndarray) -> np.ndarray:
    """The ``[P, ...]`` stack of per-rank rows in rank order, from each
    process's rows of its local ranks (``rows[i]`` is local rank i's);
    ``rows`` itself on a mesh of this process alone."""
    if not mesh.cross_process:
        return rows
    out = np.empty((mesh.size,) + rows.shape[1:], rows.dtype)
    for ranks, got in gather_objects((mesh.local_ranks, rows)):
        out[list(ranks)] = got
    return out


def _global_ranks(local: list[torch.device]) -> tuple[list[torch.device],
                                                      tuple[int, ...], int]:
    """Every process's local devices gathered into global rank order:
    ``(devices, owners, this process's rank)``."""
    import torch.distributed as dist

    ranks = sorted(((proc, torch.device(name))
                    for proc, names in enumerate(gather_objects([str(d) for d in local]))
                    for name in names),
                   key=lambda pd: _device_order_key(pd[1], pd[0]))  # stable: slots kept
    return [d for _, d in ranks], tuple(proc for proc, _ in ranks), dist.get_rank()


def make_mesh(n_devices: int | None = None,
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A mesh of ``n_devices`` ranks (default: the ``SORT_DEVICES`` knob,
    auto = one rank per card).

    With ``devices`` given, the ranks are its first ``n_devices`` entries
    in (type, index) order; a list may name one card, or ``cpu``, P times.
    Without it the ranks go round-robin over the cards, so P ranks fit one
    card; no card raises.  Distinct cards of one process get peer access
    to each other (the exchange pushes into peers' memory).

    Inside a ``torch.distributed`` group of several processes every
    process calls it together: its local ranks are ``devices`` (default:
    its own card), the processes' lists are gathered over the control
    group, and the mesh is the first ``n_devices`` global ranks in
    (process rank, type, index, local slot) order, as the reference's
    multi-controller mesh orders (process_index, id).  A mesh across
    processes must hold ranks of every process of the group."""
    if n_devices is None and devices is None:
        n_devices = knobs.get("SORT_DEVICES")
    group = in_group()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh needs a CUDA device and none is "
                               "available; pass devices=['cpu'] * P for the "
                               "plain PyTorch path")
        if group:
            # one rank per process: its own card (multihost_init set it)
            local = [torch.device("cuda", torch.cuda.current_device())]
        else:
            cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            p = len(cards) if n_devices is None else n_devices
            local = [cards[r % len(cards)] for r in range(p)]
    else:
        local = sorted((_normalize(d) for d in devices), key=_device_order_key)
    owners: tuple[int, ...] = ()
    me = 0
    devs = local
    if group:
        devs, owners, me = _global_ranks(local)
    if n_devices is not None and (devices is not None or group):
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs, owners = devs[:n_devices], owners[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one rank")
    mesh = Mesh(tuple(devs), owners, me)
    if mesh.cross_process:
        import torch.distributed as dist

        if len(set(owners)) != dist.get_world_size():
            raise ValueError(
                f"a mesh across processes must hold ranks of all "
                f"{dist.get_world_size()} processes of the group; the first "
                f"{len(devs)} ranks lie in processes {sorted(set(owners))}")
    cards = {d for d in mesh.local_devices if d.type == "cuda"}
    if len(cards) > 1:
        from mpitest_tpu_torch.ops import exchange

        exchange.enable_peer_access(sorted(cards, key=_device_order_key))
    return mesh


def shard_bounds(mesh: Mesh, n_per_shard: int) -> list[tuple[torch.device, int, int]]:
    """Per local rank ``(device, start, stop)`` over the global padded key
    axis: rank r owns ``[r*n, (r+1)*n)``."""
    return [(mesh.devices[r], r * n_per_shard, (r + 1) * n_per_shard)
            for r in mesh.local_ranks]


def alloc_shards(mesh: Mesh, n_per_shard: int,
                 n_words: int) -> list[tuple[torch.Tensor, ...]]:
    """Preallocated per-rank word planes (int32 carriers of uint32 words),
    ``n_words`` of ``n_per_shard`` each on every local rank's device: the
    port's sharded form of the keys, which the streamed ingest fills in
    place chunk by chunk (the counterpart of the reference's
    ``assemble_sharded``, which glues per-device pieces into one global
    array)."""
    return [tuple(torch.empty(n_per_shard, dtype=torch.int32, device=d)
                  for _ in range(n_words))
            for d in mesh.local_devices]


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
    ``tcp://<coordinator>``: with ``device="cpu"`` over gloo; on the card
    (the default; ``process_id`` modulo the local card count) over NCCL
    where every process has a card of its own (``num_processes`` at most
    the card count), and over gloo where processes share a card (NCCL
    refuses two ranks on one GPU).  Beside the default group it makes the
    gloo control group (:func:`control_group`; the default group itself
    when that is gloo), bounded by :data:`CONTROL_TIMEOUT_S`; a group
    whose control group cannot be made fails here.  Without a card and
    without ``device="cpu"`` it raises before any handshake.  The caller
    ends the group with ``torch.distributed.destroy_process_group()``
    (after ``ops.exchange.release_ipc()`` where card ranks exchanged)."""
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

    timeout = timedelta(seconds=CONTROL_TIMEOUT_S)
    if kind == "cpu":
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
        _make_control_group()
        return
    if not torch.cuda.is_available():
        raise RuntimeError("multihost_init needs a CUDA device for the nccl "
                           "backend and none is available; pass device='cpu' "
                           "for gloo")
    cards = torch.cuda.device_count()
    card = torch.device("cuda", process_id % cards)
    torch.cuda.set_device(card)
    if num_processes <= cards:
        dist.init_process_group("nccl", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                device_id=card)
    else:
        # processes share a card: NCCL refuses two ranks on one GPU, and
        # the payload moves through CUDA IPC anyway
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    _make_control_group()
