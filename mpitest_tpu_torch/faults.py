"""Deterministic fault injection (port of ``mpitest_tpu/faults.py``).

Failure is a reproducible input here, as in the reference:

* ``SORT_FAULTS=<spec>`` arms a :class:`FaultRegistry`: a comma list of
  ``site[:count]`` entries (``count`` defaults to 1; ``inf`` fires on
  every opportunity, the persistent-failure configuration).  The k-th
  opportunity at a site fires iff the site still has budget, and the
  corruption values come from a splitmix64 stream over
  ``SORT_FAULTS_SEED``: the same spec and seed give the same faults in
  the same places, and the same ``fired`` list as the reference.
* Each layer polls its own site at its own fault point: the supervisor
  at dispatch (``models/supervisor.py``), the exchange between the
  payload transport and the receivers' local sort or merge
  (``parallel/collectives.py``), the ingest pipeline after the
  fingerprint fold (``models/ingest.py``), the result before
  verification (``models/api.py``), and the store's spill, commit,
  journal and merge paths (``store/``).

Sites:

=======================  ================================================
``dispatch_error``       raise :class:`DeviceDispatchError` at dispatch
``dispatch_oom``         raise a ``RESOURCE_EXHAUSTED``-shaped
                         :class:`DeviceDispatchError` at dispatch
``dispatch_stall``       block the dispatching thread for
                         ``SORT_FAULT_STALL_MS`` before the launch
``exchange_corrupt``     XOR one received word (lane (0, 0) of the first
                         word plane, on every rank) after the transport
``exchange_drop``        zero every rank's receive count from peer 0
``cap_squeeze``          force the first exchange cap to the alignment
                         floor, so the overflow regrow runs
``ingest_poison``        corrupt streamed chunk 0 after the input
                         fingerprint folded it
``result_swap``          swap the first and the last key of the result
                         (breaks sortedness)
``result_dup``           overwrite key 1 with key 0 (stays sorted; only
                         the multiset fingerprint sees it)
``spill_corrupt``        flip bits in a spill run's first key bytes after
                         its sidecar folded them
``merge_drop``           drop one merged output chunk before its fold
``spill_torn_write``     chop tail bytes off a committed run's key file
``spill_enospc``         raise ``OSError(ENOSPC)`` at the Nth spill write
                         (``SORT_FAULT_ENOSPC_AT``)
``spill_bitrot``         flip one byte of a committed run's key body
``spill_block_garbage``  scramble one compressed block's header after
                         commit (SORTRUN2 runs only)
``manifest_torn``        drop the tail of one spill-manifest journal line
``merge_stall``          block ``SORT_FAULT_STALL_MS`` at merge entry
=======================  ================================================

:data:`WIRE_SITES` is the wire-level family (torn headers, stalled
payloads, disconnects, slow drips, delayed responses, silent accepts),
injected outside the process by a chaos proxy between a client and the
sort server; it shares the spec grammar (:func:`parse_wire_faults`).

The injected dispatch sites raise :class:`DeviceDispatchError`, the
port's counterpart of the reference's ``JaxRuntimeError``; the
supervisor absorbs it and ``torch.cuda.OutOfMemoryError``, and nothing
else (``models/supervisor.py``).  Injection never bypasses detection:
faults corrupt data, and the always-on verifier plus the supervisor
decide what the user sees — a retried, fingerprint-verified result or a
typed error.  Pure Python: the device hooks take the ranks' tensors and
use only their methods.
"""

from __future__ import annotations

import errno
import math
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

from mpitest_tpu_torch.utils import knobs

if TYPE_CHECKING:
    import numpy as np
    import torch

    from mpitest_tpu_torch.models.api import DistributedSortResult

SITES = (
    "dispatch_error",
    "dispatch_oom",
    "dispatch_stall",
    "exchange_corrupt",
    "exchange_drop",
    "cap_squeeze",
    "ingest_poison",
    "result_swap",
    "result_dup",
    # out-of-core external sort (store/):
    "spill_corrupt",   # flip bits in a spill run's on-disk keys AFTER
                       # the fingerprint sidecar folded them — a bad
                       # disk / torn write the merge must catch
    "merge_drop",      # drop one merged output chunk before the output
                       # fold — silent truncation in the merge engine
    # crash-durable spill tier (store/manifest.py + resume):
    "spill_torn_write",  # chop tail bytes off a run's key file at
                         # close — sidecar/manifest promise more bytes
                         # than disk holds (re-spilled on blame)
    "spill_enospc",      # OSError(ENOSPC) at the Nth spill write
                         # (SORT_FAULT_ENOSPC_AT) — must surface as
                         # the typed capacity rejection, never a 500
    "spill_bitrot",      # flip one byte in a run's key body AFTER
                         # commit — at-rest decay caught by the
                         # merge's read-back fold
    "manifest_torn",     # drop the tail of one manifest journal line
                         # — replay must skip it loudly
    "merge_stall",       # block SORT_FAULT_STALL_MS at merge entry —
                         # the kill-resume drill's SIGKILL barrier
    # compressed spill runs (SORTRUN2 framing):
    "spill_block_garbage",  # scramble one compressed block's header
                            # after commit — the reader must raise a
                            # typed block-corruption error naming run
                            # + block, and blame-respill must recover
)

#: Sites applied inside the exchange of the armed dispatch (between the
#: payload transport and the receivers' local sort or merge): the
#: supervisor queues one when it arms a dispatch, and the first
#: ``ragged_all_to_all`` of that dispatch consumes it.
EXCHANGE_SITES = ("exchange_corrupt", "exchange_drop")

#: Wire-level chaos vocabulary: injected by a chaos TCP proxy between
#: a client and the sort server, never inside this process.  Each
#: site carries one integer parameter (a byte offset ``k`` or a delay
#: in milliseconds — see ``WIRE_DEFAULT_PARAM``).
WIRE_SITES = (
    "wire_torn_header",         # forward k request bytes, then close
    "wire_stall_payload",       # forward header + k payload bytes, then
                                # go silent (the slow-loris shape)
    "wire_disconnect_response", # forward k response bytes, then close
    "wire_slow_drip",           # drip request bytes with k ms pauses
    "wire_delay_response",      # hold the response back for k ms
    "wire_connect_silence",     # accept the client, forward nothing
)

#: Per-site default parameter (bytes for the offset sites, ms for the
#: delay sites) when the spec names no ``@param``.
WIRE_DEFAULT_PARAM: dict[str, int] = {
    "wire_torn_header": 5,
    "wire_stall_payload": 64,
    "wire_disconnect_response": 16,
    "wire_slow_drip": 200,
    "wire_delay_response": 500,
    "wire_connect_silence": 0,
}


@dataclass(frozen=True)
class WireFault:
    """One parsed wire-fault entry: ``site[@param][:every]``.

    ``param`` is the site's byte offset / delay ms; ``every`` selects
    which proxied connections the fault fires on — every ``every``-th
    (1-based), so ``every=1`` hits all connections and ``every=4``
    hits the 4th, 8th, ... (deterministic tail injection for the
    hedging cells)."""

    site: str
    param: int
    every: int = 1

    def spec(self) -> str:
        """The canonical spec string (``parse_wire_faults`` round-trips
        it)."""
        out = self.site
        if self.param != WIRE_DEFAULT_PARAM[self.site]:
            out += f"@{self.param}"
        if self.every != 1:
            out += f":{self.every}"
        return out

    def fires_on(self, conn_index: int) -> bool:
        """True when this fault applies to the ``conn_index``-th
        (0-based) proxied connection."""
        return (conn_index + 1) % self.every == 0


def parse_wire_faults(spec: str) -> tuple[WireFault, ...]:
    """Parse a comma list of ``site[@param][:every]`` wire-fault
    entries (the ``SORT_FAULTS``-style grammar extended with the wire
    family).  Raises ``ValueError`` naming the vocabulary on garbage —
    the same fail-fast contract as :class:`FaultRegistry`."""
    out: list[WireFault] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, every_s = entry.partition(":")
        name, _, param_s = name.partition("@")
        if name not in WIRE_SITES:
            raise ValueError(
                f"wire faults: unknown site {name!r}; use one of "
                f"{WIRE_SITES}")
        param = WIRE_DEFAULT_PARAM[name]
        if param_s:
            try:
                param = int(param_s)
            except ValueError:
                param = -1
            if param < 0:
                raise ValueError(
                    f"wire faults: bad param {param_s!r} for {name!r}; "
                    "use an integer >= 0 (bytes or ms)")
        every = 1
        if every_s:
            try:
                every = int(every_s)
            except ValueError:
                every = 0
            if every < 1:
                raise ValueError(
                    f"wire faults: bad every-count {every_s!r} for "
                    f"{name!r}; use an integer >= 1")
        out.append(WireFault(name, param, every))
    if not out:
        raise ValueError(
            f"wire faults: empty spec; use a comma list of "
            f"site[@param][:every] over {WIRE_SITES}")
    return tuple(out)


def _splitmix64(state: int) -> tuple[int, int]:
    """One splitmix64 step: (next_state, output) — the same deterministic
    stream family native/comm_fuzz.c uses, so corruption values are
    reproducible from SORT_FAULTS_SEED alone."""
    state = (state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return state, z ^ (z >> 31)


@dataclass
class _Site:
    name: str
    remaining: float  # math.inf = persistent


@dataclass
class FaultRegistry:
    """Parsed, seedable fault plan for ONE sort run.

    ``fire(site)`` consumes one unit of that site's budget (thread-safe:
    the ingest pool's workers poll ``ingest_poison`` concurrently) and
    records the firing in :attr:`fired`; ``on_fire`` (set by the
    supervisor) forwards each firing into the span/counter pipeline.
    """

    spec: str
    seed: int = 0
    sites: dict[str, _Site] = field(default_factory=dict)
    fired: list[tuple[str, dict[str, object]]] = field(default_factory=list)
    on_fire: Callable[[str, dict[str, object]], None] | None = None

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._rng_state = (self.seed * 0x2545F4914F6CDD1D + 1) & 0xFFFFFFFFFFFFFFFF
        self._seq = 0
        for entry in self.spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            name, _, cnt = entry.partition(":")
            if name not in SITES:
                raise ValueError(
                    f"SORT_FAULTS: unknown fault site {name!r}; "
                    f"use one of {SITES}"
                )
            if cnt in ("", None):
                count: float = 1
            elif cnt == "inf":
                count = math.inf
            else:
                try:
                    count = int(cnt)
                except ValueError:
                    count = 0
                if count < 1:
                    raise ValueError(
                        f"SORT_FAULTS: bad count {cnt!r} for {name!r}; "
                        "use a positive integer or 'inf'"
                    )
            site = self.sites.setdefault(name, _Site(name, 0))
            site.remaining += count

    # -- firing -------------------------------------------------------
    def would_fire(self, site: str) -> bool:
        """Non-consuming budget peek (lets hooks avoid advancing the
        corruption RNG for sites that are not armed — the RNG stream
        must depend only on the faults that actually fire)."""
        with self._lock:
            s = self.sites.get(site)
            return s is not None and s.remaining > 0

    def fire(self, site: str, **detail: object) -> bool:
        """Consume one unit of ``site``'s budget; True iff the fault
        fires now.  Records the firing and notifies ``on_fire``."""
        with self._lock:
            s = self.sites.get(site)
            if s is None or s.remaining <= 0:
                return False
            s.remaining -= 1
            self._seq += 1
            detail = dict(detail, seq=self._seq)
            self.fired.append((site, detail))
        cb = self.on_fire
        if cb is not None:
            cb(site, detail)
        return True

    def rand_word(self) -> int:
        """Deterministic nonzero uint32 corruption value."""
        with self._lock:
            self._rng_state, out = _splitmix64(self._rng_state)
        return (out & 0xFFFFFFFF) or 0xDEADBEEF

    @property
    def injected(self) -> int:
        return len(self.fired)


class DeviceDispatchError(RuntimeError):
    """A device dispatch failed in a way a re-run may cure (the port's
    counterpart of the reference's ``JaxRuntimeError``): raised by the
    injected dispatch sites and by drills.  The supervisor retries it and
    the degradation ladder descends on it; a kernel that fails to build
    or launch raises its own error, which neither absorbs."""


# -- run-scoped activation -------------------------------------------------

#: Registry installed explicitly (tests, chaos drivers); takes precedence
#: over the SORT_FAULTS env spec.
_INSTALLED: FaultRegistry | None = None

#: Stack of registries active for the current run (sort(), the ingest
#: pipeline, the external sort); hooks in worker threads read the top.
_ACTIVE: list[FaultRegistry] = []

#: Exchange fault handed from the supervisor to the hook in
#: ``collectives.ragged_all_to_all``; one-shot, popped by the first
#: exchange of the armed dispatch.  The supervisor drops it when the
#: armed dispatch dies before its exchange, and run teardown
#: (``active.__exit__``) clears any straggler, so a stale entry never
#: reaches a later clean dispatch.
_PENDING_EXCHANGE: list[dict] = []


def install(reg: FaultRegistry | None) -> None:
    """Install a registry for subsequent runs (None clears).  Tests use
    this instead of mutating os.environ."""
    global _INSTALLED
    _INSTALLED = reg


def for_run() -> FaultRegistry | None:
    """The registry for a new run: the installed one, else a FRESH parse
    of ``SORT_FAULTS`` (counts reset every run: deterministic per run,
    not cumulative across a process)."""
    if _INSTALLED is not None:
        return _INSTALLED
    spec = knobs.get("SORT_FAULTS")
    if not spec:
        return None
    return FaultRegistry(spec, seed=faults_seed())


def faults_seed() -> int:
    """``SORT_FAULTS_SEED`` (default 0): the corruption-stream seed."""
    return knobs.get("SORT_FAULTS_SEED")


def validate_env() -> None:
    """Fail-fast parse of the fault knobs (the CLI's [ERROR] contract)."""
    for name in ("SORT_FAULTS", "SORT_FAULTS_SEED"):
        knobs.get(name)


class active:
    """Context manager scoping ``reg`` to the current run (re-entrant: a
    rebuild that re-runs the streamed ingest inside a sort nests)."""

    def __init__(self, reg: FaultRegistry | None) -> None:
        self.reg = reg

    def __enter__(self) -> FaultRegistry | None:
        if self.reg is not None:
            _ACTIVE.append(self.reg)
        return self.reg

    def __exit__(self, *exc: object) -> bool:
        if self.reg is not None and _ACTIVE and _ACTIVE[-1] is self.reg:
            _ACTIVE.pop()
        if self.reg is not None and not _ACTIVE:
            drop_pending()  # no armed-but-unconsumed fault outlives a run
        return False


def current() -> FaultRegistry | None:
    return _ACTIVE[-1] if _ACTIVE else None


# -- site hooks ------------------------------------------------------------

def arm_exchange(reg: FaultRegistry | None) -> None:
    """Host side of the exchange faults: if one fires for this dispatch,
    queue its parameters for the exchange hook.  The reference also
    returns a compile token here (a poisoned trace must never be served
    from its jit cache); the port compiles nothing per dispatch, so the
    queue is all there is."""
    if reg is None:
        return
    for site in EXCHANGE_SITES:
        if not reg.would_fire(site):
            continue  # don't advance the RNG for unarmed sites
        word = reg.rand_word()
        if reg.fire(site, word=word):
            _PENDING_EXCHANGE.append({"site": site, "word": word})
            return


def drop_pending() -> int:
    """Discard any armed-but-unconsumed exchange fault: called when the
    armed dispatch dies before its exchange and at run teardown.  Returns
    the number dropped (the caller records them as ``faults_dropped``:
    they were counted as injected when armed but never touched data)."""
    n = len(_PENDING_EXCHANGE)
    _PENDING_EXCHANGE.clear()
    return n


def _as_int32(word: int) -> int:
    """A uint32 corruption word as the int32 value of the same bits (the
    word planes are ``torch.int32`` carriers)."""
    word &= 0xFFFFFFFF
    return word - (1 << 32) if word >= 1 << 31 else word


def apply_exchange_fault(recv: list[tuple[torch.Tensor, ...]],
                         recv_cnt: list[torch.Tensor],
                         ) -> tuple[list[tuple[torch.Tensor, ...]], list[torch.Tensor]]:
    """Exchange hook (``collectives.ragged_all_to_all``, after the payload
    transport and the ``pre_exchange`` window): apply the pending
    exchange fault, if any, to this exchange, the first of the armed
    dispatch.  ``recv`` holds per rank its ``[P, cap]`` word planes,
    ``recv_cnt`` per rank its int32[P] counts.  The reference applies it
    inside its SPMD program, so it lands on every rank: ``exchange_drop``
    zeroes every rank's count from peer 0, ``exchange_corrupt`` XORs
    lane (0, 0) of every rank's first word plane.  The faulted planes
    are copies; no-op when nothing is pending."""
    if not _PENDING_EXCHANGE:
        return recv, recv_cnt
    spec = _PENDING_EXCHANGE.pop()
    if spec["site"] == "exchange_drop":
        dropped = []
        for c in recv_cnt:
            c = c.clone()
            c[0] = 0
            dropped.append(c)
        return recv, dropped
    word = _as_int32(spec["word"])
    out = []
    for planes in recv:
        w0 = planes[0].clone()
        w0[0, 0] ^= word
        out.append((w0,) + tuple(planes[1:]))
    return out, recv_cnt


def maybe_poison_chunk(words: tuple[np.ndarray, ...],
                       chunk_idx: int) -> tuple[np.ndarray, ...]:
    """Ingest-pipeline hook (worker threads): corrupt CHUNK 0's first
    encoded word AFTER the fingerprint fold, so the device receives data
    the fingerprint never saw and the output verifier must flag it.
    Pinned to chunk 0 (one budget unit per stream pass): the encode
    workers race on the budget otherwise, and which chunk got poisoned
    would depend on thread scheduling."""
    if chunk_idx != 0:
        return words
    reg = current()
    if reg is None or not reg.would_fire("ingest_poison"):
        return words
    word = reg.rand_word()
    if not reg.fire("ingest_poison", chunk=chunk_idx, word=word):
        return words
    w0 = words[0].copy()
    if w0.size:
        w0[0] ^= word & 0xFFFFFFFF
    return (w0,) + tuple(words[1:])


def maybe_corrupt_spill(raw: bytes) -> bytes:
    """Spill-run hook (``store/runs.py`` write path): corrupt the first
    key bytes of a run AFTER its fingerprint sidecar folded the clean
    words; the merge's read-back fold must flag the on-disk bytes."""
    reg = current()
    if reg is None or not reg.would_fire("spill_corrupt"):
        return raw
    word = reg.rand_word()
    if not reg.fire("spill_corrupt", word=word):
        return raw
    buf = bytearray(raw)
    if len(buf) >= 4:
        for i in range(4):
            buf[i] ^= (word >> (8 * i)) & 0xFF
    return bytes(buf)


def should_drop_merge_chunk(chunk_idx: int, n: int) -> bool:
    """Merge hook (``store/merge.py`` emit path): True when the armed
    ``merge_drop`` site consumes this output chunk; it vanishes from the
    merged output and its fold, so the external sort's count and
    fingerprint comparison against the run sidecars must trip."""
    reg = current()
    if reg is None or not reg.would_fire("merge_drop"):
        return False
    return reg.fire("merge_drop", chunk=chunk_idx, n=n)


def spill_tear_bytes(body_bytes: int) -> int:
    """Spill-commit hook (``store/runs.py`` close path): tail bytes to
    chop off the run's key file (0 = clean).  The sidecar and any
    manifest line already promise the full length, so the torn run is
    caught structurally and re-spilled, or discarded by resume."""
    reg = current()
    if reg is None or body_bytes <= 0 \
            or not reg.would_fire("spill_torn_write"):
        return 0
    word = reg.rand_word()
    cut = min(1 + (word % 7), body_bytes)
    if not reg.fire("spill_torn_write", cut=cut, body=body_bytes):
        return 0
    return cut


def spill_bitrot_word() -> int | None:
    """Post-commit bit-rot hook (``store/runs.py`` close path): a nonzero
    word to XOR into the middle of the run's key body after the durable
    commit, or None when clean; the merge's read-back fold (and resume's
    ``verify_run``) must flag it."""
    reg = current()
    if reg is None or not reg.would_fire("spill_bitrot"):
        return None
    word = reg.rand_word()
    if not reg.fire("spill_bitrot", word=word):
        return None
    return word


def spill_block_garbage_word() -> int | None:
    """Post-commit block-garbage hook (``store/runs.py`` close path,
    compressed SORTRUN2 runs only): a word whose firing scrambles the
    middle block's header after the commit, or None when clean.  The
    reader must raise the typed block-corruption error naming the run
    and block, and the merge must re-spill the run."""
    reg = current()
    if reg is None or not reg.would_fire("spill_block_garbage"):
        return None
    word = reg.rand_word()
    if not reg.fire("spill_block_garbage", word=word):
        return None
    return word


def maybe_spill_enospc(nbytes: int) -> None:
    """Spill-write hook (``store/runs.py`` append path): raise a real
    ``OSError(ENOSPC)`` at the Nth write opportunity
    (``SORT_FAULT_ENOSPC_AT``, 1-based), the volume-full shape the
    external sort must turn into its typed capacity error."""
    reg = current()
    if reg is None or not reg.would_fire("spill_enospc"):
        return
    at = int(knobs.get("SORT_FAULT_ENOSPC_AT"))
    seen = int(getattr(reg, "_enospc_writes", 0)) + 1
    reg._enospc_writes = seen  # type: ignore[attr-defined]
    if seen < at:
        return
    if reg.fire("spill_enospc", write=seen, bytes=nbytes):
        raise OSError(errno.ENOSPC,
                      "No space left on device (injected spill_enospc)")


def manifest_tear_cut(line_len: int) -> int:
    """Manifest-journal hook (``store/manifest.py`` commit path): tail
    bytes of this journal line that never reach disk (0 = clean), the
    crashed-mid-append shape replay must skip loudly."""
    reg = current()
    if reg is None or line_len <= 1 \
            or not reg.would_fire("manifest_torn"):
        return 0
    cut = max(1, line_len // 2)
    if not reg.fire("manifest_torn", cut=cut, line_len=line_len):
        return 0
    return cut


def maybe_merge_stall() -> None:
    """Merge-entry hook (``store/external.py``): block the merging thread
    for ``SORT_FAULT_STALL_MS``, a merge wedged on a dying disk (every
    run is committed by then, so a kill here resumes at the merge)."""
    reg = current()
    if reg is None or not reg.would_fire("merge_stall"):
        return
    ms = int(knobs.get("SORT_FAULT_STALL_MS"))
    if reg.fire("merge_stall", ms=ms):
        time.sleep(ms / 1e3)


def maybe_corrupt_result(reg: FaultRegistry | None,
                         res: DistributedSortResult) -> DistributedSortResult:
    """Result hook (before verification): swap the endpoints (breaks
    sortedness) or duplicate a key (moves only the multiset fingerprint).

    The reference indexes its global padded array: it swaps element 0
    with element ``min(n_valid, size) - 1`` and copies element 0 over
    element 1.  The port's result holds per-rank shards of equal size
    (``n`` slots a rank for radix, ``shard_slots`` for sample), so global
    element ``i`` is shard ``i // slots``, offset ``i % slots``; for sample
    sort that is often a pad or a middle key, as in the reference.  The
    touched shards are replaced by corrupted copies."""
    if reg is None:
        return res
    for site in ("result_swap", "result_dup"):
        if reg.sites.get(site) and reg.sites[site].remaining > 0:
            if not reg.fire(site):
                continue
            shards = [list(s) for s in res.shards]
            slots = int(shards[0][0].numel()) if shards and shards[0] else 0
            size = slots * len(shards)
            if size >= 2:
                a, b = ((0, min(res.n_valid, size) - 1) if site == "result_swap"
                        else (0, 1))
                (ra, oa), (rb, ob) = divmod(a, slots), divmod(b, slots)
                for k in range(len(shards[0])):
                    for r in {ra, rb}:
                        shards[r][k] = shards[r][k].clone()
                    va = shards[ra][k][oa].clone()
                    vb = shards[rb][k][ob].clone()
                    if site == "result_swap":
                        shards[ra][k][oa] = vb
                    shards[rb][k][ob] = va
            res.shards = tuple(tuple(s) for s in shards)
            if res.words:
                res.words = res.shards[0]
            break
    return res
