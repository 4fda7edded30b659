"""Public sort API (port of ``mpitest_tpu/models/api.py``).

``sort(x)`` without a mesh runs the reference's one-rank path
(``_sort_impl``, ``api.py:1469-1562``): encode the keys to
order-preserving uint32 words, sort them locally, verify sortedness and
the multiset fingerprint, and decode back to the input dtype.  A numpy
array is the host path (host encode + fingerprint, one copy to the
card); a ``torch.Tensor`` is the device-resident path (encode and
fingerprint on its device).

``sort(x, mesh=make_mesh(P))`` with P > 1 runs the distributed branch
(``api.py:1564-2028``): the keys are padded to ``P*n`` with the maximum
key (the all-ones word for floats) and split into per-rank shards, and
``algorithm="radix"`` (LSD radix, ``models/radix_sort.py``) or
``"sample"`` (``models/sample_sort.py``) sorts them across the ranks.
Capacity negotiation sizes the exchange from a count probe
(``SORT_NEGOTIATE``), a skewed arrangement is re-staged by interleaving
the shards (``SORT_RESTAGE``, ``SORT_RESTAGE_RATIO``), the supervisor's
loop regrows an overflowing cap, and sample sort reroutes to radix when
its splitters degenerate (host or device sniff, probe estimate, or a
late cap overflow; counter ``sample_skew_fallback``).  The exchange
engine (``SORT_EXCHANGE_ENGINE``) resolves ``auto`` to ``pallas``: the
fused pack (K6) and the rank-to-rank all-to-all (K7); ``lax`` packs each
plane with K5 and moves it with per-block copies.  Caps align to the
pack's chunk (1024) as the reference's do on a TPU.

The call runs on ``cuda`` unless the caller passes ``device="cpu"`` (or
a mesh of ``cpu`` ranks); with no device given and no CUDA available it
raises.  On the CPU every kernel wrapper runs its plain PyTorch version,
so the CPU walks the same routing tree as the card.

Engine routing copies the reference's TPU decisions: ``auto`` means the
bitonic engine for n >= 2^13; the break-even rule (``n*10 < n_pow2*6``)
and the 64-bit constant-word shortcut, hi-duplication sniff and residual
fallback keep their counters (``local_engine``, ``pair_dup_reroute``,
``pair_residual_fallback``) and names (:data:`_PAIR_CODES`).
``radix_pallas`` sends keys of <= 2^20 elements and <= 4 words to the
fused radix kernel (K4) and larger ones to ``lax``; host input compacts
its pass plan from the words' ranges, device input runs the full plan,
and 64-bit keys with n >= 2^13 keep the pair route (whose device form
sorts a lone varying word with the bitonic engine, its host form with
K4).  Inside the distributed radix, ``radix_pallas`` runs pass 1 with
K4; inside sample sort the resolved engine sorts the shards and the
merge.

Host input of at least ``models/ingest.STREAM_MIN_BYTES`` on more than
one rank streams (``SORT_INGEST``): chunked encode on host threads, pinned
copies on a side stream into preallocated shards, the pass planner's
diffs and the fingerprint folded in flight.  :func:`ingest_to_mesh` runs
the same pipeline ahead of the sort and returns a :class:`StagedIngest`,
which ``sort`` takes in place of keys (on one rank: one local sort of the
staged words).  ``SORT_DONATE`` (auto: on a card) drops the staged words
once the first dispatch has read them; a rerun rebuilds them.  A
contiguous result of several shards streams its egress
(``DistributedSortResult.to_numpy(tracer)``).  ``payload=`` is the
record sort of ``models/records.py``.

Telemetry: the run's spans land on ``tracer.spans`` (nested phases, the
first-call/later-call split of every program dispatch, one span per radix
pass and splitter round, point events with byte counts per collective,
and the ``sort`` span's ``device_mem_peak_bytes``); ``SORT_TRACE=<path>``
streams them as JSONL.  Host spans time the enqueue of CUDA work, and
tracing adds no synchronisation (``utils/spans.py``).  A typed error
leaving ``sort()`` dumps the flight recorder's ring first.

Robustness (``models/supervisor.py``, ``faults.py``): every distributed
dispatch runs under the supervisor's retry budget, and a result that
fails verification, or a rung whose dispatch keeps failing, descends the
reference's degradation ladder (``SORT_FALLBACK``): the ``radix_pallas``
local engine to ``lax``, the ``pallas`` exchange engine to ``lax``, the
other algorithm, then the host ``np.lexsort``; each rung gets one
verification retry on re-staged input.  The ladder absorbs
``DeviceDispatchError`` and ``torch.cuda.OutOfMemoryError`` only: a kernel
that fails to build or launch, or any other CUDA error, propagates.
``SORT_FAULTS`` (or an installed :class:`faults.FaultRegistry`) injects
faults at the reference's sites.  The one-rank paths keep no ladder, as
in the reference: a failed verification raises
:class:`SortIntegrityError`.

Plan provenance (``models/plan.py``, ``SORT_PLAN``, default on): every
run mints one :class:`~mpitest_tpu_torch.models.plan.SortPlan` on its
tracer; the algo, cap, restage, engine, exchange engine, passes and
ladder decisions are stamped where the reference stamps them (the
supervisor stamps retries and regrows), and the run ends with the
registered ``sort.plan`` point event and the ``plan_regret`` /
``plan_cap_regret`` counters.  The engine decision's ``backend`` actual
is the ranks' ``torch.device`` type.  The self-tuning planner
(``models/planner.py``, ``SORT_PLANNER``, default off) scores the host
input's strided profile: under ``on`` a sorted profile verifies the
staged words as the result (``verify_passthrough``; a miss counts
``planner_passthrough_miss`` and the ladder sorts for real), near-sorted
input takes the sample sort, duplicate-heavy and range-narrow input the
radix sort, and the sample probe's margin is learned from the flight
ring; ``shadow`` records the choice without acting.
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Callable, Iterable
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from mpitest_tpu_torch import faults
from mpitest_tpu_torch.models import plan as plan_mod
from mpitest_tpu_torch.models import planner as planner_mod
from mpitest_tpu_torch.models import radix_sort, sample_sort
from mpitest_tpu_torch.models.ingest import (
    EGRESS_MIN_BYTES,
    StagedIngest,
    stream_result_to_numpy,
    stream_to_mesh,
    use_stream,
)
from mpitest_tpu_torch.models import supervisor as supervision
from mpitest_tpu_torch.models import verify as vfy
from mpitest_tpu_torch.models.supervisor import (  # re-exported: public errors
    ExchangeCapExceeded,
    SortFaultError,
    SortIntegrityError,
    SortRetryExhausted,
    SortSupervisor,
)
from mpitest_tpu_torch.ops import bitonic, exchange, kernels, radix
from mpitest_tpu_torch.ops.keys import (
    KeyCodec,
    codec_for,
    numpy_dtype,
    to_device_words,
    to_host_words,
    unsigned_order,
)
from mpitest_tpu_torch.ops.pack import CHUNK
from mpitest_tpu_torch.parallel.mesh import Mesh
from mpitest_tpu_torch.utils import flight_recorder
from mpitest_tpu_torch.utils import io as kio
from mpitest_tpu_torch.utils import knobs, spans
from mpitest_tpu_torch.utils.trace import Tracer

__all__ = ["DistributedSortResult", "SortFaultError", "SortIntegrityError",
           "SortRetryExhausted", "StagedIngest", "ingest_to_mesh",
           "resolve_device", "sort"]

Words = tuple[torch.Tensor, ...]

#: Program keys this process has run at least once: the first call of a
#: key (a label plus the static shape the reference's jit cache keys on)
#: is ``jit_compile_execute`` and pays the kernel build and load where
#: they happen (``ops/_build.py``); later calls are ``jit_execute``.
_warm_programs: set[tuple] = set()


def _traced_call(tracer: Tracer, label: str, key: tuple, fn: Callable[..., Any],
                 *args: Any, **attrs: object) -> Any:
    """Call ``fn(*args)`` under a span that separates the first call of the
    program key ``(label,) + key`` from later ones (the reference's
    compile/execute split).  The span times the enqueue of the call's CUDA
    work, not its execution."""
    prog = (label,) + tuple(key)
    first = prog not in _warm_programs
    name = "jit_compile_execute" if first else "jit_execute"
    with tracer.spans.span(name, label=label, **attrs):
        out = fn(*args)
    if first:
        _warm_programs.add(prog)
        tracer.count("jit_first_calls", 1)
    return out


def _dtype_name(x: Any) -> str | None:
    """The input's dtype by its numpy name (``"int32"``, also for a
    ``torch.dtype``), the form span attributes carry; None without one."""
    dt = getattr(x, "dtype", None)
    if dt is None:
        return None
    if isinstance(dt, torch.dtype):
        try:
            return numpy_dtype(dt).name
        except (KeyError, TypeError, ValueError):
            return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def device_mem_peak(mesh: Mesh | None) -> int:
    """Peak card memory high-water over the mesh's CUDA devices (every card
    of the process without a mesh): the largest
    ``torch.cuda.max_memory_allocated`` among them, 0 when none is a card.
    A process-lifetime high-water like the reference's
    ``peak_bytes_in_use``, never reset here; reading it needs no sync.
    Never raises."""
    try:
        if mesh is not None:
            devices: Iterable[torch.device] = mesh.devices
        elif torch.cuda.is_available():
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            return 0
        cards = {d for d in devices if d.type == "cuda"}
        return max((int(torch.cuda.max_memory_allocated(d)) for d in cards),
                   default=0)
    except Exception:  # noqa: BLE001 — telemetry never breaks the sort
        return 0


def _device_mem_high_water(span: Any, mesh: Mesh) -> None:
    """Attach :func:`device_mem_peak` to ``span`` when nonzero."""
    peak = device_mem_peak(mesh)
    if peak:
        span.attrs["device_mem_peak_bytes"] = peak


@dataclass
class DistributedSortResult:
    """Sorted word planes on the card(s); decoded lazily on demand.

    A one-rank result holds its planes in ``words``.  A mesh result holds
    one word tuple per rank in ``shards`` (``words`` is then empty): the
    radix layout is contiguous (rank r's n keys follow rank r-1's); the
    sample layout is ragged, rank r's first ``counts[r]`` of its
    ``shard_slots`` slots being its valid run."""

    words: Words
    n_valid: int                     # real keys (excludes padding)
    dtype: np.dtype
    counts: np.ndarray | None = None  # per-shard valid counts (ragged layouts)
    shard_slots: int | None = None    # slots per shard for ragged layouts
    shards: tuple[Words, ...] | None = None

    def __post_init__(self) -> None:
        if self.shards is None:
            self.shards = (tuple(self.words),)

    def _valid(self) -> list[int]:
        if self.counts is None:
            return [int(s[0].numel()) if s else 0 for s in self.shards]
        return [int(c) for c in self.counts]

    def to_numpy(self, tracer: Tracer | None = None) -> np.ndarray:
        """The valid keys on the host.  A contiguous result of more than
        one shard streams its egress (``models/ingest.py``) under
        ``SORT_INGEST=stream``, or under ``auto`` from
        :data:`EGRESS_MIN_BYTES` of keys: shard k+1 copies to the host
        while shard k decodes (``egress.*`` spans on ``tracer``).  Ragged
        (sample) results and ``mono`` take the plain gather."""
        if self.n_valid == 0:
            return np.empty(0, self.dtype)
        codec = codec_for(self.dtype)
        if self.counts is None and len(self.shards) > 1:
            mode = kio.ingest_mode()
            nbytes = self.n_valid * np.dtype(self.dtype).itemsize
            if mode == "stream" or (mode == "auto" and nbytes >= EGRESS_MIN_BYTES):
                return stream_result_to_numpy(self.shards, self.n_valid,
                                              self.dtype, tracer=tracer)
        parts = [tuple(to_host_words(w[:v]) for w in shard)
                 for shard, v in zip(self.shards, self._valid())]
        return codec.decode(tuple(np.concatenate([p[k] for p in parts])[: self.n_valid]
                                  for k in range(codec.n_words)))

    def median_probe_raw(self) -> Any:
        """The (n/2)-th sorted element as a native-dtype scalar (exact
        bits); one element crosses to the host."""
        idx = self.n_valid // 2 - 1
        if idx < 0:
            raise ValueError("median probe undefined for < 2 keys")
        for shard, v in zip(self.shards, self._valid()):
            if idx < v:
                break
            idx -= v
        codec = codec_for(self.dtype)
        return codec.decode(tuple(to_host_words(w[idx: idx + 1]) for w in shard))[0]

    def median_probe(self) -> int:
        """The reference's correctness probe: the (n/2)-th sorted element
        (``int_buf[size_input / 2 - 1]``, mpi_sample_sort.c:205)."""
        return int(self.median_probe_raw())


def _host_hi_dup_sniff(hi: np.ndarray) -> bool:
    """Hi-duplication sniff over a ~1024-key sample of host words."""
    n = hi.size
    s = min(1024, n)
    idx = np.linspace(0, n - 1, s).astype(np.int64)
    samp = np.sort(hi[idx])
    return bool(np.any(samp[1:] == samp[:-1]))


def _device_hi_dup_sniff(hi: torch.Tensor) -> bool:
    """The same sniff over device words, with the reference device
    program's strided sample (``_compile_pair_fused``)."""
    n = hi.numel()
    s = min(1024, n)
    if s <= 1:
        return False
    stride = -(-(n - 1) // (s - 1))  # ceil: sample stays <= s picks
    s_eff = (n - 1) // stride + 1
    start = (n - 1) - (s_eff - 1) * stride
    samp = torch.sort(hi[start: start + (s_eff - 1) * stride + 1: stride]).values
    return bool(torch.any(samp[1:] == samp[:-1]))


#: Engine names of the 64-bit routes, by the reference's codes.
_PAIR_CODES = {0: "constant", 1: "bitonic_1w1", 2: "bitonic_1w0",
               3: "lax", 4: "bitonic_pair", 5: "bitonic_pair+lax_fallback"}


def _local_engine() -> str:
    """``SORT_LOCAL_ENGINE={auto,bitonic,lax,radix_pallas}``."""
    return supervision.local_engine_knob()


def _word_diffs(words: tuple[np.ndarray, ...]) -> tuple[int, ...]:
    """Per-word ``max ^ min`` of host key words (msw first) — the input
    of pass planning; empty input has no differing bits."""
    if words[0].size == 0:
        return (0,) * len(words)
    return tuple(int(w.max()) ^ int(w.min()) for w in words)


def _use_bitonic(engine: str, n_words: int, n: int) -> bool:
    if n_words > 2:
        return False  # wider keys keep the plain sort
    if engine == "bitonic":
        return True
    return engine == "auto" and n >= (1 << bitonic.MIN_SORT_LOG2)


def _use_fused(engine: str, n_words: int, n: int) -> bool:
    """The fused radix engine takes this dispatch: the knob asked for it
    and the key fits the reference's envelope (the CUDA pass has none of
    its own; the envelope keeps the engine users get the same)."""
    return (engine == "radix_pallas" and n_words <= radix.FUSED_MAX_WORDS
            and n <= radix.FUSED_MAX_ELEMS)


def _resolve_local_engine(engine: str, n_words: int, n: int) -> str:
    """Concrete engine for one dispatch: ``radix_pallas``, ``bitonic`` or
    ``lax``."""
    if engine == "radix_pallas":
        return "radix_pallas" if _use_fused(engine, n_words, n) else "lax"
    return "bitonic" if _use_bitonic(engine, n_words, n) else "lax"


def _local_pair_sort(x: Any, is_device: bool, codec: KeyCodec,
                     device: torch.device, tracer: Tracer,
                     words_np: tuple[np.ndarray, ...] | None = None,
                     ) -> tuple[torch.Tensor, ...]:
    """Single-card 64-bit sort orchestration, adaptive like the reference:

    1. constant-word shortcut: a word with zero range never moves; the
       1-word engine sorts the other word.
    2. hi-duplication sniff: heavy duplication would leave equal-hi runs
       longer than the run fix-up depth, so it goes to the ``lax`` sort.
    3. pair engine (``kernels.sort_two_words_bitonic``, K2 + K3); the
       residual flag (runs the sniff missed) falls back to the ``lax``
       sort — correctness never depends on the sniff.

    Device-resident input takes the reference device program's sniff
    sample, sorts a lone varying word with the bitonic engine whatever the
    knob (the reference's fused device program does), and reports the
    fused fallback as ``bitonic_pair+lax_fallback``; host input takes the
    host sniff and the knob's one-word engine (under ``radix_pallas`` the
    full-plan K4 inside its envelope).  Returns the sorted device words."""
    n = x.numel() if is_device else np.asarray(x).size
    one_w = "bitonic" if is_device else _resolve_local_engine(_local_engine(), 1, n)
    if is_device:
        with tracer.phase("encode"):
            words = codec.encode_torch(x.reshape(-1))
            same = tuple(bool(torch.all(w == w[0])) for w in words)
            dup = _device_hi_dup_sniff(words[0])
    else:
        with tracer.phase("encode"):
            if words_np is None:
                words_np = codec.encode(np.asarray(x).reshape(-1))
            same = tuple(bool(w.min() == w.max()) for w in words_np)
            dup = _host_hi_dup_sniff(words_np[0])
        with tracer.phase("device_put"):
            words = tuple(to_device_words(w, device) for w in words_np)
    if all(same):  # all keys identical: already sorted
        tracer.counters["local_engine"] = _PAIR_CODES[0]
        return words
    key = (n, device.type)
    for const_w, sort_w in ((0, 1), (1, 0)):
        if same[const_w]:
            tracer.counters["local_engine"] = f"bitonic_1w{sort_w}"
            with tracer.phase("sort"):
                s_out = _traced_call(tracer, "local_1w", key + (one_w,),
                                     kernels.local_sort, (words[sort_w],),
                                     one_w)[0]
            return (words[0], s_out) if sort_w == 1 else (s_out, words[1])
    if dup:
        tracer.counters["local_engine"] = _PAIR_CODES[3]
        tracer.count("pair_dup_reroute", 1)
        with tracer.phase("sort"):
            return _traced_call(tracer, "local_2w_lax", key, kernels.local_sort,
                                words, "lax")
    with tracer.phase("sort"):
        hi_s, lo_s, bad = _traced_call(tracer, "pair_sort", key,
                                       kernels.sort_two_words_bitonic, *words)
        bad = bool(bad)
    tracer.counters["local_engine"] = _PAIR_CODES[5 if bad and is_device else 4]
    if not bad:
        return (hi_s, lo_s)
    tracer.verbose("pair engine left residual runs (hi duplication the "
                   "sniff missed); falling back to the lax sort")
    tracer.count("pair_residual_fallback", 1)
    with tracer.phase("sort"):
        return _traced_call(tracer, "local_2w_lax", key, kernels.local_sort,
                            words, "lax")


def resolve_device(x: Any, device: torch.device | str | None) -> torch.device:
    """The device a sort runs on: ``device`` when given, else the card
    (the input's own card for a CUDA tensor).  Never the CPU by default."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        return x.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mpitest_tpu_torch.sort needs a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")


def _donation_enabled(devices: "tuple[torch.device, ...]") -> bool:
    """``SORT_DONATE`` (``utils.io.donate_setting``): ``auto`` donates when
    the ranks are on a card, where dropping the staged words lets the
    caching allocator reuse their memory (the reference donates on its
    accelerator only); ``1`` and ``0`` force it."""
    v = kio.donate_setting()
    if v == "auto":
        return any(d.type == "cuda" for d in devices)
    return v == "1"


def ingest_to_mesh(x: Any, mesh: Mesh | None = None, tracer: Tracer | None = None,
                   chunk_elems: int | None = None,
                   threads: int | None = None) -> StagedIngest:
    """Run the streamed ingest (``models/ingest.py``: chunked parse, encode
    and pinned copies on a side stream) over host keys ``x`` onto ``mesh``
    (default: one rank on the card) and return the :class:`StagedIngest`
    that :func:`sort` takes in place of raw keys.  The ``ingest.*`` spans
    land on ``tracer`` under an ``ingest`` span, streamed to ``SORT_TRACE``
    as in :func:`sort`."""
    if mesh is None:
        from mpitest_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(1)
    tracer = tracer or Tracer()
    _stream_trace(tracer)
    arr = np.asarray(x)
    reg = faults.for_run()
    supervision.wire_registry(reg, tracer)
    with tracer.spans.span("ingest", n=int(arr.size), dtype=str(arr.dtype)), \
            faults.active(reg):
        return stream_to_mesh(arr, mesh, tracer=tracer, chunk_elems=chunk_elems,
                              threads=threads)


def sort(x: Any, algorithm: str = "radix", mesh: Mesh | None = None,
         digit_bits: int | None = None, cap_factor: float = 2.0,
         oversample: int | None = None, tracer: Tracer | None = None,
         return_result: bool = False, pack: str | None = None,
         exchange_engine: str | None = None, payload: Any = None, *,
         device: torch.device | str | None = None) -> Any:
    """Sort keys on one card, or across the ranks of ``mesh``; returns a
    sorted numpy array (or the device-resident
    :class:`DistributedSortResult`).

    The positional parameters are the reference's, in its order;
    ``device`` is keyword-only.

    ``x`` is a host array (numpy or anything ``np.asarray`` takes), a
    ``torch.Tensor`` (device-resident keys; moved to ``device``, or to the
    mesh's first rank, if it lies elsewhere), or a :class:`StagedIngest`
    from :func:`ingest_to_mesh` (encoded, padded words on its own mesh).
    2-D input flattens.  A host array of at least 32 MiB on more than one
    rank streams through the same pipeline (``SORT_INGEST``:
    auto/stream/mono).  Under ``SORT_DONATE`` (auto: on a card) the sort
    drops staged words once its first dispatch has read them; a
    :class:`StagedIngest` is then single-use (``consumed``).
    ``algorithm`` is ``"radix"`` or ``"sample"``; on one rank both take
    the same local path, as in the reference.  ``mesh``
    (``parallel.mesh.make_mesh``) with more than one rank runs the
    distributed sort; a one-rank mesh is the one-rank path on its device.
    The distributed knobs are the reference's: ``digit_bits`` (radix digit
    width, default auto), ``cap_factor`` (initial exchange cap in fair
    shares) and ``oversample`` (splitter samples per shard, default
    2P-1).  ``tracer`` collects counters and spans.  Every result is
    verified (``SORT_VERIFY``, default on); on more than one rank a
    failure descends the degradation ladder (``SORT_FALLBACK``), and a
    result that never verifies raises :class:`SortIntegrityError`, a
    dispatch that keeps failing :class:`SortRetryExhausted`.  ``return_result`` keeps the result on
    the card.  ``pack`` is ``"pallas"`` (K5, the default) or ``"xla"``
    (plain scatter), and ``exchange_engine`` defaults to the
    ``SORT_EXCHANGE_ENGINE`` knob.

    ``payload`` turns the call into a record sort
    (``models/records.py``): each key carries an opaque payload (bytes,
    an ``(n, width)`` uint8 matrix, or any fixed-itemsize array of n
    elements) permuted with the keys, stable by key, verified by the
    record fingerprint; the call returns ``(sorted_keys, sorted_payload)``
    with the payload as an ``(n, width)`` uint8 matrix, and
    ``return_result`` and ``exchange_engine`` do not apply.

    ``device`` names the card (or ``"cpu"``) of a run without a mesh;
    ``device`` and ``mesh`` exclude each other.

    ``SORT_TRACE=<path>`` streams the run's spans as JSONL; a typed error
    (:class:`SortFaultError`) leaving the call dumps the flight recorder's
    ring (``SORT_FLIGHT_RECORDER_DIR``) before it propagates."""
    if algorithm not in ("radix", "sample"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if mesh is not None and device is not None:
        raise ValueError("pass either device or mesh, not both")
    tracer = tracer or Tracer()
    _stream_trace(tracer)
    if payload is not None:
        from mpitest_tpu_torch.models import records

        # the record path mints no plan: a reused tracer must not carry
        # an earlier run's record
        tracer.plan = None
        arr = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
               else np.asarray(x))
        with tracer.spans.span("sort", algorithm="records", n=int(arr.size),
                               dtype=str(arr.dtype)):
            return records.sort_records(arr, payload, mesh=mesh, tracer=tracer,
                                        device=device)
    if isinstance(x, StagedIngest):
        if x.consumed:
            raise ValueError(
                "StagedIngest was already consumed by a donated sort "
                "dispatch (its word buffers were released); call "
                ".rebuild() or ingest_to_mesh() again for another sort")
        if device is not None:
            raise ValueError("a StagedIngest sorts on its own mesh; do not "
                             "pass device")
        if mesh is None:
            mesh = x.mesh
        elif mesh != x.mesh:
            raise ValueError("StagedIngest was streamed onto a different mesh")
        n = x.n_valid
    else:
        size = getattr(x, "numel", None)
        n = int(size()) if callable(size) else int(np.asarray(x).size)
    # the run's fault registry (SORT_FAULTS or an installed one), active
    # for the whole run so the ingest and exchange hooks see it
    reg = faults.for_run()
    supervision.wire_registry(reg, tracer)
    if mesh is not None and mesh.size > 1:
        run_mesh, where = mesh, {"ranks": mesh.size}

        def run() -> Any:
            return _sort_mesh(x, algorithm, mesh, tracer, return_result,
                              digit_bits, cap_factor, oversample, pack,
                              exchange_engine, reg)
    else:
        dev = resolve_device(x, mesh.devices[0] if mesh is not None else device)
        run_mesh, where = Mesh((dev,)), {"device": str(dev)}

        def run() -> Any:
            return _sort_impl(x, dev, tracer, return_result, exchange_engine,
                              algorithm)
    # one decision record per run, carried on the tracer so every
    # chokepoint below (and the supervisor) stamps into the same object
    plan = (plan_mod.SortPlan(algo=algorithm, dtype=_dtype_name(x))
            if plan_mod.enabled() else None)
    if plan is not None:
        # a reused tracer's counters accumulate: stamp this run's delta
        plan.fallbacks_base = int(tracer.counters.get("pair_residual_fallback", 0))
    tracer.plan = plan
    with tracer.spans.span("sort", algorithm=algorithm, n=n,
                           dtype=_dtype_name(x), **where) as sp, \
            faults.active(reg):
        try:
            out = run()
            _finish_plan(tracer, plan, run_mesh.devices[0].type)
        except SortFaultError as e:
            # a typed terminal error leaves an artifact: the ring's last
            # spans (this run's verdicts included), rate-limited per reason
            flight_recorder.dump_on_error(type(e).__name__)
            raise
        _device_mem_high_water(sp, run_mesh)
    return out


def _stream_trace(tracer: Tracer) -> None:
    """``SORT_TRACE=<path>``: stream the tracer's spans there, unless the
    caller already gave its log a stream."""
    trace_path = knobs.get("SORT_TRACE")
    if trace_path and tracer.spans.stream_path is None:
        tracer.spans.stream_path = trace_path


def _check_result(tracer: Tracer, res: DistributedSortResult,
                  fp: vfy.Fingerprint | None) -> bool:
    """Run the verifier on a result; True = verified."""
    with tracer.phase("verify"):
        sorted_ok, fp_ok = vfy.verify_result(res, fp)
    sorted_ok, fp_ok = bool(sorted_ok), bool(fp_ok)
    tracer.count("verify_runs", 1)
    tracer.spans.event("verify", ok=sorted_ok and fp_ok,
                       sorted_ok=sorted_ok, fp_ok=fp_ok, n=int(res.n_valid))
    if not (sorted_ok and fp_ok):
        tracer.verbose(f"output verification FAILED (sorted={sorted_ok}, "
                       f"fingerprint={fp_ok})")
    return sorted_ok and fp_ok


def _finish_plan(tracer: Tracer, plan: plan_mod.SortPlan | None,
                 backend: str) -> None:
    """Seal and emit the run's decision record: default the engine and
    restage decisions from what the counters know, fold the regrets, stamp
    ``plan_regret`` / ``plan_cap_regret`` into the counters and emit the
    registered ``sort.plan`` point event.  ``backend`` is the ranks'
    ``torch.device`` type, the engine decision's ``backend`` actual."""
    if plan is None:
        return
    c = tracer.counters
    engine = c.get("local_engine")
    if engine is not None:
        if "engine" in plan.decisions:
            plan.actual("engine", local_engine=str(engine))
        else:
            plan.decide("engine", chosen=str(engine))
        plan.actual("engine", backend=backend)
    fallbacks = (int(c.get("pair_residual_fallback", 0))
                 - int(getattr(plan, "fallbacks_base", 0)))
    if fallbacks > 0:
        plan.actual("engine", fallbacks=fallbacks)
    if plan.ranks and plan.ranks > 1 and "restage" not in plan.decisions:
        # never restaged: its regret is every regrow a re-stage would
        # have prevented (stamped by the supervisor)
        cap_d = plan.decisions.get("cap")
        plan.decide("restage", chosen=False)
        plan.actual("restage", regrows=(cap_d.actual.get("regrows", 0)
                                        if cap_d is not None else 0))
    total = plan.finalize()
    tracer.counters["plan_regret"] = total
    cap_d = plan.decisions.get("cap")
    if cap_d is not None and cap_d.regret is not None:
        tracer.counters["plan_cap_regret"] = cap_d.regret
    tracer.spans.event("sort.plan", **plan.to_attrs())
    tracer.plan = plan


@dataclass
class _PlannerVerdict:
    """The run's plan record (None under ``SORT_PLAN=off``) and what the
    planner decided: its mode, the scored choice (None when it did not
    run), the sample probe's margin and the algorithm after any reroute."""

    plan: plan_mod.SortPlan | None
    mode: str
    choice: planner_mod.PolicyChoice | None
    neg_margin: float
    algorithm: str

    def passthrough(self, verify_on: bool) -> bool:
        """Verify the staged input words as the result first."""
        return (self.choice is not None and self.mode == "on" and verify_on
                and self.choice.policy == "verify_passthrough")


def _plan_run(tracer: Tracer, algorithm: str, N: int, n_ranks: int,
              host_x: np.ndarray | None, verify_on: bool) -> _PlannerVerdict:
    """The run's plan record (size, ranks, the ``algo`` decision and, for
    host input, the strided profile) and the planner's verdict, as the
    reference's ``_sort_impl`` takes them before staging.  ``off`` runs
    nothing; ``shadow`` records the ``planner`` decision with
    ``applied=False``; ``on`` may reroute the algorithm, pre-record a
    compacted pass count and replace ``SAMPLE_NEG_MARGIN``."""
    plan = tracer.plan if isinstance(tracer.plan, plan_mod.SortPlan) else None
    verdict = _PlannerVerdict(plan, planner_mod.mode(), None, SAMPLE_NEG_MARGIN,
                              algorithm)
    if plan is None:
        return verdict
    plan.n = N
    plan.ranks = n_ranks
    plan.decide("algo", chosen=algorithm, requested=algorithm)
    if host_x is not None:
        # ~1k strided samples of the host keys: no extra key movement
        plan.profile.update(plan_mod.profile_host_array(host_x))
    if verdict.mode == "off":
        return verdict
    pchoice = verdict.choice = planner_mod.choose(plan.profile, algorithm,
                                                  verify_on=verify_on)
    # the margin steers only the sample negotiation: runs bound for radix
    # and runs without negotiation skip the flight-ring scan
    if ((pchoice.algo or algorithm) == "sample" and n_ranks > 1
            and supervision.negotiate_knob() != "off"):
        margin, margin_ev = planner_mod.learned_margin(SAMPLE_NEG_MARGIN)
    else:
        margin, margin_ev = SAMPLE_NEG_MARGIN, {}
    # the recorded policy: a learned margin is the planner's move when
    # the algo scorer chose nothing
    name = pchoice.policy
    if name == "static" and margin_ev.get("margin_learned"):
        name = "cap_margin"
    planner_mod.policy(name)  # a name outside the vocabulary raises
    plan.decide("planner", chosen=name, requested="static",
                trigger=pchoice.trigger, applied=(verdict.mode == "on"),
                algo=pchoice.algo, margin=round(margin, 4),
                **dict(pchoice.predicted, **margin_ev))
    tracer.counters["planner"] = verdict.mode
    tracer.counters["planner_policy"] = name
    if verdict.mode == "on":
        verdict.neg_margin = margin
        if pchoice.algo is not None and pchoice.algo != algorithm:
            plan.decide("algo", chosen=pchoice.algo, trigger="planner")
            verdict.algorithm = pchoice.algo
        if pchoice.policy == "radix_compact" and "passes" in pchoice.predicted:
            # the promised pass count; the radix run keeps it as the
            # prediction its "passes" regret is scored against
            passes = int(pchoice.predicted["passes"])
            plan.decide("passes", chosen=passes, trigger="planner",
                        passes=passes)
    return verdict


def _sort_impl(x: Any, device: torch.device, tracer: Tracer,
               return_result: bool, exchange_engine: str | None = None,
               algorithm: str = "radix") -> Any:
    """The one-rank branch of the reference's ``_sort_impl``."""
    if isinstance(x, StagedIngest):
        return _sort_staged_local(x, device, tracer, return_result, exchange_engine,
                                  algorithm)
    is_device = isinstance(x, torch.Tensor)
    if is_device:
        if x.device != device:
            x = x.to(device)
        dtype = numpy_dtype(x.dtype)
        N = int(x.numel())
    else:
        x = np.asarray(x)
        dtype = np.dtype(x.dtype)
        N = int(x.size)
    codec = codec_for(dtype)
    if N == 0:
        out = np.empty(0, dtype)
        return out if not return_result else DistributedSortResult((), 0, dtype)
    verify_on = supervision.verify_enabled()
    engine = _local_engine()
    # recorded on every run, exchange or not, as the reference does
    tracer.counters["exchange_engine"] = _resolve_exchange_engine(exchange_engine)
    verdict = _plan_run(tracer, algorithm, N, 1, None if is_device else x,
                        verify_on)
    plan = verdict.plan

    def _finish_local(res: DistributedSortResult,
                      fp: vfy.Fingerprint | None) -> Any:
        if plan is not None:
            # one rank has no ladder: the rung is the local path itself
            plan.decide("ladder", chosen="local")
        if verify_on and not _check_result(tracer, res, fp):
            raise SortIntegrityError(
                "single-device sort result failed verification")
        if return_result:
            return res
        with tracer.phase("decode"):
            return res.to_numpy(tracer=tracer)

    fp_in = None
    if (codec.n_words == 2 and engine != "lax"
            and N >= (1 << bitonic.MIN_SORT_LOG2)):
        words_np = None
        if is_device:
            if verify_on:
                fp_in = vfy.fingerprint_device_input(x, dtype)
        else:
            # encode once: the fingerprint and the pair sort share the words
            with tracer.phase("encode"):
                words_np = codec.encode(x.reshape(-1))
            if verify_on:
                with tracer.phase("verify"):
                    fp_in = vfy.fingerprint_host(words_np)
        out = _local_pair_sort(x, is_device, codec, device, tracer,
                               words_np=words_np)
        return _finish_local(DistributedSortResult(out, N, dtype), fp_in)

    resolved = _resolve_local_engine(engine, codec.n_words, N)
    tracer.counters["local_engine"] = resolved
    if is_device:
        if verify_on:
            fp_in = vfy.fingerprint_device_input(x, dtype)
        with tracer.phase("sort"):
            out = _traced_call(
                tracer, "local_device", (dtype.name, resolved, N, device.type),
                lambda: kernels.local_sort(codec.encode_torch(x.reshape(-1)),
                                           engine=resolved))
    else:
        with tracer.phase("encode"):
            words_np = codec.encode(x.reshape(-1))
        if verify_on:
            with tracer.phase("verify"):
                fp_in = vfy.fingerprint_host(words_np)
        with tracer.phase("device_put"):
            words = tuple(to_device_words(w, device) for w in words_np)
        # planner rung zero: the profile read fully sorted, so the input
        # words are a sort candidate; one verify replaces the sort when it
        # passes, and a miss costs that verify before the sort runs
        if verdict.passthrough(verify_on) and fp_in is not None:
            cand = DistributedSortResult(words, N, dtype)
            if _check_result(tracer, cand, fp_in):
                tracer.count("planner_passthrough", 1)
                if plan is not None:
                    plan.decide("ladder", chosen="passthrough")
                if return_result:
                    return cand
                with tracer.phase("decode"):
                    return cand.to_numpy(tracer=tracer)
            del cand
            tracer.count("planner_passthrough_miss", 1)
            if plan is not None:
                plan.actual("planner", misses=1)
        # fused-engine pass compaction: the host words are in hand, so the
        # per-word spread quantized to bit widths plans the passes
        diffs = (tuple((1 << int(d).bit_length()) - 1
                       for d in _word_diffs(words_np))
                 if resolved == "radix_pallas" else None)
        with tracer.phase("sort"):
            out = _traced_call(tracer, "local",
                               (codec.n_words, resolved, diffs, N, device.type),
                               kernels.local_sort, words, resolved, diffs)
    return _finish_local(DistributedSortResult(out, N, dtype), fp_in)


def _sort_staged_local(staged: StagedIngest, device: torch.device, tracer: Tracer,
                       return_result: bool, exchange_engine: str | None,
                       algorithm: str = "radix") -> Any:
    """The reference's staged one-rank route (``api.py:1452-1467``): one
    local sort of the staged words with the resolved engine (K1 for one
    word, the pair engine K2 + K3 with its residual fallback for two, K4
    under ``radix_pallas`` with the pass plan compacted from the
    ingest's ``word_diffs``), verified against the ingest's fingerprint.
    Under donation the staged words are dropped once the sort has read
    them."""
    dtype = staged.dtype
    codec = codec_for(dtype)
    N = staged.n_valid
    verify_on = supervision.verify_enabled()
    tracer.counters["exchange_engine"] = _resolve_exchange_engine(exchange_engine)
    # staged words carry no host profile: the planner chooses static
    plan = _plan_run(tracer, algorithm, N, 1, None, verify_on).plan
    words = staged.words[0]
    resolved = _resolve_local_engine(_local_engine(), codec.n_words,
                                     int(words[0].numel()))
    diffs = (tuple((1 << int(d).bit_length()) - 1 for d in staged.word_diffs)
             if resolved == "radix_pallas" and staged.word_diffs is not None
             else None)
    donate = _donation_enabled((device,))
    if donate:
        staged.consumed = True
    with tracer.phase("sort"):
        out = _traced_call(tracer, "local",
                           (codec.n_words, resolved, diffs,
                            int(words[0].numel()), device.type),
                           kernels.local_sort, words, resolved, diffs)
    if donate:
        staged.words = []
    del words   # the last reference here: the verifier runs without them
    res = DistributedSortResult(out, N, dtype)
    if plan is not None:
        plan.decide("ladder", chosen="local")
    if verify_on and not _check_result(tracer, res, staged.fingerprint):
        raise SortIntegrityError("single-device sort result failed verification")
    if return_result:
        return res
    with tracer.phase("decode"):
        return res.to_numpy(tracer=tracer)


# ------------------------------------------------------ the distributed branch


def _round_cap(c: int, align: int = 128) -> int:
    """Round a cap up to a multiple of ``align`` (128 for the plain
    scatter pack, :data:`CHUNK` for the kernel packs)."""
    return max(align, ((c + align - 1) // align) * align)


_PACK_IMPLS = ("xla", "pallas")


def _no_interpreter(knob: str, raw: str) -> knobs.KnobError:
    return knobs.KnobError(
        f"{knob}={raw!r}: the interpreter twin has no counterpart here; use "
        "'pallas' (the kernels on a card, their plain versions on the CPU)")


def _resolve_pack(pack: str | None) -> str:
    """Exchange-pack implementation of the ``lax`` engine: ``pallas`` (K5)
    unless the caller asks for the plain scatter (``xla``) — the
    reference's choice on a TPU."""
    if pack is None:
        return "pallas"
    if pack == "pallas_interpret":
        raise _no_interpreter("pack", pack)
    if pack not in _PACK_IMPLS:
        raise ValueError(f"unknown pack {pack!r}; use one of {_PACK_IMPLS}")
    return pack


def _cap_align(pack: str) -> int:
    return CHUNK if pack == "pallas" else 128


def _resolve_exchange_engine(engine: str | None) -> str:
    """Concrete exchange engine: ``None`` reads ``SORT_EXCHANGE_ENGINE``;
    ``auto`` is ``pallas`` (K6 + K7), as on the reference's TPU."""
    v = engine if engine is not None else supervision.exchange_engine_knob()
    if v == "pallas_interpret":
        raise _no_interpreter("SORT_EXCHANGE_ENGINE", v)
    if v == "auto":
        return "pallas"
    if v not in exchange.ENGINES:
        raise ValueError(f"unknown exchange engine {v!r}; use one of "
                         f"{('auto',) + exchange.ENGINES}")
    return v


def _engine_pack(pack_impl: str, engine: str) -> tuple[str, int]:
    """(effective pack, cap alignment): the pallas engine owns its fused
    pack (CHUNK-aligned caps); the lax engine keeps the resolved pack."""
    if exchange.is_pallas(engine):
        return engine, CHUNK
    return pack_impl, _cap_align(pack_impl)


def _passes_from_diffs(diffs: tuple[int, ...], digit_bits: int) -> int:
    """LSD passes needed for per-word ``max ^ min`` diffs (msw first):
    digits above the highest differing bit are skipped.  Digit alignment
    restarts at every 32-bit word, so the count is ``per_word`` a full
    word below the first non-constant one plus the digits covering that
    word's differing bits."""
    per_word = (32 + digit_bits - 1) // digit_bits
    for wi, x in enumerate(diffs):
        if x:
            below = len(diffs) - 1 - wi
            return min(below * per_word + math.ceil(x.bit_length() / digit_bits),
                       per_word * len(diffs))
    return 0


def _auto_digit_bits(diffs: tuple[int, ...]) -> int:
    """Auto digit width: 16 when it needs fewer passes than 8 (a pass
    costs one full sort whatever its digit width)."""
    return 16 if _passes_from_diffs(diffs, 16) < _passes_from_diffs(diffs, 8) else 8


#: Safety margin on the sample probe's ESTIMATED per-peer counts.
SAMPLE_NEG_MARGIN = 1.25

#: Recv-memory bound of the sample exchange in fair per-peer shares;
#: inputs needing more reroute to radix.
SAMPLE_CAP_LIMIT_FACTOR = 8


def _host_pad_words(codec: KeyCodec, flat: np.ndarray, dtype: np.dtype,
                    total: int) -> tuple[int, ...] | None:
    """Pad words for host input shorter than ``total``: the maximum real
    key, or the all-ones word for floats (``np.max`` is NaN-poisoned);
    None when no padding is needed."""
    if flat.size >= total:
        return None
    if dtype.kind == "f":
        return codec.max_sentinel()
    return tuple(int(w[0]) for w in codec.encode(np.asarray([flat.max()], dtype)))


def _shard_input(words_np: tuple[np.ndarray, ...], mesh: Mesh, n: int,
                 pad_words: tuple[int, ...] | None = None) -> list[Words]:
    """Host words padded to ``P*n`` and split into per-rank shards on the
    ranks' devices."""
    out = []
    for r, dev in enumerate(mesh.devices):
        shard = []
        for k, w in enumerate(words_np):
            piece = w[r * n: (r + 1) * n]
            if piece.size < n:
                piece = np.concatenate([piece, np.full(n - piece.size, pad_words[k],
                                                       np.uint32)])
            shard.append(to_device_words(piece, dev))
        out.append(tuple(shard))
    return out


def _max_key(words: Words) -> Words:
    """The lexicographically largest key of device words, as 1-element
    planes (one ordered reduction)."""
    return kernels.from_ordered_key(kernels._ordered_key(words).max().reshape(1),
                                    len(words))


def _device_shards(x: torch.Tensor, codec: KeyCodec, dtype: np.dtype,
                   mesh: Mesh, n: int) -> tuple[Words, list[Words]]:
    """Encode device keys where they lie, pad to ``P*n`` with the maximum
    key (the all-ones word for floats) and split into per-rank shards.
    Returns ``(unpadded words, shards)``."""
    words = codec.encode_torch(x.reshape(-1))
    N = words[0].numel()
    total = mesh.size * n
    if total > N:
        if dtype.kind == "f":
            pad = tuple(torch.full((1,), -1, dtype=torch.int32, device=x.device)
                        for _ in words)
        else:
            pad = _max_key(words)
        padded = tuple(torch.cat([w, p.expand(total - N)]) for w, p in zip(words, pad))
    else:
        padded = words
    shards = [tuple(w[r * n: (r + 1) * n].to(dev) for w in padded)
              for r, dev in enumerate(mesh.devices)]
    return words, shards


def _device_diffs(words: Words) -> tuple[int, ...]:
    """Per-word ``max ^ min`` (unsigned) of device words."""
    out = []
    for w in words:
        u = unsigned_order(w)
        out.append((int(u.min()) ^ int(u.max())) & 0xFFFFFFFF)
    return tuple(out)


def _sample_skew_sniff(words_np: tuple[np.ndarray, ...], n_ranks: int) -> bool:
    """Host skew sniff: would quantile splitters degenerate?  An evenly
    strided ~32P-key sample, sorted, and the P-1 quantile picks the SPMD
    program would take; two equal adjacent picks mean at least 2/P of the
    mass sits on one key, so the sort goes to radix up front."""
    n_total = words_np[0].size
    s = min(n_total, max(64, 32 * n_ranks))
    idx = np.linspace(0, n_total - 1, s).astype(np.int64)
    order = np.lexsort(tuple(w[idx] for w in reversed(words_np)))
    qpos = (np.arange(1, n_ranks) * s) // n_ranks
    picks = [tuple(int(w[idx[order[q]]]) for w in words_np) for q in qpos]
    return any(a == b for a, b in zip(picks, picks[1:]))


def _device_skew_sniff(shards: list[Words], n_valid: int, n_ranks: int) -> bool:
    """Device twin of :func:`_sample_skew_sniff`: the same verdict from a
    strided sample of the global key order over ``[0, n_valid)`` (its last
    pick is ``n_valid - 1``), gathered from the shards."""
    n = shards[0][0].numel()
    s = min(n_valid, max(64, 32 * n_ranks))
    start, stride, s = sample_sort._strided_sample(n_valid, s)
    qpos = (np.arange(1, n_ranks) * s) // n_ranks
    if qpos.size < 2:
        return False
    g = start + np.arange(s, dtype=np.int64) * stride
    dev0 = shards[0][0].device
    picks = []
    for k in range(len(shards[0])):
        parts = [shards[r][k][torch.from_numpy(g[g // n == r] - r * n).to(shards[r][k].device)]
                 for r in range(n_ranks)]
        picks.append(torch.cat([p.to(dev0) for p in parts]))
    q = torch.sort(kernels._ordered_key(tuple(picks))).values[torch.from_numpy(qpos).to(dev0)]
    return bool(torch.any(q[1:] == q[:-1]))


def _interleave(shards: list[Words], mesh: Mesh) -> list[Words]:
    """Skew re-stage: deal the global key array round-robin over the
    shards, ``new[j*n + i] = old[i*P + j]`` — a permutation, so the sorted
    output and the fingerprint are unchanged, while a clustered
    arrangement (sorted input) becomes one where every shard holds a
    stride of the whole distribution."""
    n, p = shards[0][0].numel(), mesh.size
    dev0 = shards[0][0].device
    out_planes = []
    for k in range(len(shards[0])):
        g = torch.cat([s[k].to(dev0) for s in shards])
        out_planes.append(g.view(n, p).t().reshape(-1))
    return [tuple(w[r * n: (r + 1) * n].to(dev) for w in out_planes)
            for r, dev in enumerate(mesh.devices)]


def _sort_mesh(x: Any, algorithm: str, mesh: Mesh, tracer: Tracer,
               return_result: bool, digit_bits: int | None, cap_factor: float,
               oversample: int | None, pack: str | None,
               exchange_engine: str | None,
               reg: faults.FaultRegistry | None = None) -> Any:
    """The distributed branch of the reference's ``_sort_impl``, with its
    supervisor and degradation ladder."""
    for dev in mesh.devices:
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"mesh rank on {dev} needs CUDA and none is available")
    staged = x if isinstance(x, StagedIngest) else None
    is_device = isinstance(x, torch.Tensor)
    if staged is not None:
        dtype = staged.dtype
        N = staged.n_valid
    elif is_device:
        if x.device not in mesh.devices:
            x = x.to(mesh.devices[0])
        dtype = numpy_dtype(x.dtype)
        N = int(x.numel())
    else:
        x = np.asarray(x)
        dtype = np.dtype(x.dtype)
        N = int(x.size)
    codec = codec_for(dtype)
    if N == 0:
        out = np.empty(0, dtype)
        return out if not return_result else DistributedSortResult((), 0, dtype)
    n_ranks = mesh.size
    n = max(1, math.ceil(N / n_ranks))
    # the engines are resolved once; the ladder may degrade them, and every
    # dispatch reads the current rung's from ``state``
    eng0 = _resolve_exchange_engine(exchange_engine)
    tracer.counters["exchange_engine"] = eng0
    leng0 = _local_engine()
    dev_type = mesh.devices[0].type
    verify_on = supervision.verify_enabled()
    # the plan record and the planner's verdict, before any staging: the
    # host profile comes from the keys before the streamed ingest takes them
    verdict = _plan_run(tracer, algorithm, N, n_ranks,
                        x if staged is None and not is_device else None, verify_on)
    algorithm, plan = verdict.algorithm, verdict.plan

    words_np = None
    dev_words: Words | None = None
    #: per-word max ^ min folded by a streamed ingest (the pass planner's
    #: input without another pass over the keys)
    plan_diffs: tuple[int, ...] | None = None
    #: input fingerprint folded from the host chunks of a streamed ingest
    #: (None when the ingest ran with verification off)
    stream_fp: vfy.Fingerprint | None = None
    #: re-creates the sharded words after a donated dispatch dropped them
    rebuild_words = None
    if staged is not None:
        words = staged.words
        plan_diffs = staged.word_diffs
        stream_fp = staged.fingerprint
        if staged.source is not None:
            rebuild_words = lambda: staged.rebuild().words  # noqa: E731
    elif is_device:
        with tracer.phase("encode"):
            dev_words, words = _traced_call(
                tracer, "encode_pad", (dtype.name, N, n_ranks, x.device.type),
                _device_shards, x, codec, dtype, mesh, n)
        rebuild_words = lambda: _device_shards(x, codec, dtype, mesh, n)[1]  # noqa: E731
    else:
        flat = x.reshape(-1)
        if use_stream(flat.nbytes):
            # streamed ingest: chunked encode overlapped with the copies,
            # the planner's diffs and the fingerprint folded in flight
            with tracer.phase("ingest"):
                st = stream_to_mesh(flat, mesh, tracer=tracer)
            words = st.words
            plan_diffs = st.word_diffs
            stream_fp = st.fingerprint
            rebuild_words = lambda: stream_to_mesh(flat, mesh, tracer=tracer).words  # noqa: E731
            del st
        else:
            with tracer.phase("encode"):
                words_np = codec.encode(flat)
                pad = _host_pad_words(codec, flat, dtype, n_ranks * n)
            with tracer.phase("device_put"):
                words = _shard_input(words_np, mesh, n, pad)
            rebuild_words = lambda: _shard_input(words_np, mesh, n, pad)  # noqa: E731

    pack_impl = _resolve_pack(pack)
    # caps align for the first rung's engine; a CHUNK-aligned cap stays
    # valid (128-aligned too) when the ladder degrades to lax
    _, align = _engine_pack(pack_impl, eng0)
    if plan is not None:
        # the pack that will run: the pallas engine owns its fused pack
        plan.decide("engine", chosen=_engine_pack(pack_impl, eng0)[0])
        plan.decide("exchange_engine", chosen=eng0)
    # drop the input words once a dispatch has read them, where that frees
    # card memory and the words can be rebuilt for a rerun
    donate = _donation_enabled(mesh.devices) and rebuild_words is not None
    if donate and staged is not None:
        staged.consumed = True
    sup = SortSupervisor(tracer, reg, plan=plan)
    input_fp = None
    if verify_on:
        with tracer.phase("verify"):
            if words_np is not None:
                input_fp = vfy.fingerprint_host(words_np)
            elif is_device:
                input_fp = vfy.fingerprint_device(words, N)
            else:   # staged or streamed: folded from the host chunks
                input_fp = stream_fp

    fair = max(1, -(-n // n_ranks))
    base_cap = _round_cap(int(n / n_ranks * cap_factor) + 1, align)
    skew_cap = _round_cap(min(n, SAMPLE_CAP_LIMIT_FACTOR * fair), align)
    if oversample is None:
        oversample = max(2 * n_ranks - 1, 8)
    oversample = min(oversample, n, 16_384)
    negotiate = supervision.negotiate_knob() != "off"
    restage_on = supervision.restage_knob() != "off"
    restage_ratio = knobs.get("SORT_RESTAGE_RATIO")
    state = {"words": words, "restaged": False, "plan": None,
             "eng": eng0, "leng": leng0}
    del words

    def live_words() -> list[Words]:
        """The input shards, rebuilt (and re-interleaved, if the run
        re-staged) after a donated dispatch dropped them."""
        if state["words"] is None:
            w = rebuild_words()
            if state["restaged"]:
                w = _interleave(w, mesh)
            state["words"] = w
        return state["words"]

    def mark_dead() -> None:
        nonlocal dev_words
        if donate:
            state["words"] = None
            dev_words = None
            if staged is not None:
                staged.words = []

    def force_restage() -> None:
        """After a failed verification the staged words themselves are
        suspect (an ingest fault corrupts them after the fingerprint
        fold): re-stage from the source even without donation."""
        if rebuild_words is not None:
            state["words"] = None

    def do_restage() -> None:
        if state["restaged"]:
            return
        with tracer.spans.span("restage", ranks=n_ranks, n=n):
            state["words"] = _traced_call(
                tracer, "interleave", (codec.n_words, n, n_ranks, dev_type),
                _interleave, live_words(), mesh)
        state["restaged"] = True
        tracer.count("skew_restage", 1)
        tracer.verbose("skew re-stage: interleaved shards to rebalance the exchange")

    def radix_plan() -> tuple[int, int]:
        if state["plan"] is None:
            with tracer.phase("plan"):
                if plan_diffs is not None:
                    diffs = plan_diffs
                elif words_np is not None:
                    diffs = _word_diffs(words_np)
                else:
                    diffs = _device_diffs(dev_words if dev_words is not None
                                          else codec.encode_torch(x.reshape(-1)))
                db = digit_bits if digit_bits is not None else _auto_digit_bits(diffs)
                state["plan"] = (db, _passes_from_diffs(diffs, db))
        return state["plan"]

    def balance(cnts: np.ndarray, label: str, exact: bool, negotiated: int) -> None:
        wpb = 4 * codec.n_words
        send = cnts.sum(axis=1) * wpb
        recv = cnts.sum(axis=0) * wpb
        rmean = float(recv.mean())
        recv_ratio = float(recv.max()) / rmean if rmean > 0 else 1.0
        peer_ratio = float(cnts.max()) / fair
        tracer.spans.event(
            "exchange_balance", algorithm=label, ranks=n_ranks, exact=exact,
            peer_max=int(cnts.max()), fair=fair, negotiated_cap=negotiated,
            worst_cap=n, send_bytes=[int(v) for v in send],
            recv_bytes=[int(v) for v in recv], recv_ratio=round(recv_ratio, 4),
            peer_ratio=round(peer_ratio, 4), restaged=state["restaged"],
            exchange_engine=state["eng"])
        tracer.counters["negotiated_cap"] = negotiated
        tracer.counters["worst_cap"] = n
        tracer.counters["exchange_balance_ratio"] = round(recv_ratio, 4)
        tracer.counters["exchange_peer_ratio"] = round(peer_ratio, 4)

    def probe(kind: str, db: int | None) -> np.ndarray:
        with tracer.phase("plan"):
            if kind == "radix":
                m = _traced_call(tracer, "radix_probe",
                                 (codec.n_words, n, db, n_ranks, dev_type),
                                 radix_sort.radix_probe_spmd, live_words(), db,
                                 n_ranks)
            else:
                m = _traced_call(tracer, "sample_probe",
                                 (codec.n_words, n, oversample, n_ranks, dev_type),
                                 sample_sort.sample_probe_spmd, live_words(),
                                 n_ranks, oversample)
            return m.cpu().numpy()

    def negotiate_counts(kind: str, db: int | None = None) -> np.ndarray:
        """The count probe; one re-stage (and re-probe) when the per-peer
        need crosses the re-stage ratio."""
        cnts = probe(kind, db)
        if plan is not None:
            # the probe's [P, P] counts are on the host already: the
            # profile's entropy and skew ride them for free
            plan.profile.update(plan_mod.profile_from_counts(cnts, fair))
        ratio = float(cnts.max()) / fair
        if restage_on and not state["restaged"] and ratio >= restage_ratio:
            tracer.verbose(f"{kind} probe: per-peer need {int(cnts.max())} >= "
                           f"{restage_ratio:g}x fair share {fair}; re-staging")
            if plan is not None:
                plan.decide("restage", chosen=True, trigger="probe",
                            peer_ratio=round(ratio, 4))
            do_restage()
            cnts = probe(kind, db)
            if plan is not None:
                plan.actual("restage", peer_ratio=round(float(cnts.max()) / fair, 4))
        return cnts

    def run_radix(cap0: int) -> DistributedSortResult:
        db, passes = radix_plan()
        eng = state["eng"]
        eff_pack, eff_align = _engine_pack(pack_impl, eng)
        tracer.counters["exchange_engine"] = eng
        leng = _resolve_local_engine(state["leng"], codec.n_words, n)
        radix_leng = leng if leng == "radix_pallas" else "lax"
        tracer.counters["local_engine"] = radix_leng
        if plan is not None:
            # a planner-predicted pass count (radix_compact) stays the
            # prediction; the chosen side is the real plan
            d_passes = plan.decisions.get("passes")
            keep = d_passes is not None and "passes" in d_passes.predicted
            plan.decide("passes", chosen=passes, digit_bits=db,
                        **({} if keep else {"passes": passes}))
        if negotiate and passes > 0:
            cnts = negotiate_counts("radix", db)
            need = _round_cap(int(cnts.max()), eff_align)
            # pass 1's need is exact; later passes keep the cap_factor floor
            cap0 = need if passes == 1 else max(need, cap0)
            if plan is not None:
                plan.decide("cap", chosen=cap0, trigger="exact", cap=cap0,
                            need=int(cnts.max()), fair=fair)
            balance(cnts, "radix", True, cap0)
        elif plan is not None:
            plan.decide("cap", chosen=cap0, trigger="off", cap=cap0, fair=fair)
        last_need: list[int | None] = [None]

        def attempt(c: int) -> tuple[object, int]:
            sup.arm_exchange()
            with tracer.phase("sort"):
                out, max_cnt = sup.dispatch("radix_spmd", lambda: _traced_call(
                    tracer, "radix_spmd",
                    (codec.n_words, n, db, c, passes, eff_pack, eng, radix_leng,
                     n_ranks, dev_type),
                    lambda: radix_sort.radix_sort_spmd(
                        live_words(), codec.n_words, db, n_ranks, c, passes,
                        pack=eff_pack, exchange_engine=eng,
                        local_engine=radix_leng),
                    n=n, cap=c, passes=passes, digit_bits=db, ranks=n_ranks),
                    on_retry=mark_dead)
                # the reference's dispatch consumes donated words: drop them
                # (this also stands in for its exchange_loop on_overflow)
                mark_dead()
                max_cnt = int(max_cnt)
            last_need[0] = max_cnt
            tracer.count("exchange_bytes",
                         passes * n_ranks * (n_ranks - 1) * c * 4 * codec.n_words)
            return out, max_cnt

        out, cap = sup.exchange_loop(
            "radix", attempt, sup.squeeze_cap(cap0, eff_align), eff_align,
            _round_cap, re_stage=do_restage if restage_on else None)
        tracer.count("exchange_passes", passes)
        tracer.counters["exchange_cap"] = cap
        tracer.counters["digit_bits"] = db
        if plan is not None:
            plan.actual("cap", cap=cap, need=last_need[0],
                        peer_recv_bytes=(last_need[0] or 0) * 4 * codec.n_words)
            plan.actual("passes", passes=passes)
        return DistributedSortResult((), N, dtype, shards=tuple(out))

    def reroute(why: str, trigger: str) -> DistributedSortResult:
        tracer.verbose(f"sample: {why}; routing to radix (skew-immune)")
        tracer.count("sample_skew_fallback", 1)
        if plan is not None:
            plan.decide("algo", chosen="radix", trigger=trigger)
            if trigger == "cap_exceeded":
                # the late reroute paid a full exchange first
                plan.actual("algo", late_reroute=True)
        return run_radix(skew_cap)

    def run_sample() -> DistributedSortResult:
        eng = state["eng"]
        eff_pack, eff_align = _engine_pack(pack_impl, eng)
        tracer.counters["exchange_engine"] = eng
        if words_np is not None:
            degenerate = _sample_skew_sniff(words_np, n_ranks)
        else:
            degenerate = _device_skew_sniff(live_words(), N, n_ranks)
        if degenerate:
            return reroute("quantile splitters degenerate (heavy duplication)",
                           "skew_sniff")
        cap_limit = _round_cap(SAMPLE_CAP_LIMIT_FACTOR * fair, eff_align)
        cap_start = base_cap
        if negotiate:
            cnts = negotiate_counts("sample")
            # an estimate: margin on top (SAMPLE_NEG_MARGIN, or the
            # planner's learned one under SORT_PLANNER=on)
            need = _round_cap(int(float(cnts.max()) * verdict.neg_margin) + 1,
                              eff_align)
            if need > cap_limit:
                return reroute(f"probe estimates cap {need} > O(n) bound {cap_limit}",
                               "probe_estimate")
            cap_start = need
            if plan is not None:
                plan.decide("cap", chosen=cap_start, trigger="estimate",
                            cap=cap_start, need=int(cnts.max()), fair=fair,
                            margin=round(verdict.neg_margin, 4))
            balance(cnts, "sample", False, cap_start)
        elif plan is not None:
            plan.decide("cap", chosen=cap_start, trigger="off", cap=cap_start,
                        fair=fair)
        spmd_engine = _resolve_local_engine(state["leng"], codec.n_words, n)
        tracer.counters["local_engine"] = spmd_engine
        last_need: list[int | None] = [None]

        def attempt(c: int) -> tuple[object, int]:
            sup.arm_exchange()
            with tracer.phase("sort"):
                out, counts, max_cnt = sup.dispatch("sample_spmd", lambda: _traced_call(
                    tracer, "sample_spmd",
                    (codec.n_words, n, c, oversample, eff_pack, spmd_engine, eng,
                     n_ranks, dev_type),
                    lambda: sample_sort.sample_sort_spmd(
                        live_words(), codec.n_words, n_ranks, c, oversample,
                        pack=eff_pack, engine=spmd_engine, exchange_engine=eng),
                    n=n, cap=c, ranks=n_ranks), on_retry=mark_dead)
                mark_dead()
                max_cnt = int(max_cnt)
            last_need[0] = max_cnt
            tracer.count("exchange_bytes",
                         n_ranks * (n_ranks - 1) * c * 4 * codec.n_words)
            return (out, counts), max_cnt

        try:
            (out, counts), cap = sup.exchange_loop(
                "sample", attempt, sup.squeeze_cap(cap_start, eff_align), eff_align,
                _round_cap, cap_limit=cap_limit,
                re_stage=do_restage if restage_on else None)
        except ExchangeCapExceeded as e:
            return reroute(f"exchange needs cap {e.need} > O(n) bound {e.limit}",
                           "cap_exceeded")
        tracer.count("exchange_passes", 1)
        tracer.counters["exchange_cap"] = cap
        if plan is not None:
            plan.actual("cap", cap=cap, need=last_need[0],
                        peer_recv_bytes=(last_need[0] or 0) * 4 * codec.n_words)
        return DistributedSortResult(
            (), N, dtype, counts=np.asarray([int(c) for c in counts]),
            shard_slots=n_ranks * cap, shards=tuple(out))

    def run_host() -> tuple[np.ndarray, ...]:
        """The last rung: ``np.lexsort`` of the encoded words on the host,
        no device work at all, fingerprint-checked on the host."""
        tracer.verbose("graceful degradation: host lexsort fallback")
        if staged is not None:
            if staged.source is None:
                raise SortIntegrityError(
                    "host fallback impossible: StagedIngest kept no source")
            arr = np.asarray(staged.source).reshape(-1)
        elif is_device:
            arr = x.detach().cpu().numpy().reshape(-1)
        else:
            arr = np.asarray(x).reshape(-1)
        with tracer.phase("sort"):
            w = codec.encode(arr)
            # np.lexsort: the last key is primary, so the words go lsw first
            order = np.lexsort(tuple(reversed(w)))
            sorted_w = tuple(wi[order] for wi in w)
        if verify_on and input_fp is not None:
            with tracer.phase("verify"):
                out_fp = vfy.fingerprint_host(sorted_w)
            tracer.count("verify_runs", 1)
            if out_fp != input_fp:
                raise SortIntegrityError(
                    "host fallback result failed fingerprint verification "
                    "(input changed between ingest and fallback?)")
        return sorted_w

    # ---- the degradation ladder: the radix_pallas local engine -> lax,
    # the pallas exchange engine -> lax (same algorithm), then the other
    # algorithm, then the host lexsort.  Each rung gets one verification
    # retry on re-staged input; a rung whose dispatch keeps failing (or
    # that fails outside its dispatch) moves down.  On CUDA ranks only a
    # DeviceDispatchError moves it down (supervision.strict_ladder): a
    # real OOM or a result that fails twice ends on its rung.  It ends in
    # a verified result or a typed error, never a silent wrong answer.
    strict = supervision.strict_ladder(dev_type)
    descends = (faults.DeviceDispatchError,) if strict else supervision.TRANSIENT
    fused_local = leng0 == "radix_pallas"
    #: lower rungs' local engine: the fused engine degrades to lax with
    #: the rest of the rung; the other values ride every rung unchanged
    lower_leng = "lax" if fused_local else leng0
    rungs: list[tuple[str, str, str]] = [(algorithm, eng0, leng0)]
    if supervision.fallback_enabled():
        if fused_local:
            rungs.append((algorithm, eng0, "lax"))
        if eng0 != "lax":
            rungs.append((algorithm, "lax", lower_leng))
        rungs.append(("sample" if algorithm == "radix" else "radix",
                      "lax", lower_leng))
        rungs.append(("host", "lax", "lax"))
    if plan is not None:
        plan.decide("ladder", chosen=rungs[0][0])

    res: DistributedSortResult | None = None
    host_words: tuple[np.ndarray, ...] | None = None
    last_err: Exception | None = None
    #: why the previous rung ended, "dispatch" or "verify": an engine
    #: degrade's trigger names the actual cause
    last_fail = "dispatch"
    level = rungs[0][0]

    # planner rung zero: the profile read fully sorted, so the staged input
    # shards (the radix layout: contiguous, pads at the tail) are a sort
    # candidate; one verify replaces the whole sort when it passes.  A miss
    # costs that verify, and the ladder below sorts the same live words.
    if verdict.passthrough(verify_on) and input_fp is not None:
        cand = DistributedSortResult((), N, dtype, shards=tuple(live_words()))
        if _check_result(tracer, cand, input_fp):
            tracer.count("planner_passthrough", 1)
            if plan is not None:
                plan.decide("ladder", chosen="passthrough")
            res = cand
        else:
            tracer.count("planner_passthrough_miss", 1)
            if plan is not None:
                plan.actual("planner", misses=1)
        del cand

    for step, (level, rung_eng, rung_leng) in enumerate(() if res is not None
                                                        else rungs):
        trigger = "pallas_fault" if last_fail == "dispatch" else "verify_failure"
        if rung_leng != state["leng"]:
            tracer.verbose(f"degrading local-sort engine {state['leng']} -> {rung_leng}")
            tracer.count("local_engine_degraded", 1)
            state["leng"] = rung_leng
            if plan is not None:
                # the engine decision keeps its chosen pack; the degrade
                # stamps its trigger, which the regret rule prices
                eng_d = plan.decisions.get("engine")
                plan.decide("engine", chosen=(eng_d.chosen if eng_d is not None
                                              else rung_leng), trigger=trigger)
        if rung_eng != state["eng"]:
            tracer.verbose(f"degrading exchange engine {state['eng']} -> {rung_eng}")
            tracer.count("exchange_engine_degraded", 1)
            state["eng"] = rung_eng
            if plan is not None:
                plan.decide("exchange_engine", chosen=rung_eng, trigger=trigger)
        if level != rungs[0][0]:
            tracer.verbose(f"degrading to the {level} path")
            if plan is not None:
                plan.decide("ladder", chosen=level)
                plan.bump("ladder", "rungs_descended")
        if step:
            # a descent leaves an artifact, and every span of a lower rung
            # carries the rung it ran on
            flight_recorder.dump_on_error(f"ladder_{level}_{rung_eng}_{rung_leng}")
        ctx = (spans.trace_context(rung=f"{level}/{rung_eng}/{rung_leng}") if step
               else contextlib.nullcontext())
        done = failed = False
        with ctx:
            for _ in range(2 if verify_on else 1):
                try:
                    if level == "host":
                        host_words = run_host()
                        done = True
                        break
                    cand = run_sample() if level == "sample" else run_radix(base_cap)
                    cand = faults.maybe_corrupt_result(reg, cand)
                    ok = not verify_on or _check_result(tracer, cand, input_fp)
                except SortRetryExhausted as e:
                    if not isinstance(e.__cause__, descends):
                        raise
                    last_err, failed, last_fail = e, True, "dispatch"
                    tracer.verbose(f"{level} path failed persistently: {e}")
                    break
                except supervision.TRANSIENT as e:
                    # a failing device can also surface outside the
                    # supervised dispatch (sniff, planner reduction,
                    # verifier): degrade rather than leak it untyped
                    last_err = SortRetryExhausted(
                        f"{level} path failed outside the sort dispatch: {e}")
                    last_err.__cause__ = e
                    if not isinstance(e, descends):
                        raise last_err from e
                    failed, last_fail = True, "dispatch"
                    tracer.count("sort_retries", 1)
                    tracer.verbose(f"{level} path device failure: "
                                   f"{type(e).__name__}; degrading")
                    break
                if ok:
                    res = cand
                    done = True
                    break
                tracer.count("verify_failures", 1)
                last_fail = "verify"
                force_restage()  # the input words themselves are suspect
            if strict and not (done or failed):
                raise SortIntegrityError(
                    f"the {level}/{rung_eng}/{rung_leng} result failed its "
                    "verification and its retry on CUDA ranks, where no rung "
                    "stands in for the kernels (verify_failures="
                    f"{int(tracer.counters.get('verify_failures', 0))})")
        if done:
            break
    if res is None and host_words is None:
        if last_err is not None:
            raise last_err
        raise SortIntegrityError(
            "no sort path produced a verified result (verify_failures="
            f"{int(tracer.counters.get('verify_failures', 0))})")

    if host_words is not None:
        tracer.counters["degraded_to"] = "host"
        out_np = codec.decode(host_words)
        if not return_result:
            return out_np
        # best-effort re-stage of the host-sorted words onto the mesh (pads
        # are copies of the maximum key, as in the device layout); a card
        # that fails here too gets a host-backed result
        try:
            pad = _host_pad_words(codec, out_np, dtype, n_ranks * n)
            return DistributedSortResult(
                (), N, dtype, shards=tuple(_shard_input(host_words, mesh, n, pad)))
        except supervision.TRANSIENT as e:
            if not isinstance(e, descends):
                raise SortRetryExhausted(
                    f"re-staging the host fallback result failed: {e}") from e
            tracer.verbose("device unavailable for re-staging the host "
                           "fallback result; returning host-backed words")
            return DistributedSortResult(
                tuple(torch.from_numpy(w.view(np.int32)) for w in host_words),
                N, dtype)

    if level != rungs[0][0]:
        tracer.counters["degraded_to"] = level
    if return_result:
        return res
    with tracer.phase("decode"):
        return res.to_numpy(tracer=tracer)
