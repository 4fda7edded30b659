"""Out-of-core external sort: partition → sort on the card → spill →
k-way merge (port of ``mpitest_tpu/store/external.py``).

The in-memory path is bounded by device and host memory; this path is
bounded by disk.  The input partitions into ``SORT_MEM_BUDGET``-sized
chunks; each chunk rides the ordinary verified sort (``models/api.sort``
on the card, or over ``mesh``; the record sort of ``models/records.py``
when a payload rides) and spills to a sorted run
(``store/runs.py``: SORTBIN1 or SORTRUN2 framing + fingerprint sidecar);
the runs then stream through the bounded k-way merge
(``store/merge.py``), at most ``SORT_MERGE_FANIN`` at a time (more runs
merge in passes through intermediate runs, each written through the
streaming run writer).  Under ``SORT_LOCAL_ENGINE=radix_pallas`` the
merge rounds of at most 4096 records are ordered by the merge-order
kernel K8 on the same device as the chunk sorts.

The sort runs on the card unless the caller passes ``device="cpu"`` (or
a mesh of CPU ranks); with neither and no CUDA it raises.

Integrity ladder:

1. every chunk sort is fingerprint-verified;
2. every run carries a sidecar folded before its bytes reach disk; the
   merge re-folds each run on read-back and raises the typed
   :class:`~mpitest_tpu_torch.store.merge.RunIntegrityError` naming a
   bad run;
3. the merged output is folded chunk by chunk and compared against the
   combined run sidecars (count + per-word XOR/sum + record mix) with a
   boundary-inclusive sortedness sweep;
4. a tripped check re-spills exactly the blamed slices from the source
   and re-merges (one recovery round, the ``external.recover`` event and
   the ``external_recoveries`` counter); a second failure raises the
   typed ``SortIntegrityError``.

Durability: a caller-supplied ``dataset`` id opts into the crash-durable
path — every spilled run commits via write temp → fsync →
``os.replace`` → fsync(dir) and is journaled in an append-only manifest
(``store/manifest.py``), so a restarted sort of the same dataset replays
the journal, re-validates every committed run and re-enters at the merge
instead of re-sorting.  The startup GC (:func:`gc_spill_dir`) reclaims
age-gated orphans no live manifest names, and a mid-sort ``ENOSPC``
surfaces as the typed :class:`SpillCapacityError` with partial outputs
deleted.

Telemetry: ``external.run`` / ``external.merge`` / ``external.resume`` /
``external.gc`` spans and the ``external.recover`` event on the tracer's
span log (streamed to ``SORT_TRACE`` as in ``sort()``), and the
``external_runs`` / ``external_disk_bytes`` / ``external_merge_passes`` /
``external_recoveries`` counters.  A typed error leaving the sort dumps
the flight recorder's ring.
"""

from __future__ import annotations

import contextlib
import errno
import os
import tempfile
import time
from dataclasses import dataclass
from itertools import islice
from typing import Any, Callable, Iterator

import numpy as np
import torch

from mpitest_tpu_torch import faults
from mpitest_tpu_torch.models import plan as plan_mod
from mpitest_tpu_torch.models.records import as_payload_matrix, words_to_payload
from mpitest_tpu_torch.models.segmented import lex_sorted_host
from mpitest_tpu_torch.models.supervisor import (SortFaultError, SortIntegrityError,
                                                 wire_registry)
from mpitest_tpu_torch.ops.keys import codec_for
from mpitest_tpu_torch.store import aio
from mpitest_tpu_torch.store import manifest as mfstlib
from mpitest_tpu_torch.store import merge as mergelib
from mpitest_tpu_torch.store import runs as runlib
from mpitest_tpu_torch.utils import flight_recorder, knobs
from mpitest_tpu_torch.utils.trace import Tracer

#: Host-memory multiplier per record during partition/sort: the raw
#: chunk + its encoded words + the device copy + sort working set.
#: chunk_elems = budget // (SPILL_FACTOR * record_bytes).
SPILL_FACTOR = 4

#: Floor on chunk/buffer sizes — below this the per-chunk overheads
#: (launches, syscalls) dominate and the budget arithmetic is noise.
MIN_CHUNK_ELEMS = 1 << 10

#: Recovery budget: full merge attempts before the typed error.
MERGE_ATTEMPTS = 2

#: Spill-artifact suffixes the orphan GC may reclaim (age-gated,
#: manifest-referenced files excluded) — run files, staging files,
#: durable-commit temps, and journals themselves.
GC_SUFFIXES = (".run", ".runz", ".pay", ".fpr.json", ".spill", ".tmp",
               mfstlib.MANIFEST_SUFFIX)


class SpillCapacityError(OSError):
    """The spill volume ran out of space mid-sort (``ENOSPC`` during a run
    or merge write).  Partial outputs are deleted before this raises."""

    def __init__(self, detail: str) -> None:
        super().__init__(errno.ENOSPC, detail)


@dataclass
class ExternalResult:
    """Outcome of one external sort."""

    n: int
    dtype: np.dtype
    payload_width: int
    runs: int                 # spill runs written by the partition pass
    disk_bytes: int           # bytes spilled (initial runs)
    merge_passes: int         # k-way passes (1 = single final pass)
    recoveries: int           # integrity recoveries taken
    keys: np.ndarray | None = None        # sink="array"
    payload: np.ndarray | None = None     # sink="array", records only
    out_run: "runlib.RunInfo | None" = None   # sink="file"
    #: runs re-validated from a journaled manifest instead of being
    #: re-sorted (crash resume; 0 = cold run)
    resumed_runs: int = 0
    #: logical bytes / spilled bytes of the partition runs: > 1.0 when
    #: SORTRUN2 compression shrank the spill, 0.0 when nothing spilled
    spill_ratio: float = 0.0
    #: fraction of the final merge's disk time that overlapped its
    #: compute (read-ahead/write-behind concurrency; 0.0 = synchronous)
    disk_overlap: float = 0.0


def _budget() -> int:
    return int(knobs.get("SORT_MEM_BUDGET"))


def _fanin() -> int:
    return int(knobs.get("SORT_MERGE_FANIN"))


def resolve_spill_dir(spill_dir: str | None = None) -> str:
    """The spill staging directory: the explicit argument, else
    ``SORT_SPILL_DIR``, else a fresh per-process temp dir."""
    d = spill_dir or knobs.get("SORT_SPILL_DIR")
    if not d:
        d = os.path.join(tempfile.gettempdir(),
                         f"mpitest_spill_{os.getpid()}")
    os.makedirs(d, exist_ok=True)
    return d


def spill_chunk_elems(budget: int, dtype: np.dtype,
                      payload_width: int = 0) -> int:
    """Records per partition chunk under ``budget`` bytes."""
    rec = int(np.dtype(dtype).itemsize) + int(payload_width)
    return max(MIN_CHUNK_ELEMS, budget // max(1, SPILL_FACTOR * rec))


def merge_chunk_elems(budget: int, dtype: np.dtype, payload_width: int,
                      n_runs: int) -> int:
    """Records per per-run read-ahead buffer during a merge of
    ``n_runs`` runs: the buffers plus one output round must fit the
    budget."""
    rec = int(np.dtype(dtype).itemsize) + int(payload_width)
    per_run = budget // max(1, SPILL_FACTOR * rec * (n_runs + 2))
    return max(MIN_CHUNK_ELEMS, per_run)


def _sort_chunk(keys: np.ndarray, pay: np.ndarray | None, algorithm: str,
                device: torch.device, mesh: Any, tracer: Any,
                ) -> tuple[np.ndarray, np.ndarray | None]:
    """One verified sort of a partition chunk (a record sort when ``pay``
    rides): over ``mesh`` when given, else on ``device``."""
    from mpitest_tpu_torch.models import api

    on = dict(device=None if mesh is not None else device, mesh=mesh,
              tracer=tracer)
    if pay is not None:
        out_k, out_p = api.sort(keys, algorithm=algorithm, payload=pay, **on)
        return out_k, out_p
    return api.sort(np.asarray(keys), algorithm=algorithm, **on), None


def _spans(tracer: Any):
    return tracer.spans if tracer is not None else None


def _spill_one(idx: int, keys: np.ndarray, pay: np.ndarray | None,
               spill_dir: str, algorithm: str, device: torch.device, mesh: Any,
               tracer: Any, durable: bool = False) -> "runlib.RunInfo":
    t0 = time.perf_counter()
    out_k, out_p = _sort_chunk(keys, pay, algorithm, device, mesh, tracer)
    info = runlib.write_run(spill_dir, f"r{os.getpid():x}_{idx:05d}",
                            out_k, out_p, durable=durable)
    spans = _spans(tracer)
    if spans is not None:
        spans.record("external.run", t0, time.perf_counter() - t0,
                     run=idx, n=info.n, bytes=info.disk_bytes,
                     dtype=info.dtype.name,
                     payload_width=info.payload_width)
    return info


def _merge_level(level: "list[runlib.RunInfo]", spill_dir: str,
                 budget: int, fanin: int, dtype: np.dtype, width: int,
                 pass_idx: int, device: torch.device,
                 tracer: Any) -> "list[runlib.RunInfo]":
    """One fan-in-bounded intermediate pass: groups of ``fanin`` runs
    merge into one run each, streamed through the run writer."""
    out: list[runlib.RunInfo] = []
    for gi in range(0, len(level), fanin):
        group = level[gi:gi + fanin]
        if len(group) == 1:
            out.append(group[0])
            continue
        t0 = time.perf_counter()
        ch = merge_chunk_elems(budget, dtype, width, len(group))
        w = runlib.RunStreamWriter(
            spill_dir, f"m{os.getpid():x}_{pass_idx}_{gi:05d}",
            dtype, width)
        # async IO: per-run read-ahead decode + write-behind encode, so
        # the pass's disk time overlaps its merge compute
        io = aio.MergeIO()
        wb = io.wrap_writer(w)
        try:
            for kws, pws in mergelib.merge_runs(group, ch, io=io,
                                                device=device):
                wb.append_words(kws, pws)
            info = wb.close()
        except BaseException:
            # an ENOSPC (or integrity failure) mid-pass must not leak
            # the half-written intermediate run
            wb.abort()
            raise
        finally:
            io.close()
        iostats = io.stats(t0, time.perf_counter())
        spans = _spans(tracer)
        if spans is not None:
            spans.record("external.merge", t0,
                         time.perf_counter() - t0,
                         runs=len(group), n=info.n,
                         bytes=info.disk_bytes, final=False,
                         merge_pass=pass_idx,
                         disk_overlap=iostats["disk_overlap"],
                         disk_busy_s=iostats["disk_busy_s"],
                         overlap_s=iostats["overlap_s"])
        out.append(info)
    return out


def _resolve(device: Any, mesh: Any) -> torch.device:
    """The device of an external sort: the mesh's first rank, ``device``,
    or the card; raises without CUDA when neither is given, and
    ``RuntimeError`` across processes (a mesh across processes, or no
    ``device`` inside a group of several)."""
    from mpitest_tpu_torch.models.api import resolve_device

    from mpitest_tpu_torch.parallel.mesh import in_group

    if mesh is not None and device is not None:
        raise ValueError("pass either device or mesh, not both")
    if (mesh.cross_process if mesh is not None else device is None and in_group()):
        # the reference's chunk sorts run on the global mesh and fail to
        # fetch their results; the port refuses up front with the same class
        raise RuntimeError(
            "external_sort across processes is not available: its chunk "
            "results would span ranks of other processes; pass device= to "
            "sort on this process alone")
    return resolve_device(None, mesh.devices[0] if mesh is not None
                          else device)


def external_sort(
    x: Any,
    payload: Any = None,
    *,
    algorithm: str = "radix",
    device: torch.device | str | None = None,
    mesh: Any = None,
    tracer: Any = None,
    budget: int | None = None,
    spill_dir: str | None = None,
    fanin: int | None = None,
    sink: "str | Callable[[np.ndarray, np.ndarray | None], None]" = "array",
    out_name: str = "merged",
    dataset: str | None = None,
) -> ExternalResult:
    """Externally sort host keys ``x`` (with per-record ``payload`` bytes,
    the record sort of ``models/records.py``, when given) under a byte
    ``budget`` (default ``SORT_MEM_BUDGET``; must be > 0 — the external
    path never engages implicitly).  The chunk sorts run on ``device`` or
    over ``mesh`` (they exclude each other; default the card).

    ``dataset`` opts the sort into the crash-durable path: every spilled
    run commits durably and is journaled in a manifest keyed by the id,
    and a retried or restarted sort of the same dataset replays the
    journal, re-validates the committed runs and re-enters at the merge
    instead of re-sorting (``SORT_RESUME=off`` disables both halves).

    ``sink`` selects where the merged output goes: ``"array"``
    materializes ``result.keys`` — byte-identical to the in-memory sort;
    ``"file"`` streams it into one raw output run (``result.out_run``); a
    callable receives each decoded ``(keys_chunk, None)`` in order (the
    CLI's streamed median probe)."""
    keys = np.asarray(x).reshape(-1)
    dtype = np.dtype(keys.dtype)
    n = int(keys.size)
    pay = as_payload_matrix(payload, n) if payload is not None else None
    width = int(pay.shape[1]) if pay is not None else 0

    def chunks(chunk_elems: int) -> Iterator[
            tuple[np.ndarray, np.ndarray | None]]:
        for off in range(0, n, chunk_elems):
            yield (keys[off:off + chunk_elems],
                   pay[off:off + chunk_elems] if pay is not None else None)

    tracer = tracer or Tracer()
    with _fault_run(tracer):
        return _external_core(chunks, n, dtype, width, algorithm=algorithm,
                              device=device, mesh=mesh, tracer=tracer,
                              budget=budget, spill_dir=spill_dir, fanin=fanin,
                              sink=sink, out_name=out_name, dataset=dataset)


def external_sort_file(
    path: str,
    dtype: Any = np.int32,
    *,
    algorithm: str = "radix",
    device: torch.device | str | None = None,
    mesh: Any = None,
    tracer: Any = None,
    budget: int | None = None,
    spill_dir: str | None = None,
    fanin: int | None = None,
    sink: "str | Callable[[np.ndarray, np.ndarray | None], None]" = "array",
    out_name: str = "merged",
    sink_factory: Any = None,
    dataset: str | None = None,
) -> ExternalResult:
    """External sort of a key FILE — SORTBIN1 or reference text — without
    materializing it: chunks stream through ``utils/io.iter_key_chunks``
    (mmap slices for binary, the threaded block parser for text) straight
    into spill runs, so host memory peaks at chunk size.  ``sink_factory``
    (n -> sink), when given, builds a fresh sink for each merge attempt."""
    from mpitest_tpu_torch.utils import io as kio

    dtype = np.dtype(dtype)

    def chunks(chunk_elems: int) -> Iterator[
            tuple[np.ndarray, np.ndarray | None]]:
        for c in kio.iter_key_chunks(path, dtype,
                                     chunk_elems=chunk_elems):
            yield c, None

    tracer = tracer or Tracer()
    with _fault_run(tracer):
        return _external_core(chunks, None, dtype, 0, algorithm=algorithm,
                              device=device, mesh=mesh, tracer=tracer,
                              budget=budget, spill_dir=spill_dir, fanin=fanin,
                              sink=sink, out_name=out_name,
                              sink_factory=sink_factory, dataset=dataset)


@contextlib.contextmanager
def _fault_run(tracer: Tracer) -> Iterator[None]:
    """One external sort's fault registry (``SORT_FAULTS``), wired to its
    tracer and current for the store's hook sites while the sort runs."""
    reg = faults.for_run()
    wire_registry(reg, tracer)
    with faults.active(reg):
        yield


def _external_core(
    chunks_fn: Callable[[int], Iterator[tuple[np.ndarray,
                                              np.ndarray | None]]],
    n_hint: int | None,
    dtype: np.dtype,
    width: int,
    *,
    algorithm: str,
    device: torch.device | str | None,
    mesh: Any,
    tracer: Any,
    budget: int | None,
    spill_dir: str | None,
    fanin: int | None,
    sink: "str | Callable[[np.ndarray, np.ndarray | None], None]",
    out_name: str,
    sink_factory: "Callable[[int], Callable[[np.ndarray, np.ndarray | None], None]] | None" = None,
    dataset: str | None = None,
) -> ExternalResult:
    tracer = tracer or Tracer()
    trace_path = knobs.get("SORT_TRACE")
    if trace_path and tracer.spans.stream_path is None:
        tracer.spans.stream_path = trace_path
    budget = _budget() if budget is None else int(budget)
    if budget <= 0:
        raise ValueError(
            "external sort needs a positive byte budget "
            "(SORT_MEM_BUDGET or the budget= argument)")
    fanin = _fanin() if fanin is None else int(fanin)
    if fanin < 2:
        raise ValueError(f"merge fan-in must be >= 2, got {fanin}")
    dev = _resolve(device, mesh)
    spill_dir = resolve_spill_dir(spill_dir)
    codec = codec_for(dtype)
    chunk_elems = spill_chunk_elems(budget, dtype, width)
    spans = _spans(tracer)

    resume_on = dataset is not None and knobs.get("SORT_RESUME") != "off"

    # ---- crash resume -----------------------------------------------
    # a journaled manifest from a killed (or typed-failed-and-retried)
    # sort of the SAME dataset is a checkpoint: replay it, re-validate
    # every committed run (structure + sidecar fold), and skip the sort
    # phase for every chunk that survives.
    resumed: dict[int, runlib.RunInfo] = {}
    resumed_meta: dict[int, mfstlib.ManifestRun] = {}
    mwriter: mfstlib.ManifestWriter | None = None
    if resume_on:
        gc_spill_dir(spill_dir, tracer=tracer)
        t0 = time.perf_counter()
        m = mfstlib.load(mfstlib.manifest_path(spill_dir, dataset))
        if m is not None and (m.dtype == dtype.name
                              and m.payload_width == width
                              and m.chunk_elems == chunk_elems
                              and (n_hint is None or m.n is None
                                   or m.n == n_hint)):
            for mr in m.runs:
                try:
                    info = runlib.open_run(mr.path)
                    ok = (info.n == mr.n
                          and info.fingerprint == mr.fingerprint
                          and runlib.verify_run(info))
                except runlib.RunVersionError:
                    raise  # version skew is typed, never silent
                except (runlib.RunFormatError, OSError):
                    ok = False  # torn/missing partial: discarded
                if ok:
                    resumed[mr.chunk] = info
                    resumed_meta[mr.chunk] = mr
                else:
                    tracer.verbose(
                        f"resume: discarding invalid committed "
                        f"run {mr.path!r} (chunk {mr.chunk})")
                    # the damaged files must not linger: this chunk
                    # re-spills to a fresh path below
                    runlib.remove_run_paths(mr.path)
            if spans is not None:
                spans.record(
                    "external.resume", t0,
                    time.perf_counter() - t0, dataset=dataset,
                    committed=len(m.runs), valid=len(resumed),
                    skipped_lines=m.skipped_lines)
        mwriter = mfstlib.ManifestWriter(
            spill_dir, dataset, dtype=dtype.name, n=n_hint,
            payload_width=width, algorithm=algorithm,
            chunk_elems=chunk_elems, budget=budget, fanin=fanin,
            resumed=[resumed_meta[c] for c in sorted(resumed_meta)])

    # ---- partition + spill ------------------------------------------
    run_infos: list[runlib.RunInfo] = []
    #: source chunk index behind each run — the recovery path re-slices
    #: chunks_fn by THIS index (empty chunks are skipped, so run order
    #: and chunk order can differ)
    chunk_of_run: list[int] = []
    n = 0
    resumed_count = 0
    try:
        for idx, (kchunk, pchunk) in enumerate(chunks_fn(chunk_elems)):
            kchunk = np.asarray(kchunk, dtype).reshape(-1)
            if kchunk.size == 0:
                continue
            prev = resumed.get(idx)
            if prev is not None and prev.n == int(kchunk.size):
                # checkpoint hit: the committed run IS this chunk
                # sorted — re-enter at the merge without re-sorting
                run_infos.append(prev)
                chunk_of_run.append(idx)
                n += int(kchunk.size)
                resumed_count += 1
                continue
            info = _spill_one(idx, kchunk, pchunk, spill_dir, algorithm, dev,
                              mesh, tracer, durable=mwriter is not None)
            if mwriter is not None:
                mwriter.commit_run(idx, info)
            run_infos.append(info)
            chunk_of_run.append(idx)
            n += int(kchunk.size)
        if n_hint is not None and n != n_hint:
            raise SortIntegrityError(
                f"partition saw {n} records, expected {n_hint}")

        if not run_infos:
            res = ExternalResult(0, dtype, width, 0, 0, 0, 0,
                                 keys=np.empty(0, dtype),
                                 payload=(np.zeros((0, width), np.uint8)
                                          if width else None))
            _finish_plan(tracer, res, budget, fanin)
            return res

        disk0 = sum(r.disk_bytes for r in run_infos)
        expected_fp = run_infos[0].fingerprint
        for r in run_infos[1:]:
            expected_fp = expected_fp.combine(r.fingerprint)

        # ---- merge (+ bounded integrity recovery) -------------------
        # partition runs are dataset-sized: deleted on EVERY exit path
        # below (the success case and the typed failure alike).  Only a
        # CRASH skips this cleanup, and that is what the manifest and
        # resume exist for.
        try:
            return _merge_with_recovery(
                chunks_fn, chunk_elems, run_infos, chunk_of_run, n,
                disk0, expected_fp, spill_dir, budget, fanin, dtype,
                width, codec, algorithm, dev, mesh, sink, sink_factory,
                out_name, tracer, spans, mwriter, resumed_count)
        finally:
            for r in run_infos:
                runlib.remove_run(r)
    except BaseException as e:
        # a FAILED sort (typed or not) never leaves partial runs behind;
        # remove_run is idempotent
        for r in run_infos:
            runlib.remove_run(r)
        if isinstance(e, SortFaultError):
            # a typed terminal error leaves the flight recorder's ring
            flight_recorder.dump_on_error(type(e).__name__)
        if isinstance(e, OSError) and e.errno == errno.ENOSPC \
                and not isinstance(e, SpillCapacityError):
            # in-flight partial outputs were already deleted at their
            # write sites (writer.abort); surface the typed shape
            raise SpillCapacityError(
                f"spill volume full ({spill_dir!r}): {e}") from e
        raise
    finally:
        if mwriter is not None:
            mwriter.delete()


def _merge_with_recovery(
    chunks_fn: Any,
    chunk_elems: int,
    run_infos: "list[runlib.RunInfo]",
    chunk_of_run: "list[int]",
    n: int,
    disk0: int,
    expected_fp: Any,
    spill_dir: str,
    budget: int,
    fanin: int,
    dtype: np.dtype,
    width: int,
    codec: Any,
    algorithm: str,
    device: torch.device,
    mesh: Any,
    sink: Any,
    sink_factory: Any,
    out_name: str,
    tracer: Any,
    spans: Any,
    mwriter: "mfstlib.ManifestWriter | None" = None,
    resumed_count: int = 0,
) -> ExternalResult:
    """The bounded merge/recovery loop of :func:`_external_core` (split
    out so the caller owns partition-run cleanup on every exit)."""

    def _run_ok(r: "runlib.RunInfo") -> bool:
        # blame must survive structurally-torn runs too: a truncated
        # file raises RunFormatError from the chunk reader, which for
        # blame purposes is simply "bad run, re-spill it"
        try:
            return runlib.verify_run(r)
        except (runlib.RunFormatError, OSError):
            return False

    recoveries = 0
    merge_passes = 0
    out: ExternalResult | None = None
    last_err: str | None = None
    for attempt in range(MERGE_ATTEMPTS + 1):
        # the sink is rebuilt PER ATTEMPT: a merge streams chunks to it
        # before verification can finish, so an attempt that fails has
        # already fed the sink possibly-bad data — array/file sinks
        # restart inside _merge_all, and a streaming caller provides
        # sink_factory(n) so ITS state (the CLI's running median probe)
        # restarts too.  A bare callable sink must be stateless across
        # attempts.
        attempt_sink = (sink_factory(n) if sink_factory is not None
                        else sink)
        try:
            out, merge_passes = _merge_all(
                run_infos, expected_fp, n, spill_dir, budget, fanin,
                dtype, width, codec, attempt_sink, out_name, device,
                tracer)
            break
        except mergelib.RunIntegrityError as e:
            # a named bad run: re-spill exactly that slice (an
            # INTERMEDIATE merge run cannot be re-spilled directly —
            # blame falls back to scanning the originals)
            bad = ([e.info] if e.info in run_infos
                   else [r for r in run_infos if not _run_ok(r)])
            last_err = str(e)
        except runlib.RunVersionError:
            raise  # version skew is typed all the way out, never blamed
        except runlib.RunFormatError as e:
            # structural damage mid-merge (the disk holds fewer bytes
            # than the sidecar promises) — blame by scanning
            bad = [r for r in run_infos if not _run_ok(r)]
            last_err = str(e)
        except SortIntegrityError as e:
            # output-side mismatch: blame by scanning every run against
            # its sidecar
            bad = [r for r in run_infos if not _run_ok(r)]
            last_err = str(e)
        if attempt >= MERGE_ATTEMPTS:
            break
        recoveries += 1
        tracer.count("external_recoveries", 1)
        if spans is not None:
            spans.event("external.recover",
                        reason=last_err,
                        bad_runs=[r.path for r in bad],
                        attempt=attempt + 1)
        tracer.verbose(
            f"external sort integrity failure ({last_err}); "
            f"re-spilling {len(bad)} run(s) and re-merging")
        for r in bad:
            i = run_infos.index(r)
            ci = chunk_of_run[i]
            src = next(islice(chunks_fn(chunk_elems), ci, ci + 1))
            run_infos[i] = _spill_one(ci, np.asarray(src[0], dtype), src[1],
                                      spill_dir, algorithm, device, mesh,
                                      tracer, durable=mwriter is not None)
            if mwriter is not None:
                # journal the replacement (replay is last-wins per
                # chunk, so the blamed run's old line is superseded)
                mwriter.commit_run(ci, run_infos[i])
            if r.path != run_infos[i].path:
                # a blamed RESUMED run kept its old (other-pid) name;
                # the replacement got a fresh one — drop the old files
                runlib.remove_run(r)
        expected_fp = run_infos[0].fingerprint
        for r in run_infos[1:]:
            expected_fp = expected_fp.combine(r.fingerprint)
    if out is None:
        raise SortIntegrityError(
            "external sort produced no verified result after "
            f"{MERGE_ATTEMPTS} recovery attempt(s): {last_err}")

    out.runs = len(run_infos)
    out.disk_bytes = disk0
    out.recoveries = recoveries
    out.merge_passes = merge_passes
    out.resumed_runs = resumed_count
    rec_bytes = int(np.dtype(dtype).itemsize) + int(width)
    out.spill_ratio = (n * rec_bytes / disk0) if disk0 else 0.0
    tracer.counters["external_runs"] = out.runs
    tracer.counters["external_disk_bytes"] = out.disk_bytes
    tracer.counters["external_merge_passes"] = out.merge_passes
    tracer.counters["external_recoveries"] = recoveries
    _finish_plan(tracer, out, budget, fanin)
    return out


def _finish_plan(tracer: Tracer, res: ExternalResult, budget: int,
                 fanin: int) -> None:
    """Record the ``external`` plan decision: the spill tier, its sizing
    and what it cost (runs, disk bytes, merge passes; each integrity
    recovery is its regret), emitted as the run's ``sort.plan`` event."""
    if not plan_mod.enabled():
        return
    plan = plan_mod.SortPlan(algo="external", n=res.n, dtype=res.dtype.name,
                             ranks=1)
    plan.decide("external", chosen="spill", trigger="budget", budget=budget,
                fanin=fanin, payload_width=res.payload_width)
    plan.actual("external", runs=res.runs, disk_bytes=res.disk_bytes,
                merge_passes=res.merge_passes, recoveries=res.recoveries,
                resumed=res.resumed_runs, spill_ratio=round(res.spill_ratio, 3),
                disk_overlap=round(res.disk_overlap, 3))
    if res.recoveries:
        plan.bump("external", "recoveries", float(res.recoveries))
    plan.finalize()
    tracer.spans.event("sort.plan", **plan.to_attrs())
    tracer.plan = plan


def _merge_all(
    run_infos: "list[runlib.RunInfo]",
    expected_fp: Any,
    n: int,
    spill_dir: str,
    budget: int,
    fanin: int,
    dtype: np.dtype,
    width: int,
    codec: Any,
    sink: "str | Callable[[np.ndarray, np.ndarray | None], None]",
    out_name: str,
    device: torch.device,
    tracer: Any,
) -> tuple[ExternalResult, int]:
    """Fan-in-bounded merge of all runs + the output-side verification
    (fingerprint vs combined sidecars, boundary-inclusive sortedness).
    Raises typed integrity errors; never returns unverified bytes."""
    # merge_stall drill: every partition run is committed and the merge
    # has not consumed them yet (a kill here resumes at the merge)
    faults.maybe_merge_stall()
    spans = _spans(tracer)
    level = list(run_infos)
    merge_passes = 0
    #: intermediate runs created by the fan-in passes — deleted once the
    #: final pass has consumed them (success OR failure), so a
    #: multi-pass merge never leaks dataset-sized files
    created: list[runlib.RunInfo] = []
    while len(level) > fanin:
        merge_passes += 1
        level = _merge_level(level, spill_dir, budget, fanin, dtype,
                             width, merge_passes, device, tracer)
        created.extend(r for r in level if r not in run_infos)

    merge_passes += 1
    t0 = time.perf_counter()
    ch = merge_chunk_elems(budget, dtype, width, len(level))

    # async IO: read-ahead sources for every input run + (file sink) a
    # write-behind on the output writer; the final span carries the
    # measured disk/compute overlap
    io = aio.MergeIO()
    out_keys: list[np.ndarray] = []
    out_pay: list[np.ndarray] = []
    wb: "aio.WriteBehind | None" = None
    emit: Callable[[np.ndarray, np.ndarray | None], None]
    if sink == "array":
        def emit(k: np.ndarray, p: np.ndarray | None) -> None:
            out_keys.append(k)
            if p is not None:
                out_pay.append(p)
    elif sink == "file":
        # the OUTPUT run is always raw (compress=False): its consumers
        # read its body directly — only intermediate spill traffic rides
        # the compressed SORTRUN2 framing
        wb = io.wrap_writer(runlib.RunStreamWriter(
            spill_dir, out_name, dtype, width, compress=False))

        def emit(k: np.ndarray, p: np.ndarray | None) -> None:
            wb.append(k, p)
    elif callable(sink):
        emit = sink
    else:
        raise ValueError(f"unknown sink {sink!r}")

    got_fp = None
    got_n = 0
    prev_last: tuple[int, ...] | None = None
    sorted_ok = True
    out_info: "runlib.RunInfo | None" = None
    try:
        for kws, pws in mergelib.merge_runs(level, ch, io=io, device=device):
            cfp = runlib.run_fingerprint(kws, pws)
            got_fp = cfp if got_fp is None else got_fp.combine(cfp)
            m = int(kws[0].size)
            got_n += m
            if m:
                if not lex_sorted_host(kws):
                    sorted_ok = False
                first = tuple(int(w[0]) for w in kws)
                if prev_last is not None and first < prev_last:
                    sorted_ok = False
                prev_last = tuple(int(w[-1]) for w in kws)
            keys_dec = codec.decode(kws)
            pay_dec = words_to_payload(pws, m, width) if width else None
            emit(keys_dec, pay_dec)
        if wb is not None:
            # drain + publish BEFORE verification so the not-ok path
            # below can delete the published names
            out_info = wb.close()
    except BaseException:
        if wb is not None:
            # stop the worker and delete the partial output run: a failed
            # merge must not leak a dataset-sized output file per attempt
            wb.abort()
        raise
    finally:
        io.close()
        for r in created:
            runlib.remove_run(r)
    iostats = io.stats(t0, time.perf_counter())

    ok = (sorted_ok and got_n == n
          and (got_fp == expected_fp if got_fp is not None else n == 0))
    tracer.count("verify_runs", 1)
    if spans is not None:
        spans.event("verify", ok=bool(ok), sorted_ok=bool(sorted_ok),
                    fp_ok=bool(got_fp == expected_fp or n == 0), n=n)
        spans.record("external.merge", t0, time.perf_counter() - t0,
                     runs=len(level), n=got_n, final=True,
                     merge_pass=merge_passes,
                     disk_overlap=iostats["disk_overlap"],
                     disk_busy_s=iostats["disk_busy_s"],
                     overlap_s=iostats["overlap_s"])
    if not ok:
        tracer.count("verify_failures", 1)
        if out_info is not None:
            runlib.remove_run(out_info)  # see the except above
        raise SortIntegrityError(
            f"merged output failed verification (sorted={sorted_ok}, "
            f"n={got_n}/{n}, fingerprint="
            f"{'ok' if got_fp == expected_fp else 'MISMATCH'})")

    res = ExternalResult(n, dtype, width, len(run_infos), 0,
                         merge_passes, 0,
                         disk_overlap=iostats["disk_overlap"])
    if sink == "array":
        res.keys = (np.concatenate(out_keys) if out_keys
                    else np.empty(0, dtype))
        if width:
            res.payload = (np.concatenate(out_pay) if out_pay
                           else np.zeros((0, width), np.uint8))
    elif sink == "file":
        res.out_run = out_info
    return res, merge_passes


def gc_spill_dir(spill_dir: str | None = None, *,
                 age_s: float | None = None, tracer: Any = None) -> int:
    """Startup GC: reclaim orphaned spill artifacts — run / staging /
    temp / journal files under ``spill_dir`` that no live manifest
    references (a killed process leaks its partials otherwise).
    Age-gated (``SORT_SPILL_GC_AGE_S``): a concurrent sort's fresh files
    are never swept.  Returns the number of files reclaimed (recorded as
    the ``external.gc`` span)."""
    d = resolve_spill_dir(spill_dir)
    if age_s is None:
        age_s = float(knobs.get("SORT_SPILL_GC_AGE_S"))
    t0 = time.perf_counter()
    live: set[str] = set()
    for m in mfstlib.live_manifests(d):
        live.add(m.path)
        for mr in m.runs:
            live.add(mr.path)
            live.add(mr.path + ".pay")
            live.add(mr.path + ".fpr.json")
    now = time.time()
    reclaimed = 0
    freed = 0
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return 0
    for fn in names:
        if not fn.endswith(GC_SUFFIXES):
            continue
        p = os.path.join(d, fn)
        if p in live:
            continue
        try:
            st = os.stat(p)
        except OSError:
            continue
        if now - st.st_mtime < age_s:
            continue
        try:
            os.unlink(p)
        except OSError:
            continue
        reclaimed += 1
        freed += int(st.st_size)
    if reclaimed and tracer is not None:
        spans = _spans(tracer)
        if spans is not None:
            spans.record("external.gc", t0, time.perf_counter() - t0,
                         dir=d, reclaimed=reclaimed, bytes=freed,
                         age_s=float(age_s))
    return reclaimed
