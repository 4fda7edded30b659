"""The key-file CLI — the reference's own program contract (port of
``drivers/sort_cli.py``: the in-memory leg and the external leg).

    python -m mpitest_tpu_torch.cli <file> [debug]

* argv: a data file and an optional debug level (``atoi`` semantics: a
  non-numeric level is 0); another argument count prints ``Usage: <prog>
  <file: Data file to read>`` to stderr and exits 1, and an unreadable,
  malformed or empty file prints ``sort(): '<file>' is not a valid file
  for read.`` and exits 1.
* stdout: ``Each bucket will be put N items.`` (``SORT_ALGO=sample``, the
  default; N = ceil(n / P)), the ``[COMMON]``/``[MASTER]``/``[SLAVE]``
  protocol lines at debug >= 2 (in rank order), at debug > 2 the
  per-pass ``DUMP`` lines (radix, integer keys, each rank's block of the
  reference's block contract) and the full ``i|v`` dump, then ``The
  n/2-th sorted element: X``.
* stderr: ``Endtime()-Starttime() = T sec``, timed from after the file
  read to the materialized result (the external leg: from before the
  read, which it interleaves with the sort).
* exit 3 on :class:`SortIntegrityError`, 4 on :class:`SortRetryExhausted`,
  each with one ``[ERROR]`` line; a bad knob value is one ``[ERROR]`` line
  and exit 1.

The file is read by ``utils/io.py`` (SORTBIN1 as an mmap, text through the
``SORT_NATIVE_ENCODE`` parser; the engine that ran is the tracer's
``encode_engine`` counter) and sorted by the same ``sort()`` the library
exposes, so ``SORT_LOCAL_ENGINE`` and ``SORT_EXCHANGE_ENGINE`` pick its
kernels.  ``SORT_RANKS`` (default: ``SORT_DEVICES``, one rank per card)
sets the mesh: P > 1 ranks run the distributed sort, round-robin over
the cards, so all of them share the card of a one-card machine;
``SORT_DIGIT_BITS``, ``SORT_CAP_FACTOR`` and ``SORT_OVERSAMPLE`` reach the
sort as in the reference.  It runs on the card unless :func:`main` is
given ``device="cpu"`` (then P ranks on the CPU).

With ``SORT_MEM_BUDGET`` > 0, a file larger than the budget and debug <= 0,
the sort runs out of core (``store/external.py``): budget-sized chunks are
sorted on the mesh and spilled to sorted runs, a streamed k-way merge
probes the median without holding the result, and the bucket line prints
once n is known.  Debug runs keep the in-memory path, as in the
reference.

Observability, off by default and outside the timed span, as in the
reference: ``SORT_METRICS=<path>`` appends one JSON sidecar line per run
(phase ms, Mkeys/s, counters, exchange bytes and GB/s; both legs);
``SORT_TRACE=<path>`` streams the span log as JSONL (``utils/spans.py``;
``SORT_TRACE_SAMPLE`` thins it); ``SORT_TRACE_CHROME=<path>`` writes the
run as Chrome trace-event JSON; ``SORT_PROFILE=<logdir>`` wraps the sort
in ``torch.profiler`` (CUDA activity on a card, a ``*.pt.trace.json``
artifact; ``utils/trace.torch_profile``).  A typed error dumps the flight
recorder's ring (``SORT_FLIGHT_RECORDER_SIZE``/``_DIR``).  What the port
cannot take yet ends with one ``[ERROR]`` line and exit 1:
``SORT_FAULTS`` and ``--explain``.
"""

from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from mpitest_tpu_torch.models import api, radix_sort
from mpitest_tpu_torch.models.supervisor import SortIntegrityError, SortRetryExhausted
from mpitest_tpu_torch.ops import radix
from mpitest_tpu_torch.ops.keys import codec_for, to_device_words, to_host_words
from mpitest_tpu_torch.parallel.mesh import Mesh, make_mesh
from mpitest_tpu_torch.store import external
from mpitest_tpu_torch.utils import io as kio
from mpitest_tpu_torch.utils import knobs, native_encode
from mpitest_tpu_torch.utils.knobs import NotPortedError
from mpitest_tpu_torch.utils.metrics import Metrics
from mpitest_tpu_torch.utils.trace import Tracer, torch_profile

EXIT_INTEGRITY = 3
EXIT_RETRIES = 4

#: Knobs of reference subsystems the port does not carry yet.
_UNPORTED_KNOBS = ("SORT_FAULTS",)

#: Knobs read later in the run, validated up front so garbage fails here.
_VALIDATED = ("SORT_INGEST", "SORT_INGEST_CHUNK", "SORT_INGEST_THREADS",
              "SORT_DONATE", "SORT_NATIVE_ENCODE",
              "SORT_VERIFY", "SORT_LOCAL_ENGINE", "SORT_MEM_BUDGET",
              "SORT_SPILL_DIR", "SORT_MERGE_FANIN", "SORT_SPILL_COMPRESS",
              "SORT_SPILL_THROTTLE_MBPS", "SORT_EXCHANGE_ENGINE",
              "SORT_DEVICES", "SORT_NEGOTIATE", "SORT_RESTAGE",
              "SORT_RESTAGE_RATIO", "SORT_TRACE_SAMPLE",
              "SORT_FLIGHT_RECORDER_SIZE", "SORT_FLIGHT_RECORDER_DIR")


def _error(msg: str) -> None:
    print(f"[ERROR] {msg}", file=sys.stderr)


def _invalid_file(path: str) -> int:
    print(f"sort(): '{path}' is not a valid file for read.", file=sys.stderr)
    return 1


def _refuse_unported() -> None:
    for name in _UNPORTED_KNOBS:
        if knobs.get(name):
            raise NotPortedError(f"{name}={knobs.get(name)!r}: not ported yet; "
                                 "unset it")


def _dump_metrics(config: dict, n: int, seconds: float, tracer: Tracer) -> None:
    """``SORT_METRICS=<path>``: append the run's sidecar line (the
    reference's config keys and metric names)."""
    metrics_path = knobs.get("SORT_METRICS")
    if metrics_path:
        m = Metrics(config=config)
        m.record("wall_time_s", round(seconds, 6), "s")
        m.throughput("sort_mkeys_per_s", n, seconds)
        m.record_tracer(tracer)
        m.dump(metrics_path)


def _mesh(ranks: int | None, dev: torch.device) -> Mesh:
    """``SORT_RANKS`` ranks (default ``SORT_DEVICES``): round-robin over
    the cards, or all on ``dev`` when it is the CPU."""
    if dev.type == "cpu":
        p = ranks or knobs.get("SORT_DEVICES") or 1
        return make_mesh(p, devices=[dev] * p)
    return make_mesh(ranks)


def radix_pass_states(keys: np.ndarray, digit_bits: int | None
                      ) -> Iterator[tuple[int, np.ndarray]]:
    """The keys after each LSD pass of the radix sort: pass k sorts stably
    by the digit (word, k-th shift) of the reference's plan, with
    ``digit_bits`` (auto: 16 when that needs fewer passes than 8).  Every
    pass places each key at its global digit-stable position, so the
    state is the same on any number of ranks.  Debug output only; runs
    the plain pass on the host."""
    codec = codec_for(keys.dtype)
    words_np = codec.encode(np.asarray(keys).reshape(-1))
    diffs = api._word_diffs(words_np)
    if digit_bits is None:
        digit_bits = api._auto_digit_bits(diffs)
    plan = radix_sort._plan(codec.n_words, digit_bits,
                            api._passes_from_diffs(diffs, digit_bits))
    planes = tuple(to_device_words(w, "cpu") for w in words_np)
    for k, (widx, shift) in enumerate(plan, 1):
        planes = radix.radix_pass_plain(planes, widx, shift, digit_bits)
        yield k, codec.decode(tuple(to_host_words(p) for p in planes))


def main(argv: list[str] | None = None, device: torch.device | str | None = None,
         tracer: Tracer | None = None) -> int:
    argv = sys.argv if argv is None else argv
    if "--explain" in argv:
        _error("--explain: plan provenance is not ported yet; run without it")
        return 1
    if len(argv) not in (2, 3):
        print(f"Usage: {argv[0]} <file: Data file to read>", file=sys.stderr)
        return 1
    path = argv[1]
    debug = 0
    if len(argv) == 3:
        m = re.match(r"\s*[+-]?\d+", argv[2])
        debug = int(m.group()) if m else 0
    tracer = tracer or Tracer()
    tracer.level = debug

    try:
        algo = knobs.get("SORT_ALGO")
        dtype = knobs.get("SORT_DTYPE")
        digit_bits = knobs.get("SORT_DIGIT_BITS")
        ranks = knobs.get("SORT_RANKS")
        cap_factor = knobs.get("SORT_CAP_FACTOR")
        oversample = knobs.get("SORT_OVERSAMPLE")
        for name in _VALIDATED:
            knobs.get(name)
        _refuse_unported()
        tracer.counters["encode_engine"] = native_encode.engine()
        dev = api.resolve_device(None, device)
        mesh = _mesh(ranks, dev)
    except (ValueError, RuntimeError) as e:
        _error(str(e))
        return 1
    mem_budget = knobs.get("SORT_MEM_BUDGET")
    try:
        file_bytes = Path(path).stat().st_size
    except OSError:
        return _invalid_file(path)
    if mem_budget and file_bytes > mem_budget and debug <= 0:
        return _external_main(path, dtype, algo, mem_budget, mesh, tracer)

    try:
        keys = kio.read_keys_auto(path, dtype=dtype, mmap=True)
    except (OSError, ValueError, OverflowError):
        return _invalid_file(path)
    n = keys.size
    if n == 0:
        return _invalid_file(path)

    n_ranks = mesh.size
    for r in range(n_ranks):
        tracer.common(f"Working {r}/{n_ranks}", min_level=2)
    tracer.master(f"Read file: {path}")
    tracer.master(f"File read OK, {n} numbers {keys[0]}-{keys[-1]}.")
    for r in range(1, n_ranks):
        tracer.slave(f"{r} Recv(size_input): {n}")
    if algo == "sample":
        print(f"Each bucket will be put {-(-n // n_ranks)} items.")

    start = time.perf_counter()  # after the file read
    try:
        with torch_profile(knobs.get("SORT_PROFILE"), mesh.devices):
            res = api.sort(keys, algorithm=algo, tracer=tracer,
                           return_result=True, mesh=mesh, digit_bits=digit_bits,
                           cap_factor=cap_factor, oversample=oversample)
            out = res.to_numpy(tracer=tracer)
    except SortIntegrityError as e:
        _error(f"sort integrity failure: {e}")
        return EXIT_INTEGRITY
    except SortRetryExhausted as e:
        _error(f"sort failed after retries: {e}")
        return EXIT_RETRIES
    end = time.perf_counter()

    chrome_path = knobs.get("SORT_TRACE_CHROME")
    if chrome_path:
        with open(chrome_path, "w") as f:
            json.dump(tracer.spans.to_chrome_trace(), f)
    _dump_metrics({"algo": algo, "n": n, "dtype": dtype.name, "ranks": n_ranks,
                   "digit_bits": digit_bits}, n, end - start, tracer)

    if debug > 2:
        mask = (1 << (8 * dtype.itemsize)) - 1
        if algo == "radix" and dtype.kind in "iu":
            # rank r's block: n//P + (r < n%P) keys (the reference's
            # block contract, whatever the padded shards hold)
            q, rem = divmod(n, n_ranks)
            for k, state in radix_pass_states(keys, digit_bits):
                off = 0
                for r in range(n_ranks):
                    cnt = q + (1 if r < rem else 0)
                    print(f"[COMMON] {r}: Main Queue Completed, LEN={cnt}")
                    for v in state[off:off + cnt]:
                        print(f"DUMP: LOOP {k} RADIX {r} = {int(v) & mask}")
                    off += cnt
        for i, v in enumerate(out):
            print(f"{i}|{v}" if dtype.kind == "f" else f"{i}|{int(v) & mask}")
    med = out[max(n // 2 - 1, 0)]
    if dtype.kind == "f":
        print(f"The n/2-th sorted element: {med}")
    else:
        print(f"The n/2-th sorted element: {int(med)}")
    print(f"Endtime()-Starttime() = {end - start:.5f} sec", file=sys.stderr)
    return 0


def _external_main(path: str, dtype: np.dtype, algo: str, mem_budget: int,
                   mesh: Mesh, tracer: Tracer) -> int:
    """The out-of-core leg: streamed external sort of ``path`` under
    ``SORT_MEM_BUDGET`` — chunks spill to sorted runs, the k-way merge
    streams past a running median probe, and the result is never
    materialized.  Same stdout/stderr/exit contract as the in-memory leg;
    the timer starts before the read, which is interleaved with the
    sort."""
    try:
        kio.sniff_format(path)
    except OSError:
        return _invalid_file(path)
    n_ranks = mesh.size
    probe: dict = {"off": 0, "med": None, "n": 0, "announced": False}

    def sink_factory(n: int):
        # called once per merge attempt (an integrity recovery re-runs the
        # merge): the probe restarts, so a recovered attempt never reports
        # a median captured from the aborted stream
        probe["off"], probe["med"], probe["n"] = 0, None, n
        if algo == "sample" and not probe["announced"]:
            # the reference's bucket line, printable once n is known
            print(f"Each bucket will be put {-(-n // n_ranks)} items.")
            probe["announced"] = True
        med_idx = max(n // 2 - 1, 0)

        def sink(k: np.ndarray, _p: object) -> None:
            off = probe["off"]
            if off <= med_idx < off + int(k.size):
                probe["med"] = k[med_idx - off]
            probe["off"] = off + int(k.size)

        return sink

    start = time.perf_counter()
    try:
        external.external_sort_file(
            path, dtype=dtype, algorithm=algo, mesh=mesh, tracer=tracer,
            budget=mem_budget, sink="array", sink_factory=sink_factory)
    except SortIntegrityError as e:
        _error(f"sort integrity failure: {e}")
        return EXIT_INTEGRITY
    except SortRetryExhausted as e:
        _error(f"sort failed after retries: {e}")
        return EXIT_RETRIES
    except (OSError, ValueError, OverflowError):
        return _invalid_file(path)
    end = time.perf_counter()
    if probe["n"] == 0:
        return _invalid_file(path)
    _dump_metrics({"algo": algo, "n": probe["n"], "dtype": dtype.name,
                   "ranks": n_ranks, "external": True},
                  probe["n"], end - start, tracer)
    med = probe["med"]
    if dtype.kind == "f":
        print(f"The n/2-th sorted element: {med}")
    else:
        print(f"The n/2-th sorted element: {int(med)}")
    print(f"Endtime()-Starttime() = {end - start:.5f} sec", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
