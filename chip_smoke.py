#!/usr/bin/env python3
"""Smoke run of mpitest_tpu_torch on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Phases, each failing loudly (any exception exits non-zero):

1. build   — compile every ``mpitest_tpu_torch/csrc/*.cu`` with nvcc (all
             started together) into ``build/kernels/``, and the host text
             parser (``native/encode.c``) into ``build/native/``; print the
             build time and the card's name and power limit.
2. kernels — each CUDA kernel against its plain PyTorch version on the
             card: K1 (bitonic_u32) at 2^20 and 2^24 over adversarial
             patterns (6 and 10 merge rounds), K2 (bitonic_pairs_u32) at
             2^20, keys and payload byte-equal, K3
             (fix_runs_pairs) alone and as phase B (``fix_runs_flag``:
             K3, the boundary-strip kernel and the residual flag) at
             2^20 with planted runs of up to 40, 0..32 passes, lo bytes
             and flag,
             K4 (radix_histogram + radix_pass, onesweep) at 2^20: one,
             two and four planes, full and compacted plans, the payload
             shape ``(digit,) + 2 words`` with diffs (255, 0, 0), n = 2^20
             - 3001, and the all-equal, sorted, reversed and 0xFFFFFFFF
             patterns; all-equal keys at 2^24 (every tile looks back on
             one bin), one digit spread over 256 values, the distributed
             pass 1 shape (one pass, three payload planes) at 2^22, four
             planes with top digits of 1-7 bits, and the tile edges (n =
             1..33, tile - 1, tile, tile + 1).  K5
             (segment_pack) and K6 (fused_pass_pack, 1-3 planes) at P = 8
             over 2^25 - 777 keys (n not a multiple of 1024) with ragged,
             empty and overflowing (cnt > cap) segments; K7 (remote_a2a)
             over eight [8, 2^22] send matrices.  K8 (merge_order, a
             cluster of 8 CTAs a row block) at n in {2, 3, 255, 256, 257,
             1000, 1024, 1025, 4095, 4096}, 3 and 4 planes (1..8 at 257
             and 4096; every key tied),
             dup-heavy key words with 0xFFFFFFFF and 0x80000000, shuffled
             positions, against its plain version and np.lexsort; n = 4097
             must raise.  The verifier's scan (``verify_scan``,
             :func:`verify_phase`): one plane of
             2^30, eight shards of 2^25 (``verify_result`` clean, with a
             broken seam between shards and with a duplicated key), two
             planes of 2^27, planes one word past a 16-byte boundary (a
             one-word head) and at different offsets (the one-word loop),
             each with faults at the seams of its vectors, warps and blocks and
             at the last pair, every row equal to the plain version's;
             timed beside its bound and the PyTorch chain it replaces.
             The placement (``slot_place``, :func:`slot_place_phase`) and
             the digit sort (``digit_count`` + ``digit_scatter``,
             :func:`digit_sort_phase`) on rank 0's calls of one
             eight-rank radix sort of 2^28 int32 keys, the sort's exact
             launches of each, against the plain versions, timed beside
             their bounds and the library calls they replaced.
             Tolerance: exact (integer words; every byte must match).
3. main    — three paths, each with the launch counts set to 0 just
             before it and read just after; in (a), (b), (d) and (e) each
             call makes one ``verify_scan`` a shard for its result check,
             and one more a shard where its input is on the card:
             (a) ``mpitest_tpu_torch.sort()`` at full size with
             verification on: int32 2^28 from the host and resident on
             the card, int64 2^27, the constant-word and hi-duplication
             int64 routes at 2^26, the residual fallback at 2^26 from the
             host and resident on the card (hi runs of 24: K2 + K3, flag
             set, ``pair_residual_fallback`` = 1),
             float32 2^24 with NaN/±0/±inf, and a
             non-power-of-two int32 that pads to 2^26 (K1-K3);
             (b) ``sort()`` under ``SORT_LOCAL_ENGINE=radix_pallas`` at
             2^20 (K4: one histogram launch a sort, one pass launch a
             planned pass): compacted and full plans, the 64-bit constant-word
             route on host and device input, the general 64-bit route at
             5000 keys and the lax route past the envelope;
             (c) the key-file CLI in process (``mpitest_tpu_torch.cli``):
             a 2^28 int32 SORTBIN1 file and a 2^22 int32 text file under
             ``auto`` (K1), a 2^20 text file under ``radix_pallas`` (K4).
             (d) ``sort(x, mesh=make_mesh(8))``, radix, eight ranks on the
             card, exchange engine ``pallas`` (K6 + K7): int32 2^28 from
             the host and resident on the card, int64 2^27, float32 2^24
             with NaN/±0/±inf, N < P and non-divisible N, sorted-skew 2^24
             (``skew_restage`` >= 1); under ``SORT_EXCHANGE_ENGINE=lax``
             (K5) at 2^26; under ``radix_pallas`` at 2^23 (K4 as pass 1);
             (e) sample sort on eight ranks: int32 2^28 (K1 inside), int64
             2^27 (K2 + K3 inside), duplicate-skew (``sample_skew_fallback``
             = 1);
             (f) the CLI with ``SORT_RANKS=8`` on a 2^28 SORTBIN1 file,
             ``sample`` and ``radix``;
             (g) ``external_sort()`` under ``radix_pallas`` at fan-in 4
             (K4 chunk sorts, K8 merge rounds): int32 2^22 at a 98304-byte
             budget (683 runs, 5 merge passes; cut from 2^24 and 2^23,
             whose host-bound merges took 163 and 67 s) and int64 2^21 at
             196608 (342 runs, 5 passes; cut from 2^22, 47 s); K8's
             launches must equal the merge
             rounds of 2..4096 records, counted by wrapping
             ``store.merge._order_for``, K4's histograms the runs (one
             chunk sort a run) and its pass launches the planned passes;
             (h) the CLI's external leg: a 2^25 int32 SORTBIN1 file at
             ``SORT_MEM_BUDGET=16777216`` (``auto``, K1 chunk sorts of 2^20:
             32 runs, 2 passes at fan-in 16; cut from 2^26, which takes more
             than a minute on an H100) and ``SORT_RANKS=8 SORT_ALGO=radix`` on
             a 2^24 file at 4 MiB (64 runs, K6/K7 inside).
             (i) this slice's paths: the record sort ``sort(x, payload=)``
             on int32 2^25 with uint64 row ids, int64 2^24 with 10-byte
             records and int32 2^24-5 of 2^10 distinct keys plus all-ones
             keys that tie with the pad lanes (against the stable
             argsort-gather on the card; no
             hand-written kernel launches: the reference's ``lax.sort``);
             a packed batch of 64 requests filling 2^16 keys in int32,
             int64 and float32 (every segment equals its own ``sort()``,
             ``verify_segments`` flags one planted bad segment only);
             ``ingest_to_mesh(make_mesh(1))`` then ``sort(staged)`` on
             int32 2^28 (K1) and int64 2^27 (K2 + K3) with the ingest's
             stage seconds and overlap, and the staged int32 sort's
             ``max_memory_allocated`` under ``SORT_DONATE=0`` and ``1``;
             ``external_sort`` of int32 2^22 with 8-byte payloads at a 4
             MiB budget (equal to the in-memory record sort, runs and
             passes as computed from the budget).  The host inputs of
             (d)-(f) at 32 MiB or more stream onto the eight ranks
             (``ingest.pipeline`` span asserted) and their contiguous
             results stream back through ``to_numpy(tracer)``
             (``egress.*`` spans, one fetch a rank).
             (j) the telemetry layer on the card: the wall of
             ``sort(cuda int32 2^28)`` on one rank and of the radix and
             sample sorts on eight ranks with tracing off, with
             ``SORT_TRACE`` + ``SORT_TRACE_CHROME`` on (the Chrome export
             in the wall) and with ``SORT_TRACE_SAMPLE=0.1`` (one tracer
             over ten calls streams exactly one call's lines), median of
             5, with the streamed lines a call; each streamed file held
             to the port report's ``check_rows`` (required keys, dt >= 0,
             parents that resolve) with every name registered in the
             port's ``span_schema``, the
             eight-rank radix file to one ``radix_pass`` and one
             ``ragged_all_to_all`` (``wire_bytes`` > 0) a planned pass,
             ``exchange_balance``, and a ``sort`` span with
             ``device_mem_peak_bytes`` > 0; phase ``sort``'s host ms beside
             CUDA events around the same region (one and eight ranks); the
             CUDA runtime's synchronize calls in a profile of one eight-rank
             sort, traced and untraced, equal; ``SORT_PROFILE`` through the
             CLI on a 2^24 SORTBIN1 file on eight ranks (radix) with the
             trace, Chrome and metrics sinks: its ``*.pt.trace.json``
             must hold the ``pack_rows`` (fused_pass_pack) and
             ``a2a_push`` (remote_a2a) kernels, and the card's busy share
             is printed; the same profiler's busy share of the external
             record leg (int32 2^22, 8-byte payload, 4 MiB) and the record
             sort at int32 2^25; the CLI on a 2^28 SORTBIN1 file untraced
             and with ``SORT_METRICS`` + ``SORT_TRACE`` +
             ``SORT_TRACE_CHROME`` (the sidecar's ``sort_mkeys_per_s``
             beside both timing lines); and a flight-recorder dump, held
             to the same check.
             (k) the fault grid (``fault_phase``, with
             ``SORT_RETRY_BACKOFF=0``): int32 2^28 from the host on eight
             ranks, clean and under ``dispatch_error:1`` (radix; the
             donated words re-streamed), ``exchange_corrupt:1`` (sample)
             and ``result_dup:1`` (radix; caught by the fingerprint
             alone); every device site x {radix, sample} at int32 2^24,
             the persistent cells (``dispatch_oom:inf`` with the ladder on
             and off, ``result_dup:inf`` off), ``dispatch_error:3`` (the
             ``lax`` engine rung, K5), ``result_dup:2`` (on CUDA ranks
             ``SortIntegrityError``: a twice-failed verification ends on
             its rung) and ``exchange_corrupt:1`` on int64 sample (K2 +
             K3); the full-width cells three rounds each, beside a clean
             twin a round; a K6 launch refused with
             ``KernelLaunchError`` must leave ``sort()`` unretried and
             undegraded, a real OOM in K6's wrapper must end in
             ``SortRetryExhausted`` after its retries, undegraded, and a
             failing K4 under ``radix_pallas`` must
             degrade only the local engine (or raise with the ladder off);
             the full descent at 2^26 with each rung's wall; the eight
             store sites through ``external_sort`` of int32 2^20 (16 runs,
             two passes at fan-in 4) and ``spill_corrupt:1`` under
             ``radix_pallas`` (K8 in the recovery merges); the CLI's exits
             3, 4 and 1 at ``SORT_RANKS=8``.  Each cell ends verified and
             byte-equal to ``torch.sort`` on the card, or with the typed
             error the CPU parity tests fix; every fault must fire.
             (l) the planner mix and the doctor (``planner_phase``, the
             twins of the reference's ``bench/planner_selftest.py`` and
             ``bench/doctor_selftest.py``): five host int32 2^28 inputs
             from seed 2026 (sorted, near-sorted, duplicate-heavy,
             range-narrow, uniform) on eight ranks under
             ``SORT_PLANNER=off``, ``shadow`` and ``on``, each byte-equal
             to ``torch.sort``; shadow byte-equal to off; the expected
             policy a input under ``on`` (``verify_passthrough``,
             ``merge_sample``, ``radix_narrow``, ``radix_compact``,
             ``static``), one passthrough on the sorted input, the
             predicted two passes run on the range-narrow one; a sorted
             input with one hidden descent misses the passthrough on eight
             ranks and on one (``planner_passthrough_miss`` = 1), the
             one-rank passthrough beside it; ``radix_compact`` under
             ``radix_pallas`` at 2^23 (K4); one planted trace a doctor
             rule, a clean eight-rank sample sort raising no finding,
             ``python -m mpitest_tpu_torch.report --explain``, ``--doctor``
             and ``--check`` over the phase's trace, and the CLI's
             ``--explain`` on a 2^24 SORTBIN1 file.  It prints each
             input's host wall and ``plan_regret`` a mode and the mix's
             off/on wall ratio (not asserted).
             (m) the sort server on the card (``serve_phase``, the twin of
             the reference's ``bench/serve_load.py``): in-process
             ``SortServer``s on ``127.0.0.1:0`` driven through the port's
             client over real sockets — the mixed load (8 closed-loop
             clients, 160 requests of 2^7-2^10 int32 keys) against an
             8 ms-window server and a window-0 server with the four gates
             (warm cache, batched dispatch keys/s >= 2x window 0, typed
             backpressure at ``SORT_SERVE_MAX_INFLIGHT=1``, a poisoned
             request typed ``integrity`` on eight ranks); one scrape of
             ``/metrics``, ``/healthz`` and ``/varz`` equal to the
             clients' counts; solo int32 2^26 (K1) and int64 2^25 (K2,
             K3) on one rank, int32 2^26 on a ``SORT_DEVICES=8`` server
             with radix and sample (K6, K7); a record request (2^24, 8
             payload bytes); a spill request (2^24 against 2^25 bytes);
             the watchdog drill (``dispatch_stall``: trip, typed
             rejection, a flight artifact through ``check_rows``,
             half-open recovery); ``python -m
             mpitest_tpu_torch.sort_server`` in a subprocess (listening
             line, a round trip, SIGTERM drain, exit 0).  Every reply
             equals ``np.sort``; the phase's timings line (p50/p99,
             dispatch keys/s and their ratio, prewarm, first and warm
             solo latency, the server's wall against an in-process
             ``sort()``, the phase wall) comes before the kernels line.
             (n) the reference's spawned-server gates against the port's
             server as its own process (``spawned_phase``,
             ``mpitest_tpu_torch/selftest/``): the live-telemetry leg on
             eight ranks (trace ids rebuilt by ``report --trace-id``,
             ``/metrics`` reconciled, every side-port route, a fault's
             flight dump through ``--check``, a sampled stream, the
             explain leg), the mix's p50/p99 with the clients in this
             process and the wire-chaos cells on one rank (torn header,
             stalled payload, RST mid-payload, slow drip, disconnect
             mid-response, connect-then-silence, each followed by the
             four recovery checks), the watchdog cell on eight ranks, the
             hedging cell, kill and resume (int32 2^24 against 2^25
             bytes), and the sentinel cells; each leg's solo int32 2^26
             request asserts its kernels in the server through ``/varz``
             (K1 on one rank, K6 and K7 on eight, K1 for the spill chunk
             sorts).
             (o) ``parallel.multihost_init`` over NCCL in a subprocess
             (``multihost_phase``): one process, one ``all_reduce``, then
             ``sort()`` of int32 2^28 on ``make_mesh(1)`` (K1) and
             ``make_mesh(8)`` (K6, K7), bytes equal to ``torch.sort``,
             ``destroy_process_group()`` in a ``finally``.
             (p) the radix sort across two processes on the one card
             (``crossprocess_phase``): the single-controller sort of the
             same host keys first (``make_mesh(P)``, its counters and
             warm wall), then two children join a gloo group
             (``multihost_init``; NCCL refuses two ranks on one GPU) and
             sort on the global mesh: 2 x 4 ranks of int32 2^28 (phase
             4's eight-rank shape) and 2 x 1 of int64 2^26.  Each child
             holds its shards to ``torch.sort``, the combined
             ``Fingerprint`` to the input's, the median probe across
             processes and to the oracle, the exchange counters to the
             single-controller run's, K6 and K7 in its own launches,
             ``to_numpy`` and ``algorithm="sample"`` to ``RuntimeError``,
             and K7 across processes (CUDA IPC) byte-equal to the
             host-staged transport; it prints the walls beside the
             single-controller's, the control-group seconds, the handle
             mapping, the barrier waits and K7's device ms.
             (q) the sort server across two processes on the one card
             (``serve_crossprocess_phase``): two children join a gloo
             group and each serves ``ServerCore()`` over the global mesh
             (prewarmed, watchdog on, 8 ms window, its own trace,
             flight-recorder and spill paths) through a ``SortServer``
             and a ``TelemetryServer``; this process runs the mixed load
             (four clients to each server, every reply equal to
             ``np.sort``, p50/p99 per server), int64 and float32 at the
             packed maximum (2^16) to each, a solo int32 2^26 request to
             server 0 only (``internal`` within 5 s while server 1
             serves, both ``/healthz`` 200), a record request (int32
             2^20, 8 payload bytes: ``ok`` from server 0, ``bad_request``
             from server 1) and a spill request (``internal``) to each;
             ``/varz`` shows the two-rank mesh and no kernel launched by
             the served requests, and no control-group round runs after
             the cores are built.
             Every clean phase (1-4) asserts that no Tracer it created
             holds a fault or ladder counter (``LADDER_COUNTERS``).
             Every output equals its oracle (np.sort, or torch.sort on the
             card for the large rows and every mesh row; the CLI's probe
             equals the (n/2)-th element of np.sort); the ``local_engine``
             counter, the kernel launch counts and K4's pass counts are
             asserted.
4. timing  — CUDA events, warm median: each kernel at the main path's
             shape beside its plain version, its bound and torch.sort (K1
             and K2 with their pass counts and design floors; K3 alone
             and phase B at 2^27 on K2's output (the kernels line: phase
             B) and on planted runs of 1..16 and 1..24; K4
             at 2^28 one word with K4 byte-equal to plain there, 2^27 two
             words, 2^20 and 6144 keys (an external chunk sort), each with
             its ms a pass and its design floor); end-to-end sort() of the
             device-resident
             inputs; the CLI's own timing line and wall time on the 2^28
             SORTBIN1 file; K5/K6 at the mesh paths' shapes on even
             starts and on starts at every residue mod 4 (one launch
             through the wrapper, the kernels line's on the latter, and
             the mean of 50 back to back through the C entry), K7 there
             too, beside their plain versions, their bounds and (K7) one
             ``copy_`` of the transposed [P, P, cap] view; end-to-end
             sort() on eight ranks of device-resident int32 2^28 (radix
             and sample) and int64 2^27 beside one rank (each timed run
             must emit one ``sort.plan`` span), and of int32
             2^26 under the lax exchange engine (K5); K8 at n = 4096 and 1024 with 3 and 4
             planes (one launch through the wrapper, which the kernels
             line keeps, and the mean of 50 launches back to back through
             the C entry; the round trip of merge_order_host,
             the plain version, and the host np.lexsort of the same
             planes);
             the wall of each external leg; phase 3k's walls (each fault
             beside the clean wall, the descent's rungs); phase 3l's walls,
             regrets and mix ratio; phase 3i's notes (record sort
             Mkeys/s, ingest stage seconds and overlap, donation memory),
             its wall, phase 3j's notes and wall, phase 3m's, 3n's (with
             the spawned mix's p50/p99), 3o's and 3p's walls (3p's
             cross-process walls beside the single-controller ones, and
             K7 across processes), 3q's wall and per-server p50/p99, and
             the smoke's total wall.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 2
before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and the
# non-tensor-core 32-bit rate, which bounds the integer compares here.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S_32BIT = 67e12
REPS = 5          # warm repetitions for kernel / library / end-to-end times
PLAIN_REPS = 3    # the plain versions take seconds per call at full size

SOURCES = {
    "bitonic_u32": "mpitest_tpu_torch/csrc/bitonic.cu",
    "bitonic_pairs_u32": "mpitest_tpu_torch/csrc/bitonic.cu",
    "fix_runs_pairs": "mpitest_tpu_torch/csrc/bitonic.cu",
    "radix_pass": "mpitest_tpu_torch/csrc/radix.cu",
    "segment_pack": "mpitest_tpu_torch/csrc/exchange.cu",
    "fused_pass_pack": "mpitest_tpu_torch/csrc/exchange.cu",
    "remote_a2a": "mpitest_tpu_torch/csrc/exchange.cu",
    "merge_order": "mpitest_tpu_torch/csrc/merge.cu",
}
REPLACES = {
    "bitonic_u32": "mpitest_tpu/ops/bitonic.py:308,351,371,514,571",
    "bitonic_pairs_u32": "mpitest_tpu/ops/bitonic.py:703,737,758,970,1038",
    "fix_runs_pairs": "mpitest_tpu/ops/bitonic.py:1101",
    "radix_pass": "mpitest_tpu/ops/radix_pallas.py:186",
    "segment_pack": "mpitest_tpu/ops/pallas_kernels.py:139",
    "fused_pass_pack": "mpitest_tpu/ops/exchange.py:159",
    "remote_a2a": "mpitest_tpu/ops/exchange.py:244",
    "merge_order": "mpitest_tpu/ops/radix_pallas.py:296",
}
RANKS = 8
#: 32-bit operations per element per K4 pass: two digit extractions
#: (shift, mask) for the histogram and the scatter, one histogram add and
#: one rank add.
K4_OPS_PER_ELEM_PASS = 6


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def env(**values: str | None):
    """Knobs set (``None``: unset) for a block: the port's
    ``knobs.scoped_env``, imported at the call so that the script alone
    still reaches its CUDA check."""
    from mpitest_tpu_torch.utils.knobs import scoped_env

    return scoped_env(**values)


#: Counters a clean run never sets: a fault fired, a dispatch retried, a
#: verification failed or the ladder descended.  Every clean phase holds
#: every tracer it created to this, so a kernel that produced wrong bytes
#: can never be absorbed by the ladder unseen.
LADDER_COUNTERS = ("faults_injected", "sort_retries", "verify_failures",
                   "exchange_engine_degraded", "local_engine_degraded", "degraded_to")

#: Phase 3k's sizes on the card: the full-width cells, the site grid, the
#: full descent, the store sites (16 runs, two passes at fan-in 4), the K8
#: store cell and the CLI file.
FAULT_SIZES = {"full": 1 << 28, "grid": 1 << 24, "descent": 1 << 26,
               "drill": 1 << 23, "store": 1 << 20, "store_budget": 1 << 20,
               "k8": 98304, "k8_budget": 98304, "cli": 1 << 20}
#: Rounds of the full-width cells: each fault wall beside its round's clean.
FULL_ROUNDS = 3


def fault_phase(dev, mesh, rng, sizes: dict, log) -> tuple[dict, list[str]]:
    """Phase 3k: the fault grid on the card.  Every cell ends verified and
    byte-equal to a ``torch.sort`` oracle, or with the typed error the CPU
    parity tests fix for its spec; a silently wrong answer, or a fault that
    never fired, fails the phase.  Returns the kernel launches of each
    cell and the timing notes."""
    import numpy as np
    import torch

    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch import cli, faults
    from mpitest_tpu_torch.models import ingest
    from mpitest_tpu_torch.models import supervisor as supervision
    from mpitest_tpu_torch.ops import _build, exchange, radix
    from mpitest_tpu_torch.store import external
    from mpitest_tpu_torch.utils import io as kio
    from mpitest_tpu_torch.utils.trace import Tracer

    cells: dict[str, dict] = {}
    notes: list[str] = []
    typed = (mt.SortIntegrityError, mt.SortRetryExhausted, external.SpillCapacityError)

    def keys32(n: int) -> np.ndarray:
        return rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)

    def oracle(x: np.ndarray) -> bytes:
        return torch.sort(torch.from_numpy(x).to(dev)).values.cpu().numpy().tobytes()

    def cell(label: str, x, algo: str, spec: str, expect: str, want: bytes | None,
             fallback: str = "1", sort=None, **counters) -> tuple[float, Tracer]:
        base = dict(_build.LAUNCHES)
        reg = faults.FaultRegistry(spec, seed=7) if spec else None
        faults.install(reg)
        tr = Tracer()
        t = time.perf_counter()
        try:
            with env(SORT_FALLBACK=fallback):
                got = (sort(tr) if sort is not None
                       else mt.sort(x, algorithm=algo, mesh=mesh, tracer=tr))
            outcome = "verified"
        except typed as e:
            got, outcome = None, type(e).__name__
        finally:
            faults.install(None)
        wall = time.perf_counter() - t
        if outcome != expect:
            raise AssertionError(f"3k {label}: {outcome}, expected {expect}")
        if outcome == "verified":
            if got.tobytes() != want:
                raise AssertionError(f"3k {label}: a silently wrong answer")
            if tr.counters.get("verify_runs", 0) < 1:
                raise AssertionError(f"3k {label}: result not verified")
        if reg is not None and reg.injected == 0:
            raise AssertionError(f"3k {label}: the fault never fired")
        for name, v in counters.items():
            val = tr.counters.get(name)
            if not (v(val) if callable(v) else val == v):
                raise AssertionError(f"3k {label}: counter {name}={val}")
        cells[label] = {k: _build.LAUNCHES[k] - base[k] for k in base
                        if _build.LAUNCHES[k] != base[k]}
        shown = {k: tr.counters[k] for k in ("faults_injected", "faults_dropped",
                                             "sort_retries", "verify_failures",
                                             "exchange_retries", "exchange_engine_degraded",
                                             "local_engine_degraded", "degraded_to")
                 if k in tr.counters}
        log(f"[faults] {label}: {outcome}, {shown}, launches {cells[label]}, "
            f"wall {wall:.3f} s")
        return wall, tr

    with env(SORT_RETRY_BACKOFF="0"):
        # ---- full width: the main path's size, each fault beside the clean
        # wall; three rounds, each cell once a round, so every fault wall
        # has a clean twin from its own round and the medians share a card
        x = keys32(sizes["full"])
        want = oracle(x)
        full = (("dispatch_error:1", "radix", {"sort_retries": 1}),
                ("exchange_corrupt:1", "sample", {"verify_failures": 1}),
                ("result_dup:1", "radix", {"verify_failures": 1}))
        walls: dict[str, list[float]] = {}
        for _ in range(FULL_ROUNDS):
            for algo in ("radix", "sample"):
                walls.setdefault(f"clean {algo}", []).append(cell(
                    f"clean {algo} int32 {x.size} P=8", x, algo, "", "verified",
                    want)[0])
            for spec, algo, check in full:
                wall, tr = cell(f"{spec} {algo} int32 {x.size} P=8", x, algo, spec,
                                "verified", want, **check)
                walls.setdefault(spec, []).append(wall)
                verdicts = [s.attrs for s in tr.spans.spans if s.name == "verify"]
                if spec.startswith("result_dup") and not (
                        verdicts[0]["sorted_ok"] and not verdicts[0]["fp_ok"]):
                    raise AssertionError(f"3k {spec}: not caught by the fingerprint "
                                         f"alone ({verdicts[0]})")
                if spec.startswith("dispatch_error") and x.nbytes >= ingest.STREAM_MIN_BYTES:
                    # host input streams; the failed dispatch dropped the
                    # donated words, and the retry re-streamed them
                    pipes = sum(1 for s in tr.spans.spans if s.name == "ingest.pipeline")
                    if pipes != 2:
                        raise AssertionError(f"3k {spec}: {pipes} ingest pipelines, "
                                             "expected the rebuild's second")
        for spec, algo, _ in full:
            got, twin = walls[spec], walls[f"clean {algo}"]
            deltas = [a - b for a, b in zip(got, twin)]
            notes.append(
                f"{spec} {algo} sort(np int32 {x.size}, P=8): walls "
                f"{[round(w, 3) for w in got]} s, median {statistics.median(got):.3f} s, "
                f"beside the clean {algo} walls {[round(w, 3) for w in twin]} s, "
                f"median {statistics.median(twin):.3f} s; the round's delta median "
                f"{statistics.median(deltas):+.3f} s, range {min(deltas):+.3f} to "
                f"{max(deltas):+.3f} s (host clock)")
        del x, want

        # ---- the grid: every device site x {radix, sample}
        x = keys32(sizes["grid"])
        want = oracle(x)
        for site in ("dispatch_error", "dispatch_oom", "dispatch_stall",
                     "exchange_corrupt", "exchange_drop", "cap_squeeze",
                     "ingest_poison", "result_swap", "result_dup"):
            check = ({"sort_retries": 1} if site in ("dispatch_error", "dispatch_oom")
                     else {"exchange_retries": lambda v: (v or 0) >= 1}
                     if site == "cap_squeeze"
                     else {} if site == "dispatch_stall"
                     else {"verify_failures": 1})
            for algo in ("radix", "sample"):
                with env(SORT_INGEST="stream" if site == "ingest_poison" else "auto"):
                    cell(f"{site} {algo} int32 {x.size}", x, algo, site, "verified",
                         want, **check)
        for spec, fallback, expect in (("dispatch_oom:inf", "1", "verified"),
                                       ("dispatch_oom:inf", "0", "SortRetryExhausted"),
                                       ("result_dup:inf", "0", "SortIntegrityError")):
            for algo in ("radix", "sample"):
                check = {"degraded_to": "host"} if expect == "verified" else {}
                cell(f"{spec} fallback={fallback} {algo} int32 {x.size}", x, algo,
                     spec, expect, want, fallback=fallback, **check)
        # a dispatch that fails past its retries on the pallas engine: the
        # ladder's engine rung re-runs radix on the lax engine (K5 packs)
        cell(f"dispatch_error:3 radix int32 {x.size} (the lax engine rung)", x,
             "radix", "dispatch_error:3", "verified", want, sort_retries=2,
             exchange_engine_degraded=1, exchange_engine="lax")
        # on CUDA ranks a result that fails its verification twice ends on
        # its rung (CPU ranks keep the reference's descent)
        strict = supervision.strict_ladder(dev.type)
        cell(f"result_dup:2 radix int32 {x.size}", x, "radix", "result_dup:2",
             "SortIntegrityError" if strict else "verified", want, verify_failures=2,
             exchange_engine_degraded=None if strict else 1)
        x64 = rng.integers(-(2**63), 2**63 - 1, sizes["grid"], dtype=np.int64)
        cell(f"exchange_corrupt:1 sample int64 {x64.size}", x64, "sample",
             "exchange_corrupt:1", "verified", oracle(x64), verify_failures=1,
             local_engine="bitonic")
        del x64

        # ---- drills that must raise, and the local-engine rung
        real_launch = _build.launch

        def refused(lib, name, *a):
            if name == "fused_pass_pack":
                raise _build.KernelLaunchError(
                    "CUDA kernel fused_pass_pack failed: injected refusal (code 1)")
            return real_launch(lib, name, *a)

        tr = Tracer()
        real_k6 = exchange.fused_pass_pack
        if dev.type == "cuda":
            _build.launch = refused
        else:   # the plain version launches nothing: refuse at the wrapper
            exchange.fused_pass_pack = lambda *a, **k: refused(None, "fused_pass_pack")
        try:
            with env(SORT_FALLBACK="1"):
                mt.sort(x, algorithm="radix", mesh=mesh, tracer=tr)
        except _build.KernelLaunchError:
            bad = [c for c in LADDER_COUNTERS if c in tr.counters]
            if bad:
                raise AssertionError(f"3k K6 refusal: retried or degraded ({bad})")
            log("[faults] K6 launch refused under SORT_FALLBACK=1: KernelLaunchError "
                "propagated out of sort(), no retry, no degrade, no host result")
        else:
            raise AssertionError("3k K6 refusal: sort() returned")
        finally:
            _build.launch = real_launch
            exchange.fused_pass_pack = real_k6
        # a real OOM in K6's wrapper: retried on the same kernels, then
        # SortRetryExhausted on CUDA ranks, never the plain pack or the host
        def oom(*a, **k):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (drill)")

        exchange.fused_pass_pack = oom
        try:
            cell(f"K6 out of memory radix fallback=1 int32 {x.size}", x, "radix", "",
                 "SortRetryExhausted" if strict else "verified", want, sort_retries=2,
                 exchange_engine_degraded=None if strict else 1)
        finally:
            exchange.fused_pass_pack = real_k6
        del x, want
        xd = keys32(sizes["drill"])
        want = oracle(xd)
        real_fused = radix.fused_radix_sort

        def dead_fused(*a, **k):
            raise faults.DeviceDispatchError("INTERNAL: injected fused local-sort fault")

        radix.fused_radix_sort = dead_fused
        try:
            with env(SORT_LOCAL_ENGINE="radix_pallas", SORT_MAX_RETRIES="0"):
                cell(f"K4 dispatch failure radix_pallas fallback=1 int32 {xd.size}", xd,
                     "radix", "", "verified", want, local_engine_degraded=1,
                     local_engine="lax", exchange_engine_degraded=None)
                cell(f"K4 dispatch failure radix_pallas fallback=0 int32 {xd.size}", xd,
                     "radix", "", "SortRetryExhausted", want, fallback="0")
        finally:
            radix.fused_radix_sort = real_fused
        del xd, want

        # ---- the full descent: the user's time to recover on a dead device
        x = keys32(sizes["descent"])
        want = oracle(x)
        wall, tr = cell(f"dispatch_oom:inf fallback=1 radix int32 {x.size} (full descent)",
                        x, "radix", "dispatch_oom:inf", "verified", want,
                        degraded_to="host", exchange_engine_degraded=1)
        rungs: dict[str, list[float]] = {}
        for s in tr.spans.spans:
            if s.name == "sort":
                continue
            span = rungs.setdefault(str(s.attrs.get("rung", "radix/pallas/auto")),
                                    [s.t0, s.t0 + s.dt])
            span[0], span[1] = min(span[0], s.t0), max(span[1], s.t0 + s.dt)
        notes.append(f"full descent sort(np int32 {x.size}, P=8, dispatch_oom:inf): "
                     f"wall {wall:.3f} s; per rung " + ", ".join(
                         f"{k} {v[1] - v[0]:.3f} s" for k, v in rungs.items())
                     + " (host clock, first to last span of the rung)")
        del x, want

        # ---- the store sites through external_sort
        x = keys32(sizes["store"])
        want = oracle(x)

        def ext_sort(budget: int, **kw):
            def run(tr: Tracer):
                with tempfile.TemporaryDirectory() as sd:
                    res = external.external_sort(x, budget=budget, spill_dir=sd,
                                                 tracer=tr, device=dev, **kw)
                    if os.listdir(sd):
                        raise AssertionError(f"3k store: spill files left {os.listdir(sd)}")
                cells_ext.update(runs=res.runs, passes=res.merge_passes,
                                 recoveries=res.recoveries)
                if (res.runs, res.merge_passes) != (16, 2):
                    raise AssertionError(f"3k store: {res.runs} runs, "
                                         f"{res.merge_passes} passes")
                return res.keys
            return run

        cells_ext: dict = {}
        with env(SORT_MERGE_FANIN="4", SORT_SPILL_COMPRESS="off",
                 SORT_FAULT_ENOSPC_AT="5", SORT_FAULT_STALL_MS="50"):
            for site, compress, expect, kw in (
                    ("spill_corrupt", "off", "verified", {}),
                    ("merge_drop", "off", "verified", {}),
                    ("spill_torn_write", "off", "verified", {}),
                    ("spill_enospc", "off", "SpillCapacityError", {}),
                    ("spill_bitrot", "off", "verified", {}),
                    ("spill_block_garbage", "on", "verified", {}),
                    ("manifest_torn", "off", "verified", {"dataset": "faults3k"}),
                    ("merge_stall", "off", "verified", {})):
                cells_ext.clear()
                with env(SORT_SPILL_COMPRESS=compress):
                    cell(f"{site} external_sort int32 {x.size} (16 runs, 2 passes)",
                         x, "radix", site, expect, want,
                         sort=ext_sort(sizes["store_budget"], **kw))
                if expect == "verified" and site not in ("merge_stall", "manifest_torn") \
                        and cells_ext["recoveries"] < 1:
                    raise AssertionError(f"3k {site}: no recovery ({cells_ext})")
        del x, want
        x = keys32(sizes["k8"])
        want = oracle(x)
        with env(SORT_MERGE_FANIN="4", SORT_SPILL_COMPRESS="off",
                 SORT_LOCAL_ENGINE="radix_pallas"):
            label = f"spill_corrupt:1 external_sort radix_pallas int32 {x.size}"
            cell(label, x, "radix", "spill_corrupt:1", "verified", want,
                 sort=ext_sort(sizes["k8_budget"]))
            if cells_ext["recoveries"] != 1:
                raise AssertionError(f"3k {label}: {cells_ext}")
        del x, want

        # ---- the CLI's exit codes on eight ranks
        x = keys32(sizes["cli"])
        with tempfile.TemporaryDirectory() as tmp:
            f = os.path.join(tmp, "keys.txt")
            kio.write_keys_text(f, x)
            for spec, fallback, code in (("result_dup:inf", "0", 3),
                                         ("dispatch_oom:inf", "0", 4),
                                         ("garbage_site", "1", 1)):
                out, err = io.StringIO(), io.StringIO()
                with env(SORT_FAULTS=spec, SORT_FALLBACK=fallback, SORT_RANKS="8"), \
                        contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                    rc = cli.main(["mpitest_tpu_torch.cli", f],
                                  device=None if dev.type == "cuda" else dev)
                lines = err.getvalue().splitlines()
                if rc != code or len(lines) != 1 or not lines[0].startswith("[ERROR] "):
                    raise AssertionError(f"3k CLI SORT_FAULTS={spec}: exit {rc}, "
                                         f"stderr {err.getvalue()!r}")
                log(f"[faults] CLI SORT_RANKS=8 SORT_FAULTS={spec} SORT_FALLBACK="
                    f"{fallback}: exit {rc}, {lines[0][:100]}")
    return cells, notes


#: Phase 3l's sizes on the card: the planner mix at full width (eight
#: ranks, host input), the K4 cell inside the fused engine's envelope (2^20
#: a rank), the zipf table the duplicate-heavy input draws from, the
#: doctor's clean run and traced planner run, and the CLI file.
PLANNER_SIZES = {"mix": 1 << 28, "k4": 1 << 23, "zipf_table": 1 << 22,
                 "clean": 1 << 20, "cli": 1 << 24}
#: The planner's expected verdict on each mix input under SORT_PLANNER=on.
PLANNER_EXPECT = {"sorted": "verify_passthrough", "near_sorted": "merge_sample",
                  "dup_heavy": "radix_narrow", "range_narrow": "radix_compact",
                  "uniform": "static"}


def planner_phase(dev, mesh, seed: int, sizes: dict, log) -> list[str]:
    """Phase 3l: the planner mix and the doctor on the card.

    The mix: five host int32 inputs built from ``seed`` in the shapes of
    the reference's ``bench/planner_selftest.py`` (sorted; near-sorted, 32
    overlapping ascending runs; duplicate-heavy, draws from a
    ``generate_zipf`` table; range-narrow, keys in [-2^16, 2^16); uniform,
    ``generate_uniform``), each sorted on ``mesh`` under
    ``SORT_PLANNER=off``, ``shadow`` and ``on``: every output byte-equal to
    ``torch.sort`` on the card, shadow byte-equal to off with an
    ``applied=False`` planner decision, the expected policy under ``on``,
    one passthrough on the sorted input, and the range-narrow input running
    the pass count the planner predicted.  A sorted input with one descent
    hidden between the profile's strided samples must miss the passthrough
    (``planner_passthrough_miss`` = 1) and end in the right bytes, on
    ``mesh`` and on one rank (with the one-rank passthrough beside it).
    The range-narrow input at ``sizes["k4"]`` runs under
    ``SORT_LOCAL_ENGINE=radix_pallas``, where the compacted pass plan is
    K4's.  The doctor: one planted trace a rule (exactly that rule), a
    real eight-rank sort whose trace raises nothing,
    ``python -m mpitest_tpu_torch.report`` with ``--explain``,
    ``--doctor`` and ``--check`` over the phase's traces, and the CLI's
    ``--explain`` on a SORTBIN1 file.  Returns the timing notes."""
    import numpy as np
    import torch

    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch import cli, doctor, report
    from mpitest_tpu_torch.utils import flight_recorder, timeline
    from mpitest_tpu_torch.utils import io as kio
    from mpitest_tpu_torch.utils.spans import SpanLog
    from mpitest_tpu_torch.utils.trace import Tracer

    notes: list[str] = []
    # the margin policy learns from this phase's runs alone
    flight_recorder.reset()
    g = torch.Generator(device=dev).manual_seed(seed)

    def oracle(x: np.ndarray) -> bytes:
        return torch.sort(torch.from_numpy(x).to(dev)).values.cpu().numpy().tobytes()

    def build(name: str, n: int) -> tuple[np.ndarray, str]:
        """(keys, requested algorithm) of one mix input."""
        if name == "sorted":
            return np.arange(-(n // 2), n - n // 2, dtype=np.int32), "radix"
        if name == "near_sorted":
            runs = 32
            span = (1 << 31) // runs
            off = torch.randint(0, 2 * span, (runs, n // runs), generator=g,
                                device=dev, dtype=torch.int64)
            base = torch.arange(runs, device=dev, dtype=torch.int64)[:, None] * span
            return ((base + off.sort(dim=1).values).reshape(-1) - (1 << 30)).to(
                torch.int32).cpu().numpy(), "radix"
        if name == "dup_heavy":
            table = torch.from_numpy(kio.generate_zipf(
                sizes["zipf_table"], dtype=np.int32, seed=seed)).to(dev)
            idx = torch.randint(0, table.numel(), (n,), generator=g, device=dev)
            return table[idx].cpu().numpy(), "sample"
        if name == "range_narrow":
            return torch.randint(-(1 << 16), 1 << 16, (n,), generator=g, device=dev,
                                 dtype=torch.int32).cpu().numpy(), "sample"
        if name == "uniform":
            return kio.generate_uniform(n, np.int32, seed=seed), "radix"
        x = np.arange(n, dtype=np.int32)       # lying: one hidden descent
        x[5], x[6] = x[6], x[5]
        return x, "radix"

    def run(x: np.ndarray, algo: str, m, mode: str, want: bytes,
            **knobs_) -> tuple[float, Tracer]:
        tr = Tracer()
        with env(SORT_PLANNER=mode, **knobs_):
            t = time.perf_counter()
            got = mt.sort(x, algorithm=algo, mesh=m, tracer=tr)
            wall = time.perf_counter() - t
        if got.tobytes() != want:
            raise AssertionError(f"3l {mode}: output differs from torch.sort")
        if [s.name for s in tr.spans.spans].count("sort.plan") != 1:
            raise AssertionError(f"3l {mode}: not one sort.plan span")
        return wall, tr

    walls: dict[str, dict[str, float]] = {}
    n = sizes["mix"]
    for name, expect in PLANNER_EXPECT.items():
        x, algo = build(name, n)
        want = oracle(x)
        walls[name] = {}
        for mode in ("off", "shadow", "on"):
            wall, tr = run(x, algo, mesh, mode, want)
            walls[name][mode] = wall
            d = tr.plan.decisions.get("planner")
            regret = tr.counters.get("plan_regret")
            if mode == "off" and d is not None:
                raise AssertionError(f"3l {name} off: a planner decision")
            if mode == "shadow" and (d is None or d.predicted.get("applied") is not False):
                raise AssertionError(f"3l {name} shadow: planner decision {d}")
            if mode == "on":
                if d is None or d.chosen != expect:
                    raise AssertionError(f"3l {name} on: policy "
                                         f"{d and d.chosen} != {expect}")
                if name == "sorted" and tr.counters.get("planner_passthrough") != 1:
                    raise AssertionError("3l sorted on: no passthrough")
                if name == "range_narrow":
                    p = tr.plan.decisions["passes"]
                    if not (p.trigger == "planner"
                            and p.predicted["passes"] == p.actual["passes"] == 2):
                        raise AssertionError(f"3l range_narrow: passes {p}")
            log(f"[planner] {name} ({algo}) {mode}: {wall:.3f} s host wall, "
                f"plan_regret {regret}, policy "
                f"{d.chosen if d is not None else '-'}")
        del x
    off = sum(w["off"] for w in walls.values())
    on = sum(w["on"] for w in walls.values())
    notes.append(f"3l planner mix int32 2^{n.bit_length() - 1} x5 on {mesh.size} "
                 f"ranks, host walls off/shadow/on: "
                 + "; ".join(f"{k} {v['off']:.3f}/{v['shadow']:.3f}/{v['on']:.3f} s"
                             for k, v in walls.items())
                 + f"; mix off {off:.3f} s, on {on:.3f} s, ratio off/on "
                   f"{off / on:.3f}")

    # the lying profile: the verify misses and the ladder sorts for real
    x, algo = build("lying", n)
    want = oracle(x)
    for m, label in ((mesh, f"{mesh.size} ranks"), (None, "one rank")):
        wall, tr = run(x, algo, m, "on", want)
        if tr.counters.get("planner_passthrough_miss") != 1 or \
                tr.plan.decisions["planner"].regret != 1.0:
            raise AssertionError(f"3l lying ({label}): {tr.counters}")
        notes.append(f"3l lying profile ({label}): miss, then the ladder's sort, "
                     f"{wall:.3f} s host wall")
    del x
    x, algo = build("sorted", n)
    wall, tr = run(x, algo, None, "on", oracle(x))
    if tr.counters.get("planner_passthrough") != 1:
        raise AssertionError("3l sorted (one rank): no passthrough")
    notes.append(f"3l sorted, one rank, passthrough: {wall:.3f} s host wall")
    del x

    # radix_compact where K4 is the local engine (inside its envelope)
    x, algo = build("range_narrow", sizes["k4"])
    wall, tr = run(x, algo, mesh, "on", oracle(x), SORT_LOCAL_ENGINE="radix_pallas")
    if (tr.plan.decisions["planner"].chosen != "radix_compact"
            or tr.counters.get("local_engine") != "radix_pallas"):
        raise AssertionError(f"3l K4 cell: {tr.counters}")
    del x

    # ---- the doctor: planted pathologies, a clean run, the report CLI
    tmp = tempfile.mkdtemp(prefix="phase3l_")
    for rule in doctor.DOCTOR_RULES:
        log_ = SpanLog()
        log_.stream_path = os.path.join(tmp, f"{rule}.jsonl")
        plant_pathology(log_, rule)
        rows = report.load_rows(log_.stream_path)
        found = doctor.diagnose(doctor.evidence_from_rows(
            rows, timeline=timeline.build_timeline(rows)))
        if [f.rule for f in found] != [rule] or not found[0].evidence:
            raise AssertionError(f"3l doctor {rule}: {[f.rule for f in found]}")
    log(f"[planner] doctor: {len(doctor.DOCTOR_RULES)} planted pathologies, "
        "each diagnosed as exactly its rule")
    trace = os.path.join(tmp, "clean.jsonl")
    xc = kio.generate_uniform(sizes["clean"], np.int32, seed=seed)
    tr = Tracer()
    tr.spans.stream_path = trace
    if mt.sort(xc, algorithm="sample", mesh=mesh, tracer=tr).tobytes() != oracle(xc):
        raise AssertionError("3l doctor clean run: wrong bytes")
    rows = [s.to_dict() for s in tr.spans.spans]
    found = doctor.diagnose(doctor.evidence_from_rows(
        rows, timeline=timeline.build_timeline(rows)))
    if found:
        raise AssertionError(f"3l doctor clean run: {[f.rule for f in found]}")
    x, algo = build("near_sorted", sizes["clean"])
    tr = Tracer()
    tr.spans.stream_path = trace
    with env(SORT_PLANNER="on"):
        mt.sort(x, algorithm=algo, mesh=mesh, tracer=tr)
    procs = {flag: subprocess.Popen(
        [sys.executable, "-m", "mpitest_tpu_torch.report", flag, trace],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for flag in ("--explain", "--doctor", "--check")}
    for flag, p in procs.items():
        out, err = p.communicate(timeout=120)
        want_text = {"--explain": "merge_sample", "--doctor": "doctor:",
                     "--check": "telemetry check OK"}[flag]
        if p.returncode != 0 or want_text not in out:
            raise AssertionError(f"3l report {flag}: rc {p.returncode}\n{out}\n{err}")
    path = os.path.join(tmp, "cli.bin")
    xb = kio.generate_uniform(sizes["cli"], np.int32, seed=seed)
    kio.write_keys_binary(path, xb)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), env(SORT_ALGO="radix", SORT_RANKS="1"):
        rc = cli.main(["sort_cli", path, "--explain"])
    out = buf.getvalue()
    med = np.sort(xb)[max(xb.size // 2 - 1, 0)]
    if rc != 0 or f"The n/2-th sorted element: {int(med)}" not in out \
            or f"plan algo=radix n={xb.size} dtype=int32 ranks=1" not in out:
        raise AssertionError(f"3l CLI --explain: rc {rc}\n{out}")
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    os.rmdir(tmp)
    log("[planner] doctor clean run: no finding; report --explain/--doctor/--check "
        "and the CLI's --explain pass")
    return notes


def plant_pathology(log, rule: str, backend: str = "cuda") -> None:
    """The reference's ``bench/doctor_selftest.py`` planted trace of one
    doctor rule into ``log`` (a ``SpanLog`` of either package);
    ``local_sort_lax`` is planted on ``backend``."""
    if rule == "skew_imbalance":
        log.record("sort", 0.0, 2.0)
        log.record("exchange_balance", 0.5, 0.0, recv_bytes=[100.0, 110.0, 90.0, 420.0],
                   send_bytes=[180.0] * 4, negotiated_cap=256, worst_cap=1024)
    elif rule == "cap_thrash":
        log.record("sort", 0.0, 1.0)
        log.record("sort.plan", 1.0, 0.0, algo="sample", decisions={"cap": {
            "chosen": 128, "predicted": {"cap": 128},
            "actual": {"cap": 310, "regrows": 3}, "regret": 1.4}})
    elif rule == "compile_storm":
        for i in range(6):
            log.record("serve.compile_cache", float(i), 0.0, hit=False,
                       bucket=1 << (10 + i), dtype="int32", compile_s=0.2)
        log.record("serve.compile_cache", 7.0, 0.0, hit=True, bucket=1024,
                   dtype="int32")
    elif rule == "window_misfit":
        log.record("sort.plan", 0.0, 0.0, algo="sample", decisions={"batch": {
            "chosen": 4096, "predicted": {"waste": 0.1}, "actual": {"waste": 0.7},
            "regret": 0.6}})
    elif rule == "spill_bound":
        log.record("jit_execute", 0.0, 0.5)
        log.record("external.run", 0.5, 1.2, run=0, n=1 << 20, bytes=1 << 22,
                   dtype="int32", payload_width=0)
        log.record("external.merge", 1.7, 2.3, runs=4, n=1 << 22, merge_pass=0,
                   final=True)
    elif rule == "verify_overhead_regression":
        log.record("phase:sort", 0.0, 2.0)
        log.record("phase:verify", 2.0, 1.0)
    elif rule == "local_sort_lax":
        log.record("phase:sort", 0.0, 2.0)
        log.record("phase:decode", 2.0, 0.5)
        log.record("sort.plan", 2.5, 0.0, algo="radix", decisions={"engine": {
            "chosen": "xla", "actual": {"local_engine": "lax", "backend": backend,
                                        "fallbacks": 0}}})
    elif rule == "spill_churn":
        log.record("external.recover", 0.0, 0.0, reason="fingerprint", bad_runs=1,
                   attempt=1)
        log.record("external.resume", 1.0, 0.0, dataset="ds1", committed=4, valid=4,
                   skipped_lines=0)
    elif rule == "breaker_flap":
        log.record("serve.watchdog", 0.0, 0.0, event="trip", age_s=130.0)
        log.record("serve.watchdog", 1.0, 0.0, event="recovered")
        log.record("serve.watchdog", 2.0, 0.0, event="trip", age_s=131.0)
    elif rule == "deadline_burn":
        for i in range(12):
            log.record("serve.request", float(i), 0.01, status="ok", n=4096,
                       dtype="int32")
        for i in range(4):
            log.record("serve.request", 12.0 + i, 0.01, status="deadline", n=4096,
                       dtype="int32")
            log.record("serve.deadline", 12.0 + i, 0.0, stage="queue")
    else:
        raise KeyError(rule)


#: Phase 3m's sizes on the card: the mixed load (the reference's
#: ``bench/serve_load.py`` shape: C closed-loop clients, log-uniform
#: 2^7..2^10 int32 keys), the one-rank solo requests (int32 2^26 is 2^28
#: bytes, exactly the default ``SORT_SERVE_MAX_BYTES``), the eight-rank
#: request, the record request, the spill request against its byte bound,
#: and the watchdog drill's request.
SERVE_SIZES = {"mix_requests": 160, "clients": 8, "solo32": 1 << 26,
               "solo64": 1 << 25, "ranks8": 1 << 26, "records": 1 << 24,
               "spill": 1 << 24, "spill_bytes": 1 << 25, "drill": 1 << 20}
#: The batching gate of ``bench/serve_load.py``: batched dispatch keys/s
#: at least this multiple of the window-0 server's.
MIN_BATCH_SPEEDUP = 2.0


def serve_phase(mesh_for, sizes: dict, log, *, card: bool,
                driver_cmd: list[str]) -> tuple[dict, list, dict]:
    """Phase 3m: the sort server on the card.  Every leg runs against an
    in-process ``SortServer`` on ``127.0.0.1:0``, through the port's
    client, over real sockets, and every reply's bytes must equal
    ``np.sort`` of its request (records: the stable permutation).

    ``mesh_for(P)`` makes a P-rank mesh (the card's on the card).  The
    legs: the mixed load against a ``SORT_SERVE_BATCH_WINDOW_MS=8`` server
    and a window-0 server with ``bench/serve_load.py``'s four gates (warm
    cache: no ``jit_compile_execute`` span and no cache miss in the
    measured window; batched dispatch keys/s >= ``MIN_BATCH_SPEEDUP`` x
    window 0; typed backpressure at ``SORT_SERVE_MAX_INFLIGHT=1`` while
    still serving; a poisoned request typed ``integrity`` and the next one
    served); one scrape of ``/metrics``, ``/healthz`` and ``/varz`` whose
    request counters equal the clients' own counts; one-rank solo int32
    and int64 requests (first and warm latency, the server's wall against
    an in-process ``sort()``); an eight-rank server's solo request with
    radix and with sample; a record request; a spill request; the watchdog
    drill (trip, typed fast rejections, a flight artifact that passes
    ``report.check_rows``, half-open recovery without a restart); and one
    subprocess run of ``driver_cmd`` (the listening line, a round trip,
    SIGTERM drain with exit 0).  With ``card`` each leg's kernel launches
    are asserted.  Returns (launches by leg, the tracers a fault leg
    dirtied on purpose, the timings)."""
    import signal
    import threading
    import urllib.request
    from pathlib import Path

    import numpy as np

    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch import report
    from mpitest_tpu_torch.ops import _build
    from mpitest_tpu_torch.serve.client import ServeClient
    from mpitest_tpu_torch.serve.server import ServerCore, SortServer
    from mpitest_tpu_torch.serve.telemetry import TelemetryServer
    from mpitest_tpu_torch.utils import flight_recorder
    from mpitest_tpu_torch.utils.metrics_live import check_exposition, parse_prom_text

    t_phase = time.perf_counter()
    legs: dict[str, dict[str, int]] = {}
    fault_tracers: list = []
    timings: dict = {}
    host = "127.0.0.1"

    def core_with(P: int, **knobs_env: str):
        with env(**knobs_env):
            return ServerCore(mesh_for(P))

    @contextlib.contextmanager
    def serving(core):
        srv = SortServer(core, host, 0)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            yield srv.bound_port
        finally:
            srv.shutdown()
            srv.server_close()
            if not core.drain_and_stop(timeout=60.0):
                raise AssertionError("3m: a server did not drain cleanly")

    @contextlib.contextmanager
    def leg(name: str, must: tuple[str, ...] = ()):
        before = dict(_build.LAUNCHES)
        yield
        got = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
               if v - before.get(k, 0)}
        legs[name] = got
        if card:
            for k in must:
                if not got.get(k):
                    raise AssertionError(f"3m {name}: kernel {k} never launched "
                                         f"({got})")
        log(f"[serve] {name}: launches {got}")

    def check(label: str, reply, x, payload=None) -> None:
        if not reply.ok:
            raise AssertionError(f"3m {label}: {reply.header}")
        if payload is None:
            want = np.sort(x)
            if not np.array_equal(reply.arr.view(np.uint8), want.view(np.uint8)):
                raise AssertionError(f"3m {label}: reply differs from np.sort")
            return
        order = np.argsort(x, kind="stable")
        if not (np.array_equal(reply.arr, x[order])
                and np.array_equal(reply.payload, payload[order])):
            raise AssertionError(f"3m {label}: record reply differs")

    def run_load(port: int, requests: int, clients: int, seed: int) -> dict:
        lock = threading.Lock()
        lat: list[float] = []
        statuses: dict[str, int] = {}
        bad: list[str] = []
        claimed = [0]

        def worker(w: int) -> None:
            rng = np.random.default_rng(seed + w)
            with ServeClient(host, port, timeout=120) as c:
                while True:
                    with lock:
                        if claimed[0] >= requests:
                            return
                        claimed[0] += 1
                    n = int(2 ** rng.uniform(7, 10))
                    x = rng.integers(-2**31, 2**31 - 1, size=n, dtype=np.int32)
                    t0 = time.perf_counter()
                    r = c.sort(x)
                    dt = time.perf_counter() - t0
                    with lock:
                        st = "ok" if r.ok else str(r.error)
                        statuses[st] = statuses.get(st, 0) + 1
                        if r.ok:
                            lat.append(dt)
                            if not np.array_equal(r.arr, np.sort(x)):
                                bad.append(r.trace_id)

        ts = [threading.Thread(target=worker, args=(w,)) for w in range(clients)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if bad:
            raise AssertionError(f"3m mixed load: {len(bad)} replies differ from np.sort")
        return {"wall_s": time.perf_counter() - t0, "lat": sorted(lat),
                "statuses": statuses}

    def dispatch_keys_per_s(spans: list) -> float:
        batches = [s for s in spans if s.name == "serve.batch"]
        secs = sum(s.dt for s in batches)
        return sum(s.attrs.get("keys", 0) for s in batches) / secs if secs else 0.0

    def measured(core, port: int, seed: int) -> tuple[dict, list, dict]:
        """Warm-up, then the measured window's load and spans."""
        warm = run_load(port, max(16, sizes["clients"]), sizes["clients"], seed + 1000)
        window: list = []
        core.tracer.spans.observers.append(window.append)
        stats = run_load(port, sizes["mix_requests"], sizes["clients"], seed)
        core.tracer.spans.observers.remove(window.append)
        if stats["statuses"] != {"ok": sizes["mix_requests"]}:
            raise AssertionError(f"3m mixed load statuses {stats['statuses']}")
        combined = dict(warm["statuses"])
        for k, v in stats["statuses"].items():
            combined[k] = combined.get(k, 0) + v
        return stats, window, combined

    # ---- the mixed load: batched (window 8 ms) with the side port
    core_b = core_with(1, SORT_SERVE_BATCH_WINDOW_MS="8")
    t0 = time.perf_counter()
    core_b.prewarm(log)
    timings["prewarm_s"] = time.perf_counter() - t0
    tel = TelemetryServer(core_b, host, 0)
    tel.start()
    try:
        with leg("mixed load, window 8 ms"), serving(core_b) as port:
            stats_b, spans_b, combined = measured(core_b, port, 2026)
            compiles = [s for s in spans_b if s.name == "jit_compile_execute"]
            misses = [s for s in spans_b if s.name == "serve.compile_cache"
                      and not s.attrs.get("hit")]
            if compiles or misses:
                raise AssertionError(f"3m warm-cache gate: {len(compiles)} "
                                     f"jit_compile_execute, {len(misses)} misses")
            if not any(s.name == "serve.request" and s.attrs.get("batched")
                       for s in spans_b):
                raise AssertionError("3m: batching never engaged")
            base = f"http://{host}:{tel.bound_port}"
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                prom = r.read().decode()
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                healthz = json.loads(r.read())
            with urllib.request.urlopen(base + "/varz", timeout=30) as r:
                varz = json.loads(r.read())
        if check_exposition(prom):
            raise AssertionError(f"3m /metrics: {check_exposition(prom)}")
        served = {lbl["status"]: int(v) for _n, lbl, v in
                  parse_prom_text(prom)["sort_serve_requests_total"]["samples"]}
        if served != combined or healthz["requests_ok"] != combined.get("ok"):
            raise AssertionError(f"3m side port: server counts {served} / "
                                 f"{healthz['requests_ok']} != client counts {combined}")
        if varz["mesh"]["platform"] != ("cuda" if card else "cpu") or \
                varz["cache"]["misses"] != len(varz["cache"]["buckets"]):
            raise AssertionError(f"3m /varz: {varz['mesh']} {varz['cache']}")
        log(f"[serve] side port: /metrics {served} == clients' {combined}, "
            f"/healthz ok={healthz['ok']}, /varz cache {varz['cache']}")
    finally:
        tel.shutdown()
        tel.server_close()
    lat = stats_b["lat"]
    timings["p50_ms"] = 1e3 * lat[len(lat) // 2]
    timings["p99_ms"] = 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    timings["batched_keys_per_s"] = dispatch_keys_per_s(spans_b)

    # ---- the mixed load against a window-0 server
    core_0 = core_with(1, SORT_SERVE_BATCH_WINDOW_MS="0")
    core_0.prewarm()
    with leg("mixed load, window 0"), serving(core_0) as port:
        stats_0, spans_0, _ = measured(core_0, port, 2026)
    timings["window0_keys_per_s"] = dispatch_keys_per_s(spans_0)
    timings["batch_speedup"] = timings["batched_keys_per_s"] / timings["window0_keys_per_s"]
    if timings["batch_speedup"] < MIN_BATCH_SPEEDUP:
        raise AssertionError(f"3m batching gate: {timings['batch_speedup']:.2f}x < "
                             f"{MIN_BATCH_SPEEDUP}x")
    log(f"[serve] batching gate: dispatch {timings['batched_keys_per_s'] / 1e6:.3f} vs "
        f"{timings['window0_keys_per_s'] / 1e6:.3f} Mkeys/s = "
        f"{timings['batch_speedup']:.2f}x; closed-loop walls "
        f"{stats_b['wall_s']:.3f} / {stats_0['wall_s']:.3f} s")

    # ---- one rank: the large solo requests, a record request
    rng = np.random.default_rng(31)
    core_1 = core_with(1)
    core_1.prewarm()
    with serving(core_1) as port, ServeClient(host, port, timeout=600) as c:
        x = rng.integers(-2**31, 2**31 - 1, size=sizes["solo32"], dtype=np.int32)
        walls = []
        with leg(f"solo int32 2^{sizes['solo32'].bit_length() - 1}, one rank",
                 ("bitonic_u32",)):
            for i in range(2):
                t0 = time.perf_counter()
                r = c.sort(x, trace_id=f"solo32-{i}")
                walls.append(time.perf_counter() - t0)
                check("solo int32", r, x)
                if r.header["batched"]:
                    raise AssertionError("3m: a solo request was batched")
        req_s = [s.dt for s in core_1.tracer.spans.spans
                 if s.name == "serve.request" and s.attrs.get("trace_id") == "solo32-1"]
        mesh1 = core_1.mesh
        mt.sort(x, mesh=mesh1)
        t0 = time.perf_counter()
        mt.sort(x, mesh=mesh1)
        inproc = time.perf_counter() - t0
        timings.update(solo_first_s=walls[0], solo_warm_s=walls[1],
                       solo_server_s=req_s[0], solo_inprocess_s=inproc)
        log(f"[serve] solo int32: first {walls[0]:.3f} s, warm {walls[1]:.3f} s round "
            f"trip; serve.request {req_s[0]:.3f} s; in-process sort() {inproc:.3f} s")
        del x, r
        x64 = rng.integers(-2**63, 2**63 - 1, size=sizes["solo64"], dtype=np.int64)
        with leg(f"solo int64 2^{sizes['solo64'].bit_length() - 1}, one rank",
                 ("bitonic_pairs_u32", "fix_runs_pairs")):
            t0 = time.perf_counter()
            r = c.sort(x64)
            timings["solo64_s"] = time.perf_counter() - t0
            check("solo int64", r, x64)
        del x64, r
        xr = rng.integers(-2**31, 2**31 - 1, size=sizes["records"], dtype=np.int32)
        pay = rng.integers(0, 256, size=(xr.size, 8), dtype=np.uint8)
        with leg("records int32, 8 payload bytes"):
            t0 = time.perf_counter()
            r = c.sort(xr, payload=pay)
            timings["records_s"] = time.perf_counter() - t0
            check("records", r, xr, pay)
        del xr, pay, r

    # ---- eight ranks: one solo request with radix and with sample
    with env(SORT_DEVICES="8"):
        core_8 = ServerCore() if card else ServerCore(mesh_for(8))
    if core_8.mesh.size != 8:
        raise AssertionError(f"3m: SORT_DEVICES=8 server has {core_8.mesh.size} ranks")
    core_8.prewarm()
    x = rng.integers(-2**31, 2**31 - 1, size=sizes["ranks8"], dtype=np.int32)
    with serving(core_8) as port, ServeClient(host, port, timeout=600) as c:
        for algo in ("radix", "sample"):
            with leg(f"eight ranks int32 {algo}", ("fused_pass_pack", "remote_a2a")):
                t0 = time.perf_counter()
                r = c.sort(x, algo=algo)
                timings[f"ranks8_{algo}_s"] = time.perf_counter() - t0
                check(f"eight ranks {algo}", r, x)
                if r.plan["algo"] != algo or "exchange_engine" not in r.plan:
                    raise AssertionError(f"3m eight ranks: plan {r.plan}")
    del x, r

    # ---- the spill tier
    core_s = core_with(1, SORT_SERVE_MAX_BYTES=str(sizes["spill_bytes"]))
    xs = rng.integers(-2**31, 2**31 - 1, size=sizes["spill"], dtype=np.int32)
    with leg("spill int32", ("bitonic_u32",)), serving(core_s) as port, \
            ServeClient(host, port, timeout=600) as c:
        t0 = time.perf_counter()
        r = c.sort(xs)
        timings["spill_s"] = time.perf_counter() - t0
        check("spill", r, xs)
        if not r.spilled or not r.plan.get("spilled"):
            raise AssertionError(f"3m spill: {r.header}")
    del xs, r

    # ---- backpressure and per-request fault isolation (eight ranks: the
    # result-corruption sites live on the distributed path)
    core_l = core_with(8, SORT_SERVE_MAX_INFLIGHT="1", SORT_SERVE_BATCH_WINDOW_MS="20",
                       SORT_SERVE_ALLOW_FAULTS="1")
    fault_tracers.append(core_l.tracer)
    core_l.prewarm()
    with leg("backpressure and fault isolation"), serving(core_l) as port, \
            env(SORT_FALLBACK="0", SORT_MAX_RETRIES="0"):
        burst = run_load(port, 16, 8, 3000)
        if burst["statuses"].get("backpressure", 0) < 1 or \
                burst["statuses"].get("ok", 0) < 1 or \
                set(burst["statuses"]) != {"ok", "backpressure"}:
            raise AssertionError(f"3m backpressure gate: {burst['statuses']}")
        xf = rng.integers(-2**31, 2**31 - 1, size=sizes["drill"], dtype=np.int32)
        with ServeClient(host, port, timeout=600) as c:
            r = c.sort(xf, faults="result_swap:inf")
            if r.ok or r.error != "integrity":
                raise AssertionError(f"3m fault gate: {r.header}")
            check("after the poisoned request", c.sort(xf), xf)
    log(f"[serve] backpressure burst {burst['statuses']}; poisoned request typed "
        "integrity, the next one served")

    # ---- the watchdog drill (eight ranks, dispatch_stall on the dispatch
    # thread: a wedged CUDA stream cannot be cancelled, only tripped over)
    with tempfile.TemporaryDirectory() as flight_dir:
        with env(SORT_FLIGHT_RECORDER_DIR=flight_dir):
            flight_recorder.reset()
            core_w = core_with(8, SORT_SERVE_ALLOW_FAULTS="1",
                               SORT_SERVE_DISPATCH_TIMEOUT_S="1",
                               SORT_SERVE_BREAKER_BACKOFF_S="0.5",
                               SORT_SERVE_BATCH_WINDOW_MS="0")
            fault_tracers.append(core_w.tracer)
            core_w.prewarm()
            xw = rng.integers(-2**31, 2**31 - 1, size=sizes["drill"], dtype=np.int32)
            with leg("watchdog drill"), serving(core_w) as port, \
                    env(SORT_FAULT_STALL_MS="6000"):
                with ServeClient(host, port, timeout=600) as c:
                    check("drill warm-up", c.sort(xw), xw)
                core_w.start_watchdog()
                t_drill = time.perf_counter()
                res: dict = {}

                def stalled() -> None:
                    with ServeClient(host, port, timeout=600) as c2:
                        res["r"] = c2.sort(xw, faults="dispatch_stall")

                th = threading.Thread(target=stalled, daemon=True)
                th.start()

                def wait(pred, secs: float) -> bool:
                    end = time.monotonic() + secs
                    while time.monotonic() < end:
                        if pred():
                            return True
                        time.sleep(0.02)
                    return pred()

                if not wait(lambda: core_w.breaker.state != "closed", 60):
                    raise AssertionError("3m watchdog never tripped")
                timings["trip_s"] = time.perf_counter() - t_drill
                with ServeClient(host, port, timeout=60) as c:
                    rej = c.sort(xw)
                if rej.ok or rej.error != "backpressure" or \
                        "circuit breaker" not in rej.detail:
                    raise AssertionError(f"3m breaker rejection: {rej.header}")
                if not wait(lambda: core_w.breaker.state == "closed", 120):
                    raise AssertionError("3m breaker never recovered")
                timings["recover_s"] = time.perf_counter() - t_drill
                th.join(timeout=120)
                check("the stalled request", res["r"], xw)
                with ServeClient(host, port, timeout=60) as c:
                    check("after recovery", c.sort(xw), xw)
            events = [s.attrs.get("event") for s in core_w.tracer.spans.spans
                      if s.name == "serve.watchdog"]
            arts = sorted(Path(flight_dir).glob("flight-*-watchdog-*.jsonl"))
            if "trip" not in events or "recovered" not in events or \
                    core_w.breaker.trips != 1 or not arts or \
                    report.check_rows(report.load_rows(str(arts[-1]))):
                raise AssertionError(f"3m watchdog audit: events {events}, trips "
                                     f"{core_w.breaker.trips}, artifacts {arts}")
        flight_recorder.reset()
    log(f"[serve] watchdog drill: tripped after {timings['trip_s']:.3f} s, breaker "
        f"rejection typed, recovered after {timings['recover_s']:.3f} s, artifact "
        "passes check_rows")

    # ---- the driver, in a subprocess
    t0 = time.perf_counter()
    denv = dict(os.environ, SORT_SERVE_PORT="0", SORT_METRICS_PORT="-1")
    proc = subprocess.Popen(driver_cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=denv)
    try:
        line = proc.stdout.readline().strip()
        m = re.fullmatch(r"sort_server listening on 127\.0\.0\.1:(\d+)", line)
        if not m:
            raise AssertionError(f"3m driver: no listening line ({line!r})")
        timings["driver_start_s"] = time.perf_counter() - t0
        x = rng.integers(-2**31, 2**31 - 1, size=5000, dtype=np.int32)
        with ServeClient(host, int(m.group(1)), timeout=120) as c:
            check("driver round trip", c.sort(x), x)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        err = proc.stderr.read()
        if rc != 0 or "drained=clean served_ok=1" not in err:
            raise AssertionError(f"3m driver: exit {rc}, {err[-1000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"[serve] driver: listening after {timings['driver_start_s']:.3f} s, one round "
        "trip, SIGTERM drained, exit 0")
    timings["phase_wall_s"] = time.perf_counter() - t_phase
    return legs, fault_tracers, timings


#: Phase 3n's sizes on the card: one solo int32 request a leg (2^26, the
#: largest the default ``SORT_SERVE_MAX_BYTES`` admits), the closed-loop
#: mix of 2^7-2^10 keys, the RST and drip cells' request, and the kill
#: drill's spill request against its byte bound (as phase 3m's).
SPAWNED_SIZES = {"solo": 1 << 26, "mix_requests": 160, "clients": 8,
                 "big": 1 << 16, "spill": 1 << 24, "spill_bytes": 1 << 25}


def spawned_phase(sizes: dict, log, *, card: bool, mesh_for,
                  cmd: "tuple[str, ...] | None" = None) -> dict:
    """Phase 3n: the reference's spawned-server gates
    (``mpitest_tpu_torch/selftest/drills.py``) against the port's server
    running as its own process (``cmd``, default ``python -m
    mpitest_tpu_torch.sort_server``), driven only through the wire and the
    side port: the live-telemetry leg (eight ranks), the mix and the wire
    chaos cells (one rank), the watchdog (eight ranks) and hedging (one
    rank) cells, kill and resume, and the sentinel cells.  Every leg's
    solo request asserts its kernels in the server process through
    ``/varz`` when ``card``.  Returns each leg's timings and the phase
    wall."""
    from pathlib import Path

    from mpitest_tpu_torch.selftest import drills
    from mpitest_tpu_torch.selftest.spawned import DRIVER

    cmd = cmd or DRIVER
    out: dict = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tdir:
        root = Path(tdir)
        for name, leg in (("telemetry", drills.telemetry_leg), ("wire", drills.wire_leg),
                          ("watchdog", drills.watchdog_leg), ("hedging", drills.hedging_leg),
                          ("kill_resume", drills.kill_resume_leg)):
            t0 = time.perf_counter()
            kw = {"mesh_for": mesh_for} if name == "telemetry" else {}
            out[name] = leg(root / name, sizes, log, card=card, cmd=cmd, **kw)
            out[name]["wall_s"] = time.perf_counter() - t0
            log(f"[3n] {name} leg: {out[name]['wall_s']:.3f} s, server start "
                f"{out[name].get('start_s', out[name].get('start1_s', 0.0)):.3f} s, "
                f"server launches {out[name].get('launches', out[name].get('launches1'))}")
        out["sentinel"] = drills.sentinel_cells(root / "sentinel", log)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


#: Phase 3o's sort size: int32 2^28, the main path's.
MULTIHOST_N = 1 << 28

_MULTIHOST_CHILD = """
import json, sys, time
import numpy as np
import torch, torch.distributed as dist
import mpitest_tpu_torch as mt
from mpitest_tpu_torch.ops import _build
from mpitest_tpu_torch.parallel import make_mesh, multihost_init
port, n = int(sys.argv[1]), int(sys.argv[2])
t0 = time.perf_counter()
multihost_init(f"127.0.0.1:{port}", 1, 0)
out = {"init_s": time.perf_counter() - t0}
try:
    assert dist.get_backend() == "nccl", dist.get_backend()
    assert dist.get_world_size() == 1 and dist.get_rank() == 0
    t0 = time.perf_counter()
    t = torch.arange(1024, dtype=torch.float32, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    assert torch.equal(t, torch.arange(1024, dtype=torch.float32, device="cuda"))
    out["all_reduce_s"] = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32, device="cuda",
                      generator=g)
    want = torch.sort(x).values.cpu().numpy()
    for ranks, must in ((1, ["bitonic_u32"]),
                        (8, ["fused_pass_pack", "remote_a2a", "slot_place"])):
        mesh = make_mesh(ranks)
        assert mesh.size == ranks
        for rep in range(2):
            _build.reset_launches()
            t0 = time.perf_counter()
            got = mt.sort(x, "radix", mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        got = np.asarray(got)
        assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8),
                                                          want.view(np.uint8)), ranks
        for k in must:
            assert launches.get(k, 0) > 0, (ranks, k, launches)
        # host wall of the second call, the result's copy back included
        out[f"ranks{ranks}"] = {"warm_s": wall, "launches": launches}
finally:
    dist.destroy_process_group()
print("MULTIHOST " + json.dumps(out))
"""


def multihost_phase(n: int, log, attempts: int = 3) -> dict:
    """Phase 3o: ``parallel.multihost_init`` on the card, in a subprocess
    of the smoke: NCCL at one process on a free port (a port taken between
    the probe and the bind is retried, nothing else is), one
    ``all_reduce``, then ``sort()`` of int32 ``n`` on ``make_mesh(1)`` (K1)
    and ``make_mesh(8)`` with radix (K6, K7), bytes equal to
    ``torch.sort``, launches asserted, and
    ``destroy_process_group()`` in a ``finally``.  Returns the child's
    timings and launches."""
    import socket

    for attempt in range(attempts):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _MULTIHOST_CHILD, str(port), str(n)],
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode == 0:
            line = next(ln for ln in proc.stdout.splitlines()
                        if ln.startswith("MULTIHOST "))
            res = json.loads(line.split(" ", 1)[1])
            res["wall_s"] = wall
            log(f"[3o] multihost_init over NCCL: init {res['init_s']:.3f} s, all_reduce "
                f"{res['all_reduce_s']:.3f} s; sort(int32 2^{n.bit_length() - 1}) "
                f"one rank {res['ranks1']['warm_s']:.3f} s {res['ranks1']['launches']}, "
                f"eight ranks {res['ranks8']['warm_s']:.3f} s "
                f"{res['ranks8']['launches']}; subprocess {wall:.3f} s")
            return res
        if "address already in use" not in proc.stderr.lower() or attempt == attempts - 1:
            raise AssertionError(f"3o: the multihost child failed (rc {proc.returncode}):\n"
                                 f"{proc.stderr[-3000:]}")
    raise AssertionError("3o: unreachable")


#: Phase 3p's legs: (label, kind, ranks per process, keys, seed).  Two
#: processes share the card; the first leg is phase 4's eight-rank shape,
#: the last sorted keys that take the skew re-stage.
CROSSPROCESS_LEGS = (("2x4 int32", "int32", 4, 1 << 28, 41),
                     ("2x1 int64", "int64", 1, 1 << 26, 42),
                     ("2x4 int32 sorted", "sorted", 4, 1 << 28, 43))


def crossprocess_keys(kind: str, n: int, seed: int):
    """Phase 3p's host keys: uniform int32 or int64, or nondecreasing
    int32 below 2^16 (``sorted``: one radix pass, whose digit keeps every
    rank's keys on that rank, so the count probe asks for the re-stage)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if kind == "sorted":
        steps = np.cumsum(rng.integers(0, 2, n, dtype=np.int8), dtype=np.int32)
        return steps >> max(0, n.bit_length() - 17)
    info = np.iinfo(np.dtype(kind))
    return rng.integers(info.min, info.max, n, dtype=np.dtype(kind), endpoint=True)


def crossprocess_stats(spans_) -> dict:
    """Phase 3p's readings from a run's span log, summed over the attrs
    that the exchange layer adds to its enclosing spans: control-group
    rounds and seconds, handle opens, the syncs and barriers around the
    pushes, and K7's device time across processes."""
    def total(key):
        return sum(s.attrs.get(key, 0) for s in spans_)
    return {"control_s": total("control_s"), "control_calls": total("control_rounds"),
            "open_s": total("ipc_open_s"), "barrier_s": total("ipc_wait_s"),
            "k7_ms": total("k7_device_ms"), "exchanges": total("k7_exchanges")}


def crossprocess_k7_under_restage(spans_) -> int:
    """The cross-process K7 exchanges that ran inside the skew re-stage
    (on the ``restage`` span or one nested in it)."""
    by_id = {s.id: s for s in spans_}

    def inside(s):
        while s is not None:
            if s.name == "restage":
                return True
            s = by_id.get(s.parent)
        return False
    return sum(s.attrs.get("k7_exchanges", 0) for s in spans_ if inside(s))


_CROSSPROCESS_CHILD = """
import json, statistics, sys, time
import numpy as np
import torch, torch.distributed as dist
import mpitest_tpu_torch as mt
from mpitest_tpu_torch.models import verify as vfy
from mpitest_tpu_torch.ops import _build, exchange
from mpitest_tpu_torch.ops.keys import codec_for
from mpitest_tpu_torch.parallel import make_mesh, multihost_init
from mpitest_tpu_torch.parallel import mesh as mesh_mod
from mpitest_tpu_torch.utils.trace import Tracer

rank, port = int(sys.argv[1]), int(sys.argv[2])
legs, expect, reps = json.loads(sys.argv[3]), json.loads(sys.argv[4]), int(sys.argv[5])
t0 = time.perf_counter()
multihost_init(f"127.0.0.1:{port}", 2, rank)
out = {"init_s": time.perf_counter() - t0, "backend": dist.get_backend(), "legs": {}}
COUNTERS = ("exchange_passes", "exchange_bytes", "exchange_cap", "digit_bits",
            "skew_restage")
""" + "\n".join(inspect.getsource(f) for f in (
    crossprocess_keys, crossprocess_stats, crossprocess_k7_under_restage)) + """

try:
    # two processes on one card: the default group is gloo, and so is the
    # control group (NCCL refuses two ranks on one GPU)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 2, dist.get_backend()
    mesh = None
    for label, kind, local, n, seed in legs:
        x = crossprocess_keys(kind, n, seed)
        mesh = make_mesh(devices=["cuda"] * local)
        assert mesh.cross_process and mesh.size == 2 * local, mesh
        assert mesh.local_ranks == tuple(range(rank * local, (rank + 1) * local)), mesh
        codec = codec_for(x.dtype)
        fp_in = vfy.fingerprint_host(codec.encode(x))
        want = torch.sort(torch.from_numpy(x).cuda()).values
        walls = []
        for rep in range(reps):
            _build.reset_launches()
            tr = Tracer()
            torch.cuda.synchronize()
            mesh_mod.barrier()
            t = time.perf_counter()
            res = mt.sort(x, mesh=mesh, return_result=True, tracer=tr)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            stats = crossprocess_stats(tr.spans.spans)
            if rep == 0:
                cold = {"wall_s": walls[0], "open_s": stats["open_s"]}
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        for k in ("fused_pass_pack", "remote_a2a", "slot_place"):
            assert launches.get(k, 0) > 0, (label, k, launches)
        restage_k7 = crossprocess_k7_under_restage(tr.spans.spans)
        if kind == "sorted":
            # the re-stage's all-to-all is K7 into the peer's buffers
            assert tr.counters.get("skew_restage") == 1 and restage_k7 == 1, (
                label, tr.counters.get("skew_restage"), restage_k7)
        # local shards against the matching slices of torch.sort
        for (r, a, b), shard in zip(res.addressable, res.shards):
            ref = codec.encode_torch(want[a:b])
            assert all(torch.equal(g, w) for g, w in zip(shard, ref)), (label, r)
        fp_out = vfy.result_fingerprint(res)
        assert fp_out == fp_in, (label, fp_out, fp_in)
        med = res.median_probe()
        oracle = int(want[n // 2 - 1])
        meds = mesh_mod.gather_objects(med)
        assert meds[0] == meds[1] == oracle, (label, meds, oracle)
        got = {c: tr.counters.get(c, 0) for c in COUNTERS}
        assert got == expect[label], (label, got, expect[label])
        for what in ("to_numpy", "sample"):
            try:
                res.to_numpy() if what == "to_numpy" else mt.sort(
                    x[:1 << 16], algorithm="sample", mesh=mesh, return_result=True)
            except RuntimeError:
                pass
            else:
                raise AssertionError(f"{label}: {what} did not raise across processes")
        out["legs"][label] = {"walls_s": walls, "cold": cold, "launches": launches,
                              "counters": got, "median": med, "restage_k7": restage_k7,
                              **stats}
        del res, want
        torch.cuda.empty_cache()
    # K7 across processes against the host-staged transport of the same send
    # matrices, byte for byte, at the first leg's shape; then K7 alone: CUDA
    # events around each process's pushes, and one host window from the
    # first process's launch to the last process's completion (the shared
    # host clock; both processes leave a barrier just before)
    label, kind, local, n, seed = legs[0]
    mesh = make_mesh(devices=["cuda"] * local)
    cap = expect[label]["exchange_cap"]
    g = torch.Generator(device="cuda").manual_seed(500 + rank)
    sends = [(torch.randint(-2**31, 2**31 - 1, (mesh.size, cap), dtype=torch.int32,
                            device="cuda", generator=g),) for _ in mesh.local_ranks]
    got = [tuple(p.clone() for p in planes) for planes in exchange.remote_a2a_across(sends, mesh)]
    staged = exchange.staged_a2a(sends, mesh)
    for a, b in zip(got, staged):
        assert all(torch.equal(p, q) for p, q in zip(a, b)), "K7 across != staged"
    table, _ = exchange._arena.layout(1, cap)
    lib = exchange.lib()
    k7, windows = [], []
    for _ in range(5):
        tr = Tracer()
        with tr.span("k7_probe"):
            exchange.remote_a2a_across(sends, mesh)
        k7.append(crossprocess_stats(tr.spans.spans)["k7_ms"])
        torch.cuda.synchronize()
        mesh_mod.barrier()
        t_launch = time.time()
        for i, me in enumerate(mesh.local_ranks):
            _build.launch(lib, "remote_a2a", sends[i][0].device, sends[i][0].data_ptr(),
                          table[0].data_ptr(), me, mesh.size, cap)
        torch.cuda.synchronize()
        t_done = time.time()
        ends = mesh_mod.gather_objects((t_launch, t_done))
        mesh_mod.barrier()
        windows.append(1e3 * (max(e for _, e in ends) - min(s for s, _ in ends)))
    out["k7"] = {"cap": cap, "ms": k7, "window_ms": windows, "bytes_equal": True}
    exchange.release_ipc()
finally:
    dist.destroy_process_group()
print("CROSSPROCESS " + json.dumps(out))
"""


def crossprocess_phase(log, legs=CROSSPROCESS_LEGS, reps: int = 2,
                       attempts: int = 3) -> dict:
    """Phase 3p: the radix sort across two processes on the one card.

    First the single-controller sort of each leg's host keys in this
    process (``make_mesh(P)``, the same call twice: its exchange counters
    and its warm wall), and the in-process K7 at the first leg's exchange
    shape (CUDA events, and the host window from launch to completion).
    Then two child processes join a group on a free port
    (``multihost_init``: gloo, the processes share the card), build the
    global mesh of each leg (``make_mesh(devices=["cuda"] * k)`` in each)
    and run ``sort(x, return_result=True)`` on it ``reps`` times.  Each
    child asserts its local shards against ``torch.sort`` of the same
    keys, the combined ``Fingerprint`` against the input's, the median
    probe across processes and against the oracle, the exchange counters
    (the re-stage's included) against the single-controller run's, K6 and
    K7 in its own launch counts, the sorted leg's re-stage moved by K7
    across processes, ``to_numpy`` and ``algorithm="sample"`` raising,
    and K7 across processes byte-equal to the host-staged transport.
    Every child ends its group in a ``finally``.  Returns this process's
    walls and counters beside each child's result."""
    import socket

    import torch

    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.ops import exchange
    from mpitest_tpu_torch.parallel.mesh import make_mesh
    from mpitest_tpu_torch.utils.trace import Tracer

    t_phase = time.perf_counter()
    single: dict = {}
    for label, kind, local, n, seed in legs:
        x = crossprocess_keys(kind, n, seed)
        mesh = make_mesh(2 * local)
        walls = []
        for _ in range(reps):
            tr = Tracer()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = mt.sort(x, mesh=mesh, return_result=True, tracer=tr)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        single[label] = {"walls_s": walls, "counters": {
            c: tr.counters.get(c, 0) for c in ("exchange_passes", "exchange_bytes",
                                               "exchange_cap", "digit_bits",
                                               "skew_restage")}}
        del res, x
    # the in-process K7 at the first leg's shape, timed as the children time
    # theirs: eight pushes of [8, cap], events and host window
    cap = single[legs[0][0]]["counters"]["exchange_cap"]
    p = 2 * legs[0][2]
    g = torch.Generator(device="cuda").manual_seed(500)
    sends = [torch.randint(-2**31, 2**31 - 1, (p, cap), dtype=torch.int32,
                           device="cuda", generator=g) for _ in range(p)]
    exchange.remote_a2a(sends)
    in_ms, in_windows = [], []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.time()
        start.record()
        exchange.remote_a2a(sends)
        end.record()
        torch.cuda.synchronize()
        in_windows.append(1e3 * (time.time() - t0))
        in_ms.append(start.elapsed_time(end))
    in_process = {"ms": in_ms, "window_ms": in_windows}
    del sends
    torch.cuda.empty_cache()   # the children allocate on the same card
    expect = {label: v["counters"] for label, v in single.items()}
    child_src = _CROSSPROCESS_CHILD
    for attempt in range(attempts):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        argv = [json.dumps(legs), json.dumps(expect), str(reps)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", child_src, str(r),
                                   str(port), *argv],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=600))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        if all(proc.returncode == 0 for proc in procs):
            children = [json.loads(next(ln for ln in o.splitlines()
                                        if ln.startswith("CROSSPROCESS ")).split(" ", 1)[1])
                        for o, _e in outs]
            for label, *_ in legs:
                w_single = min(single[label]["walls_s"])
                w_cross = max(min(c["legs"][label]["walls_s"]) for c in children)
                log(f"[3p] {label}: cross-process sort wall {w_cross:.3f} s (warm, slower "
                    f"process) beside single-controller {w_single:.3f} s, same call; "
                    + "; ".join(
                        f"process {r}: control group {c['legs'][label]['control_s']:.3f} s "
                        f"in {c['legs'][label]['control_calls']} rounds, handle open "
                        f"{c['legs'][label]['cold']['open_s']:.3f} s (cold call "
                        f"{c['legs'][label]['cold']['wall_s']:.3f} s), barrier waits "
                        f"{c['legs'][label]['barrier_s']:.3f} s, K7 "
                        f"{c['legs'][label]['k7_ms']:.3f} ms over "
                        f"{c['legs'][label]['exchanges']} exchanges "
                        f"({c['legs'][label]['restage_k7']} in the re-stage), launches "
                        f"{c['legs'][label]['launches']}"
                        for r, c in enumerate(children)))
            k7 = [c["k7"] for c in children]

            def span(v):
                return f"{min(v):.4f}-{max(v):.4f} (median {statistics.median(v):.4f})"
            log(f"[3p] K7 at [8, {k7[0]['cap']}] per rank, 5 runs each: in process, eight "
                f"pushes {span(in_process['ms'])} ms by events, host window "
                f"{span(in_process['window_ms'])} ms; across processes (4 pushes each, bytes "
                f"equal to the host-staged transport) "
                + ", ".join(f"process {r} {span(v['ms'])} ms by events"
                            for r, v in enumerate(k7))
                + f", host window over both processes' pushes "
                + ", ".join(f"{span(v['window_ms'])} ms (process {r}'s view)"
                            for r, v in enumerate(k7)))
            return {"single": single, "in_process_k7": in_process, "children": children,
                    "wall_s": wall, "phase_wall_s": time.perf_counter() - t_phase}
        errs = "\n".join(e[-3000:] for _o, e in outs)
        if "address already in use" not in errs.lower() or attempt == attempts - 1:
            raise AssertionError(f"3p: a cross-process child failed (rc "
                                 f"{[p.returncode for p in procs]}):\n{errs}")
    raise AssertionError("3p: unreachable")


#: Phase 3q's sizes: the mixed load (``bench/serve_load.py``'s shape, as
#: phase 3m's: closed-loop clients, 2^7-2^10 int32 keys), half the
#: clients and requests to each of the two servers; the packed maximum
#: (``SORT_SERVE_BATCH_KEYS``, 2^16 keys) of int64 and float32; the
#: one-sided solo request (int32 2^26, the largest the default
#: ``SORT_SERVE_MAX_BYTES`` admits); the record request (int32 2^20 with
#: 8 payload bytes); the spill request (int32 2^26 + 2^20, past that
#: bound).
SERVE_CROSS_SIZES = {"mix_requests": 160, "clients": 8, "packed": 1 << 16,
                     "solo": 1 << 26, "records": 1 << 20, "record_bytes": 8,
                     "spill": (1 << 26) + (1 << 20)}

_SERVE_CROSS_CHILD = """
import json, os, sys, threading, time
rank, port, root, card = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4] == "1"
# each process its own trace, flight-recorder and spill paths
mine = os.path.join(root, f"process{rank}")
os.makedirs(mine, exist_ok=True)
os.environ.update(SORT_TRACE=os.path.join(mine, "trace.jsonl"),
                  SORT_FLIGHT_RECORDER_DIR=os.path.join(mine, "flight"),
                  SORT_SPILL_DIR=os.path.join(mine, "spill"),
                  SORT_SERVE_BATCH_WINDOW_MS="8")
import torch, torch.distributed as dist
from mpitest_tpu_torch.ops import exchange
from mpitest_tpu_torch.parallel import make_mesh, multihost_init
from mpitest_tpu_torch.parallel import mesh as mesh_mod
from mpitest_tpu_torch.serve.server import ServerCore, SortServer
from mpitest_tpu_torch.serve.telemetry import TelemetryServer

t0 = time.perf_counter()
multihost_init(f"127.0.0.1:{port}", 2, rank, **({} if card else {"device": "cpu"}))
out = {"init_s": time.perf_counter() - t0, "backend": dist.get_backend()}
rounds = []
try:
    t0 = time.perf_counter()
    # every process builds its core together: make_mesh() gathers the
    # processes' devices over the control group
    core = ServerCore() if card else ServerCore(make_mesh(devices=["cpu"]))
    out["core_s"] = time.perf_counter() - t0
    mesh = core.mesh
    assert mesh.cross_process and mesh.size == 2 and mesh.local_ranks == (rank,), mesh
    assert core.device == mesh.devices[rank], (core.device, mesh)
    t0 = time.perf_counter()
    core.prewarm()
    out["prewarm_s"] = time.perf_counter() - t0
    core.start_watchdog()
    # every control-group round from here on is counted: serving makes none
    gather = mesh_mod._all_gather
    mesh_mod._all_gather = lambda step, obj: rounds.append(step) or gather(step, obj)
    srv = SortServer(core, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    tel = TelemetryServer(core, "127.0.0.1", 0)
    tel.start()
    print(f"LISTENING {srv.bound_port} {tel.bound_port}", flush=True)
    sys.stdin.readline()        # the parent's stop line, or its end
    t0 = time.perf_counter()
    srv.shutdown()
    srv.server_close()
    out["drained"] = core.drain_and_stop(timeout=60)
    tel.shutdown()
    tel.server_close()
    out["shutdown_s"] = time.perf_counter() - t0
    out["control_rounds"] = list(rounds)
    out["breaker"] = core.breaker.snapshot()
    out["flight"] = sorted(os.listdir(os.environ["SORT_FLIGHT_RECORDER_DIR"]))
finally:
    exchange.release_ipc()
    dist.destroy_process_group()
print("SERVECROSS " + json.dumps(out), flush=True)
"""


def serve_crossprocess_phase(sizes: dict, log, *, card: bool = True,
                             attempts: int = 3) -> dict:
    """Phase 3q: the sort server across two processes on the one card.

    Two children join a group on a free port (``multihost_init``: gloo,
    the processes share the card), and each builds ``ServerCore()`` over
    the global mesh, prewarms it, starts its watchdog, a ``SortServer``
    (8 ms window) and a ``TelemetryServer``, with trace, flight-recorder
    and spill paths of its own.  This process is the clients: the mixed
    load, half the clients to each server (every reply equal to
    ``np.sort``; p50/p99 per server); int64 and float32 at the packed
    maximum to each (batched, one bucket of 2^16); a solo request to
    server 0 only, ``internal`` within 5 s while server 1 serves a load,
    neither ``/healthz`` turning 503, no kernel launched; a record request
    to each (``ok`` from server 0, the stable permutation, and
    ``bad_request`` from server 1); a spill request to each
    (``internal``).  Then ``/varz`` of each: the global mesh, no kernel
    launch in the served requests.  Each child drains on the parent's stop
    line, with no control-group round counted after its core was built,
    its breaker closed and its group ended in a ``finally``.  Returns the
    timings and the children's readings."""
    import signal
    import socket
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from mpitest_tpu_torch.report import percentile
    from mpitest_tpu_torch.selftest.spawned import run_load
    from mpitest_tpu_torch.serve.client import ServeClient

    host = "127.0.0.1"
    t_phase = time.perf_counter()

    def get(url: str) -> tuple[int, dict]:
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def load(port: int, requests: int, clients: int, seed: int) -> dict:
        got = run_load(port, requests, clients, seed)
        if got["bad"] or got["statuses"] != {"ok": requests}:
            raise AssertionError(f"3q load on port {port}: statuses {got['statuses']}, "
                                 f"{len(got['bad'])} replies differ from np.sort")
        return {"wall_s": got["wall_s"], "p50_ms": 1e3 * percentile(got["lat"], 50),
                "p99_ms": 1e3 * percentile(got["lat"], 99)}

    def one(port: int, x, **kw):
        with ServeClient(host, port, timeout=300) as c:
            t0 = time.perf_counter()
            r = c.sort(x, **kw)
            return r, time.perf_counter() - t0

    def serve(ports: list[int], tels: list[int]) -> dict:
        res: dict = {}
        half = sizes["clients"] // 2
        for r, port in enumerate(ports):      # warm-up, as phase 3m's
            load(port, max(16, half), half, 1000 + r)
        mix: dict = {}
        ts = [threading.Thread(target=lambda r=r, p=p: mix.__setitem__(
                  r, load(p, sizes["mix_requests"] // 2, half, 3030 + 100 * r)))
              for r, p in enumerate(ports)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if len(mix) != 2:
            raise AssertionError("3q: a mixed-load thread failed")
        res["mix"] = [mix[0], mix[1]]
        rng = np.random.default_rng(77)
        for dtype in ("int64", "float32"):
            n = sizes["packed"]
            x = (rng.standard_normal(n).astype(np.float32) if dtype == "float32" else
                 rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64))
            for r, port in enumerate(ports):
                rep, dt = one(port, x)
                if not (rep.ok and rep.header.get("batched")
                        and rep.header.get("bucket") == n
                        and rep.arr.tobytes() == np.sort(x).tobytes()):
                    raise AssertionError(f"3q packed {dtype} on server {r}: {rep.header}")
                res[f"packed_{dtype}_{r}_s"] = dt
        # a solo request to server 0 only, while server 1 serves a load
        x = rng.integers(-2**31, 2**31 - 1, sizes["solo"], dtype=np.int32)
        side: dict = {}
        t = threading.Thread(target=lambda: side.update(load(ports[1], 40, 2, 4040)))
        t.start()
        rep, dt = one(ports[0], x, algo="radix")
        t.join()
        if rep.ok or rep.error != "internal" or "RuntimeError" not in rep.detail:
            raise AssertionError(f"3q one-sided solo: {rep.header}")
        if dt >= 5.0:
            raise AssertionError(f"3q one-sided solo took {dt:.3f} s (limit 5 s)")
        if "p50_ms" not in side:
            raise AssertionError("3q: server 1's load during the solo request failed")
        res["solo_s"] = dt
        res["during_solo"] = side
        for r, tport in enumerate(tels):
            code, health = get(f"http://{host}:{tport}/healthz")
            if code != 200 or health.get("breaker") != "closed":
                raise AssertionError(f"3q /healthz of server {r}: {code} {health}")
        del x
        # a record request to each: rank 0 lies in process 0
        n = sizes["records"]
        x = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int32)
        pay = rng.integers(0, 256, (n, sizes["record_bytes"]), dtype=np.uint8)
        order = np.argsort(x, kind="stable")
        for r, port in enumerate(ports):
            rep, dt = one(port, x, payload=pay)
            res[f"records_{r}_s"] = dt
            if r == 0:
                if not (rep.ok and np.array_equal(rep.arr, x[order])
                        and np.array_equal(rep.payload, pay[order])):
                    raise AssertionError(f"3q records on server 0: {rep.header}")
            elif rep.ok or rep.error != "bad_request":
                raise AssertionError(f"3q records on server 1: {rep.header}")
        del x, pay, order
        # a spill request to each: past the byte bound, refused as a solo one
        x = rng.integers(-2**31, 2**31 - 1, sizes["spill"], dtype=np.int32)
        for r, port in enumerate(ports):
            rep, dt = one(port, x)
            res[f"spill_{r}_s"] = dt
            if rep.ok or rep.error != "internal":
                raise AssertionError(f"3q spill on server {r}: {rep.header}")
        del x
        res["varz"] = []
        for r, tport in enumerate(tels):
            code, varz = get(f"http://{host}:{tport}/varz")
            launched = {k: v for k, v in varz["kernels"]["launches"].items() if v}
            if code != 200 or varz["mesh"]["devices"] != 2 or launched:
                raise AssertionError(f"3q /varz of server {r}: {code} {varz['mesh']} "
                                     f"launches {launched}")
            res["varz"].append({"mesh": varz["mesh"], "requests": varz["requests"],
                                "batcher": varz["batcher"],
                                "launches": varz["kernels"]["launches"]})
        return res

    for attempt in range(attempts):
        with socket.socket() as s:
            s.bind((host, 0))
            port = s.getsockname()[1]
        with tempfile.TemporaryDirectory() as root:
            errs = [open(os.path.join(root, f"stderr{r}"), "w+") for r in range(2)]
            t0 = time.perf_counter()
            procs = [subprocess.Popen([sys.executable, "-c", _SERVE_CROSS_CHILD, str(r),
                                       str(port), root, "1" if card else "0"],
                                      stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                      stderr=errs[r], text=True,
                                      cwd=os.path.dirname(os.path.abspath(__file__)))
                     for r in range(2)]
            # a child that never answers is killed; its pipes then end
            killer = threading.Timer(600, lambda: [p.kill() for p in procs])
            killer.start()
            try:
                lines = [next((ln for ln in iter(p.stdout.readline, "")
                               if ln.startswith("LISTENING ")), "") for p in procs]
                start_s = time.perf_counter() - t0
                res = None
                if all(ln.startswith("LISTENING ") for ln in lines):
                    ports = [int(ln.split()[1]) for ln in lines]
                    tels = [int(ln.split()[2]) for ln in lines]
                    try:
                        res = serve(ports, tels)
                    finally:
                        for p in procs:
                            with contextlib.suppress(OSError):
                                p.stdin.write("stop\n")
                                p.stdin.flush()
                outs = [p.communicate(timeout=120)[0] for p in procs]
            finally:
                killer.cancel()
                for p in procs:
                    if p.poll() is None:
                        p.send_signal(signal.SIGKILL)
                        p.wait()
            wall = time.perf_counter() - t0
            err_text = []
            for f in errs:
                f.seek(0)
                err_text.append(f.read())
                f.close()
        if res is not None and all(p.returncode == 0 for p in procs):
            children = [json.loads(next(ln for ln in o.splitlines()
                                        if ln.startswith("SERVECROSS ")).split(" ", 1)[1])
                        for o in outs]
            for r, c in enumerate(children):
                if (c["control_rounds"] or not c["drained"] or c["shutdown_s"] > 30
                        or c["breaker"]["state"] != "closed" or c["breaker"]["trips"]):
                    raise AssertionError(f"3q child {r}: {c}")
                if not any("serve_internal_RuntimeError" in f for f in c["flight"]):
                    raise AssertionError(f"3q child {r}: no refusal in the flight dumps "
                                         f"{c['flight']}")
            res.update(children=children, start_s=start_s, wall_s=wall,
                       phase_wall_s=time.perf_counter() - t_phase)
            log(f"[3q] two servers across processes: start {start_s:.3f} s (core "
                + ", ".join(f"{c['core_s']:.3f}" for c in children) + " s, prewarm "
                + ", ".join(f"{c['prewarm_s']:.3f}" for c in children) + " s); mixed load "
                + "; ".join(f"server {r} p50 {m['p50_ms']:.3f} ms, p99 {m['p99_ms']:.3f} ms "
                            f"over {sizes['mix_requests'] // 2} requests"
                            for r, m in enumerate(res["mix"]))
                + f"; one-sided solo int32 2^{sizes['solo'].bit_length() - 1} internal in "
                f"{res['solo_s']:.3f} s (server 1 meanwhile p50 "
                f"{res['during_solo']['p50_ms']:.3f} ms); records "
                f"{res['records_0_s']:.3f} s ok / {res['records_1_s']:.3f} s bad_request; "
                f"spill internal in {res['spill_0_s']:.3f} / {res['spill_1_s']:.3f} s; "
                f"launches in the servers {[v['launches'] for v in res['varz']]}; "
                f"shutdown " + ", ".join(f"{c['shutdown_s']:.3f}" for c in children)
                + f" s; children {wall:.3f} s")
            return res
        errs_joined = "\n".join(e[-3000:] for e in err_text)
        if "address already in use" not in errs_joined.lower() or attempt == attempts - 1:
            raise AssertionError(f"3q: a server child failed (rc "
                                 f"{[p.returncode for p in procs]}):\n{errs_joined}")
    raise AssertionError("3q: unreachable")


#: The verifier phase's sizes: one plane of the one-rank cell, the radix
#: cell's eight shards, and two-word keys at K2's shape.
VERIFY_SIZES = {"plane": 1 << 30, "shards": 8, "shard": 1 << 25, "pairs": 1 << 27,
                "unaligned": 1 << 24}


def verify_phase(log, card: str, sizes: dict = VERIFY_SIZES) -> dict:
    """The verifier's scan (``verify_scan``, ``ops/fold.py``) on the card
    against its plain version, then timed.

    Checks, every row exact: one plane of ``sizes["plane"]`` sorted words
    (the whole scan, the fold alone, the fold of a prefix with the whole
    order checked), then with a pair swapped and a word corrupted at the
    seams 4095/4096 (vector, warp and block), at the middle block seam and
    at the last pair; ``sizes["shards"]`` views of ``sizes["shard"]``
    words of one sorted array (the radix cell's shards: each shard's row,
    and ``verify_result`` of the result clean, with one seam between
    shards broken and with one word duplicated); two-word planes of
    ``sizes["pairs"]`` keys with the high word narrow (ties decided by
    the low word) with faults at the same seams; planes one word past a
    16-byte boundary (the kernel's one-word head, then its vectors) and
    two planes at different offsets (its one-word loop).  Timed by CUDA
    events (warm median of ``REPS``): the scan of the plane, the fold
    alone, the scan of the pairs, the shifted plane, the two planes at
    different offsets, and the check of the
    eight shards (one zeroed row tensor, eight launches, one read), each
    beside its bound (the bytes read once at 3.35 TB/s) and beside the
    PyTorch chain it replaces (the plain version on the card); the
    launches of one ``sort()`` of the plane."""
    import numpy as np
    import torch

    from mpitest_tpu_torch.models import api
    from mpitest_tpu_torch.models import verify as vfy
    from mpitest_tpu_torch.ops import _build, fold

    dev = torch.device("cuda")
    out: dict = {"card": card}

    def sync() -> None:
        torch.cuda.synchronize()

    def events(fn, reps: int = REPS) -> float:
        fn()
        sync()
        ms = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        return statistics.median(ms)

    def row_of(words, n_sorted, n_fold, i_last, plain=False):
        if plain:
            return [int(v) & 0xFFFFFFFF for v in
                    fold.scan_plain(words, n_sorted, n_fold, i_last).tolist()]
        row = torch.zeros(fold.row_width(len(words)), dtype=torch.int64, device=dev)
        fold.scan(words, n_sorted, n_fold, i_last, row)
        return [int(v) & 0xFFFFFFFF for v in row.tolist()]

    checked = 0

    def same(label, words, n_sorted, n_fold, i_last, flag=None):
        nonlocal checked
        got = row_of(words, n_sorted, n_fold, i_last)
        want = row_of(words, n_sorted, n_fold, i_last, plain=True)
        if got != want:
            raise AssertionError(f"verify_scan {label}: kernel {got} != plain {want}")
        k = len(words)
        if flag is not None and got[2 * k] != flag:
            raise AssertionError(f"verify_scan {label}: order flag {got[2 * k]}, "
                                 f"expected {flag}")
        checked += 1
        return got

    def swap(words, j):
        for w in words:
            a, b = w[j].clone(), w[j + 1].clone()
            w[j], w[j + 1] = b, a

    def seams(label, words):
        """Faults at the seams of sorted planes, each undone after."""
        n = words[0].numel()
        clean = same(f"{label} clean", words, n, n, n - 1, flag=0)
        for j in (3, 127, 1023, 4095, n // 2 - 1, n - 2):
            if all(int(w[j]) == int(w[j + 1]) for w in words):
                continue
            swap(words, j)
            same(f"{label} swapped {j}/{j + 1}", words, n, n, n - 1, flag=1)
            swap(words, j)
            words[-1][j + 1] ^= 0x10000
            got = same(f"{label} corrupted {j + 1}", words, n, n, n - 1)
            words[-1][j + 1] ^= 0x10000
            if got[:2 * len(words)] == clean[:2 * len(words)]:
                raise AssertionError(f"verify_scan {label}: corrupting word "
                                     f"{j + 1} left the fold unchanged")

    # ---- one plane of the one-rank cell
    n = sizes["plane"]
    g = torch.Generator(device=dev).manual_seed(1900)
    x = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev, generator=g)
    plane = (torch.sort(x).values ^ -(2**31),)      # unsigned order, as encode_torch
    sync()
    same("plane fold", plane, 0, n, -1)
    same("plane prefix", plane, n, n - 12345, n - 12346, flag=0)
    seams("plane", plane)
    same("plane unsorted", (x,), n, n, n - 1, flag=1)
    launches = _build.launches("verify_scan")
    res = api.DistributedSortResult(plane, n, np.dtype(np.uint32))
    t_check = events(lambda: vfy.verify_result(res, None))
    t_scan = events(lambda: fold.scan(plane, n, n, n - 1, torch.zeros(
        fold.row_width(1), dtype=torch.int64, device=dev)))
    t_fold = events(lambda: fold.scan(plane, 0, n, -1, torch.zeros(
        fold.row_width(1), dtype=torch.int64, device=dev)))
    t_plain = events(lambda: fold.scan_plain(plane, n, n, n - 1), reps=PLAIN_REPS)
    bound = 4 * n / HBM_BYTES_PER_S * 1e3
    out["plane"] = {"n": n, "scan_ms": t_scan, "fold_ms": t_fold,
                    "verify_result_ms": t_check, "plain_ms": t_plain,
                    "bound_ms": bound, "scan_share": bound / t_scan}
    log(f"[verify] one plane of 2^{n.bit_length() - 1}: scan {t_scan:.4f} ms "
        f"({4 * n / t_scan / 1e6:.1f} GB/s, {100 * bound / t_scan:.1f}% of "
        f"3.35 TB/s), fold alone {t_fold:.4f} ms, verify_result (zeroing, launch, "
        f"read) {t_check:.4f} ms; bound {bound:.4f} ms; the PyTorch chain it "
        f"replaces (plain version on the card) {t_plain:.3f} ms | card {card}")
    api.sort(x, device=dev, return_result=True)                # warm: builds K1
    sync()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        api.sort(x, device=dev, return_result=True)
        sync()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    verify_ms = [e.time_range.elapsed_us() / 1e3 for e in kernels
                 if "verify_scan" in e.name]
    out["sort_launches"] = {"all": len(kernels), "verify_scan_ms": verify_ms}
    log(f"[verify] sort() of the plane: {len(kernels)} device operations, "
        f"{len(verify_ms)} verify_scan ({', '.join(f'{v:.4f}' for v in verify_ms)} ms) "
        f"| card {card}")
    del x, plane, res
    torch.cuda.empty_cache()

    # ---- the radix cell's eight shards
    P, m = sizes["shards"], sizes["shard"]
    x = torch.randint(-(2**31), 2**31, (P * m,), dtype=torch.int32, device=dev, generator=g)
    whole = torch.sort(x).values ^ -(2**31)
    shards = tuple((whole[r * m:(r + 1) * m],) for r in range(P))
    for r, s in enumerate(shards):
        same(f"shard {r}", s, m, m, m - 1, flag=0)
        same(f"shard {r} fold", s, 0, m, -1)
    fp_in = vfy.fingerprint_device([(x ^ -(2**31),)], P * m)
    res = api.DistributedSortResult((), P * m, np.dtype(np.int32), shards=shards)
    if vfy.verify_result(res, fp_in) != (True, True):
        raise AssertionError("verify_result of the clean shards failed")
    a, b = whole[3 * m - 1].clone(), whole[3 * m].clone()
    whole[3 * m - 1], whole[3 * m] = b, a           # the seam between ranks 2 and 3
    if vfy.verify_result(res, fp_in) != (False, True):
        raise AssertionError("verify_result missed a broken seam between shards")
    whole[3 * m - 1], whole[3 * m] = a, b
    keep = whole[5 * m + 7].clone()
    whole[5 * m + 7] = whole[5 * m + 6]
    if vfy.verify_result(res, fp_in) != (True, False):
        raise AssertionError("verify_result missed a duplicated key")
    whole[5 * m + 7] = keep
    t_shards = events(lambda: vfy.verify_result(res, fp_in))
    t_shards_plain = events(lambda: [fold.scan_plain(s, m, m, m - 1) for s in shards],
                            reps=PLAIN_REPS)
    bound = 4 * P * m / HBM_BYTES_PER_S * 1e3
    out["shards"] = {"P": P, "n": m, "verify_result_ms": t_shards,
                     "plain_ms": t_shards_plain, "bound_ms": bound}
    log(f"[verify] {P} shards of 2^{m.bit_length() - 1}: verify_result {t_shards:.4f} "
        f"ms (one zeroed row tensor, {P} launches, one read), bound {bound:.4f} ms; "
        f"the PyTorch chain (plain version on the card) {t_shards_plain:.3f} ms "
        f"| card {card}")
    del x, whole, shards, res
    torch.cuda.empty_cache()

    # ---- two-word planes
    n = sizes["pairs"]
    hi = torch.randint(0, 64, (n,), dtype=torch.int64, device=dev, generator=g)
    lo = torch.randint(0, 2**32, (n,), dtype=torch.int64, device=dev, generator=g)
    key = torch.sort((hi << 32) | lo).values.view(torch.int32).view(-1, 2)
    pairs = (key[:, 1].contiguous(), key[:, 0].contiguous())    # (hi, lo)
    del hi, lo, key
    same("pairs fold", pairs, 0, n, -1)
    same("pairs prefix", pairs, n, n // 3, n // 3 - 1, flag=0)
    seams("pairs", pairs)
    t_pairs = events(lambda: fold.scan(pairs, n, n, n - 1, torch.zeros(
        fold.row_width(2), dtype=torch.int64, device=dev)))
    t_pairs_plain = events(lambda: fold.scan_plain(pairs, n, n, n - 1), reps=PLAIN_REPS)
    bound = 8 * n / HBM_BYTES_PER_S * 1e3
    out["pairs"] = {"n": n, "scan_ms": t_pairs, "plain_ms": t_pairs_plain,
                    "bound_ms": bound}
    log(f"[verify] two planes of 2^{n.bit_length() - 1}: scan {t_pairs:.4f} ms, bound "
        f"{bound:.4f} ms ({100 * bound / t_pairs:.1f}%); plain {t_pairs_plain:.3f} ms "
        f"| card {card}")
    del pairs
    torch.cuda.empty_cache()

    # ---- planes past a 16-byte boundary: one word past it (a one-word
    # head, then vectors), and two planes at different offsets (the
    # one-word loop)
    n = sizes["unaligned"]
    for label, offs in (("x1 +1", (1,)), ("x2 +1", (1, 1)), ("x2 +1/+2", (1, 2))):
        buf = [torch.sort(torch.randint(-(2**31), 2**31, (n + o,), dtype=torch.int32,
                                        device=dev, generator=g)).values ^ -(2**31)
               for o in offs]
        off = tuple(b[o:] for b, o in zip(buf, offs))
        same(f"unaligned {label}", off, n, n, n - 1, flag=0)
        same(f"unaligned {label} fold", off, 0, n - 5, -1)
        seams(f"unaligned {label}", off)
        if label != "x2 +1":
            t_off = events(lambda: fold.scan(off, n, n, n - 1, torch.zeros(
                fold.row_width(len(off)), dtype=torch.int64, device=dev)))
            bound = 4 * n * len(off) / HBM_BYTES_PER_S * 1e3
            out[f"unaligned {label}"] = {"n": n, "scan_ms": t_off, "bound_ms": bound}
            log(f"[verify] {len(off)} plane(s) of 2^{n.bit_length() - 1} at word "
                f"offsets {offs}: scan {t_off:.4f} ms, bound {bound:.4f} ms "
                f"| card {card}")
    out["checked"] = checked
    out["launches"] = _build.launches("verify_scan") - launches
    log(f"[verify] {checked} rows equal to the plain version's, every fault found "
        f"| card {card}")
    return out


#: The placement phase's size: the radix cell's (2^28 int32 keys over
#: eight ranks of the card, two 16-bit passes).
SLOT_PLACE_SIZES = {"keys": 1 << 28, "ranks": 8}


def slot_place_phase(log, card: str, sizes: dict = SLOT_PLACE_SIZES) -> dict:
    """``slot_place`` (``ops/exchange.py``) on the receive buffers of a
    real exchange at the radix cell's shape, against its plain version and
    the sorts it replaced.

    One eight-rank radix ``sort()`` of ``sizes["keys"]`` int32 keys runs
    with ``exchange.slot_place`` wrapped, keeping rank 0's two calls: the
    merge pass's (with the digit plane) and the final merge's.  Each is
    checked byte for byte against the plain version on the card, then
    timed by CUDA events (warm median of ``REPS``): the call (output fill
    and launch), the kernel alone (profiler), the plain version, and the
    merge it replaced (the merge pass's sort keyed on ``(digit, slot)``
    over the whole receive buffer; the final sort by slot and its gather)
    beside the merge as it is now (placement, then the stable digit
    sort).  Bound: the slot plane read once, the valid lanes of each
    plane read once, each output plane written once, at 3.35 TB/s."""
    import torch

    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.models import radix_sort
    from mpitest_tpu_torch.ops import _build, exchange, kernels
    from mpitest_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda")
    out: dict = {"card": card}

    def events(fn, reps: int = REPS) -> float:
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        return statistics.median(ms)

    def kernel_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        ms = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "place_rows" in e.name)
        if len(ms) != REPS:
            raise AssertionError(f"slot_place: {len(ms)} place_rows kernels in "
                                 f"{REPS} calls")
        return statistics.median(ms)

    calls: dict[str, tuple] = {}
    real = exchange.slot_place

    def keep(planes, slot, n, digit=None):
        key = "merge" if digit is not None else "final"
        calls.setdefault(key, (tuple(planes), slot, n, digit))
        return real(planes, slot, n, digit)

    P = sizes["ranks"]
    g = torch.Generator(device=dev).manual_seed(2200)
    x = torch.randint(-(2**31), 2**31, (sizes["keys"],), dtype=torch.int32, device=dev,
                      generator=g)
    before = _build.launches("slot_place")
    exchange.slot_place = keep
    try:
        res = mt.sort(x, algorithm="radix", mesh=make_mesh(P), return_result=True)
    finally:
        exchange.slot_place = real
    launches = _build.launches("slot_place") - before
    if launches != 2 * P:
        raise AssertionError(f"slot_place: {launches} launches in one sort, expected {2 * P}")
    if not torch.equal(torch.cat([s[0] for s in res.shards]) ^ -(2**31),
                       torch.sort(x).values):
        raise AssertionError("slot_place: the eight-rank sort differs from torch.sort")
    del res
    out["launches_per_sort"] = launches
    for key in ("merge", "final"):
        planes, slot, n, digit = calls[key]
        got = real(planes, slot, n, digit)
        want = exchange.slot_place_plain(planes, slot, n, digit)
        if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"slot_place {key}: kernel differs from the plain version")
        rows, cap = slot.shape
        n_out = len(got)
        nbytes = 4 * (rows * cap + n * len(planes) + n * n_out)
        t_call = events(lambda: real(planes, slot, n, digit))
        t_kernel = kernel_ms(lambda: real(planes, slot, n, digit))
        t_plain = events(lambda: exchange.slot_place_plain(planes, slot, n, digit),
                         reps=PLAIN_REPS)
        if key == "merge":
            w_idx, shift, bits, cnts = digit

            def replaced():
                d = kernels.digit_at(planes[w_idx], shift, bits)
                c = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
                d = torch.where(c < cnts[:, None], d,
                                torch.full((), 1 << bits, dtype=torch.int32, device=dev))
                k = (d.to(torch.int64) << 32) | slot.to(torch.int64)
                ks, order = torch.sort(k.reshape(-1))
                order = order[:n]
                return (ks[:n] >> 32).to(torch.int32), [p.reshape(-1)[order] for p in planes]

            def now():
                return radix_sort._merge_pass(planes, cnts, slot, w_idx, shift, bits, n)
        else:
            def replaced():
                order = torch.sort(slot.reshape(-1)).indices[:n]
                return [p.reshape(-1)[order] for p in planes]

            def now():
                return real(planes, slot, n)
        t_replaced = events(replaced)
        t_now = events(now)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out[key] = {"rows": rows, "cap": cap, "n": n, "planes": len(planes),
                    "outputs": n_out, "call_ms": t_call, "kernel_ms": t_kernel,
                    "plain_ms": t_plain, "bound_ms": bound,
                    "kernel_share": bound / t_kernel, "replaced_ms": t_replaced,
                    "merge_now_ms": t_now}
        log(f"[slot_place] {key} of rank 0, [{rows}, {cap}] -> {n_out} x 2^"
            f"{n.bit_length() - 1}: kernel {t_kernel:.4f} ms ({100 * bound / t_kernel:.1f}% "
            f"of the {bound:.4f} ms bound), call with its output fill {t_call:.4f} ms, "
            f"plain version on the card {t_plain:.3f} ms; the merge it replaced "
            f"{t_replaced:.3f} ms, the merge now {t_now:.3f} ms | card {card}")
    calls.clear()
    torch.cuda.empty_cache()
    return out



#: The digit sort phase's size: the radix cell's (2^28 int32 keys over
#: eight ranks of the card, two 16-bit passes).
DIGIT_SORT_SIZES = {"keys": 1 << 28, "ranks": 8}


def digit_sort_phase(log, card: str, sizes: dict = DIGIT_SORT_SIZES) -> dict:
    """The distributed radix's digit sort (``digit_count`` +
    ``digit_scatter``, ``ops/radix.py``) at the radix cell's shape,
    against its plain version and the library calls it replaced.

    One eight-rank radix ``sort()`` of ``sizes["keys"]`` int32 keys runs
    with ``radix.digit_sort`` and ``radix.digit_count`` wrapped, keeping
    rank 0's calls: pass 1's sort (a bit field of the word), the merge
    pass's (the digit plane, with its sentinel) and the probe's count.
    The sort must launch exactly P counts for the probe, and a count and
    two scatters a rank a pass, and equal ``torch.sort``.  Each kept call
    is checked byte for byte against the plain version on the card, then
    timed by CUDA events (warm median of ``REPS``): the call (its memsets
    and launches), the kernels alone (profiler: ``k4_digit_count`` and
    ``k4_digit_scatter``), the plain version, and the library calls it
    replaced (``torch.sort(stable=True)`` of the digit and a gather of
    every plane; the probe's sort and ``histogram_sorted``).  Bound: the
    key read once by the count, and every plane read and written once a
    scatter pass, at 3.35 TB/s."""
    import torch

    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.ops import _build, kernels, radix
    from mpitest_tpu_torch.parallel.mesh import make_mesh

    out: dict = {"card": card}
    dev = torch.device("cuda")

    def events(fn, reps: int = REPS) -> float:
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        return statistics.median(ms)

    def kernel_ms(fn) -> dict[str, float]:
        """Device ms a call of each ``k4_digit_`` kernel, summed over the
        call's launches (profiler, mean of ``REPS`` calls)."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        got: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and "k4_digit_" in e.name:
                name = "count" if "k4_digit_count" in e.name else "scatter"
                got[name] = got.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / REPS
        if not got:
            raise AssertionError("digit sort: no k4_digit_ kernel in the profile")
        return got

    calls: dict[str, tuple] = {}
    real_sort, real_count = radix.digit_sort, radix.digit_count

    def keep_sort(words, bits, digits=None, w_idx=0, shift=0):
        calls.setdefault("first" if digits is None else "merge",
                         (tuple(words), bits, digits, w_idx, shift))
        return real_sort(words, bits, digits, w_idx, shift)

    def keep_count(word, shift, bits):
        calls.setdefault("probe", (word, shift, bits))
        return real_count(word, shift, bits)

    P = sizes["ranks"]
    g = torch.Generator(device=dev).manual_seed(2500)
    x = torch.randint(-(2**31), 2**31, (sizes["keys"],), dtype=torch.int32, device=dev,
                      generator=g)
    before = dict(_build.LAUNCHES)
    radix.digit_sort, radix.digit_count = keep_sort, keep_count
    try:
        res = mt.sort(x, algorithm="radix", mesh=make_mesh(P), return_result=True)
    finally:
        radix.digit_sort, radix.digit_count = real_sort, real_count
    launches = {k: _build.LAUNCHES[k] - before[k] for k in ("digit_count", "digit_scatter")}
    if launches != {"digit_count": P + 2 * P, "digit_scatter": 2 * 2 * P}:
        raise AssertionError(f"digit sort: launches {launches} in one sort, expected "
                             f"{P} + {2 * P} counts and {4 * P} scatters")
    if not torch.equal(torch.cat([s[0] for s in res.shards]) ^ -(2**31),
                       torch.sort(x).values):
        raise AssertionError("digit sort: the eight-rank sort differs from torch.sort")
    del res
    out["launches_per_sort"] = launches
    for key in ("first", "merge", "probe"):
        if key == "probe":
            word, shift, bits = calls[key]
            n = word.numel()
            got = real_count(word, shift, bits)
            want = radix.digit_count_plain(word, shift, bits)
            same = all(torch.equal(a, b) for a, b in zip(got, want))

            def now():
                return real_count(word, shift, bits)

            def plain():
                return radix.digit_count_plain(word, shift, bits)

            def library():
                d = kernels.digit_at(word, shift, bits)
                return kernels.histogram_sorted(torch.sort(d).values, 1 << bits)
            planes, nbytes = 1, 4 * n
        else:
            words, bits, digits, w_idx, shift = calls[key]
            n = words[0].numel()
            got = real_sort(words, bits, digits, w_idx, shift)
            want = radix.digit_sort_plain(words, bits, digits, w_idx, shift)
            same = ((got[0] is None) == (want[0] is None)
                    and (got[0] is None or torch.equal(got[0], want[0]))
                    and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
                    and all(torch.equal(a, b) for a, b in zip(got[2], want[2])))

            def now():
                return real_sort(words, bits, digits, w_idx, shift)

            def plain():
                return radix.digit_sort_plain(words, bits, digits, w_idx, shift)

            def library():
                d = digits if digits is not None else kernels.digit_at(words[w_idx],
                                                                        shift, bits)
                order = torch.sort(d, stable=True).indices
                return [w[order] for w in words]
            planes = len(words) + (digits is not None)
            key_bits = bits + 1 if digits is not None else min(bits, 32 - shift)
            nbytes = 4 * n * (1 + 2 * planes * len(radix.sweep_split(key_bits)))
        if not same:
            raise AssertionError(f"digit sort {key}: kernel differs from the plain version")
        t_call = events(now)
        t_kernels = kernel_ms(now)
        t_plain = events(plain, reps=PLAIN_REPS)
        t_library = events(library)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        t_kernel = sum(t_kernels.values())
        out[key] = {"n": n, "bits": bits, "planes": planes, "call_ms": t_call,
                    "kernel_ms": t_kernel, "count_ms": t_kernels.get("count", 0.0),
                    "scatter_ms": t_kernels.get("scatter", 0.0), "plain_ms": t_plain,
                    "library_ms": t_library, "bound_ms": bound,
                    "kernel_share": bound / t_kernel}
        log(f"[digit_sort] {key} of rank 0, 2^{n.bit_length() - 1} keys, {bits}-bit digit, "
            f"{planes} plane(s): kernels {t_kernel:.4f} ms (count "
            f"{t_kernels.get('count', 0.0):.4f}, scatter {t_kernels.get('scatter', 0.0):.4f}; "
            f"{100 * bound / t_kernel:.1f}% of the {bound:.4f} ms bound), call {t_call:.4f} "
            f"ms, plain version on the card {t_plain:.3f} ms, the library calls it replaced "
            f"{t_library:.3f} ms | card {card}")
    calls.clear()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    import numpy as np

    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch import cli
    from mpitest_tpu_torch.models import api, ingest, segmented
    from mpitest_tpu_torch.ops import _build, bitonic, exchange, kernels, pack, radix
    from mpitest_tpu_torch.ops.keys import codec_for, to_device_words, unsigned_order
    from mpitest_tpu_torch.parallel.mesh import make_mesh
    from mpitest_tpu_torch.store import compress
    from mpitest_tpu_torch.store import merge as mergelib
    from mpitest_tpu_torch.utils import io as kio
    from mpitest_tpu_torch.utils import knobs, native_encode
    from mpitest_tpu_torch.utils.trace import Tracer

    t_smoke = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()

    # every Tracer the run creates (sort() makes its own when the caller
    # passes none), so each clean phase holds them to LADDER_COUNTERS
    tracers: list = []
    tracer_init = Tracer.__init__

    def tracked_init(self, *a, **k) -> None:
        tracer_init(self, *a, **k)
        tracers.append(self)

    Tracer.__init__ = tracked_init

    def assert_clean(phase: str) -> None:
        for tr in tracers:
            bad = {c: tr.counters[c] for c in LADDER_COUNTERS if c in tr.counters}
            if bad:
                raise AssertionError(f"clean phase {phase}: a run set {bad}")
        log(f"[clean] phase {phase}: {len(tracers)} tracers, none with a fault "
            "or ladder counter")
        tracers.clear()

    def sync() -> None:
        torch.cuda.synchronize()

    def u64(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.int64) & 0xFFFFFFFF

    def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
        return int((u64(a) - u64(b)).abs().max())

    def timed(fn, reps: int) -> float:
        fn()
        sync()
        ms = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        return statistics.median(ms)

    def words(n: int, seed: int, high: int = 2**31) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(-(2**31), high, (n,), dtype=torch.int32,
                             device=dev, generator=g)

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    _build.build(*names)
    log(f"[build] {names} built in {time.perf_counter() - t0:.2f} s "
        f"into {_build.BUILD_DIR}")
    t0 = time.perf_counter()
    native_ok = native_encode.build()
    log(f"[build] host text parser {native_encode.LIB_PATH}: "
        f"{'built' if native_ok else 'not built: ' + str(native_encode.unavailable_reason())}"
        f" in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    log(f"[build] spill codec {compress.lib_path()}: "
        f"{'built' if compress.available() else 'not built: ' + str(compress.unavailable_reason())}"
        f" in {time.perf_counter() - t0:.2f} s")
    log(f"[card] {card}")
    assert_clean("1")

    # ---------------------------------------------------- 2. kernels vs plain
    before = dict(bitonic.LAUNCHES)
    for n_log2 in (20, 24):
        n = 1 << n_log2
        x = words(n, n_log2)
        srt = torch.sort(x).values
        with_pads = words(n, n_log2 + 1)
        with_pads[::7] = -1                      # real 0xFFFFFFFF keys ...
        with_pads[n - n // 5:] = -1              # ... among the pads
        patterns = {"random": x, "all_equal": torch.full_like(x, 12345),
                    "sorted": unsigned_order(srt),
                    "reversed": unsigned_order(srt.flip(0)),
                    "max_keys_and_pads": with_pads,
                    "two_values": words(n, 7) & 1}
        for name, p in patterns.items():
            got = bitonic.sort_padded(p, n, bitonic.BLOCK_LOG2)
            want = bitonic.sort_padded_plain(p)
            sync()
            if not torch.equal(got, want):
                raise AssertionError(f"K1 2^{n_log2} {name}: kernel != plain")
        odd = with_pads[: n - 3001]
        got = bitonic.bitonic_sort_u32(odd)
        want = unsigned_order(torch.sort(unsigned_order(odd)).values)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 bitonic_sort_u32 2^{n_log2}-3001 wrong")
        log(f"[kernels] K1 2^{n_log2}: {len(patterns)} patterns + padded "
            f"n equal to plain (bytes), {bitonic.merge_rounds(n)} merge rounds")

    n = 1 << 20
    k = words(n, 21) & 0xFFF                     # equal-key runs of ~256
    p = words(n, 22)
    gk, gp = bitonic.sort_pairs_padded(k, p, n, bitonic.PAIR_BLOCK_LOG2)
    wk, wp = bitonic.sort_pairs_padded_plain(k, p)
    sync()
    if not torch.equal(gk, wk):
        raise AssertionError("K2 2^20: key plane differs from plain")

    def pair_multiset(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.sort((u64(a) << 32) | u64(b)).values

    if not torch.equal(pair_multiset(gk, gp), pair_multiset(wk, wp)):
        raise AssertionError("K2 2^20: payload multiset per key run differs")
    # K2 keeps the network's comparators, so the payload order inside each
    # equal-key run is the plain version's to the byte
    if not torch.equal(gp, wp):
        raise AssertionError("K2 2^20: payload bytes differ from plain")
    log(f"[kernels] K2 2^20: keys and payload bytes equal to plain, passes "
        f"(tile sorts, staged, tails) = {bitonic.network_plan(n)}")

    rng = np.random.default_rng(23)
    for max_run, b_log2, passes in ((16, 16, 16), (24, 16, 16), (16, 10, 16),
                                    (40, 13, 32), (8, 12, 1), (24, 10, 0)):
        lens = rng.integers(1, max_run + 1, n)
        hi_np = np.repeat(np.arange(lens.size, dtype=np.uint32) * 7 + 1,
                          lens)[:n]
        hi = to_device_words(hi_np, dev)
        lo = words(n, max_run + b_log2)
        got = bitonic.fix_runs_pairs(hi, lo, passes, b_log2)
        if not torch.equal(got, bitonic.fix_runs_pairs_plain(hi, lo, passes, b_log2)):
            raise AssertionError(f"K3 2^20 runs<= {max_run} b_log2={b_log2} "
                                 f"passes={passes}: kernel != plain")
        # phase B in one call: K3, the boundary-strip kernel, the flag byte
        got, bad = bitonic.fix_runs_flag(hi, lo, passes, b_log2)
        want, want_bad = bitonic.fix_runs_flag_plain(hi, lo, passes, b_log2)
        sync()
        if not torch.equal(got, want) or bool(bad) != bool(want_bad):
            raise AssertionError(f"K3 phase B 2^20 runs<= {max_run} b_log2={b_log2} "
                                 f"passes={passes}: kernel != plain")
        log(f"[kernels] K3 and phase B 2^20 runs 1..{max_run} bsz 2^{b_log2} "
            f"passes {passes}: lo bytes equal, residual={bool(bad)} on both")

    def k4_plain(ws, diffs=None):
        planes = ws
        for widx, shift, bits in radix.pass_plan(diffs, len(ws)):
            planes = radix.radix_pass_plain(planes, widx, shift, bits)
        return planes

    def k4_check(label: str, ws, diffs=None, quiet: bool = False) -> int:
        got = radix.fused_radix_sort(ws, diffs=diffs)
        want = k4_plain(ws, diffs)
        sync()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K4 {label}: kernel != plain (max_abs_err {err})")
        if not quiet:
            log(f"[kernels] K4 {label}: {len(radix.pass_plan(diffs, len(ws)))} "
                "passes, bytes equal to plain")
        return err

    n = 1 << 20
    for n_planes in (1, 2, 4):
        ws = tuple(words(n, 40 + i) for i in range(n_planes))
        k4_check(f"2^20 x{n_planes} full plan", ws)
        narrow = tuple(w & 0xFFFFF for w in ws)
        k4_check(f"2^20 x{n_planes} compacted plan (20-bit words)", narrow,
                 (0xFFFFF,) * n_planes)
    k4_check("2^20 x2 compacted plan (constant hi word)",
             (torch.full((n,), 7, dtype=torch.int32, device=dev), words(n, 45) & 0xFFF),
             (0, 0xFFF))
    digit = words(n, 46) & 0xFF                  # ~4096 keys per digit
    k4_check("2^20 payload (digit,)+2 words diffs (255,0,0)",
             (digit, words(n, 47), words(n, 48)), (255, 0, 0))
    k4_check("2^20-3001 x2 full plan", (words(n - 3001, 49), words(n - 3001, 50)))
    x = words(n, 51)
    srt = unsigned_order(torch.sort(unsigned_order(x)).values)
    ffs = words(n, 52)
    ffs[::5] = -1                                # real 0xFFFFFFFF keys
    for name, pat in (("all-equal", torch.full_like(x, 12345)), ("sorted", srt),
                      ("reversed", srt.flip(0).contiguous()), ("0xFFFFFFFF keys", ffs)):
        k4_check(f"2^20 {name}", (pat,))
    # onesweep's adversaries: one bin taking every key (every tile looks
    # back on one chain), one digit spread over all bins, the distributed
    # pass 1 shape, narrow top digits, and the tile edges
    k4_check("2^24 all-equal", (torch.full((1 << 24,), 0x5A5A5A5A, dtype=torch.int32,
                                           device=dev),))
    k4_check("2^22 one digit spread over 256 values",
             ((words(1 << 22, 53) & 0xFF) | 0x1234500,))
    k4_check("2^22 one pass, three payload planes (distributed pass 1)",
             (words(1 << 22, 54) & 0xFF, words(1 << 22, 55), words(1 << 22, 56),
              words(1 << 22, 57)), (255, 0, 0, 0))
    for top_bits in range(1, 8):
        top = (1 << top_bits) - 1
        k4_check(f"2^20 x4 top digit {top_bits} bits",
                 (words(n, 60 + top_bits) & top, words(n, 70), words(n, 71) & 0xFFF,
                  words(n, 72)), (top, 0xFFFFFFFF, 0xFFF, 0xFFFFFFFF))
    edges = list(range(1, 34)) + [radix.TILE - 1, radix.TILE, radix.TILE + 1]
    for m in edges:
        k4_check(f"n={m} x2 (tile edge)", (words(m, 80 + m), words(m, 81 + m)), quiet=True)
    log(f"[kernels] K4 tile edges n in 1..33, {radix.TILE - 1}, {radix.TILE}, "
        f"{radix.TILE + 1}: bytes equal to plain")
    # K5, K6 at P = 8 over one rank's 2^28 / 8 shard (n not a multiple of
    # 1024); K7 over eight [8, 2^22] send matrices
    def segments(n: int, mode: str, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
        cuts = np.sort(rng.integers(0, n + 1, RANKS - 1))
        starts = np.concatenate([[0], cuts]).astype(np.int32)
        cnts = (np.concatenate([cuts, [n]]) - starts).astype(np.int32)
        if mode == "empty":
            cnts[1::2] = 0
        if mode == "overflow":
            cnts[:] = (n - (cap + 4096)) // (RANKS - 1)
            cnts[3] = n - int(cnts.sum()) + int(cnts[3])
            starts = (np.cumsum(cnts) - cnts).astype(np.int32)
            assert cnts.max() > cap
        return (torch.from_numpy(starts).to(dev), torch.from_numpy(cnts).to(dev))

    def k567_check(label: str, got, want) -> int:
        sync()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{label}: kernel != plain (max_abs_err {err})")
        log(f"[kernels] {label}: bytes equal to plain")
        return err

    rng = np.random.default_rng(25)
    n = (1 << 25) - 777
    planes = tuple(words(n, 90 + i) for i in range(3))
    for mode, cap in (("ragged", 1 << 23), ("empty", 1 << 23), ("overflow", 1 << 22)):
        st, ct = segments(n, mode, cap)
        k567_check(f"K5 P=8 n=2^25-777 cap={cap} {mode}",
                   (pack.segment_pack(planes[0], st, ct, cap, RANKS, 0xFFFFFFFF),),
                   (pack.segment_pack_plain(planes[0], st, ct, cap, RANKS, 0xFFFFFFFF),))
        for w in (1, 2, 3):
            fills = (0xFFFFFFFF, 0, 7)[:w]
            k567_check(f"K6 P=8 n=2^25-777 cap={cap} {mode} x{w}",
                       exchange.fused_pass_pack(planes[:w], st, ct, cap, RANKS, fills),
                       exchange.fused_pass_pack_plain(planes[:w], st, ct, cap, RANKS,
                                                      fills))
    del planes
    sends = [words(RANKS * (1 << 22), 100 + r).view(RANKS, 1 << 22) for r in range(RANKS)]
    k567_check("K7 P=8 [8, 2^22] per rank", exchange.remote_a2a(sends),
               exchange.remote_a2a_plain(sends))
    del sends

    def merge_planes(n: int, k: int, seed: int) -> tuple:
        g = np.random.default_rng(seed)
        kw = [g.integers(0, 7, n).astype(np.uint32) for _ in range(k - 2)]
        kw[0][g.random(n) < 0.1] = 0xFFFFFFFF
        kw[-1][g.random(n) < 0.1] = 0x80000000
        rid = g.integers(0, 4, n).astype(np.uint32)
        pos = g.permutation(n).astype(np.uint32)
        return tuple(kw) + (rid, pos)

    def k8_check(label: str, planes: tuple) -> int:
        got = radix.merge_order_host(planes, dev)
        on_card = tuple(to_device_words(p, dev) for p in planes)
        plain = radix.merge_order_plain(on_card).cpu().numpy()
        want = np.lexsort(tuple(reversed(planes)))
        sync()
        err = int(np.abs(got.astype(np.int64) - plain).max())
        if err or not np.array_equal(got, want):
            raise AssertionError(f"K8 {label}: kernel != plain / np.lexsort "
                                 f"(max_abs_err {err})")
        return err

    for k in (3, 4):
        for n in (2, 3, 255, 256, 257, 1000, 1024, 1025, 4095, 4096):
            k8_check(f"n={n} x{k}", merge_planes(n, k, 500 + n + k))
        log(f"[kernels] K8 x{k} planes, n in 2..4096: bytes equal to plain and "
            "np.lexsort (dup-heavy words, 0xFFFFFFFF and 0x80000000, shuffled "
            "positions)")
    for k in (1, 2, 5, 6, 7, 8):
        for n in (257, 4096):
            g8 = np.random.default_rng(600 + n + k)
            k8_check(f"n={n} x{k}", tuple(g8.integers(0, 3, n).astype(np.uint32)
                                          for _ in range(k)))
    for n in (2, 1025, 4096):
        k8_check(f"n={n} all tied", tuple(np.full(n, 0xFFFFFFFF, np.uint32)
                                          for _ in range(3)))
    log("[kernels] K8 x1..8 planes at n = 257 and 4096 (ties across the column "
        "splits) and every key tied at n = 2, 1025, 4096: equal to plain and np.lexsort")
    try:
        radix.merge_order_host(merge_planes(4097, 3, 7), dev)
    except ValueError as e:
        log(f"[kernels] K8 n=4097 raises: {e}")
    else:
        raise AssertionError("K8 n=4097 did not raise")
    verify_phase(log, card)
    slot_place_phase(log, card)
    digit_sort_phase(log, card)
    for name, count in bitonic.LAUNCHES.items():
        if count <= before[name]:
            raise AssertionError(f"kernel {name} never launched in phase 2")

    assert_clean("2")

    # ----------------------------------------------------- 3. main paths
    K1, K2, K3, K4 = "bitonic_u32", "bitonic_pairs_u32", "fix_runs_pairs", "radix_pass"
    K4H = "radix_histogram"     # K4's one histogram launch a sort
    VS = "verify_scan"
    per_case = {}

    def verify_scans(x, shards: int) -> int:
        """The verifier's launches for one verified sort: one scan a shard
        for the result check, and one a shard for the input fingerprint
        when the input is on the card (a host input folds on the host)."""
        return shards * (1 + isinstance(x, torch.Tensor))

    def run_case(label: str, x, engine: str, oracle, kernels_run: tuple[str, ...],
                 k4_passes: int = 0, **counters) -> None:
        base = dict(bitonic.LAUNCHES)
        base_passes = radix.pass_launches()
        tr = Tracer()
        t = time.perf_counter()
        got = mt.sort(x, tracer=tr)
        secs = time.perf_counter() - t
        want = oracle()
        if got.dtype != want.dtype or not np.array_equal(
                got.view(np.uint8), want.view(np.uint8)):
            raise AssertionError(f"{label}: output differs from the oracle")
        if tr.counters.get("local_engine") != engine:
            raise AssertionError(f"{label}: local_engine="
                                 f"{tr.counters.get('local_engine')} != {engine}")
        for c, v in counters.items():
            if tr.counters.get(c, 0) != v:
                raise AssertionError(f"{label}: counter {c}={tr.counters.get(c)}")
        if tr.counters.get("verify_runs") != 1:
            raise AssertionError(f"{label}: result not verified")
        per_case[label] = {k2: bitonic.LAUNCHES[k2] - base[k2] for k2 in base}
        expect = {k2: int(k2 in kernels_run) for k2 in base}
        expect[K4] = k4_passes
        expect[K4H] = int(k4_passes > 0)        # one fused sort a call
        expect[VS] = verify_scans(x, 1)
        passes = radix.pass_launches() - base_passes
        if per_case[label] != expect or passes != k4_passes:
            raise AssertionError(f"{label}: launches {per_case[label]}, K4 passes "
                                 f"{passes} != {expect}")
        log(f"[main] {label}: equal to oracle, engine={engine}, "
            f"launches={per_case[label]}, K4 passes={passes}, {secs:.3f} s "
            "host wall incl. encode/verify/decode")

    def run_path(label: str, path_kernels: tuple[str, ...], drive) -> dict[str, int]:
        """Counts set to 0 just before the path and read just after; every
        kernel of the path must have launched."""
        bitonic.reset_launches()
        drive()
        counts = dict(bitonic.LAUNCHES)
        for name in path_kernels:
            if counts[name] == 0:
                raise AssertionError(f"kernel {name} was never launched on {label}")
        log(f"[main] launches over {label}: {counts}")
        return counts

    def local_engine(value: str):
        return env(SORT_LOCAL_ENGINE=value)

    def card_sort_oracle(host: np.ndarray):
        def f():
            t = torch.from_numpy(host).to(dev)
            return torch.sort(t).values.cpu().numpy()
        return f

    def float_oracle(xf: np.ndarray):
        def f():
            u = xf.view(np.uint32)  # IEEE totalOrder by bit pattern
            key = np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000))
            return xf[np.argsort(key, kind="stable")]
        return f

    def float_keys(n: int) -> np.ndarray:
        xf = rng.standard_normal(n).astype(np.float32)
        xf[:8] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45]
        return xf

    rng = np.random.default_rng(2026)

    def main_path() -> None:
        x28 = rng.integers(-(2**31), 2**31, 1 << 28, dtype=np.int64).astype(np.int32)
        run_case("sort(np int32 2^28)", x28, "bitonic", card_sort_oracle(x28), (K1,))
        del x28
        xd = words(1 << 28, 28)
        run_case("sort(cuda int32 2^28)", xd, "bitonic",
                 lambda: torch.sort(xd).values.cpu().numpy(), (K1,))
        del xd
        x64 = rng.integers(-(2**63), 2**63 - 1, 1 << 27, dtype=np.int64)
        run_case("sort(np int64 2^27)", x64, "bitonic_pair", card_sort_oracle(x64),
                 (K2, K3))
        del x64
        xw = rng.integers(5 << 32, 6 << 32, 1 << 26, dtype=np.int64)  # hi constant
        run_case("sort(np int64 2^26, one 32-bit window)", xw, "bitonic_1w1",
                 lambda: np.sort(xw), (K1,))
        hi = rng.integers(0, 8, 1 << 26).astype(np.int64)
        xh = (hi << 33) | rng.integers(0, 2**32, 1 << 26).astype(np.int64)
        run_case("sort(np int64 2^26, hi duplication)", xh, "lax",
                 lambda: np.sort(xh), (), pair_dup_reroute=1)
        del xw, xh, hi
        # runs of 24 equal hi words, distinct across runs and laid out in
        # runs, so the strided sniffs never sample one run twice: K2 + K3
        # leave residual runs (24 > 16 passes), the flag sends the sort to
        # the lax fallback (W5); the host route keeps the name
        # bitonic_pair, the device route reports the fused fallback
        hr = np.repeat(np.arange((1 << 26) // 24 + 1, dtype=np.int64) * 2654435761
                       % 2**31, 24)[:1 << 26]
        xr = (hr << 32) | rng.integers(0, 2**32, 1 << 26).astype(np.int64)
        run_case("sort(np int64 2^26, hi runs of 24)", xr, "bitonic_pair",
                 lambda: np.sort(xr), (K2, K3), pair_residual_fallback=1)
        run_case("sort(cuda int64 2^26, hi runs of 24)", torch.from_numpy(xr).to(dev),
                 "bitonic_pair+lax_fallback", lambda: np.sort(xr), (K2, K3),
                 pair_residual_fallback=1)
        del hr, xr
        xf = float_keys(1 << 24)
        run_case("sort(np float32 2^24, NaN/±0/±inf)", xf, "bitonic",
                 float_oracle(xf), (K1,))
        # pads to 2^26 (past the break-even: n*10 >= n_pow2*6), so K1 runs
        xo = rng.integers(-(2**31), 2**31, (1 << 26) - 12345, dtype=np.int64).astype(np.int32)
        run_case("sort(np int32 2^26-12345)", xo, "bitonic", lambda: np.sort(xo), (K1,))

    def radix_path() -> None:
        n = 1 << 20
        with local_engine("radix_pallas"):
            xa = rng.integers(0, 2**20, n).astype(np.int32)
            run_case("radix_pallas sort(np int32 2^20 in [0, 2^20))", xa,
                     "radix_pallas", lambda: np.sort(xa), (), k4_passes=3)
            xc = words(n, 60)
            run_case("radix_pallas sort(cuda int32 2^20)", xc, "radix_pallas",
                     lambda: torch.sort(xc).values.cpu().numpy(), (), k4_passes=4)
            xf = float_keys(n)
            run_case("radix_pallas sort(np float32 2^20, NaN/±0/±inf)", xf,
                     "radix_pallas", float_oracle(xf), (), k4_passes=4)
            xw = rng.integers(5 << 32, 6 << 32, n, dtype=np.int64)
            run_case("radix_pallas sort(np int64 2^20, one 32-bit window)", xw,
                     "bitonic_1w1", lambda: np.sort(xw), (), k4_passes=4)
            run_case("radix_pallas sort(cuda int64 2^20, one 32-bit window)",
                     torch.from_numpy(xw).to(dev), "bitonic_1w1",
                     lambda: np.sort(xw), (K1,), k4_passes=0)
            x5 = rng.integers(-(2**40), 2**40, 5000, dtype=np.int64)
            diffs = tuple((1 << d.bit_length()) - 1
                          for d in api._word_diffs(codec_for(np.int64).encode(x5)))
            run_case("radix_pallas sort(np int64 5000)", x5, "radix_pallas",
                     lambda: np.sort(x5), (),
                     k4_passes=len(radix.pass_plan(diffs, 2)))
            xl = rng.integers(-(2**31), 2**31, n + 1, dtype=np.int64).astype(np.int32)
            run_case("radix_pallas sort(np int32 2^20+1)", xl, "lax",
                     lambda: np.sort(xl), (), k4_passes=0)

    cli_times = {}

    def run_cli(label: str, path: str, engine: str, x: np.ndarray,
                local: str, ranks: int = 1, algo: str = "sample",
                extra_env: dict | None = None, counters: dict | None = None) -> None:
        out, err = io.StringIO(), io.StringIO()
        tr = Tracer()
        t = time.perf_counter()
        with env(SORT_LOCAL_ENGINE=engine, SORT_RANKS=str(ranks), SORT_ALGO=algo,
                 **(extra_env or {})), \
                contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["mpitest_tpu_torch.cli", path], tracer=tr)
        wall = time.perf_counter() - t
        if rc != 0:
            raise AssertionError(f"CLI {label}: exit {rc}: {err.getvalue()}")
        n = x.size
        k = n // 2 - 1
        probe = int(np.partition(x, k)[k])      # np.sort(x)[n//2-1]
        want = ([f"Each bucket will be put {-(-n // ranks)} items."]
                if algo == "sample" else []) + [f"The n/2-th sorted element: {probe}"]
        if out.getvalue().splitlines() != want:
            raise AssertionError(f"CLI {label}: stdout {out.getvalue()!r} != {want}")
        m = re.fullmatch(r"Endtime\(\)-Starttime\(\) = (\d+\.\d{5}) sec\n",
                         err.getvalue())
        if m is None:
            raise AssertionError(f"CLI {label}: stderr {err.getvalue()!r}")
        if tr.counters.get("local_engine") != local:
            raise AssertionError(f"CLI {label}: local_engine="
                                 f"{tr.counters.get('local_engine')} != {local}")
        for c, v in (counters or {}).items():
            if tr.counters.get(c) != v:
                raise AssertionError(f"CLI {label}: counter {c}={tr.counters.get(c)} != {v}")
        cli_times[label] = (float(m.group(1)), wall)
        log(f"[main] CLI {label} ({engine}, SORT_RANKS={ranks}, {algo}): exit 0, "
            "stdout equal to the reference "
            f"lines with probe np.sort(x)[n//2-1] = {probe}, "
            f"local_engine={tr.counters.get('local_engine')}, "
            f"encode_engine={tr.counters.get('encode_engine')}")

    def cli_path() -> None:
        with tempfile.TemporaryDirectory() as tmp:
            x = rng.integers(-(2**31), 2**31 - 1, 1 << 28, dtype=np.int32,
                             endpoint=True)
            f = os.path.join(tmp, "keys28.bin")
            kio.write_keys_binary(f, x)
            run_cli("2^28 int32 SORTBIN1", f, "auto", x, "bitonic")
            os.unlink(f)
            for log2n, engine, local in ((22, "auto", "bitonic"),
                                         (20, "radix_pallas", "radix_pallas")):
                x = rng.integers(-(2**31), 2**31 - 1, 1 << log2n, dtype=np.int32,
                                 endpoint=True)
                f = os.path.join(tmp, f"keys{log2n}.txt")
                kio.write_keys_text(f, x)
                run_cli(f"2^{log2n} int32 text", f, engine, x, local)

    mesh = make_mesh(RANKS)            # eight ranks, all on this card
    mesh_counters: dict[str, dict] = {}

    def card_float_oracle(xf: np.ndarray):
        def f():
            t = torch.from_numpy(xf).to(dev)
            u = t.view(torch.int32)            # IEEE totalOrder, signed form
            key = torch.where(u < 0, ~u ^ -(2**31), u)
            return t[torch.sort(key).indices].cpu().numpy()
        return f

    def run_mesh_case(label: str, x, algo: str, oracle, local: str, **checks) -> None:
        tr = Tracer()
        scans = bitonic.LAUNCHES[VS]
        t = time.perf_counter()
        res = mt.sort(x, algorithm=algo, mesh=mesh, tracer=tr, return_result=True)
        scans = bitonic.LAUNCHES[VS] - scans
        if scans != verify_scans(x, RANKS):
            raise AssertionError(f"{label}: {scans} verify scans != "
                                 f"{verify_scans(x, RANKS)}")
        got = res.to_numpy(tracer=tr)
        secs = time.perf_counter() - t
        # host input of STREAM_MIN_BYTES or more streams onto the ranks; a
        # contiguous result of EGRESS_MIN_BYTES or more streams back
        names = [sp.name for sp in tr.spans.spans]
        streamed = not isinstance(x, torch.Tensor) and x.nbytes >= ingest.STREAM_MIN_BYTES
        if streamed != ("ingest.pipeline" in names):
            raise AssertionError(f"{label}: ingest.pipeline span present="
                                 f"{'ingest.pipeline' in names}, expected {streamed}")
        egress = (res.counts is None
                  and res.n_valid * res.dtype.itemsize >= ingest.EGRESS_MIN_BYTES)
        if names.count("egress.fetch") != (RANKS if egress else 0):
            raise AssertionError(f"{label}: {names.count('egress.fetch')} egress.fetch "
                                 f"spans, expected {RANKS if egress else 0}")
        if streamed:
            pipe = next(sp for sp in tr.spans.spans if sp.name == "ingest.pipeline")
            log(f"[main] {label}: streamed ingest {pipe.attrs['chunks']} chunks, "
                f"wall {pipe.dt:.3f} s, parse {pipe.attrs['parse_s']} s, encode "
                f"{pipe.attrs['encode_s']} s, transfer {pipe.attrs['transfer_s']} s, "
                f"overlap_efficiency {pipe.attrs['overlap_efficiency']}, engine "
                f"{pipe.attrs['encode_engine']}")
        if egress:
            fetch = sum(sp.dt for sp in tr.spans.spans if sp.name == "egress.fetch")
            dec = sum(sp.dt for sp in tr.spans.spans if sp.name == "egress.decode")
            log(f"[main] {label}: streamed egress {RANKS} shards, fetch {fetch:.3f} s, "
                f"decode {dec:.3f} s (host clock)")
        want = oracle()
        if got.dtype != want.dtype or not np.array_equal(
                got.view(np.uint8), want.view(np.uint8)):
            raise AssertionError(f"{label}: output differs from the oracle")
        c = tr.counters
        if c.get("local_engine") != local:
            raise AssertionError(f"{label}: local_engine={c.get('local_engine')} != {local}")
        for name, v in checks.items():
            val = c.get(name, 0)
            if not (v(val) if callable(v) else val == v):
                raise AssertionError(f"{label}: counter {name}={val}")
        if c.get("verify_runs") != 1:
            raise AssertionError(f"{label}: result not verified")
        mesh_counters[label] = dict(c)
        keys = ("exchange_engine", "local_engine", "digit_bits", "exchange_passes",
                "negotiated_cap", "exchange_cap", "exchange_retries", "skew_restage",
                "sample_skew_fallback", "exchange_peer_ratio")
        log(f"[main] {label}: equal to torch.sort on the card, "
            f"{ {k: c[k] for k in keys if k in c} }, {secs:.3f} s host wall "
            "incl. encode/verify/decode")

    def int32_keys(n: int) -> np.ndarray:
        return rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)

    def mesh_radix_path() -> None:
        x = int32_keys(1 << 28)
        run_mesh_case("radix P=8 sort(np int32 2^28)", x, "radix",
                      card_sort_oracle(x), "lax", exchange_engine="pallas")
        del x
        xd = words(1 << 28, 128)
        run_mesh_case("radix P=8 sort(cuda int32 2^28)", xd, "radix",
                      lambda: torch.sort(xd).values.cpu().numpy(), "lax")
        del xd
        x = rng.integers(-(2**63), 2**63 - 1, 1 << 27, dtype=np.int64)
        run_mesh_case("radix P=8 sort(np int64 2^27)", x, "radix", card_sort_oracle(x),
                      "lax", exchange_passes=4)
        del x
        for label, xf in (("2^24", float_keys(1 << 24)), ("5 keys (N < P)", float_keys(8)[:5]),
                          ("2^24+1001 (non-divisible)", float_keys((1 << 24) + 1001))):
            run_mesh_case(f"radix P=8 sort(np float32 {label}, NaN/±0/±inf)", xf,
                          "radix", card_float_oracle(xf), "lax")
        xs = np.sort(rng.integers(0, 1 << 16, 1 << 24).astype(np.int32))
        run_mesh_case("radix P=8 sort(np int32 2^24 sorted-skew)", xs, "radix",
                      card_sort_oracle(xs), "lax", skew_restage=lambda v: v >= 1)

    def digit_launches(label: str, counts: int, scatters: int) -> None:
        """The digit sort's launches since the path began: one count a
        rank for the probe and a rank a digit sort, two scatters a 16-bit
        digit sort."""
        got = (bitonic.LAUNCHES["digit_count"], bitonic.LAUNCHES["digit_scatter"])
        if got != (counts, scatters):
            raise AssertionError(f"{label}: digit counts and scatters {got} != "
                                 f"{(counts, scatters)}")

    def mesh_lax_path() -> None:
        with env(SORT_EXCHANGE_ENGINE="lax"):
            x = int32_keys(1 << 26)
            run_mesh_case("radix P=8 lax engine sort(np int32 2^26)", x, "radix",
                          card_sort_oracle(x), "lax", exchange_engine="lax")
            # the probe, then two passes of 16-bit digits
            digit_launches("radix P=8 lax engine", RANKS + 2 * RANKS, 2 * 2 * RANKS)

    def mesh_k4_path() -> None:
        with local_engine("radix_pallas"):
            x = int32_keys(1 << 23)
            base = radix.pass_launches()
            run_mesh_case("radix P=8 radix_pallas sort(np int32 2^23)", x, "radix",
                          card_sort_oracle(x), "radix_pallas")
            hists = bitonic.LAUNCHES[K4H]
            if radix.pass_launches() - base != 2 * RANKS or hists != RANKS:
                raise AssertionError("K4 did not run pass 1 of every rank (one "
                                     "histogram and two 8-bit passes of the 16-bit "
                                     f"digit each): {hists} histograms")
            # the probe, then the merge pass alone (K4 ran pass 1)
            digit_launches("radix P=8 radix_pallas", RANKS + RANKS, 2 * RANKS)

    def mesh_sample_path() -> None:
        x = int32_keys(1 << 28)
        run_mesh_case("sample P=8 sort(np int32 2^28)", x, "sample",
                      card_sort_oracle(x), "bitonic", sample_skew_fallback=0)
        del x
        x = rng.integers(-(2**63), 2**63 - 1, 1 << 27, dtype=np.int64)
        run_mesh_case("sample P=8 sort(np int64 2^27)", x, "sample",
                      card_sort_oracle(x), "bitonic", sample_skew_fallback=0)
        del x
        x = rng.choice(np.asarray([3, 7, 7, 7, 42], np.int32), 1 << 24)
        run_mesh_case("sample P=8 sort(np int32 2^24 duplicate-skew)", x, "sample",
                      card_sort_oracle(x), "lax", sample_skew_fallback=1)

    def mesh_cli_path() -> None:
        with tempfile.TemporaryDirectory() as tmp:
            x = rng.integers(-(2**31), 2**31 - 1, 1 << 28, dtype=np.int32,
                             endpoint=True)
            f = os.path.join(tmp, "keys28.bin")
            kio.write_keys_binary(f, x)
            run_cli("2^28 int32 SORTBIN1 P=8 sample", f, "auto", x, "bitonic",
                    ranks=RANKS, algo="sample")
            run_cli("2^28 int32 SORTBIN1 P=8 radix", f, "auto", x, "lax",
                    ranks=RANKS, algo="radix")

    ext_walls: dict[str, float] = {}
    k8_rounds = {"n": 0}
    real_order_for = mergelib._order_for

    def counting_order_for(kws, rid, pos, device=None):
        if 1 < rid.size <= radix.MERGE_MAX_ELEMS:
            k8_rounds["n"] += 1
        return real_order_for(kws, rid, pos, device)

    def k8_leg(label: str, x: np.ndarray, budget: int, runs: int, passes: int) -> None:
        base = dict(bitonic.LAUNCHES)
        base_passes = radix.pass_launches()
        k8_rounds["n"] = 0
        mergelib._order_for = counting_order_for
        tr = Tracer()
        try:
            with env(SORT_LOCAL_ENGINE="radix_pallas", SORT_MERGE_FANIN="4"), \
                    tempfile.TemporaryDirectory() as sd:
                t = time.perf_counter()
                res = mt.external_sort(x, budget=budget, spill_dir=sd, tracer=tr)
                ext_walls[label] = time.perf_counter() - t
                if os.listdir(sd):
                    raise AssertionError(f"{label}: spill files left: {os.listdir(sd)[:4]}")
        finally:
            mergelib._order_for = real_order_for
        want = card_sort_oracle(x)()
        if res.keys.dtype != want.dtype or not np.array_equal(
                res.keys.view(np.uint8), want.view(np.uint8)):
            raise AssertionError(f"{label}: output differs from torch.sort on the card")
        if (res.runs, res.merge_passes) != (runs, passes):
            raise AssertionError(f"{label}: {res.runs} runs, {res.merge_passes} "
                                 f"passes != {runs}, {passes}")
        k4 = bitonic.LAUNCHES[K4] - base[K4]
        k4h = bitonic.LAUNCHES[K4H] - base[K4H]
        k8 = bitonic.LAUNCHES["merge_order"] - base["merge_order"]
        planned = radix.pass_launches() - base_passes
        # one fused sort a chunk, each run one chunk: one histogram a run,
        # one pass launch per planned pass
        if k4h != res.runs or k4 != planned or planned < res.runs:
            raise AssertionError(f"{label}: K4 {k4} pass launches for {planned} "
                                 f"planned passes, {k4h} histograms for "
                                 f"{res.runs} runs")
        if k8 != k8_rounds["n"] or k8 == 0:
            raise AssertionError(f"{label}: K8 launched {k8} times for "
                                 f"{k8_rounds['n']} merge rounds of 2..4096")
        log(f"[main] {label}: equal to torch.sort on the card, {res.runs} runs, "
            f"{res.merge_passes} merge passes, spill ratio {res.spill_ratio:.3f}, "
            f"K4 launches {k4} = planned passes (+ {k4h} histograms = runs), K8 "
            f"launches {k8} = rounds of 2..4096, "
            f"wall {ext_walls[label]:.3f} s")

    def external_k8_path() -> None:
        # int32 2^22 and int64 2^21 (cut from 2^24 / 2^23 and 2^22, whose
        # host-bound merges took 163 / 67 and 47 s): five passes at fan-in
        # 4 each, every round size of 2..4096 still reached
        x = int32_keys(1 << 22)
        k8_leg("external_sort(np int32 2^22, budget 98304, fan-in 4)", x, 98304,
               683, 5)
        x = rng.integers(-(2**63), 2**63 - 1, 1 << 21, dtype=np.int64)
        k8_leg("external_sort(np int64 2^21, budget 196608, fan-in 4)", x, 196608,
               342, 5)

    def cli_external_path() -> None:
        with tempfile.TemporaryDirectory() as tmp:
            for log2n, budget, ranks, algo, local, runs in (
                    (25, 1 << 24, 1, "sample", "bitonic", 32),
                    (24, 1 << 22, RANKS, "radix", "lax", 64)):
                x = rng.integers(-(2**31), 2**31 - 1, 1 << log2n, dtype=np.int32,
                                 endpoint=True)
                f = os.path.join(tmp, f"keys{log2n}.bin")
                kio.write_keys_binary(f, x)
                run_cli(f"external leg 2^{log2n} int32 SORTBIN1 budget {budget}", f,
                        "auto", x, local, ranks=ranks, algo=algo,
                        extra_env={"SORT_MEM_BUDGET": str(budget),
                                   "SORT_SPILL_DIR": os.path.join(tmp, "spill")},
                        counters={"external_runs": runs, "external_merge_passes": 2})
                os.unlink(f)

    # ------------------------------------------------ 3i. the new slice's paths
    mesh1 = make_mesh(1)
    slice_notes: list[str] = []

    def no_kernel(label: str, counts: dict[str, int]) -> None:
        """The record and segmented programs are torch.sort plus gathers
        (the reference's lax.sort): no hand-written kernel launches."""
        if any(counts.values()):
            raise AssertionError(f"{label} launched a hand-written kernel: {counts}")

    def card_stable_gather(x: np.ndarray, pay: np.ndarray):
        t = torch.from_numpy(x).to(dev)
        idx = torch.sort(t, stable=True).indices
        return (t[idx].cpu().numpy(),
                torch.from_numpy(pay).to(dev)[idx].cpu().numpy())

    def record_case(label: str, x: np.ndarray, pay) -> None:
        tr = Tracer()
        t = time.perf_counter()
        got_k, got_p = mt.sort(x, payload=pay, tracer=tr)
        secs = time.perf_counter() - t
        pm = np.ascontiguousarray(pay).view(np.uint8).reshape(x.size, -1)
        want_k, want_p = card_stable_gather(x, pm)
        if got_k.tobytes() != want_k.tobytes() or got_p.tobytes() != want_p.tobytes():
            raise AssertionError(f"{label}: keys or payload differ from the stable "
                                 "argsort-gather on the card")
        if tr.counters.get("verify_runs") != 1 or tr.counters.get("verify_failures"):
            raise AssertionError(f"{label}: record verification {tr.counters}")
        note = (f"{label}: equal to the stable argsort-gather, {secs:.3f} s host wall "
                f"= {x.size / secs / 1e6:.1f} Mkeys/s (encode, record fingerprint, "
                "copy, sort + gather, fetch, verify, decode)")
        slice_notes.append(note)
        log(f"[main] {note}")

    def records_path() -> None:
        x = int32_keys(1 << 25)
        record_case("sort(np int32 2^25, payload=uint64 row ids)", x,
                    np.arange(x.size, dtype=np.uint64))
        x = rng.integers(-(2**63), 2**63 - 1, 1 << 24, dtype=np.int64)
        record_case("sort(np int64 2^24, payload=10-byte records)", x,
                    rng.integers(0, 256, (x.size, 10), dtype=np.uint8))
        # 2^10 distinct keys plus keys whose word is all ones, which tie with
        # the 5 pad lanes of the 2^24 bucket (a real record wins by index)
        x = rng.integers(0, 1 << 10, (1 << 24) - 5).astype(np.int32)
        x[rng.integers(0, x.size, 1 << 16)] = np.iinfo(np.int32).max
        record_case("sort(np int32 2^24-5 with 2^10 distinct keys and all-ones keys, "
                    "payload=uint64 row ids)", x, np.arange(x.size, dtype=np.uint64))
        del x

    def packed_path() -> None:
        for dtype in (np.int32, np.int64, np.float32):
            cuts = np.sort(rng.choice(np.arange(1, 1 << 16), 63, replace=False))
            sizes = np.diff(np.concatenate([[0], cuts, [1 << 16]]))
            arrays = []
            for sz in sizes:
                if dtype == np.float32:
                    arrays.append(float_keys(int(sz)) if sz >= 8 else
                                  rng.standard_normal(int(sz)).astype(dtype))
                else:
                    info = np.iinfo(dtype)
                    arrays.append(rng.integers(info.min, info.max, int(sz), dtype=dtype))
            base = dict(bitonic.LAUNCHES)
            t = time.perf_counter()
            batch = segmented.pack_segments(arrays, np.dtype(dtype))
            out = segmented.run_packed(batch)
            secs = time.perf_counter() - t
            no_kernel(f"the packed sort ({np.dtype(dtype).name})",
                      {k: bitonic.LAUNCHES[k] - base[k] for k in base})
            if batch.bucket != 1 << 16 or batch.n_segments != 64:
                raise AssertionError(f"packed batch {dtype}: bucket {batch.bucket}, "
                                     f"{batch.n_segments} segments")
            for got, req in zip(segmented.split_segments(batch, out), arrays):
                if got.tobytes() != mt.sort(req).tobytes():
                    raise AssertionError(f"packed batch {dtype}: a segment differs "
                                         "from its own sort()")
            if not all(segmented.verify_segments(batch, out)):
                raise AssertionError(f"packed batch {dtype}: verification failed")
            bad = [w.copy() for w in out]
            bad[-1][batch.offsets[17] + 3] ^= np.uint32(1 << 20)
            verdicts = segmented.verify_segments(batch, tuple(bad))
            if verdicts != [i != 17 for i in range(64)]:
                raise AssertionError(f"packed batch {dtype}: the planted bad segment "
                                     f"gave {verdicts}")
            note = (f"packed batch {np.dtype(dtype).name}: 64 requests, 2^16 keys, "
                    f"pack + sort + fetch {secs * 1e3:.3f} ms host wall; every segment "
                    "equals its own sort(), the planted bad segment alone flagged")
            slice_notes.append(note)
            log(f"[main] {note}")

    def staged_case(label: str, x: np.ndarray) -> None:
        tr = Tracer()
        t = time.perf_counter()
        st = api.ingest_to_mesh(x, mesh=mesh1, tracer=tr)
        torch.cuda.synchronize()
        ing = time.perf_counter() - t
        s_ = st.stats
        got = mt.sort(st, tracer=tr)
        secs = time.perf_counter() - t
        if got.tobytes() != card_sort_oracle(x)().tobytes():
            raise AssertionError(f"{label}: output differs from torch.sort on the card")
        names = {sp.name for sp in tr.spans.spans}
        if not {"ingest.parse", "ingest.encode", "ingest.transfer",
                "ingest.pipeline"} <= names or tr.counters.get("verify_runs") != 1:
            raise AssertionError(f"{label}: spans {sorted(names)}, {tr.counters}")
        note = (f"{label}: ingest {ing:.3f} s ({s_.chunks} chunks of 2^22, engine "
                f"{s_.encode_engine}: parse {s_.parse_s:.3f} s, encode {s_.encode_s:.3f} "
                f"s, transfer {s_.transfer_s:.3f} s, pipeline wall {s_.wall_s:.3f} s, "
                f"overlap_efficiency {s_.overlap_efficiency():.4f}); ingest + sort + "
                f"verify + decode {secs:.3f} s host wall")
        slice_notes.append(note)
        log(f"[main] {note}")

    donation: dict[str, tuple[int, int]] = {}

    def staged_path() -> None:
        x = int32_keys(1 << 28)
        staged_case("ingest_to_mesh(np int32 2^28, make_mesh(1)) + sort(staged)", x)
        # SORT_DONATE: the staged one-rank sort's card memory high-water
        for donate in ("0", "1"):
            with env(SORT_DONATE=donate):
                st = api.ingest_to_mesh(x, mesh=mesh1)
                sync()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                res = mt.sort(st, return_result=True)
                sync()
                peak = torch.cuda.max_memory_allocated()
                if st.consumed != (donate == "1"):
                    raise AssertionError(f"SORT_DONATE={donate}: consumed={st.consumed}")
                donation[donate] = (before, peak)
                del res, st
        for donate, (before, peak) in donation.items():
            note = (f"staged one-rank int32 2^28 sort, SORT_DONATE={donate}: "
                    f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB), "
                    f"{peak - before} B above the staged words' {before} B")
            slice_notes.append(note)
            log(f"[main] {note}")
        del x
        x = rng.integers(-(2**63), 2**63 - 1, 1 << 27, dtype=np.int64)
        staged_case("ingest_to_mesh(np int64 2^27, make_mesh(1)) + sort(staged)", x)
        del x

    def ext_record_path() -> None:
        n, width, budget = 1 << 22, 8, 1 << 22
        x = int32_keys(n)
        pay = rng.integers(0, 256, (n, width), dtype=np.uint8)
        from mpitest_tpu_torch.store import external as ext
        chunk = ext.spill_chunk_elems(budget, x.dtype, width)
        runs = -(-n // chunk)
        fanin, level, passes = ext._fanin(), runs, 1
        while level > fanin:
            level, passes = -(-level // fanin), passes + 1
        tr = Tracer()
        with tempfile.TemporaryDirectory() as sd:
            t = time.perf_counter()
            res = mt.external_sort(x, pay, budget=budget, spill_dir=sd, tracer=tr)
            wall = time.perf_counter() - t
        want_k, want_p = mt.sort(x, payload=pay)
        if res.keys.tobytes() != want_k.tobytes() or res.payload.tobytes() != \
                want_p.tobytes():
            raise AssertionError("external record leg: keys or payload differ from "
                                 "the in-memory record sort")
        if (res.runs, res.merge_passes) != (runs, passes):
            raise AssertionError(f"external record leg: {res.runs} runs, "
                                 f"{res.merge_passes} passes != {runs}, {passes}")
        ext_walls["external_sort(np int32 2^22, payload=8 bytes, budget 4 MiB)"] = wall
        note = (f"external_sort(np int32 2^22, payload=8 bytes, budget 4 MiB): equal "
                f"to the in-memory record sort, {res.runs} runs of {chunk}, "
                f"{res.merge_passes} merge passes (as computed from the budget), "
                f"wall {wall:.3f} s")
        slice_notes.append(note)
        log(f"[main] {note}")

    main_launches = run_path("the main path (sort(), auto)", (K1, K2, K3), main_path)
    radix_launches = run_path("sort() under radix_pallas", (K4, K4H), radix_path)
    run_path("the key-file CLI", (K1, K4, K4H), cli_path)
    K5, K6, K7 = "segment_pack", "fused_pass_pack", "remote_a2a"
    SP = "slot_place"
    DC, DS = "digit_count", "digit_scatter"
    mesh_launches = run_path("radix on eight ranks (pallas engine)", (K6, K7, SP, DC, DS),
                             mesh_radix_path)
    lax_launches = run_path("radix on eight ranks (lax engine)", (K5, SP, DC, DS),
                            mesh_lax_path)
    run_path("radix on eight ranks under radix_pallas", (K4, K4H, K6, K7, SP, DC, DS),
             mesh_k4_path)
    run_path("sample sort on eight ranks", (K1, K2, K3, K6, K7), mesh_sample_path)
    run_path("the key-file CLI, SORT_RANKS=8", (K1, K6, K7), mesh_cli_path)
    K8 = "merge_order"
    k8_launches = run_path("external_sort() under radix_pallas", (K4, K4H, K8),
                           external_k8_path)
    run_path("the CLI's external leg", (K1, K6, K7), cli_external_path)
    assert_clean("3")
    t_slice = time.perf_counter()
    no_kernel("the record sorts", run_path("the record sorts", (), records_path))
    run_path("the packed batch", (), packed_path)
    staged_launches = run_path("the staged one-rank routes", (K1, K2, K3), staged_path)
    if (staged_launches[K1], staged_launches[K2], staged_launches[K3]) != (3, 1, 1):
        raise AssertionError(f"staged one-rank routes: K1/K2/K3 launches "
                             f"{staged_launches} != 3 (one per int32 sort), 1, 1")
    no_kernel("the external record leg",
              run_path("the external record leg", (), ext_record_path))
    slice_wall = time.perf_counter() - t_slice
    assert_clean("3i")
    log(f"[main] phase 3i (records, packed batch, staged routes, external record "
        f"leg) wall {slice_wall:.3f} s")
    path_launches = {K1: main_launches[K1], K2: main_launches[K2],
                     K3: main_launches[K3], K4: radix_launches[K4],
                     K5: lax_launches[K5], K6: mesh_launches[K6],
                     K7: mesh_launches[K7], K8: k8_launches[K8]}

    # -------------------------------------------- 3j. telemetry on the card
    from mpitest_tpu_torch import report
    from mpitest_tpu_torch.utils import flight_recorder, span_schema
    from mpitest_tpu_torch.utils.trace import torch_profile

    t_tele = time.perf_counter()
    tele_notes: list[str] = []

    def tele(note: str) -> None:
        tele_notes.append(note)
        log(f"[telemetry] {note} | card {card}")

    def check_trace(path: str) -> list[dict]:
        """The port report's ``check_rows`` over the file (span rows with
        name/id/t0/dt/attrs, attrs an object, dt >= 0, parents that
        resolve; a metrics line, the flight dump's header, is allowed), and
        every span name registered in the port's span_schema.  Returns the
        span rows."""
        rows = report.load_rows(path)
        errors = report.check_rows(rows)
        spans_ = [r for r in rows if r["kind"] == "span"]
        errors += [f"{path}: unregistered span {r['name']!r}" for r in spans_
                   if not span_schema.is_registered(r["name"])]
        if errors or not spans_:
            raise AssertionError(f"{path}: {errors[:5] or 'no span rows'}")
        return spans_

    def profile_stats(logdir: str) -> tuple[float, float, set[str], dict[str, int]]:
        """From the ``*.pt.trace.json`` torch_profile wrote: the card's
        busy ms (the union of kernel, memcpy and memset intervals), the
        window ms (first to last event of the trace), the kernel names and
        the count of each CUDA runtime call whose name holds
        ``Synchronize``."""
        arts = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
        if len(arts) != 1:
            raise AssertionError(f"{logdir}: profile artifacts {arts}")
        with open(os.path.join(logdir, arts[0])) as f:
            evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        dev_iv = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                        for e in evs
                        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
        if not dev_iv:
            raise AssertionError(f"{logdir}: the profile holds no device event")
        busy, cur_a, cur_b = 0.0, None, None
        for a, b in dev_iv:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        t0 = min(float(e["ts"]) for e in evs)
        t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in evs)
        kernels_seen = {e["name"] for e in evs if e.get("cat") == "kernel"}
        syncs: dict[str, int] = {}
        for e in evs:
            if e.get("cat") == "cuda_runtime" and "Synchronize" in e["name"]:
                syncs[e["name"]] = syncs.get(e["name"], 0) + 1
        return busy / 1e3, (t1 - t0) / 1e3, kernels_seen, syncs

    def wall(fn) -> float:
        sync()
        t = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t

    @dataclasses.dataclass
    class EventTracer(Tracer):
        """A tracer that also records CUDA events where phase "sort" opens
        and closes, on the current stream (all ranks' work is on it)."""

        sort_events: list = dataclasses.field(default_factory=list)

        @contextlib.contextmanager
        def phase(self, name: str):
            with Tracer.phase(self, name):
                if name != "sort":
                    yield
                    return
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                try:
                    yield
                finally:
                    b.record()
                    self.sort_events.append((a, b))

    def telemetry_path(tdir: str) -> None:
        x28 = words(1 << 28, 3001)
        cases = (("sort(cuda int32 2^28), one rank", "p1", {}),
                 (f"sort(cuda int32 2^28), {RANKS} ranks, radix", "p8r",
                  {"mesh": mesh, "algorithm": "radix"}),
                 (f"sort(cuda int32 2^28), {RANKS} ranks, sample", "p8s",
                  {"mesh": mesh, "algorithm": "sample"}))
        for label, slug, kw in cases:
            def call(tr=None, kw=kw):
                return mt.sort(x28, return_result=True, tracer=tr, **kw)

            wall(call)                                   # warm
            off = [wall(call) for _ in range(REPS)]
            on, lines = [], []
            last_tr = None
            for i in range(REPS):
                path = os.path.join(tdir, f"{slug}-{i}.jsonl")
                chrome = os.path.join(tdir, f"{slug}-{i}.chrome.json")

                def traced(path=path, chrome=chrome) -> None:
                    nonlocal last_tr
                    with env(SORT_TRACE=path, SORT_TRACE_CHROME=chrome):
                        last_tr = Tracer()
                        call(last_tr)
                        with open(knobs.get("SORT_TRACE_CHROME"), "w") as f:
                            json.dump(last_tr.spans.to_chrome_trace(), f)

                on.append(wall(traced))
                with open(path) as f:
                    lines.append(len(f.read().splitlines()))
            rows = check_trace(path)
            with open(chrome) as f:
                if not json.load(f)["traceEvents"]:
                    raise AssertionError(f"{label}: empty Chrome trace")
            sort_rows = [r for r in rows if r["name"] == "sort"]
            if len(sort_rows) != 1 or \
                    sort_rows[0]["attrs"].get("device_mem_peak_bytes", 0) <= 0:
                raise AssertionError(f"{label}: sort span {sort_rows}")
            if slug == "p8r":
                names = [r["name"] for r in rows]
                passes = int(last_tr.counters["exchange_passes"])
                a2a = [r for r in rows if r["name"] == "ragged_all_to_all"]
                if (names.count("radix_pass") != passes or len(a2a) != passes
                        or not all(r["attrs"]["wire_bytes"] > 0 for r in a2a)
                        or "exchange_balance" not in names):
                    raise AssertionError(f"{label}: {names.count('radix_pass')} "
                                         f"radix_pass, {len(a2a)} exchanges for "
                                         f"{passes} passes, names {sorted(set(names))}")
            # SORT_TRACE_SAMPLE=0.1: one tracer over ten calls streams
            # exactly one root's subtree
            spath = os.path.join(tdir, f"{slug}-sampled.jsonl")
            with env(SORT_TRACE=spath, SORT_TRACE_SAMPLE="0.1"):
                st = Tracer()
                sampled = [wall(lambda: call(st)) for _ in range(2 * REPS)]
            with open(spath) as f:
                s_lines = len(f.read().splitlines())
            check_trace(spath)
            if s_lines != lines[-1]:
                raise AssertionError(f"{label}: the sampled stream held {s_lines} "
                                     f"lines over ten calls, one call streams "
                                     f"{lines[-1]}")
            m_off, m_on, m_s = (statistics.median(v) for v in (off, on, sampled))
            tele(f"tracing overhead, {label} (verify on, result on card; host wall "
                 f"to a synchronize, median of {REPS}): off {m_off * 1e3:.3f} ms, "
                 f"SORT_TRACE + SORT_TRACE_CHROME {m_on * 1e3:.3f} ms (ratio "
                 f"{m_on / m_off:.4f}, {statistics.median(lines)} streamed lines a "
                 f"call, Chrome export included), SORT_TRACE_SAMPLE=0.1 "
                 f"{m_s * 1e3:.3f} ms (median of {2 * REPS}; ratio {m_s / m_off:.4f}, "
                 f"{s_lines / (2 * REPS):.1f} lines a call)")

        # host phase "sort" against CUDA events around the same region
        for label, kw in (("one rank", {}),
                          (f"{RANKS} ranks, radix", {"mesh": mesh,
                                                     "algorithm": "radix"})):
            host_ms, ev_ms = [], []
            for _ in range(REPS):
                tr = EventTracer()
                mt.sort(x28, return_result=True, tracer=tr, **kw)
                sync()
                host_ms.append(tr.phases["sort"] * 1e3)
                ev_ms.append(sum(a.elapsed_time(b) for a, b in tr.sort_events))
            tele(f"phase sort of sort(cuda int32 2^28), {label}: host "
                 f"{statistics.median(host_ms):.3f} ms against CUDA events "
                 f"{statistics.median(ev_ms):.3f} ms around the same region "
                 f"(median of {REPS}; {len(tr.sort_events)} sort phase(s) a call)")
        del x28

        # tracing adds no synchronisation: the CUDA runtime's synchronize
        # calls in a profile of one warm call, untraced and traced
        x24 = words(1 << 24, 3002)
        mt.sort(x24, mesh=mesh, return_result=True)
        counted = {}
        for mode in ("untraced", "traced"):
            pdir = os.path.join(tdir, f"sync-{mode}")
            extra = ({"SORT_TRACE": os.path.join(tdir, "sync.jsonl")}
                     if mode == "traced" else {})
            with env(**extra), torch_profile(pdir, mesh.devices):
                mt.sort(x24, mesh=mesh, return_result=True, tracer=Tracer())
            counted[mode] = profile_stats(pdir)[3]
        if counted["traced"] != counted["untraced"]:
            raise AssertionError(f"tracing changed the synchronize calls: {counted}")
        tele(f"synchronize calls in one sort(cuda int32 2^24), {RANKS} ranks, "
             f"radix: untraced {counted['untraced']}, traced {counted['traced']} "
             "(equal: tracing adds none)")
        del x24

        # the CLI: 2^24 on eight ranks under SORT_PROFILE (with the trace,
        # Chrome and metrics sinks), then 2^28 on one rank traced and not
        x = int32_keys(1 << 24)
        f24 = os.path.join(tdir, "keys24.bin")
        kio.write_keys_binary(f24, x)
        pdir = os.path.join(tdir, "profile")
        sinks = {"SORT_METRICS": os.path.join(tdir, "m24.jsonl"),
                 "SORT_TRACE": os.path.join(tdir, "t24.jsonl"),
                 "SORT_TRACE_CHROME": os.path.join(tdir, "c24.json")}
        run_cli("2^24 int32 SORTBIN1, SORT_PROFILE + sinks", f24, "auto", x, "lax",
                ranks=RANKS, algo="radix", extra_env={"SORT_PROFILE": pdir, **sinks})
        busy, window, names, _ = profile_stats(pdir)
        for entry_name, kernel in (("fused_pass_pack", "pack_rows"),
                                   ("remote_a2a", "a2a_push")):
            if not any(kernel in nm for nm in names):
                raise AssertionError(f"SORT_PROFILE: no {kernel} kernel event "
                                     f"({entry_name}) in {sorted(names)}")
        check_trace(sinks["SORT_TRACE"])
        with open(sinks["SORT_METRICS"]) as f:
            if "sort_mkeys_per_s" not in json.loads(f.read())["metrics"]:
                raise AssertionError("CLI 2^24: no sort_mkeys_per_s in the sidecar")
        tele(f"SORT_PROFILE of the CLI, {RANKS} ranks radix, 2^24 int32 SORTBIN1 "
             f"(sort + host decode): card busy {busy:.3f} of {window:.3f} ms, "
             f"busy share {busy / window:.4f}; kernels include pack_rows "
             f"(fused_pass_pack) and a2a_push (remote_a2a)")
        os.unlink(f24)
        del x

        x = int32_keys(1 << 28)
        f28 = os.path.join(tdir, "keys28.bin")
        kio.write_keys_binary(f28, x)
        run_cli("2^28 int32 SORTBIN1, untraced", f28, "auto", x, "bitonic")
        sinks = {"SORT_METRICS": os.path.join(tdir, "m28.jsonl"),
                 "SORT_TRACE": os.path.join(tdir, "t28.jsonl"),
                 "SORT_TRACE_CHROME": os.path.join(tdir, "c28.json")}
        run_cli("2^28 int32 SORTBIN1, traced", f28, "auto", x, "bitonic",
                extra_env=sinks)
        with open(sinks["SORT_METRICS"]) as f:
            side = json.loads(f.read().splitlines()[-1])
        if set(side["config"]) != {"algo", "n", "dtype", "ranks", "digit_bits"}:
            raise AssertionError(f"metrics sidecar config {side['config']}")
        check_trace(sinks["SORT_TRACE"])
        ends_off = cli_times["2^28 int32 SORTBIN1, untraced"][0]
        ends_on = cli_times["2^28 int32 SORTBIN1, traced"][0]
        tele(f"CLI 2^28 int32 SORTBIN1, one rank: untraced Endtime()-Starttime() "
             f"= {ends_off:.5f} s ({(1 << 28) / ends_off / 1e6:.1f} Mkeys/s), with "
             f"SORT_METRICS + SORT_TRACE + SORT_TRACE_CHROME {ends_on:.5f} s, "
             f"sidecar sort_mkeys_per_s {side['metrics']['sort_mkeys_per_s']['value']}")
        os.unlink(f28)
        del x

        # the card's busy share of the external record leg and the record
        # sort (a host-bound merge and a host-side record path)
        n, width, budget = 1 << 22, 8, 1 << 22
        x = int32_keys(n)
        pay = rng.integers(0, 256, (n, width), dtype=np.uint8)
        pdir = os.path.join(tdir, "prof-ext")
        t = time.perf_counter()
        with torch_profile(pdir, [dev]):
            mt.external_sort(x, pay, budget=budget,
                             spill_dir=os.path.join(tdir, "spill"))
        ext_wall = time.perf_counter() - t
        busy, window, _, _ = profile_stats(pdir)
        tele(f"external_sort(np int32 2^22, payload=8 bytes, budget 4 MiB) under "
             f"SORT_PROFILE: card busy {busy:.3f} of {window:.3f} ms, busy share "
             f"{busy / window:.6f} (wall {ext_wall:.3f} s under the profiler)")
        x = int32_keys(1 << 25)
        pdir = os.path.join(tdir, "prof-rec")
        t = time.perf_counter()
        with torch_profile(pdir, [dev]):
            mt.sort(x, payload=np.arange(x.size, dtype=np.uint64))
        rec_wall = time.perf_counter() - t
        busy, window, _, _ = profile_stats(pdir)
        tele(f"sort(np int32 2^25, payload=uint64 row ids) under SORT_PROFILE: "
             f"card busy {busy:.3f} of {window:.3f} ms, busy share "
             f"{busy / window:.4f} (wall {rec_wall:.3f} s under the profiler)")
        del x, pay

        fpath = flight_recorder.get().dump("smoke")
        if fpath is None:
            raise AssertionError("the flight recorder dumped nothing")
        frows = check_trace(fpath)
        tele(f"flight recorder dump: {len(frows)} spans (ring "
             f"{flight_recorder.get().capacity}), passes the schema check")

    with tempfile.TemporaryDirectory() as tdir:
        with env(SORT_FLIGHT_RECORDER_DIR=os.path.join(tdir, "flight")):
            flight_recorder.reset()
            try:
                run_path("telemetry on the card", (K1, K6, K7),
                         lambda: telemetry_path(tdir))
            finally:
                flight_recorder.reset()
    tele_wall = time.perf_counter() - t_tele
    log(f"[main] phase 3j (telemetry) wall {tele_wall:.3f} s")
    assert_clean("3j")

    # ------------------------------------------- 3k. the fault grid on the card
    t_fault = time.perf_counter()
    fault_cells: dict[str, dict] = {}
    fault_notes: list[str] = []

    def fault_path() -> None:
        got_cells, notes = fault_phase(dev, mesh, rng, FAULT_SIZES, log)
        fault_cells.update(got_cells)
        fault_notes.extend(notes)

    run_path("the fault grid (phase 3k)", (K1, K2, K3, K4, K4H, K5, K6, K7, K8),
             fault_path)
    k8_cell = next(k for k in fault_cells if "radix_pallas" in k and "external" in k)
    if fault_cells[k8_cell].get(K8, 0) == 0:
        raise AssertionError(f"3k: K8 never launched in the store recovery ({k8_cell})")
    for name in (K1, K2, K3, K4, K5, K6, K7, K8):
        log(f"[faults] {name} launches by cell: "
            f"{ {k: v[name] for k, v in fault_cells.items() if v.get(name)} }")
    tracers.clear()    # the fault cells set the ladder counters on purpose
    fault_wall = time.perf_counter() - t_fault
    log(f"[main] phase 3k (faults) wall {fault_wall:.3f} s")

    # ------------------------------ 3l. the planner mix and the doctor on the card
    t_plan = time.perf_counter()
    planner_notes: list[str] = []
    planner_launches = run_path(
        "the planner mix and the doctor (phase 3l)", (K1, K4, K4H, K6, K7),
        lambda: planner_notes.extend(planner_phase(dev, mesh, 2026, PLANNER_SIZES, log)))
    assert_clean("3l")
    planner_wall = time.perf_counter() - t_plan
    log(f"[main] phase 3l (planner, doctor) wall {planner_wall:.3f} s, launches "
        f"{planner_launches}")

    # ------------------------------------------------ 3m. the server on the card
    serve_out: dict = {}

    def serve_path() -> None:
        legs, dirty, timings = serve_phase(
            make_mesh, SERVE_SIZES, log, card=True,
            driver_cmd=[sys.executable, "-m", "mpitest_tpu_torch.sort_server"])
        serve_out.update(legs=legs, dirty=dirty, timings=timings)

    serve_launches = run_path("the server on the card (phase 3m)",
                              (K1, K2, K3, K6, K7), serve_path)
    # the fault legs' cores set the ladder counters on purpose
    tracers[:] = [t for t in tracers if not any(t is d for d in serve_out["dirty"])]
    assert_clean("3m")
    serve_timings = serve_out["timings"]
    log(f"[serve] timings {json.dumps(serve_timings, sort_keys=True)} | card {card}")
    log(f"[main] phase 3m (the server) wall {serve_timings['phase_wall_s']:.3f} s, "
        f"launches {serve_launches}")

    # ----------------------------------- 3n. the spawned-server drills on the card
    torch.cuda.empty_cache()   # the server processes allocate on the same card
    spawned = spawned_phase(SPAWNED_SIZES, log, card=True, mesh_for=make_mesh)
    assert_clean("3n")
    log(f"[spawned] timings {json.dumps(spawned, sort_keys=True, default=str)} "
        f"| card {card}")
    log(f"[main] phase 3n (the spawned-server drills) wall "
        f"{spawned['phase_wall_s']:.3f} s")

    # ------------------------------ 3o. multihost_init over NCCL on the card
    t_mh = time.perf_counter()
    multihost = multihost_phase(MULTIHOST_N, log)
    multihost_wall = time.perf_counter() - t_mh
    log(f"[main] phase 3o (multihost_init) wall {multihost_wall:.3f} s")

    # -------------------- 3p. the radix sort across two processes on the card
    # the children assert K6 and K7 in their own counts; these are the
    # single-controller twins' in this process
    cross: dict = {}
    run_path("phase 3p's single-controller twins", (K6, K7),
             lambda: cross.update(crossprocess_phase(log)))
    log(f"[main] phase 3p (cross-process radix) wall {cross['phase_wall_s']:.3f} s")

    # ----------------- 3q. the sort server across two processes on the card
    # the served requests launch no kernel: the children's counts start at
    # 0 and their /varz is read after the last request
    torch.cuda.empty_cache()   # the server processes allocate on the same card
    serve_cross = serve_crossprocess_phase(SERVE_CROSS_SIZES, log)
    assert_clean("3q")
    log(f"[main] phase 3q (the server across processes) wall "
        f"{serve_cross['phase_wall_s']:.3f} s, launches in the servers "
        f"{[v['launches'] for v in serve_cross['varz']]}")

    # ---------------------------------------------------------- 4. timing
    entries = []

    def bound(nbytes: float, ops: float) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / OPS_PER_S_32BIT * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def entry(name: str, ms: float, plain_ms: float, err: int, nbytes: float,
              ops: float, library_ms: float | None, shape: str,
              library: str = "torch.sort") -> None:
        b_ms, b_by = bound(nbytes, ops)
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": path_launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms})
        log(f"[timing] {name} {shape}: {ms:.3f} ms kernel, {plain_ms:.1f} ms "
            f"plain, bound {b_ms:.3f} ms ({b_by}; HBM bytes alone "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms), {library} "
            f"{'-' if library_ms is None else f'{library_ms:.3f} ms'} "
            f"| card {card}")

    # K1, K2: bound_ms is the function's floor, each plane read once and
    # written once, against n log2 n compares; the design floor of the
    # schedule (its passes through HBM, ops/bitonic.py) is logged beside it.
    def design_floor(label: str, passes: int, pass_bytes: float, ms: float) -> None:
        floor = passes * pass_bytes / HBM_BYTES_PER_S * 1e3
        log(f"[timing] {label}: {passes} passes x {pass_bytes / 2**30:.0f} GiB, "
            f"design floor {floor:.3f} ms at 3.35 TB/s, measured {ms:.3f} ms = "
            f"{ms / passes:.3f} ms a pass | card {card}")

    n = 1 << 28
    t = 28
    x = words(n, 281)
    got = bitonic.sort_padded(x, n, bitonic.BLOCK_LOG2)
    want = bitonic.sort_padded_plain(x)
    err = max_abs_err(got, want)
    del got, want
    if err:
        raise AssertionError(f"K1 2^28: kernel != plain (max_abs_err {err})")
    k1_ms = timed(lambda: bitonic.sort_padded(x, n, bitonic.BLOCK_LOG2), REPS)
    k1_plain = timed(lambda: bitonic.sort_padded_plain(x), PLAIN_REPS)
    k1_lib = timed(lambda: torch.sort(x), REPS)
    entry("bitonic_u32", k1_ms, k1_plain, err, 2 * 4 * n, n * t, k1_lib,
          "2^28 int32")
    design_floor(f"K1 2^28: 1 tile sort + {bitonic.merge_rounds(n)} merge rounds",
                 1 + bitonic.merge_rounds(n), 2 * 4 * n, k1_ms)
    del x

    n = 1 << 27
    t = 27
    hi = words(n, 271)
    lo = words(n, 272)
    gk, gp = bitonic.sort_pairs_padded(hi, lo, n, bitonic.PAIR_BLOCK_LOG2)
    wk, wp = bitonic.sort_pairs_padded_plain(hi, lo)
    err = max(max_abs_err(gk, wk), max_abs_err(gp, wp))
    del wk, wp
    if err:
        raise AssertionError(f"K2 2^27: kernel != plain (max_abs_err {err})")
    k2_ms = timed(lambda: bitonic.sort_pairs_padded(hi, lo, n, bitonic.PAIR_BLOCK_LOG2),
                  REPS)
    k2_plain = timed(lambda: bitonic.sort_pairs_padded_plain(hi, lo), PLAIN_REPS)
    k2_lib = timed(lambda: torch.sort(hi), REPS)  # keys + permutation, one call
    entry("bitonic_pairs_u32", k2_ms, k2_plain, err, 4 * 4 * n, n * t,
          k2_lib, "2^27 pairs")
    tiles, staged, tails = bitonic.network_plan(n)
    design_floor(f"K2 2^27: {tiles} tile sort + {staged} staged + {tails} tail passes",
                 tiles + staged + tails, 4 * 4 * n, k2_ms)

    # K3 on the pair network's own output: hi sorted, lo permuted in runs.
    # The main path calls phase B (K3, the strip kernel and the flag in
    # one call): its time is the kernels line's; K3 alone is logged beside.
    PB = bitonic.PAIR_BLOCK_LOG2

    def planted(max_run: int, seed: int) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(seed)
        m = 2 * n // (max_run + 1) + (1 << 16)
        lens = torch.randint(1, max_run + 1, (m,), device=dev, generator=g)
        keys = torch.arange(m, dtype=torch.int32, device=dev) * 11 + 3
        return torch.repeat_interleave(keys, lens)[:n].contiguous()

    k3_inputs = {"network output": (gk, gp), "planted runs 1..16": (planted(16, 277), lo),
                 "planted runs 1..24": (planted(24, 278), lo)}
    for label, (kh, kl) in k3_inputs.items():
        g3 = bitonic.fix_runs_pairs(kh, kl, 16, PB)
        err3 = max_abs_err(g3, bitonic.fix_runs_pairs_plain(kh, kl, 16, PB))
        gl, gb = bitonic.fix_runs_flag(kh, kl, 16, PB)
        wl, wb = bitonic.fix_runs_flag_plain(kh, kl, 16, PB)
        err = max_abs_err(gl, wl)
        del g3, gl, wl
        if err3 or err or bool(gb) != bool(wb):
            raise AssertionError(f"K3 2^27 {label}: kernel != plain (max_abs_err "
                                 f"{err3}, phase B {err}, flags {bool(gb)}/{bool(wb)})")
        k3_ms = timed(lambda: bitonic.fix_runs_pairs(kh, kl, 16, PB), REPS)
        pb_ms = timed(lambda: bitonic.fix_runs_flag(kh, kl, 16, PB), REPS)
        log(f"[timing] K3 2^27 {label}: K3 alone {k3_ms:.4f} ms, phase B (K3 + "
            f"strips + flag) {pb_ms:.4f} ms, residual {bool(gb)}, bound "
            f"{3 * 4 * n / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes) | card {card}")
        if label == "network output":
            pb_plain = timed(lambda: bitonic.fix_runs_flag_plain(kh, kl, 16, PB),
                             PLAIN_REPS)
            entry("fix_runs_pairs", pb_ms, pb_plain, err, 3 * 4 * n,
                  16 * (n // 2) * 4, None,
                  f"2^27 pairs, 16 passes, phase B (K3 alone {k3_ms:.4f} ms)")
    del gk, gp, k3_inputs

    key64 = (hi.to(torch.int64) << 32) | u64(lo)
    pair_ms = timed(lambda: kernels.sort_two_words_bitonic(hi, lo), REPS)
    sort64_ms = timed(lambda: torch.sort(key64), REPS)
    log(f"[timing] pair engine K2+K3+strips 2^27: {pair_ms:.3f} ms; "
        f"torch.sort int64 2^27: {sort64_ms:.3f} ms | card {card}")
    del hi, lo, key64

    # K4: the whole fused_radix_sort call (one histogram launch, one
    # onesweep launch a pass).  bound_ms is the function's floor (each
    # plane read once and written once, 2*W*4*n bytes); the design floor
    # of the onesweep sort (every plane read and written once a pass, the
    # touched planes read once more for the histogram) is logged beside it.
    def k4_time(label: str, ws, lib_key, json_entry: bool) -> None:
        n_planes, nk = len(ws), ws[0].numel()
        plan = radix.pass_plan(None, n_planes)
        passes = len(plan)
        touched = len({widx for widx, _, _ in plan})
        err = k4_check(f"{label} full plan", ws)
        ms = timed(lambda: radix.fused_radix_sort(ws), REPS)
        plain = timed(lambda: k4_plain(ws), PLAIN_REPS)
        lib = timed(lambda: torch.sort(lib_key), REPS)
        design = (passes * 2 * n_planes + touched) * 4 * nk / HBM_BYTES_PER_S * 1e3
        log(f"[timing] K4 {label}: {ms:.4f} ms a call (1 histogram + {passes} "
            f"onesweep launches), {ms / passes:.4f} ms a pass, plain "
            f"{plain:.1f} ms, torch.sort of the same words {lib:.4f} ms, "
            f"design floor {design:.3f} ms (({passes} x 2 x {n_planes} + {touched}) "
            f"planes x 4 B x n / 3.35 TB/s) | card {card}")
        if json_entry:
            entry("radix_pass", ms, plain, err, 2 * n_planes * 4 * nk,
                  K4_OPS_PER_ELEM_PASS * nk * passes, lib, label)

    x = words(1 << 28, 283)
    k4_time("2^28 one word", (x,), x, True)
    del x
    hi, lo = words(1 << 27, 275), words(1 << 27, 276)
    k4_time("2^27 two words", (hi, lo), (hi.to(torch.int64) << 32) | u64(lo), False)
    del hi, lo
    x = words(1 << 20, 284)
    k4_time("2^20 one word", (x,), x, False)
    x = words(6144, 285)
    k4_time("6144 one word (an external chunk sort)", (x,), x, False)
    del x
    # K5/K6/K7 at the mesh paths' shapes: one rank's pack (n keys into
    # [P, cap] with the run's negotiated cap, segments split evenly), and
    # one all-to-all over the eight ranks' send matrices.
    def even_segments(n: int) -> tuple[torch.Tensor, torch.Tensor]:
        cnt = torch.full((RANKS,), n // RANKS, dtype=torch.int32, device=dev)
        cnt[-1] += n - int(cnt.sum())
        return torch.cumsum(cnt, 0, dtype=torch.int32) - cnt, cnt

    def residue_segments(n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Start p at p*(n/P) + p % 4: every residue mod 4, as radix
        buckets start anywhere."""
        starts = [p * (n // RANKS) + p % 4 for p in range(RANKS)]
        cnts = [b - a for a, b in zip(starts, starts[1:] + [n])]
        return (torch.tensor(starts, dtype=torch.int32, device=dev),
                torch.tensor(cnts, dtype=torch.int32, device=dev))

    xlib = pack.lib()
    xstream = torch.cuda.current_stream(dev).cuda_stream
    for name, n, cap_of, n_planes in (
            (K5, 1 << 23, "radix P=8 lax engine sort(np int32 2^26)", 1),
            (K6, 1 << 25, "radix P=8 sort(cuda int32 2^28)", 1)):
        cap = mesh_counters[cap_of]["exchange_cap"]
        planes = tuple(words(n, 300 + i) for i in range(n_planes))
        buf = torch.empty((RANKS, cap), dtype=torch.int32, device=dev)
        for mode, (st, ct) in (("even", even_segments(n)), ("ragged", residue_segments(n))):
            if name == K5:
                def run(): return (pack.segment_pack(planes[0], st, ct, cap, RANKS),)
                def plain(): return (pack.segment_pack_plain(planes[0], st, ct, cap, RANKS),)

                def direct() -> int:
                    return xlib.segment_pack(planes[0].data_ptr(), buf.data_ptr(),
                                             st.data_ptr(), ct.data_ptr(), n, RANKS, cap,
                                             0, xstream)
            else:
                def run(): return exchange.fused_pass_pack(planes, st, ct, cap, RANKS)
                def plain(): return exchange.fused_pass_pack_plain(planes, st, ct, cap, RANKS)

                def direct() -> int:
                    return xlib.fused_pass_pack(planes[0].data_ptr(), None, None, None,
                                                buf.data_ptr(), None, None, None, 0, 0, 0,
                                                0, 1, st.data_ptr(), ct.data_ptr(), n,
                                                RANKS, cap, xstream)

            def fifty() -> None:
                for _ in range(50):
                    if direct():
                        raise AssertionError(f"{name} launch refused")

            err = k567_check(f"{name} P=8 n={n} cap={cap} {mode} starts (timing shape)",
                             run(), plain())
            one_ms = timed(run, REPS)
            mean_ms = timed(fifty, REPS) / 50
            nbytes = n_planes * 4 * (n + RANKS * cap)
            log(f"[timing] {name} {mode} starts: one launch through the wrapper "
                f"{one_ms:.4f} ms, mean of 50 back to back {mean_ms:.4f} ms, bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes) | card {card}")
            if mode == "ragged":
                entry(name, one_ms, timed(plain, PLAIN_REPS), err, nbytes,
                      n_planes * RANKS * cap, None,
                      f"one rank: {n_planes} x 2^{n.bit_length() - 1} keys -> [8, {cap}], "
                      f"starts at every residue mod 4 (one launch; mean of 50 back to "
                      f"back {mean_ms:.4f} ms)")
        del planes, buf

    cap = mesh_counters["radix P=8 sort(cuda int32 2^28)"]["exchange_cap"]
    sends = [words(RANKS * cap, 400 + r).view(RANKS, cap) for r in range(RANKS)]
    err = k567_check(f"K7 P=8 cap={cap} (timing shape)", exchange.remote_a2a(sends),
                     exchange.remote_a2a_plain(sends))
    stacked = torch.stack(sends)                         # [src, dst, cap]
    recv_all = torch.empty_like(stacked)                 # [dst, src, cap]
    k7_lib = timed(lambda: recv_all.copy_(stacked.transpose(0, 1)), REPS)
    entry(K7, timed(lambda: exchange.remote_a2a(sends), REPS),
          timed(lambda: exchange.remote_a2a_plain(sends), PLAIN_REPS), err,
          RANKS * 2 * RANKS * cap * 4, 0, k7_lib,
          f"8 ranks x [8, {cap}] (8 launches)", library="copy_ of [P, P, cap]^T")
    del sends, stacked, recv_all

    # K8 at the envelope and at the leg's typical round: the kernel alone
    # on staged device planes, the store's round trip (pinned H2D, launch,
    # D2H, sync), the plain version on the card, and the host np.lexsort
    # the round would otherwise take.
    # Bound: max(bytes / HBM rate, n^2 * k * 4 ops / 32-bit rate), the
    # bytes k planes in and the order out once.
    for n, k in ((radix.MERGE_MAX_ELEMS, 3), (radix.MERGE_MAX_ELEMS, 4), (1024, 3),
                 (1024, 4)):
        planes = merge_planes(n, k, 900 + k + n)
        err = k8_check(f"n={n} x{k} (timing shape)", planes)
        on_card = tuple(to_device_words(p, dev) for p in planes)
        stacked = torch.stack(on_card)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        # one launch through the wrapper between events (the kernels line),
        # and beside it the mean of 50 launches back to back through the C
        # entry, which hides the Python launch path's latency
        k8_ms = timed(lambda: radix._launch_merge(dev, stacked, k, n, out), REPS)
        lib8 = radix._merge_lib()
        stream8 = torch.cuda.current_stream(dev).cuda_stream

        def k8_launches() -> None:
            for _ in range(50):
                if lib8.merge_order(stacked.data_ptr(), k, n, out.data_ptr(), stream8):
                    raise AssertionError("K8 launch refused")

        k8_mean_ms = timed(k8_launches, REPS) / 50
        trip_ms = timed(lambda: radix.merge_order_host(planes, dev), REPS)
        plain_ms = timed(lambda: radix.merge_order_plain(on_card), REPS)
        host = []
        for _ in range(REPS + 1):
            t = time.perf_counter()
            np.lexsort(tuple(reversed(planes)))
            host.append((time.perf_counter() - t) * 1e3)
        lexsort_ms = statistics.median(host[1:])
        log(f"[timing] K8 n={n} x{k}: kernel {k8_ms:.4f} ms (one launch), "
            f"{k8_mean_ms:.4f} ms (mean of 50 back to back), round trip "
            f"(H2D + launch + D2H + sync) {trip_ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"host np.lexsort {lexsort_ms:.4f} ms (host clock) | card {card}")
        if (n, k) == (radix.MERGE_MAX_ELEMS, 4):
            entry(K8, k8_ms, plain_ms, err, (k + 1) * 4 * n, n * n * k * 4, None,
                  f"n={n} x{k} planes (one launch; mean of 50 back to back "
                  f"{k8_mean_ms:.4f} ms, round trip {trip_ms:.4f} ms, host "
                  f"np.lexsort {lexsort_ms:.4f} ms)", library="no single call")
    for label, wall in ext_walls.items():
        log(f"[timing] {label}: wall {wall:.3f} s (host-bound merge rounds) "
            f"| card {card}")
    for label, (ends, wall) in cli_times.items():
        if label.startswith("external leg"):
            log(f"[timing] CLI {label}: Endtime()-Starttime() = {ends:.5f} s, "
                f"wall {wall:.3f} s | card {card}")

    ends, wall = cli_times["2^28 int32 SORTBIN1"]
    log(f"[timing] CLI 2^28 int32 SORTBIN1 (auto, K1): Endtime()-Starttime() = "
        f"{ends:.5f} s, wall {wall:.3f} s incl. mmap open and the stdout lines "
        f"| card {card}")

    for label, x in (("int32 2^28", words(1 << 28, 282)),
                     ("int64 2^27", (words(1 << 27, 273).to(torch.int64) << 32)
                      | u64(words(1 << 27, 274)))):
        for ranks, algo in ((1, "radix"), (RANKS, "radix"), (RANKS, "sample")):
            kw = {"mesh": mesh, "algorithm": algo} if ranks > 1 else {}
            runs: list = []

            def traced() -> Tracer:
                runs.append(Tracer())
                return runs[-1]

            ms = timed(lambda: mt.sort(x, return_result=True, tracer=traced(), **kw),
                       REPS)
            # SORT_PLAN at its default: every timed run emits its plan record
            plans = [[s.name for s in tr.spans.spans].count("sort.plan") for tr in runs]
            if plans != [1] * (REPS + 1):
                raise AssertionError(f"sort(cuda {label}, P={ranks}, {algo}): "
                                     f"sort.plan spans per run {plans}")
            log(f"[timing] end-to-end sort(cuda {label}, P={ranks}, {algo}, verify "
                f"on, result on card, one sort.plan a run, plan_regret "
                f"{runs[-1].counters.get('plan_regret')}): {ms:.3f} ms = "
                f"{x.numel() / ms / 1e3:.1f} Mkeys/s | card {card}")
        del x
    # what the plan record costs: the same calls with SORT_PLAN=off beside
    # SORT_PLAN=on, in this call (on, off, off, on)
    x = words(1 << 28, 287)
    for ranks in (1, RANKS):
        kw = {"mesh": mesh} if ranks > 1 else {}
        ab = {"on": [], "off": []}
        for plan_knob in ("on", "off", "off", "on"):
            with env(SORT_PLAN=plan_knob):
                ab[plan_knob].append(timed(lambda: mt.sort(x, return_result=True, **kw),
                                           REPS))
        log(f"[timing] SORT_PLAN on/off, sort(cuda int32 2^28, P={ranks}, radix): on "
            f"{ab['on'][0]:.3f} / {ab['on'][1]:.3f} ms, off {ab['off'][0]:.3f} / "
            f"{ab['off'][1]:.3f} ms | card {card}")
    del x
    # K5's path: the lax exchange engine on eight ranks (one segment_pack
    # a rank a pass)
    x = words(1 << 26, 286)
    with env(SORT_EXCHANGE_ENGINE="lax"):
        ms = timed(lambda: mt.sort(x, mesh=mesh, algorithm="radix", return_result=True),
                   REPS)
    log(f"[timing] end-to-end sort(cuda int32 2^26, P={RANKS}, radix, lax exchange "
        f"engine (K5), verify on, result on card): {ms:.3f} ms = "
        f"{x.numel() / ms / 1e3:.1f} Mkeys/s | card {card}")
    del x

    assert_clean("4")
    for note in fault_notes:
        log(f"[timing] faults: {note} | card {card}")
    log(f"[timing] phase 3k wall {fault_wall:.3f} s | card {card}")
    for note in planner_notes:
        log(f"[timing] planner: {note} | card {card}")
    log(f"[timing] phase 3l wall {planner_wall:.3f} s | card {card}")
    log(f"[timing] phase 3m wall {serve_timings['phase_wall_s']:.3f} s | card {card}")
    log(f"[timing] phase 3n wall {spawned['phase_wall_s']:.3f} s (spawned mix p50 "
        f"{spawned['wire']['p50_ms']:.3f} ms, p99 {spawned['wire']['p99_ms']:.3f} ms) "
        f"| card {card}")
    log(f"[timing] phase 3o wall {multihost_wall:.3f} s (one rank "
        f"{multihost['ranks1']['warm_s']:.3f} s, eight ranks "
        f"{multihost['ranks8']['warm_s']:.3f} s) | card {card}")
    log(f"[timing] phase 3p wall {cross['phase_wall_s']:.3f} s (children "
        f"{cross['wall_s']:.3f} s; " + "; ".join(
            f"{label}: cross-process {max(min(c['legs'][label]['walls_s']) for c in cross['children']):.3f} s, "
            f"single-controller {min(v['walls_s']):.3f} s"
            for label, v in cross["single"].items())
        + f"; K7 at [8, {cross['children'][0]['k7']['cap']}] per rank, median ms: in "
        f"process {statistics.median(cross['in_process_k7']['ms']):.4f} by events, "
        f"window {statistics.median(cross['in_process_k7']['window_ms']):.4f}; across "
        + ", ".join(f"process {r} {statistics.median(c['k7']['ms']):.4f}"
                    for r, c in enumerate(cross["children"]))
        + f" by events, window {statistics.median(cross['children'][0]['k7']['window_ms']):.4f}"
        + f") | card {card}")
    log(f"[timing] phase 3q wall {serve_cross['phase_wall_s']:.3f} s (two servers across "
        f"processes, mixed load " + ", ".join(
            f"server {r} p50 {m['p50_ms']:.3f} ms p99 {m['p99_ms']:.3f} ms"
            for r, m in enumerate(serve_cross["mix"]))
        + f"; beside 3m's p50 {serve_timings['p50_ms']:.3f} ms p99 "
        f"{serve_timings['p99_ms']:.3f} ms and 3n's p50 {spawned['wire']['p50_ms']:.3f} ms "
        f"p99 {spawned['wire']['p99_ms']:.3f} ms; one-sided solo internal in "
        f"{serve_cross['solo_s']:.3f} s) | card {card}")
    for note in slice_notes:
        log(f"[timing] {note} | card {card}")
    for note in tele_notes:
        log(f"[timing] telemetry: {note} | card {card}")
    log(f"[timing] phase 3j wall {tele_wall:.3f} s | card {card}")
    log(f"[timing] phase 3i wall {slice_wall:.3f} s; smoke total wall "
        f"{time.perf_counter() - t_smoke:.3f} s | card {card}")
    log(f"[card] {card}")
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
