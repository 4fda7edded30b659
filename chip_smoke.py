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
             must raise.
             Tolerance: exact (integer words; every byte must match).
3. main    — three paths, each with the launch counts set to 0 just
             before it and read just after:
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
             (K4 chunk sorts, K8 merge rounds): int32 2^24 at a 98304-byte
             budget (2731 runs, 6 merge passes) and int64 2^22 at 196608
             (683 runs, 5 passes); K8's launches must equal the merge
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
             its wall, phase 3j's notes and wall, and the smoke's total
             wall.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 2
before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


@contextlib.contextmanager
def env(**values: str):
    """Set environment knobs for a block, restoring them after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
    for name, count in bitonic.LAUNCHES.items():
        if count <= before[name]:
            raise AssertionError(f"kernel {name} never launched in phase 2")

    assert_clean("2")

    # ----------------------------------------------------- 3. main paths
    K1, K2, K3, K4 = "bitonic_u32", "bitonic_pairs_u32", "fix_runs_pairs", "radix_pass"
    K4H = "radix_histogram"     # K4's one histogram launch a sort
    per_case = {}

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
        t = time.perf_counter()
        res = mt.sort(x, algorithm=algo, mesh=mesh, tracer=tr, return_result=True)
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

    def mesh_lax_path() -> None:
        with env(SORT_EXCHANGE_ENGINE="lax"):
            x = int32_keys(1 << 26)
            run_mesh_case("radix P=8 lax engine sort(np int32 2^26)", x, "radix",
                          card_sort_oracle(x), "lax", exchange_engine="lax")

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
        x = int32_keys(1 << 24)
        k8_leg("external_sort(np int32 2^24, budget 98304, fan-in 4)", x, 98304,
               2731, 6)
        x = rng.integers(-(2**63), 2**63 - 1, 1 << 22, dtype=np.int64)
        k8_leg("external_sort(np int64 2^22, budget 196608, fan-in 4)", x, 196608,
               683, 5)

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
    mesh_launches = run_path("radix on eight ranks (pallas engine)", (K6, K7),
                             mesh_radix_path)
    lax_launches = run_path("radix on eight ranks (lax engine)", (K5,), mesh_lax_path)
    run_path("radix on eight ranks under radix_pallas", (K4, K4H, K6, K7), mesh_k4_path)
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
