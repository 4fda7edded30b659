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
             and sample) and int64 2^27 beside one rank, and of int32
             2^26 under the lax exchange engine (K5); K8 at n = 4096 and 1024 with 3 and 4
             planes (one launch through the wrapper, which the kernels
             line keeps, and the mean of 50 launches back to back through
             the C entry; the round trip of merge_order_host,
             the plain version, and the host np.lexsort of the same
             planes);
             the wall of each external leg.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 2
before printing any result.
"""

from __future__ import annotations

import contextlib
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    import numpy as np

    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch import cli
    from mpitest_tpu_torch.models import api
    from mpitest_tpu_torch.ops import _build, bitonic, exchange, kernels, pack, radix
    from mpitest_tpu_torch.ops.keys import codec_for, to_device_words, unsigned_order
    from mpitest_tpu_torch.parallel.mesh import make_mesh
    from mpitest_tpu_torch.store import compress
    from mpitest_tpu_torch.store import merge as mergelib
    from mpitest_tpu_torch.utils import io as kio
    from mpitest_tpu_torch.utils import native_encode
    from mpitest_tpu_torch.utils.trace import Tracer

    dev = torch.device("cuda")
    card = card_line()

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

    @contextlib.contextmanager
    def env(**values: str):
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
        got = mt.sort(x, algorithm=algo, mesh=mesh, tracer=tr)
        secs = time.perf_counter() - t
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
    path_launches = {K1: main_launches[K1], K2: main_launches[K2],
                     K3: main_launches[K3], K4: radix_launches[K4],
                     K5: lax_launches[K5], K6: mesh_launches[K6],
                     K7: mesh_launches[K7], K8: k8_launches[K8]}

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
            ms = timed(lambda: mt.sort(x, return_result=True, **kw), REPS)
            log(f"[timing] end-to-end sort(cuda {label}, P={ranks}, {algo}, verify "
                f"on, result on card): {ms:.3f} ms = {x.numel() / ms / 1e3:.1f} "
                f"Mkeys/s | card {card}")
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

    log(f"[card] {card}")
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
