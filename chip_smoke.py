#!/usr/bin/env python3
"""Smoke run of mpitest_tpu_torch on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Phases, each failing loudly (any exception exits non-zero):

1. build   — compile every ``mpitest_tpu_torch/csrc/*.cu`` with nvcc (all
             started together) into ``build/kernels/``; print the build
             time and the card's name and power limit.
2. kernels — each CUDA kernel against its plain PyTorch version on the
             card: K1 (bitonic_u32) at 2^20 and 2^24 over adversarial
             patterns, K2 (bitonic_pairs_u32) at 2^20, K3
             (fix_runs_pairs) + boundary strips at 2^20 with planted runs.
             Tolerance: exact (integer words; every byte must match).
3. main    — ``mpitest_tpu_torch.sort()`` at full size with verification
             on: int32 2^28 from the host and resident on the card, int64
             2^27, the constant-word and hi-duplication int64 routes at
             2^26, float32 2^24 with NaN/±0/±inf, and a non-power-of-two
             int32 that pads to 2^26.  Every output equals its oracle (np.sort, or torch.sort
             on the card for the 2^28/2^27 rows); the ``local_engine``
             counter and the kernel launch counts are asserted.
4. timing  — CUDA events, warm median: each kernel at the main path's
             shape beside its plain version, its bound and torch.sort;
             end-to-end sort() of the device-resident inputs.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 2
before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and the
# non-tensor-core 32-bit rate, which bounds the integer compares here.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S_32BIT = 67e12
REPS = 5          # warm repetitions for kernel / library / end-to-end times
PLAIN_REPS = 3    # the plain versions take seconds per call at full size

SOURCE = "mpitest_tpu_torch/csrc/bitonic.cu"
REPLACES = {
    "bitonic_u32": "mpitest_tpu/ops/bitonic.py:308,371,514,571",
    "bitonic_pairs_u32": "mpitest_tpu/ops/bitonic.py:703,758,970,1038",
    "fix_runs_pairs": "mpitest_tpu/ops/bitonic.py:1101",
}


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
    from mpitest_tpu_torch.ops import _build, bitonic, kernels
    from mpitest_tpu_torch.ops.keys import to_device_words, unsigned_order
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
            "n equal to plain (bytes)")

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
    k2_payload_bytes_equal = bool(torch.equal(gp, wp))
    log(f"[kernels] K2 2^20: keys equal, payload multiset per run equal, "
        f"payload byte-equal={k2_payload_bytes_equal}")

    rng = np.random.default_rng(23)
    for max_run, b_log2 in ((16, 16), (24, 16), (16, 10)):
        lens = rng.integers(1, max_run + 1, n)
        hi_np = np.repeat(np.arange(lens.size, dtype=np.uint32) * 7 + 1,
                          lens)[:n]
        hi = to_device_words(hi_np, dev)
        lo = words(n, max_run + b_log2)
        got = kernels._fix_boundary(hi, bitonic.fix_runs_pairs(hi, lo, 16, b_log2),
                                    16, 1 << b_log2)
        want = kernels._fix_boundary(hi, bitonic.fix_runs_pairs_plain(hi, lo, 16, b_log2),
                                     16, 1 << b_log2)
        sync()

        def residual(v: torch.Tensor) -> bool:
            return bool(torch.any((hi[1:] == hi[:-1])
                                  & (unsigned_order(v[1:]) < unsigned_order(v[:-1]))))

        if not torch.equal(got, want) or residual(got) != residual(want):
            raise AssertionError(f"K3 2^20 runs<= {max_run} b_log2={b_log2}: "
                                 "kernel != plain")
        log(f"[kernels] K3+boundary 2^20 runs 1..{max_run} bsz 2^{b_log2}: lo "
            f"bytes equal, residual={residual(got)} on both")
    for name, count in bitonic.LAUNCHES.items():
        if count <= before[name]:
            raise AssertionError(f"kernel {name} never launched in phase 2")

    # ------------------------------------------------------ 3. main path
    bitonic.reset_launches()
    per_case = {}

    def run_case(label: str, x, engine: str, oracle, kernels_run: tuple[str, ...],
                 **counters) -> None:
        base = dict(bitonic.LAUNCHES)
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
        if per_case[label] != expect:
            raise AssertionError(f"{label}: launches {per_case[label]} != {expect}")
        log(f"[main] {label}: equal to oracle, engine={engine}, "
            f"launches={per_case[label]}, {secs:.3f} s host wall incl. "
            "encode/verify/decode")

    def card_sort_oracle(host: np.ndarray):
        def f():
            t = torch.from_numpy(host).to(dev)
            return torch.sort(t).values.cpu().numpy()
        return f

    K1, K2, K3 = "bitonic_u32", "bitonic_pairs_u32", "fix_runs_pairs"
    rng = np.random.default_rng(2026)
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
    xf = rng.standard_normal(1 << 24).astype(np.float32)
    xf[:8] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45]

    def float_oracle():
        u = xf.view(np.uint32)  # IEEE totalOrder by bit pattern
        key = np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000))
        return xf[np.argsort(key, kind="stable")]

    run_case("sort(np float32 2^24, NaN/±0/±inf)", xf, "bitonic", float_oracle,
             (K1,))
    # pads to 2^26 (past the break-even: n*10 >= n_pow2*6), so K1 runs
    xo = rng.integers(-(2**31), 2**31, (1 << 26) - 12345, dtype=np.int64).astype(np.int32)
    run_case("sort(np int32 2^26-12345)", xo, "bitonic", lambda: np.sort(xo), (K1,))
    del xf, xo
    main_launches = dict(bitonic.LAUNCHES)
    for name, count in main_launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    log(f"[main] launches over the main path: {main_launches}")

    # ---------------------------------------------------------- 4. timing
    entries = []

    def bound(nbytes: float, ops: float) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / OPS_PER_S_32BIT * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def entry(name: str, ms: float, plain_ms: float, err: int, nbytes: float,
              ops: float, library_ms: float | None, shape: str) -> None:
        b_ms, b_by = bound(nbytes, ops)
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": main_launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms})
        log(f"[timing] {name} {shape}: {ms:.3f} ms kernel, {plain_ms:.1f} ms "
            f"plain, bound {b_ms:.3f} ms ({b_by}; HBM bytes alone "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms), torch.sort "
            f"{'-' if library_ms is None else f'{library_ms:.3f} ms'} "
            f"| card {card}")

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
    cmp_k1 = (n // 2) * t * (t + 1) // 2        # compare-exchanges of the network
    entry("bitonic_u32", k1_ms, k1_plain, err, 2 * 4 * n, 2 * cmp_k1, k1_lib,
          "2^28 int32")
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
    cmp_k2 = (n // 2) * t * (t + 1) // 2
    entry("bitonic_pairs_u32", k2_ms, k2_plain, err, 4 * 4 * n, 4 * cmp_k2,
          k2_lib, "2^27 pairs")

    # K3 on the pair network's own output: hi sorted, lo permuted in runs
    g3 = bitonic.fix_runs_pairs(gk, gp, 16, bitonic.PAIR_BLOCK_LOG2)
    w3 = bitonic.fix_runs_pairs_plain(gk, gp, 16, bitonic.PAIR_BLOCK_LOG2)
    err = max_abs_err(g3, w3)
    del g3, w3
    if err:
        raise AssertionError(f"K3 2^27: kernel != plain (max_abs_err {err})")
    k3_ms = timed(lambda: bitonic.fix_runs_pairs(gk, gp, 16, bitonic.PAIR_BLOCK_LOG2),
                  REPS)
    k3_plain = timed(lambda: bitonic.fix_runs_pairs_plain(gk, gp, 16,
                                                          bitonic.PAIR_BLOCK_LOG2),
                     PLAIN_REPS)
    entry("fix_runs_pairs", k3_ms, k3_plain, err, 3 * 4 * n, 16 * (n // 2) * 4,
          None, "2^27 pairs, 16 passes")
    del gk, gp

    key64 = (hi.to(torch.int64) << 32) | u64(lo)
    pair_ms = timed(lambda: kernels.sort_two_words_bitonic(hi, lo), REPS)
    sort64_ms = timed(lambda: torch.sort(key64), REPS)
    log(f"[timing] pair engine K2+K3+strips 2^27: {pair_ms:.3f} ms; "
        f"torch.sort int64 2^27: {sort64_ms:.3f} ms | card {card}")
    del hi, lo, key64

    for label, x in (("int32 2^28", words(1 << 28, 282)),
                     ("int64 2^27", (words(1 << 27, 273).to(torch.int64) << 32)
                      | u64(words(1 << 27, 274)))):
        ms = timed(lambda: mt.sort(x, return_result=True), REPS)
        log(f"[timing] end-to-end sort(cuda {label}, verify on, result on "
            f"card): {ms:.3f} ms = {x.numel() / ms / 1e3:.1f} Mkeys/s "
            f"| card {card}")
        del x

    log(f"[card] {card}")
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
