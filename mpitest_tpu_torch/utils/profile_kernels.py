"""Device time by CUDA kernel on the single-card sort path.

    python3 -m mpitest_tpu_torch.utils.profile_kernels [--parts a,b,...]

``--parts`` picks sections (default: all): ``sorts`` (the list below),
``phase_b``, ``pack`` and ``host`` (the three after it).  Traces, with
``torch.profiler`` (CUPTI), one warm call each of:

* K1 ``bitonic.sort_padded`` on 2^28 int32 words;
* the 64-bit pair engine ``kernels.sort_two_words_bitonic`` (K2 + K3 +
  boundary strips + residual check) on 2^27 pairs;
* end-to-end ``sort()`` of a device-resident int32 2^28 tensor and of an
  int64 2^27 tensor, verification on, result left on the card;
* K4 ``radix.fused_radix_sort`` on 2^28 one-word and 2^27 two-word
  planes (full plan: one histogram launch, then 4 and 8 onesweep passes),
  and
  ``sort()`` of a device-resident int32 2^20 tensor under
  ``SORT_LOCAL_ENGINE=radix_pallas``;
* ``sort()`` on eight ranks of the card (``make_mesh(8)``) of a
  device-resident int32 2^28 tensor, radix and sample, with the share of
  device time in the exchange kernels K5-K7 (``pack_rows``, ``a2a_push``);
* phase B of the pair engine at 2^27 pairs, on K2's own output and on
  planted equal-hi runs of 1..16 and 1..24: K3 alone
  (``bitonic.fix_runs_pairs``), the boundary strips
  (``kernels._fix_boundary``), the residual expression, the three
  composed, and, where the package has it, the fused entry
  (``bitonic.fix_runs_flag``: K3, the strip kernel and the flag), each
  with its CUDA-event time (median of 7) beside the trace;
* K5 (``pack.segment_pack``, 2^23 keys) and K6
  (``exchange.fused_pass_pack``, one plane of 2^25) into ``[8, n/4 +
  1024]`` (the mesh paths' negotiated caps) on even segments (starts at multiples
  of n/8) and on ragged ones (start p at p*n/8 + p mod 4): one launch
  through the wrapper between CUDA events, the mean of 50 launches back
  to back through the C entry, and the device time of the kernel
  (``pack_rows``) per launch from the trace; then the wrapper's host
  path piece by piece (argument checks, output allocation, the launch
  glue, the bare C call), in µs a call over 2000 calls of a pack small
  enough that the card keeps up;
* host input (``host``): ``sort()`` of a host int32 2^28 array on eight
  ranks under ``SORT_INGEST=mono`` (one encode, one copy a shard, the
  plain gather back) and ``stream`` (the streamed ingest and egress of
  ``models/ingest.py``), six calls in the order mono, stream, stream,
  mono, mono, stream, each with its phase seconds and the bytes checked
  equal; the same array on one rank, ``sort(x)`` against
  ``ingest_to_mesh`` + ``sort(staged)``; and the trace of one streamed
  eight-rank call (its busy share is the device's share of the host
  wall).

For each it prints the host wall time of the window, the device time
summed over CUDA events, their ratio (the device-busy share; one minus it
is the idle share), the device time per kernel name, and the time and
launches of each phase: K1's tile sort and merge rounds, K2's tile sort,
staged passes and tail passes, K4's histogram and onesweep passes.  Every line
carries the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable

import torch


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


#: The bitonic kernels by phase (``csrc/bitonic.cu``): K1's tile sort and
#: merge rounds, K2's tile sort, staged passes and tail passes.
K1_PHASES = {"K1 tile sort": ("k1_tile_sort",),
             "K1 merge rounds": ("k1_merge_partition", "k1_merge_round")}
#: Phase B of the pair engine: K3 (the kernel before and after its
#: redesign), the boundary-strip kernel, and everything else a phase-B
#: window launches (the eager strips, copies and the residual expression).
PHASE_B = {"K3": ("fix_runs_kernel", "k3_fix_runs"), "K3 strips": ("k3_fix_strips",),
           "phase B glue": None}
K2_PHASES = {"K2 tile sort": ("k2_tile_sort",), "K2 staged passes": ("k2_staged_pass",),
             "K2 tail passes": ("k2_tail_pass",), "K3": PHASE_B["K3"],
             "K3 strips": PHASE_B["K3 strips"],
             "other kernels (phase B glue, codec, verifier)": None}
#: The onesweep radix kernels (``csrc/radix.cu``): one histogram a sort,
#: one pass kernel a planned pass.
K4_PHASES = {"K4 histogram": ("k4_histogram",), "K4 passes": ("k4_onesweep",)}


def profile(label: str, fn: Callable[[], object], card: str, top: int = 10,
            share: tuple[str, ...] = (),
            groups: dict[str, tuple[str, ...]] | None = None) -> None:
    """Trace one warm call of ``fn``; ``share`` names kernels (by
    substring) whose summed device time is printed as a share, and
    ``groups`` names phases whose kernels' device time and launches are
    printed each (a phase of ``None`` takes every kernel no other phase
    names)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    if not rows:
        print(f"[profile] {label}: wall {wall_ms:.3f} ms; device time not "
              f"measured (no CUDA events traced) | card {card}")
        return
    print(f"[profile] {label}: wall {wall_ms:.3f} ms, device {dev_ms:.3f} ms, "
          f"busy share {dev_ms / wall_ms:.3f} | card {card}")
    for ms, count, name in rows[:top]:
        print(f"[profile]   {ms:9.3f} ms  {count:5d}x  {name[:110]}")
    named = [k for names in (groups or {}).values() if names for k in names]
    for phase, names in (groups or {}).items():
        if names is None:
            hit = [r for r in rows if not any(k in r[2] for k in named)]
        else:
            hit = [r for r in rows if any(k in r[2] for k in names)]
        print(f"[profile] {label}: {phase} {sum(r[0] for r in hit):.3f} ms in "
              f"{sum(r[1] for r in hit)} launches | card {card}")
    if share:
        part = sum(r[0] for r in rows if any(k in r[2] for k in share))
        print(f"[profile] {label}: {part:.3f} ms of {dev_ms:.3f} ms device time "
              f"({part / dev_ms:.4f}) in kernels named {share} | card {card}")


def timed(fn: Callable[[], object], reps: int = 7) -> float:
    """CUDA-event median over ``reps`` warm calls, in ms."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return sorted(ms)[len(ms) // 2]


def kernel_device_ms(fn: Callable[[], object], names: tuple[str, ...]) -> tuple[float, int]:
    """Device time of the kernels named (by substring) in one traced warm
    call of ``fn``: (ms summed, launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    hit = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
           and any(k in ev.key for k in names)]
    return (sum(ev.self_device_time_total for ev in hit) / 1e3,
            sum(ev.count for ev in hit))


def sorts(card: str, words: Callable[[int, int], torch.Tensor]) -> None:
    """K1, the pair engine, K4 and end-to-end sorts on one and eight ranks."""
    import os

    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.ops import bitonic, kernels, radix

    x = words(1 << 28, 1)
    profile("K1 sort_padded 2^28", lambda: bitonic.sort_padded(
        x, 1 << 28, bitonic.BLOCK_LOG2), card, groups=K1_PHASES)
    profile("sort(cuda int32 2^28)", lambda: mt.sort(x, return_result=True), card,
            groups=K1_PHASES)
    del x
    hi, lo = words(1 << 27, 2), words(1 << 27, 3)
    profile("pair engine 2^27", lambda: kernels.sort_two_words_bitonic(hi, lo), card,
            groups=K2_PHASES)
    x64 = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
    del hi, lo
    profile("sort(cuda int64 2^27)", lambda: mt.sort(x64, return_result=True), card,
            groups=K2_PHASES)
    del x64
    x = words(1 << 28, 4)
    profile("K4 fused_radix_sort 2^28 x1", lambda: radix.fused_radix_sort((x,)), card,
            groups=K4_PHASES)
    del x
    hi, lo = words(1 << 27, 5), words(1 << 27, 6)
    profile("K4 fused_radix_sort 2^27 x2",
            lambda: radix.fused_radix_sort((hi, lo)), card, groups=K4_PHASES)
    del hi, lo
    x = words(1 << 20, 7)
    old = os.environ.get("SORT_LOCAL_ENGINE")
    os.environ["SORT_LOCAL_ENGINE"] = "radix_pallas"
    try:
        profile("sort(cuda int32 2^20), radix_pallas",
                lambda: mt.sort(x, return_result=True), card, groups=K4_PHASES)
    finally:
        if old is None:
            os.environ.pop("SORT_LOCAL_ENGINE")
        else:
            os.environ["SORT_LOCAL_ENGINE"] = old
    from mpitest_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    x = words(1 << 28, 8)
    for algo in ("radix", "sample"):
        profile(f"sort(cuda int32 2^28), 8 ranks, {algo}",
                lambda: mt.sort(x, algorithm=algo, mesh=mesh, return_result=True),
                card, top=14, share=("pack_rows", "a2a_push"), groups=K1_PHASES)


def phase_b(card: str, words: Callable[[int, int], torch.Tensor]) -> None:
    """Phase B of the pair engine at 2^27 pairs, split into its parts."""
    from mpitest_tpu_torch.ops import bitonic, kernels
    from mpitest_tpu_torch.ops.keys import unsigned_order

    n, b_log2, passes = 1 << 27, bitonic.PAIR_BLOCK_LOG2, 16
    dev = torch.device("cuda")

    def residual(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
        return torch.any((hi[1:] == hi[:-1])
                         & (unsigned_order(lo[1:]) < unsigned_order(lo[:-1])))

    def composed(hi: torch.Tensor, lo: torch.Tensor):
        fixed = bitonic.fix_runs_pairs(hi, lo, passes, b_log2)
        fixed = kernels._fix_boundary(hi, fixed, passes, 1 << b_log2)
        return fixed, residual(hi, fixed)

    def planted(max_run: int, seed: int) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(seed)
        m = 2 * n // (max_run + 1) + (1 << 16)
        lens = torch.randint(1, max_run + 1, (m,), device=dev, generator=g)
        if int(lens.sum()) < n:
            raise AssertionError("planted runs too short")
        keys = torch.arange(m, dtype=torch.int32, device=dev) * 11 + 3
        return torch.repeat_interleave(keys, lens)[:n].contiguous()

    hi, lo = words(n, 11), words(n, 12)
    hs, lr = bitonic.sort_pairs_padded(hi, lo, n, b_log2)
    del hi, lo
    inputs = {"network output": (hs, lr),
              "planted runs 1..16": (planted(16, 13), words(n, 14)),
              "planted runs 1..24": (planted(24, 15), words(n, 16))}
    fused = getattr(bitonic, "fix_runs_flag", None)
    for label, (h, lo_in) in inputs.items():
        k3 = bitonic.fix_runs_pairs(h, lo_in, passes, b_log2)
        strips = kernels._fix_boundary(h, k3, passes, 1 << b_log2)
        parts = {"K3 fix_runs_pairs": lambda: bitonic.fix_runs_pairs(
                     h, lo_in, passes, b_log2),
                 "_fix_boundary": lambda: kernels._fix_boundary(
                     h, k3, passes, 1 << b_log2),
                 "residual expression": lambda: residual(h, strips),
                 "K3 + _fix_boundary + residual": lambda: composed(h, lo_in)}
        if fused is not None:
            parts["fix_runs_flag (K3 + strip kernel + flag)"] = lambda: fused(
                h, lo_in, passes, b_log2)
            got, bad = fused(h, lo_in, passes, b_log2)
            want, want_bad = composed(h, lo_in)
            if not torch.equal(got, want) or bool(bad) != bool(want_bad):
                raise AssertionError(f"phase B {label}: fused entry != composition")
        for part, fn in parts.items():
            profile(f"phase B 2^27 {label}: {part}", fn, card, top=6, groups=PHASE_B)
            print(f"[phase_b] {label}: {part} {timed(fn):.4f} ms (CUDA events, "
                  f"median of 7) | card {card}", flush=True)
        print(f"[phase_b] {label}: residual {bool(residual(h, strips))} | card {card}",
              flush=True)
        del k3, strips


def pack_times(card: str, words: Callable[[int, int], torch.Tensor]) -> None:
    """K5 and K6 on even and ragged segments, three measures each."""
    from mpitest_tpu_torch.ops import _build, exchange, pack

    dev = torch.device("cuda")
    lib = pack.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ranks = 8
    for name, n in (("K5 segment_pack", 1 << 23), ("K6 fused_pass_pack", 1 << 25)):
        cap = n // 4 + pack.CHUNK                 # the mesh paths' caps
        x = words(n, 20 + n.bit_length())
        out = torch.empty((ranks, cap), dtype=torch.int32, device=dev)
        q = n // ranks
        for mode in ("even", "ragged"):
            starts = [p * q + (p % 4 if mode == "ragged" else 0) for p in range(ranks)]
            cnts = [b - a for a, b in zip(starts, starts[1:] + [n])]
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            ct = torch.tensor(cnts, dtype=torch.int32, device=dev)
            if name.startswith("K5"):
                def wrap():
                    return (pack.segment_pack(x, st, ct, cap, ranks),)

                def plain():
                    return (pack.segment_pack_plain(x, st, ct, cap, ranks),)

                def direct() -> int:
                    return lib.segment_pack(x.data_ptr(), out.data_ptr(), st.data_ptr(),
                                            ct.data_ptr(), n, ranks, cap, 0, stream)
            else:
                def wrap():
                    return exchange.fused_pass_pack((x,), st, ct, cap, ranks)

                def plain():
                    return exchange.fused_pass_pack_plain((x,), st, ct, cap, ranks)

                def direct() -> int:
                    return lib.fused_pass_pack(x.data_ptr(), None, None, None,
                                               out.data_ptr(), None, None, None,
                                               0, 0, 0, 0, 1, st.data_ptr(), ct.data_ptr(),
                                               n, ranks, cap, stream)

            if not all(torch.equal(a, b) for a, b in zip(wrap(), plain())):
                raise AssertionError(f"{name} {mode}: kernel != plain")

            def fifty() -> None:
                for _ in range(50):
                    if direct():
                        raise AssertionError(f"{name} launch refused")

            one = timed(wrap, 21)
            mean50 = timed(fifty, 5) / 50
            dev_ms, count = kernel_device_ms(fifty, ("pack_rows",))
            nbytes = 4 * (n + ranks * cap)
            print(f"[pack] {name} {mode} n={n} -> [{ranks}, {cap}]: one launch through "
                  f"the wrapper {one:.4f} ms, mean of 50 back to back {mean50:.4f} ms, "
                  f"device {dev_ms / max(count, 1):.4f} ms a launch ({count} traced), "
                  f"bound {nbytes / 3.35e12 * 1e3:.4f} ms (bytes) | card {card}",
                  flush=True)
        del x, out
    # the wrapper's host path alone: a pack small enough that the card
    # keeps up with the launches, so host time per call is the wall
    n, cap, calls = 4096, pack.CHUNK, 2000
    x = words(n, 30)
    st = torch.arange(ranks, dtype=torch.int32, device=dev) * (n // ranks)
    ct = torch.full((ranks,), n // ranks, dtype=torch.int32, device=dev)
    out = torch.empty((ranks, cap), dtype=torch.int32, device=dev)
    args = (x.data_ptr(), out.data_ptr(), st.data_ptr(), ct.data_ptr(), n, ranks, cap, 0)
    steps = {"segment_pack (whole wrapper)": lambda: pack.segment_pack(x, st, ct, cap, ranks),
             "check_pack_args": lambda: pack.check_pack_args((x,), st, ct, cap, ranks),
             "torch.empty of the [P, cap] output": lambda: torch.empty(
                 (ranks, cap), dtype=torch.int32, device=dev),
             "_build.launch on the current card (raw stream, ctypes call)":
                 lambda: _build.launch(lib, "segment_pack", x.device, *args),
             "_build.launch through the device guard (cuda without an index)":
                 lambda: _build.launch(lib, "segment_pack", torch.device("cuda"), *args),
             "the C entry alone (ctypes)": lambda: lib.segment_pack(*args, stream)}
    for label, fn in steps.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        print(f"[pack] host path, {label}: {(time.perf_counter() - t0) / calls * 1e6:.2f} "
              f"us a call (mean of {calls}, n={n} -> [{ranks}, {cap}]) | card {card}",
              flush=True)


def host_input(card: str, words: Callable[[int, int], torch.Tensor]) -> None:
    """Host-input sort() on eight ranks and on one: the one-shot encode
    and copy against the streamed ingest, host wall and phase seconds."""
    import os

    import numpy as np

    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.models import api
    from mpitest_tpu_torch.parallel.mesh import make_mesh
    from mpitest_tpu_torch.utils.trace import Tracer

    del words
    x = np.random.default_rng(2026).integers(-(2**31), 2**31, 1 << 28,
                                             dtype=np.int64).astype(np.int32)
    old = os.environ.get("SORT_INGEST")
    first: dict = {}

    def run(label: str, fn: Callable[[Tracer], np.ndarray]) -> None:
        tr = Tracer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(tr)
        wall = time.perf_counter() - t0
        if "out" not in first:
            first["out"] = out
        elif out.tobytes() != first["out"].tobytes():
            raise AssertionError(f"{label}: bytes differ from the first call's")
        phases = ", ".join(f"{k} {v:.3f}" for k, v in tr.phases.items())
        print(f"[host] {label}: wall {wall:.3f} s (phases, s: {phases}) "
              f"| card {card}", flush=True)

    mesh = make_mesh(8)
    try:
        for mode in ("mono", "stream", "stream", "mono", "mono", "stream"):
            os.environ["SORT_INGEST"] = mode
            run(f"sort(np int32 2^28), 8 ranks, radix, SORT_INGEST={mode}",
                lambda tr: mt.sort(x, mesh=mesh, tracer=tr))
        os.environ["SORT_INGEST"] = "stream"
        profile("sort(np int32 2^28), 8 ranks, radix, streamed ingest and egress",
                lambda: mt.sort(x, mesh=mesh), card, top=8)
        os.environ["SORT_INGEST"] = "auto"
        mesh1 = make_mesh(1)
        for label in ("sort(x)", "ingest_to_mesh + sort(staged)") * 2:
            run(f"one rank, np int32 2^28, {label}",
                (lambda tr: mt.sort(x, tracer=tr)) if label == "sort(x)" else
                (lambda tr: mt.sort(api.ingest_to_mesh(x, mesh=mesh1, tracer=tr),
                                    tracer=tr)))
    finally:
        if old is None:
            os.environ.pop("SORT_INGEST", None)
        else:
            os.environ["SORT_INGEST"] = old


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="sorts,phase_b,pack,host",
                    help="comma-separated sections: sorts, phase_b, pack, host")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device available", file=sys.stderr)
        return 2
    card = _card()
    dev = torch.device("cuda")

    def words(n: int, seed: int) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                             device=dev, generator=g)

    sections = {"sorts": sorts, "phase_b": phase_b, "pack": pack_times,
                "host": host_input}
    for part in args.parts.split(","):
        sections[part](card, words)
    return 0


if __name__ == "__main__":
    sys.exit(main())
