"""Device time by CUDA kernel on the single-card sort path.

    python3 -m mpitest_tpu_torch.utils.profile_kernels

Traces, with ``torch.profiler`` (CUPTI), one warm call each of:

* K1 ``bitonic.sort_padded`` on 2^28 int32 words;
* the 64-bit pair engine ``kernels.sort_two_words_bitonic`` (K2 + K3 +
  boundary strips + residual check) on 2^27 pairs;
* end-to-end ``sort()`` of a device-resident int32 2^28 tensor and of an
  int64 2^27 tensor, verification on, result left on the card;
* K4 ``radix.fused_radix_sort`` on 2^28 one-word and 2^27 two-word
  planes (full plan: 4 and 8 passes of histogram, scan and scatter), and
  ``sort()`` of a device-resident int32 2^20 tensor under
  ``SORT_LOCAL_ENGINE=radix_pallas``;
* ``sort()`` on eight ranks of the card (``make_mesh(8)``) of a
  device-resident int32 2^28 tensor, radix and sample, with the share of
  device time in the exchange kernels K5-K7 (``pack_rows``, ``a2a_push``).

For each it prints the host wall time of the window, the device time
summed over CUDA events, their ratio (the device-busy share; one minus it
is the idle share), the device time per kernel name, and for the bitonic
paths the time and launches of each phase: K1's tile sort and merge
rounds, K2's tile sort, staged passes and tail passes.  Every line
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
K2_PHASES = {"K2 tile sort": ("k2_tile_sort",), "K2 staged passes": ("k2_staged_pass",),
             "K2 tail passes": ("k2_tail_pass",), "K3": ("fix_runs_kernel",)}


def profile(label: str, fn: Callable[[], object], card: str, top: int = 10,
            share: tuple[str, ...] = (),
            groups: dict[str, tuple[str, ...]] | None = None) -> None:
    """Trace one warm call of ``fn``; ``share`` names kernels (by
    substring) whose summed device time is printed as a share, and
    ``groups`` names phases whose kernels' device time and launches are
    printed each."""
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
    for phase, names in (groups or {}).items():
        hit = [r for r in rows if any(k in r[2] for k in names)]
        print(f"[profile] {label}: {phase} {sum(r[0] for r in hit):.3f} ms in "
              f"{sum(r[1] for r in hit)} launches | card {card}")
    if share:
        part = sum(r[0] for r in rows if any(k in r[2] for k in share))
        print(f"[profile] {label}: {part:.3f} ms of {dev_ms:.3f} ms device time "
              f"({part / dev_ms:.4f}) in kernels named {share} | card {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device available", file=sys.stderr)
        return 2
    import os

    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.ops import bitonic, kernels, radix

    card = _card()
    dev = torch.device("cuda")

    def words(n: int, seed: int) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                             device=dev, generator=g)

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
    profile("K4 fused_radix_sort 2^28 x1", lambda: radix.fused_radix_sort((x,)), card)
    del x
    hi, lo = words(1 << 27, 5), words(1 << 27, 6)
    profile("K4 fused_radix_sort 2^27 x2",
            lambda: radix.fused_radix_sort((hi, lo)), card)
    del hi, lo
    x = words(1 << 20, 7)
    old = os.environ.get("SORT_LOCAL_ENGINE")
    os.environ["SORT_LOCAL_ENGINE"] = "radix_pallas"
    try:
        profile("sort(cuda int32 2^20), radix_pallas",
                lambda: mt.sort(x, return_result=True), card)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
