"""Kernels of this checkout against those of an earlier one, on one card.

    python3 -m mpitest_tpu_torch.utils.kernel_ab --old DIR [--rounds R]
        [--parts k4,k8,k3,pack,e2e]

``DIR`` holds a checkout of the earlier commit (``git archive <commit> |
tar -x -C DIR``, in a directory ``.gitignore`` lists).  Each measurement
runs in a process of its own whose ``mpitest_tpu_torch`` is one
checkout's package, built from that checkout's sources, so the script
knows nothing of either side's kernel interface: it calls
``radix.fused_radix_sort``, ``radix._launch_merge``, ``radix._merge_lib``
and ``radix.merge_order_host``, which both sides have.  The processes
run in pairs, the first side alternating: old, new, new, old, old, new
for ``R = 3``.  ``--parts`` picks what each measures (default: all):

* K4, the whole sort (``fused_radix_sort``'s full plan) at 2^28 one
  word, 2^27 two words, 2^20 one word and 6144 keys (an external chunk
  sort): CUDA-event median around the call, the device time by kernel
  (``torch.profiler``), ``torch.sort`` of the same keys, and the output
  against ``torch.sort``;
* the host wall of 2731 sorts of 6144 keys back to back (one external
  leg's chunk sorts), the median of three, in ms a sort;
* K8 at n = 4096 and 1024 with 3 and 4 planes: one launch through the
  wrapper between events, the mean of 50 launches back to back through
  the C entry, and the store's round trip (``merge_order_host``), the
  order against ``np.lexsort``;
* ``k3``: at 2^27 pairs on K2's own output and on planted equal-hi runs
  of 1..16 and 1..24, K3 alone (``bitonic.fix_runs_pairs``) and the pair
  engine's whole phase B (``bitonic.fix_runs_flag`` where the checkout
  has it, else ``fix_runs_pairs`` + ``kernels._fix_boundary`` + the
  residual expression): CUDA-event median and device time by kernel,
  the lo plane and flag against K3's plain version composed with the
  strips and the residual expression;
* ``pack``: K5 (``pack.segment_pack``, 2^23 keys) and K6
  (``exchange.fused_pass_pack``, one plane of 2^25) into ``[8, n/4 +
  1024]`` on even starts and on starts at every residue mod 4: one
  launch through the wrapper, the mean of 50 back to back through the C
  entry, the kernel's device time a launch, the output against the
  plain version;
* ``e2e``: ``sort()`` of device-resident int64 2^27 on one rank, the
  eight-rank sample sort of the same keys, and the eight-rank radix sort
  of int32 2^26 under ``SORT_EXCHANGE_ENGINE=lax`` (K5's path), result
  on the card, CUDA-event median of 5, the output against
  ``torch.sort``.

Before that, it prints the registers, shared memory and spills ``nvcc
-Xptxas -v`` reports for every kernel of this checkout's ``radix.cu``,
``merge.cu``, ``bitonic.cu`` and ``exchange.cu``.  Every line carries
the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
K4_CASES = (("2^28 one word", 1 << 28, 1), ("2^27 two words", 1 << 27, 2),
            ("2^20 one word", 1 << 20, 1), ("6144 one word", 6144, 1))
K8_CASES = ((4096, 3), (4096, 4), (1024, 3), (1024, 4))
CHUNKS = 2731                      # one K8 leg's chunk sorts (int32 2^24)
PARTS = ("k4", "k8", "k3", "pack", "e2e")
K3_INPUTS = ("network output", "planted runs 1..16", "planted runs 1..24")
PACK_CASES = (("K5", 1 << 23), ("K6", 1 << 25))
E2E_CASES = ("sort(cuda int64 2^27)", "sample P=8 sort(cuda int64 2^27)",
             "radix P=8 lax engine sort(cuda int32 2^26)")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _ptxas() -> None:
    """Registers, shared memory and spills of this checkout's kernels."""
    from mpitest_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    for name in ("radix", "merge", "bitonic", "exchange"):
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(out / f"lib{name}_ptxas.so"), str(_build.CSRC / f"{name}.cu")]
        done = subprocess.run(cmd, check=True, capture_output=True, text=True)
        kernel = ""
        for line in done.stderr.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"[ptxas] {name}.cu {kernel}: {line.split(':', 1)[-1].strip()}",
                      flush=True)


# ------------------------------------------------- one side, in its process


def measure(parts: tuple[str, ...] = PARTS) -> dict:
    """Every number of one side, for the package this process imports."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpitest_tpu_torch.ops import radix

    dev = torch.device("cuda")

    def timed(fn, reps: int = 7) -> float:
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
        return statistics.median(ms)

    def device_ms(fn) -> dict[str, float]:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got: dict[str, float] = {}
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
                name = ev.key.replace("(anonymous namespace)::", "").split("(")[0].strip()
                got[name] = got.get(name, 0.0) + ev.self_device_time_total / 1e3
        return got

    def words(n: int, seed: int) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev,
                             generator=g)

    def unsigned(w: torch.Tensor) -> torch.Tensor:
        return w.to(torch.int64) & 0xFFFFFFFF

    flip = torch.tensor(-(2**31), dtype=torch.int32, device=dev)
    res: dict = {"k4": {}, "k8": {}, "k3": {}, "pack": {}, "e2e": {}}
    if "k3" in parts:
        res["k3"] = _measure_k3(timed, device_ms, words)
    if "pack" in parts:
        res["pack"] = _measure_pack(timed, device_ms, words)
    if "e2e" in parts:
        res["e2e"] = _measure_e2e(timed, words)
    for label, n, planes in K4_CASES if "k4" in parts else ():
        ws = tuple(words(n, 10 + q) for q in range(planes))
        # the key as a signed int32 / int64 whose order is the planes'
        # unsigned order (the sign bit flipped)
        key = ws[0] ^ flip if planes == 1 else (
            ((unsigned(ws[0]) ^ 0x80000000) << 32) | unsigned(ws[1]))
        got = radix.fused_radix_sort(ws)
        want = torch.sort(key).values
        if planes == 1:
            equal = torch.equal(got[0] ^ flip, want)
        else:
            equal = (torch.equal(unsigned(got[0]), ((want >> 32) & 0xFFFFFFFF) ^ 0x80000000)
                     and torch.equal(unsigned(got[1]), want & 0xFFFFFFFF))
        del got, want
        res["k4"][label] = {"ms": timed(lambda: radix.fused_radix_sort(ws)),
                            "torch_sort_ms": timed(lambda: torch.sort(key)),
                            "device": device_ms(lambda: radix.fused_radix_sort(ws)),
                            "equal": bool(equal)}
        del ws, key

    if "k4" in parts:
        chunks = [words(6144, 100 + i) for i in range(CHUNKS)]
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for c in chunks:
                radix.fused_radix_sort((c,))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3 / CHUNKS)
        res["wall6144_ms"] = statistics.median(walls)
        del chunks

    rng = np.random.default_rng(9)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = radix._merge_lib()
    for n, k in K8_CASES if "k8" in parts else ():
        planes = tuple(rng.integers(0, 7, n).astype(np.uint32) for _ in range(k - 1)) + (
            rng.permutation(n).astype(np.uint32),)
        stacked = torch.from_numpy(np.stack(planes).view(np.int32)).to(dev)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        radix._launch_merge(dev, stacked, k, n, out)
        want = np.lexsort(tuple(reversed(planes)))
        equal = (np.array_equal(out.cpu().numpy(), want)
                 and np.array_equal(radix.merge_order_host(planes, dev), want))

        def fifty() -> None:
            for _ in range(50):
                if lib.merge_order(stacked.data_ptr(), k, n, out.data_ptr(), stream):
                    raise RuntimeError("K8 launch refused")

        res["k8"][f"n={n} x{k}"] = {
            "one": timed(lambda: radix._launch_merge(dev, stacked, k, n, out), 21),
            "mean50": timed(fifty, 5) / 50,
            "trip": timed(lambda: radix.merge_order_host(planes, dev), 21),
            "equal": bool(equal)}
    return res


def _measure_k3(timed, device_ms, words) -> dict:
    """K3 alone and phase B at 2^27 pairs (module docstring, ``k3``)."""
    import torch

    from mpitest_tpu_torch.ops import bitonic, kernels

    dev = torch.device("cuda")
    n, b_log2, passes = 1 << 27, 16, 16

    def residual(hi, lo):
        flip = -(2**31)
        return torch.any((hi[1:] == hi[:-1]) & ((lo[1:] ^ flip) < (lo[:-1] ^ flip)))

    def phase_b(hi, lo):
        fused = getattr(bitonic, "fix_runs_flag", None)
        if fused is not None:
            return fused(hi, lo, passes, b_log2)
        fixed = bitonic.fix_runs_pairs(hi, lo, passes, b_log2)
        fixed = kernels._fix_boundary(hi, fixed, passes, 1 << b_log2)
        return fixed, residual(hi, fixed)

    def planted(max_run: int, seed: int):
        g = torch.Generator(device=dev).manual_seed(seed)
        m = 2 * n // (max_run + 1) + (1 << 16)
        lens = torch.randint(1, max_run + 1, (m,), device=dev, generator=g)
        keys = torch.arange(m, dtype=torch.int32, device=dev) * 11 + 3
        return torch.repeat_interleave(keys, lens)[:n].contiguous()

    out = {}
    for label in K3_INPUTS:
        if label == "network output":
            hi, lo = bitonic.sort_pairs_padded(words(n, 31), words(n, 32), n, b_log2)
        else:
            max_run = int(label.rsplit(".", 1)[-1])
            hi, lo = planted(max_run, 33 + max_run), words(n, 34 + max_run)
        want = kernels._fix_boundary(hi, bitonic.fix_runs_pairs_plain(hi, lo, passes, b_log2),
                                     passes, 1 << b_log2)
        got, bad = phase_b(hi, lo)
        equal = torch.equal(got, want) and bool(bad) == bool(residual(hi, want))
        del got, want
        out[label] = {"k3_ms": timed(lambda: bitonic.fix_runs_pairs(hi, lo, passes, b_log2)),
                      "k3_device": device_ms(lambda: bitonic.fix_runs_pairs(
                          hi, lo, passes, b_log2)),
                      "phase_b_ms": timed(lambda: phase_b(hi, lo)),
                      "phase_b_device": device_ms(lambda: phase_b(hi, lo)),
                      "equal": bool(equal)}
        del hi, lo
    return out


def _measure_pack(timed, device_ms, words) -> dict:
    """K5 and K6 on even and residue starts (module docstring, ``pack``)."""
    import torch

    from mpitest_tpu_torch.ops import exchange, pack

    dev = torch.device("cuda")
    lib = pack.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ranks, out = 8, {}
    for name, n in PACK_CASES:
        cap = n // 4 + 1024
        x = words(n, 40 + n.bit_length())
        buf = torch.empty((ranks, cap), dtype=torch.int32, device=dev)
        for mode in ("even", "residues"):
            starts = [p * (n // ranks) + (p % 4 if mode == "residues" else 0)
                      for p in range(ranks)]
            cnts = [b - a for a, b in zip(starts, starts[1:] + [n])]
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            ct = torch.tensor(cnts, dtype=torch.int32, device=dev)
            if name == "K5":
                def wrap():
                    return (pack.segment_pack(x, st, ct, cap, ranks),)

                def plain():
                    return (pack.segment_pack_plain(x, st, ct, cap, ranks),)

                def direct() -> int:
                    return lib.segment_pack(x.data_ptr(), buf.data_ptr(), st.data_ptr(),
                                            ct.data_ptr(), n, ranks, cap, 0, stream)
            else:
                def wrap():
                    return exchange.fused_pass_pack((x,), st, ct, cap, ranks)

                def plain():
                    return exchange.fused_pass_pack_plain((x,), st, ct, cap, ranks)

                def direct() -> int:
                    return lib.fused_pass_pack(x.data_ptr(), None, None, None,
                                               buf.data_ptr(), None, None, None, 0, 0, 0,
                                               0, 1, st.data_ptr(), ct.data_ptr(), n,
                                               ranks, cap, stream)

            def fifty() -> None:
                for _ in range(50):
                    if direct():
                        raise RuntimeError(f"{name} launch refused")

            dms = device_ms(fifty)
            out[f"{name} {mode}"] = {
                "one": timed(wrap, 21), "mean50": timed(fifty, 5) / 50,
                "device": sum(dms.values()) / 50,
                "equal": all(torch.equal(a, b) for a, b in zip(wrap(), plain()))}
        del x, buf
    return out


def _measure_e2e(timed, words) -> dict:
    """End-to-end sorts on the paths K3 and K5 serve (docstring, ``e2e``)."""
    import numpy as np
    import torch

    import mpitest_tpu_torch as mt
    from mpitest_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    x64 = (words(1 << 27, 51).to(torch.int64) << 32) | (words(1 << 27, 52).to(torch.int64)
                                                          & 0xFFFFFFFF)
    x32 = words(1 << 26, 53)
    runs = {E2E_CASES[0]: (x64, {}), E2E_CASES[1]: (x64, {"mesh": mesh,
                                                         "algorithm": "sample"}),
            E2E_CASES[2]: (x32, {"mesh": mesh, "algorithm": "radix"})}
    out = {}
    for label, (x, kw) in runs.items():
        old = os.environ.get("SORT_EXCHANGE_ENGINE")
        if "lax" in label:
            os.environ["SORT_EXCHANGE_ENGINE"] = "lax"
        try:
            got = mt.sort(x, return_result=True, **kw)
            equal = np.array_equal(got.to_numpy(), torch.sort(x).values.cpu().numpy())
            out[label] = {"ms": timed(lambda: mt.sort(x, return_result=True, **kw), 5),
                          "equal": bool(equal)}
        finally:
            if old is None:
                os.environ.pop("SORT_EXCHANGE_ENGINE", None)
            else:
                os.environ["SORT_EXCHANGE_ENGINE"] = old
    return out


# ------------------------------------------------------------ the A/B


def _side(side: str, root: Path, parts: tuple[str, ...]) -> dict:
    """:func:`measure` in a process of its own, importing ``root``'s
    package: this file is run by path, so nothing of this checkout's
    package is loaded there."""
    boot = ("import json, runpy, sys; sys.path.insert(0, sys.argv[1]); "
            "m = runpy.run_path(sys.argv[2]); "
            "print(json.dumps(m['measure'](tuple(sys.argv[3].split(',')))))")
    done = subprocess.run([sys.executable, "-c", boot, str(root), __file__, ",".join(parts)],
                          cwd=root, capture_output=True, text=True, check=False)
    if done.returncode != 0:
        sys.stderr.write(done.stderr)
        raise RuntimeError(f"the {side} side ({root}) failed ({done.returncode})")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="a checkout of the commit to compare against")
    ap.add_argument("--rounds", type=int, default=3,
                    help="old/new pairs, the first side alternating (default 3)")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated subset of {','.join(PARTS)} (default: all)")
    args = ap.parse_args(argv)
    parts = tuple(args.parts.split(","))
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts takes {','.join(PARTS)}")
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    card = _card()
    _ptxas()
    roots = {"old": args.old.resolve(), "new": ROOT}
    order = [s for r in range(args.rounds) for s in (("old", "new"), ("new", "old"))[r % 2]]
    runs = [(side, _side(side, roots[side], parts)) for side in order]

    def line(what: str, pick) -> None:
        print(f"[ab] {what}: " + ", ".join(f"{s} {pick(r):.4f}" for s, r in runs)
              + f" | card {card}", flush=True)

    def by_kernel(what: str, pick) -> None:
        for side in roots:
            dms = pick(next(r for s, r in runs if s == side))
            print(f"[ab]   {side} {what} device ms by kernel: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in sorted(dms.items()))
                  + f" | card {card}", flush=True)

    for label, _, _ in K4_CASES if "k4" in parts else ():
        line(f"K4 {label} ms", lambda r: r["k4"][label]["ms"])
        line("  torch.sort of the same keys ms", lambda r: r["k4"][label]["torch_sort_ms"])
        by_kernel("", lambda r: r["k4"][label]["device"])
    if "k4" in parts:
        line(f"K4 wall of {CHUNKS} sorts of 6144 keys back to back, ms a sort",
             lambda r: r["wall6144_ms"])
    for n, k in K8_CASES if "k8" in parts else ():
        key = f"n={n} x{k}"
        line(f"K8 {key} one launch ms", lambda r: r["k8"][key]["one"])
        line(f"K8 {key} mean of 50 back to back ms", lambda r: r["k8"][key]["mean50"])
        line(f"K8 {key} round trip ms", lambda r: r["k8"][key]["trip"])
    for label in K3_INPUTS if "k3" in parts else ():
        line(f"K3 2^27 {label} ms", lambda r: r["k3"][label]["k3_ms"])
        by_kernel("K3", lambda r: r["k3"][label]["k3_device"])
        line(f"phase B 2^27 {label} ms", lambda r: r["k3"][label]["phase_b_ms"])
        by_kernel("phase B", lambda r: r["k3"][label]["phase_b_device"])
    for name, _ in PACK_CASES if "pack" in parts else ():
        for mode in ("even", "residues"):
            key = f"{name} {mode}"
            line(f"{key} one launch through the wrapper ms", lambda r: r["pack"][key]["one"])
            line(f"{key} mean of 50 back to back ms", lambda r: r["pack"][key]["mean50"])
            line(f"{key} device ms a launch", lambda r: r["pack"][key]["device"])
    for label in E2E_CASES if "e2e" in parts else ():
        line(f"{label} ms", lambda r: r["e2e"][label]["ms"])
    wrong = [(s, what) for s, r in runs for part in ("k4", "k8", "k3", "pack", "e2e")
             for what, v in r[part].items() if not v["equal"]]
    print(f"[ab] every output equal to its oracle: {not wrong} {wrong}", flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
