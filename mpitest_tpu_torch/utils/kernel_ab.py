"""K4 and K8 of this checkout against those of an earlier one, on one card.

    python3 -m mpitest_tpu_torch.utils.kernel_ab --old DIR [--rounds R]

``DIR`` holds a checkout of the earlier commit (``git archive <commit> |
tar -x -C DIR``, in a directory ``.gitignore`` lists).  Each measurement
runs in a process of its own whose ``mpitest_tpu_torch`` is one
checkout's package, built from that checkout's sources, so the script
knows nothing of either side's kernel interface: it calls
``radix.fused_radix_sort``, ``radix._launch_merge``, ``radix._merge_lib``
and ``radix.merge_order_host``, which both sides have.  The processes
run in pairs, the first side alternating: old, new, new, old, old, new
for ``R = 3``.  Each measures:

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
  order against ``np.lexsort``.

Before that, it prints the registers, shared memory and spills ``nvcc
-Xptxas -v`` reports for every kernel of this checkout's ``radix.cu``
and ``merge.cu``.  Every line carries the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
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


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _ptxas() -> None:
    """Registers, shared memory and spills of this checkout's K4 and K8."""
    from mpitest_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    for name in ("radix", "merge"):
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


def measure() -> dict:
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
    res: dict = {"k4": {}, "k8": {}}
    for label, n, planes in K4_CASES:
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
    for n, k in K8_CASES:
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


# ------------------------------------------------------------ the A/B


def _side(side: str, root: Path) -> dict:
    """:func:`measure` in a process of its own, importing ``root``'s
    package: this file is run by path, so nothing of this checkout's
    package is loaded there."""
    boot = ("import json, runpy, sys; sys.path.insert(0, sys.argv[1]); "
            "m = runpy.run_path(sys.argv[2]); print(json.dumps(m['measure']()))")
    done = subprocess.run([sys.executable, "-c", boot, str(root), __file__], cwd=root,
                          capture_output=True, text=True, check=False)
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
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    card = _card()
    _ptxas()
    roots = {"old": args.old.resolve(), "new": ROOT}
    order = [s for r in range(args.rounds) for s in (("old", "new"), ("new", "old"))[r % 2]]
    runs = [(side, _side(side, roots[side])) for side in order]

    def line(what: str, pick) -> None:
        print(f"[ab] {what}: " + ", ".join(f"{s} {pick(r):.4f}" for s, r in runs)
              + f" | card {card}", flush=True)

    for label, _, _ in K4_CASES:
        line(f"K4 {label} ms", lambda r: r["k4"][label]["ms"])
        line("  torch.sort of the same keys ms", lambda r: r["k4"][label]["torch_sort_ms"])
        for side in roots:
            dms = next(r for s, r in runs if s == side)["k4"][label]["device"]
            print(f"[ab]   {side} device ms by kernel: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in sorted(dms.items()))
                  + f" | card {card}", flush=True)
    line(f"K4 wall of {CHUNKS} sorts of 6144 keys back to back, ms a sort",
         lambda r: r["wall6144_ms"])
    for n, k in K8_CASES:
        key = f"n={n} x{k}"
        line(f"K8 {key} one launch ms", lambda r: r["k8"][key]["one"])
        line(f"K8 {key} mean of 50 back to back ms", lambda r: r["k8"][key]["mean50"])
        line(f"K8 {key} round trip ms", lambda r: r["k8"][key]["trip"])
    wrong = [(s, what) for s, r in runs for part in ("k4", "k8")
             for what, v in r[part].items() if not v["equal"]]
    print(f"[ab] every output equal to its oracle: {not wrong} {wrong}", flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
