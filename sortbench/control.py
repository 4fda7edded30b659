"""Readings of the comparison that decides ``correct``, at a cell's own size.

    python3 sortbench/control.py --workload <name> --program-seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3]

In one process: the benchmark's run of the cell (``harness.run``: its
pool, warm-up, a short window of its own closed loop, the comparison of
the kept answers) once for each program seed, then the same with the
control (``reference.control_sort``, the reference with its keys
compared in the next lower precision) in the program's place, once for
each control seed.  Prints one JSON line a seed
and a summary: the largest reading of the program's seeds (the lower
reading) and the smallest of the control's (the upper).  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from sortbench import harness, reference  # noqa: E402


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    bench = harness.Bench.load()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    seeds = {"program": [int(s) for s in args.program_seeds.split(",") if s],
             "control": [int(s) for s in args.control_seeds.split(",") if s]}
    rows: dict[str, list[dict]] = {"program": [], "control": []}
    for side in ("program", "control"):
        if not seeds[side]:
            continue
        call = (harness.program(cell, "cuda") if side == "program"
                else lambda x, tracer=None: reference.control_sort(x))
        for seed in seeds[side]:
            out = harness.run(bench, cell, seed, args.seconds, False, time.perf_counter(),
                              make_call=lambda c, d: call)
            row = {"workload": cell.name, "side": side, "seed": seed,
                   "calls": out["attempted"], "failed": out["failed"],
                   **{k: c["value"] for k, c in out["checks"].items()}}
            rows[side].append(row)
            print(json.dumps(row), flush=True)
        del call
        torch.cuda.empty_cache()
    summary = {"workload": cell.name, "card": harness.card_line(),
               "lower": max((r["mismatched_keys"] for r in rows["program"]), default=None),
               "upper": min((r["mismatched_keys"] for r in rows["control"]), default=None),
               "program_seeds": len(rows["program"]),
               "control_seeds": len(rows["control"])}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
