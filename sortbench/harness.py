"""One run of one cell of the benchmark of ``mpitest_tpu_torch``.

    python3 sortbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: ``BENCHMARK.json`` at the
root names the cell, its configuration file and its traffic mix
(``sortbench/traffic/<traffic>.json``); each metric is read by
``sortbench/e2e/<name>.py`` (end to end) or ``sortbench/metrics/<name>.py``
(per layer), a module with ``read(...) -> float | None``; the kernel
stages are the pattern files of ``sortbench/stages/``.  A new cell, mix,
metric or stage pattern is a new file and a new entry, never an edit of a
file; a metric with no ``workloads`` list is reported by every cell, and a
cell joins a metric that has one by adding its name to that list.

A run: check the cards, make the key pool on the card from the seed,
build the program's call, warm it up on every array of the pool, then
call it back to back for ``--seconds`` (a closed loop: one caller, no
think time; each call ends with the result on the card and
``torch.cuda.synchronize()``), keeping a sample of the answers drawn from
the seed.  With ``--trace 1`` a few more calls run under
``torch.profiler``.  Then the sampled answers are decoded by the program
and compared with the plain reference (``sortbench/reference.py``), and
one JSON line is printed: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, (``breakdown``), ``card``, ``engines`` and, last,
``checks``: each number compared beside its limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import torch

from sortbench import generator, reference, tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level module names that a run may not load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "mpitest_tpu")

#: The program's counters that say which engines a call ran.
ENGINE_COUNTERS = ("local_engine", "exchange_engine", "digit_bits", "exchange_passes")

#: Limits of the numbers compared (exact comparison: nothing may differ).
LIMITS = {"mismatched_keys": 0, "failed_calls": 0}


@dataclass
class Cell:
    name: str
    chips: int
    config: dict[str, Any]
    traffic: dict[str, Any]

    @property
    def keys(self) -> int:
        return 1 << int(self.config["log2_n"])

    @property
    def key_bytes(self) -> int:
        return self.keys * generator.DTYPES[self.config["dtype"]].itemsize


@dataclass
class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    root: Path
    spec: dict[str, Any]

    @classmethod
    def load(cls, root: Path = ROOT) -> "Bench":
        return cls(root, json.loads((root / "BENCHMARK.json").read_text()))

    @property
    def home(self) -> Path:
        return self.root / HERE.name

    def cell(self, name: str) -> Cell:
        w = next((w for w in self.spec["workloads"] if w["name"] == name), None)
        if w is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        c = next(c for c in self.spec["configs"] if c["name"] == w["config"])
        config = json.loads((self.root / c["file"]).read_text())
        traffic = json.loads((self.home / "traffic" / f"{w['traffic']}.json").read_text())
        if (traffic.get("loop"), traffic.get("callers"), traffic.get("think_ms")) != ("closed", 1, 0):
            raise ValueError(f"traffic {w['traffic']!r}: this harness drives one caller "
                             "in a closed loop with no think time")
        return Cell(name, int(w["chips"]), config, traffic)

    def metrics(self, cell: str, kind: str) -> list[dict[str, Any]]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
        return [m for m in self.spec[kind] if cell in m.get("workloads", [cell])]

    def reader(self, kind: str, name: str) -> Callable[..., float | None]:
        """``read`` of ``sortbench/e2e/<name>.py`` or ``sortbench/metrics/<name>.py``."""
        path = self.home / ("e2e" if kind == "end_to_end" else "metrics") / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"sortbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def stages(self) -> dict[str, list[str]]:
        return tracing.read_stages(self.home / "stages")

    def peaks(self, kind: str) -> dict[str, float] | None:
        table = json.loads((self.home / "peaks.json").read_text())
        return table.get(kind)


@dataclass
class Window:
    """What the measured window did, for the end-to-end readers."""

    setup_s: float
    keys_per_call: int
    t_start: float = 0.0
    t_last: float = 0.0
    calls: int = 0
    failed: int = 0
    keys: int = 0
    footprint_bytes: list[int] = field(default_factory=list)
    latencies_s: list[float] = field(default_factory=list)
    peak_bytes: int = 0
    errors: list[str] = field(default_factory=list)
    #: the program's counters of the last call (its engines)
    counters: dict[str, Any] = field(default_factory=dict)


def program(cell: Cell, device: str) -> Callable[[torch.Tensor, Any], Any]:
    """The call under test: ``mpitest_tpu_torch.sort`` of one device-resident
    array, verification as the program has it (on by default), the result
    left on the card."""
    import mpitest_tpu_torch as port

    ranks = int(cell.config["ranks"])
    if ranks > 1:
        kw: dict[str, Any] = {"mesh": port.make_mesh(ranks) if device == "cuda"
                              else port.make_mesh(ranks, devices=[device] * ranks)}
    else:
        kw = {} if device == "cuda" else {"device": device}
    algorithm = cell.traffic["algorithm"]

    def call(x: torch.Tensor, tracer: Any = None) -> Any:
        return port.sort(x, algorithm, tracer=tracer, return_result=True, **kw)

    return call


def new_tracer() -> Any:
    from mpitest_tpu_torch.utils.trace import Tracer

    return Tracer()


class Card:
    """Synchronisation and memory readings of the cards a run uses (none on
    the CPU, where a test drives the run)."""

    def __init__(self, device: str, chips: int) -> None:
        self.cuda = device == "cuda"
        self.ids = list(range(chips)) if self.cuda else []

    def sync(self) -> None:
        for i in self.ids:
            torch.cuda.synchronize(i)

    def start(self) -> list[int]:
        """Reset the peaks; the bytes each card holds now."""
        for i in self.ids:
            torch.cuda.reset_peak_memory_stats(i)
        return [torch.cuda.memory_allocated(i) for i in self.ids]

    def peaks(self) -> list[int]:
        return [torch.cuda.max_memory_allocated(i) for i in self.ids]


def run_window(call: Callable[[torch.Tensor, Any], Any], pool: list[torch.Tensor],
               seconds: float, card: Card, win: Window, rng: random.Random,
               keep: int, profiled: int = 0
               ) -> tuple[list[tuple[int, Any]], tracing.Capture | None]:
    """Call back to back for ``seconds``, the first ``profiled`` calls under
    ``torch.profiler``; returns the answers kept, a uniform sample of
    ``keep`` calls of the window drawn by ``rng`` (reservoir sampling), as
    ``(pool index, result)``, and the profile."""
    kept: list[tuple[int, Any]] = []
    input_bytes = pool[0].numel() * pool[0].element_size()
    rec = tracing.Recorder() if profiled else None
    cap = None
    win.t_start = time.perf_counter()
    deadline = win.t_start + seconds
    i = 0
    while i == 0 or time.perf_counter() < deadline or (rec and i < profiled):
        p = i % len(pool)
        held = card.start()
        t0 = time.perf_counter()
        tracer = new_tracer()

        def one() -> Any:
            out = call(pool[p], tracer)
            card.sync()
            return out

        try:
            res = rec.call(one, tracer) if rec else one()
        except Exception:  # noqa: BLE001 — a failed call is counted, the loop goes on
            win.failed += 1
            win.errors.append(traceback.format_exc(limit=3))
            res = None
        if rec and i + 1 == profiled:
            cap, rec = rec.stop(), None
        i += 1
        if res is None:
            continue
        t1 = time.perf_counter()
        win.t_last = t1
        win.calls += 1
        win.keys += win.keys_per_call
        win.latencies_s.append(t1 - t0)
        win.counters = tracer.counters
        peaks = card.peaks()
        win.peak_bytes = max([win.peak_bytes, *peaks])
        # the call's own footprint on its fullest card: the peak less what
        # the card held before the call, the call's input counted in (the
        # pool's other arrays and the kept answers not)
        win.footprint_bytes.append(max((pk - h for pk, h in zip(peaks, held)), default=0)
                                   + input_bytes)
        if len(kept) < keep:
            kept.append((p, res))
        else:
            j = rng.randrange(i)
            if j < keep:
                kept[j] = (p, res)
        del res
    return kept, cap


def check(answers: list[tuple[int, Any]], pool: list[torch.Tensor]) -> dict[str, int]:
    """Compare every kept answer, decoded to host keys by the program, with
    the reference's sort of the same pool array."""
    want: dict[int, torch.Tensor] = {}
    bad = 0
    for p, res in answers:
        if p not in want:
            want[p] = reference.sorted_keys(pool[p])
        bad += reference.count_mismatches(res.to_numpy(), want[p])
    return {"mismatched_keys": bad, "answers_checked": len(answers)}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(k for k in list(sys.modules) if k.split(".")[0] in FORBIDDEN)


def run(bench: Bench, cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda",
        make_call: Callable[[Cell, str], Callable[[torch.Tensor, Any], Any]] = program,
        ) -> dict[str, Any]:
    """One run of ``cell``; returns the result line's object."""
    marks = [time.perf_counter()]
    card = Card(device, cell.chips)
    traffic = cell.traffic
    pool = generator.make_pool(cell.config, traffic, seed, device)
    card.sync()
    marks.append(time.perf_counter())
    call = make_call(cell, device)
    marks.append(time.perf_counter())
    rng = random.Random(seed)
    keep = int(traffic["check_calls"])
    # warm-up: every array of the pool, and as many answers held at once
    # as the window keeps, so the allocator has grown to the window's size
    held = [call(pool[i % len(pool)], new_tracer())
            for i in range(max(len(pool), keep + 1))]
    card.sync()
    del held
    marks.append(time.perf_counter())
    win = Window(setup_s=marks[3] - t0, keys_per_call=cell.keys)
    answers, cap = run_window(call, pool, seconds, card, win, rng, keep,
                              int(traffic["trace_calls"]) if trace else 0)
    out: dict[str, Any] = {}
    metrics: dict[str, Any] = {}
    prof = None
    if cap is not None:
        prof = tracing.reduce(cap, bench.stages(), key_bytes=cell.key_bytes,
                              ranks=int(cell.config["ranks"]), chips=cell.chips,
                              peaks=bench.peaks(device_kind(device)))
        source, kind = prof, "per_layer"
    else:
        source, kind = win, "end_to_end"
    for m in bench.metrics(cell.name, kind):
        value = bench.reader(kind, m["name"])(source)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    engines = {k: win.counters[k] for k in ENGINE_COUNTERS if k in win.counters}
    del call
    t_check = time.perf_counter()
    checks = check(answers, pool)
    print(f"run setup_s {win.setup_s:.3f} (to run {marks[0] - t0:.3f}, keys "
          f"{marks[1] - marks[0]:.3f}, program {marks[2] - marks[1]:.3f}, warm-up "
          f"{marks[3] - marks[2]:.3f}) window_s {win.t_last - win.t_start:.3f} "
          f"calls {win.calls} check_s {time.perf_counter() - t_check:.3f}", file=sys.stderr)
    del answers, pool
    checks["failed_calls"] = win.failed
    correct = (win.failed == 0 and checks["answers_checked"] >= 1
               and checks["mismatched_keys"] <= LIMITS["mismatched_keys"])
    out["correct"] = correct
    out["attempted"] = win.calls + win.failed
    out["failed"] = win.failed
    out["metrics"] = metrics
    dev: dict[str, Any] = {"platform": "gpu" if card.cuda else device,
                           "kind": device_kind(device), "count": cell.chips,
                           "memory_peak_bytes": win.peak_bytes}
    if prof is not None:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
    out["device"] = dev
    if prof is not None:
        out["breakdown"] = {"device_ops": prof.device_ops, "idle_gaps": prof.idle_gaps}
        out["stage_kernels"] = {str(k): v for k, v in prof.stage_kernels.items()}
    out["card"] = card_line() if card.cuda else device
    out["engines"] = engines
    if win.errors:
        out["errors"] = win.errors[:3]
    out["checks"] = {
        "mismatched_keys": {"value": checks["mismatched_keys"],
                            "limit": LIMITS["mismatched_keys"]},
        "failed_calls": {"value": checks["failed_calls"], "limit": LIMITS["failed_calls"]},
        "answers_checked": {"value": checks["answers_checked"], "at_least": 1},
    }
    return out


def device_kind(device: str) -> str:
    return torch.cuda.get_device_name(0) if device == "cuda" else device


def report(out: dict[str, Any]) -> None:
    """The metrics, each beside the card and its power limit, then the
    compared numbers, as the last lines on standard error."""
    for name, m in out["metrics"].items():
        print(f"metric {name} {m['value']} {m['unit']} ({out['card']})", file=sys.stderr)
    for name, c in out["checks"].items():
        lim = f"limit {c['limit']}" if "limit" in c else f"at least {c['at_least']}"
        print(f"check {name} {c['value']} {lim}", file=sys.stderr)


def parse(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="sortbench/run.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs() -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))


def main(argv: list[str], t0: float) -> int:
    args = parse(argv)
    cache_dirs()
    bench = Bench.load()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run(bench, cell, args.seed, args.seconds, bool(args.trace), t0)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    report(out)
    print(json.dumps(out), flush=True)
    return 0
