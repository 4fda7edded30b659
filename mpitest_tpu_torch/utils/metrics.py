"""Structured metrics sidecar (port of ``mpitest_tpu/utils/metrics.py``).

The reference program's machine-readable surface is two text lines
(stdout median probe, stderr elapsed seconds, ``mpi_sample_sort.c:205,
207``).  This is the structured counterpart: throughput (Mkeys/s),
per-phase milliseconds, counters, bytes moved and the achieved exchange
bandwidth, one JSON object per run (``SORT_METRICS``).

Phase times are host wall time.  ``exchange_gb_per_s`` divides
``exchange_bytes`` by phase ``sort``; that phase closes after the card
finishes only where the code inside it reads a result back to the host
(the distributed sorts read the exchange's overflow count, the pair
engine its residual flag).  The one-rank one-word path reads nothing back
inside the phase, and moves no exchange bytes either.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field


@dataclass
class Metrics:
    """Accumulates named measurements; one JSON object out."""

    config: dict = field(default_factory=dict)
    values: dict = field(default_factory=dict)

    def record(self, name: str, value, unit: str | None = None) -> None:
        self.values[name] = {"value": value, **({"unit": unit} if unit else {})}

    def record_phases(self, phases: dict[str, float]) -> None:
        """Fold a Tracer's phase→seconds map in as per-phase milliseconds."""
        for name, secs in phases.items():
            self.record(f"phase_{name}_ms", round(secs * 1e3, 3), "ms")

    def record_tracer(self, tracer) -> None:
        """Fold one run's Tracer in: phases, counters, and the achieved
        exchange bandwidth.  The denominator is the tracer's "sort" phase
        (the distributed program's span, compute included; the per-kernel
        breakdown lives in a SORT_PROFILE trace).  Pass a per-run Tracer:
        one accumulated across R runs inflates every value R-fold."""
        self.record_phases(tracer.phases)
        for name, v in tracer.counters.items():
            self.record(name, v)
        xbytes = tracer.counters.get("exchange_bytes", 0)
        sort_s = tracer.phases.get("sort")
        if xbytes and sort_s:
            self.bandwidth("exchange_gb_per_s", int(xbytes), sort_s)

    def throughput(self, name: str, n_keys: int, seconds: float) -> float:
        mkeys = n_keys / seconds / 1e6
        self.record(name, round(mkeys, 3), "Mkeys/s")
        return mkeys

    def bandwidth(self, name: str, n_bytes: int, seconds: float) -> float:
        gbs = n_bytes / seconds / 1e9
        self.record(name, round(gbs, 3), "GB/s")
        return gbs

    def to_json(self) -> str:
        return json.dumps(
            {"ts": time.time(), "config": self.config, "metrics": self.values}
        )

    def dump(self, path: str | None = None) -> None:
        """Append one JSON line to ``path``, or stderr when no path given."""
        line = self.to_json()
        if path:
            with open(path, "a") as f:
                f.write(line + "\n")
        else:
            print(line, file=sys.stderr)
