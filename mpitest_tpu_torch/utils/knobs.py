"""Env-knob registry of the port — the one place it reads the environment.

A subset of the reference registry (``mpitest_tpu/utils/knobs.py``): the
knobs the sort paths, the external sort, the key-file CLI and its readers
read, with the same names, defaults and message contract.  A bad value
raises :class:`KnobError` (a ``ValueError``) whose text names the knob and
the accepted values.
"""

from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

__all__ = ["Knob", "KnobError", "NotPortedError", "get", "register"]


class KnobError(ValueError):
    """A knob's value failed validation; the message starts with
    ``NAME=<raw!r>``."""


class NotPortedError(KnobError):
    """A knob or argument named a reference feature this package does not
    carry yet."""


@dataclass(frozen=True)
class Knob:
    """One registered environment knob."""

    name: str
    default: Any                  # typed default returned when unset
    doc: str
    parse: Callable[[str], Any]   # raw string -> typed value; raises KnobError

    def read(self) -> Any:
        raw = os.environ.get(self.name)
        return self.default if raw is None else self.parse(raw)


_REGISTRY: dict[str, Knob] = {}


def register(name: str, default: Any, doc: str,
             parse: Callable[[str], Any]) -> None:
    if name in _REGISTRY:
        raise ValueError(f"knob {name} registered twice")
    _REGISTRY[name] = Knob(name, default, doc, parse)


def get(name: str) -> Any:
    """Typed, validated value of registered knob ``name`` (its default
    when unset); ``KeyError`` for unregistered names."""
    return _REGISTRY[name].read()


def _flag(name: str) -> Callable[[str], bool]:
    def parse(raw: str) -> bool:
        if raw not in ("0", "1"):
            raise KnobError(f"{name}={raw!r}: use '1' or '0'")
        return raw == "1"
    return parse


LOCAL_ENGINES = ("auto", "bitonic", "lax", "radix_pallas")


def _parse_local_engine(raw: str) -> str:
    if raw == "radix_pallas_interpret":
        # the Pallas interpreter twin has no counterpart: on a card the
        # engine is the kernel, on the CPU its plain version
        raise KnobError(
            f"SORT_LOCAL_ENGINE={raw!r}: the interpreter twin has no "
            "counterpart here; use 'radix_pallas' (the kernel on a card, its "
            f"plain version on the CPU) or one of {LOCAL_ENGINES}")
    if raw not in LOCAL_ENGINES:
        raise KnobError(f"SORT_LOCAL_ENGINE={raw!r}; use one of {LOCAL_ENGINES}")
    return raw


def _int(name: str, lo: int) -> Callable[[str], int]:
    def parse(raw: str) -> int:
        try:
            v = int(raw)
        except ValueError:
            v = lo - 1
        if v < lo:
            raise KnobError(f"{name}={raw!r}: use an integer >= {lo}")
        return v
    return parse


def _float_at_least(name: str, lo: float) -> Callable[[str], float]:
    def parse(raw: str) -> float:
        try:
            v = float(raw)
        except ValueError:
            v = math.nan
        if not math.isfinite(v) or v < lo:
            raise KnobError(f"{name}={raw!r}: use a finite number >= {lo:g}")
        return v
    return parse


def _enum(name: str, choices: tuple[str, ...],
          err: str | None = None) -> Callable[[str], str]:
    def parse(raw: str) -> str:
        if raw not in choices:
            raise KnobError(err.format(name=name, raw=raw) if err else
                            f"{name}={raw!r}; use one of {choices}")
        return raw
    return parse


def _parse_dtype(raw: str) -> Any:
    from mpitest_tpu_torch.ops.keys import codec_for
    try:
        # np.dtype raises TypeError/ValueError/SyntaxError depending on the
        # garbage; codec_for rejects valid-but-unsupported dtypes with the
        # supported list in the message
        return codec_for(raw).dtype
    except Exception as e:
        raise KnobError(f"SORT_DTYPE={raw!r}: {e}") from None


def _parse_positive_or_unset(name: str, msg: str) -> Callable[[str], int | None]:
    def parse(raw: str) -> int | None:
        if raw == "":
            return None
        try:
            v = int(raw)
        except ValueError:
            v = 0
        if v < 1:
            raise KnobError(f"{name}={raw!r}: {msg}")
        return v
    return parse


def _parse_digit_bits(raw: str) -> int | None:
    if raw == "auto":
        return None
    try:
        v = int(raw)
    except ValueError:
        v = 0
    if not 1 <= v <= 16:
        raise KnobError(f"SORT_DIGIT_BITS={raw!r}: use 'auto' or an "
                        "integer in [1, 16]") from None
    return v


def _passthrough(raw: str) -> str:
    return raw


register("SORT_LOCAL_ENGINE", "auto",
         "Local sort engine; auto = bitonic CUDA kernels for n >= 2^13, "
         "radix_pallas = the fused radix kernel (K4) for <= 2^20 keys.",
         _parse_local_engine)
register("SORT_VERIFY", True,
         "Always-on output verification (sortedness + fingerprint).",
         _flag("SORT_VERIFY"))

# The key-file CLI (cli.py) and its readers (utils/io.py).
register("SORT_ALGO", "sample",
         "Sort algorithm the CLI dispatches (reference default: sample).",
         _enum("SORT_ALGO", ("sample", "radix"),
               err="{name}={raw!r}: use 'sample' or 'radix'"))
register("SORT_DTYPE", np.dtype(np.int32),
         "Key dtype for text inputs (int32/uint32/int64/uint64/f32/f64).",
         _parse_dtype)
register("SORT_RANKS", None,
         "Mesh size (ranks) of the CLI's sort; ranks share the cards round-robin.",
         _parse_positive_or_unset("SORT_RANKS", "use a positive integer"))
register("SORT_DIGIT_BITS", None,
         "Radix digit width of the CLI's debug>2 per-pass dump; auto picks.",
         _parse_digit_bits)
register("SORT_NATIVE_ENCODE", "auto",
         "Native C text parser (utils/native_encode.py): auto | on | off.",
         _enum("SORT_NATIVE_ENCODE", ("auto", "on", "off")))
register("SORT_INGEST", "auto",
         "Ingest pipeline selector; auto streams inputs above ~32 MiB.",
         _enum("SORT_INGEST", ("auto", "stream", "mono")))
register("SORT_INGEST_CHUNK", None,
         "Keys per streamed ingest chunk and per text-parse chunk "
         "(default 2^22).",
         _int("SORT_INGEST_CHUNK", 1))
register("SORT_INGEST_THREADS", 2,
         "Host parse/encode worker threads (text parse, ingest encode).",
         _int("SORT_INGEST_THREADS", 1))
register("SORT_DONATE", "auto",
         "Drop the staged word tensors once the sort's first dispatch has "
         "read them (auto: on a CUDA device).",
         _enum("SORT_DONATE", ("auto", "1", "0"),
               err="{name}={raw!r}: use 'auto', '1' or '0'"))
register("SORT_MEM_BUDGET", 0,
         "Byte budget the external sort partitions against; the CLI sorts a "
         "file above it out of core (0 = unlimited).",
         _int("SORT_MEM_BUDGET", 0))

# The out-of-core external sort (store/).
register("SORT_SPILL_DIR", None,
         "Directory spill runs are staged in (default: a per-process tmp dir).",
         _passthrough)
register("SORT_MERGE_FANIN", 16,
         "Maximum runs merged per k-way merge pass; more runs merge in "
         "several passes through intermediate runs.",
         _int("SORT_MERGE_FANIN", 2))
register("SORT_SPILL_COMPRESS", "auto",
         "SORTRUN2 compression of spill runs: auto = when the native codec "
         "loads, on = always (numpy codec without it), off = raw runs.",
         _enum("SORT_SPILL_COMPRESS", ("auto", "on", "off")))
register("SORT_SPILL_THROTTLE_MBPS", 0.0,
         "Simulated spill-disk bandwidth cap in MB/s, shared by every spill "
         "reader and writer of the process (0 = unthrottled).",
         _float_at_least("SORT_SPILL_THROTTLE_MBPS", 0.0))
register("SORT_RESUME", "auto",
         "Crash resume of dataset-keyed external sorts from their journaled "
         "manifest (auto) or neither journal nor resume (off).",
         _enum("SORT_RESUME", ("auto", "off")))
register("SORT_SPILL_GC_AGE_S", 3600,
         "Minimum age in seconds before the startup GC reclaims an orphaned "
         "spill file that no live manifest names.",
         _int("SORT_SPILL_GC_AGE_S", 0))

EXCHANGE_ENGINES = ("auto", "lax", "pallas")


def _parse_exchange_engine(raw: str) -> str:
    if raw == "pallas_interpret":
        raise KnobError(
            f"SORT_EXCHANGE_ENGINE={raw!r}: the interpreter twin has no "
            "counterpart here; use 'pallas' (the kernels on a card, their "
            f"plain versions on the CPU) or one of {EXCHANGE_ENGINES}")
    if raw not in EXCHANGE_ENGINES:
        raise KnobError(f"SORT_EXCHANGE_ENGINE={raw!r}; use one of {EXCHANGE_ENGINES}")
    return raw


def _parse_devices(raw: str) -> int | None:
    if raw == "auto":
        return None
    try:
        v = int(raw)
    except ValueError:
        v = 0
    if v < 1:
        raise KnobError(f"SORT_DEVICES={raw!r}: use 'auto' or an "
                        "integer >= 1") from None
    return v


def _float_above(name: str, lo: float, what: str) -> Callable[[str], float]:
    def parse(raw: str) -> float:
        try:
            v = float(raw)
        except ValueError:
            v = lo
        # isfinite: 'nan' passes a <= gate and 'inf' overflows int()
        if not math.isfinite(v) or v <= lo:
            raise KnobError(f"{name}={raw!r}: use {what}")
        return v
    return parse


# The distributed sorts (models/api.py, models/supervisor.py).
register("SORT_EXCHANGE_ENGINE", "auto",
         "Exchange engine; auto = pallas (fused pack K6 + all-to-all K7); "
         "lax = pack K5 + per-block copies.",
         _parse_exchange_engine)
register("SORT_DEVICES", None,
         "Mesh rank count when none is passed explicitly (auto: one per card).",
         _parse_devices)
register("SORT_NEGOTIATE", "auto",
         "Exchange-capacity negotiation from a count probe (auto: P>1).",
         _enum("SORT_NEGOTIATE", ("auto", "on", "off")))
register("SORT_RESTAGE", "auto",
         "Skew-aware re-stage (shard interleave) on exchange imbalance.",
         _enum("SORT_RESTAGE", ("auto", "off")))
register("SORT_RESTAGE_RATIO", 4.0,
         "Per-peer max/fair-share count ratio that triggers a re-stage.",
         _float_above("SORT_RESTAGE_RATIO", 1.0, "a finite number > 1"))
register("SORT_CAP_FACTOR", 2.0,
         "Exchange cap as a multiple of the fair per-peer share.",
         _float_above("SORT_CAP_FACTOR", 0.0, "a finite number > 0"))
register("SORT_OVERSAMPLE", None,
         "Samples per shard for sample sort's splitter selection (default 2P-1).",
         _parse_positive_or_unset("SORT_OVERSAMPLE", "use an integer >= 1"))

# Observability sidecar paths (off when unset: the byte-compatible CLI
# contract is untouched by default).
register("SORT_TRACE", None,
         "Stream the structured span log as JSONL to this path.",
         _passthrough)
register("SORT_TRACE_CHROME", None,
         "Write the run's Chrome trace-event JSON (Perfetto) here.",
         _passthrough)
register("SORT_METRICS", None,
         "Append one JSON metrics sidecar line per run to this path.",
         _passthrough)
register("SORT_PROFILE", None,
         "Capture a torch.profiler trace of the sort (CUDA activity on a "
         "card) into this logdir.",
         _passthrough)


def _parse_sample(raw: str) -> float:
    try:
        v = float(raw)
    except ValueError:
        v = 0.0
    if not (math.isfinite(v) and 0.0 < v <= 1.0):
        raise KnobError(f"SORT_TRACE_SAMPLE={raw!r}: use a number in "
                        "(0, 1]")
    return v


register("SORT_TRACE_SAMPLE", 1.0,
         "Down-sample the SORT_TRACE stream: keep ~this fraction of "
         "top-level spans (whole subtrees; the flight recorder still sees "
         "everything).",
         _parse_sample)
register("SORT_FLIGHT_RECORDER_SIZE", 2048,
         "Flight-recorder ring capacity: recent spans kept in memory for "
         "incident dumps on typed errors (0 disables).",
         _int("SORT_FLIGHT_RECORDER_SIZE", 0))
# the reference's /tmp/mpitest_flightrec, under the process's TMPDIR
register("SORT_FLIGHT_RECORDER_DIR",
         os.path.join(tempfile.gettempdir(), "mpitest_flightrec"),
         "Directory flight-recorder dump artifacts land in.",
         _passthrough)

# A reference knob whose subsystem is not ported: the CLI refuses to run
# with it set rather than silently ignore it.
register("SORT_FAULTS", None, "Fault-injection plan (not ported).", _passthrough)
