"""Env-knob registry of the port — the one place it reads the environment.

A subset of the reference registry (``mpitest_tpu/utils/knobs.py``): the
knobs the sort paths, the external sort, the key-file CLI and its readers,
and the sort server (``serve/``) read, with the same names, defaults and
message contract.  A bad value raises :class:`KnobError` (a
``ValueError``) whose text names the knob and the accepted values;
:func:`validate` parses a list of them up front (the drivers' fail-fast
``[ERROR]`` line), :func:`iter_knobs` and :func:`get_raw` serve the
server's ``/varz`` view of what was set.
"""

from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np

__all__ = ["Knob", "KnobError", "get", "get_raw", "iter_knobs", "register",
           "validate"]


class KnobError(ValueError):
    """A knob's value failed validation; the message starts with
    ``NAME=<raw!r>``."""


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


def get_raw(name: str) -> str | None:
    """The raw (unparsed) string value of a registered knob, or None when
    unset; ``KeyError`` for unregistered names, like :func:`get`."""
    return os.environ.get(_REGISTRY[name].name)


def validate(*names: str) -> None:
    """Fail-fast parse of the named knobs (every registered knob when none
    is named): garbage in any of them raises :class:`KnobError` here, not
    in the middle of a sort."""
    for name in names or tuple(_REGISTRY):
        _REGISTRY[name].read()


def iter_knobs() -> Iterator[Knob]:
    """Registered knobs in name order."""
    for name in sorted(_REGISTRY):
        yield _REGISTRY[name]


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


def _float_at_least(name: str, lo: float,
                    note: str | None = None) -> Callable[[str], float]:
    def parse(raw: str) -> float:
        try:
            v = float(raw)
        except ValueError:
            v = math.nan
        if not math.isfinite(v) or v < lo:
            extra = f" ({note})" if note else ""
            raise KnobError(f"{name}={raw!r}: use a finite number >= {lo:g}{extra}")
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

# Robustness knobs (models/supervisor.py + faults.py), with the
# reference's defaults and messages.
register("SORT_MAX_RETRIES", 2,
         "Dispatch retry budget for transient launch failures.",
         _int("SORT_MAX_RETRIES", 0))
register("SORT_RETRY_BACKOFF", 0.05,
         "Base seconds of exponential dispatch-retry backoff.",
         _float_at_least("SORT_RETRY_BACKOFF", 0.0))
register("SORT_FALLBACK", True,
         "Graceful-degradation ladder (engines, other algorithm, then host "
         "sort).",
         _flag("SORT_FALLBACK"))


def _parse_faults(raw: str) -> str | None:
    if not raw:
        return None
    from mpitest_tpu_torch import faults
    faults.FaultRegistry(raw)  # raises ValueError with the site list
    return raw


register("SORT_FAULTS", None,
         "Deterministic fault-injection plan (mpitest_tpu_torch/faults.py).",
         _parse_faults)


def _parse_faults_seed(raw: str) -> int:
    try:
        return int(raw)
    except ValueError:
        raise KnobError(f"SORT_FAULTS_SEED={raw!r}: use an integer") from None


register("SORT_FAULTS_SEED", 0,
         "Seed of the splitmix64 stream fault corruption values draw from.",
         _parse_faults_seed)
register("SORT_FAULT_STALL_MS", 250,
         "Milliseconds the dispatch_stall and merge_stall fault sites block "
         "the dispatching or merging thread.",
         _int("SORT_FAULT_STALL_MS", 1))
register("SORT_FAULT_ENOSPC_AT", 1,
         "Which spill write (1-based, counted per registry) the armed "
         "spill_enospc fault site fails with ENOSPC.",
         _int("SORT_FAULT_ENOSPC_AT", 1))

# Plan provenance (models/plan.py) and the self-tuning planner
# (models/planner.py), with the reference's defaults and messages.
register("SORT_PLAN", "on",
         "Decision provenance: mint SortPlan records, emit sort.plan spans "
         "and the plan-regret counters (off = no plan record).",
         _enum("SORT_PLAN", ("on", "off")))


def _parse_hysteresis(raw: str) -> float:
    try:
        v = float(raw)
    except ValueError:
        v = 0.0
    if not math.isfinite(v) or v <= 1.0:
        raise KnobError(f"SORT_PLANNER_HYSTERESIS={raw!r}: use a finite "
                        "number > 1")
    return v


register("SORT_PLANNER", "off",
         "Self-tuning planner: off = hand-set defaults, shadow = compute and "
         "log every policy choice without acting, on = act "
         "(models/planner.py).",
         _enum("SORT_PLANNER", ("off", "shadow", "on")))
register("SORT_PLANNER_WINDOW", 256,
         "Rolling look-back of the planner's learning policies: flight-ring "
         "plan records (cap margin) / request arrivals (serve tuner).",
         # 16 = planner.MIN_OBSERVATIONS: a smaller window would validate
         # but behave as 16
         _int("SORT_PLANNER_WINDOW", 16))
register("SORT_PLANNER_HYSTERESIS", 1.5,
         "Minimum up/down ratio a serve-tuner recommendation must differ by "
         "before it may commit.",
         _parse_hysteresis)


# The sort server (serve/ and sort_server.py), with the reference's
# defaults and messages; the drivers validate them fail-fast at startup.


def _int_in(name: str, lo: int, hi: int, msg: str) -> Callable[[str], int]:
    def parse(raw: str) -> int:
        try:
            v = int(raw)
        except ValueError:
            v = lo - 1
        if not lo <= v <= hi:
            raise KnobError(f"{name}={raw!r}: {msg}") from None
        return v
    return parse


def _parse_buckets(raw: str) -> tuple[int, ...]:
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            v = int(part)
        except ValueError:
            v = 0
        if not 1 <= v <= 30:
            raise KnobError(
                f"SORT_SERVE_SHAPE_BUCKETS={raw!r}: use a comma list of "
                "log2 bucket sizes in [1, 30]") from None
        out.append(v)
    if not out:
        raise KnobError(f"SORT_SERVE_SHAPE_BUCKETS={raw!r}: use a comma "
                        "list of log2 bucket sizes in [1, 30]")
    return tuple(sorted(set(out)))


register("SORT_SERVE_PORT", 7077,
         "TCP port the sort server listens on (0 = ephemeral).",
         _int_in("SORT_SERVE_PORT", 0, 65535,
                 "use an integer in [0, 65535] (0 = ephemeral)"))
register("SORT_SERVE_HOST", "127.0.0.1",
         "Address the sort server binds (default loopback).",
         _passthrough)
register("SORT_SERVE_MAX_INFLIGHT", 64,
         "Admission bound: concurrent in-flight requests before typed "
         "backpressure rejection.",
         _int("SORT_SERVE_MAX_INFLIGHT", 1))
register("SORT_SERVE_MAX_BYTES", 1 << 28,
         "Admission bound: total in-flight request payload bytes.",
         _int("SORT_SERVE_MAX_BYTES", 1))
register("SORT_SERVE_BATCH_WINDOW_MS", 2.0,
         "Batching window: how long a dispatch waits to pack more small "
         "requests (0 = dispatch each alone).",
         _float_at_least("SORT_SERVE_BATCH_WINDOW_MS", 0.0,
                         note="0 disables packing"))
register("SORT_SERVE_BATCH_KEYS", 1 << 16,
         "Requests up to this many keys are batchable; one packed dispatch "
         "carries at most this many keys.",
         _int("SORT_SERVE_BATCH_KEYS", 1))
# every bucket the packed path can request: bucket_for() floors at 2^10
# and a packed dispatch carries at most SORT_SERVE_BATCH_KEYS (2^16) keys
register("SORT_SERVE_SHAPE_BUCKETS", (10, 11, 12, 13, 14, 15, 16),
         "Power-of-two shape buckets the executor cache warms at server "
         "startup.",
         _parse_buckets)
register("SORT_SERVE_PREWARM", "auto",
         "Warm the executor cache (and build the kernels) at startup "
         "(off = on first use).",
         _enum("SORT_SERVE_PREWARM", ("auto", "off")))
register("SORT_SERVE_ALLOW_FAULTS", False,
         "Honor per-request fault-injection specs (test mode only; "
         "production servers reject them as bad requests).",
         _flag("SORT_SERVE_ALLOW_FAULTS"))
register("SORT_SERVE_IDLE_TIMEOUT_S", 300.0,
         "Per-connection idle bound: seconds a keep-alive connection may "
         "sit between requests before the server closes it.",
         _float_above("SORT_SERVE_IDLE_TIMEOUT_S", 0.0, "a finite number > 0"))
register("SORT_SERVE_READ_TIMEOUT_S", 30.0,
         "Total wire-read budget per request (payload reads, rejected-"
         "payload drains, response writes).",
         _float_above("SORT_SERVE_READ_TIMEOUT_S", 0.0, "a finite number > 0"))
register("SORT_SERVE_DISPATCH_TIMEOUT_S", 120.0,
         "Dispatch watchdog bound: a single dispatch exceeding this trips "
         "the circuit breaker (healthz 503, fast typed rejections).",
         _float_at_least("SORT_SERVE_DISPATCH_TIMEOUT_S", 0.0,
                         note="0 disables the watchdog"))
register("SORT_SERVE_BREAKER_BACKOFF_S", 5.0,
         "Seconds the tripped circuit breaker stays open before half-opening "
         "with a probe request (doubles per failed probe).",
         _float_above("SORT_SERVE_BREAKER_BACKOFF_S", 0.0, "a finite number > 0"))
register("SORT_SERVE_COMPLETION_TIMEOUT_S", 600.0,
         "Backstop bound a handler thread waits for its dispatched request "
         "before failing it typed 'internal'.",
         _float_above("SORT_SERVE_COMPLETION_TIMEOUT_S", 0.0,
                      "a finite number > 0"))
register("SORT_SERVE_SPILL", "auto",
         "Route serve requests larger than SORT_SERVE_MAX_BYTES to the "
         "out-of-core spill tier instead of a typed 'bytes' rejection.",
         _enum("SORT_SERVE_SPILL", ("auto", "off")))
register("SORT_METRICS_PORT", 0,
         "Side port for the server's live /metrics, /healthz, /varz, "
         "/flightrecorder, /profile endpoints (0 = ephemeral, -1 = off).",
         _int_in("SORT_METRICS_PORT", -1, 65535,
                 "use an integer in [-1, 65535] (0 = ephemeral, "
                 "-1 = disabled)"))
register("SORT_PROFILE_EVERY", 0,
         "Capture a torch.profiler trace around every Nth server dispatch "
         "(into SORT_PROFILE, else <flight dir>/profile).",
         _int("SORT_PROFILE_EVERY", 0))
register("SORT_SENTINEL", "on",
         "Streaming SLO sentinel in the serve core (off detaches it).",
         _enum("SORT_SENTINEL", ("on", "off")))
register("SORT_SENTINEL_WINDOW_S", 60.0,
         "Rolling evaluation window of the sentinel's series, also the "
         "per-rule alert cooldown.",
         _float_above("SORT_SENTINEL_WINDOW_S", 0.0, "a finite number > 0"))
register("SORT_ALERT_BURN_RATE", 2.0,
         "Error-budget burn-rate multiple (vs the 99.9% SLO allowance) at "
         "which the sentinel raises deadline_burn.",
         _float_above("SORT_ALERT_BURN_RATE", 0.0, "a finite number > 0"))
