"""Env-knob registry of the port — the one place it reads the environment.

A subset of the reference registry (``mpitest_tpu/utils/knobs.py``): the
knobs the sort paths, the external sort, the key-file CLI and its readers,
and the sort server (``serve/``) read, with the same names, kinds,
defaults, "validates" specs and message contract.  A bad value raises
:class:`KnobError` (a ``ValueError``) whose text names the knob and the
accepted values; :func:`validate` parses a list of them up front (the
drivers' fail-fast ``[ERROR]`` line), :func:`iter_knobs` and
:func:`get_raw` serve the server's ``/varz`` view of what was set, and
:func:`scoped_env` flips knobs for a block.  :func:`reference_table` is
the port's generated knob table, which README embeds between its
``torch-knob-table`` markers (``python -m mpitest_tpu_torch.utils.knobs``
prints it).

The reference's bench (``BENCH_*`` and the probe sizes), native-runtime
(``COMM_*``, ``MINIMPI_NP``) and XLA (``XLA_FLAGS``) knobs belong to
programs the port does not have and are not registered (ROADMAP).
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np

__all__ = ["Knob", "KnobError", "get", "get_raw", "iter_knobs", "main",
           "reference_table", "register", "scoped_env", "validate"]

#: Default keys per streamed ingest chunk (``SORT_INGEST_CHUNK`` unset):
#: 2^22, the reference's ``DEFAULT_INGEST_CHUNK``.
DEFAULT_INGEST_CHUNK = 1 << 22


class KnobError(ValueError):
    """A knob's value failed validation; the message starts with
    ``NAME=<raw!r>``."""


@dataclass(frozen=True)
class Knob:
    """One registered environment knob."""

    name: str
    kind: str                     # int | float | flag | enum | csv | str | path | spec | dtype
    default: Any                  # typed default returned when unset
    spec: str                     # one-line "validates" column of the table
    doc: str                      # one-line description
    parse: Callable[[str], Any]   # raw string -> typed value; raises KnobError

    def read(self) -> Any:
        raw = os.environ.get(self.name)
        return self.default if raw is None else self.parse(raw)


_REGISTRY: dict[str, Knob] = {}


def register(name: str, kind: str, default: Any, spec: str, doc: str,
             parse: Callable[[str], Any]) -> None:
    """Register one knob, in the reference's argument order."""
    if not doc:
        raise ValueError(f"knob {name}: doc must be nonempty")
    if name in _REGISTRY:
        raise ValueError(f"knob {name} registered twice")
    _REGISTRY[name] = Knob(name, kind, default, spec, doc, parse)


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
    """Registered knobs in name order (the table's row order)."""
    for name in sorted(_REGISTRY):
        yield _REGISTRY[name]


@contextlib.contextmanager
def scoped_env(**overrides: str | None) -> Iterator[None]:
    """Set (or, with ``None``, unset) environment variables for a block and
    restore the previous state on exit, an exception included (the
    reference's ``scoped_env``)."""
    old = {k: os.environ.get(k) for k in overrides}
    try:
        for k, v in overrides.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


register("SORT_LOCAL_ENGINE", "enum", "auto",
         "auto | bitonic | lax | radix_pallas | radix_pallas_interpret",
         "Local sort engine; auto = bitonic CUDA kernels for n >= 2^13, "
         "radix_pallas = the fused radix kernel (K4) for <= 2^20 keys; the "
         "interpreter twin radix_pallas_interpret is refused here.",
         _parse_local_engine)
register("SORT_VERIFY", "flag", True,
         "1 | 0",
         "Always-on output verification (sortedness + fingerprint).",
         _flag("SORT_VERIFY"))

# The key-file CLI (cli.py) and its readers (utils/io.py).
register("SORT_ALGO", "enum", "sample",
         "sample | radix",
         "Sort algorithm the CLI dispatches (reference default: sample).",
         _enum("SORT_ALGO", ("sample", "radix"),
               err="{name}={raw!r}: use 'sample' or 'radix'"))
register("SORT_DTYPE", "dtype", np.dtype(np.int32),
         "a codec-supported numpy dtype",
         "Key dtype for text inputs (int32/uint32/int64/uint64/f32/f64).",
         _parse_dtype)
register("SORT_RANKS", "int", None,
         "a positive integer (default: all devices)",
         "Mesh size (ranks) of the CLI's sort; ranks share the cards round-robin.",
         _parse_positive_or_unset("SORT_RANKS", "use a positive integer"))
register("SORT_DIGIT_BITS", "int", None,
         "'auto' or an integer in [1, 16]",
         "Radix digit width of the CLI's debug>2 per-pass dump; auto picks.",
         _parse_digit_bits)
register("SORT_NATIVE_ENCODE", "enum", "auto",
         "auto | on | off",
         "Native C text parser (utils/native_encode.py): auto | on | off.",
         _enum("SORT_NATIVE_ENCODE", ("auto", "on", "off")))
register("SORT_INGEST", "enum", "auto",
         "auto | stream | mono",
         "Ingest pipeline selector; auto streams inputs above ~32 MiB.",
         _enum("SORT_INGEST", ("auto", "stream", "mono")))
register("SORT_INGEST_CHUNK", "int", None,
         "an integer >= 1 (default 2^22)",
         "Keys per streamed ingest chunk and per text-parse chunk "
         "(default 2^22).",
         _int("SORT_INGEST_CHUNK", 1))
register("SORT_INGEST_THREADS", "int", 2,
         "an integer >= 1",
         "Host parse/encode worker threads (text parse, ingest encode).",
         _int("SORT_INGEST_THREADS", 1))
register("SORT_DONATE", "enum", "auto",
         "auto | 1 | 0",
         "Drop the staged word tensors once the sort's first dispatch has "
         "read them (auto: on a CUDA device).",
         _enum("SORT_DONATE", ("auto", "1", "0"),
               err="{name}={raw!r}: use 'auto', '1' or '0'"))
register("SORT_MEM_BUDGET", "int", 0,
         "an integer >= 0 (0 = unlimited)",
         "Byte budget the external sort partitions against; the CLI sorts a "
         "file above it out of core (0 = unlimited).",
         _int("SORT_MEM_BUDGET", 0))

# The out-of-core external sort (store/).
register("SORT_SPILL_DIR", "path", None,
         "a writable directory path (default: a per-process tmp dir)",
         "Directory spill runs are staged in (default: a per-process tmp dir).",
         _passthrough)
register("SORT_MERGE_FANIN", "int", 16,
         "an integer >= 2",
         "Maximum runs merged per k-way merge pass; more runs merge in "
         "several passes through intermediate runs.",
         _int("SORT_MERGE_FANIN", 2))
register("SORT_SPILL_COMPRESS", "enum", "auto",
         "auto | on | off",
         "SORTRUN2 compression of spill runs: auto = when the native codec "
         "loads, on = always (numpy codec without it), off = raw runs.",
         _enum("SORT_SPILL_COMPRESS", ("auto", "on", "off")))
register("SORT_SPILL_THROTTLE_MBPS", "float", 0.0,
         "a finite number >= 0 (0 = unthrottled)",
         "Simulated spill-disk bandwidth cap in MB/s, shared by every spill "
         "reader and writer of the process (0 = unthrottled).",
         _float_at_least("SORT_SPILL_THROTTLE_MBPS", 0.0))
register("SORT_RESUME", "enum", "auto",
         "auto | off",
         "Crash resume of dataset-keyed external sorts from their journaled "
         "manifest (auto) or neither journal nor resume (off).",
         _enum("SORT_RESUME", ("auto", "off")))
register("SORT_SPILL_GC_AGE_S", "int", 3600,
         "an integer >= 0",
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
register("SORT_EXCHANGE_ENGINE", "enum", "auto",
         "auto | lax | pallas | pallas_interpret",
         "Exchange engine; auto = pallas (fused pack K6 + all-to-all K7); "
         "lax = pack K5 + per-block copies; the interpreter twin "
         "pallas_interpret is refused here.",
         _parse_exchange_engine)
register("SORT_DEVICES", "int", None,
         "'auto' or an integer >= 1",
         "Mesh rank count when none is passed explicitly (auto: one per card).",
         _parse_devices)
register("SORT_NEGOTIATE", "enum", "auto",
         "auto | on | off",
         "Exchange-capacity negotiation from a count probe (auto: P>1).",
         _enum("SORT_NEGOTIATE", ("auto", "on", "off")))
register("SORT_RESTAGE", "enum", "auto",
         "auto | off",
         "Skew-aware re-stage (shard interleave) on exchange imbalance.",
         _enum("SORT_RESTAGE", ("auto", "off")))
register("SORT_RESTAGE_RATIO", "float", 4.0,
         "a finite number > 1",
         "Per-peer max/fair-share count ratio that triggers a re-stage.",
         _float_above("SORT_RESTAGE_RATIO", 1.0, "a finite number > 1"))
register("SORT_CAP_FACTOR", "float", 2.0,
         "a finite number > 0",
         "Exchange cap as a multiple of the fair per-peer share.",
         _float_above("SORT_CAP_FACTOR", 0.0, "a finite number > 0"))
register("SORT_OVERSAMPLE", "int", None,
         "an integer >= 1 (default: 2P-1)",
         "Samples per shard for sample sort's splitter selection (default 2P-1).",
         _parse_positive_or_unset("SORT_OVERSAMPLE", "use an integer >= 1"))

# Observability sidecar paths (off when unset: the byte-compatible CLI
# contract is untouched by default).
register("SORT_TRACE", "path", None,
         "a writable file path",
         "Stream the structured span log as JSONL to this path.",
         _passthrough)
register("SORT_TRACE_CHROME", "path", None,
         "a writable file path",
         "Write the run's Chrome trace-event JSON (Perfetto) here.",
         _passthrough)
register("SORT_METRICS", "path", None,
         "a writable file path",
         "Append one JSON metrics sidecar line per run to this path.",
         _passthrough)
register("SORT_PROFILE", "path", None,
         "a writable directory path",
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


register("SORT_TRACE_SAMPLE", "float", 1.0,
         "a number in (0, 1]",
         "Down-sample the SORT_TRACE stream: keep ~this fraction of "
         "top-level spans (whole subtrees; the flight recorder still sees "
         "everything).",
         _parse_sample)
register("SORT_FLIGHT_RECORDER_SIZE", "int", 2048,
         "an integer >= 0 (0 disables)",
         "Flight-recorder ring capacity: recent spans kept in memory for "
         "incident dumps on typed errors (0 disables).",
         _int("SORT_FLIGHT_RECORDER_SIZE", 0))
# the reference's /tmp/mpitest_flightrec, under the process's TMPDIR
register("SORT_FLIGHT_RECORDER_DIR", "path",
         os.path.join(tempfile.gettempdir(), "mpitest_flightrec"),
         "a writable directory path",
         "Directory flight-recorder dump artifacts land in.",
         _passthrough)

# Robustness knobs (models/supervisor.py + faults.py), with the
# reference's defaults and messages.
register("SORT_MAX_RETRIES", "int", 2,
         "an integer >= 0",
         "Dispatch retry budget for transient launch failures.",
         _int("SORT_MAX_RETRIES", 0))
register("SORT_RETRY_BACKOFF", "float", 0.05,
         "a number >= 0",
         "Base seconds of exponential dispatch-retry backoff.",
         _float_at_least("SORT_RETRY_BACKOFF", 0.0))
register("SORT_FALLBACK", "flag", True,
         "1 | 0",
         "Graceful-degradation ladder (engines, other algorithm, then host "
         "sort).",
         _flag("SORT_FALLBACK"))


def _parse_faults(raw: str) -> str | None:
    if not raw:
        return None
    from mpitest_tpu_torch import faults
    faults.FaultRegistry(raw)  # raises ValueError with the site list
    return raw


register("SORT_FAULTS", "spec", None,
         "comma list of site[:count|:inf]",
         "Deterministic fault-injection plan (mpitest_tpu_torch/faults.py).",
         _parse_faults)


def _parse_faults_seed(raw: str) -> int:
    try:
        return int(raw)
    except ValueError:
        raise KnobError(f"SORT_FAULTS_SEED={raw!r}: use an integer") from None


register("SORT_FAULTS_SEED", "int", 0,
         "an integer",
         "Seed of the splitmix64 stream fault corruption values draw from.",
         _parse_faults_seed)
register("SORT_FAULT_STALL_MS", "int", 250,
         "an integer >= 1",
         "Milliseconds the dispatch_stall and merge_stall fault sites block "
         "the dispatching or merging thread.",
         _int("SORT_FAULT_STALL_MS", 1))
register("SORT_FAULT_ENOSPC_AT", "int", 1,
         "an integer >= 1",
         "Which spill write (1-based, counted per registry) the armed "
         "spill_enospc fault site fails with ENOSPC.",
         _int("SORT_FAULT_ENOSPC_AT", 1))

# Plan provenance (models/plan.py) and the self-tuning planner
# (models/planner.py), with the reference's defaults and messages.
register("SORT_PLAN", "enum", "on",
         "on | off",
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


register("SORT_PLANNER", "enum", "off",
         "off | shadow | on",
         "Self-tuning planner: off = hand-set defaults, shadow = compute and "
         "log every policy choice without acting, on = act "
         "(models/planner.py).",
         _enum("SORT_PLANNER", ("off", "shadow", "on")))
register("SORT_PLANNER_WINDOW", "int", 256,
         "an integer >= 16",
         "Rolling look-back of the planner's learning policies: flight-ring "
         "plan records (cap margin) / request arrivals (serve tuner).",
         # 16 = planner.MIN_OBSERVATIONS: a smaller window would validate
         # but behave as 16
         _int("SORT_PLANNER_WINDOW", 16))
register("SORT_PLANNER_HYSTERESIS", "float", 1.5,
         "a finite number > 1",
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


register("SORT_SERVE_PORT", "int", 7077,
         "an integer in [0, 65535]",
         "TCP port the sort server listens on (0 = ephemeral).",
         _int_in("SORT_SERVE_PORT", 0, 65535,
                 "use an integer in [0, 65535] (0 = ephemeral)"))
register("SORT_SERVE_HOST", "str", "127.0.0.1",
         "a bind address",
         "Address the sort server binds (default loopback).",
         _passthrough)
register("SORT_SERVE_MAX_INFLIGHT", "int", 64,
         "an integer >= 1",
         "Admission bound: concurrent in-flight requests before typed "
         "backpressure rejection.",
         _int("SORT_SERVE_MAX_INFLIGHT", 1))
register("SORT_SERVE_MAX_BYTES", "int", 1 << 28,
         "an integer >= 1",
         "Admission bound: total in-flight request payload bytes.",
         _int("SORT_SERVE_MAX_BYTES", 1))
register("SORT_SERVE_BATCH_WINDOW_MS", "float", 2.0,
         "a number >= 0",
         "Batching window: how long a dispatch waits to pack more small "
         "requests (0 = dispatch each alone).",
         _float_at_least("SORT_SERVE_BATCH_WINDOW_MS", 0.0,
                         note="0 disables packing"))
register("SORT_SERVE_BATCH_KEYS", "int", 1 << 16,
         "an integer >= 1",
         "Requests up to this many keys are batchable; one packed dispatch "
         "carries at most this many keys.",
         _int("SORT_SERVE_BATCH_KEYS", 1))
# every bucket the packed path can request: bucket_for() floors at 2^10
# and a packed dispatch carries at most SORT_SERVE_BATCH_KEYS (2^16) keys
register("SORT_SERVE_SHAPE_BUCKETS", "csv", (10, 11, 12, 13, 14, 15, 16),
         "comma list of log2 sizes in [1, 30]",
         "Power-of-two shape buckets the executor cache warms at server "
         "startup.",
         _parse_buckets)
register("SORT_SERVE_PREWARM", "enum", "auto",
         "auto | off",
         "Warm the executor cache (and build the kernels) at startup "
         "(off = on first use).",
         _enum("SORT_SERVE_PREWARM", ("auto", "off")))
register("SORT_SERVE_ALLOW_FAULTS", "flag", False,
         "1 | 0",
         "Honor per-request fault-injection specs (test mode only; "
         "production servers reject them as bad requests).",
         _flag("SORT_SERVE_ALLOW_FAULTS"))
register("SORT_SERVE_IDLE_TIMEOUT_S", "float", 300.0,
         "a finite number > 0",
         "Per-connection idle bound: seconds a keep-alive connection may "
         "sit between requests before the server closes it.",
         _float_above("SORT_SERVE_IDLE_TIMEOUT_S", 0.0, "a finite number > 0"))
register("SORT_SERVE_READ_TIMEOUT_S", "float", 30.0,
         "a finite number > 0",
         "Total wire-read budget per request (payload reads, rejected-"
         "payload drains, response writes).",
         _float_above("SORT_SERVE_READ_TIMEOUT_S", 0.0, "a finite number > 0"))
register("SORT_SERVE_DISPATCH_TIMEOUT_S", "float", 120.0,
         "a finite number >= 0 (0 = watchdog off)",
         "Dispatch watchdog bound: a single dispatch exceeding this trips "
         "the circuit breaker (healthz 503, fast typed rejections).",
         _float_at_least("SORT_SERVE_DISPATCH_TIMEOUT_S", 0.0,
                         note="0 disables the watchdog"))
register("SORT_SERVE_BREAKER_BACKOFF_S", "float", 5.0,
         "a finite number > 0",
         "Seconds the tripped circuit breaker stays open before half-opening "
         "with a probe request (doubles per failed probe).",
         _float_above("SORT_SERVE_BREAKER_BACKOFF_S", 0.0, "a finite number > 0"))
register("SORT_SERVE_COMPLETION_TIMEOUT_S", "float", 600.0,
         "a finite number > 0",
         "Backstop bound a handler thread waits for its dispatched request "
         "before failing it typed 'internal'.",
         _float_above("SORT_SERVE_COMPLETION_TIMEOUT_S", 0.0,
                      "a finite number > 0"))
register("SORT_SERVE_SPILL", "enum", "auto",
         "auto | off",
         "Route serve requests larger than SORT_SERVE_MAX_BYTES to the "
         "out-of-core spill tier instead of a typed 'bytes' rejection.",
         _enum("SORT_SERVE_SPILL", ("auto", "off")))
register("SORT_METRICS_PORT", "int", 0,
         "an integer in [-1, 65535]",
         "Side port for the server's live /metrics, /healthz, /varz, "
         "/flightrecorder, /profile endpoints (0 = ephemeral, -1 = off).",
         _int_in("SORT_METRICS_PORT", -1, 65535,
                 "use an integer in [-1, 65535] (0 = ephemeral, "
                 "-1 = disabled)"))
register("SORT_PROFILE_EVERY", "int", 0,
         "an integer >= 0 (0 = off)",
         "Capture a torch.profiler trace around every Nth server dispatch "
         "(into SORT_PROFILE, else <flight dir>/profile).",
         _int("SORT_PROFILE_EVERY", 0))
register("SORT_SENTINEL", "enum", "on",
         "on | off",
         "Streaming SLO sentinel in the serve core (off detaches it).",
         _enum("SORT_SENTINEL", ("on", "off")))
register("SORT_SENTINEL_WINDOW_S", "float", 60.0,
         "a finite number > 0",
         "Rolling evaluation window of the sentinel's series, also the "
         "per-rule alert cooldown.",
         _float_above("SORT_SENTINEL_WINDOW_S", 0.0, "a finite number > 0"))
register("SORT_ALERT_BURN_RATE", "float", 2.0,
         "a finite number > 0",
         "Error-budget burn-rate multiple (vs the 99.9% SLO allowance) at "
         "which the sentinel raises deadline_burn.",
         _float_above("SORT_ALERT_BURN_RATE", 0.0, "a finite number > 0"))


# ----------------------------------------------------------------- table

def _shown_default(k: Knob) -> str:
    """The table's default column, rendered as the reference renders it."""
    if k.name == "SORT_INGEST_CHUNK":
        # unset means the constant; the table shows the effective value
        return f"{DEFAULT_INGEST_CHUNK} (2^22)"
    if k.name == "SORT_FLIGHT_RECORDER_DIR":
        # the process's temp dir, so the generated table does not depend
        # on the environment it was generated in
        return "$TMPDIR/mpitest_flightrec"
    if k.default is None:
        return "_(unset)_"
    if isinstance(k.default, bool):
        return "1" if k.default else "0"
    if isinstance(k.default, tuple):
        return ",".join(str(v) for v in k.default)
    return str(k.default)


def reference_table() -> str:
    """The port's knob reference as a markdown table (README's block
    between the ``torch-knob-table`` markers)."""
    rows = ["| knob | type | default | validates | description |",
            "|---|---|---|---|---|"]
    for k in iter_knobs():
        spec, doc = (t.replace("|", "\\|")  # literal pipes inside md cells
                     for t in (k.spec, k.doc))
        rows.append(f"| `{k.name}` | {k.kind} | {_shown_default(k)} | {spec} "
                    f"| {doc} |")
    return "\n".join(rows)


def main() -> int:
    print(reference_table())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
