"""Registered span-name schema: the vocabulary contract of the telemetry
layer (port of ``mpitest_tpu/utils/span_schema.py``; every name is the
reference's, so rows from both packages group alike in its ``report.py``).

``report.py`` aggregates spans by string match (phase tables, the
collective table via ``MPI_EQUIV``, the robustness table, the ingest
overlap gate), so a renamed span would silently vanish from those
tables.  Every span name a producer may emit is registered here, and
``tests/test_torch_span_names.py`` fails on any literal span name in the
package outside the registry (the reference's sortlint rule SL003).

Two name classes:

* **exact names** (:data:`SPAN_NAMES`): every key maps to a one-line
  doc of what the span means and who emits it;
* **phase names** (:data:`PHASE_NAMES`): ``Tracer.phase(name)`` emits
  ``phase:<name>``; the report's per-phase table keys on the suffix.

Stdlib only, so the name scan loads it without torch.
"""

from __future__ import annotations

#: ``Tracer.phase(name)`` vocabulary → ``phase:<name>`` spans, summed
#: into the report's per-phase wall-time table.
PHASE_NAMES: frozenset[str] = frozenset({
    "sort",        # SPMD program dispatch + execution
    "encode",      # host-side key codec encode
    "device_put",  # host→device placement (monolithic path)
    "decode",      # device→host decode of the sorted words
    "verify",      # always-on output verification (ISSUE 3)
    "ingest",      # streamed ingest pipeline region
    "plan",        # pass/splitter planning
})

#: Prefix of every phase span (``Tracer.phase`` is the only producer).
PHASE_PREFIX = "phase:"

#: Exact span/event names → one-line doc.  Grouped by producer.
SPAN_NAMES: dict[str, str] = {
    # models/api.py — run umbrellas and the first-call split
    "sort": "one sort() run (umbrella span; device-mem high-water attr)",
    "ingest": "one ingest_to_mesh() run (umbrella span)",
    "jit_compile_execute": ("first call of a program key in this process "
                            "(kernel build and load included)"),
    "jit_execute": "later call of a program key",
    # models/* — algorithm structure (host enqueue wall, every run)
    "radix_pass": "one LSD radix pass",
    "splitter_round": "one sample-sort splitter round",
    # parallel/collectives.py — collective byte accounting (every run)
    "all_gather": "all_gather point event (bytes, ranks)",
    "psum": "psum point event (bytes, op=sum)",
    "pmax": "pmax point event (bytes, op=max)",
    "ragged_all_to_all": "padded alltoallv exchange (bytes, wire_bytes, cap)",
    # robustness vocabulary (ISSUE 3)
    "fault": "one injected fault firing (site, seq)",
    "supervisor_retry": "one retried SPMD dispatch (label, attempt, error)",
    "verify": "one output verification (ok, sorted_ok, fp_ok)",
    # scale-out vocabulary (ISSUE 7)
    "exchange_balance": ("negotiated exchange capacity + per-rank "
                         "send/recv byte balance (host count probe)"),
    "restage": "skew-aware re-stage (shard interleave) of the input words",
    "negotiate_probe": ("one capacity-negotiation count probe "
                        "(its collectives nest here, not under a "
                        "pass)"),
    # serve/ — sort-as-a-service vocabulary (ISSUE 8); the report CLI's
    # SLO table computes p50/p99 latency from serve.request durations
    "serve.request": ("one served sort request (n, dtype, status, "
                      "batched, bucket) — the SLO latency unit"),
    "serve.batch": ("one packed multi-tenant dispatch (segments, keys, "
                    "bucket)"),
    "serve.compile_cache": ("executor-cache lookup point event (hit, "
                            "bucket, dtype; compile_s + XLA cost "
                            "analysis flops/bytes on miss)"),
    "serve.profile": ("one on-demand jax.profiler capture (logdir, "
                      "trigger=endpoint|every, seq) — ISSUE 10 device "
                      "profiling hook"),
    # request-lifecycle robustness vocabulary (ISSUE 11)
    "serve.deadline": ("one request cancelled because its deadline_ms "
                       "expired before dispatch (stage=admission|queue|"
                       "dispatch, trace_id) — never dispatched"),
    "serve.watchdog": ("dispatch-watchdog state change (event=trip|"
                       "probe|recovered|reopen|drain_timeout; stuck "
                       "trace_ids, age_s) — the circuit-breaker audit "
                       "trail"),
    "serve.hedge": ("one client-side hedged request (winner=primary|"
                    "hedge, waited_ms) — the p99-tail second attempt"),
    # streaming sentinel vocabulary (ISSUE 16): one point event per
    # raised anomaly alert; rule names come from doctor.DOCTOR_RULES
    # (sortlint SL007) and the bridge folds them into
    # sort_alerts_total{rule,severity}
    "serve.alert": ("one sentinel anomaly alert (rule, severity, "
                    "value, threshold, window_s) — serve/sentinel.py "
                    "rolling-window detection; /alerts lists them"),
    # plan provenance (ISSUE 12): one point event per finished sort (or
    # packed serve dispatch) carrying the full decision record —
    # decisions {algo, cap, restage, engine, passes, ladder, batch}
    # with predicted/actual/regret, plus the input-distribution profile
    # (models/plan.py is the registered decision vocabulary, SL005)
    "sort.plan": ("one finished plan record (algo, regret, decisions, "
                  "profile) — report.py --explain and /varz consume it"),
    # store/ — out-of-core external sort (ISSUE 15)
    "external.run": ("one spill run written (run, n, bytes, dtype, "
                     "payload_width) — partition chunk sorted + "
                     "persisted with its fingerprint sidecar"),
    "external.merge": ("one k-way merge pass (runs, n, merge_pass, "
                       "final) — intermediate passes stream into a "
                       "run, the final pass into the caller's sink"),
    "external.recover": ("external-sort integrity recovery point event "
                         "(reason, bad_runs, attempt) — blamed runs "
                         "re-spilled from source before the re-merge"),
    # crash-durable spill tier (ISSUE 18, store/manifest.py)
    "external.resume": ("one spill-manifest replay (dataset, "
                        "committed, valid, skipped_lines) — committed "
                        "runs re-validated and re-entered at the merge "
                        "phase instead of being re-sorted"),
    "external.gc": ("one orphaned-spill sweep (dir, reclaimed, bytes, "
                    "age_s) — files no live manifest references, "
                    "reclaimed age-gated at startup"),
    # models/ingest.py — streamed pipeline stages (ISSUE 2)
    "ingest.parse": "parse/materialize one host chunk",
    "ingest.encode": "codec-encode one chunk (worker pool)",
    "ingest.transfer": "host→device DMA of one chunk's shard pieces",
    "ingest.pipeline": "whole streamed-ingest wall interval",
    "egress.fetch": "device→host fetch of one result shard",
    "egress.decode": "codec-decode one fetched shard",
}

#: Ingest/egress stage split used by the report overlap tables: host-side
#: work vs host↔device transfer, per direction (the span name's prefix).
INGEST_HOST_STAGES = ("ingest.parse", "ingest.encode", "egress.decode")
INGEST_XFER_STAGES = ("ingest.transfer", "egress.fetch")

#: Robustness event names the report's robustness table folds.
FAULT_SPAN = "fault"
RETRY_SPAN = "supervisor_retry"
VERIFY_SPAN = "verify"

#: Scale-out event names the report's scale-out table folds (ISSUE 7).
BALANCE_SPAN = "exchange_balance"
RESTAGE_SPAN = "restage"

#: Sort-as-a-service names the report's SLO table folds (ISSUE 8).
SERVE_REQUEST_SPAN = "serve.request"
SERVE_BATCH_SPAN = "serve.batch"
SERVE_CACHE_SPAN = "serve.compile_cache"
SERVE_PROFILE_SPAN = "serve.profile"

#: Request-lifecycle robustness names (ISSUE 11): deadline expiries,
#: watchdog/breaker transitions, client-side hedges.
SERVE_DEADLINE_SPAN = "serve.deadline"
SERVE_WATCHDOG_SPAN = "serve.watchdog"
SERVE_HEDGE_SPAN = "serve.hedge"

#: Streaming-sentinel name (ISSUE 16): anomaly alerts over rolling
#: windows; rule vocabulary lives in mpitest_tpu/doctor.py.
SERVE_ALERT_SPAN = "serve.alert"

#: Plan-provenance name (ISSUE 12): the decision record report.py
#: --explain renders and the /varz decision snapshot aggregates.
PLAN_SPAN = "sort.plan"

#: Out-of-core external sort names (ISSUE 15).
EXTERNAL_RUN_SPAN = "external.run"
EXTERNAL_MERGE_SPAN = "external.merge"
EXTERNAL_RECOVER_SPAN = "external.recover"

#: Crash-durable spill tier names (ISSUE 18).
EXTERNAL_RESUME_SPAN = "external.resume"
EXTERNAL_GC_SPAN = "external.gc"

#: Request-trace attributes (ISSUE 10): the wire layer mints one
#: ``trace_id`` per request (echoed in the response) and the dispatch
#: thread opens a ``spans.trace_context`` carrying it, so EVERY span a
#: request touches — admission, batching, the ``sort`` umbrella and its
#: phases, supervisor retries, fault events, verification — is stamped
#: with the same id; packed dispatches additionally stamp the shared
#: ``batch_id`` (and ``serve.batch`` lists every member's trace id
#: under ``trace_ids``).  ``report.py --trace-id`` reconstructs one
#: request end-to-end from exactly these attrs.
TRACE_ID_ATTR = "trace_id"
BATCH_ID_ATTR = "batch_id"
BATCH_TRACE_IDS_ATTR = "trace_ids"


def is_registered(name: str) -> bool:
    """True iff ``name`` is a registered span name (exact, or a
    ``phase:`` span over a registered phase)."""
    if name in SPAN_NAMES:
        return True
    return (name.startswith(PHASE_PREFIX)
            and name[len(PHASE_PREFIX):] in PHASE_NAMES)


def all_names() -> tuple[str, ...]:
    """Every registered name, phases expanded — for docs and tests."""
    return tuple(sorted(SPAN_NAMES)) + tuple(
        sorted(PHASE_PREFIX + p for p in PHASE_NAMES))
