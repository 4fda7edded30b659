"""The sort server: protocol, orchestration, per-request supervision (port
of ``mpitest_tpu/serve/server.py``).

Wire protocol (``sortserve.v1``, one TCP connection may carry many
requests back to back):

* request: one JSON header line (utf-8, ``\\n``-terminated) —
  ``{"v": "sortserve.v1", "dtype": "int32", "n": 4096}`` with optional
  ``"algo"`` (radix | sample; solo dispatches only), ``"trace_id"``
  (1-64 chars of ``[A-Za-z0-9_-]``; minted server-side when absent and
  echoed in the response — the end-to-end request-trace key),
  ``"payload_bytes"`` (per-record payload width — the keys
  become records; ``n * payload_bytes`` raw payload bytes follow the
  key bytes and come back permuted into key order)
  and ``"faults"`` (a ``SORT_FAULTS`` spec, honored only when the
  server runs with ``SORT_SERVE_ALLOW_FAULTS=1``) — followed by exactly
  ``n * itemsize`` raw little-endian key bytes (then the payload
  section, when declared).  A request whose total bytes exceed
  ``SORT_SERVE_MAX_BYTES`` routes to the out-of-core **spill tier**
  (``SORT_SERVE_SPILL``): the bytes stream straight to disk,
  the external sort serves them under ``SORT_MEM_BUDGET``, and the ok
  response carries ``"spilled": true`` (+ the plan digest's
  ``spilled``) instead of the old typed ``bytes`` rejection.
* response: one JSON header line — ``{"ok": true, "n": ..., "batched":
  ..., "bucket": ..., "trace_id": ..., "batch_id": ..., "plan": ...}``
  (``plan`` is the compact decision digest — algo,
  negotiated cap, restage verdict, regret — present when ``SORT_PLAN``
  is on) followed by the sorted key bytes, or ``{"ok": false, "error":
  <code>, "detail": ..., "trace_id": ...}`` with no payload.  Error codes are TYPED and stable: ``bad_request`` (the
  header/payload is malformed), ``backpressure`` (admission bounds hit
  or the circuit breaker is open — retry with backoff), ``draining``
  (SIGTERM received), ``deadline_exceeded`` (the request's optional
  ``deadline_ms`` budget expired before dispatch — the sort was never
  run), ``integrity`` (no path produced a verified result for THIS
  request), ``retries`` (dispatch kept failing past the retry budget),
  ``internal`` (anything else — still one request's problem, never the
  server's).

Request lifecycle bounds: the header read is bounded by the
connection idle timeout, payload reads / rejected-payload drains /
response writes by one total ``SORT_SERVE_READ_TIMEOUT_S`` budget
(admission bytes are provably released on every wire exit path), the
dispatch wait by ``SORT_SERVE_COMPLETION_TIMEOUT_S``, and the dispatch
itself by the watchdog (``serve/watchdog.py``): a wedge trips a
circuit breaker — ``/healthz`` 503, fast typed rejections, automatic
half-open probe recovery — instead of silently pinning the server.

Failure semantics: every dispatch runs under the robustness layer.
Solo requests go through the supervised ``models.api.sort`` (bounded
retry, degradation ladder, always-on verification); batched requests
are verified PER SEGMENT (``models/segmented.verify_segments``) and a
failing segment is re-run solo under the supervisor while its
batchmates' verified results return normally.  A poisoned request —
injected via ``SORT_FAULTS`` on the server or a per-request ``faults``
spec in test mode — therefore yields a typed per-request error, never
server death and never a batchmate's corruption.

Telemetry: every request records a ``serve.request`` span (n, dtype,
status, batched, bucket) whose duration feeds the report CLI's p50/p99
SLO table; every packed dispatch records ``serve.batch``; every
executor-cache lookup records ``serve.compile_cache``.  All ride the
ordinary ``SORT_TRACE`` stream.

On the card: the core's mesh (default ``make_mesh()``, the card; a
caller may pass CPU ranks) decides where every dispatch runs.  A solo
request reaches the hand-written kernels through ``sort()`` (K1, or K2
and K3, on one rank; K6 and K7 on several); a batched request runs the
packed ``torch.sort`` on this process's first rank.  Only the batcher's
dispatch thread touches torch: handler threads frame bytes and build
numpy arrays.  A kernel that fails to build or launch is never caught
and replaced by plain PyTorch: the request gets ``internal`` and the
flight recorder names the error.

Across processes (``parallel.multihost_init``, then ``ServerCore()`` and
a :class:`SortServer` in every process of the group): each process's
core serves its own clients over the global mesh.  Batched requests run
on the process's own first rank and touch no other process.  A record
request runs on the mesh's rank 0: ``ok`` in the process that owns it,
``bad_request`` in the others.  A solo key request and a spill request
get ``internal`` (``RuntimeError``) at once, before any control-group
round: their result would lie on other processes' ranks, where the
reference's sort runs and then fails to fetch it.  Requests are never
coordinated between the processes, so a request that reaches one
server only is answered without waiting for a peer.
"""

from __future__ import annotations

import errno
import json
import math
import os
import re
import socket
import socketserver
import threading
import time
from typing import TYPE_CHECKING, Any, BinaryIO

import numpy as np

from mpitest_tpu_torch import faults
from mpitest_tpu_torch.models import plan as plan_mod
from mpitest_tpu_torch.models import planner as planner_mod
from mpitest_tpu_torch.models import segmented
from mpitest_tpu_torch.models import supervisor as supervision
from mpitest_tpu_torch.serve.admission import AdmissionControl, AdmissionReject
from mpitest_tpu_torch.serve.batching import ERR_DEADLINE, Batcher, ServeRequest
from mpitest_tpu_torch.serve.executor_cache import ExecutorCache
from mpitest_tpu_torch.serve.telemetry import ProfileHook
from mpitest_tpu_torch.serve.watchdog import CircuitBreaker, DispatchWatchdog
from mpitest_tpu_torch.utils import flight_recorder, knobs
from mpitest_tpu_torch.utils import spans as spanlib
from mpitest_tpu_torch.utils.metrics_live import LiveMetrics, SpanMetricsBridge

if TYPE_CHECKING:
    from mpitest_tpu_torch.parallel.mesh import Mesh
    from mpitest_tpu_torch.utils.trace import Tracer

#: Protocol version tag (header "v" of every request and response).
WIRE_SCHEMA = "sortserve.v1"

#: Typed error codes (stable wire vocabulary; see module docstring).
ERR_BAD_REQUEST = "bad_request"
ERR_BACKPRESSURE = "backpressure"
ERR_DRAINING = "draining"
ERR_INTEGRITY = "integrity"
ERR_RETRIES = "retries"
ERR_INTERNAL = "internal"
#: the request's deadline_ms expired before dispatch — the
#: sort was never run, the admission bytes were released.  Defined by
#: the dispatch layer (serve/batching.py), re-exported as wire vocab.
ERR_DEADLINE_EXCEEDED = ERR_DEADLINE

#: Sanity cap on a single request's key count (the admission byte bound
#: is the real limit; this just stops a hostile header from asking the
#: server to read exabytes to keep framing).
MAX_REQUEST_KEYS = 1 << 31

#: Sanity cap on the per-record payload width: 64 KiB per
#: record is far past any key-attached handle; bigger payloads belong
#: in an object store keyed by a payload-resident id.
MAX_PAYLOAD_WIDTH = 1 << 16

#: Wire-supplied trace ids: short, log/filename-safe tokens.  Anything
#: else is a typed bad_request — trace ids land in span attrs, file
#: names and report output, so the grammar is closed.
_TRACE_ID_RE = re.compile(r"[A-Za-z0-9_\-]{1,64}")


def mint_trace_id() -> str:
    """Server-side trace id for requests that arrived without one (the
    wire/client layer normally mints it — serve/client.py)."""
    return os.urandom(8).hex()


def _maybe_corrupt_packed(reg: "faults.FaultRegistry | None",
                          words: tuple,
                          n_valid: int) -> tuple:
    """Batch-path twin of ``faults.maybe_corrupt_result``: apply the
    ``result_swap`` / ``result_dup`` sites to the packed host words so
    server-level ``SORT_FAULTS`` chaos drills reach the batched
    dispatch too.  The per-segment verifier must then flag (only) the
    touched segments."""
    if reg is None or n_valid < 2:
        return words
    for site in ("result_swap", "result_dup"):
        if not reg.would_fire(site):
            continue
        if not reg.fire(site):
            continue
        out = []
        for w in words:
            h = w.copy()
            if site == "result_swap":
                h[0], h[n_valid - 1] = h[n_valid - 1].copy(), h[0].copy()
            else:
                h[1] = h[0]
            out.append(h)
        return tuple(out)
    return words


class ServerCore:
    """Transport-independent server core: admission → batcher →
    executor cache → supervised dispatch → typed result.  The TCP layer
    (:class:`SortServer`) and the in-process tests both drive this."""

    def __init__(self, mesh: "Mesh | None" = None,
                 tracer: "Tracer | None" = None) -> None:
        from mpitest_tpu_torch.parallel.mesh import make_mesh
        from mpitest_tpu_torch.utils.trace import Tracer as _Tracer

        # the card unless the caller passes ranks; no card raises here.
        # Inside a group of several processes make_mesh() gathers every
        # process's devices over the control group: every process of the
        # group constructs its core together.
        self.mesh = mesh if mesh is not None else make_mesh()
        #: where a packed batch and the cache's warm-ups run: this
        #: process's first rank (the mesh's first may be another's)
        self.device = self.mesh.local_devices[0]
        self.tracer = tracer or _Tracer()
        trace_path = knobs.get("SORT_TRACE")
        if trace_path and self.tracer.spans.stream_path is None:
            self.tracer.spans.stream_path = trace_path
        self.default_algo = knobs.get("SORT_ALGO")
        self.allow_faults = knobs.get("SORT_SERVE_ALLOW_FAULTS")
        self.batch_keys = knobs.get("SORT_SERVE_BATCH_KEYS")
        window_ms = knobs.get("SORT_SERVE_BATCH_WINDOW_MS")
        # request-lifecycle bounds: every wire interaction
        # and every dispatch wait is time-bounded
        self.idle_timeout_s = knobs.get("SORT_SERVE_IDLE_TIMEOUT_S")
        self.read_timeout_s = knobs.get("SORT_SERVE_READ_TIMEOUT_S")
        self.completion_timeout_s = knobs.get(
            "SORT_SERVE_COMPLETION_TIMEOUT_S")
        #: out-of-core spill tier: requests larger than the
        #: admission byte bound spill to disk and ride the external
        #: sort instead of a typed 'bytes' rejection.  The tier's
        #: memory budget is SORT_MEM_BUDGET when set, else the
        #: admission bound itself (the byte bound IS the host-memory
        #: statement the operator already made).
        self.spill_enabled = knobs.get("SORT_SERVE_SPILL") != "off"
        self.spill_budget = (knobs.get("SORT_MEM_BUDGET")
                             or knobs.get("SORT_SERVE_MAX_BYTES"))
        self.cache = ExecutorCache(self.tracer.spans, device=self.device)
        self.admission = AdmissionControl(
            knobs.get("SORT_SERVE_MAX_INFLIGHT"),
            knobs.get("SORT_SERVE_MAX_BYTES"))
        #: live metrics: the registry the /metrics endpoint
        #: renders.  Span-derived metrics ride the span-close bridge;
        #: only the admission gauges are written directly.
        self.metrics = LiveMetrics()
        self.tracer.spans.observers.append(SpanMetricsBridge(self.metrics))
        #: streaming SLO sentinel: a second span-close
        #: observer, appended right after the bridge so its serve.alert
        #: emissions are bridged into sort_alerts_total on the same
        #: flush.  None when SORT_SENTINEL=off; /alerts snapshots it.
        self.sentinel = None
        if knobs.get("SORT_SENTINEL") != "off":
            from mpitest_tpu_torch.serve.sentinel import SortSentinel
            self.sentinel = SortSentinel(
                self.metrics, self.tracer.spans,
                window_s=knobs.get("SORT_SENTINEL_WINDOW_S"),
                burn_rate=knobs.get("SORT_ALERT_BURN_RATE"))
            self.tracer.spans.observers.append(self.sentinel)
        #: on-demand torch.profiler captures around dispatches.
        self.profiler = ProfileHook(self.tracer.spans,
                                    self.mesh.local_devices)
        # gauge publication rides the admission lock (see
        # AdmissionControl.on_change) so exported in-flight counts can
        # never be left stale by interleaved handler threads
        self.admission.on_change = self._publish_admission
        self.started = time.time()
        self._batch_seq = 0
        self.batcher = Batcher(self._run_batch, self._run_solo,
                               window_ms / 1e3, self.batch_keys)
        # seed the gauge with the configured window so a scrape can
        # always tell "initial value" from "metric missing" (retunes
        # overwrite it)
        self.metrics.gauge("sort_serve_batch_window_ms").set(window_ms)
        #: serve-side auto-tuning: rolling request-mix
        #: observer + two-phase hysteresis re-sizing the batching
        #: window and the prewarm buckets.  `shadow` computes and logs
        #: every recommendation without touching the batcher; `on`
        #: acts.  None when SORT_PLANNER=off — and when the operator
        #: set window 0 (solo dispatch): there is no batching window to
        #: tune, and the tuner's clamp floor (MIN_WINDOW_S) could only
        #: ever override that explicit config, never restore it.
        self.planner_mode = planner_mod.mode()
        self.tuner: "planner_mod.ServeTuner | None" = None
        if self.planner_mode != "off" and window_ms > 0:
            self.tuner = planner_mod.ServeTuner(
                window=knobs.get("SORT_PLANNER_WINDOW"),
                hysteresis=knobs.get("SORT_PLANNER_HYSTERESIS"),
                batch_keys=self.batch_keys,
                initial_window_s=window_ms / 1e3)
        #: circuit breaker + dispatch watchdog.  The breaker
        #: is always consulted by admission; the watchdog THREAD only
        #: runs when start_watchdog() is called (the server driver does;
        #: in-process test cores stay thread-clean unless they opt in).
        self.breaker = CircuitBreaker(
            knobs.get("SORT_SERVE_BREAKER_BACKOFF_S"))
        self.watchdog = DispatchWatchdog(
            self, knobs.get("SORT_SERVE_DISPATCH_TIMEOUT_S"),
            self.breaker)
        self.requests_ok = 0
        self.requests_err = 0
        #: guards the two tallies above — _finish runs on concurrent
        #: TCP handler threads, and a bare += loses increments.
        self._tally_lock = threading.Lock()
        #: in-flight dispatched requests by trace_id: the
        #: drain-timeout path names exactly who was stuck.
        self._inflight_reqs: dict[str, ServeRequest] = {}
        self._inflight_lock = threading.Lock()

    #: Disk headroom a spill request must fit under: staged input +
    #: merged output + merge intermediates.  Without this check the
    #: spill tier would convert the old memory-protection rejection
    #: into a disk-exhaustion vector (huge declared n, or a full
    #: volume surfacing as an untyped OSError mid-stage).
    SPILL_DISK_FACTOR = 3

    def spill_disk_ok(self, nbytes: int) -> bool:
        """True when the spill volume has room for a request of
        ``nbytes`` (input + output + intermediates); False degrades to
        the ordinary typed ``bytes`` rejection."""
        import shutil

        from mpitest_tpu_torch.store import external

        try:
            free = shutil.disk_usage(
                external.resolve_spill_dir(None)).free
        except OSError:
            return False
        return free >= self.SPILL_DISK_FACTOR * nbytes

    def start_watchdog(self) -> None:
        """Start the dispatch-watchdog thread (no-op when
        ``SORT_SERVE_DISPATCH_TIMEOUT_S=0``)."""
        self.watchdog.start()

    def _publish_admission(self, inflight: int, nbytes: int) -> None:
        self.metrics.gauge("sort_serve_inflight").set(inflight)
        self.metrics.gauge("sort_serve_inflight_bytes").set(nbytes)

    # -- startup ------------------------------------------------------
    def prewarm(self, log: Any = None) -> int:
        """Warm the executor cache (``SORT_SERVE_PREWARM`` /
        ``SORT_SERVE_SHAPE_BUCKETS``): build and load the kernels when
        the mesh is on a card, then run each bucket's packed sort once on
        this process's first rank; returns entries ensured."""
        if knobs.get("SORT_SERVE_PREWARM") == "off":
            return 0
        log = log or (lambda m: None)
        buckets = tuple(1 << int(b)
                        for b in knobs.get("SORT_SERVE_SHAPE_BUCKETS"))
        return self.cache.prewarm(buckets, ("int32",), log)

    # -- dispatch executors (dispatch thread only) --------------------
    def _run_solo(self, req: ServeRequest) -> None:
        """One supervised sort for one request.  A per-request fault
        spec (test mode) installs a scoped registry — the dispatch
        thread is single, so install/clear cannot race another sort.
        Runs under the request's trace context: every span the sort
        emits (phases, retries, faults, verify) carries its trace_id."""
        from mpitest_tpu_torch.models import api

        req.picked_up()
        if req.expired():
            # final pre-executor deadline gate (stage "dispatch"): the
            # device never sees work nobody is waiting for
            req.fail_deadline("dispatch")
            self.batcher.deadline_cancelled += 1
            return
        reg = None
        if req.faults is not None:
            reg = faults.FaultRegistry(req.faults, seed=faults.faults_seed())
        try:
            if self.mesh.cross_process and (req.spill or not req.payload_width):
                # refused before any control-group round: a peer that
                # never got this request would leave the round waiting
                # out its timeout
                raise RuntimeError(
                    "a solo or spilled sort on a mesh across processes "
                    "leaves its result on ranks of other processes, which "
                    "cannot come back to this process's client; run a "
                    "server per process on a mesh of its own to serve "
                    "requests above SORT_SERVE_BATCH_KEYS")
            with spanlib.trace_context(trace_id=req.trace_id), \
                    self.profiler.maybe_capture():
                if reg is not None:
                    faults.install(reg)
                try:
                    if req.spill:
                        # out-of-core tier: external sort
                        # over the disk-staged input, merged output
                        # streamed into one run the reply reads from
                        from mpitest_tpu_torch.store import external

                        # out_name: server-minted nonce, NOT the
                        # client trace_id (see _spill_wire — a reused
                        # id must never collide one request's reply
                        # stream with another's dispatch)
                        res = external.external_sort(
                            req.arr, req.payload
                            if req.payload_width else None,
                            algorithm=req.algo, mesh=self.mesh,
                            tracer=self.tracer,
                            budget=self.spill_budget,
                            sink="file",
                            out_name=f"out_{mint_trace_id()}",
                            dataset=req.dataset)
                        out, out_pay, out_run = None, None, res.out_run
                    elif req.payload_width:
                        # record sort: key+payload through
                        # the fused argsort-gather
                        out, out_pay = api.sort(
                            req.arr, algorithm=req.algo, mesh=self.mesh,
                            tracer=self.tracer, payload=req.payload)
                        out_run = None
                    else:
                        out = api.sort(req.arr, algorithm=req.algo,
                                       mesh=self.mesh, tracer=self.tracer)
                        out_pay = out_run = None
                finally:
                    if reg is not None:
                        faults.install(None)
            # plan digest: sort() left its finished decision
            # record on the tracer (single dispatch thread — last write
            # is this request's); the compact digest rides the response
            # header so clients can watch decision drift
            p = self.tracer.plan
            req.complete(out, batched=False, bucket=None,
                         plan=p.digest() if isinstance(
                             p, plan_mod.SortPlan) else None,
                         payload=out_pay, run=out_run)
        except supervision.SortIntegrityError as e:
            req.fail(ERR_INTEGRITY, str(e))
        except supervision.SortRetryExhausted as e:
            req.fail(ERR_RETRIES, str(e))
        except (ValueError, TypeError, OverflowError) as e:
            from mpitest_tpu_torch.store.runs import RunFormatError

            # a structurally-bad SPILL artifact is the server's disk
            # problem, never the client's request
            req.fail(ERR_INTERNAL if isinstance(e, RunFormatError)
                     else ERR_BAD_REQUEST, str(e))
        except OSError as e:
            # mid-merge disk-full: the external sort already
            # deleted its partials; the client sees the same retryable
            # rejection vocabulary as admission backpressure, never an
            # untyped 500
            if e.errno == errno.ENOSPC:
                req.fail(ERR_BACKPRESSURE, str(e))
            else:
                flight_recorder.dump_on_error("serve_internal")
                req.fail(ERR_INTERNAL, f"{type(e).__name__}: {e}")
        except Exception as e:  # noqa: BLE001 — one request's problem,
            # never the server's; an UNtyped failure is an incident the
            # flight recorder must document (api.sort dumps the typed
            # ones itself at their raise chokepoint).  The dump's reason
            # names the error class: a kernel that failed to build or
            # launch (KernelBuildError, KernelLaunchError, a CUDA error)
            # is named in the artifact, never retried or replaced.
            flight_recorder.dump_on_error(
                f"serve_internal_{type(e).__name__}")
            req.fail(ERR_INTERNAL, f"{type(e).__name__}: {e}")

    def _run_batch(self, reqs: "list[ServeRequest]") -> None:
        """One packed multi-tenant dispatch.  Per-segment verification
        isolates a bad segment: it re-runs solo under the supervisor,
        its batchmates' verified results return normally.  The whole
        dispatch runs under a ``batch_id`` trace context, and the
        ``serve.batch`` span lists every member's ``trace_id`` — one
        request is reconstructable even when it shared a device sort
        with strangers."""
        from mpitest_tpu_torch.models import api

        t0 = time.perf_counter()
        for r in list(reqs):
            r.picked_up()
            if r.expired():
                # a member that expired while the window packed around
                # it is cancelled here; its batchmates dispatch normally
                r.fail_deadline("dispatch")
                self.batcher.deadline_cancelled += 1
                reqs.remove(r)
        if not reqs:
            return
        dtype = reqs[0].dtype
        self._batch_seq += 1
        batch_id = f"b{os.getpid():x}-{self._batch_seq:06x}"
        with spanlib.trace_context(batch_id=batch_id):
            try:
                with self.profiler.maybe_capture():
                    batch = segmented.pack_segments(
                        [r.arr for r in reqs], dtype)
                    exe = self.cache.get_packed(batch.bucket, dtype.name,
                                                len(batch.words))
                    # on this process's first rank: the card for a card
                    # core, the CPU for a core on CPU ranks
                    sorted_words = segmented.run_packed(
                        batch, exe, device=self.device)
                reg = faults.for_run()
                supervision.wire_registry(reg, self.tracer)
                sorted_words = _maybe_corrupt_packed(reg, sorted_words,
                                                     batch.n_valid)
                verdicts = segmented.verify_segments(batch, sorted_words)
                outs = segmented.split_segments(batch, sorted_words)
            except Exception as e:  # noqa: BLE001 — pack/dispatch died:
                # nothing was verified; every tenant falls back to its
                # own supervised solo run (typed per-request outcome)
                self.tracer.count("serve_batch_fallbacks", 1)
                self.metrics.counter(
                    "sort_serve_batch_fallbacks_total").inc(1)
                flight_recorder.dump_on_error("serve_batch_fallback")
                self.tracer.verbose(f"batch dispatch failed "
                                    f"({type(e).__name__}: {e}); "
                                    "re-running each request solo")
                for r in reqs:
                    self._run_solo(r)
                return
            attrs: dict = {"segments": len(reqs), "keys": batch.n_valid,
                           "bucket": batch.bucket, "dtype": dtype.name,
                           "trace_ids": [r.trace_id for r in reqs]}
            peak = api.device_mem_peak(self.mesh)
            if peak:
                attrs["device_mem_peak_bytes"] = peak
            self.tracer.spans.record(
                "serve.batch", t0, time.perf_counter() - t0, **attrs)
            # batch plan: the batching-window + bucket
            # decision as a first-class plan record — predicted waste
            # at window close vs the padded lanes actually shipped
            digest = None
            if plan_mod.enabled():
                plan = plan_mod.SortPlan(algo="packed", n=batch.n_valid,
                                         dtype=dtype.name, ranks=1)
                w = next((r.window for r in reqs if r.window), None) or {}
                keys_close = int(w.get("keys", batch.n_valid))
                pred_bucket = segmented.bucket_for(keys_close)
                plan.decide(
                    "batch", chosen=batch.bucket,
                    trigger=str(w.get("closed_by", "?")),
                    members=int(w.get("members", len(reqs))),
                    bucket=pred_bucket,
                    waste=round(1.0 - keys_close / pred_bucket, 4))
                plan.actual(
                    "batch", keys=batch.n_valid,
                    waste=round(1.0 - batch.n_valid / batch.bucket, 4))
                plan.finalize()
                self.tracer.spans.event("sort.plan", **plan.to_attrs())
                digest = plan.digest()
            for r, ok, out in zip(reqs, verdicts, outs):
                if ok:
                    r.complete(out, batched=True, bucket=batch.bucket,
                               batch_id=batch_id, plan=digest)
                else:
                    self.tracer.count("serve_segment_requeues", 1)
                    self.metrics.counter(
                        "sort_serve_segment_requeues_total").inc(1)
                    self.tracer.verbose(
                        "batched segment failed verification; re-running "
                        "that request solo under the supervisor")
                    self._run_solo(r)

    # -- request execution (any handler thread) -----------------------
    def _finish(self, t0: float, attrs: dict, status: str,
                payload: Any) -> tuple[str, Any, dict]:
        """Record the ``serve.request`` span — the SLO unit — and the
        served/errored tallies; every request path ends here exactly
        once."""
        attrs["status"] = status
        self.tracer.spans.record("serve.request", t0,
                                 time.perf_counter() - t0, **attrs)
        with self._tally_lock:
            if status == "ok":
                self.requests_ok += 1
            else:
                self.requests_err += 1
        return status, payload, attrs

    @staticmethod
    def reject_code(e: AdmissionReject) -> str:
        return ERR_DRAINING if e.reason == "draining" else ERR_BACKPRESSURE

    def _deadline_event(self, stage: str, trace_id: str) -> None:
        """Record the registered ``serve.deadline`` point event — the
        audit trail (and live counter, via the span bridge) of work
        cancelled before it ever reached the device."""
        self.tracer.spans.record("serve.deadline", time.perf_counter(),
                                 0.0, stage=stage, trace_id=trace_id)

    def _dispatch_admitted(self, t0: float, attrs: dict, arr: np.ndarray,
                           algo: str | None, faults_spec: str | None,
                           trace_id: str, deadline: float | None = None,
                           payload: np.ndarray | None = None,
                           spill: bool = False,
                           dataset: str | None = None,
                           ) -> tuple[str, Any, dict]:
        """Dispatch an ALREADY-ADMITTED request and wait for completion.
        The caller owns the admission release.  ``payload``
        routes through the record sort; ``spill`` through the
        out-of-core tier — both solo by construction (the packed path
        is keys-only and in-memory).  ``dataset`` keys the
        spill tier's journaled manifest for crash/retry resume."""
        width = int(payload.shape[1]) if payload is not None else 0
        req = ServeRequest(
            arr=arr, dtype=np.dtype(arr.dtype),
            algo=algo or self.default_algo,
            batchable=(faults_spec is None and not spill and width == 0
                       and int(arr.size) <= self.batch_keys),
            faults=faults_spec, trace_id=trace_id, deadline=deadline,
            payload=payload, payload_width=width, spill=spill,
            dataset=dataset)
        # serve auto-tuning: every admitted request feeds
        # the rolling mix the window/bucket policies learn from
        self._tuner_observe(int(arr.size), req.dtype.name)
        if req.expired():
            # stage "admission": the deadline died while the payload
            # was read/admitted — never enqueued, never dispatched
            req.fail_deadline("admission")
            attrs["deadline_stage"] = "admission"
            self._deadline_event("admission", trace_id)
            return self._finish(t0, attrs, req.error[0], req.error[1])
        with self._inflight_lock:
            self._inflight_reqs[trace_id] = req
        try:
            self.batcher.submit(req)
            if not req.done.wait(self.completion_timeout_s):
                return self._finish(t0, attrs, ERR_INTERNAL,
                                    "dispatch timed out")
        finally:
            with self._inflight_lock:
                self._inflight_reqs.pop(trace_id, None)
        attrs["batched"] = req.batched
        if req.bucket is not None:
            attrs["bucket"] = req.bucket
        if req.batch_id is not None:
            attrs["batch_id"] = req.batch_id
        if req.plan is not None:
            attrs["plan"] = req.plan
        if req.queue_s is not None:
            attrs["queue_s"] = round(req.queue_s, 6)
        if req.error is not None:
            if req.error[0] == ERR_DEADLINE_EXCEEDED:
                attrs["deadline_stage"] = req.deadline_stage
                self._deadline_event(req.deadline_stage or "queue",
                                     trace_id)
            return self._finish(t0, attrs, req.error[0], req.error[1])
        if req.result_run is not None:            # spill tier
            attrs["spilled"] = True
            return self._finish(t0, attrs, "ok", req.result_run)
        if req.payload_width:                     # record sort
            return self._finish(t0, attrs, "ok",
                                (req.result, req.result_payload))
        return self._finish(t0, attrs, "ok", req.result)

    def _tuner_observe(self, n: int, dtype_name: str = "int32") -> None:
        """Feed the serve tuner one admitted request and,
        every RETUNE_EVERY observations, evaluate the mix.  A committed
        recommendation re-sizes the live batching window (`on` mode
        only — `shadow` logs the would-have-been retune and changes
        nothing) and background-prewarms any (bucket, dtype) pair the
        observed size/dtype mix says it needs.  Every commit is a
        registered `planner` plan decision in the span stream, so
        window drift is explainable from the same record as everything
        else."""
        tuner = self.tuner
        if tuner is None:
            return
        if not tuner.observe(time.monotonic(), n, dtype_name):
            return
        verdict = tuner.evaluate()
        if verdict is None or verdict[0] != "retune":
            return
        _action, rec = verdict
        applied = self.planner_mode == "on"
        want = tuple(sorted({
            segmented.bucket_for(int(rec["p99_n"])),
            segmented.bucket_for(int(rec["expected_batch_keys"]))}))
        dtypes = tuple(rec.get("dtypes") or ("int32",))
        missing = self.cache.missing_packed(want, dtypes)
        if applied:
            self.batcher.set_window(rec["window_s"])
            self.metrics.counter(
                "sort_serve_window_retunes_total").inc(1)
            self.metrics.gauge("sort_serve_batch_window_ms").set(
                rec["window_s"] * 1e3)
            if missing:
                # warm off the request path, on the dispatch thread
                # between dispatches: it is the only thread that touches
                # the card (the reference compiles on a detached thread)
                def _prewarm(cache=self.cache, pairs=missing):
                    for dn in sorted({d for _b, d in pairs}):
                        cache.prewarm(tuple(sorted(
                            b for b, d in pairs if d == dn)), (dn,))
                self.batcher.call_soon(_prewarm)
        if missing:
            # its own plan event: a SortPlan keys decisions by name, so
            # the bucket verdict cannot ride the window_auto record —
            # and shadow logs the would-have-been prewarm too
            bplan = plan_mod.SortPlan(algo="serve_tuner")
            bplan.decide("planner", chosen="buckets_auto",
                         trigger="mix_shift", applied=applied,
                         buckets=sorted({int(b) for b, _d in missing}),
                         dtypes=sorted({d for _b, d in missing}))
            bplan.finalize()
            self.tracer.spans.event("sort.plan", **bplan.to_attrs())
        plan = plan_mod.SortPlan(algo="serve_tuner")
        plan.decide("planner", chosen="window_auto",
                    trigger="mix_shift", applied=applied,
                    window_ms=round(rec["window_s"] * 1e3, 3),
                    p50_gap_ms=round(rec["p50_gap_s"] * 1e3, 3),
                    p99_n=rec["p99_n"],
                    expected_batch_keys=rec["expected_batch_keys"])
        plan.finalize()
        self.tracer.spans.event("sort.plan", **plan.to_attrs())

    def stuck_trace_ids(self) -> list[str]:
        """Trace ids of requests admitted+dispatched but not yet
        complete — what the drain-timeout incident artifact names."""
        with self._inflight_lock:
            return sorted(self._inflight_reqs)

    def _admit(self, nbytes: int) -> None:
        """Admission with the circuit breaker consulted FIRST: while the
        breaker is open a request is rejected in
        microseconds — clients back off instead of queueing behind a
        wedged dispatch."""
        if self.breaker.engaged():
            self.admission.note_reject()
            raise AdmissionReject(
                "breaker",
                "circuit breaker open (dispatch watchdog tripped); "
                "retry with backoff")
        self.admission.admit(nbytes)

    def execute(self, arr: np.ndarray, algo: str | None = None,
                faults_spec: str | None = None,
                trace_id: str | None = None,
                deadline_ms: float | None = None,
                payload: np.ndarray | None = None,
                ) -> tuple[str, Any, dict]:
        """Admit, dispatch and complete one request (the in-process
        entry; the wire path admits BEFORE materializing the payload —
        see :meth:`handle_wire`).  Returns ``(status, payload, attrs)``
        where status ``"ok"`` carries the sorted array (a
        ``(keys, payload)`` pair for record requests) and any error
        status carries the detail string.  ``trace_id`` is minted when
        the caller supplies none; it lands in ``attrs`` and on every
        span the request touches.  ``deadline_ms`` (optional) is the
        caller's remaining latency budget: once it expires the request
        is cancelled typed ``deadline_exceeded`` at whatever lifecycle
        stage it had reached — never dispatched late.

        A request whose bytes exceed ``SORT_SERVE_MAX_BYTES`` outright
        routes to the spill tier instead of the typed
        ``bytes`` rejection — unless ``SORT_SERVE_SPILL=off``."""
        t0 = time.perf_counter()
        tid = trace_id or mint_trace_id()
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        pay = None
        if payload is not None:
            from mpitest_tpu_torch.models.records import as_payload_matrix

            pay = as_payload_matrix(payload, int(arr.size))
        nbytes = int(arr.nbytes) + (int(pay.nbytes) if pay is not None
                                    else 0)
        attrs: dict = {"n": int(arr.size), "dtype": str(arr.dtype),
                       "trace_id": tid}
        spill = False
        if (nbytes > self.admission.max_bytes and self.spill_enabled
                and faults_spec is None and self.spill_disk_ok(nbytes)):
            # the request can NEVER fit the byte bound — the spill
            # tier serves it from disk under count-only admission
            # (no disk headroom ⇒ fall through to the byte rejection)
            spill = True
            attrs["spilled"] = True
            nbytes = 0
        try:
            self._admit(nbytes)
        except AdmissionReject as e:
            attrs["reject"] = e.reason
            return self._finish(t0, attrs, self.reject_code(e), str(e))
        if spill:
            self.metrics.counter(
                "sort_external_spilled_requests_total").inc(1)
        try:
            status, result, attrs = self._dispatch_admitted(
                t0, attrs, arr, algo, faults_spec, tid, deadline,
                payload=pay, spill=spill)
        finally:
            self.admission.release(nbytes)
        if status == "ok" and spill:
            # in-process callers want arrays, not the output run: read
            # it back (the run files are unlinked once viewed)
            from mpitest_tpu_torch.store import runs as runlib

            views = runlib.run_body_views(result, unlink=True)
            keys = np.frombuffer(views[0], dtype=arr.dtype).copy()
            if pay is not None:
                out_pay = np.frombuffer(
                    views[1], np.uint8).reshape(pay.shape).copy()
                return status, (keys, out_pay), attrs
            return status, keys, attrs
        return status, result, attrs

    # -- wire handling ------------------------------------------------
    def wire_timeout(self, kind: str) -> None:
        """Tally one enforced wire timeout (kind: idle|read|write) —
        the live evidence a slow-loris is being shed, not served."""
        self.metrics.counter("sort_serve_timeouts_total").inc(
            1, kind=kind)

    def _read_wire(self, rfile: BinaryIO, nbytes: int,
                   conn: "socket.socket | None",
                   keep: bool = True,
                   sink: Any = None) -> tuple[bytes, str]:
        """Read exactly ``nbytes`` under ONE total wall budget
        (``SORT_SERVE_READ_TIMEOUT_S``).  On a socket the loop uses
        ``read1`` — AT MOST ONE underlying ``recv`` per call — with
        the timeout re-armed to the remaining budget before each, so
        the deadline is re-checked per recv: neither a dead stall nor
        a slow drip (whose every tiny chunk "makes progress" and so
        never trips a per-recv timeout) can hold the thread past the
        budget.  Returns ``(data, outcome)`` with outcome
        ``"ok"``, ``"short"`` (EOF / reset) or ``"timeout"``;
        ``keep=False`` drops the bytes (the discard path) instead of
        accumulating them, and ``sink`` (a callable taking one bytes
        chunk — the spill tier's disk stage) consumes them without
        accumulation either way.  ``conn`` None (in-process callers
        reading from a BytesIO) reads unbounded — there is no socket to
        stall."""
        chunks: list[bytes] = []
        got = 0
        deadline = (time.monotonic() + self.read_timeout_s
                    if conn is not None else None)
        read1 = getattr(rfile, "read1", None)
        while got < nbytes:
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return b"".join(chunks), "timeout"
                try:
                    conn.settimeout(remaining)
                except OSError:
                    return b"".join(chunks), "short"
            want = min(nbytes - got, 1 << 20)
            try:
                # read1 never blocks across multiple recvs; a plain
                # buffered read(N) would recv in a loop internally,
                # giving EVERY recv the full remaining budget and
                # stretching the total far past the deadline
                chunk = (read1(want) if read1 is not None
                         else rfile.read(want))
            except TimeoutError:
                return b"".join(chunks), "timeout"
            except OSError:
                return b"".join(chunks), "short"
            if not chunk:
                return b"".join(chunks), "short"
            if sink is not None:
                sink(chunk)
            elif keep:
                chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks), "ok"

    def _read_header_line(self, rfile: BinaryIO,
                          conn: "socket.socket",
                          ) -> tuple[bytes, str]:
        """Read one header line under two TOTAL budgets: the idle
        timeout bounds the wait for the FIRST byte (a keep-alive
        connection sitting between requests), the read timeout bounds
        the rest of the line (a header dripped byte-by-byte must not
        reset the clock per recv — a plain ``readline`` would).  Uses
        ``read1(1)``: at most one raw recv per call, and anything the
        recv buffered past the requested byte stays in the
        BufferedReader for the payload reads.  Returns ``(line,
        outcome)`` with outcome ``ok`` | ``idle`` | ``read`` (the
        timeout kinds) | ``closed`` (EOF / reset / over-long)."""
        line = bytearray()
        read1 = rfile.read1
        deadline = time.monotonic() + self.idle_timeout_s
        phase = "idle"
        while len(line) < (1 << 16):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return bytes(line), phase
            try:
                conn.settimeout(remaining)
                b = read1(1)
            except TimeoutError:
                return bytes(line), phase
            except OSError:
                return bytes(line), "closed"
            if not b:
                return bytes(line), "closed"
            line += b
            if phase == "idle":
                # first byte landed: this is now a request read, on
                # the request-read budget
                phase = "read"
                deadline = time.monotonic() + self.read_timeout_s
            if b == b"\n":
                return bytes(line), "ok"
        return bytes(line), "closed"

    def write_wire(self, conn: "socket.socket",
                   blob: "bytes | list") -> str:
        """Send a response under ONE total wall budget (the read
        timeout): per-``send`` socket timeouts reset on any progress,
        so a client reading one byte per interval could otherwise pin
        the handler thread for hours on a large payload.  ``blob`` may
        be a list of byte-like segments (the spill tier's zero-copy
        run views) — all segments share the one budget.  Returns
        ``"ok"``, ``"timeout"`` or ``"closed"``."""
        segments = blob if isinstance(blob, list) else [blob]
        deadline = time.monotonic() + self.read_timeout_s
        for seg in segments:
            view = memoryview(seg)
            off = 0
            while off < len(view):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.wire_timeout("write")
                    return "timeout"
                try:
                    conn.settimeout(remaining)
                    off += conn.send(view[off:off + (1 << 20)])
                except TimeoutError:
                    self.wire_timeout("write")
                    return "timeout"
                except OSError:
                    return "closed"
        return "ok"

    def _discard(self, rfile: BinaryIO, nbytes: int,
                 conn: "socket.socket | None" = None) -> bool:
        """Read and drop ``nbytes`` of payload — keeps the
        connection's framing after a semantic rejection WITHOUT ever
        buffering the rejected payload (the admission byte bound must
        bound memory, not just dispatch).  Same bounded reader, same
        total time budget.  Returns False on a short read or timeout
        (framing lost)."""
        _data, outcome = self._read_wire(rfile, nbytes, conn, keep=False)
        if outcome == "timeout":
            self.wire_timeout("read")
        return outcome == "ok"

    def handle_wire(self, header_line: bytes, rfile: BinaryIO,
                    conn: "socket.socket | None" = None,
                    ) -> tuple[dict, bytes, bool]:
        """One request from the wire: parse the header, ADMIT (the
        payload only enters host memory after the admission byte/count
        bounds said yes), read the payload, execute, build the
        response.  Returns ``(response header, response payload,
        keep_alive)`` — ``keep_alive`` False means framing is lost
        (unreadable header / short payload / read timeout) and the
        connection must close.  ``conn`` (the TCP layer passes its
        socket) arms the total read budget; in-process callers reading
        from a BytesIO pass None and read unbounded."""
        tid: str | None = None   # echoed in every response once known

        def err(code: str, detail: str, keep: bool = True,
                ) -> tuple[dict, bytes, bool]:
            h = {"v": WIRE_SCHEMA, "ok": False, "error": code,
                 "detail": detail}
            if tid is not None:
                h["trace_id"] = tid
            return (h, b"", keep)

        try:
            hdr = json.loads(header_line.decode("utf-8"))
            if not isinstance(hdr, dict):
                raise ValueError("header is not an object")
        except (UnicodeDecodeError, ValueError) as e:
            return err(ERR_BAD_REQUEST, f"unreadable header: {e}",
                       keep=False)
        if hdr.get("v") != WIRE_SCHEMA:
            return err(ERR_BAD_REQUEST,
                       f"unknown protocol version {hdr.get('v')!r} "
                       f"(want {WIRE_SCHEMA!r})", keep=False)
        # trace context, parsed FIRST among the fields so
        # every later typed error echoes it — a client correlating
        # failures by its minted id must never lose one to a bad dtype.
        raw_tid = hdr.get("trace_id")
        if raw_tid is not None and (
                not isinstance(raw_tid, str)
                or not _TRACE_ID_RE.fullmatch(raw_tid)):
            return err(ERR_BAD_REQUEST,
                       f"bad trace_id {raw_tid!r} (1-64 chars of "
                       "[A-Za-z0-9_-])", keep=False)
        tid = raw_tid or mint_trace_id()
        # dataset_id: client-chosen stable id keying the
        # spill tier's journaled manifest — a retried request with the
        # same id warm-resumes at the merge phase.  Same grammar as
        # trace_id (it becomes a spill-dir filename stem).
        dataset_id = hdr.get("dataset_id")
        if dataset_id is not None and (
                not isinstance(dataset_id, str)
                or not _TRACE_ID_RE.fullmatch(dataset_id)):
            return err(ERR_BAD_REQUEST,
                       f"bad dataset_id {dataset_id!r} (1-64 chars of "
                       "[A-Za-z0-9_-])", keep=False)
        try:
            dtype = np.dtype(str(hdr.get("dtype", "int32")))
            from mpitest_tpu_torch.ops.keys import codec_for

            codec_for(dtype)  # rejects valid-but-unsupported dtypes
        except Exception as e:  # noqa: BLE001 — typed wire error
            return err(ERR_BAD_REQUEST, f"bad dtype: {e}", keep=False)
        n = hdr.get("n")
        if not isinstance(n, int) or not 1 <= n <= MAX_REQUEST_KEYS:
            return err(ERR_BAD_REQUEST,
                       f"bad n={n!r} (integer in [1, {MAX_REQUEST_KEYS}])",
                       keep=False)
        # payload_bytes: per-record payload width.  The
        # payload section (n * payload_bytes raw bytes) follows the key
        # bytes; the reply mirrors the framing with the payload
        # permuted into key order.
        width = hdr.get("payload_bytes", 0)
        if not isinstance(width, int) or isinstance(width, bool) or \
                not 0 <= width <= MAX_PAYLOAD_WIDTH:
            return err(ERR_BAD_REQUEST,
                       f"bad payload_bytes={width!r} (integer in "
                       f"[0, {MAX_PAYLOAD_WIDTH}])", keep=False)
        nbytes = n * (dtype.itemsize + width)
        # deadline_ms: the client's remaining latency budget
        # becomes an ABSOLUTE monotonic deadline right here, carried
        # through admission -> queue -> dispatch; expired work is
        # cancelled typed, never dispatched.
        deadline_ms = hdr.get("deadline_ms")
        deadline: float | None = None
        if deadline_ms is not None:
            ok_num = (isinstance(deadline_ms, (int, float))
                      and not isinstance(deadline_ms, bool)
                      and math.isfinite(float(deadline_ms))
                      and float(deadline_ms) > 0)
            if not ok_num:
                keep = self._discard(rfile, nbytes, conn)
                return err(ERR_BAD_REQUEST,
                           f"bad deadline_ms {deadline_ms!r} (a finite "
                           "number of milliseconds > 0)", keep=keep)
            deadline = time.monotonic() + float(deadline_ms) / 1e3
        algo = hdr.get("algo")
        if algo is not None and algo not in ("radix", "sample"):
            # payload not read yet: framing is recoverable only by
            # draining it (bounded chunks) before responding
            keep = self._discard(rfile, nbytes, conn)
            return err(ERR_BAD_REQUEST,
                       f"bad algo {algo!r} (radix | sample)", keep=keep)
        faults_spec = hdr.get("faults")
        if faults_spec is not None:
            if not self.allow_faults:
                keep = self._discard(rfile, nbytes, conn)
                return err(ERR_BAD_REQUEST,
                           "per-request fault injection requires "
                           "SORT_SERVE_ALLOW_FAULTS=1 on the server",
                           keep=keep)
            try:
                faults.FaultRegistry(str(faults_spec))
            except ValueError as e:
                keep = self._discard(rfile, nbytes, conn)
                return err(ERR_BAD_REQUEST, str(e), keep=keep)
        # Admission BEFORE the payload is materialized: a rejected
        # request is drained in bounded chunks, so the in-flight byte
        # bound really bounds host memory, not just dispatch.
        t0 = time.perf_counter()
        attrs: dict = {"n": n, "dtype": dtype.name, "trace_id": tid}
        if width:
            attrs["payload_bytes"] = width
        if (nbytes > self.admission.max_bytes and self.spill_enabled
                and faults_spec is None and self.spill_disk_ok(nbytes)):
            # spill tier: the request can NEVER fit the
            # byte bound — stream it to disk and serve it out-of-core
            # instead of the old typed 'bytes' rejection.  No disk
            # headroom (3x the request) ⇒ the ordinary typed rejection
            # below, never an untyped OSError mid-stage.
            return self._spill_wire(t0, attrs, rfile, conn, n, dtype,
                                    width, algo, tid, deadline, err,
                                    dataset_id)
        try:
            self._admit(nbytes)
        except AdmissionReject as e:
            attrs["reject"] = e.reason
            code, detail, _ = self._finish(t0, attrs,
                                           self.reject_code(e), str(e))
            keep = self._discard(rfile, nbytes, conn)
            return err(code, str(detail), keep=keep)
        try:
            # the TOTAL read budget (SORT_SERVE_READ_TIMEOUT_S) starts
            # here: a client that stalls mid-payload — or drips one
            # byte per second — is disconnected at the budget, and the
            # finally below provably reclaims its admission bytes on
            # THIS exit path like every other.
            payload, outcome = self._read_wire(rfile, nbytes, conn)
            if outcome != "ok":
                if outcome == "timeout":
                    self.wire_timeout("read")
                detail = (f"payload read "
                          f"{'timed out' if outcome == 'timeout' else 'short'}"
                          f" ({len(payload)}/{nbytes} bytes)")
                # post-admission outcome like any other: it must land
                # in the serve.request span stream / error tally too
                self._finish(t0, attrs, ERR_BAD_REQUEST, detail)
                return err(ERR_BAD_REQUEST, detail, keep=False)
            key_bytes = n * dtype.itemsize
            arr = np.frombuffer(payload[:key_bytes], dtype=dtype).copy()
            pay = None
            if width:
                pay = np.frombuffer(
                    payload[key_bytes:], np.uint8).reshape(n,
                                                           width).copy()
            del payload
            status, result, attrs = self._dispatch_admitted(
                t0, attrs, arr, algo,
                str(faults_spec) if faults_spec is not None else None,
                tid, deadline, payload=pay)
        finally:
            self.admission.release(nbytes)
        if status != "ok":
            return err(status, str(result))
        return self._ok_response(n, dtype, width, attrs, tid, result)

    def _ok_response(self, n: int, dtype: np.dtype, width: int,
                     attrs: dict, tid: str, result: Any,
                     ) -> tuple[dict, Any, bool]:
        """Build the ok wire response.  ``result`` is the sorted array,
        a ``(keys, payload)`` pair (records) or a
        :class:`~mpitest_tpu_torch.store.runs.RunInfo` (spill tier — the
        reply streams zero-copy memoryviews of the output run)."""
        resp = {"v": WIRE_SCHEMA, "ok": True, "n": n,
                "dtype": dtype.name,
                "batched": bool(attrs.get("batched")),
                "bucket": attrs.get("bucket"),
                "trace_id": tid}
        if width:
            resp["payload_bytes"] = width
        if attrs.get("spilled"):
            resp["spilled"] = True
        if attrs.get("batch_id") is not None:
            resp["batch_id"] = attrs["batch_id"]
        if attrs.get("plan") is not None:
            # compact decision digest: algo, negotiated cap,
            # restage verdict, regret — decision drift is observable
            # from the client side without the span stream
            resp["plan"] = attrs["plan"]
        if attrs.get("spilled"):
            from mpitest_tpu_torch.store import runs as runlib

            return resp, runlib.run_body_views(result, unlink=True), True
        if width:
            keys, pay = result
            return resp, (np.ascontiguousarray(keys).tobytes()
                          + np.ascontiguousarray(pay).tobytes()), True
        return resp, np.ascontiguousarray(result).tobytes(), True

    def _spill_wire(self, t0: float, attrs: dict, rfile: BinaryIO,
                    conn: "socket.socket | None", n: int,
                    dtype: np.dtype, width: int, algo: str | None,
                    tid: str, deadline: float | None,
                    err: Any,
                    dataset_id: str | None = None) -> tuple[dict, Any, bool]:
        """The wire spill tier: stream the over-budget request's bytes
        straight from the socket into spill-dir staging files (host
        memory never holds them), dispatch the external sort over the
        staged memmaps, and reply from the merged output run.  Admitted
        under the COUNT bound only (bytes live on disk); the staged
        and output files are unlinked as soon as they are mapped, so no
        exit path can leak them."""
        from mpitest_tpu_torch.store import external
        from mpitest_tpu_torch.store import runs as runlib

        attrs["spilled"] = True
        try:
            self._admit(0)
        except AdmissionReject as e:
            attrs["reject"] = e.reason
            code, detail, _ = self._finish(t0, attrs,
                                           self.reject_code(e), str(e))
            keep = self._discard(rfile, n * (dtype.itemsize + width),
                                 conn)
            return err(code, str(detail), keep=keep)
        self.metrics.counter(
            "sort_external_spilled_requests_total").inc(1)
        # staging/output names carry a SERVER-minted nonce, never the
        # client-supplied trace_id: two concurrent requests reusing one
        # trace_id (only grammar-checked) must not share disk paths —
        # interleaved staged bytes would be folded as-is and VERIFY
        # cleanly while carrying the other client's data.
        nonce = mint_trace_id()
        try:
            stage = runlib.InputStage(
                external.resolve_spill_dir(None), f"in_{nonce}", dtype,
                n, width)
            try:
                _, outcome = self._read_wire(rfile, n * dtype.itemsize,
                                             conn, sink=stage.key_sink)
                if outcome == "ok" and width:
                    _, outcome = self._read_wire(rfile, n * width, conn,
                                                 sink=stage.pay_sink)
                if outcome != "ok":
                    if outcome == "timeout":
                        self.wire_timeout("read")
                    stage.abort()
                    detail = (f"payload read "
                              f"{'timed out' if outcome == 'timeout' else 'short'}"
                              " (spill tier)")
                    self._finish(t0, attrs, ERR_BAD_REQUEST, detail)
                    return err(ERR_BAD_REQUEST, detail, keep=False)
                arr, pay = stage.finish()
            except runlib.RunFormatError as e:
                self._finish(t0, attrs, ERR_INTERNAL, str(e))
                return err(ERR_INTERNAL, str(e), keep=False)
            except OSError as e:
                # ENOSPC while staging: typed retryable
                # rejection, partial staging files already unlinked
                stage.abort()
                if e.errno != errno.ENOSPC:
                    raise
                self._finish(t0, attrs, ERR_BACKPRESSURE, str(e))
                return err(ERR_BACKPRESSURE, str(e), keep=False)
            status, result, attrs = self._dispatch_admitted(
                t0, attrs, arr, algo, None, tid, deadline, payload=pay,
                spill=True, dataset=dataset_id)
        finally:
            self.admission.release(0)
        if status != "ok":
            return err(status, str(result))
        return self._ok_response(n, dtype, width, attrs, tid, result)

    # -- lifecycle ----------------------------------------------------
    def start_drain(self) -> None:
        self.admission.start_drain()

    def drain_and_stop(self, timeout: float = 60.0) -> bool:
        """SIGTERM semantics: reject new work (typed ``draining``), let
        in-flight requests complete, stop the dispatch thread and the
        watchdog.  Returns True ONLY when everything drained AND the
        dispatch thread actually exited inside ``timeout`` — a wedged
        dispatch is a dirty exit, not a quiet one (the
        join() outcome used to be silently discarded here)."""
        self.start_drain()
        idle = self.admission.wait_idle(timeout)
        stopped = self.batcher.stop(timeout=10.0)
        self.watchdog.stop()
        return idle and stopped


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        core: ServerCore = self.server.core  # type: ignore[attr-defined]
        while True:
            # idle bound for the wait, read bound for the line itself
            #: both TOTAL budgets, not per-recv timeouts
            line, outcome = core._read_header_line(self.rfile,
                                                   self.connection)
            if outcome in ("idle", "read"):
                core.wire_timeout(outcome)
                return
            if outcome != "ok" or not line.strip():
                return
            resp, payload, keep = core.handle_wire(line, self.rfile,
                                                   self.connection)
            # response writes share the wire budget: a client that
            # stops (or trickles) reading cannot pin this thread on a
            # full send buffer.  A list payload (the spill tier's
            # zero-copy run views) streams segment by segment.
            header = json.dumps(resp).encode("utf-8") + b"\n"
            blob = ([header] + payload if isinstance(payload, list)
                    else header + payload)
            if core.write_wire(self.connection, blob) != "ok":
                return
            if not keep:
                return


class SortServer(socketserver.ThreadingTCPServer):
    """TCP front end over a :class:`ServerCore`.  Handler threads only
    parse/frame and block on completion events; all device work happens
    on the core's single dispatch thread."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, core: ServerCore, host: str, port: int) -> None:
        super().__init__((host, port), _Handler)
        self.core = core

    @property
    def bound_port(self) -> int:
        return int(self.server_address[1])
