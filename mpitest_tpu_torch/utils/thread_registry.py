"""Thread-root and lock vocabularies of the port — its concurrency registry
(port of ``mpitest_tpu/utils/thread_registry.py``).

The server is multi-threaded (the dispatch thread, the watchdog, span
observers, the telemetry side port, the ingest and egress pools, the
hedging client, the spill read-ahead and write-behind), and its
invariants ("only the dispatch thread touches the card", "locks nest in
one global order", "no build or blocking call under a lock") are checked
statically by the reference's ``tools/threadlint`` engine, run under this
registry with ``torch`` as the device surface
(``tests/test_torch_threadlint.py``).  The engine loads this module by
file path and never imports the package under lint.

The vocabulary is closed, as in the reference:

* every ``threading.Thread(target=...)``, pool submit target, handler
  entry and signal handler resolves to a :class:`ThreadRoot` (TL010);
* every ``threading.Lock()`` / ``RLock()`` / ``Condition()`` creation site
  carries a :class:`LockDecl` with a **rank** in one global acquisition
  order (TL011; TL002 checks the nesting).

``device_ok`` is the reference's ``jax_ok``: whether code reachable from
the root may touch the device surface (any ``torch.*`` call and the
kernel launchers of ``ops/_build.py``).  Granting it is a reviewed act.

Stdlib-only by design; imports nothing, not even :mod:`threading`.
"""

from __future__ import annotations

from dataclasses import dataclass

#: Valid values for :attr:`ThreadRoot.kind`.
ROOT_KINDS = ("thread", "pool", "handler", "signal", "main")


@dataclass(frozen=True)
class ThreadRoot:
    """One registered thread entry point.

    ``entry`` is the module-qualified function the thread runs (nested
    defs join with dots).  ``device_ok`` declares whether code reachable
    from this root may touch the device surface; the doc says why."""

    name: str
    kind: str
    entry: str
    device_ok: bool
    doc: str


@dataclass(frozen=True)
class LockDecl:
    """One registered lock instance site: ``module.Class.attr``,
    ``module.NAME`` or ``module.func.name``.  Holding a lock while taking
    another is legal only when the second one's ``rank`` is strictly
    greater; ``reentrant`` marks RLocks."""

    name: str
    rank: int
    site: str
    doc: str
    reentrant: bool = False


# ---------------------------------------------------------------- roots
#
# device_ok=True is the short, audited list: the dispatch loop (the one
# serve thread allowed at the card), the ingest transfer and egress fetch
# stages (copies to and from the card are their whole job), and the
# server process's main thread.

_P = "mpitest_tpu_torch"

THREAD_ROOTS: tuple[ThreadRoot, ...] = (
    # -- serve layer --------------------------------------------------
    ThreadRoot(
        "serve-dispatch", "thread", f"{_P}.serve.batching.Batcher._loop", True,
        "The dispatch thread, the only serve thread allowed at the card: "
        "sort(), the packed sort, the external sort, the read-backs, the "
        "executor cache's warm-ups, the tuner's warm-ups (call_soon) and "
        "the profiler hook all run here."),
    ThreadRoot(
        "serve-watchdog", "thread", f"{_P}.serve.watchdog.DispatchWatchdog._loop",
        False,
        "Ages the dispatch heartbeat and trips the breaker; its half-open "
        "probe goes through batcher.submit, so the dispatch thread runs "
        "the sort."),
    ThreadRoot(
        "serve-accept", "thread", f"{_P}.serve.server.SortServer.serve_forever",
        False,
        "socketserver accept loop (stdlib body); per-connection work runs "
        "on serve-wire-handler."),
    ThreadRoot(
        "serve-wire-handler", "handler", f"{_P}.serve.server._Handler.handle",
        False,
        "Per-connection wire handler: parses, admits and enqueues requests "
        "and frames replies from numpy arrays the dispatch thread made."),
    ThreadRoot(
        "serve-telemetry", "thread",
        f"{_P}.serve.telemetry.TelemetryServer.serve_forever", False,
        "Telemetry side-port accept loop (stdlib body); scrapes run on "
        "telemetry-http-handler."),
    ThreadRoot(
        "telemetry-http-handler", "handler", f"{_P}.serve.telemetry._Handler.do_GET",
        False,
        "/metrics /healthz /varz /alerts /flightrecorder /profile: "
        "read-only snapshots; arming a capture flips a count under the "
        "hook lock, and torch.profiler runs on the dispatch thread."),
    ThreadRoot(
        "client-hedge", "thread", f"{_P}.serve.client.ResilientClient._hedged.attempt",
        False,
        "A hedged request's attempt (primary and hedge share the entry): "
        "wire I/O against the server's socket."),
    # -- ingest / egress ----------------------------------------------
    ThreadRoot(
        "ingest-parse", "thread", f"{_P}.models.ingest.stream_to_mesh.parse_chunks",
        False,
        "Streamed-ingest producer: splits the host input into bounded "
        "queue chunks; host bytes only."),
    ThreadRoot(
        "ingest-enc", "pool", f"{_P}.models.ingest.stream_to_mesh.encode_one", False,
        "Encode workers: numpy or native codec folds of host chunks; the "
        "copy to the card belongs to ingest-xfer."),
    ThreadRoot(
        "ingest-xfer", "pool", f"{_P}.models.ingest.stream_to_mesh.transfer_one",
        True,
        "The one transfer thread: pinned staging and the copies on its own "
        "CUDA stream into the ranks' shards; copying to the card is its "
        "whole job, serialized so chunk k+1's encode overlaps chunk k's "
        "copy."),
    ThreadRoot(
        "egress-fetch", "pool", f"{_P}.models.ingest.stream_result_to_numpy.fetch",
        True,
        "Egress prefetch: copies shard k+1 to the host while the caller "
        "decodes shard k; reads card memory by design."),
    ThreadRoot(
        "io-parse", "pool", f"{_P}.utils.native_encode.parse_text_tokens", False,
        "Text-ingest parse workers (iter_key_chunks): native or numpy "
        "parsing of file blocks; no device access."),
    # -- external-sort spill IO ---------------------------------------
    ThreadRoot(
        "spill-readahead", "thread", f"{_P}.store.aio.ReadAhead._worker", False,
        "Per-run merge read-ahead: reads and decodes the next spill chunk "
        "while the merge consumes the current one; host bytes only."),
    ThreadRoot(
        "spill-writebehind", "thread", f"{_P}.store.aio.WriteBehind._worker", False,
        "Merge write-behind: drains output chunks into the run writer "
        "behind the emit loop; errors re-raise at the next append."),
    # -- the driver ---------------------------------------------------
    ThreadRoot(
        "signal-drain", "signal", f"{_P}.sort_server.main.on_signal", False,
        "SIGTERM/SIGINT: flips admission to draining and sets the stop "
        "event; never touches the card."),
    ThreadRoot(
        "signal-flight-dump", "signal", f"{_P}.sort_server.main.on_sigquit", False,
        "SIGQUIT: dumps the flight-recorder ring and keeps serving."),
    ThreadRoot(
        "server-main", "main", f"{_P}.sort_server.main", True,
        "The server process's main thread: the startup build (bounded by "
        "ops/_build.BUILD_TIMEOUT_S) and prewarm, then it parks on the "
        "stop event."),
    # -- selftest drills (the spawned-server gates) -------------------
    ThreadRoot(
        "chaos-accept", "thread", f"{_P}.selftest.wire_chaos.ChaosProxy._accept_loop",
        False, "Chaos proxy accept loop (wire-level fault injection)."),
    ThreadRoot(
        "chaos-conn", "thread", f"{_P}.selftest.wire_chaos.ChaosProxy._serve_conn",
        False, "Per-connection chaos pipe (downstream leg)."),
    ThreadRoot(
        "chaos-pipe-up", "thread", f"{_P}.selftest.wire_chaos.ChaosProxy._pipe_up",
        False, "Per-connection chaos pipe (upstream leg)."),
    ThreadRoot(
        "load-worker", "thread", f"{_P}.selftest.spawned.run_load.worker", False,
        "Closed-loop load worker: sends the mix over the wire protocol."),
    ThreadRoot(
        "durability-victim", "thread",
        f"{_P}.selftest.drills.kill_resume_leg.send_victim", False,
        "The kill drill's request, stranded by the SIGKILL."),
    ThreadRoot(
        "chaos-stalled-request", "thread",
        f"{_P}.selftest.drills.watchdog_leg.stalled_request", False,
        "The deliberately wedged request that trips the watchdog."),
)


# ---------------------------------------------------------------- locks
#
# One global acquisition order, ranks spaced by 5 as in the reference.
# Today's real nesting edges: admission -> metrics (the on_change
# publish), sentinel -> metrics (alert counters), spans.log ->
# spans.flush; the rest never nest.

LOCKS: tuple[LockDecl, ...] = (
    LockDecl("batcher.pending", 10, f"{_P}.serve.batching.Batcher._pending_lock",
             "Guards the incompatible-requests set-aside list."),
    LockDecl("breaker.state", 15, f"{_P}.serve.watchdog.CircuitBreaker._lock",
             "All breaker state transitions; leaf in practice."),
    LockDecl("admission.state", 20, f"{_P}.serve.admission.AdmissionControl._lock",
             "Admission byte and in-flight accounting; the on_change publish "
             "fires under it, so it ranks below the metrics lock."),
    LockDecl("sentinel.series", 25, f"{_P}.serve.sentinel.SortSentinel._lock",
             "Rolling alert series and cooldowns, written from every "
             "span-closing thread through the observer hook."),
    LockDecl("cache.entries", 30, f"{_P}.serve.executor_cache.ExecutorCache._lock",
             "Executor-cache entries and stats; get_packed warms a cold "
             "bucket under it by choice (cold-key dogpile), on the dispatch "
             "thread."),
    LockDecl("tuner.series", 35, f"{_P}.models.planner.ServeTuner._lock",
             "Tuner observation deques and retune bookkeeping."),
    LockDecl("batcher.heartbeat", 40, f"{_P}.serve.batching.Batcher._hb_lock",
             "Dispatch heartbeat cell, set and cleared around every "
             "executor call; aged by the watchdog."),
    LockDecl("spans.log", 45, f"{_P}.utils.spans.SpanLog._lock",
             "Span id allocation, retention and stacks; observers run after "
             "release."),
    LockDecl("spans.flush", 50, f"{_P}.utils.spans.SpanLog._flush_lock",
             "Serializes JSONL stream appends across threads."),
    LockDecl("flight.ring", 55, f"{_P}.utils.flight_recorder.FlightRecorder._lock",
             "Flight-recorder ring; reentrant because dump() snapshots "
             "while holding it.", reentrant=True),
    LockDecl("flight.singleton", 60, f"{_P}.utils.flight_recorder._SINGLETON_LOCK",
             "Double-checked init of the process flight recorder."),
    LockDecl("server.tally", 65, f"{_P}.serve.server.ServerCore._tally_lock",
             "requests_ok / requests_err counters (leaf)."),
    LockDecl("server.inflight", 70, f"{_P}.serve.server.ServerCore._inflight_lock",
             "The in-flight request map for stuck_trace_ids (leaf)."),
    LockDecl("profile.hook", 75, f"{_P}.serve.telemetry.ProfileHook._lock",
             "Profile-capture arm state; torch.profiler runs outside it on "
             "the dispatch thread."),
    LockDecl("faults.registry", 80, f"{_P}.faults.FaultRegistry._lock",
             "Fault budgets and rng; ingest workers poll concurrently."),
    LockDecl("build.loaded", 82, f"{_P}.ops._build._lock",
             "The loaded-library and pending-build tables; never held "
             "across an nvcc build (TL003 holds it to that)."),
    LockDecl("compress.load", 83, f"{_P}.store.compress._LOAD_LOCK",
             "One-time spill-codec library resolution."),
    LockDecl("runs.throttle", 84, f"{_P}.store.runs._THROTTLE_LOCK",
             "The shared spill-disk token bucket (SORT_SPILL_THROTTLE_MBPS); "
             "the sleep happens outside it."),
    LockDecl("native.load", 85, f"{_P}.utils.native_encode._LOAD_LOCK",
             "One-time native text-parser library resolution."),
    LockDecl("aio.readahead", 86, f"{_P}.store.aio.ReadAhead._lock",
             "Read-ahead IO/stall interval stats (leaf)."),
    LockDecl("aio.writebehind", 87, f"{_P}.store.aio.WriteBehind._lock",
             "Write-behind interval stats and the parked worker error (leaf)."),
    LockDecl("ingest.stream", 88, f"{_P}.models.ingest._StreamState.lock",
             "Streamed-ingest shared fold and stats state."),
    LockDecl("metrics.registry", 90, f"{_P}.utils.metrics_live.LiveMetrics._lock",
             "The live metric registry and every series update; ranks above "
             "admission and sentinel, which update metrics under their own "
             "locks (leaf)."),
    LockDecl("client.stats", 95, f"{_P}.serve.client.ResilientClient._stats_lock",
             "Client attempt and hedge accounting (leaf)."),
    LockDecl("selftest.chaos", 100, f"{_P}.selftest.wire_chaos.ChaosProxy._lock",
             "Chaos proxy connection and fault bookkeeping."),
    LockDecl("selftest.load", 101, f"{_P}.selftest.spawned.run_load.lock",
             "Load-generator latency and status accumulators."),
)

#: Lock objects reached through a second name: the admission Condition
#: wraps the admission lock, and Metric handles borrow the registry lock.
LOCK_ALIASES: dict[str, str] = {
    f"{_P}.serve.admission.AdmissionControl._idle":
        f"{_P}.serve.admission.AdmissionControl._lock",
    f"{_P}.utils.metrics_live.Metric._lock":
        f"{_P}.utils.metrics_live.LiveMetrics._lock",
}


# ------------------------------------------------- call-graph alias maps

#: ``module.Class.attr`` -> class qualname of the object stored there.
RECEIVER_TYPES: dict[str, str] = {
    f"{_P}.serve.server.ServerCore.batcher": f"{_P}.serve.batching.Batcher",
    f"{_P}.serve.server.ServerCore.cache": f"{_P}.serve.executor_cache.ExecutorCache",
    f"{_P}.serve.server.ServerCore.admission": f"{_P}.serve.admission.AdmissionControl",
    f"{_P}.serve.server.ServerCore.breaker": f"{_P}.serve.watchdog.CircuitBreaker",
    f"{_P}.serve.server.ServerCore.metrics": f"{_P}.utils.metrics_live.LiveMetrics",
    f"{_P}.serve.server.ServerCore.sentinel": f"{_P}.serve.sentinel.SortSentinel",
    f"{_P}.serve.server.ServerCore.tuner": f"{_P}.models.planner.ServeTuner",
    f"{_P}.serve.server.ServerCore.profiler": f"{_P}.serve.telemetry.ProfileHook",
    f"{_P}.serve.server.ServerCore.watchdog": f"{_P}.serve.watchdog.DispatchWatchdog",
    f"{_P}.serve.server.SortServer.core": f"{_P}.serve.server.ServerCore",
    f"{_P}.serve.server._Handler.server": f"{_P}.serve.server.SortServer",
    f"{_P}.serve.watchdog.DispatchWatchdog.core": f"{_P}.serve.server.ServerCore",
    f"{_P}.serve.watchdog.DispatchWatchdog.breaker": f"{_P}.serve.watchdog.CircuitBreaker",
    f"{_P}.serve.telemetry.TelemetryServer.core": f"{_P}.serve.server.ServerCore",
    f"{_P}.serve.telemetry._Handler.server": f"{_P}.serve.telemetry.TelemetryServer",
    f"{_P}.serve.sentinel.SortSentinel.spans": f"{_P}.utils.spans.SpanLog",
    f"{_P}.serve.sentinel.SortSentinel.metrics": f"{_P}.utils.metrics_live.LiveMetrics",
    f"{_P}.serve.executor_cache.ExecutorCache.spans": f"{_P}.utils.spans.SpanLog",
}

#: Constructor-injected callbacks: calling ``<site>(...)`` runs these.
ATTR_CALLS: dict[str, tuple[str, ...]] = {
    f"{_P}.serve.batching.Batcher.run_batch": (f"{_P}.serve.server.ServerCore._run_batch",),
    f"{_P}.serve.batching.Batcher.run_solo": (f"{_P}.serve.server.ServerCore._run_solo",),
    f"{_P}.serve.admission.AdmissionControl.on_change":
        (f"{_P}.serve.server.ServerCore._publish_admission",),
}

#: Factory functions -> class qualname of the returned object.
RETURN_TYPES: dict[str, str] = {
    f"{_P}.utils.flight_recorder.get": f"{_P}.utils.flight_recorder.FlightRecorder",
}

#: Dynamic fan-out the AST cannot see: span close runs the registered
#: observers (the metrics bridge and the sentinel) on whatever thread
#: closed the span.
EXTRA_EDGES: dict[str, tuple[str, ...]] = {
    f"{_P}.utils.spans.SpanLog._flush": (f"{_P}.serve.sentinel.SortSentinel.__call__",),
}


# ------------------------------------------------------ call surfaces

#: Attribute-chain heads that mean "the device surface" (TL001).
DEVICE_SURFACE_HEADS: tuple[str, ...] = ("torch",)

#: Call names (bare or attribute tail) that mean the device surface
#: without a ``torch.`` head: the kernel launcher of ``ops/_build.py``
#: and the executor cache's warm lookup.
DEVICE_SURFACE_CALLS: tuple[str, ...] = ("launch", "get_packed")

#: Blocking calls TL003 refuses under any registered lock, with the
#: label findings carry.
BLOCKING_CALLS: dict[str, str] = {
    "os.fsync": "fsync",
    "time.sleep": "sleep",
    "sleep": "sleep",
    "subprocess.run": "subprocess",
    "subprocess.Popen": "subprocess",
    "subprocess.check_output": "subprocess",
    "subprocess.check_call": "subprocess",
    "subprocess.call": "subprocess",
    ".communicate": "subprocess",
    ".sendall": "socket send",
    ".recv": "socket recv",
    ".recv_into": "socket recv",
    ".accept": "socket accept",
    ".connect": "socket connect",
}

#: Repo functions that compile (TL003's compile leg): the nvcc build.
COMPILE_FUNCS: tuple[str, ...] = (f"{_P}.ops._build.build",)

#: Calls that can block forever holding the GIL (TL005): none in the port
#: (its one compiler is a child process, bounded by BUILD_TIMEOUT_S).
GIL_WEDGE_CALLS: tuple[str, ...] = ()
GIL_WEDGE_HOME: tuple[str, ...] = ()

#: Attribute sites whose unlocked multi-root writes are documented
#: GIL-atomic single-reference swaps (TL004 exemptions).
ATOMIC_OK: tuple[str, ...] = (
    # live window resize: one float swap, re-read at every pack open
    f"{_P}.serve.batching.Batcher.window_s",
    f"{_P}.serve.batching.Batcher.window_retunes",
    # lazy flight-recorder hook bind: every racing writer stores the same
    # function object
    f"{_P}.utils.spans._flight_record",
)
