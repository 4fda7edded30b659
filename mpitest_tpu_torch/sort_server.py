"""Sort-as-a-service entry point: the persistent server (port of
``drivers/sort_server.py``; it is to that driver what ``cli.py`` is to
``drivers/sort_cli.py``).

Usage::

    python -m mpitest_tpu_torch.sort_server      # knobs configure everything

The server runs on the card: its mesh is ``make_mesh()`` (``SORT_DEVICES``
ranks, default one; eight ranks share one card).  Without a card it
prints one ``[ERROR]`` line and exits 1; :func:`main` takes
``device="cpu"`` for a server on CPU ranks.

The contract is the reference driver's:

* knobs are validated fail-fast — garbage in any of them is one
  ``[ERROR]`` line and exit 1, never a traceback: ``SORT_SERVE_PORT`` (0 =
  ephemeral), ``SORT_SERVE_HOST``, ``SORT_SERVE_MAX_INFLIGHT`` /
  ``SORT_SERVE_MAX_BYTES`` (admission), ``SORT_SERVE_BATCH_WINDOW_MS`` /
  ``SORT_SERVE_BATCH_KEYS`` (batching), ``SORT_SERVE_SHAPE_BUCKETS`` /
  ``SORT_SERVE_PREWARM`` (executor cache and kernel build),
  ``SORT_SERVE_ALLOW_FAULTS`` (test mode), the lifecycle timeouts, the
  spill tier, the sentinel, plus every ordinary sort knob;
* startup prints ``sort_server listening on HOST:PORT`` (flushed) once
  the socket accepts, after the kernels are built and the buckets warm,
  then ``sort_server metrics on HOST:PORT`` for the telemetry side port
  (``SORT_METRICS_PORT``; -1 disables);
* ``SIGTERM`` / ``SIGINT`` drain: in-flight requests complete, new work
  gets a typed ``draining`` rejection, then the process exits 0 (1 when
  the drain timed out, with the stuck trace ids named);
* ``SIGQUIT`` dumps the flight recorder's ring and keeps serving.

``SORT_TRACE=<path>`` streams every ``serve.*`` span and the ordinary
sort spans as JSONL; ``python -m mpitest_tpu_torch.report`` renders the
p50/p99 SLO table from it.
"""

from __future__ import annotations

import signal
import sys
import threading
import time
from typing import Any

#: The knobs validated before any device work (the reference driver's
#: list, where the port has the knob).
_VALIDATED = (
    "SORT_SERVE_MAX_INFLIGHT", "SORT_SERVE_MAX_BYTES",
    "SORT_SERVE_BATCH_WINDOW_MS", "SORT_SERVE_BATCH_KEYS",
    "SORT_SERVE_SHAPE_BUCKETS", "SORT_SERVE_PREWARM",
    "SORT_SERVE_ALLOW_FAULTS",
    "SORT_SERVE_IDLE_TIMEOUT_S", "SORT_SERVE_READ_TIMEOUT_S",
    "SORT_SERVE_DISPATCH_TIMEOUT_S", "SORT_SERVE_BREAKER_BACKOFF_S",
    "SORT_SERVE_COMPLETION_TIMEOUT_S", "SORT_FAULT_STALL_MS",
    "SORT_TRACE_SAMPLE", "SORT_FLIGHT_RECORDER_SIZE",
    "SORT_FLIGHT_RECORDER_DIR", "SORT_PROFILE", "SORT_PROFILE_EVERY",
    "SORT_ALGO", "SORT_DTYPE", "SORT_DEVICES", "SORT_RANKS",
    "SORT_VERIFY", "SORT_MAX_RETRIES", "SORT_RETRY_BACKOFF",
    "SORT_FALLBACK", "SORT_FAULTS", "SORT_FAULTS_SEED",
    "SORT_LOCAL_ENGINE", "SORT_EXCHANGE_ENGINE",
    "SORT_NEGOTIATE", "SORT_RESTAGE", "SORT_RESTAGE_RATIO",
    "SORT_NATIVE_ENCODE", "SORT_PLAN",
    "SORT_PLANNER", "SORT_PLANNER_WINDOW", "SORT_PLANNER_HYSTERESIS",
    "SORT_SERVE_SPILL", "SORT_SPILL_DIR", "SORT_MEM_BUDGET",
    "SORT_MERGE_FANIN", "SORT_SPILL_COMPRESS", "SORT_SPILL_THROTTLE_MBPS",
    "SORT_RESUME", "SORT_SPILL_GC_AGE_S", "SORT_FAULT_ENOSPC_AT",
    "SORT_SENTINEL", "SORT_SENTINEL_WINDOW_S", "SORT_ALERT_BURN_RATE",
)


def _make_mesh(device: Any) -> Any:
    """The server's mesh: the card's (``make_mesh()``), or ``SORT_DEVICES``
    ranks (default one) on ``device`` when the caller names one."""
    from mpitest_tpu_torch.parallel.mesh import make_mesh
    from mpitest_tpu_torch.utils import knobs

    if device is None:
        return make_mesh()
    p = knobs.get("SORT_DEVICES") or 1
    return make_mesh(p, devices=[device] * p)


def main(argv: list[str] | None = None, device: Any = None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) != 1:
        print(f"Usage: {argv[0]}  (configuration rides the SORT_SERVE_* "
              "environment knobs)", file=sys.stderr)
        return 1

    from mpitest_tpu_torch.utils import knobs

    def err(msg: str) -> None:
        print(f"[ERROR] {msg}", file=sys.stderr)

    try:
        host = knobs.get("SORT_SERVE_HOST")
        port = knobs.get("SORT_SERVE_PORT")
        metrics_port = knobs.get("SORT_METRICS_PORT")
        knobs.validate(*_VALIDATED)
        from mpitest_tpu_torch.utils import native_encode

        native_encode.engine()  # =on with no usable library dies here
        mesh = _make_mesh(device)
    except (ValueError, RuntimeError) as e:
        err(str(e))
        return 1

    from mpitest_tpu_torch.serve.server import ServerCore, SortServer
    from mpitest_tpu_torch.utils import flight_recorder

    def log(msg: str) -> None:
        print(f"sort_server: {msg}", file=sys.stderr, flush=True)

    core = ServerCore(mesh)
    core.prewarm(log)
    # startup orphan GC: reclaim spill files no live manifest references
    # (age-gated, so a concurrent sort's fresh files are never swept)
    if knobs.get("SORT_SERVE_SPILL") != "off":
        from mpitest_tpu_torch.store import external as _external

        swept = _external.gc_spill_dir(tracer=core.tracer)
        if swept:
            log(f"spill GC: reclaimed {swept} orphaned file(s)")
    core.start_watchdog()
    try:
        server = SortServer(core, host, port)
    except OSError as e:
        err(f"cannot bind {host}:{port}: {e}")
        return 1
    telemetry = None
    if metrics_port >= 0:
        from mpitest_tpu_torch.serve.telemetry import TelemetryServer

        try:
            telemetry = TelemetryServer(core, host, metrics_port)
            telemetry.start()
        except OSError as e:
            err(f"cannot bind metrics port {host}:{metrics_port}: {e}")
            server.server_close()
            return 1
    stop = threading.Event()

    def on_signal(signum: int, frame: object) -> None:
        log(f"signal {signum}: draining (in-flight requests complete; "
            "new work gets a typed 'draining' rejection)")
        core.start_drain()
        stop.set()

    def on_sigquit(signum: int, frame: object) -> None:
        # an incident snapshot, not a shutdown
        path = flight_recorder.get().dump("sigquit")
        log(f"SIGQUIT: flight recorder dumped to {path or '(nothing)'}")

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGQUIT, on_sigquit)

    serve_thread = threading.Thread(target=server.serve_forever,
                                    name="serve-accept", daemon=True)
    serve_thread.start()
    print(f"sort_server listening on {host}:{server.bound_port}",
          flush=True)
    if telemetry is not None:
        print(f"sort_server metrics on {host}:{telemetry.bound_port}",
              flush=True)
    # a signal may land on another thread while this one sleeps in an
    # untimed wait, and Python runs its handler only here: wake up to run it
    while not stop.wait(0.5):
        pass
    drained = core.drain_and_stop(timeout=60.0)
    server.shutdown()
    server.server_close()
    if telemetry is not None:
        telemetry.shutdown()
        telemetry.server_close()
    if not drained:
        # a drain timeout is an incident: name the stuck requests, record
        # the typed drain_timeout evidence, dump the flight recorder
        stuck = core.stuck_trace_ids()
        core.tracer.spans.record(
            "serve.watchdog", time.perf_counter(), 0.0,
            event="drain_timeout", trace_ids=stuck)
        path = flight_recorder.get().dump("drain_timeout")
        log(f"drain TIMEOUT: {len(stuck)} request(s) still in flight "
            f"(trace_ids={stuck}); flight recorder dumped to "
            f"{path or '(nothing)'}")
        if knobs.get("SORT_SERVE_SPILL") != "off":
            from mpitest_tpu_torch.store import external as _external
            from mpitest_tpu_torch.store import manifest as _mfst

            live = _mfst.live_manifests(_external.resolve_spill_dir(None))
            if live:
                log("resumable spill datasets: "
                    + ", ".join(m.dataset for m in live)
                    + " (a restarted server re-enters them at the "
                    "merge phase)")
    log(f"drained={'clean' if drained else 'TIMEOUT'} "
        f"served_ok={core.requests_ok} errors={core.requests_err} "
        f"rejected={core.admission.rejected} "
        f"batches={core.batcher.batches} "
        f"watchdog_trips={core.breaker.trips} "
        f"cache_hits={core.cache.stats.hits} "
        f"cache_misses={core.cache.stats.misses}")
    return 0 if drained else 1


if __name__ == "__main__":
    sys.exit(main())
