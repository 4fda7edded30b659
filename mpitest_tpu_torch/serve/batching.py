"""Multi-tenant batching: pack concurrent small requests into one dispatch
(port of ``mpitest_tpu/serve/batching.py``).

One dispatch of the packed program costs roughly the same wall time as a
dispatch for a single small request — the fixed per-launch overhead
(host staging, program launch, result sync) dominates at small N.  The
batcher therefore runs ONE dispatch thread that, on picking up a
batchable request, keeps collecting compatible requests for at most
``SORT_SERVE_BATCH_WINDOW_MS`` (or until ``SORT_SERVE_BATCH_KEYS`` keys
are packed) and hands the group to the server's batch runner — under
closed-loop small-request load, K tenants share one device launch
instead of paying K.

Compatibility is dtype equality (segments share one packed word
layout).  Requests that are too large, carry a per-request fault spec,
or arrive with batching disabled (window 0) dispatch alone, in arrival
order, on the same thread — a single dispatcher also serializes device
access, so batched and solo work never contend for the mesh.

The dispatch thread is the only thread that touches torch on the card
(every ``sort()``, packed sort and device read-back); request handler
threads only frame bytes, build numpy arrays, enqueue and wait on
per-request completion events.  :meth:`Batcher.call_soon` hands other
device work (the serve tuner's bucket warm-up) to the same thread.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

#: Sentinel that tells the dispatch thread to finish the queue and exit.
_STOP = object()

#: Typed error code of a request whose deadline expired before dispatch
#:.  Defined here (not in server.py) because the dispatch
#: loop is the layer that cancels expired work; the wire protocol
#: re-exports it as part of the stable error vocabulary.
ERR_DEADLINE = "deadline_exceeded"


@dataclass
class ServeRequest:
    """One admitted request riding the dispatch queue.  The handler
    thread blocks on ``done``; the dispatch thread fills exactly one of
    ``result`` / ``error`` and sets it."""

    arr: np.ndarray
    dtype: np.dtype
    algo: str
    batchable: bool
    faults: str | None = None
    #: per-record payload bytes: a ``(n, width)`` uint8
    #: matrix riding the keys through the record sort.  Payload
    #: requests dispatch solo (the packed path is keys-only).
    payload: np.ndarray | None = None
    payload_width: int = 0
    #: out-of-core spill-tier request: ``arr``/``payload``
    #: are disk-backed memmaps of the staged input and the dispatch
    #: runs the external sort; solo by construction.
    spill: bool = False
    #: client-chosen dataset id: keys the spill tier's
    #: journaled manifest, so a retried request of the same dataset
    #: warm-resumes at the merge phase instead of re-sorting.
    dataset: str | None = None
    #: wire/client-minted request trace id — stamped on every
    #: span this request touches via ``spans.trace_context``.
    trace_id: str = ""
    t_enq: float = field(default_factory=time.perf_counter)
    done: threading.Event = field(default_factory=threading.Event)
    result: np.ndarray | None = None
    #: record requests: the permuted payload, (n, width) uint8.
    result_payload: np.ndarray | None = None
    #: spill requests: the merged output run the reply streams from.
    result_run: object | None = None
    error: tuple[str, str] | None = None    # (code, detail)
    batched: bool = False
    bucket: int | None = None
    #: packed-dispatch identity this request shared (None for solo).
    batch_id: str | None = None
    #: seconds between enqueue and dispatch pickup (the queue wait the
    #: serve.request span + live histogram report).
    queue_s: float | None = None
    #: absolute monotonic deadline: work whose deadline
    #: expires before dispatch is cancelled typed, never dispatched.
    deadline: float | None = None
    #: lifecycle stage the deadline expired at (admission|queue|
    #: dispatch) — set by fail_deadline, read by the serve.deadline
    #: span emission.
    deadline_stage: str | None = None
    #: batching-window decision record: why the window
    #: closed, members collected, keys at close — the predicted side of
    #: the batch/bucket decision the server's plan stamps actuals onto.
    window: dict | None = None
    #: compact plan digest of the dispatch that served this request
    #: (models/plan.py SortPlan.digest()) — echoed in the wire response.
    plan: dict | None = None

    @property
    def n(self) -> int:
        return int(self.arr.size)

    def expired(self, now: float | None = None) -> bool:
        """True once the request's deadline has passed (False when no
        deadline was set)."""
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline

    def fail_deadline(self, stage: str) -> None:
        """Cancel this request typed ``deadline_exceeded`` — it was
        never dispatched; the admitting handler releases its bytes."""
        self.deadline_stage = stage
        self.fail(ERR_DEADLINE,
                  f"deadline expired before dispatch (at stage "
                  f"{stage!r}); the sort was never run")

    def picked_up(self) -> None:
        """Dispatch-thread pickup marker: fixes the queue wait."""
        if self.queue_s is None:
            self.queue_s = time.perf_counter() - self.t_enq

    def complete(self, out: np.ndarray, batched: bool,
                 bucket: int | None, batch_id: str | None = None,
                 plan: dict | None = None,
                 payload: np.ndarray | None = None,
                 run: object | None = None) -> None:
        self.result = out
        self.result_payload = payload
        self.result_run = run
        self.batched = batched
        self.bucket = bucket
        self.batch_id = batch_id
        if plan is not None:
            self.plan = plan
        self.done.set()

    def fail(self, code: str, detail: str) -> None:
        self.error = (code, detail)
        self.done.set()


class Batcher:
    """The dispatch loop.  ``run_batch(requests)`` / ``run_solo(request)``
    are the server's executors; both must complete/fail every request
    they are handed (the loop itself never touches results)."""

    def __init__(self, run_batch: Callable[[list[ServeRequest]], None],
                 run_solo: Callable[[ServeRequest], None],
                 window_s: float, batch_keys: int) -> None:
        self.run_batch = run_batch
        self.run_solo = run_solo
        self.window_s = float(window_s)
        self.batch_keys = int(batch_keys)
        self._q: "queue.Queue[object]" = queue.Queue()
        self._pending: list[object] = []  # incompatibles set aside
        self._pending_lock = threading.Lock()
        self._stopping = False
        self.batches = 0
        self.batched_requests = 0
        self.solo_requests = 0
        self.deadline_cancelled = 0
        #: live window re-sizes applied via set_window.
        self.window_retunes = 0
        #: dispatch heartbeat: (monotonic start, kind,
        #: trace_ids) while an executor call is live, None otherwise —
        #: the watchdog's only evidence, so it is set/cleared under a
        #: lock around EVERY executor call.
        self._hb_lock = threading.Lock()
        self._hb: "tuple[float, str, list[str]] | None" = None
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-dispatch", daemon=True)
        self._thread.start()

    def submit(self, req: ServeRequest) -> None:
        self._q.put(req)

    def call_soon(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the dispatch thread between dispatches: the one
        thread that touches the card also runs work that is not a
        request.  Errors of ``fn`` are dropped (the caller's work is
        best effort, the dispatch thread must survive it)."""
        self._q.put(fn)

    def set_window(self, window_s: float) -> None:
        """Re-size the batching window live (the serve
        tuner's actuator).  A single float attribute swap — GIL-atomic
        against the dispatch loop, which re-reads ``window_s`` at every
        pack open, so the new value governs the NEXT window and never
        tears one already collecting.  Callers own the hysteresis; this
        method just applies."""
        self.window_s = float(window_s)
        self.window_retunes += 1

    # -- watchdog surface ----------------------------------
    def inflight_dispatch(self) -> "tuple[float, str, list[str]] | None":
        """Snapshot of the live executor call: ``(age_s, kind,
        trace_ids)`` — None when the dispatch thread is between
        dispatches.  The watchdog polls this."""
        with self._hb_lock:
            hb = self._hb
        if hb is None:
            return None
        started, kind, tids = hb
        return (time.monotonic() - started, kind, tids)

    def fail_queued(self, code: str, detail: str) -> int:
        """Fail every request still waiting in the queue (typed) —
        called by the watchdog when the dispatch thread is wedged, so
        queued callers stop burning their completion timeout on work
        that will never start.  Returns the number failed."""
        failed = 0
        drained: list[object] = []
        while True:
            try:
                drained.append(self._q.get_nowait())
            except queue.Empty:
                break
        for item in drained:
            if isinstance(item, ServeRequest):
                if not item.done.is_set():
                    item.fail(code, detail)
                    failed += 1
            else:
                self._q.put(item)        # _STOP survives the purge
        with self._pending_lock:
            pending, self._pending = self._pending, []
        for req in pending:
            if not isinstance(req, ServeRequest):
                self._q.put(req)
                continue
            if not req.done.is_set():
                req.fail(code, detail)
                failed += 1
        return failed

    def _guarded(self, thunk: "Callable[[], None]",
                 reqs: list[ServeRequest], kind: str) -> None:
        """Run an executor under a blanket guard: the dispatch thread
        must survive ANY executor failure (the executors are typed
        internally, but e.g. a span-stream disk-full OSError escaping
        would otherwise kill the only thread that completes requests,
        wedging every future request for the full completion timeout).
        Requests the executor never completed fail typed instead.  The
        heartbeat brackets the call so the watchdog can age it."""
        with self._hb_lock:
            self._hb = (time.monotonic(), kind,
                        [r.trace_id for r in reqs])
        try:
            thunk()
        except BaseException as e:  # noqa: BLE001 — thread survival
            for r in reqs:
                if not r.done.is_set():
                    r.fail("internal",
                           f"dispatcher error: {type(e).__name__}: {e}")
        finally:
            with self._hb_lock:
                self._hb = None

    def stop(self, timeout: float = 60.0) -> bool:
        """Finish everything already enqueued, then stop the dispatch
        thread (the drain path: admission already rejects new work).
        Returns True iff the thread actually exited inside ``timeout``
        — a False here means a dispatch is wedged, and the caller
        (``ServerCore.drain_and_stop``) must NOT report a clean drain
        (the silently-discarded join() outcome, )."""
        self._q.put(_STOP)
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- dispatch loop ------------------------------------------------
    def _next(self, timeout: float | None) -> object | None:
        with self._pending_lock:
            if self._pending:
                return self._pending.pop(0)
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    @staticmethod
    def _deadline_close(req: ServeRequest, now: float) -> float:
        """Window-close instant for a deadline-carrying member: 90% of
        its remaining budget (>= 2 ms headroom), so the dispatch still
        happens inside the deadline instead of the pack consuming it
        to the last tick."""
        assert req.deadline is not None
        return req.deadline - max(0.002, 0.1 * (req.deadline - now))

    def _cancel_if_expired(self, req: ServeRequest, stage: str) -> bool:
        """Deadline gate at queue pickup: expired work is
        cancelled typed and NEVER dispatched — the device's time goes
        to requests someone is still waiting for.  (The executors run
        a final stage="dispatch" check at entry; this one catches the
        queue wait.)"""
        if req.expired():
            req.fail_deadline(stage)
            self.deadline_cancelled += 1
            return True
        return False

    def _loop(self) -> None:
        while True:
            item = self._next(timeout=0.1 if self._stopping else None)
            if item is None:
                if self._stopping and self._q.empty():
                    return
                continue
            if item is _STOP:
                self._stopping = True
                continue
            if callable(item):              # call_soon work
                try:
                    item()
                except Exception:  # noqa: BLE001 — thread survival
                    pass
                continue
            req = item  # type: ignore[assignment]
            if not isinstance(req, ServeRequest):
                continue
            if self._cancel_if_expired(req, "queue"):
                continue
            if not req.batchable or req.faults is not None:
                self.solo_requests += 1
                # kind "spill" lets the watchdog age the (legitimately
                # long) out-of-core dispatch against the completion
                # bound instead of the per-dispatch one
                self._guarded(lambda r=req: self.run_solo(r), [req],
                              "spill" if req.spill else "solo")
                continue
            batch = [req]
            total = req.n
            closed_by = "keys" if total >= self.batch_keys else (
                "solo" if self.window_s <= 0 else "window")
            if self.window_s > 0:
                # the window closes at the EARLIEST member deadline,
                # less dispatch headroom (10% of the member's remaining
                # budget, >= 2 ms): holding a deadline-carrying request
                # open for the full window could expire it in the pack,
                # and closing exactly AT the deadline would hand the
                # dispatch a request already dead on arrival
                now = time.monotonic()
                close = now + self.window_s
                #: True once a member deadline shortened the window —
                #: a time-based close is then a "deadline" close, not a
                #: full "window" (the plan's trigger must say which)
                deadline_clamped = False
                if req.deadline is not None:
                    dc = self._deadline_close(req, now)
                    if dc < close:
                        close, deadline_clamped = dc, True
                while total < self.batch_keys:
                    slack = close - time.monotonic()
                    if slack <= 0:
                        if deadline_clamped:
                            closed_by = "deadline"
                        break
                    try:
                        nxt = self._q.get(timeout=slack)
                    except queue.Empty:
                        if deadline_clamped:
                            closed_by = "deadline"
                        break
                    if nxt is _STOP:
                        self._stopping = True
                        continue
                    if callable(nxt):
                        with self._pending_lock:
                            self._pending.append(nxt)
                        continue
                    cand = nxt  # type: ignore[assignment]
                    if not isinstance(cand, ServeRequest):
                        continue
                    if self._cancel_if_expired(cand, "queue"):
                        continue
                    if (cand.batchable and cand.faults is None
                            and cand.dtype == req.dtype
                            and total + cand.n <= self.batch_keys):
                        batch.append(cand)
                        total += cand.n
                        if total >= self.batch_keys:
                            closed_by = "keys"
                        if cand.deadline is not None:
                            dc = self._deadline_close(cand,
                                                      time.monotonic())
                            if dc < close:
                                close, deadline_clamped = dc, True
                    else:
                        # incompatible (dtype mix, solo-only, or the
                        # batch would overflow): set it aside for the
                        # next iteration and close this batch — simple
                        # FIFO fairness beats clever repacking at a
                        # 2 ms window
                        with self._pending_lock:
                            self._pending.append(cand)
                        # a same-dtype batchable candidate can only be
                        # deferred by the capacity bound — that is a
                        # "keys" (full) close, not an incompatibility
                        closed_by = ("keys" if (cand.batchable
                                                and cand.faults is None
                                                and cand.dtype == req.dtype)
                                     else "incompatible")
                        break
            # final deadline sweep AFTER the window: members that
            # expired while the pack collected are cancelled here, so
            # the batches/batched_requests tallies below count only
            # work actually handed to the executor (they must
            # reconcile with the serve.batch span stream)
            batch = [r for r in batch
                     if not self._cancel_if_expired(r, "dispatch")]
            if not batch:
                continue
            # window decision record: why this pack closed
            # and what it will actually dispatch — keys recounted AFTER
            # the deadline sweep above, or the batch plan's predicted
            # bucket/waste would be computed from members that were
            # cancelled and never shipped
            window = {"members": len(batch),
                      "keys": sum(r.n for r in batch),
                      "closed_by": closed_by}
            for r in batch:
                r.window = window
            # window 0 degenerates to per-request dispatch — still
            # through the packed path, so the executor cache serves the
            # sequential mode warm too (the A/B the selftest measures)
            self.batches += 1
            self.batched_requests += len(batch)
            self._guarded(lambda b=batch: self.run_batch(b), batch,
                          "batch")
