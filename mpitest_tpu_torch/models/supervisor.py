"""Retries, cap regrow and the typed terminal errors of the sort path
(port of ``mpitest_tpu/models/supervisor.py``).

* :meth:`SortSupervisor.dispatch`: every distributed sort dispatch runs
  under one bounded retry loop with exponential backoff
  (``SORT_MAX_RETRIES``, ``SORT_RETRY_BACKOFF``; the delay is
  ``min(backoff * 2^attempt, 2.0)`` s).  Each failed attempt counts
  ``sort_retries``, emits a ``supervisor_retry`` span, drops an armed
  exchange fault it never reached (``faults_dropped``) and calls
  ``on_retry`` (which marks donated input words dead, so the re-run
  rebuilds them).  The fault registry's ``dispatch_stall``,
  ``dispatch_oom`` and ``dispatch_error`` sites inject here.  On a mesh
  across processes every attempt's outcome is agreed over the control
  group (``parallel.mesh.agree``): a process whose dispatch failed
  reports it, a peer still inside its dispatch fails at its next
  control-group step (``PeerFailedError``) and reports too, and every
  process then retries, descends or stops on the most severe failure
  any of them saw.  A failure no retry absorbs ends the run in every
  process (``parallel.mesh.abort`` in ``models/api.py``).
* :meth:`SortSupervisor.exchange_loop`: the one cap-regrow loop of both
  distributed sorts: run an attempt at the current cap, grow to the
  reported need on overflow, re-stage the shards once when the overflow
  persists, and raise :class:`ExchangeCapExceeded` when the need crosses
  the caller's bound (sample sort then reroutes to radix).  Retries and
  regrows are stamped onto the run's plan record (``ladder`` and ``cap``
  regret; a re-stage at the second regrow is the ``restage`` decision).
* The degradation ladder (``SORT_FALLBACK``) runs in ``models/api.py``:
  local engine ``radix_pallas`` -> ``lax``, exchange engine ``pallas`` ->
  ``lax``, the other algorithm, then the host ``np.lexsort``; it ends in
  a verified result or :class:`SortIntegrityError` /
  :class:`SortRetryExhausted`.

A dispatch retry absorbs :data:`TRANSIENT` and nothing else:
:class:`~mpitest_tpu_torch.faults.DeviceDispatchError` (the injected
sites and drills; the reference's ``JaxRuntimeError``) and
``torch.cuda.OutOfMemoryError``.  A retry re-runs the same kernels.  A
kernel that fails to build (``KernelBuildError``) or launch
(``KernelLaunchError``), and any other CUDA error, propagates out of
``sort()`` where it failed.

The ladder's lower rungs run plain versions (``torch.sort``, the plain
scatter pack) and last the host, so what moves it down depends on the
mesh (:func:`strict_ladder`).  On CPU ranks, where the parity tests run,
it is the reference's ladder: a :data:`TRANSIENT` failure or a result
that fails its verification twice descends.  On a mesh of CUDA ranks only
a ``DeviceDispatchError`` descends: a real OOM ends in
:class:`SortRetryExhausted` once the retries are spent, and a result that
fails its verification retry on the same rung ends in
:class:`SortIntegrityError`.  So on the card no rung stands in for a
kernel that ran out of memory or returned wrong bytes.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from typing import TYPE_CHECKING

import torch

from mpitest_tpu_torch import faults as flt
from mpitest_tpu_torch.parallel.mesh import PeerFailedError
from mpitest_tpu_torch.utils import knobs

if TYPE_CHECKING:
    from mpitest_tpu_torch.models.plan import SortPlan
    from mpitest_tpu_torch.utils.trace import Tracer


class SortFaultError(RuntimeError):
    """Base of the typed terminal errors."""


class SortIntegrityError(SortFaultError):
    """The result failed the sortedness + fingerprint verification — the
    caller must treat the sort as failed (never as approximately right)."""


class SortRetryExhausted(SortFaultError):
    """Dispatch kept failing past the retry budget (and fallback was
    disabled or also failed); the underlying error is ``__cause__``."""


class ExchangeCapExceeded(Exception):
    """Control flow of :meth:`SortSupervisor.exchange_loop`: the exchange
    needs a cap beyond the caller's bound."""

    def __init__(self, need: int, limit: int) -> None:
        super().__init__(f"exchange needs cap {need} > bound {limit}")
        self.need = need
        self.limit = limit


class _PeerDispatchFailed(flt.DeviceDispatchError):
    """A peer process's dispatch failed: every process retries together."""


class _PeerOutOfMemory(torch.cuda.OutOfMemoryError):
    """A peer process's dispatch ran out of device memory: every process
    retries, and stops, as that process does."""


#: The failures a dispatch retry or a ladder rung absorbs.
TRANSIENT: tuple[type[BaseException], ...] = (flt.DeviceDispatchError,
                                              torch.cuda.OutOfMemoryError)


def _kind(e: BaseException) -> str:
    """A failed dispatch's kind, as the processes agree on it."""
    return "oom" if isinstance(e, torch.cuda.OutOfMemoryError) else "dispatch"


def strict_ladder(dev_type: str) -> bool:
    """Whether the ladder on ranks of this device type descends only on a
    :class:`~mpitest_tpu_torch.faults.DeviceDispatchError` (true off the
    CPU: see the module docstring)."""
    return dev_type != "cpu"


def max_retries() -> int:
    """``SORT_MAX_RETRIES`` (default 2): the dispatch retry budget."""
    return knobs.get("SORT_MAX_RETRIES")


def retry_backoff() -> float:
    """``SORT_RETRY_BACKOFF`` (default 0.05): base backoff seconds."""
    return knobs.get("SORT_RETRY_BACKOFF")


def fallback_enabled() -> bool:
    """``SORT_FALLBACK`` (default on): the degradation ladder switch."""
    return knobs.get("SORT_FALLBACK")


def exchange_engine_knob() -> str:
    """``SORT_EXCHANGE_ENGINE`` (default auto): the exchange engine;
    ``models/api.py`` resolves auto to ``pallas`` (K6 + K7)."""
    return knobs.get("SORT_EXCHANGE_ENGINE")


def negotiate_knob() -> str:
    """``SORT_NEGOTIATE`` (default auto): capacity negotiation from a
    count probe before the exchange (auto/on: whenever P > 1)."""
    return knobs.get("SORT_NEGOTIATE")


def restage_knob() -> str:
    """``SORT_RESTAGE`` (default auto): the skew re-stage (shard
    interleave) on measured exchange imbalance."""
    return knobs.get("SORT_RESTAGE")


def local_engine_knob() -> str:
    """``SORT_LOCAL_ENGINE`` (default auto): the local-sort engine, one of
    ``auto`` (the bitonic kernels for n >= 2^13), ``bitonic``, ``lax``
    (``torch.sort``) and ``radix_pallas`` (the fused radix kernel, K4,
    inside its envelope of 2^20 keys and 4 words)."""
    return knobs.get("SORT_LOCAL_ENGINE")


def verify_enabled() -> bool:
    """``SORT_VERIFY`` (default on): the always-on output verifier."""
    return knobs.get("SORT_VERIFY")


def wire_registry(reg: flt.FaultRegistry | None, tracer: "Tracer") -> None:
    """Point a fault registry's ``on_fire`` at a tracer: every injected
    fault becomes a ``fault`` span event, a ``faults_injected`` count and
    a flight-recorder dump (rate-limited per site).  Wired as early as
    possible in a run: ``ingest_poison`` fires inside the streamed ingest,
    before the dispatch supervisor exists."""
    if reg is None:
        return

    def _on_fault(site: str, detail: dict) -> None:
        tracer.count("faults_injected", 1)
        tracer.spans.record("fault", time.perf_counter(), 0.0, site=site,
                            **{k: v for k, v in detail.items() if k != "word"})
        from mpitest_tpu_torch.utils import flight_recorder

        flight_recorder.dump_on_error(f"fault_{site}")

    reg.on_fire = _on_fault


class SortSupervisor:
    """Per-run supervisor: the retry budget, the fault registry hookup and
    the shared cap-regrow loop.  One instance per distributed sort."""

    def __init__(self, tracer: "Tracer",
                 registry: flt.FaultRegistry | None = None,
                 plan: "SortPlan | None" = None,
                 agree: Callable[[str | None], list[str]] | None = None) -> None:
        self.tracer = tracer
        #: across processes: every dispatch's outcome is agreed before
        #: anyone retries (``parallel.mesh.agree``), so no process retries
        #: alone while its peers wait in a collective
        self.agree = agree
        self.registry = registry
        #: the run's decision record: the supervisor knows how wrong a
        #: sizing decision was, so overflow regrows and dispatch retries
        #: stamp their counts onto it here
        self.plan = plan
        self.max_retries = max_retries()
        self.backoff = retry_backoff()
        wire_registry(registry, tracer)

    # -- fault arming -------------------------------------------------
    def squeeze_cap(self, cap: int, floor: int) -> int:
        """``cap_squeeze`` site: collapse the initial exchange cap to the
        alignment floor so the overflow regrow runs for real."""
        if self.registry is not None and self.registry.fire(
                "cap_squeeze", cap=cap, floor=floor):
            return floor
        return cap

    def arm_exchange(self) -> None:
        """Queue this dispatch's exchange fault, if one fires."""
        flt.arm_exchange(self.registry)

    def _inject_dispatch_fault(self) -> None:
        reg = self.registry
        if reg is None:
            return
        if reg.would_fire("dispatch_stall"):
            stall_ms = knobs.get("SORT_FAULT_STALL_MS")
            if reg.fire("dispatch_stall", stall_ms=stall_ms):
                # the dispatching thread blocks, as on a wedged device; the
                # sort still completes correctly afterwards
                time.sleep(stall_ms / 1e3)
        if reg.fire("dispatch_oom"):
            raise flt.DeviceDispatchError(
                "RESOURCE_EXHAUSTED: injected fault (SORT_FAULTS=dispatch_oom)")
        if reg.fire("dispatch_error"):
            raise flt.DeviceDispatchError(
                "INTERNAL: injected fault (SORT_FAULTS=dispatch_error)")

    # -- dispatch with bounded retry + backoff ------------------------
    def dispatch(self, label: str, call: Callable[[], object],
                 on_retry: Callable[[], None] | None = None) -> object:
        """Run ``call()`` under the retry budget.  ``call`` is re-run per
        attempt: after a failed attempt ``on_retry`` marks donated input
        words dead and the next ``call`` rebuilds them.  Only
        :data:`TRANSIENT` failures are retried."""
        attempt = 0
        while True:
            out = None
            try:
                self._inject_dispatch_fault()
                out, e = call(), None
            except (*TRANSIENT, PeerFailedError) as err:
                e = err
            if self.agree is not None:
                e = self._agreed(label, e)
            if e is None:
                return out
            # an exchange fault armed for THIS dispatch may not have
            # been consumed: drop it so it cannot reach a later clean
            # dispatch (counted as injected when armed, it never
            # touched data)
            dropped = flt.drop_pending()
            if dropped:
                self.tracer.count("faults_dropped", dropped)
            if attempt >= self.max_retries:
                raise SortRetryExhausted(
                    f"{label} failed {attempt + 1} time(s); retry "
                    f"budget exhausted: {e}") from e
            delay = min(self.backoff * (2 ** attempt), 2.0)
            self.tracer.verbose(
                f"{label} dispatch failed ({type(e).__name__}); "
                f"retry {attempt + 1}/{self.max_retries} in {delay:.2f}s")
            self.tracer.count("sort_retries", 1)
            if self.plan is not None:
                self.plan.bump("ladder", "dispatch_retries")
            self.tracer.spans.record(
                "supervisor_retry", time.perf_counter(), 0.0,
                label=label, attempt=attempt + 1, error=type(e).__name__)
            if on_retry is not None:
                on_retry()
            if delay:
                time.sleep(delay)
            attempt += 1

    def _agreed(self, label: str, e: BaseException | None) -> BaseException | None:
        """The dispatch outcome every process acts on: None where every
        process's dispatch succeeded, else this process's failure or a
        peer's, of the most severe kind any process saw (an OOM over a
        dispatch error), so every process retries, descends or stops
        alike."""
        kinds = self.agree(None if e is None else _kind(e))
        if not kinds:
            return None
        if "oom" in kinds and not isinstance(e, torch.cuda.OutOfMemoryError):
            return _PeerOutOfMemory(
                f"{label}: a dispatch ran out of device memory in a peer process")
        if e is None or isinstance(e, PeerFailedError):
            return _PeerDispatchFailed(f"{label}: the dispatch failed in a peer process")
        return e

    # -- the one cap-regrow loop --------------------------------------
    def exchange_loop(self, label: str,
                      attempt: "Callable[[int], tuple[object, int]]",
                      cap: int, align: int,
                      round_cap: "Callable[[int, int], int]",
                      cap_limit: int | None = None,
                      re_stage: "Callable[[], None] | None" = None,
                      ) -> tuple[object, int]:
        """Run ``attempt(cap) -> (payload, max_cnt)`` until the exchange
        fits, growing the cap to the reported need (it only grows, bounded
        by the shard size, so the loop ends).  ``cap_limit``: raise
        :class:`ExchangeCapExceeded` when the need crosses it.  (The
        reference's ``on_overflow`` hook invalidates donated words before
        a rerun; here each attempt marks them dead after its dispatch.)
        ``re_stage``: called once, at the second regrow (the arrangement,
        not a one-off estimate, drives the cap)."""
        regrows = 0
        while True:
            payload, max_cnt = attempt(cap)
            if max_cnt <= cap:
                return payload, cap
            need = round_cap(max_cnt, align)
            if cap_limit is not None and need > cap_limit:
                raise ExchangeCapExceeded(max_cnt, cap_limit)
            regrows += 1
            if self.plan is not None:
                # each regrow is a full discarded exchange dispatch
                self.plan.bump("cap", "regrows")
            if re_stage is not None and regrows >= 2:
                self.tracer.verbose(
                    f"{label} exchange overflowed {regrows} times "
                    "(persistent imbalance); re-staging shards")
                if self.plan is not None:
                    self.plan.decide("restage", chosen=True,
                                     trigger="overflow")
                re_stage()
                re_stage = None
            self.tracer.verbose(
                f"{label} exchange overflow (need {max_cnt} > cap {cap}); retrying")
            self.tracer.count("exchange_retries", 1)
            cap = need
