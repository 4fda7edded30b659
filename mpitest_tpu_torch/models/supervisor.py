"""Typed terminal errors, the exchange's cap-regrow loop and the knobs of
the sort path (port of ``mpitest_tpu/models/supervisor.py``).

:meth:`SortSupervisor.exchange_loop` is the one cap-regrow loop of both
distributed sorts: run an attempt at the current cap, grow to the
reported need on overflow, re-stage the shards once when the overflow
persists, and raise :class:`ExchangeCapExceeded` when the need crosses the
caller's bound (sample sort then reroutes to radix).

The degradation ladder (``SORT_FALLBACK``), dispatch retries and fault
injection are not ported: a result that fails verification raises
:class:`SortIntegrityError`, and a CUDA kernel that fails to build or
launch raises where it failed.  No rung ever swaps a kernel for its plain
PyTorch version.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import TYPE_CHECKING

from mpitest_tpu_torch.utils import knobs

if TYPE_CHECKING:
    from mpitest_tpu_torch.utils.trace import Tracer


class SortFaultError(RuntimeError):
    """Base of the typed terminal errors."""


class SortIntegrityError(SortFaultError):
    """The result failed the sortedness + fingerprint verification — the
    caller must treat the sort as failed (never as approximately right)."""


class SortRetryExhausted(SortFaultError):
    """Dispatch kept failing past the retry budget; the underlying error
    is ``__cause__``.  The port has no retry budget yet (a failing
    dispatch raises its own error); exported so callers can catch the
    same types."""


class ExchangeCapExceeded(Exception):
    """Control flow of :meth:`SortSupervisor.exchange_loop`: the exchange
    needs a cap beyond the caller's bound."""

    def __init__(self, need: int, limit: int) -> None:
        super().__init__(f"exchange needs cap {need} > bound {limit}")
        self.need = need
        self.limit = limit


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


class SortSupervisor:
    """Per-run owner of the shared cap-regrow loop."""

    def __init__(self, tracer: "Tracer") -> None:
        self.tracer = tracer

    def squeeze_cap(self, cap: int, floor: int) -> int:
        """The reference's ``cap_squeeze`` fault site; with no fault
        registry ported, the cap passes through."""
        return cap

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
        :class:`ExchangeCapExceeded` when the need crosses it.
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
            if re_stage is not None and regrows >= 2:
                self.tracer.verbose(
                    f"{label} exchange overflowed {regrows} times "
                    "(persistent imbalance); re-staging shards")
                re_stage()
                re_stage = None
            self.tracer.verbose(
                f"{label} exchange overflow (need {max_cnt} > cap {cap}); retrying")
            self.tracer.count("exchange_retries", 1)
            cap = need
