"""Typed terminal errors and the robustness knobs of the sort path (the
single-card subset of ``mpitest_tpu/models/supervisor.py``).

The single-card branch has no degradation ladder, in the reference as
here: a result that fails verification raises :class:`SortIntegrityError`.
A CUDA kernel that fails to build or launch raises where it failed; no
rung ever swaps a kernel for its plain PyTorch version.
"""

from __future__ import annotations

from mpitest_tpu_torch.utils import knobs


class SortFaultError(RuntimeError):
    """Base of the typed terminal errors."""


class SortIntegrityError(SortFaultError):
    """The result failed the sortedness + fingerprint verification — the
    caller must treat the sort as failed (never as approximately right)."""


class SortRetryExhausted(SortFaultError):
    """Dispatch kept failing past the retry budget; the underlying error
    is ``__cause__``.  Raised by the distributed paths, which the port
    does not carry yet; exported so callers can catch the same types."""


def local_engine_knob() -> str:
    """``SORT_LOCAL_ENGINE`` (default auto): the local-sort engine, one of
    ``auto`` (the bitonic kernels for n >= 2^13), ``bitonic``, ``lax``
    (``torch.sort``) and ``radix_pallas`` (the fused radix kernel, K4,
    inside its envelope of 2^20 keys and 4 words)."""
    return knobs.get("SORT_LOCAL_ENGINE")


def verify_enabled() -> bool:
    """``SORT_VERIFY`` (default on): the always-on output verifier."""
    return knobs.get("SORT_VERIFY")
