"""mpitest_tpu_torch — the sorter on PyTorch and CUDA (NVIDIA H100).

A port of ``mpitest_tpu`` beside it: the same public ``sort()``,
``make_mesh()``, codecs, verifier and typed errors, with the Pallas
kernels of the one-rank and distributed paths rewritten as CUDA kernels
(``csrc/``).  The out-of-core store's exports (``external_sort``,
``external_sort_file``, ``merge_runs``, the run-file API) resolve lazily
through ``store/``.  Imports ``torch``, never ``jax`` and nothing of
``mpitest_tpu``.
"""

from typing import Any

from mpitest_tpu_torch import store as _store
from mpitest_tpu_torch.models.api import DistributedSortResult, sort
from mpitest_tpu_torch.models.supervisor import (
    SortFaultError,
    SortIntegrityError,
    SortRetryExhausted,
)
from mpitest_tpu_torch.parallel.mesh import make_mesh
from mpitest_tpu_torch.utils.knobs import KnobError, NotPortedError

__all__ = [
    "DistributedSortResult",
    "KnobError",
    "NotPortedError",
    "SortFaultError",
    "SortIntegrityError",
    "SortRetryExhausted",
    "make_mesh",
    "sort",
    *_store.__all__,
]


def __getattr__(name: str) -> Any:
    if name in _store.__all__:
        return getattr(_store, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
