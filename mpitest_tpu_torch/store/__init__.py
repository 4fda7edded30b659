"""Out-of-core sorted-run store (port of ``mpitest_tpu/store/``): spill
runs, the k-way merge, and the external sort that turns dataset
size from a device-memory limit into a disk limit.

Exports are PEP 562 lazy, as in the reference: importing the package
costs nothing until a symbol is touched.
"""

from __future__ import annotations

from typing import Any

_EXPORTS = {
    "RunFormatError": "mpitest_tpu_torch.store.runs",
    "RunInfo": "mpitest_tpu_torch.store.runs",
    "open_run": "mpitest_tpu_torch.store.runs",
    "read_run_chunks": "mpitest_tpu_torch.store.runs",
    "verify_run": "mpitest_tpu_torch.store.runs",
    "write_run": "mpitest_tpu_torch.store.runs",
    "merge_runs": "mpitest_tpu_torch.store.merge",
    "external_sort": "mpitest_tpu_torch.store.external",
    "external_sort_file": "mpitest_tpu_torch.store.external",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
