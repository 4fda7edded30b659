"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch and NumPy only: this module imports nothing of the program
under test and takes nothing it made.  It sorts the keys the benchmark
generated (``torch.sort`` on their own device, the library sort) and
compares the program's answer, as the program decodes it back to host
keys, position by position on that device.

The control (``control_sort``) is the reference put in the program's
place with one stated guarantee broken: it orders the keys by their value
in the float type of the next lower precision (``float32`` for 32-bit
keys, ``float64`` for 64-bit ones), so keys that round alike keep their
input order.  Its answer holds every input key once, so only the order
comparison can catch it.
"""

from __future__ import annotations

import numpy as np
import torch

#: Positions compared per step, bounding the temporaries.
BLOCK = 1 << 26

_LOWER = {torch.int32: torch.float32, torch.int64: torch.float64}


class HostAnswer:
    """A sorted answer already on the host, read as the program's result is."""

    def __init__(self, keys: np.ndarray) -> None:
        self.keys = keys
        self.n_valid = int(keys.size)

    def to_numpy(self) -> np.ndarray:
        return self.keys


def sorted_keys(x: torch.Tensor) -> torch.Tensor:
    """The reference answer: ``x`` sorted ascending, on its own device."""
    return torch.sort(x).values


def count_mismatches(got: np.ndarray, want: torch.Tensor) -> int:
    """Positions at which the host keys ``got`` differ from ``want``, every
    missing or extra key counted as one; compared on ``want``'s device, a
    block at a time."""
    common = min(int(got.size), want.numel())
    bad = abs(int(got.size) - want.numel())
    for lo in range(0, common, BLOCK):
        hi = min(lo + BLOCK, common)
        block = torch.from_numpy(np.ascontiguousarray(got[lo:hi])).to(want.device)
        bad += int((block != want[lo:hi]).sum())
    return bad


def control_sort(x: torch.Tensor, *_: object, **__: object) -> HostAnswer:
    """The control: ``x`` ordered by its value in the next lower precision."""
    order = torch.sort(x.to(_LOWER[x.dtype]), stable=True).indices
    return HostAnswer(x[order].cpu().numpy())
