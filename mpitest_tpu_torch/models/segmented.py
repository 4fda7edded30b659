"""Host helpers of the reference's ``mpitest_tpu/models/segmented.py``
that the external sort uses.  Segmented batch sorts are not ported yet."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def lex_sorted_host(words: Sequence[np.ndarray]) -> bool:
    """Host lexicographic non-decreasing check over uint32 word arrays
    (msw first)."""
    n = int(words[0].size)
    if n < 2:
        return True
    lt = np.zeros(n - 1, bool)
    eq = np.ones(n - 1, bool)
    for w in words:
        a, b = w[:-1], w[1:]
        lt |= eq & (a < b)
        eq &= a == b
    return bool(np.all(lt | eq))
