"""Keys of a cell, made on the device from ``--seed``.

A configuration file states the keys (``dtype``, ``log2_n`` and a
``keys`` object with a ``distribution``); a traffic file states how many
distinct arrays the closed loop cycles through (``pool``).  Array ``i`` of
seed ``s`` comes from one ``torch.Generator`` on the device seeded from
``(s, i)``, in a few large calls, so one seed always gives the same keys
and every seed gives the same sizes.

Distributions (all parameters in the configuration file):

* ``uniform``: integers in ``[low, high)``;
* ``npb_is``: the NAS Parallel Benchmarks IS keys,
  ``floor(max_key / 4 * (u1 + u2 + u3 + u4))`` with ``u`` uniform in
  ``[0, 1)``;
* ``zipf``: ranks ``1..values`` with probability proportional to
  ``rank ** -exponent``, each rank mapped to a distinct key by an odd
  multiplier (a bijection of the dtype's bits).
"""

from __future__ import annotations

from typing import Any

import torch

#: Keys made per generator call: large calls, bounded temporaries.
CHUNK = 1 << 26

DTYPES = {"int32": torch.int32, "int64": torch.int64}

#: Odd multipliers that scatter Zipf ranks over the key space.
_SCATTER = {torch.int32: 0x9E3779B1 - (1 << 32), torch.int64: 0x9E3779B97F4A7C15 - (1 << 64)}


def generator_seed(seed: int, index: int) -> int:
    """The generator seed of pool array ``index``: any whole ``seed``, of
    any size, folded into the 63 bits ``manual_seed`` takes."""
    return (int(seed) * 1_000_003 + index) % (1 << 63)


def make_keys(config: dict[str, Any], seed: int, index: int,
              device: str | torch.device) -> torch.Tensor:
    """Pool array ``index`` of ``seed`` for ``config``, on ``device``."""
    dtype = DTYPES[config["dtype"]]
    n = 1 << int(config["log2_n"])
    spec = config["keys"]
    g = torch.Generator(device=device)
    g.manual_seed(generator_seed(seed, index))
    out = torch.empty(n, dtype=dtype, device=device)
    kind = spec["distribution"]
    cdf = None
    if kind == "zipf":
        ranks = torch.arange(1, int(spec["values"]) + 1, dtype=torch.float64, device=device)
        cdf = torch.cumsum(ranks.pow(-float(spec["exponent"])), 0)
        cdf /= cdf[-1].clone()
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        if kind == "uniform":
            out[lo:lo + m] = torch.randint(int(spec["low"]), int(spec["high"]), (m,),
                                           dtype=dtype, generator=g, device=device)
        elif kind == "npb_is":
            u = torch.rand((4, m), dtype=torch.float64, generator=g, device=device).sum(0)
            out[lo:lo + m] = torch.floor(u * (int(spec["max_key"]) / 4)).to(dtype)
        elif kind == "zipf":
            u = torch.rand(m, dtype=torch.float64, generator=g, device=device)
            r = torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1).to(dtype)
            out[lo:lo + m] = r * _SCATTER[dtype]
        else:
            raise ValueError(f"unknown key distribution {kind!r}")
    return out


def make_pool(config: dict[str, Any], traffic: dict[str, Any], seed: int,
              device: str | torch.device) -> list[torch.Tensor]:
    """The ``traffic["pool"]`` distinct arrays the closed loop cycles through."""
    return [make_keys(config, seed, i, device) for i in range(int(traffic["pool"]))]
