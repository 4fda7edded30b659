"""Env-knob registry of the port — the one place it reads the environment.

A subset of the reference registry (``mpitest_tpu/utils/knobs.py``): the
knobs the single-card sort path reads, with the same names, defaults and
message contract.  A bad value raises :class:`KnobError` (a
``ValueError``) whose text names the knob and the accepted values.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["Knob", "KnobError", "NotPortedError", "get", "register"]


class KnobError(ValueError):
    """A knob's value failed validation; the message starts with
    ``NAME=<raw!r>``."""


class NotPortedError(KnobError):
    """A knob named a reference engine whose kernel this package does not
    carry yet."""


@dataclass(frozen=True)
class Knob:
    """One registered environment knob."""

    name: str
    default: Any                  # typed default returned when unset
    doc: str
    parse: Callable[[str], Any]   # raw string -> typed value; raises KnobError

    def read(self) -> Any:
        raw = os.environ.get(self.name)
        return self.default if raw is None else self.parse(raw)


_REGISTRY: dict[str, Knob] = {}


def register(name: str, default: Any, doc: str,
             parse: Callable[[str], Any]) -> None:
    if name in _REGISTRY:
        raise ValueError(f"knob {name} registered twice")
    _REGISTRY[name] = Knob(name, default, doc, parse)


def get(name: str) -> Any:
    """Typed, validated value of registered knob ``name`` (its default
    when unset); ``KeyError`` for unregistered names."""
    return _REGISTRY[name].read()


def _flag(name: str) -> Callable[[str], bool]:
    def parse(raw: str) -> bool:
        if raw not in ("0", "1"):
            raise KnobError(f"{name}={raw!r}: use '1' or '0'")
        return raw == "1"
    return parse


#: Reference engine values whose kernel (K4, ``ops/radix_pallas.py``) is
#: still to be ported.
_NOT_PORTED_ENGINES = ("radix_pallas", "radix_pallas_interpret")
LOCAL_ENGINES = ("auto", "bitonic", "lax")


def _parse_local_engine(raw: str) -> str:
    if raw in _NOT_PORTED_ENGINES:
        raise NotPortedError(
            f"SORT_LOCAL_ENGINE={raw!r}: the fused radix kernel (K4, "
            "mpitest_tpu/ops/radix_pallas.py) is not yet ported to CUDA; "
            f"use one of {LOCAL_ENGINES}")
    if raw not in LOCAL_ENGINES:
        raise KnobError(f"SORT_LOCAL_ENGINE={raw!r}; use one of {LOCAL_ENGINES}")
    return raw


register("SORT_LOCAL_ENGINE", "auto",
         "Local sort engine; auto = bitonic CUDA kernels for n >= 2^13.",
         _parse_local_engine)
register("SORT_VERIFY", True,
         "Always-on output verification (sortedness + fingerprint).",
         _flag("SORT_VERIFY"))
