"""Public sort API on one card (port of the single-device branch of
``mpitest_tpu/models/api.py``).

``sort(x)`` runs the reference's one-rank path (``_sort_impl``,
``api.py:1469-1562``): encode the keys to order-preserving uint32 words,
sort them locally, verify sortedness and the multiset fingerprint, and
decode back to the input dtype.  A numpy array is the host path (host
encode + fingerprint, one copy to the card); a ``torch.Tensor`` is the
device-resident path (encode and fingerprint on its device).

The call runs on ``cuda`` unless the caller passes ``device="cpu"``; with
no device given and no CUDA available it raises.  On the CPU every
kernel wrapper runs its plain PyTorch version, so the CPU walks the same
routing tree as the card.

Engine routing copies the reference's TPU decisions: ``auto`` means the
bitonic engine for n >= 2^13; the break-even rule (``n*10 < n_pow2*6``)
and the 64-bit constant-word shortcut, hi-duplication sniff and residual
fallback keep their counters (``local_engine``, ``pair_dup_reroute``,
``pair_residual_fallback``) and names (:data:`_PAIR_CODES`).
``radix_pallas`` sends keys of <= 2^20 elements and <= 4 words to the
fused radix kernel (K4) and larger ones to ``lax``; host input compacts
its pass plan from the words' ranges, device input runs the full plan,
and 64-bit keys with n >= 2^13 keep the pair route (whose device form
sorts a lone varying word with the bitonic engine, its host form with
K4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from mpitest_tpu_torch.models import supervisor as supervision
from mpitest_tpu_torch.models import verify as vfy
from mpitest_tpu_torch.models.supervisor import (  # re-exported: public errors
    SortFaultError,
    SortIntegrityError,
    SortRetryExhausted,
)
from mpitest_tpu_torch.ops import bitonic, kernels, radix
from mpitest_tpu_torch.ops.keys import (
    KeyCodec,
    codec_for,
    numpy_dtype,
    to_device_words,
    to_host_words,
)
from mpitest_tpu_torch.utils.trace import Tracer

__all__ = ["DistributedSortResult", "SortFaultError", "SortIntegrityError",
           "SortRetryExhausted", "resolve_device", "sort"]


@dataclass
class DistributedSortResult:
    """Sorted word planes on the card; decoded lazily on demand."""

    words: tuple[torch.Tensor, ...]
    n_valid: int                     # real keys (excludes padding)
    dtype: np.dtype

    def to_numpy(self) -> np.ndarray:
        if self.n_valid == 0:
            return np.empty(0, self.dtype)
        codec = codec_for(self.dtype)
        return codec.decode(tuple(to_host_words(w[: self.n_valid])
                                  for w in self.words))

    def median_probe_raw(self) -> Any:
        """The (n/2)-th sorted element as a native-dtype scalar (exact
        bits); one element crosses to the host."""
        idx = self.n_valid // 2 - 1
        if idx < 0:
            raise ValueError("median probe undefined for < 2 keys")
        codec = codec_for(self.dtype)
        return codec.decode(tuple(to_host_words(w[idx: idx + 1])
                                  for w in self.words))[0]

    def median_probe(self) -> int:
        """The reference's correctness probe: the (n/2)-th sorted element
        (``int_buf[size_input / 2 - 1]``, mpi_sample_sort.c:205)."""
        return int(self.median_probe_raw())


def _host_hi_dup_sniff(hi: np.ndarray) -> bool:
    """Hi-duplication sniff over a ~1024-key sample of host words."""
    n = hi.size
    s = min(1024, n)
    idx = np.linspace(0, n - 1, s).astype(np.int64)
    samp = np.sort(hi[idx])
    return bool(np.any(samp[1:] == samp[:-1]))


def _device_hi_dup_sniff(hi: torch.Tensor) -> bool:
    """The same sniff over device words, with the reference device
    program's strided sample (``_compile_pair_fused``)."""
    n = hi.numel()
    s = min(1024, n)
    if s <= 1:
        return False
    stride = -(-(n - 1) // (s - 1))  # ceil: sample stays <= s picks
    s_eff = (n - 1) // stride + 1
    start = (n - 1) - (s_eff - 1) * stride
    samp = torch.sort(hi[start: start + (s_eff - 1) * stride + 1: stride]).values
    return bool(torch.any(samp[1:] == samp[:-1]))


#: Engine names of the 64-bit routes, by the reference's codes.
_PAIR_CODES = {0: "constant", 1: "bitonic_1w1", 2: "bitonic_1w0",
               3: "lax", 4: "bitonic_pair", 5: "bitonic_pair+lax_fallback"}


def _local_engine() -> str:
    """``SORT_LOCAL_ENGINE={auto,bitonic,lax,radix_pallas}``."""
    return supervision.local_engine_knob()


def _word_diffs(words: tuple[np.ndarray, ...]) -> tuple[int, ...]:
    """Per-word ``max ^ min`` of host key words (msw first) — the input
    of pass planning; empty input has no differing bits."""
    if words[0].size == 0:
        return (0,) * len(words)
    return tuple(int(w.max()) ^ int(w.min()) for w in words)


def _use_bitonic(engine: str, n_words: int, n: int) -> bool:
    if n_words > 2:
        return False  # wider keys keep the plain sort
    if engine == "bitonic":
        return True
    return engine == "auto" and n >= (1 << bitonic.MIN_SORT_LOG2)


def _use_fused(engine: str, n_words: int, n: int) -> bool:
    """The fused radix engine takes this dispatch: the knob asked for it
    and the key fits the reference's envelope (the CUDA pass has none of
    its own; the envelope keeps the engine users get the same)."""
    return (engine == "radix_pallas" and n_words <= radix.FUSED_MAX_WORDS
            and n <= radix.FUSED_MAX_ELEMS)


def _resolve_local_engine(engine: str, n_words: int, n: int) -> str:
    """Concrete engine for one dispatch: ``radix_pallas``, ``bitonic`` or
    ``lax``."""
    if engine == "radix_pallas":
        return "radix_pallas" if _use_fused(engine, n_words, n) else "lax"
    return "bitonic" if _use_bitonic(engine, n_words, n) else "lax"


def _local_pair_sort(x: Any, is_device: bool, codec: KeyCodec,
                     device: torch.device, tracer: Tracer,
                     words_np: tuple[np.ndarray, ...] | None = None,
                     ) -> tuple[torch.Tensor, ...]:
    """Single-card 64-bit sort orchestration, adaptive like the reference:

    1. constant-word shortcut: a word with zero range never moves; the
       1-word engine sorts the other word.
    2. hi-duplication sniff: heavy duplication would leave equal-hi runs
       longer than the run fix-up depth, so it goes to the ``lax`` sort.
    3. pair engine (``kernels.sort_two_words_bitonic``, K2 + K3); the
       residual flag (runs the sniff missed) falls back to the ``lax``
       sort — correctness never depends on the sniff.

    Device-resident input takes the reference device program's sniff
    sample, sorts a lone varying word with the bitonic engine whatever the
    knob (the reference's fused device program does), and reports the
    fused fallback as ``bitonic_pair+lax_fallback``; host input takes the
    host sniff and the knob's one-word engine (under ``radix_pallas`` the
    full-plan K4 inside its envelope).  Returns the sorted device words."""
    n = x.numel() if is_device else np.asarray(x).size
    one_w = "bitonic" if is_device else _resolve_local_engine(_local_engine(), 1, n)
    if is_device:
        with tracer.phase("encode"):
            words = codec.encode_torch(x.reshape(-1))
            same = tuple(bool(torch.all(w == w[0])) for w in words)
            dup = _device_hi_dup_sniff(words[0])
    else:
        with tracer.phase("encode"):
            if words_np is None:
                words_np = codec.encode(np.asarray(x).reshape(-1))
            same = tuple(bool(w.min() == w.max()) for w in words_np)
            dup = _host_hi_dup_sniff(words_np[0])
        with tracer.phase("device_put"):
            words = tuple(to_device_words(w, device) for w in words_np)
    if all(same):  # all keys identical: already sorted
        tracer.counters["local_engine"] = _PAIR_CODES[0]
        return words
    for const_w, sort_w in ((0, 1), (1, 0)):
        if same[const_w]:
            tracer.counters["local_engine"] = f"bitonic_1w{sort_w}"
            with tracer.phase("sort"):
                s_out = kernels.local_sort((words[sort_w],), engine=one_w)[0]
            return (words[0], s_out) if sort_w == 1 else (s_out, words[1])
    if dup:
        tracer.counters["local_engine"] = _PAIR_CODES[3]
        tracer.count("pair_dup_reroute", 1)
        with tracer.phase("sort"):
            return kernels.local_sort(words, engine="lax")
    with tracer.phase("sort"):
        hi_s, lo_s, bad = kernels.sort_two_words_bitonic(*words)
        bad = bool(bad)
    tracer.counters["local_engine"] = _PAIR_CODES[5 if bad and is_device else 4]
    if not bad:
        return (hi_s, lo_s)
    tracer.verbose("pair engine left residual runs (hi duplication the "
                   "sniff missed); falling back to the lax sort")
    tracer.count("pair_residual_fallback", 1)
    with tracer.phase("sort"):
        return kernels.local_sort(words, engine="lax")


def resolve_device(x: Any, device: torch.device | str | None) -> torch.device:
    """The device a sort runs on: ``device`` when given, else the card
    (the input's own card for a CUDA tensor).  Never the CPU by default."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        return x.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mpitest_tpu_torch.sort needs a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")


def sort(x: Any, algorithm: str = "radix",
         device: torch.device | str | None = None,
         tracer: Tracer | None = None, return_result: bool = False) -> Any:
    """Sort keys on one card; returns a sorted numpy array (or the
    device-resident :class:`DistributedSortResult`).

    ``x`` is a host array (numpy or anything ``np.asarray`` takes) or a
    ``torch.Tensor`` (device-resident keys; moved to ``device`` if it lies
    elsewhere).  2-D input flattens.  Every result is verified
    (``SORT_VERIFY``, default on); a failure raises
    :class:`SortIntegrityError`.  ``algorithm`` is ``"radix"`` or
    ``"sample"``; on one card both take the same local path, as in the
    reference."""
    if algorithm not in ("radix", "sample"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    tracer = tracer or Tracer()
    dev = resolve_device(x, device)
    size = getattr(x, "numel", None)
    n = int(size()) if callable(size) else int(np.asarray(x).size)
    with tracer.spans.span("sort", algorithm=algorithm, n=n,
                           dtype=str(getattr(x, "dtype", "")) or None,
                           device=str(dev)):
        return _sort_impl(x, dev, tracer, return_result)


def _sort_impl(x: Any, device: torch.device, tracer: Tracer,
               return_result: bool) -> Any:
    """The one-rank branch of the reference's ``_sort_impl``."""
    is_device = isinstance(x, torch.Tensor)
    if is_device:
        if x.device != device:
            x = x.to(device)
        dtype = numpy_dtype(x.dtype)
        N = int(x.numel())
    else:
        x = np.asarray(x)
        dtype = np.dtype(x.dtype)
        N = int(x.size)
    codec = codec_for(dtype)
    if N == 0:
        out = np.empty(0, dtype)
        return out if not return_result else DistributedSortResult((), 0, dtype)
    verify_on = supervision.verify_enabled()
    engine = _local_engine()

    def _check_result(res: DistributedSortResult,
                      fp: vfy.Fingerprint | None) -> bool:
        with tracer.phase("verify"):
            sorted_ok, fp_ok = vfy.verify_result(res, fp)
        tracer.count("verify_runs", 1)
        tracer.spans.event("verify", ok=sorted_ok and fp_ok,
                           sorted_ok=sorted_ok, fp_ok=fp_ok, n=N)
        if not (sorted_ok and fp_ok):
            tracer.verbose(f"output verification FAILED (sorted={sorted_ok}, "
                           f"fingerprint={fp_ok})")
        return sorted_ok and fp_ok

    def _finish_local(res: DistributedSortResult,
                      fp: vfy.Fingerprint | None) -> Any:
        if verify_on and not _check_result(res, fp):
            raise SortIntegrityError(
                "single-device sort result failed verification")
        if return_result:
            return res
        with tracer.phase("decode"):
            return res.to_numpy()

    fp_in = None
    if (codec.n_words == 2 and engine != "lax"
            and N >= (1 << bitonic.MIN_SORT_LOG2)):
        words_np = None
        if is_device:
            if verify_on:
                fp_in = vfy.fingerprint_device_input(x, dtype)
        else:
            # encode once: the fingerprint and the pair sort share the words
            with tracer.phase("encode"):
                words_np = codec.encode(x.reshape(-1))
            if verify_on:
                with tracer.phase("verify"):
                    fp_in = vfy.fingerprint_host(words_np)
        out = _local_pair_sort(x, is_device, codec, device, tracer,
                               words_np=words_np)
        return _finish_local(DistributedSortResult(out, N, dtype), fp_in)

    resolved = _resolve_local_engine(engine, codec.n_words, N)
    tracer.counters["local_engine"] = resolved
    if is_device:
        if verify_on:
            fp_in = vfy.fingerprint_device_input(x, dtype)
        with tracer.phase("sort"):
            out = kernels.local_sort(codec.encode_torch(x.reshape(-1)),
                                     engine=resolved)
    else:
        with tracer.phase("encode"):
            words_np = codec.encode(x.reshape(-1))
        if verify_on:
            with tracer.phase("verify"):
                fp_in = vfy.fingerprint_host(words_np)
        with tracer.phase("device_put"):
            words = tuple(to_device_words(w, device) for w in words_np)
        # fused-engine pass compaction: the host words are in hand, so the
        # per-word spread quantized to bit widths plans the passes
        diffs = (tuple((1 << int(d).bit_length()) - 1
                       for d in _word_diffs(words_np))
                 if resolved == "radix_pallas" else None)
        with tracer.phase("sort"):
            out = kernels.local_sort(words, engine=resolved, diffs=diffs)
    return _finish_local(DistributedSortResult(out, N, dtype), fp_in)
