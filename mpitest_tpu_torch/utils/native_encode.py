"""ctypes shim over the native text parser and header check
(``native/encode.{h,c}``; port of the parse half of
``mpitest_tpu/utils/native_encode.py``).

The library is host C, built from the repository's ``native/encode.c``
by :func:`build` (``cc -O3``) into ``build/native/libencode.so``, which
``.gitignore`` lists; nothing builds it behind the caller's back.
``python -m mpitest_tpu_torch.utils.native_encode`` builds it.

Engine selection is the registered knob ``SORT_NATIVE_ENCODE``:

* ``auto`` (default) — native when the library loads, the numpy path
  otherwise; :func:`engine` returns the engine that runs, and the CLI
  records it in its tracer's ``encode_engine`` counter;
* ``on`` — native, and a missing or stale library raises;
* ``off`` — the numpy path.

Both engines return the same keys and raise the same exception types on
malformed input (``ValueError`` for bad tokens and headers,
``OverflowError`` for out-of-range tokens), with the same header
messages.  Float text always parses in Python, as in the reference.

:func:`encode_and_fold` is the encode stage of the streamed ingest
(``models/ingest.py``): one chunk's words, per-word min and max, its
maximum key and its fingerprint, in one GIL-released C pass
(``enc_encode_fold``) or the numpy passes, with equal results.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

from typing import TYPE_CHECKING

import numpy as np

from mpitest_tpu_torch.utils import knobs

if TYPE_CHECKING:
    from mpitest_tpu_torch.models.verify import Fingerprint
    from mpitest_tpu_torch.ops.keys import KeyCodec

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "encode.c"
LIB_PATH = _REPO / "build" / "native" / "libencode.so"

#: Must match ENC_ABI_VERSION in native/encode.h — a stale library is
#: refused at load, never called into.
ABI_VERSION = 1

# status codes (native/encode.h)
_ENC_OK = 0
_ENC_ERANGE = -3
_ENC_EMAGIC = -4
_ENC_EHDR = -5



class _EncFold(ctypes.Structure):
    """``enc_fold`` of ``native/encode.h``: one chunk's reductions."""

    _fields_ = [
        ("count", ctypes.c_uint64),
        ("xor0", ctypes.c_uint32), ("xor1", ctypes.c_uint32),
        ("sum0", ctypes.c_uint32), ("sum1", ctypes.c_uint32),
        ("min0", ctypes.c_uint32), ("min1", ctypes.c_uint32),
        ("max0", ctypes.c_uint32), ("max1", ctypes.c_uint32),
        ("lexmax0", ctypes.c_uint32), ("lexmax1", ctypes.c_uint32),
    ]


_LOADED = False
_LIB: ctypes.CDLL | None = None
_LIB_ERR: str | None = None
_LOAD_LOCK = threading.Lock()


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.enc_encode_fold.restype = ctypes.c_int
    lib.enc_encode_fold.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char, ctypes.c_int,
        u32p, u32p, ctypes.c_int, ctypes.POINTER(_EncFold)]
    lib.enc_abi_version.restype = ctypes.c_int
    lib.enc_abi_version.argtypes = []
    lib.enc_count_tokens.restype = ctypes.c_longlong
    lib.enc_count_tokens.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.enc_parse_i64.restype = ctypes.c_longlong
    lib.enc_parse_i64.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
    lib.enc_parse_u64.restype = ctypes.c_longlong
    lib.enc_parse_u64.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
    lib.enc_check_header.restype = ctypes.c_int
    lib.enc_check_header.argtypes = [
        u8p, ctypes.c_size_t, ctypes.c_char, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char), ctypes.POINTER(ctypes.c_int)]


def _load() -> ctypes.CDLL | None:
    """Load (once) and ABI-check the library; None and a recorded reason
    on any failure — ``auto`` then takes numpy, ``on`` raises."""
    global _LOADED, _LIB, _LIB_ERR
    if _LOADED:
        return _LIB
    with _LOAD_LOCK:
        if _LOADED:
            return _LIB
        lib: ctypes.CDLL | None = None
        err: str | None = None
        if not LIB_PATH.exists():
            err = (f"{LIB_PATH} not built (python -m "
                   "mpitest_tpu_torch.utils.native_encode)")
        else:
            try:
                lib = ctypes.CDLL(str(LIB_PATH))
                _bind(lib)
                got = int(lib.enc_abi_version())
                if got != ABI_VERSION:
                    err = (f"{LIB_PATH} has ABI v{got}, shim expects "
                           f"v{ABI_VERSION} (rebuild it)")
                    lib = None
            except (OSError, AttributeError) as e:
                err = f"{LIB_PATH} failed to load: {e} (rebuild it)"
                lib = None
        _LIB, _LIB_ERR = lib, err
        _LOADED = True  # published last: readers never see a half-load
    return _LIB


def available() -> bool:
    """True iff the native library is present, loadable and ABI-matched."""
    return _load() is not None


def unavailable_reason() -> str | None:
    _load()
    return _LIB_ERR


def engine() -> str:
    """Resolve ``SORT_NATIVE_ENCODE`` to ``"native"`` or ``"python"``;
    ``on`` with no usable library raises."""
    mode = knobs.get("SORT_NATIVE_ENCODE")
    if mode == "off":
        return "python"
    if available():
        return "native"
    if mode == "on":
        raise RuntimeError(
            f"SORT_NATIVE_ENCODE=on but the native engine is unavailable: "
            f"{_LIB_ERR}")
    return "python"


def build(quiet: bool = True) -> bool:
    """Best-effort build of the library from ``native/encode.c`` with the
    host C compiler; True when it then loads."""
    global _LOADED, _LIB, _LIB_ERR
    cc = shutil.which("cc") or shutil.which("gcc")
    ok = False
    if cc is not None:
        LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run(
            [cc, "-O3", "-std=c11", "-Wall", "-Wextra", "-fPIC", "-shared",
             f"-I{SOURCE.parent}", str(SOURCE), "-o", str(tmp)],
            capture_output=quiet, text=True)
        ok = r.returncode == 0
        if ok:
            os.replace(tmp, LIB_PATH)  # atomic: a loader sees all or nothing
        else:
            tmp.unlink(missing_ok=True)
    with _LOAD_LOCK:  # force a re-probe
        _LOADED, _LIB, _LIB_ERR = False, None, None
    return ok and available()


# ------------------------------------------------------------ encode path

def encode_and_fold(chunk: np.ndarray, codec: "KeyCodec", fold_fp: bool,
                    eng: str | None = None,
                    ) -> "tuple[tuple[np.ndarray, ...], list[int], list[int], object, Fingerprint | None]":
    """One chunk's encode stage: ``(words, word_mins, word_maxs,
    native_max, fingerprint)``, where ``words`` are the codec's uint32
    planes (msw first), the mins and maxs per-word reductions of them,
    ``native_max`` the chunk's maximum key in its own dtype (None for
    floats, which pad with the all-ones sentinel) and ``fingerprint`` the
    ``models/verify.py`` fold (None when ``fold_fp`` is False).  Both
    engines return equal values.  An empty chunk raises in both: it has
    no min, max or pad."""
    if np.asarray(chunk).size == 0:
        raise ValueError("encode_and_fold: empty chunk (no min/max/pad "
                         "is defined; the pipeline never produces one)")
    if eng is None:
        eng = engine()
    if eng == "native":
        return _encode_fold_native(chunk, codec, fold_fp)
    return _encode_fold_python(chunk, codec, fold_fp)


def _encode_fold_python(chunk: np.ndarray, codec: "KeyCodec", fold_fp: bool,
                        ) -> "tuple[tuple[np.ndarray, ...], list[int], list[int], object, Fingerprint | None]":
    """The numpy encode stage: codec encode, per-word min/max passes, the
    host fingerprint and the native max."""
    from mpitest_tpu_torch.models.verify import fingerprint_host

    words = codec.encode(chunk)
    los = [int(w.min()) for w in words]
    his = [int(w.max()) for w in words]
    m = chunk.max() if chunk.dtype.kind != "f" else None
    fp = fingerprint_host(words) if fold_fp else None
    return words, los, his, m, fp


def _encode_fold_native(chunk: np.ndarray, codec: "KeyCodec", fold_fp: bool,
                        ) -> "tuple[tuple[np.ndarray, ...], list[int], list[int], object, Fingerprint | None]":
    from mpitest_tpu_torch.models.verify import Fingerprint

    lib = _load()
    assert lib is not None, "engine() guards this path"
    dt = codec.dtype
    if (not chunk.flags.c_contiguous or not chunk.flags.aligned
            or chunk.dtype != dt):
        # C needs one flat, aligned pointer
        chunk = np.ascontiguousarray(chunk, dtype=dt)
    n = int(chunk.size)
    words = tuple(np.empty(n, np.uint32) for _ in range(codec.n_words))
    w0 = words[0].ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    w1 = (words[1].ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
          if codec.n_words == 2 else None)
    fold = _EncFold()
    rc = lib.enc_encode_fold(chunk.ctypes.data_as(ctypes.c_void_p), n,
                             dt.kind.encode(), int(dt.itemsize), w0, w1,
                             1 if fold_fp else 0, ctypes.byref(fold))
    if rc != _ENC_OK:
        raise TypeError(f"unsupported key dtype: {dt}")
    if codec.n_words == 1:
        los, his = [int(fold.min0)], [int(fold.max0)]
        lexmax = (int(fold.lexmax0),)
        fp = (Fingerprint(n, (int(fold.xor0),), (int(fold.sum0),))
              if fold_fp else None)
    else:
        los = [int(fold.min0), int(fold.min1)]
        his = [int(fold.max0), int(fold.max1)]
        lexmax = (int(fold.lexmax0), int(fold.lexmax1))
        fp = (Fingerprint(n, (int(fold.xor0), int(fold.xor1)),
                          (int(fold.sum0), int(fold.sum1)))
              if fold_fp else None)
    # the lex max of the words is encode(max key): decode it back to the
    # native scalar the pad logic expects
    m = None if dt.kind == "f" else codec.decode(
        tuple(np.full(1, v, np.uint32) for v in lexmax))[0]
    return words, los, his, m, fp


# ------------------------------------------------------------- text parse

def parse_text_tokens(block: bytes, dt: np.dtype,
                      eng: str | None = None) -> np.ndarray:
    """Whitespace-separated decimal tokens -> keys of ``dt``: int dtypes
    through an int64 intermediate then truncated, uint64 exact, float
    dtypes always through the Python parser.  Malformed tokens raise
    ValueError, out-of-container tokens OverflowError."""
    if eng is None:
        eng = engine()
    if eng != "native" or dt.kind == "f":
        return _parse_text_python(block, dt)
    lib = _load()
    assert lib is not None, "engine() guards this path"
    n_toks = int(lib.enc_count_tokens(block, len(block)))
    if n_toks == 0:
        return np.empty(0, dt)
    bad = ctypes.c_size_t()
    if dt == np.dtype(np.uint64):
        out = np.empty(n_toks, np.uint64)
        rc = int(lib.enc_parse_u64(
            block, len(block),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n_toks, ctypes.byref(bad)))
    else:
        out = np.empty(n_toks, np.int64)
        rc = int(lib.enc_parse_i64(
            block, len(block),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_toks, ctypes.byref(bad)))
    if rc < 0:
        tok = block[bad.value:bad.value + 32].split()[0]
        if rc == _ENC_ERANGE:
            raise OverflowError(
                f"token {tok.decode(errors='replace')!r} out of range "
                f"for the {('uint64' if dt == np.dtype(np.uint64) else 'int64')} "
                "container")
        raise ValueError(
            "invalid literal for int() with base 10: "
            f"{tok.decode(errors='replace')!r}")
    assert rc == n_toks, "token count and parse disagree (engine bug)"
    return out if out.dtype == dt else out.astype(dt)


def _parse_text_python(block: bytes, dt: np.dtype) -> np.ndarray:
    """The numpy token parse."""
    tokens = block.split()
    if not tokens:
        return np.empty(0, dt)
    toks = np.array(tokens)
    if dt == np.dtype(np.uint64):
        return toks.astype(np.uint64)
    if dt.kind == "f":
        return toks.astype(np.float64).astype(dt)
    return toks.astype(np.int64).astype(dt)


# ----------------------------------------------------------------- header

def check_bin_header(header: bytes, path: str, dtype: np.dtype,
                     eng: str | None = None) -> None:
    """SORTBIN1 header validation, raising the same messages from either
    engine."""
    if eng is None:
        eng = engine()
    if eng == "native":
        lib = _load()
        assert lib is not None
        got_kind = ctypes.c_char()
        got_size = ctypes.c_int()
        buf = (ctypes.c_uint8 * len(header)).from_buffer_copy(header)
        rc = int(lib.enc_check_header(
            buf, len(header), dtype.kind.encode(), int(dtype.itemsize),
            ctypes.byref(got_kind), ctypes.byref(got_size)))
        if rc == _ENC_EMAGIC:
            raise ValueError(f"'{path}' is not a SORTBIN1 key file")
        if rc == _ENC_EHDR:
            # latin-1: any byte decodes to the char chr() gives the numpy
            # engine, so a garbage kind byte yields the same message
            kind = got_kind.value.decode("latin-1")
            raise ValueError(
                f"'{path}' holds {kind}{got_size.value * 8} keys, "
                f"not {dtype.name}")
        return
    if header[:8] != b"SORTBIN1" or len(header) < 16:
        raise ValueError(f"'{path}' is not a SORTBIN1 key file")
    kind, itemsize = chr(header[8]), header[9]
    if (kind, itemsize) != (dtype.kind, dtype.itemsize):
        raise ValueError(
            f"'{path}' holds {kind}{itemsize * 8} keys, not {dtype.name}")


if __name__ == "__main__":
    ok = build(quiet=False)
    print(f"{LIB_PATH}: {'built' if ok else 'NOT built: ' + str(unavailable_reason())}")
    raise SystemExit(0 if ok else 1)
