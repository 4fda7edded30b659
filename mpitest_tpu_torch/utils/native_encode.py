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
messages.  Float text always parses in Python, as in the reference.  The
reference's fused encode + fold (``enc_encode_fold``) serves its
streamed ingest, which the port does not carry yet.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from mpitest_tpu_torch.utils import knobs

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "encode.c"
LIB_PATH = _REPO / "build" / "native" / "libencode.so"

#: Must match ENC_ABI_VERSION in native/encode.h — a stale library is
#: refused at load, never called into.
ABI_VERSION = 1

# status codes (native/encode.h)
_ENC_ERANGE = -3
_ENC_EMAGIC = -4
_ENC_EHDR = -5

_LOADED = False
_LIB: ctypes.CDLL | None = None
_LIB_ERR: str | None = None
_LOAD_LOCK = threading.Lock()


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
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
