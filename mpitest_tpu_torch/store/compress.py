"""Spill-run block codec: order-preserving delta + bitpack compression
(port of ``mpitest_tpu/store/compress.py``).

Spill runs hold sorted key words, the best case for delta coding: a block
of 64-bit "wide" values (the codec's msw/lsw uint32 planes combined, so
numeric uint64 order is the planes' lexicographic order) packs into
``bit_length(max delta)`` bits per key.  This is the per-block codec
behind the SORTRUN2 framing of ``store/runs.py``: pack one block ->
(packed bytes, first value, delta width, checksum); unpack mirrors it.
Deltas wrap mod 2^64, so any block round-trips; unsorted data costs
width, never correctness.

Two engines, byte-identical on every input:

* native — the repository's ``native/spillz.c`` built with the host C
  compiler at first use into ``build/native/`` (git-ignored), under a
  name that carries a hash of the source, so a stale library is never
  loaded; called through ctypes, which releases the GIL, so the
  read-ahead and write-behind threads of ``store/aio.py`` run in
  parallel.  ``SPZ_ABI_VERSION`` is checked at load.
* python — the numpy version below, the parity oracle and the engine
  when the library is missing (no ``cc``, or a failed build).

Whether runs compress at all is the knob ``SORT_SPILL_COMPRESS``:
``auto`` (default) compresses only when the native library loads,
``on`` always (the numpy codec without the library), ``off`` writes raw
SORTBIN1 runs.  The engine never changes the bytes on disk.

The block checksum is a 32-bit fold of the values: each uint64 is
avalanche-mixed (murmur3 finalizer) before an XOR + wrapping-sum
accumulate, halves mixed at the end.  Host code only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from mpitest_tpu_torch.utils import knobs

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "spillz.c"
_FLAGS = ("-O3", "-std=c11", "-Wall", "-Wextra", "-fPIC", "-shared")

#: Must match SPZ_ABI_VERSION in native/spillz.h: a stale library is
#: refused at load, never called into.
ABI_VERSION = 1

# status codes (native/spillz.h)
_SPZ_EWIDTH = -2

#: Keys per compressed block (the SORTRUN2 header stamps the value the
#: writer used, so readers never depend on this constant).
DEFAULT_BLOCK_ELEMS = 4096

_LOADED = False
_LIB: ctypes.CDLL | None = None
_LIB_ERR: str | None = None
#: guards the one-time load and its verdict: concurrent first users
#: (spill writers, a read-ahead thread) all see the completed verdict.
#: The ``cc`` build runs before it, never under it.
_LOAD_LOCK = threading.Lock()
#: Seconds ``cc`` may take on ``native/spillz.c`` (it takes well under a
#: second); past it the build is killed and the codec counts as missing.
CC_TIMEOUT_S = 120.0


def lib_path() -> Path:
    """The library's path: ``build/native/libspillz-<hash>.so``, the hash
    over the C source, its header and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes()
                       + (SOURCE.parent / "spillz.h").read_bytes()
                       + " ".join(_FLAGS).encode())
    return _REPO / "build" / "native" / f"libspillz-{h.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.spz_abi_version.restype = ctypes.c_int
    lib.spz_abi_version.argtypes = []
    lib.spz_pack_block.restype = ctypes.c_longlong
    lib.spz_pack_block.argtypes = [
        u64p, ctypes.c_size_t, u8p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint32)]
    lib.spz_unpack_block.restype = ctypes.c_longlong
    lib.spz_unpack_block.argtypes = [
        u8p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_uint64,
        ctypes.c_int, u64p, ctypes.POINTER(ctypes.c_uint32)]


def _build(path: Path) -> str | None:
    """Compile ``native/spillz.c`` to ``path``; None, or why it failed."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return "no C compiler (cc) to build native/spillz.c"
    path.parent.mkdir(parents=True, exist_ok=True)
    # one partial output per thread: concurrent first users may all build
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        r = subprocess.run([cc, *_FLAGS, f"-I{SOURCE.parent}", str(SOURCE),
                            "-o", str(tmp)], capture_output=True, text=True,
                           timeout=CC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        tmp.unlink(missing_ok=True)
        return (f"cc on native/spillz.c did not finish within "
                f"{CC_TIMEOUT_S:g} s")
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"cc failed on native/spillz.c: {r.stderr.strip()[:500]}"
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return None


def _load() -> ctypes.CDLL | None:
    """Build (once, when missing), load and ABI-check the codec library;
    None and a recorded reason on any failure."""
    global _LOADED, _LIB, _LIB_ERR
    if _LOADED:
        return _LIB
    path = lib_path()
    # the bounded build runs outside the lock, so a slow compiler never
    # holds up a thread that only waits for the verdict
    built_err = None if path.exists() else _build(path)
    with _LOAD_LOCK:
        if _LOADED:
            return _LIB
        lib: ctypes.CDLL | None = None
        err = built_err
        if err is None:
            try:
                lib = ctypes.CDLL(str(path))
                _bind(lib)
                got = int(lib.spz_abi_version())
                if got != ABI_VERSION:
                    err = (f"{path} has ABI v{got}, shim expects "
                           f"v{ABI_VERSION}")
                    lib = None
            except (OSError, AttributeError) as e:
                err = f"{path} failed to load: {e}"
                lib = None
        _LIB, _LIB_ERR = lib, err
        _LOADED = True  # published last: readers never see a half-load
    return _LIB


def available() -> bool:
    """True iff the native library builds (or is built), loads and has the
    expected ABI."""
    return _load() is not None


def unavailable_reason() -> str | None:
    _load()
    return _LIB_ERR


def engine() -> str:
    """``"native"`` when the library loads, ``"python"`` otherwise; the
    bytes on disk are the same either way."""
    return "native" if available() else "python"


def resolve_compress(mode: str | None = None) -> bool:
    """Resolve ``SORT_SPILL_COMPRESS`` (or an explicit ``mode``): True
    means new runs are written SORTRUN2-compressed."""
    if mode is None:
        mode = knobs.get("SORT_SPILL_COMPRESS")
    if mode == "off":
        return False
    if mode == "on":
        return True
    return available()  # auto: only when the fast engine is present


# --------------------------------------------------------- wide <-> words

def words_to_wide(words: tuple[np.ndarray, ...]) -> np.ndarray:
    """Codec word planes (msw first) -> one uint64 array whose numeric
    order is the planes' lexicographic order."""
    if len(words) == 1:
        return words[0].astype(np.uint64)
    return ((words[0].astype(np.uint64) << np.uint64(32))
            | words[1].astype(np.uint64))


def wide_to_words(wide: np.ndarray, n_words: int) -> tuple[np.ndarray, ...]:
    """Inverse of :func:`words_to_wide` (msw first)."""
    if n_words == 1:
        return (wide.astype(np.uint32),)
    return ((wide >> np.uint64(32)).astype(np.uint32),
            wide.astype(np.uint32))


# ------------------------------------------------------------ value fold

def _mix64(z: np.ndarray) -> np.ndarray:
    """Vectorized murmur3 finalizer (wrapping uint64 arithmetic)."""
    z = z.astype(np.uint64, copy=True)
    z ^= z >> np.uint64(33)
    z *= np.uint64(0xFF51AFD7ED558CCD)
    z ^= z >> np.uint64(33)
    z *= np.uint64(0xC4CEB9FE1A85EC53)
    z ^= z >> np.uint64(33)
    return z


def _fold(vals: np.ndarray) -> int:
    """The ``spz_fold`` rule of ``native/spillz.c``: m = mix64(vals);
    x = XOR(m); s = sum(m) mod 2^64; halves mixed."""
    if vals.size == 0:
        return 0
    m = _mix64(vals)
    x = int(np.bitwise_xor.reduce(m))
    s = int(np.sum(m, dtype=np.uint64))
    v = x ^ (x >> 32) ^ s ^ (s >> 32)
    return v & 0xFFFFFFFF


def checksum_bytes(data: bytes) -> int:
    """32-bit fold of a raw byte block (payload blocks): zero-pad to a
    multiple of 8, view little-endian uint64, the same value fold."""
    if not data:
        return 0
    pad = (-len(data)) % 8
    if pad:
        data = data + b"\x00" * pad
    return _fold(np.frombuffer(data, dtype="<u8"))


# ------------------------------------------------------------ block codec

def pack_block(vals: np.ndarray,
               eng: str | None = None) -> tuple[bytes, int, int, int]:
    """Pack one block of wide (uint64) values: ``(packed, first, width,
    checksum)``, ``packed`` holding the n-1 wrapping deltas at ``width``
    bits each, LSB-first, zero-padded to whole bytes —
    ``ceil((n-1)*width/8)`` bytes.  Both engines return the same bytes."""
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    n = int(vals.size)
    if n == 0:
        raise ValueError("pack_block: empty block (the run framing "
                         "never writes one)")
    if eng is None:
        eng = engine()
    if eng != "native":
        return _pack_python(vals)
    lib = _load()
    assert lib is not None, "engine() guards this path"
    cap = n * 8 + 8
    out = np.empty(cap, np.uint8)
    first = ctypes.c_uint64()
    width = ctypes.c_int()
    chk = ctypes.c_uint32()
    rc = int(lib.spz_pack_block(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        ctypes.byref(first), ctypes.byref(width), ctypes.byref(chk)))
    if rc < 0:  # unreachable with the cap above; refuse to write garbage
        raise ValueError(f"spz_pack_block failed: status {rc}")
    return (out[:rc].tobytes(), int(first.value), int(width.value),
            int(chk.value))


def _pack_python(vals: np.ndarray) -> tuple[bytes, int, int, int]:
    n = int(vals.size)
    first = int(vals[0])
    chk = _fold(vals)
    if n == 1:
        return b"", first, 0, chk
    deltas = vals[1:] - vals[:-1]  # uint64 wrapping, like the C kernel
    width = int(deltas.max()).bit_length()
    if width == 0:
        return b"", first, 0, chk
    shifts = np.arange(width, dtype=np.uint64)
    bits = ((deltas[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    packed = np.packbits(bits.reshape(-1), bitorder="little")
    return packed.tobytes(), first, width, chk


def unpack_block(data: bytes, n: int, first: int, width: int,
                 eng: str | None = None) -> tuple[np.ndarray, int]:
    """Unpack one block: ``(values, checksum)`` from the packed bytes and
    the block header's (n, first, width).  Raises ValueError on any
    framing inconsistency (width outside 0..64, ``len(data) !=
    ceil((n-1)*width/8)``) from either engine.  The checksum is folded
    from the reconstructed values; the caller compares it with the stored
    one."""
    if n <= 0:
        raise ValueError(f"unpack_block: bad element count {n}")
    if eng is None:
        eng = engine()
    if eng != "native":
        return _unpack_python(data, n, first, width)
    lib = _load()
    assert lib is not None, "engine() guards this path"
    buf = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    vals = np.empty(n, np.uint64)
    chk = ctypes.c_uint32()
    rc = int(lib.spz_unpack_block(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data), n,
        ctypes.c_uint64(first & 0xFFFFFFFFFFFFFFFF), width,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.byref(chk)))
    if rc == _SPZ_EWIDTH:
        raise ValueError(f"unpack_block: delta width {width} outside 0..64")
    if rc < 0:
        raise ValueError(
            f"unpack_block: {len(data)} packed bytes disagree with "
            f"(n={n}, width={width})")
    return vals, int(chk.value)


def _unpack_python(data: bytes, n: int, first: int,
                   width: int) -> tuple[np.ndarray, int]:
    if width < 0 or width > 64:
        raise ValueError(f"unpack_block: delta width {width} outside 0..64")
    need = ((n - 1) * width + 7) // 8
    if len(data) != need:
        raise ValueError(
            f"unpack_block: {len(data)} packed bytes disagree with "
            f"(n={n}, width={width})")
    f64 = np.uint64(first & 0xFFFFFFFFFFFFFFFF)
    vals = np.empty(n, np.uint64)
    vals[0] = f64
    if n > 1:
        if width == 0:
            vals[1:] = f64
        else:
            nbits = (n - 1) * width
            raw = np.frombuffer(data, np.uint8)
            bits = np.unpackbits(raw, count=nbits,
                                 bitorder="little").reshape(n - 1, width)
            deltas = np.zeros(n - 1, np.uint64)
            for j in range(width):
                deltas |= bits[:, j].astype(np.uint64) << np.uint64(j)
            vals[1:] = f64 + np.cumsum(deltas, dtype=np.uint64)
    return vals, _fold(vals)
