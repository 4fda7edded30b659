"""Key files: the reference text format and the SORTBIN1 binary format
(port of the readers and writers of ``mpitest_tpu/utils/io.py``).

The reference reads whitespace-separated decimal ints on rank 0; this
reader reads exactly the tokens present.  SORTBIN1 is an 8-byte magic, a
1-byte numpy dtype kind, a 1-byte itemsize, 6 pad bytes, then raw
little-endian keys.  Text parses in blocks that end on token boundaries,
on a ``SORT_INGEST_THREADS``-wide pool, through the engine that
``SORT_NATIVE_ENCODE`` selects (``utils/native_encode.py``).  The
ingest knobs (``SORT_INGEST``, ``SORT_INGEST_CHUNK``,
``SORT_INGEST_THREADS``, ``SORT_DONATE``) are read here for the streamed
ingest of ``models/ingest.py``.  :func:`generate` makes seeded uniform or
Zipf keys, byte-equal to the reference's generators.  Host code only:
nothing here touches a device.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from mpitest_tpu_torch.utils import knobs, native_encode

BIN_MAGIC = b"SORTBIN1"
BIN_HEADER_LEN = 16

#: Default keys per parsed text chunk (``SORT_INGEST_CHUNK``).
DEFAULT_CHUNK_ELEMS = 1 << 22

#: Text-chunk byte budget per key: sign + 10 digits + newline for int32.
_TEXT_BYTES_PER_KEY = 12

#: Keys per buffered block in :func:`write_keys_text`.
_WRITE_CHUNK_ELEMS = 1 << 16


def _bin_header(dtype: np.dtype) -> bytes:
    return BIN_MAGIC + dtype.kind.encode() + bytes([dtype.itemsize]) + b"\0" * 6


def ingest_chunk_elems() -> int:
    v = knobs.get("SORT_INGEST_CHUNK")
    return DEFAULT_CHUNK_ELEMS if v is None else v


def ingest_threads() -> int:
    return knobs.get("SORT_INGEST_THREADS")


INGEST_MODES = ("auto", "stream", "mono")


def ingest_mode() -> str:
    """``SORT_INGEST``: ``auto`` streams inputs large enough for the
    overlap to pay (``models/ingest.use_stream``), ``stream`` forces the
    pipeline at any size, ``mono`` the one-shot encode and copy."""
    return knobs.get("SORT_INGEST")


DONATE_MODES = ("auto", "1", "0")


def donate_setting() -> str:
    """Validated ``SORT_DONATE`` value (auto/1/0), shared by the CLI's
    fail-fast block and the sort dispatch, which maps ``auto`` to the
    device (``models/api.py``)."""
    return knobs.get("SORT_DONATE")


def read_keys_text(path: str, dtype=np.int32) -> np.ndarray:
    """Read keys: the whitespace-separated decimal format, or SORTBIN1
    when the magic header is present."""
    with open(path, "rb") as f:
        head = f.read(BIN_HEADER_LEN)
        if head[:8] == BIN_MAGIC:
            native_encode.check_bin_header(head, path, np.dtype(dtype))
            return np.frombuffer(f.read(), dtype=dtype).copy()
    dt = np.dtype(dtype)
    if dt == np.dtype(np.uint64):
        # an int64 intermediate would saturate keys above 2^63-1
        with open(path) as f:
            return np.array([int(t) for t in f.read().split()], dtype=dt)
    if dt.kind == "f":
        # float() parse (exact IEEE double), then narrowed for float32
        with open(path) as f:
            return np.array([float(t) for t in f.read().split()],
                            dtype=np.float64).astype(dt)
    try:
        arr = np.fromfile(path, dtype=np.int64, sep=" ")
    except FileNotFoundError:
        raise FileNotFoundError(f"'{path}' is not a valid file for read.")
    return arr.astype(dt)


def write_keys_text(path: str, keys: np.ndarray,
                    chunk_elems: int = _WRITE_CHUNK_ELEMS) -> None:
    """Write keys one per line; floats with shortest-round-trip precision
    (9 / 17 significant digits for f32 / f64)."""
    keys = np.asarray(keys).reshape(-1)
    if keys.dtype.kind == "f":
        fmt = "%.9g" if keys.dtype.itemsize == 4 else "%.17g"
    else:
        fmt = "%d"
    with open(path, "w", buffering=1 << 20) as f:
        for i in range(0, keys.size, chunk_elems):
            seg = keys[i:i + chunk_elems].tolist()
            if fmt == "%d":
                f.write("\n".join(map(str, seg)))
            else:
                f.write("\n".join(fmt % v for v in seg))
            f.write("\n")


def read_keys_binary(path: str, dtype=np.int32) -> np.ndarray:
    """SORTBIN1 header + raw little-endian keys."""
    with open(path, "rb") as f:
        head = f.read(BIN_HEADER_LEN)
        if head[:8] != BIN_MAGIC:
            raise ValueError(f"'{path}' is not a SORTBIN1 key file")
        native_encode.check_bin_header(head, path, np.dtype(dtype))
        return np.frombuffer(f.read(), dtype=dtype).copy()


def write_keys_binary(path: str, keys: np.ndarray) -> None:
    keys = np.asarray(keys).reshape(-1)
    with open(path, "wb") as f:
        f.write(_bin_header(keys.dtype))
        keys.tofile(f)


def sniff_format(path: str) -> str:
    """``"binary"`` (SORTBIN1 magic) or ``"text"``."""
    with open(path, "rb") as f:
        return "binary" if f.read(len(BIN_MAGIC)) == BIN_MAGIC else "text"


def open_keys_mmap(path: str, dtype=np.int32) -> np.ndarray:
    """SORTBIN1 file as an mmap-backed array (header checked, zero-copy)."""
    dt = np.dtype(dtype)
    with open(path, "rb") as f:
        head = f.read(BIN_HEADER_LEN)
        if head[:8] != BIN_MAGIC:
            raise ValueError(f"'{path}' is not a SORTBIN1 key file")
        native_encode.check_bin_header(head, path, dt)
    return np.memmap(path, dtype=dt, mode="r", offset=BIN_HEADER_LEN)


def _iter_text_blocks(path: str, block_bytes: int) -> Iterator[bytes]:
    """Byte blocks that each end on a token boundary; the partial
    trailing token carries into the next block."""
    carry = b""
    with open(path, "rb") as f:
        while True:
            block = f.read(block_bytes)
            if not block:
                if carry.strip():
                    yield carry
                return
            block = carry + block
            cut = max(block.rfind(w) for w in (b" ", b"\n", b"\t", b"\r"))
            if cut < 0:
                carry = block  # one giant token so far; keep accreting
                continue
            carry = block[cut + 1:]
            piece = block[: cut + 1]
            if piece.strip():
                yield piece


def _iter_text_key_chunks(path: str, dt: np.dtype, chunk_elems: int,
                          threads: int | None) -> Iterator[np.ndarray]:
    """Text blocks parsed by a ``threads``-wide pool with bounded
    prefetch, in file order."""
    threads = threads or ingest_threads()
    eng = native_encode.engine()  # resolved once per file
    blocks = _iter_text_blocks(path, chunk_elems * _TEXT_BYTES_PER_KEY)
    with ThreadPoolExecutor(max_workers=threads,
                            thread_name_prefix="io-parse") as ex:
        pending = deque()
        for b in blocks:
            pending.append(ex.submit(native_encode.parse_text_tokens, b, dt, eng))
            while len(pending) > threads:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def iter_key_chunks(path: str, dtype=np.int32, chunk_elems: int | None = None,
                    threads: int | None = None) -> Iterator[np.ndarray]:
    """The file's keys as arrays of about ``chunk_elems`` keys,
    concatenation-equal to :func:`read_keys_auto` (SORTBIN1: mmap
    slices of exactly ``chunk_elems`` but the tail)."""
    dt = np.dtype(dtype)
    chunk_elems = chunk_elems or ingest_chunk_elems()
    if sniff_format(path) == "binary":
        mm = open_keys_mmap(path, dt)
        for i in range(0, mm.size, chunk_elems):
            yield mm[i:i + chunk_elems]
        return
    yield from _iter_text_key_chunks(path, dt, chunk_elems, threads)


def read_keys_auto(path: str, dtype=np.int32, mmap: bool = False) -> np.ndarray:
    """Read keys, sniffing SORTBIN1 against text once.  ``mmap=True``
    returns the zero-copy mmap-backed array for binary files."""
    dt = np.dtype(dtype)
    if sniff_format(path) == "binary":
        return open_keys_mmap(path, dt) if mmap else read_keys_binary(path, dt)
    parts = list(_iter_text_key_chunks(path, dt, ingest_chunk_elems(), None))
    if not parts:
        return np.empty(0, dt)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def generate_uniform(n: int, dtype=np.int32, seed: int = 0) -> np.ndarray:
    """Uniform random keys over the full range of ``dtype`` (the
    reference's generator, byte-equal for the same seed).

    Float dtypes get finite, sign-symmetric values spanning most of the
    exponent range (normal significand x per-element power of ten); no
    NaN or inf, so the ``np.sort`` median probe is well-defined."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        max_exp = 30 if dt.itemsize == 4 else 250
        expo = rng.integers(-max_exp, max_exp, size=n, endpoint=True)
        return (rng.standard_normal(n) * 10.0 ** expo).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=n, dtype=dt, endpoint=True)


def generate_zipf(n: int, a: float = 1.1, dtype=np.int64, seed: int = 0) -> np.ndarray:
    """Zipf-skewed keys: heavy duplication of small values, the
    splitter-imbalance stressor (the reference's generator, byte-equal for
    the same seed)."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    vals = rng.zipf(a, size=n)
    if dt.kind == "f":
        # draws beyond the float's exact-integer range round; the rounded
        # array is the input
        return vals.astype(dt)
    return np.clip(vals, None, int(np.iinfo(dt).max)).astype(dt)


def generate(kind: str, n: int, dtype=np.int32, seed: int = 0) -> np.ndarray:
    """``uniform`` or ``zipf`` keys of ``dtype`` from ``seed``."""
    if kind == "uniform":
        return generate_uniform(n, dtype, seed)
    if kind == "zipf":
        return generate_zipf(n, dtype=dtype, seed=seed)
    raise ValueError(f"unknown generator kind: {kind!r}")
