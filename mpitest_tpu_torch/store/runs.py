"""Spill-run files: SORTBIN1-framed sorted runs + fingerprint sidecars
(port of ``mpitest_tpu/store/runs.py``; the files are byte-identical).

One **run** is a sorted slice of a dataset persisted to disk so the
external sort (``store/external.py``) can exceed device and host memory:

* ``<name>.run`` — the sorted keys as an ordinary SORTBIN1 file (the
  framing ``utils/io.py`` reads), with the run format version stamped
  into reserved header byte 10.
* ``<name>.pay`` — the per-record payload bytes (record runs only): a
  16-byte ``SORTPAY1`` header carrying the payload width, then
  ``n * width`` raw bytes in key order.
* ``<name>.fpr.json`` — the fingerprint **sidecar**: record count and
  per-word XOR/sum folds (key words, payload words and the binding mix
  word, :func:`models.verify.fingerprint_records`) computed from the
  sorted host words before the bytes reach disk.  The merge folds every
  chunk it reads back and compares at run exhaustion, so bad disk bytes
  are caught before they can ship.

Compressed runs swap the framing, not the contract: a ``<name>.runz``
key file is ``SORTRUN2`` — the encoded key words delta-coded and
bitpacked in fixed-size, independently decodable blocks
(``store/compress.py``), each with a 24-byte header (count, delta width,
first value, packed length, checksum); the payload section becomes
``SORTPAY2`` (the same raw bytes with 8-byte per-block headers).  The
sidecar still folds the decompressed words, and a block whose framing or
checksum disagrees raises :class:`BlockIntegrityError` naming run and
block.  ``SORT_SPILL_COMPRESS`` decides whether new runs compress;
readers dispatch on the file magic, so raw and compressed runs mix in one
merge.

Typed errors: :class:`RunFormatError` (``ValueError``) for structural
garbage — bad magic, truncation, a count that disagrees with the sidecar;
:class:`RunVersionError` for a format version this code cannot read.
Fingerprint failures surface from the merge and external layers as
``SortIntegrityError``.  Host code only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass

import numpy as np

from mpitest_tpu_torch import faults
from mpitest_tpu_torch.models.records import payload_to_words, words_to_payload
from mpitest_tpu_torch.models.segmented import lex_sorted_host
from mpitest_tpu_torch.models.verify import (Fingerprint, fingerprint_host,
                                             fingerprint_records)
from mpitest_tpu_torch.ops.keys import codec_for
from mpitest_tpu_torch.store import compress as blockz
from mpitest_tpu_torch.utils import io as kio
from mpitest_tpu_torch.utils import knobs, native_encode

#: Payload-section magic (the key section reuses ``kio.BIN_MAGIC``).
PAY_MAGIC = b"SORTPAY1"
PAY_HEADER_LEN = 16

#: Compressed-run framing.  SORTRUN2 key header (16 bytes,
#: same length as SORTBIN1 so the version/kind offsets line up):
#: magic[8] | kind[1] | itemsize[1] | format_version[1] | n_words[1] |
#: block_elems u32 LE[4].  Each block: n u32 | width u8 | reserved[3] |
#: first u64 | packed_len u32 | checksum u32, then the packed bytes.
RUNZ_MAGIC = b"SORTRUN2"
RUNZ_HEADER_LEN = 16
RUNZ_BLOCK_HEADER_LEN = 24

#: Compressed payload section: magic[8] | width u32 LE | version[1] |
#: zeros[3]; blocks 1:1 with key blocks, each ``n u32 | checksum u32``
#: then ``n * width`` raw payload bytes.
PAY2_MAGIC = b"SORTPAY2"

#: Sidecar schema tag.
FP_SCHEMA = "sortfp1"

#: Run-framing format version, stamped into reserved byte 10 of the
#: SORTBIN1 header and byte 12 of the SORTPAY1 header (readers validate
#: only magic + kind + itemsize, so versioned runs stay readable by every
#: SORTBIN1 consumer), plus the sidecar and the spill manifest.  Version
#: 0 is the pre-versioning framing (reserved bytes all zero); version 2
#: introduced the compressed SORTRUN2/SORTPAY2 framing, and raw runs
#: stamp 2 as well (the version names the writer generation, the magic
#: names the framing).
RUN_FORMAT_VERSION = 2
COMPAT_FORMAT_VERSIONS = (0, 1, 2)

#: Byte offsets of the version stamp inside the two 16-byte headers.
BIN_VERSION_OFF = 10
PAY_VERSION_OFF = 12


class RunFormatError(ValueError):
    """A run file (or its payload/sidecar) is structurally invalid —
    bad magic, truncation, or a count that disagrees with the sidecar.
    Always names the offending path."""


class RunVersionError(RunFormatError):
    """A run file / sidecar / manifest carries a ``format_version``
    this build cannot read.  Always names BOTH versions — the file's
    and ours — so an upgrade mismatch is diagnosable from the message
    alone.  A distinct type so crash-resume can re-sort around disk
    *damage* while still surfacing version skew typed: damage is
    recoverable from source, silent cross-version misreads are not."""


class BlockIntegrityError(RunFormatError):
    """One compressed block of a SORTRUN2/SORTPAY2 run is undecodable
    or fails its checksum — garbage framing fields, a torn body, or
    bytes that no longer fold to the stored block checksum.  Always
    names the run path AND the block index, so the merge's blame ladder
    (:class:`store.merge.RunIntegrityError`) can re-spill exactly the
    damaged run."""

    def __init__(self, path: str, block: int, detail: str) -> None:
        self.path = str(path)
        self.block = int(block)
        super().__init__(
            f"run file {path!r}: compressed block {block}: {detail}")


# --------------------------------------------------------- disk throttle
#
# SORT_SPILL_THROTTLE_MBPS simulates ONE disk of bounded bandwidth for
# the whole process: a module-level token bucket every spill read/write
# charges actual bytes moved against.  Shared state is the point — the
# read-ahead threads of store/aio.py each stream a different run, and
# per-thread throttles would multiply the simulated bandwidth by the
# merge fan-in.  The sleep happens outside the lock: the lock only
# computes this transfer's reservation window.

_THROTTLE_LOCK = threading.Lock()
_throttle_next = 0.0


def throttle_disk(nbytes: int) -> None:
    """Charge ``nbytes`` against the simulated spill-disk bandwidth
    (no-op when ``SORT_SPILL_THROTTLE_MBPS`` is 0, the default)."""
    global _throttle_next
    mbps = float(knobs.get("SORT_SPILL_THROTTLE_MBPS"))
    if mbps <= 0.0 or nbytes <= 0:
        return
    cost = nbytes / (mbps * 1e6)
    with _THROTTLE_LOCK:
        now = time.monotonic()
        start = _throttle_next if _throttle_next > now else now
        _throttle_next = start + cost
        wait = _throttle_next - now
    if wait > 0:
        time.sleep(wait)


def fsync_dir(path: str) -> None:
    """Durably commit a directory's entries (the rename half of the
    write-temp → fsync → ``os.replace`` → fsync(dir) protocol).
    Best-effort: filesystems without directory fsync just no-op."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _check_format_version(ver: int, path: str) -> None:
    if ver not in COMPAT_FORMAT_VERSIONS:
        raise RunVersionError(
            f"run file {path!r} is format_version {ver}; this build "
            f"reads {COMPAT_FORMAT_VERSIONS} and writes "
            f"{RUN_FORMAT_VERSION}")


def _run_bin_header(dtype: np.dtype) -> bytes:
    """The SORTBIN1 header with the run format version stamped into
    reserved byte 10 (``kio._bin_header`` zeroes all six reserved
    bytes, so pre-versioning files read back as version 0)."""
    h = bytearray(kio._bin_header(dtype))
    h[BIN_VERSION_OFF] = RUN_FORMAT_VERSION
    return bytes(h)


def _pay_header(width: int) -> bytes:
    h = bytearray(PAY_MAGIC + int(width).to_bytes(4, "little")
                  + b"\0" * 4)
    h[PAY_VERSION_OFF] = RUN_FORMAT_VERSION
    return bytes(h)


def _runz_header(dtype: np.dtype, n_words: int, block_elems: int) -> bytes:
    h = bytearray(RUNZ_MAGIC)
    h.append(ord(dtype.kind))
    h.append(dtype.itemsize)
    h.append(RUN_FORMAT_VERSION)
    h.append(n_words)
    h += int(block_elems).to_bytes(4, "little")
    return bytes(h)


def _pay2_header(width: int) -> bytes:
    h = bytearray(PAY2_MAGIC + int(width).to_bytes(4, "little")
                  + b"\0" * 4)
    h[PAY_VERSION_OFF] = RUN_FORMAT_VERSION
    return bytes(h)


def _runz_block_header(n: int, width: int, first: int, packed_len: int,
                       checksum: int) -> bytes:
    return (int(n).to_bytes(4, "little") + bytes([width]) + b"\0" * 3
            + int(first).to_bytes(8, "little")
            + int(packed_len).to_bytes(4, "little")
            + int(checksum).to_bytes(4, "little"))


def _runz_pay_blocks(n: int, block_elems: int) -> int:
    """Number of payload/key blocks a compressed run of ``n`` records
    holds (the writer flushes full blocks plus one remainder)."""
    return (n + block_elems - 1) // block_elems if n else 0


@dataclass(frozen=True)
class RunInfo:
    """One opened (or freshly written) spill run."""

    path: str                 # the .run (raw) / .runz (compressed) key file
    n: int                    # records in the run
    dtype: np.dtype
    payload_width: int        # bytes per record payload (0 = keys only)
    fingerprint: Fingerprint  # sidecar fold (sorted words, pre-disk)
    disk_bytes: int           # total bytes on disk (keys + payload)
    compressed: bool = False  # SORTRUN2 block-compressed framing

    @property
    def pay_path(self) -> str:
        return self.path + ".pay"

    @property
    def sidecar_path(self) -> str:
        return self.path + ".fpr.json"


def run_fingerprint(key_words: tuple[np.ndarray, ...],
                    payload_words: tuple[np.ndarray, ...],
                    ) -> Fingerprint:
    """The ONE fold rule for runs: plain per-word fingerprint for bare
    keys, the record (binding-mix) fingerprint once a payload rides."""
    if payload_words:
        return fingerprint_records(key_words, payload_words)
    return fingerprint_host(key_words)


def _take_pending(bufs: list[np.ndarray], take: int) -> np.ndarray:
    """Pop exactly ``take`` leading rows from a list of buffered arrays
    (1-D keys or (m, width) payload), splitting the boundary array in
    place — the compressed writer's block former."""
    out: list[np.ndarray] = []
    got = 0
    while got < take:
        a = bufs[0]
        need = take - got
        if len(a) <= need:
            out.append(a)
            got += len(a)
            bufs.pop(0)
        else:
            out.append(a[:need])
            bufs[0] = a[need:]
            got = take
    return out[0] if len(out) == 1 else np.concatenate(out)


class RunStreamWriter:
    """Incremental run writer: append already-sorted chunks, fold the
    fingerprint as they arrive, seal the sidecar at :meth:`close`.
    The intermediate-merge path writes through this so a merge pass
    never materializes its output run in host memory;
    :func:`write_run` is the one-shot convenience on top.

    The ``spill_corrupt`` fault site fires on the FIRST appended chunk
    (after its fold, before its write), a deterministic placement like
    ``faults.maybe_poison_chunk``'s.

    ``durable=True`` (the manifest-journaled path) writes
    ``*.tmp`` names and commits at :meth:`close` via fsync(file) →
    ``os.replace`` → fsync(dir), per file (keys, payload, sidecar) —
    a crash leaves either a complete published run or invisible temp
    files the startup GC reclaims, never a half-run under a final
    name."""

    def __init__(self, spill_dir: str, name: str, dtype: np.dtype,
                 payload_width: int = 0, durable: bool = False,
                 compress: bool | None = None,
                 block_elems: int = blockz.DEFAULT_BLOCK_ELEMS) -> None:
        os.makedirs(spill_dir, exist_ok=True)
        if compress is None:
            compress = blockz.resolve_compress()
        self.compressed = bool(compress)
        ext = ".runz" if self.compressed else ".run"
        self.path = os.path.join(spill_dir, f"{name}{ext}")
        self.durable = bool(durable)
        self._dir = spill_dir
        self._suffix = ".tmp" if self.durable else ""
        self.dtype = np.dtype(dtype)
        self.codec = codec_for(self.dtype)
        self.payload_width = int(payload_width)
        self.block_elems = max(1, int(block_elems))
        self.n = 0
        self.disk_bytes = 0
        self._fp: Fingerprint | None = None
        self._chunks = 0
        self._key_body = 0  # key bytes written after the 16-byte header
        self._blocks: list[tuple[int, int]] = []  # (offset, len) per block
        self._pend_keys: list[np.ndarray] = []
        self._pend_pay: list[np.ndarray] = []
        self._pend_n = 0
        self._kf = open(self.path + self._suffix, "wb")
        if self.compressed:
            self._kf.write(_runz_header(self.dtype, self.codec.n_words,
                                        self.block_elems))
            self.disk_bytes += RUNZ_HEADER_LEN
        else:
            self._kf.write(_run_bin_header(self.dtype))
            self.disk_bytes += kio.BIN_HEADER_LEN
        self._pf = None
        if self.payload_width:
            self._pf = open(self.path + ".pay" + self._suffix, "wb")
            self._pf.write(_pay2_header(self.payload_width)
                           if self.compressed
                           else _pay_header(self.payload_width))
            self.disk_bytes += PAY_HEADER_LEN

    def append(self, keys_sorted: np.ndarray,
               payload_sorted: np.ndarray | None = None) -> None:
        keys_sorted = np.ascontiguousarray(
            np.asarray(keys_sorted, self.dtype).reshape(-1))
        m = int(keys_sorted.size)
        if m == 0:
            return
        kw = self.codec.encode(keys_sorted)
        pw: tuple = ()
        pay = None
        if self.payload_width:
            if payload_sorted is None:
                raise ValueError(
                    "run declared a payload width but a chunk arrived "
                    "without payload")
            pay = np.ascontiguousarray(
                np.asarray(payload_sorted, np.uint8)).reshape(
                m, self.payload_width)
            pw = payload_to_words(pay)
        cfp = run_fingerprint(kw, pw)
        self._fp = cfp if self._fp is None else self._fp.combine(cfp)
        key_bytes = keys_sorted.tobytes()
        if self._chunks == 0:
            key_bytes = faults.maybe_corrupt_spill(key_bytes)
        self._chunks += 1
        faults.maybe_spill_enospc(len(key_bytes))
        if self.compressed:
            # from the (possibly drill-corrupted) disk bytes: the block
            # codec compresses exactly what a raw run would persist, so
            # every block checksum holds and only the sidecar fold can
            # catch the spill_corrupt shape, as for raw runs
            self._pend_keys.append(np.frombuffer(key_bytes, self.dtype))
            if pay is not None:
                self._pend_pay.append(pay)
            self._pend_n += m
            self._flush_blocks(final=False)
        else:
            throttle_disk(len(key_bytes))
            self._kf.write(key_bytes)
            self.disk_bytes += len(key_bytes)
            self._key_body += len(key_bytes)
            if pay is not None:
                throttle_disk(pay.nbytes)
                self._pf.write(pay.tobytes())
                self.disk_bytes += pay.nbytes
        self.n += m

    def _flush_blocks(self, final: bool) -> None:
        """Compress+write full buffered blocks (every block except the
        run's last holds exactly ``block_elems`` records; ``final``
        drains the remainder at close)."""
        while self._pend_n >= self.block_elems or (final and
                                                   self._pend_n > 0):
            take = min(self.block_elems, self._pend_n)
            keys = _take_pending(self._pend_keys, take)
            wide = blockz.words_to_wide(self.codec.encode(keys))
            packed, first, width, chk = blockz.pack_block(wide)
            bh = _runz_block_header(take, width, first, len(packed), chk)
            off = RUNZ_HEADER_LEN + self._key_body
            throttle_disk(len(bh) + len(packed))
            self._kf.write(bh)
            self._kf.write(packed)
            blen = RUNZ_BLOCK_HEADER_LEN + len(packed)
            self._blocks.append((off, blen))
            self._key_body += blen
            self.disk_bytes += blen
            if self._pf is not None:
                pay_bytes = _take_pending(self._pend_pay, take).tobytes()
                pbh = (int(take).to_bytes(4, "little")
                       + int(blockz.checksum_bytes(pay_bytes)).to_bytes(
                           4, "little"))
                throttle_disk(len(pbh) + len(pay_bytes))
                self._pf.write(pbh)
                self._pf.write(pay_bytes)
                self.disk_bytes += len(pbh) + len(pay_bytes)
            self._pend_n -= take

    def append_words(self, key_words: tuple[np.ndarray, ...],
                     payload_words: tuple[np.ndarray, ...]) -> None:
        """Append a chunk already in encoded-word form (the merge's
        native currency) — decoded once here for the disk framing."""
        keys = self.codec.decode(key_words)
        pay = None
        if self.payload_width:
            pay = words_to_payload(payload_words, int(keys.size),
                                   self.payload_width)
        self.append(keys, pay)

    def abort(self) -> None:
        """Close + delete everything this writer may have produced
        (both temp and published names) — the ENOSPC / failed-merge
        cleanup path: a dead attempt must not leak dataset-sized
        partials under either naming."""
        for f in (self._kf, self._pf):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass
        for base in (self.path, self.path + ".pay",
                     self.path + ".fpr.json"):
            for p in ((base, base + ".tmp") if self.durable
                      else (base,)):
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def close(self) -> RunInfo:
        if self.compressed:
            self._flush_blocks(final=True)
        if self.durable:
            for f in (self._kf, self._pf):
                if f is not None:
                    f.flush()
                    os.fsync(f.fileno())
        self._kf.close()
        if self._pf is not None:
            self._pf.close()
        fp = self._fp if self._fp is not None else run_fingerprint(
            tuple(np.empty(0, np.uint32)
                  for _ in range(self.codec.n_words)),
            ())
        sc_path = self.path + ".fpr.json"
        with open(sc_path + self._suffix, "w") as f:
            json.dump({"v": FP_SCHEMA, "n": self.n,
                       "dtype": self.dtype.name,
                       "payload_width": self.payload_width,
                       "format_version": RUN_FORMAT_VERSION,
                       "count": fp.count,
                       "xors": list(fp.xors), "sums": list(fp.sums)}, f)
            if self.durable:
                f.flush()
                os.fsync(f.fileno())
        if self.durable:
            # publish: fsync'd temp → final name → directory entry.
            # order keys/payload before sidecar — a sidecar must never
            # describe files that do not exist yet
            os.replace(self.path + ".tmp", self.path)
            if self.payload_width:
                os.replace(self.path + ".pay.tmp", self.path + ".pay")
            os.replace(sc_path + ".tmp", sc_path)
            fsync_dir(self._dir)
        # disk-fault drills, applied to the PUBLISHED file: a torn tail,
        # post-commit bit rot and (compressed runs only) a scrambled block
        # header; each leaves the sidecar and manifest promising bytes the
        # disk no longer holds
        body = self._key_body
        cut = faults.spill_tear_bytes(body)
        if cut:
            os.truncate(self.path,
                        kio.BIN_HEADER_LEN + max(0, body - cut))
        rot = faults.spill_bitrot_word()
        if rot is not None and body > 0:
            off = kio.BIN_HEADER_LEN + body // 2
            with open(self.path, "r+b") as f:
                f.seek(off)
                b = f.read(1)
                if b:
                    f.seek(off)
                    f.write(bytes([b[0] ^ ((rot & 0xFF) or 0x5A)]))
        gw = faults.spill_block_garbage_word()
        if gw is not None and self.compressed and self._blocks:
            # scramble the MIDDLE block's header payload (first value,
            # packed length, checksum: bytes 8..24); the reader must fail
            # the framing or checksum check of that exact block
            off, blen = self._blocks[len(self._blocks) // 2]
            span = min(16, blen - 8)
            with open(self.path, "r+b") as f:
                f.seek(off + 8)
                cur = f.read(span)
                f.seek(off + 8)
                f.write(bytes(b ^ 0xA5 for b in cur))
        return RunInfo(self.path, self.n, self.dtype,
                       self.payload_width, fp, self.disk_bytes,
                       compressed=self.compressed)


def write_run(spill_dir: str, name: str, keys_sorted: np.ndarray,
              payload_sorted: np.ndarray | None = None,
              durable: bool = False,
              compress: bool | None = None) -> RunInfo:
    """Persist one sorted run: keys as SORTBIN1, payload (optional) as
    SORTPAY1, fingerprint sidecar folded from the HOST words before any
    byte reaches disk.  ``payload_sorted`` is a ``(n, width)`` uint8
    matrix already permuted into key order (``models/records.py``)."""
    keys_sorted = np.asarray(keys_sorted).reshape(-1)
    width = 0
    if payload_sorted is not None:
        pay = np.asarray(payload_sorted, np.uint8)
        if pay.ndim != 2 or pay.shape[0] != int(keys_sorted.size):
            raise ValueError(
                f"payload must be (n, width) uint8; got {pay.shape} for "
                f"{int(keys_sorted.size)} records")
        width = int(pay.shape[1])
    w = RunStreamWriter(spill_dir, name, keys_sorted.dtype, width,
                        durable=durable, compress=compress)
    try:
        w.append(keys_sorted, payload_sorted if width else None)
        return w.close()
    except OSError:
        # ENOSPC mid-write (real or injected): never leak the partial
        w.abort()
        raise


def _load_sidecar(path: str) -> tuple[dict, Fingerprint]:
    sc_path = path + ".fpr.json"
    try:
        with open(sc_path) as f:
            sc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise RunFormatError(
            f"run sidecar {sc_path!r} unreadable: {e}") from None
    if not isinstance(sc, dict) or sc.get("v") != FP_SCHEMA:
        raise RunFormatError(
            f"run sidecar {sc_path!r}: bad schema tag {sc.get('v')!r} "
            f"(want {FP_SCHEMA!r})")
    try:
        fp = Fingerprint(int(sc["count"]),
                         tuple(int(v) for v in sc["xors"]),
                         tuple(int(v) for v in sc["sums"]))
    except (KeyError, TypeError, ValueError) as e:
        raise RunFormatError(
            f"run sidecar {sc_path!r}: malformed fingerprint: {e}"
        ) from None
    _check_format_version(int(sc.get("format_version", 0)), sc_path)
    return sc, fp


def open_run(path: str) -> RunInfo:
    """Open an existing run: validate the SORTBIN1 framing (via the
    engine-dispatched header check — the native encode engine's
    read-back path), the payload section, and the sidecar.  Raises
    :class:`RunFormatError` on any structural problem; fingerprint
    verification happens at read time (the merge) or via
    :func:`verify_run`."""
    sc, fp = _load_sidecar(path)
    dtype = np.dtype(str(sc.get("dtype", "int32")))
    try:
        st = os.stat(path)
    except OSError as e:
        raise RunFormatError(f"run file {path!r} unreadable: {e}") from None
    n = int(sc["n"])
    with open(path, "rb") as f:
        head = f.read(kio.BIN_HEADER_LEN)
    compressed = head[:8] == RUNZ_MAGIC
    if compressed:
        if len(head) < RUNZ_HEADER_LEN:
            raise RunFormatError(
                f"run file {path!r}: truncated SORTRUN2 header")
        if (chr(head[8]), head[9]) != (dtype.kind, dtype.itemsize):
            raise RunFormatError(
                f"run file {path!r} holds {chr(head[8])}{head[9] * 8} "
                f"keys, not {dtype.name}")
        _check_format_version(head[BIN_VERSION_OFF], path)
        codec = codec_for(dtype)
        if head[11] != codec.n_words:
            raise RunFormatError(
                f"run file {path!r}: {head[11]} key words in the "
                f"header, codec says {codec.n_words}")
        block_elems = int.from_bytes(head[12:16], "little")
        if block_elems < 1:
            raise RunFormatError(
                f"run file {path!r}: bad block_elems {block_elems}")
        # no fixed key-body size for compressed runs — each block
        # declares its own length; framing damage surfaces as a typed
        # BlockIntegrityError at read time instead
    else:
        body = st.st_size - kio.BIN_HEADER_LEN
        if body != n * dtype.itemsize:
            raise RunFormatError(
                f"run file {path!r}: {body} key bytes on disk but the "
                f"sidecar says {n} x {dtype.itemsize}-byte records "
                "(truncated or torn write)")
        if head[:8] != kio.BIN_MAGIC:
            raise RunFormatError(
                f"run file {path!r} is not SORTBIN1-framed")
        native_encode.check_bin_header(head, path, dtype)
        _check_format_version(head[BIN_VERSION_OFF], path)
        block_elems = 0
    width = int(sc.get("payload_width", 0))
    disk = st.st_size
    if width:
        pp = path + ".pay"
        try:
            pst = os.stat(pp)
        except OSError as e:
            raise RunFormatError(
                f"run payload {pp!r} unreadable: {e}") from None
        want_pay = PAY_HEADER_LEN + n * width
        if compressed:
            want_pay += 8 * _runz_pay_blocks(n, block_elems)
        if pst.st_size != want_pay:
            raise RunFormatError(
                f"run payload {pp!r}: {pst.st_size} bytes on disk, "
                f"expected {want_pay} "
                f"({n} x {width}-byte payloads)")
        with open(pp, "rb") as f:
            phead = f.read(PAY_HEADER_LEN)
        want_magic = PAY2_MAGIC if compressed else PAY_MAGIC
        if phead[:8] != want_magic or \
                int.from_bytes(phead[8:12], "little") != width:
            raise RunFormatError(
                f"run payload {pp!r}: bad "
                f"{want_magic.decode('ascii')} header")
        _check_format_version(phead[PAY_VERSION_OFF], pp)
        disk += pst.st_size
    return RunInfo(path, n, dtype, width, fp, disk,
                   compressed=compressed)


def read_run_chunks(info: RunInfo, chunk_elems: int):
    """Yield ``(keys_chunk, payload_chunk | None)`` slices of a run in
    order.  Raw runs: keys as zero-copy mmap slices
    (``kio.open_keys_mmap``), payload as
    mmap-backed ``(m, width)`` views.  Compressed runs: sequential
    block reads + decode (:mod:`store.compress`), any in-block
    inconsistency raising the typed :class:`BlockIntegrityError`.
    Bounded memory at any run size."""
    if info.compressed:
        yield from _read_runz_chunks(info, chunk_elems)
        return
    try:
        mm = kio.open_keys_mmap(info.path, info.dtype)
    except ValueError as e:
        # a torn tail leaves a byte count that is not a whole number of
        # keys — np.memmap raises a bare ValueError; type it so the
        # merge blame ladder can re-spill this run
        raise RunFormatError(
            f"run file {info.path!r}: torn/unmappable keys body "
            f"({e})") from None
    if int(mm.size) != info.n:
        raise RunFormatError(
            f"run file {info.path!r}: {int(mm.size)} keys on disk, "
            f"sidecar says {info.n}")
    pm = None
    if info.payload_width:
        try:
            pm = np.memmap(info.pay_path, dtype=np.uint8, mode="r",
                           offset=PAY_HEADER_LEN)
            pm = pm.reshape(info.n, info.payload_width)
        except ValueError as e:
            raise RunFormatError(
                f"run payload {info.pay_path!r}: torn/unmappable body "
                f"({e})") from None
    if info.n == 0:
        return
    chunk_elems = max(1, int(chunk_elems))
    for i in range(0, info.n, chunk_elems):
        k = mm[i:i + chunk_elems]
        throttle_disk(k.nbytes)
        p = pm[i:i + chunk_elems] if pm is not None else None
        if p is not None:
            throttle_disk(p.nbytes)
        yield k, p


def _read_runz_chunks(info: RunInfo, chunk_elems: int):
    """The compressed (SORTRUN2) half of :func:`read_run_chunks`:
    stream block headers + bodies sequentially, validate EVERY framing
    field against the sidecar's totals before trusting it, decode
    (native engine when loadable), and compare the stored block
    checksum against one folded from the reconstructed values.  Any
    disagreement is a :class:`BlockIntegrityError` naming run + block
    — the merge types it as run damage and re-spills."""
    codec = codec_for(info.dtype)
    chunk_elems = max(1, int(chunk_elems))
    kf = open(info.path, "rb")
    pf = open(info.pay_path, "rb") if info.payload_width else None
    try:
        head = kf.read(RUNZ_HEADER_LEN)
        if len(head) < RUNZ_HEADER_LEN or head[:8] != RUNZ_MAGIC:
            raise RunFormatError(
                f"run file {info.path!r} is not SORTRUN2-framed")
        block_elems = max(1, int.from_bytes(head[12:16], "little"))
        if pf is not None:
            pf.seek(PAY_HEADER_LEN)
        remaining = info.n
        bidx = 0
        while remaining > 0:
            bh = kf.read(RUNZ_BLOCK_HEADER_LEN)
            if len(bh) != RUNZ_BLOCK_HEADER_LEN:
                raise BlockIntegrityError(
                    info.path, bidx, "truncated block header "
                    f"({len(bh)} of {RUNZ_BLOCK_HEADER_LEN} bytes)")
            bn = int.from_bytes(bh[0:4], "little")
            bwidth = bh[4]
            first = int.from_bytes(bh[8:16], "little")
            plen = int.from_bytes(bh[16:20], "little")
            stored = int.from_bytes(bh[20:24], "little")
            if bn == 0 or bn > block_elems or bn > remaining:
                raise BlockIntegrityError(
                    info.path, bidx,
                    f"element count {bn} outside 1..{min(block_elems, remaining)}")
            if bwidth > 64:
                raise BlockIntegrityError(
                    info.path, bidx, f"delta width {bwidth} outside 0..64")
            want = ((bn - 1) * bwidth + 7) // 8
            if plen != want:
                raise BlockIntegrityError(
                    info.path, bidx,
                    f"packed length {plen} disagrees with "
                    f"(n={bn}, width={bwidth}) -> {want}")
            packed = kf.read(plen)
            if len(packed) != plen:
                raise BlockIntegrityError(
                    info.path, bidx, "truncated block body "
                    f"({len(packed)} of {plen} bytes)")
            throttle_disk(RUNZ_BLOCK_HEADER_LEN + plen)
            try:
                wide, chk = blockz.unpack_block(packed, bn, first, bwidth)
            except ValueError as e:
                raise BlockIntegrityError(info.path, bidx, str(e)) from None
            if chk != stored:
                raise BlockIntegrityError(
                    info.path, bidx,
                    f"checksum mismatch (stored {stored:#010x}, "
                    f"re-folded {chk:#010x})")
            keys = codec.decode(blockz.wide_to_words(wide, codec.n_words))
            pay = None
            if pf is not None:
                pbh = pf.read(8)
                if len(pbh) != 8:
                    raise BlockIntegrityError(
                        info.path, bidx, "truncated payload block header")
                pn = int.from_bytes(pbh[0:4], "little")
                pstored = int.from_bytes(pbh[4:8], "little")
                if pn != bn:
                    raise BlockIntegrityError(
                        info.path, bidx,
                        f"payload block holds {pn} records, key block {bn}")
                pay_bytes = pf.read(bn * info.payload_width)
                if len(pay_bytes) != bn * info.payload_width:
                    raise BlockIntegrityError(
                        info.path, bidx, "truncated payload block body")
                throttle_disk(8 + len(pay_bytes))
                if blockz.checksum_bytes(pay_bytes) != pstored:
                    raise BlockIntegrityError(
                        info.path, bidx, "payload block checksum mismatch")
                pay = np.frombuffer(pay_bytes, np.uint8).reshape(
                    bn, info.payload_width)
            for i in range(0, bn, chunk_elems):
                yield (keys[i:i + chunk_elems],
                       pay[i:i + chunk_elems] if pay is not None else None)
            remaining -= bn
            bidx += 1
    finally:
        kf.close()
        if pf is not None:
            pf.close()


def remove_run(info: RunInfo) -> None:
    """Best-effort deletion of a run's files (keys, payload, sidecar)
    — the external sort's cleanup: partition and intermediate runs
    are dataset-sized and must not outlive the sort that made them."""
    for p in (info.path, info.pay_path, info.sidecar_path):
        try:
            os.unlink(p)
        except OSError:
            pass


def remove_run_paths(path: str) -> None:
    """Best-effort deletion by the KEY path alone — cleanup of a run
    whose metadata never loaded (a torn/damaged resume candidate the
    manifest names but :func:`open_run` rejects)."""
    for p in (path, path + ".pay", path + ".fpr.json"):
        try:
            os.unlink(p)
        except OSError:
            pass


def verify_run(info: RunInfo, chunk_elems: int = 1 << 20) -> bool:
    """Full integrity scan of one run: re-fold the on-disk bytes
    chunk-by-chunk and compare against the sidecar, plus a sortedness
    sweep across chunk boundaries.  The external sort's blame step —
    when the merged output disagrees with the combined sidecars, this
    names the bad run(s)."""
    codec = codec_for(info.dtype)
    fp = None
    prev_last: np.ndarray | None = None
    for keys, pay in read_run_chunks(info, chunk_elems):
        arr = np.array(keys)  # fault the pages in
        kw = codec.encode(arr)
        pw = payload_to_words(np.array(pay)) if pay is not None else ()
        cfp = run_fingerprint(kw, pw)
        fp = cfp if fp is None else fp.combine(cfp)
        if arr.size:
            # boundary-inclusive sortedness: prepend the previous
            # chunk's last key so a violation across the seam trips too
            both = (np.concatenate([prev_last, arr])
                    if prev_last is not None else arr)
            if not lex_sorted_host(codec.encode(both)):
                return False
            prev_last = arr[-1:]
    if fp is None:  # 0-record run: nothing to fold, nothing to corrupt
        return info.fingerprint.count == 0
    return fp == info.fingerprint
