"""Journaled spill manifests — the durability anchor of the external sort
(port of ``mpitest_tpu/store/manifest.py``; the journal lines are the
reference's, so either package resumes the other's journal).

One append-only JSONL **journal** per dataset-keyed external sort lives
beside the runs it describes (``<spill_dir>/<dataset>.mfst``).  Commit
protocol (write-ahead):

1. the run's files are made durable first — the streaming writer
   (``store/runs.py``, ``durable=True``) writes ``*.tmp`` names,
   ``fsync``\\ s them, publishes with ``os.replace`` and ``fsync``\\ s
   the directory, so a run is either fully present or invisible;
2. only then does :meth:`ManifestWriter.commit_run` append one JSON line
   (chunk index, path, count, fingerprint, ``format_version``) and
   ``flush + fsync`` the journal.

A crash leaves at most one torn tail line; everything before it names
runs that reached disk.  Replay (:func:`load`) skips torn or garbage
lines loudly (a warning and ``skipped_lines``), takes duplicate chunk
entries last-wins (a resumed sort re-commits corrected runs), and raises
the typed :class:`~mpitest_tpu_torch.store.runs.RunVersionError`, naming
both versions, for a journal written at a ``format_version`` this code
cannot read.  The journal itself is created atomically (write temp →
fsync → ``os.replace`` → fsync(dir)).
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass, field

from mpitest_tpu_torch import faults
from mpitest_tpu_torch.models.verify import Fingerprint
from mpitest_tpu_torch.store import runs as runlib

#: Journal schema tag (first field of every line).
MANIFEST_SCHEMA = "sortmfst1"

#: Journal filename suffix (``<dataset>.mfst`` in the spill dir).
MANIFEST_SUFFIX = ".mfst"


def manifest_path(spill_dir: str, dataset: str) -> str:
    """The journal path for ``dataset`` under ``spill_dir``."""
    return os.path.join(spill_dir, f"{dataset}{MANIFEST_SUFFIX}")


@dataclass(frozen=True)
class ManifestRun:
    """One committed run as recorded in the journal."""

    chunk: int                # source chunk index behind the run
    path: str                 # the .run key file
    n: int
    payload_width: int
    fingerprint: Fingerprint
    disk_bytes: int
    format_version: int


@dataclass
class Manifest:
    """Replayed journal state: the begin record + every committed run
    that survived replay (torn/garbage lines skipped loudly)."""

    path: str
    dataset: str
    dtype: str
    n: int | None             # total records (None = unknown at begin)
    payload_width: int
    format_version: int
    chunk_elems: int          # partition chunking the runs were cut at
    algorithm: str
    budget: int
    fanin: int
    runs: list[ManifestRun] = field(default_factory=list)
    #: torn / unparseable journal lines skipped during replay — the
    #: loud part of "skipped loudly" (also a warning per line).
    skipped_lines: int = 0


def _fp_fields(fp: Fingerprint) -> dict:
    return {"count": fp.count, "xors": list(fp.xors),
            "sums": list(fp.sums)}


def _fp_from(obj: dict) -> Fingerprint:
    return Fingerprint(int(obj["count"]),
                       tuple(int(v) for v in obj["xors"]),
                       tuple(int(v) for v in obj["sums"]))


def _check_version(ver: object, path: str) -> int:
    ver = int(ver) if isinstance(ver, (int, float)) else -1
    if ver not in runlib.COMPAT_FORMAT_VERSIONS:
        raise runlib.RunVersionError(
            f"spill manifest {path!r} was written at format_version "
            f"{ver}; this build reads "
            f"{runlib.COMPAT_FORMAT_VERSIONS} and writes "
            f"{runlib.RUN_FORMAT_VERSION}")
    return ver


def load(path: str) -> Manifest | None:
    """Replay a journal.  Returns ``None`` when no journal exists or it
    holds no readable ``begin`` record; raises the typed
    :class:`~mpitest_tpu_torch.store.runs.RunVersionError` (naming both
    versions) when the journal's ``format_version`` is unreadable.
    Torn / garbage lines are skipped loudly, duplicates last-wins."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    head: Manifest | None = None
    by_chunk: dict[int, ManifestRun] = {}
    skipped = 0
    lines = raw.split(b"\n")
    #: a non-empty final segment has no newline — a torn tail write
    torn_tail = lines[-1] != b""
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        is_tail = i == len(lines) - 1 and torn_tail
        try:
            obj = json.loads(line.decode("utf-8"))
            if not isinstance(obj, dict) or \
                    obj.get("v") != MANIFEST_SCHEMA:
                raise ValueError(f"bad schema tag {obj!r:.64}")
            kind = obj.get("kind")
            if kind == "begin":
                ver = _check_version(obj.get("format_version"), path)
                head = Manifest(
                    path=path, dataset=str(obj["dataset"]),
                    dtype=str(obj["dtype"]),
                    n=(int(obj["n"]) if obj.get("n") is not None
                       else None),
                    payload_width=int(obj["payload_width"]),
                    format_version=ver,
                    chunk_elems=int(obj["chunk_elems"]),
                    algorithm=str(obj.get("algorithm", "radix")),
                    budget=int(obj.get("budget", 0)),
                    fanin=int(obj.get("fanin", 0)))
            elif kind == "run":
                ver = _check_version(obj.get("format_version"), path)
                mr = ManifestRun(
                    chunk=int(obj["chunk"]), path=str(obj["path"]),
                    n=int(obj["n"]),
                    payload_width=int(obj["payload_width"]),
                    fingerprint=_fp_from(obj),
                    disk_bytes=int(obj.get("disk_bytes", 0)),
                    format_version=ver)
                by_chunk[mr.chunk] = mr
            else:
                raise ValueError(f"unknown record kind {kind!r}")
        except runlib.RunVersionError:
            raise
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            skipped += 1
            warnings.warn(
                f"spill manifest {path!r}: skipping "
                f"{'torn tail' if is_tail else 'garbage'} journal "
                f"line {i + 1} ({e})", RuntimeWarning, stacklevel=2)
    if head is None:
        if skipped:
            warnings.warn(
                f"spill manifest {path!r}: no readable begin record "
                f"({skipped} line(s) skipped) — ignoring the journal",
                RuntimeWarning, stacklevel=2)
        return None
    head.runs = [by_chunk[c] for c in sorted(by_chunk)]
    head.skipped_lines = skipped
    return head


def live_manifests(spill_dir: str) -> list[Manifest]:
    """Every replayable journal under ``spill_dir`` — the GC sweep's
    notion of *live*: any run a journal names must not be reclaimed.
    Unreadable journals are skipped (they stay subject to the age-gated
    sweep themselves)."""
    out: list[Manifest] = []
    try:
        names = os.listdir(spill_dir)
    except OSError:
        return out
    for fn in sorted(names):
        if not fn.endswith(MANIFEST_SUFFIX):
            continue
        try:
            m = load(os.path.join(spill_dir, fn))
        except (runlib.RunFormatError, OSError):
            continue
        if m is not None:
            out.append(m)
    return out


def run_record(chunk: int, info: "runlib.RunInfo") -> dict:
    """The journal line (as a dict) for one committed run."""
    rec = {"v": MANIFEST_SCHEMA, "kind": "run", "chunk": int(chunk),
           "path": info.path, "n": info.n,
           "payload_width": info.payload_width,
           "disk_bytes": info.disk_bytes,
           "format_version": runlib.RUN_FORMAT_VERSION}
    rec.update(_fp_fields(info.fingerprint))
    return rec


class ManifestWriter:
    """The append side of the journal.  Construction atomically
    replaces any prior journal for the dataset with a fresh ``begin``
    record (plus one ``run`` line per already-validated resumed run —
    a resumed sort's journal is self-contained, never a diff against
    the old one); :meth:`commit_run` appends + ``fsync``\\ s one line
    per newly committed run.

    The ``manifest_torn`` fault site fires in :meth:`commit_run`: the
    line's tail bytes never reach the journal (the crashed-mid-append
    shape replay must skip loudly)."""

    def __init__(self, spill_dir: str, dataset: str, *, dtype: str,
                 n: int | None, payload_width: int, algorithm: str,
                 chunk_elems: int, budget: int, fanin: int,
                 resumed: "list[ManifestRun] | None" = None) -> None:
        os.makedirs(spill_dir, exist_ok=True)
        self.dataset = dataset
        self.path = manifest_path(spill_dir, dataset)
        self._dir = spill_dir
        begin = {"v": MANIFEST_SCHEMA, "kind": "begin",
                 "dataset": dataset, "dtype": dtype, "n": n,
                 "payload_width": int(payload_width),
                 "algorithm": algorithm,
                 "chunk_elems": int(chunk_elems), "budget": int(budget),
                 "fanin": int(fanin),
                 "format_version": runlib.RUN_FORMAT_VERSION}
        lines = [json.dumps(begin, separators=(",", ":"))]
        for mr in resumed or ():
            rec = {"v": MANIFEST_SCHEMA, "kind": "run",
                   "chunk": mr.chunk, "path": mr.path, "n": mr.n,
                   "payload_width": mr.payload_width,
                   "disk_bytes": mr.disk_bytes,
                   "format_version": mr.format_version}
            rec.update(_fp_fields(mr.fingerprint))
            lines.append(json.dumps(rec, separators=(",", ":")))
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(("\n".join(lines) + "\n").encode("utf-8"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        runlib.fsync_dir(self._dir)
        self._f = open(self.path, "ab")
        #: a fired manifest_torn left the journal without its newline; the
        #: next commit restores line framing first (the drill keeps exactly
        #: one bad line; a real crash's torn line is the last)
        self._torn = False

    def commit_run(self, chunk: int, info: "runlib.RunInfo") -> None:
        """Durably append one committed run's journal line.  MUST be
        called only after the run's own files are durable (the writer's
        ``durable=True`` commit) — the journal is the promise that the
        named files are complete."""
        line = json.dumps(run_record(chunk, info),
                          separators=(",", ":")).encode("utf-8")
        cut = faults.manifest_tear_cut(len(line))
        prefix = b"\n" if self._torn else b""
        if cut:
            self._f.write(prefix + line[:len(line) - cut])
            self._torn = True
        else:
            self._f.write(prefix + line + b"\n")
            self._torn = False
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    def delete(self) -> None:
        """Retire the journal (the sort finished — verified success or
        a typed failure whose runs were already deleted).  Only a crash
        leaves a journal behind, which is exactly the resume signal."""
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass
        runlib.fsync_dir(self._dir)
