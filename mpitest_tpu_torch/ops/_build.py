"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  Libraries land in ``build/kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source and the flags,
so an edited source rebuilds and an unchanged one loads at once.  A
failed build raises :class:`KernelBuildError` carrying nvcc's stderr; a
missing ``nvcc`` raises too; a refused launch raises
:class:`KernelLaunchError`.  Nothing here falls back to another
implementation.

Every build is bounded: an ``nvcc`` that runs past :data:`BUILD_TIMEOUT_S`
is killed, its partial output removed, and the build raises
:class:`KernelBuildTimeout` (a :class:`KernelBuildError`) naming the
source and the bound.  This is the counterpart of the reference's bounded
topology probe (``utils/topology_probe.py``): a compiler that never
answers fails the caller instead of wedging it.  :func:`load` holds the
module lock only to look up and publish libraries, never across a build:
loaders of different sources build in parallel, and a second loader of a
source waits for the first one's result.

Every wrapper launches through :func:`launch`, which counts each kernel
entry it calls in :data:`LAUNCHES` (one table for every source, so one
reset and one read cover a whole run).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: Seconds one ``nvcc`` may run before its build is abandoned: many times
#: the cold build of every source, started together, on the H100
#: machine (both numbers in ``PERF.md`` §5), so a healthy build never
#: meets it; it only ends a compiler that does not answer.
BUILD_TIMEOUT_S = 600.0

#: Seconds to wait for a killed nvcc to be reaped.
_REAP_S = 5.0

#: Guards :data:`_loaded` and :data:`_pending`; never held across a build.
_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class _Pending:
    """One source's build in flight: later loaders wait on ``done`` and
    take ``error`` (None on success) as their result."""

    def __init__(self) -> None:
        self.done = threading.Event()
        self.error: BaseException | None = None


_pending: dict[str, _Pending] = {}

#: Kernel launches per C entry point since the last :func:`reset_launches`;
#: each wrapper module registers its entries here.
LAUNCHES: dict[str, int] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelBuildTimeout(KernelBuildError):
    """nvcc did not finish within :data:`BUILD_TIMEOUT_S` and was killed."""


class KernelLaunchError(RuntimeError):
    """A kernel entry refused its launch (its status code was not 0).  Never
    retried or degraded: the sort's supervisor lets it propagate."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels need the CUDA toolkit to build")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _tmp(lib: Path) -> Path:
    # one partial output per process and thread: two threads may build
    # the same source, and the atomic rename publishes whichever ends
    return lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")


def _start(name: str) -> tuple[Path, subprocess.Popen[bytes] | None, float]:
    """Start nvcc for ``name`` unless its library is already built;
    returns the library, the process and its start time."""
    src, lib = _target(name)
    if lib.exists():
        return lib, None, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(_tmp(lib)), str(src)]
    # a session of its own, so that a kill reaches every compiler stage
    # nvcc starts, not nvcc alone
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE,
                                 start_new_session=True), time.monotonic()


def _abandon(lib: Path, proc: subprocess.Popen[bytes]) -> None:
    """Kill an unfinished nvcc and remove its partial output.

    The kill goes to nvcc's whole process group: its stages (cudafe++,
    cicc, ptxas, the host compiler) inherit its pipes, and one that kept
    running would hold them open, so nothing here reads them to their
    end; the wait for nvcc is bounded too."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    try:
        proc.wait(timeout=_REAP_S)
    except subprocess.TimeoutExpired:
        pass
    for pipe in (proc.stdout, proc.stderr):
        if pipe is not None:
            pipe.close()
    _tmp(lib).unlink(missing_ok=True)


def _finish(name: str, lib: Path, proc: subprocess.Popen[bytes] | None,
            t0: float) -> None:
    """Wait for nvcc at most until ``t0 + BUILD_TIMEOUT_S``, then publish
    the library or raise."""
    if proc is None:
        return
    tmp = _tmp(lib)
    try:
        _, err = proc.communicate(
            timeout=max(0.0, t0 + BUILD_TIMEOUT_S - time.monotonic()))
    except subprocess.TimeoutExpired:
        _abandon(lib, proc)
        raise KernelBuildTimeout(
            f"nvcc on csrc/{name}.cu did not finish within the "
            f"{BUILD_TIMEOUT_S:g} s build bound; killed") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (rc={proc.returncode}):\n"
            + err.decode(errors="replace"))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing


def build(*names: str) -> dict[str, Path]:
    """Build the named sources, all nvcc processes started together, each
    bounded by :data:`BUILD_TIMEOUT_S`; returns each library's path.  A
    failure kills the builds still running before it raises."""
    started: list[tuple[str, Path, subprocess.Popen[bytes] | None, float]] = []
    try:
        for n in names:
            started.append((n, *_start(n)))
        for i, (n, lib, proc, t0) in enumerate(started):
            _finish(n, lib, proc, t0)
            started[i] = (n, lib, None, t0)
    finally:
        for _n, lib, proc, _t0 in started:
            if proc is not None and proc.returncode is None:
                _abandon(lib, proc)
    return {n: lib for n, lib, _, _ in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.

    The lock covers the lookups only: the first loader of a source builds
    it outside the lock, a concurrent loader of the same source waits for
    that result (a failure raises in both), and loaders of other sources
    go ahead.  A failed or timed-out build is not remembered, so a later
    call builds again."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        pending = _pending.get(name)
        owner = pending is None
        if owner:
            pending = _pending[name] = _Pending()
    assert pending is not None
    if not owner:
        # the owner's own build is bounded; the grace covers its dlopen
        if not pending.done.wait(BUILD_TIMEOUT_S + 60.0):
            raise KernelBuildTimeout(
                f"csrc/{name}.cu: another thread's build did not finish "
                f"within the {BUILD_TIMEOUT_S:g} s build bound")
        err = pending.error
        if err is not None:
            cls = type(err) if isinstance(err, KernelBuildError) else KernelBuildError
            raise cls(str(err)) from err
        with _lock:
            return _loaded[name]
    try:
        lib = ctypes.CDLL(str(build(name)[name]))
    except BaseException as e:
        pending.error = e
        raise
    else:
        with _lock:
            _loaded[name] = lib
        return lib
    finally:
        with _lock:
            del _pending[name]
        pending.done.set()


def typed(name: str, signatures: dict[str, tuple[type, ...]]) -> ctypes.CDLL:
    """:func:`load` with each entry's argument types set once (every
    entry returns an int status; ``kernel_error_string`` maps it)."""
    lib = load(name)
    if not hasattr(lib, "typed"):
        for entry, argtypes in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.typed = True
    return lib


def launch(lib: ctypes.CDLL, name: str, device: torch.device, *args: int) -> None:
    """Call kernel entry ``name`` of ``lib`` on the current stream of
    ``device``; raise if the launch was refused, else count it.

    When ``device`` is the current card (the common case) the call skips
    the device guard and reads the raw stream handle: the Python launch
    path is most of a small kernel's time (K5, K8)."""
    fn = getattr(lib, name)
    index = device.index
    if device.type == "cuda" and index is not None and index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise KernelLaunchError(f"CUDA kernel {name} failed: {msg} (code {rc})")
    LAUNCHES[name] += 1


def launches(name: str) -> int:
    """Launch count of one kernel entry."""
    return LAUNCHES[name]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
