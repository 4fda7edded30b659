"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  Libraries land in ``build/kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source and the flags,
so an edited source rebuilds and an unchanged one loads at once.  A
failed build raises :class:`KernelBuildError` carrying nvcc's stderr; a
missing ``nvcc`` raises too.  Nothing here falls back to another
implementation.

Every wrapper launches through :func:`launch`, which counts each kernel
entry it calls in :data:`LAUNCHES` (one table for every source, so one
reset and one read cover a whole run).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}

#: Kernel launches per C entry point since the last :func:`reset_launches`;
#: each wrapper module registers its entries here.
LAUNCHES: dict[str, int] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


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


def _start(name: str) -> tuple[Path, subprocess.Popen[bytes] | None]:
    """Start nvcc for ``name`` unless its library is already built."""
    src, lib = _target(name)
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)


def _finish(name: str, lib: Path, proc: subprocess.Popen[bytes] | None) -> None:
    if proc is None:
        return
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    _, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (rc={proc.returncode}):\n"
            + err.decode(errors="replace"))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing


def build(*names: str) -> dict[str, Path]:
    """Build the named sources, all nvcc processes started together;
    returns each library's path."""
    started = [(n, *_start(n)) for n in names]
    for n, lib, proc in started:
        _finish(n, lib, proc)
    return {n: lib for n, lib, _ in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)[name]))
        return _loaded[name]


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
    ``device``; raise if the launch was refused, else count it."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} (code {rc})")
    LAUNCHES[name] += 1


def launches(name: str) -> int:
    """Launch count of one kernel entry."""
    return LAUNCHES[name]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
