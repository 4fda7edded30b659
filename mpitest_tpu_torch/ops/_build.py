"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  Libraries land in ``build/kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source and the flags,
so an edited source rebuilds and an unchanged one loads at once.  A
failed build raises :class:`KernelBuildError` carrying nvcc's stderr; a
missing ``nvcc`` raises too.  Nothing here falls back to another
implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


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
