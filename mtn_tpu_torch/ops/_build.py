"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain C functions (no PyTorch headers), so
one ``nvcc`` call per source builds a shared library in seconds. Libraries
go into ``mtn_tpu_torch/_build/`` (git-ignored) at first use, named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing here runs at import time: this module is
imported on machines with no CUDA toolkit, where only the plain versions
of the kernels run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Iterable, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of mtn_tpu_torch "
                       "are built from csrc/ with the CUDA toolkit at first "
                       "use on a GPU machine")


class Kernel:
    """One CUDA source, its built library and its launch count.

    ``bind(lib)`` declares the ``argtypes``/``restype`` of the library's
    functions. ``launches`` is incremented by the kernel's Python wrapper
    each time it launches the kernel, and nowhere else."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self.launches = 0
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def log_path(self) -> Path:
        return self.library_path().with_suffix(".log")

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source unless its library exists."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(self.log_path(), "w")
        try:
            return subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        rc = proc.wait()
        out = self.library_path()
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}) on {self.source}:\n"
                               + self.log_path().read_text())
        os.replace(tmp, out)

    def build(self) -> None:
        self.finish_build(self.start_build())

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.build()
                lib = ctypes.CDLL(str(self.library_path()))
                self._bind(lib)
                self._lib = lib
            return self._lib


def build_all(kernels: Iterable[Kernel]) -> List[str]:
    """Build every kernel with one ``nvcc`` per source, all started
    together; returns each build's compiler log (ptxas register and
    shared-memory lines)."""
    kernels = list(kernels)
    procs = [k.start_build() for k in kernels]
    for k, p in zip(kernels, procs):
        k.finish_build(p)
    return [k.log_path().read_text() if k.log_path().exists() else ""
            for k in kernels]


def check_cuda(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
