"""Build the port's native sources and load them with ``ctypes``: the CUDA
kernels with ``nvcc``, the host C++ feature loader with ``g++``.

Each ``csrc/<name>.cu`` or ``.cc`` exports plain C functions (no PyTorch
headers), so one compiler call per source builds a shared library in
seconds. Libraries go into ``mtn_tpu_torch/_build/`` (git-ignored) at
first use, named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused; each build writes a
temporary file and renames it, so a concurrent reader never loads a
partial library. Nothing here runs at import time: this module is
imported on machines with no CUDA toolkit, where only the plain versions
of the kernels run.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-Wall"]


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


def gxx_path() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the native feature loader of "
                       "mtn_tpu_torch is built from csrc/npy_loader.cc at "
                       "first use")


class Library:
    """One source under ``csrc/`` and its built shared library.

    ``compiler()`` names the compiler, run as ``compiler flags -o out
    source libs``; ``bind(lib)`` declares the ``argtypes``/``restype`` of
    the library's functions."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None],
                 suffix: str, compiler: Callable[[], str],
                 flags: List[str], libs: Tuple[str, ...] = ()):
        self.name = name
        self.source = CSRC_DIR / f"{name}{suffix}"
        self._compiler = compiler
        self._flags = flags
        self._libs = libs
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(self._flags
                                           + list(self._libs)).encode())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def log_path(self) -> Path:
        return self.library_path().with_suffix(".log")

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start the compiler for this source unless its library exists."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(self.log_path(), "w")
        try:
            return subprocess.Popen(
                [self._compiler(), *self._flags, "-o", str(tmp),
                 str(self.source), *self._libs],
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
            raise RuntimeError(f"{proc.args[0]} failed ({rc}) on "
                               f"{self.source}:\n"
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


_RECORDING = threading.local()
# the records of the captures in progress by capture stream (``cuda_stream``)
_BY_STREAM: Dict[int, Dict] = {}
# called with a graph's record (:func:`recording`) at each of its replays
REPLAY_LISTENERS: List[Callable[[Dict], None]] = []


class Kernel(Library):
    """One CUDA kernel's source, its library and its launch count.

    ``launches`` counts the kernel's launches: its Python wrapper calls
    :meth:`count` each time it launches the kernel, and nowhere else, and
    each replay of a CUDA graph that holds the kernel adds the graph's
    launches of it (:func:`replayed`)."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        super().__init__(name, bind, ".cu", nvcc_path, NVCC_FLAGS)
        self.launches = 0

    def count(self, args: tuple) -> None:
        """One launch by the wrapper, with arguments ``args``. While this
        thread records a CUDA graph's capture (:func:`recording`), the
        launch is a node of the graph that runs at each replay: it goes to
        the capture's record, by argument shapes, and not to
        ``launches``."""
        record = getattr(_RECORDING, "calls", None)
        if record is None and _BY_STREAM:
            import torch
            record = _BY_STREAM.get(torch.cuda.current_stream().cuda_stream)
        if record is None:
            self.launches += 1
        else:
            record[(self, tuple(tuple(a.shape) if hasattr(a, "shape") else a
                                for a in args))] += 1


@contextlib.contextmanager
def recording(stream: Optional[int] = None) -> Iterator[Dict]:
    """The kernel launches of this thread inside the block, as ``{(kernel,
    argument shapes): calls}`` (a CUDA graph's capture, whose launches
    happen at its replays), kept out of the kernels' counts; with
    ``stream`` (a ``cuda_stream`` handle) also those of other threads on
    that stream."""
    _RECORDING.calls = calls = collections.Counter()
    if stream is not None:
        _BY_STREAM[stream] = calls
    try:
        yield calls
    finally:
        _RECORDING.calls = None
        _BY_STREAM.pop(stream, None)


def replayed(calls: Dict) -> None:
    """Count one replay of a graph whose capture recorded ``calls``."""
    for (kernel, _), n in calls.items():
        kernel.launches += n
    for listener in list(REPLAY_LISTENERS):
        listener(calls)


def host_library(name: str, bind: Callable[[ctypes.CDLL], None]
                 ) -> Library:
    """The host C++ source ``csrc/<name>.cc``, built with ``g++``."""
    return Library(name, bind, ".cc", gxx_path, GXX_FLAGS, ("-lpthread",))


def build_all(kernels: Iterable[Library]) -> List[str]:
    """Build every library with one compiler per source, all started
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
