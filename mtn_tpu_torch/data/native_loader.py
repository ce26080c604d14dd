"""``ctypes`` binding to the C++ ``.npy`` batch loader
(``csrc/npy_loader.cc``).

The port's counterpart of ``mtn_tpu/data/native_loader.py``: the library
is built with ``g++`` into ``mtn_tpu_torch/_build/`` at first use
(``ops/_build.py``). Where it cannot be built or loaded, :func:`available`
is False, one warning names the error, and
:mod:`mtn_tpu_torch.data.features` reads with numpy.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from mtn_tpu_torch.ops._build import host_library

log = logging.getLogger(__name__)


def _bind(lib: ctypes.CDLL) -> None:
    lib.mtn_load_npy_batch.restype = ctypes.c_int
    lib.mtn_load_npy_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int]
    lib.mtn_npy_shape3.restype = ctypes.c_int
    lib.mtn_npy_shape3.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int32)]


LIBRARY = host_library("npy_loader", _bind)
_lock = threading.Lock()
_error: Optional[str] = None   # why the library is unavailable, once tried


def _lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None (after one warning) if it cannot be
    built or loaded."""
    global _error
    with _lock:
        if _error is not None:
            return None
        try:
            return LIBRARY.lib()
        except (RuntimeError, OSError) as e:
            _error = str(e)
            log.warning("native .npy loader unavailable, reading features "
                        "with numpy: %s", _error)
            return None


def available() -> bool:
    return _lib() is not None


def _require() -> ctypes.CDLL:
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    return lib


def npy_shape(path: str) -> Tuple[int, ...]:
    """Header-only shape: (T, D) for 2-D files, (T, R, D) for 3-D."""
    dims = (ctypes.c_int64 * 3)()
    nd = ctypes.c_int32()
    rc = _require().mtn_npy_shape3(path.encode(), dims, ctypes.byref(nd))
    if rc != 0:
        raise IOError(f"mtn_npy_shape3({path}) failed with code {rc}")
    return tuple(int(dims[i]) for i in range(nd.value))


def load_batch(paths: Sequence[str], max_frames: int, skip: int = 1,
               n_threads: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """(B, max_frames, D) float32 zero-padded array and (B,) int32 frame
    counts. 3-D (T, R, D) files follow the features flatten law: the frame
    skip on the time axis, then regions flatten into the frame axis.
    Raises IOError for a file the library cannot read (a dtype other than
    f4/f8, Fortran order)."""
    lib = _require()
    dim = npy_shape(paths[0])[-1]
    B = len(paths)
    out = np.zeros((B, max_frames, dim), dtype=np.float32)
    lens = np.zeros((B,), dtype=np.int32)
    c_paths = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    rc = lib.mtn_load_npy_batch(
        c_paths, B, skip, max_frames, dim,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    if rc != 0:
        raise IOError(f"mtn_load_npy_batch failed with code {rc}")
    return out, lens
