"""Write-once disk cache of padded per-batch feature blocks (the port's copy
of ``mtn_tpu/data/feature_cache.py``: the same keys, version, files and
bytes, so a cache directory written by either package is read by the
other).

A batch plan's padded feature block is the same in every epoch (the
epoch shuffle permutes plan order only), so the cache writes each block
once, in the run's feature transfer form, and serves later epochs from
``mmap`` reads:

- ``float32``: the padded ``(B, T, D)`` block as produced;
- ``bfloat16``: the block rounded to bf16 (half the bytes), stored as its
  uint16 bits and served as a :class:`BF16Feature`;
- ``int8``: the per-frame absmax quantization (``train/batch.py``
  ``host_quant_int8``) runs once, at first touch; later epochs read the
  int8 block and its f32 row scales as a :class:`QuantFeature`, which
  ``device_batch`` ships as-is: bitwise the uncached int8 transfer.

Keys hash the per-stream source files' identities (path, mtime_ns, size)
with the frame cap, the skip and the transfer form, so editing a feature
file invalidates its blocks. Writes go to a temporary file that is then
renamed, so a crashed run never leaves a torn entry.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

_VERSION = 1


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    return np.concatenate([a, np.zeros((rows - a.shape[0],) + a.shape[1:],
                                       a.dtype)])


class QuantFeature(NamedTuple):
    """A host feature block already in int8 transfer form."""

    q: np.ndarray      # (B, T, D) int8
    scale: np.ndarray  # (B, T, 1) float32

    @property
    def shape(self):
        return self.q.shape

    def pad_rows(self, rows: int) -> "QuantFeature":
        """Zero-pad the batch axis (``make_batch``'s ``pad_rows_to``):
        padded rows dequantize to exact 0.0, as the uncached path's
        all-zero rows do (q is 0 whatever the scale)."""
        if rows <= self.q.shape[0]:
            return self
        return QuantFeature(q=_pad_rows(self.q, rows),
                            scale=_pad_rows(self.scale, rows))


class BF16Feature(NamedTuple):
    """A host feature block already rounded to bf16, held as its uint16
    bits (numpy has no bf16 dtype)."""

    bits: np.ndarray   # (B, T, D) uint16

    @property
    def shape(self):
        return self.bits.shape

    def pad_rows(self, rows: int) -> "BF16Feature":
        """Zero-pad the batch axis; bits 0 are bf16 0.0."""
        if rows <= self.bits.shape[0]:
            return self
        return BF16Feature(bits=_pad_rows(self.bits, rows))

    def tensor(self) -> torch.Tensor:
        """The block as a bf16 tensor on the CPU (a copy of the bits)."""
        return torch.from_numpy(self.bits.view(np.int16).copy()).view(
            torch.bfloat16)


def bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 -> bf16 (round to nearest even, as torch and ml_dtypes
    round) as uint16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


class FeatureCache:
    """Per-(plan, stream) write-once block cache under ``cache_dir``.

    ``transfer`` is the feature transfer form the cache stores:
    ``"float32"`` (default), ``"bfloat16"`` or ``"int8"``. It must match
    the run's feature transfer; it is part of the key, so a directory
    filled at another transfer never hits."""

    def __init__(self, cache_dir: str, transfer: str = "float32"):
        if transfer not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"feature cache transfer {transfer!r}")
        self.dir = cache_dir
        self.transfer = transfer
        os.makedirs(cache_dir, exist_ok=True)
        self.hits = 0
        self.misses = 0

    # -- keys --------------------------------------------------------------
    def key(self, paths: Sequence[str], max_frames: int, skip: int) -> str:
        h = hashlib.sha1()
        h.update(f"v{_VERSION}|{self.transfer}|{max_frames}|{skip}"
                 .encode())
        for p in paths:
            st = os.stat(p)
            h.update(f"|{p}|{st.st_mtime_ns}|{st.st_size}".encode())
        return h.hexdigest()

    def _path(self, key: str, part: str) -> str:
        return os.path.join(self.dir, f"{key}.{part}.npy")

    # -- read --------------------------------------------------------------
    def get(self, key: str):
        """The cached ``(block, lens)`` for ``key``, or None. ``block`` is
        a float32 ndarray, a :class:`BF16Feature` or a
        :class:`QuantFeature`, backed by read-only ``mmap``s."""
        try:
            ln = np.load(self._path(key, "len"))
            if self.transfer == "int8":
                block = QuantFeature(
                    q=np.load(self._path(key, "q"), mmap_mode="r"),
                    scale=np.load(self._path(key, "s"), mmap_mode="r"))
            elif self.transfer == "bfloat16":
                block = BF16Feature(
                    bits=np.load(self._path(key, "bf16"), mmap_mode="r"))
            else:
                block = np.load(self._path(key, "f32"), mmap_mode="r")
        except (FileNotFoundError, ValueError, OSError):
            return None
        self.hits += 1
        return block, ln

    # -- write -------------------------------------------------------------
    def put(self, key: str, arr: np.ndarray, ln: np.ndarray):
        """Store the float32 block under ``key`` (atomic, write-once) and
        return it in transfer form, so the first epoch already uses it."""
        from mtn_tpu_torch.train.batch import host_quant_int8
        self.misses += 1
        self._save(key, "len", ln)
        if self.transfer == "int8":
            q, s = host_quant_int8(arr)
            self._save(key, "q", q)
            self._save(key, "s", s)
            return QuantFeature(q=q, scale=s)
        if self.transfer == "bfloat16":
            bits = bf16_bits(arr)
            self._save(key, "bf16", bits)
            return BF16Feature(bits=bits)
        self._save(key, "f32", arr)
        return arr

    def _save(self, key: str, part: str, arr: np.ndarray):
        path = self._path(key, part)
        if os.path.exists(path):
            return
        # np.save appends ".npy" to a name without it: keep the suffix so
        # the temporary name is exactly the one renamed
        tmp = f"{path}.{os.getpid()}.tmp.npy"
        np.save(tmp, arr)
        os.replace(tmp, path)
