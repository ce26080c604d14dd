"""Lazy video-feature registry and the batch feature loaders.

The port's own copy of ``mtn_tpu/data/features.py``: the registry maps
``vid -> (path, n_frames)`` per stream from header-only reads (``.npy``;
a ``.pkl`` file holds one pickled array and is loaded whole); a batch
load zero-pads each stream to ``(B, max_frames, D)`` f32 with explicit
frame counts, applies the frame skip, flattens 3-D ``(T, R, D)`` arrays
into ``T*R`` frames, and reads each distinct file of a batch once.

``.npy`` streams go through the C++ loader (``data/native_loader.py``)
when it is built; files it cannot parse (f16, integers, Fortran order)
and ``.pkl`` files are read with numpy, to the same bits. A
:class:`~mtn_tpu_torch.data.feature_cache.FeatureCache` passed as
``cache=`` serves blocks it holds and stores the ones it does not.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np


def get_npy_shape(filename: str) -> Tuple[int, ...]:
    """Read only the array header (a ``.pkl`` is loaded whole)."""
    if filename.endswith(".pkl"):
        return tuple(_load_npy(filename).shape)
    with open(filename, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, _, _ = np.lib.format.read_array_header_1_0(f)
        else:
            shape, _, _ = np.lib.format.read_array_header_2_0(f)
    return shape


class FeatureRegistry:
    """Per-stream map ``vid -> (path, n_frames)`` built from header reads."""

    def __init__(self, fea_types: Sequence[str], fea_path_template: str,
                 vid_set: Sequence[str]):
        self.fea_types = list(fea_types)
        self.streams: List[Dict[str, Tuple[str, int]]] = []
        if vid_set and self.fea_types and \
                "<ImageID>" not in fea_path_template:
            raise ValueError(
                f"feature path {fea_path_template!r} has no <ImageID> "
                "placeholder — expected a per-video template like "
                "'data/<FeaType>/<ImageID>.npy'")
        for ftype in self.fea_types:
            basepath = fea_path_template.replace("<FeaType>", ftype)
            stream: Dict[str, Tuple[str, int]] = {}
            for vid in vid_set:
                filepath = basepath.replace("<ImageID>", vid)
                shape = get_npy_shape(filepath)
                if len(shape) == 2:
                    n = shape[0]
                elif len(shape) == 3:
                    n = shape[0] * shape[1]  # regions flatten into frames
                else:
                    raise NotImplementedError(
                        f"{filepath}: {len(shape)}-D feature array {shape}; "
                        "only 2-D (n_frames, dim) and 3-D "
                        "(n_frames, regions, dim) are supported")
                stream[vid] = (filepath, n)
            self.streams.append(stream)

    def __len__(self) -> int:
        return len(self.streams)

    def n_frames(self, stream_idx: int, vid: str) -> int:
        return self.streams[stream_idx][vid][1]

    def path(self, stream_idx: int, vid: str) -> str:
        return self.streams[stream_idx][vid][0]

    def feature_dims(self) -> List[int]:
        """Last-axis dim per stream, from the first video's header."""
        return [get_npy_shape(next(iter(stream.values()))[0])[-1]
                for stream in self.streams]


def _load_npy(path: str) -> np.ndarray:
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return np.asarray(pickle.load(f))
    return np.load(path)


def native_in_use() -> bool:
    """True when the C++ loader is built and loaded in this process, so
    :func:`load_features` reads ``.npy`` streams with it by default."""
    from mtn_tpu_torch.data import native_loader
    return native_loader.available()


def _load_numpy(paths: Sequence[str], max_frames: int, skip: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    read_cache: Dict[str, np.ndarray] = {}

    def _read(p):
        a = read_cache.get(p)
        if a is None:
            a = _load_npy(p)[::skip]
            a = a.reshape(-1, a.shape[-1]) if a.ndim == 3 else a
            read_cache[p] = a
        return a
    D = _read(paths[0]).shape[-1]
    arr = np.zeros((len(paths), max_frames, D), dtype=np.float32)
    ln = np.zeros((len(paths),), dtype=np.int32)
    for j, p in enumerate(paths):
        a = _read(p)
        n = min(a.shape[0], max_frames)
        arr[j, :n] = a[:n]
        ln[j] = n
    return arr, ln


def _load_native(native, paths: Sequence[str], max_frames: int, skip: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The C++ reader over the distinct files, scattered to their rows."""
    uniq = list(dict.fromkeys(paths))
    arr, ln = native.load_batch(uniq, max_frames, skip)
    if len(uniq) < len(paths):
        pos = {p: k for k, p in enumerate(uniq)}
        inv = np.array([pos[p] for p in paths])
        arr, ln = arr[inv], ln[inv]
    return arr, ln


def load_features(registry: FeatureRegistry, vids: Sequence[str],
                  max_frames: Sequence[int], skip: Sequence[int],
                  use_native: bool = True, cache=None
                  ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Load and pad one batch of per-video features.

    Returns ``(fts, fts_len)``: ``fts[i]`` is a zero-padded
    ``(B, max_frames[i], D_i)`` float32 array for stream ``i`` and
    ``fts_len[i]`` the (B,) int32 count of real frames after skipping.
    With ``cache``, a block comes back in the cache's transfer form
    (float32, :class:`~mtn_tpu_torch.data.feature_cache.BF16Feature` or
    :class:`~mtn_tpu_torch.data.feature_cache.QuantFeature`).
    """
    native = None
    if use_native:
        from mtn_tpu_torch.data import native_loader
        native = native_loader if native_loader.available() else None
    fts: List[np.ndarray] = []
    lens: List[np.ndarray] = []
    for i in range(len(registry)):
        paths = [registry.path(i, vid) for vid in vids]
        s = skip[i] if i < len(skip) else 1
        frames = int(max_frames[i])
        key = None
        if cache is not None:
            key = cache.key(paths, frames, int(s))
            hit = cache.get(key)
            if hit is not None:
                fts.append(hit[0])
                lens.append(hit[1])
                continue
        arr = None
        if native is not None and all(p.endswith(".npy") for p in paths):
            try:
                arr, ln = _load_native(native, paths, frames, s)
            except IOError:   # a dtype or layout the C++ reader refuses
                arr = None
        if arr is None:
            arr, ln = _load_numpy(paths, frames, s)
        if key is not None:
            arr = cache.put(key, arr, ln)   # the transfer form
        fts.append(arr)
        lens.append(ln)
    return fts, lens
