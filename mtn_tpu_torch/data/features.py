"""Lazy video-feature registry and the numpy ``.npy`` loader.

The port's own copy of the ``.npy`` path of ``mtn_tpu/data/features.py``:
the registry maps ``vid -> (path, n_frames)`` per stream from header-only
reads; a batch load zero-pads each stream to ``(B, max_frames, D)`` f32
with explicit frame counts, applies the frame skip, flattens 3-D
``(T, R, D)`` arrays into ``T*R`` frames, and reads each distinct file of
a batch once. The C++ loader and the feature cache are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def get_npy_shape(filename: str) -> Tuple[int, ...]:
    """Read only the array header."""
    if not filename.endswith(".npy"):
        raise NotImplementedError(
            f"{filename}: only .npy features are read by mtn_tpu_torch")
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


def load_features(registry: FeatureRegistry, vids: Sequence[str],
                  max_frames: Sequence[int], skip: Sequence[int]
                  ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Load and pad one batch of per-video features.

    Returns ``(fts, fts_len)``: ``fts[i]`` is a zero-padded
    ``(B, max_frames[i], D_i)`` float32 array for stream ``i`` and
    ``fts_len[i]`` the (B,) int32 count of real frames after skipping.
    """
    B = len(vids)
    fts: List[np.ndarray] = []
    lens: List[np.ndarray] = []
    for i in range(len(registry)):
        paths = [registry.path(i, vid) for vid in vids]
        s = skip[i] if i < len(skip) else 1
        read_cache: Dict[str, np.ndarray] = {}

        def _read(p):
            a = read_cache.get(p)
            if a is None:
                a = np.load(p)[::s]
                a = a.reshape(-1, a.shape[-1]) if a.ndim == 3 else a
                read_cache[p] = a
            return a
        D = _read(paths[0]).shape[-1]
        arr = np.zeros((B, int(max_frames[i]), D), dtype=np.float32)
        ln = np.zeros((B,), dtype=np.int32)
        for j, p in enumerate(paths):
            a = _read(p)
            n = min(a.shape[0], arr.shape[1])
            arr[j, :n] = a[:n]
            ln[j] = n
        fts.append(arr)
        lens.append(ln)
    return fts, lens
