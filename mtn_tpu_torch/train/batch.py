"""Device-side batches and their masks (``mtn_tpu/train/batch.py``).

A :class:`DeviceBatch` holds the tokens, features and frame counts of one
host batch as tensors on one device; :func:`batch_masks` derives every
mask from them. Without a separate caption the batch carries a
single-<blank> caption column, whose pad mask is all False. Gradient
accumulation groups equal-shape batches (:func:`accumulated`) and fills a
ragged last group with :func:`blank_like` batches.

Features travel in f32, bf16 or, with ``feature_dtype="int8"``, as int8
with one f32 scale per frame (:func:`host_quant_int8`, on the host),
dequantized on the device in f32 as JAX's ``_dequant_int8`` does: about a
quarter of the f32 bytes cross the host link. A feature cache's blocks
(``data/feature_cache.py``) are already in transfer form and travel
as-is: bitwise the uncached transfer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch

from mtn_tpu_torch.data.batching import HostBatch
from mtn_tpu_torch.data.feature_cache import BF16Feature, QuantFeature
from mtn_tpu_torch.models.layers import torch_dtype
from mtn_tpu_torch.models.mtn import SourceMasks
from mtn_tpu_torch.ops.masks import length_mask, pad_mask, target_mask


@dataclass
class DeviceBatch:
    query: torch.Tensor       # (B, Lq) int64
    his: torch.Tensor         # (B, Lh)
    cap: torch.Tensor         # (B, Lc)
    answer_in: torch.Tensor   # (B, La)
    answer_out: torch.Tensor  # (B, La)
    fts: Tuple[torch.Tensor, ...]      # per stream (B, T, D)
    fts_len: Tuple[torch.Tensor, ...]  # per stream (B,)
    valid: torch.Tensor       # (B,) bool


def host_quant_int8(f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame absmax int8 quantization on the host: ``(q int8, scale
    f32 (..., 1))``; relative error at most 1/254 per frame."""
    scale = np.abs(f).max(axis=-1, keepdims=True).astype(np.float32) / 127.0
    np.maximum(scale, 1e-12, out=scale)
    q = np.rint(f / scale).astype(np.int8)
    return q, scale


def _host(a, dtype=None) -> torch.Tensor:
    """A CPU tensor of ``a``; a read-only array (a cached block's
    ``mmap``) is copied first."""
    a = np.asarray(a, dtype)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _dequant_int8(q: np.ndarray, scale: np.ndarray,
                  device: Union[str, torch.device]) -> torch.Tensor:
    """Send int8 ``q`` and its f32 row scales to ``device`` and
    dequantize there in f32."""
    return _host(q).to(device).float() * _host(scale).to(device)


def int8_transfer(f: np.ndarray,
                  device: Union[str, torch.device]) -> torch.Tensor:
    """Quantize ``f`` on the host, send the int8 array and its f32 row
    scales to ``device``, and dequantize there in f32."""
    return _dequant_int8(*host_quant_int8(np.asarray(f, np.float32)),
                         device)


def _features(f, device, feature_dtype: str) -> torch.Tensor:
    """One stream's host block on ``device`` in its transfer form."""
    if isinstance(f, QuantFeature):
        if feature_dtype != "int8":
            raise ValueError(f"an int8 feature-cache block under feature "
                             f"transfer {feature_dtype!r}")
        return _dequant_int8(f.q, f.scale, device)
    if feature_dtype == "int8":
        return int8_transfer(f, device)
    fdt = torch_dtype(feature_dtype)
    if isinstance(f, BF16Feature):
        return f.tensor().to(device=device, dtype=fdt)
    return _host(f, np.float32).to(device=device, dtype=fdt)


def device_batch(hb: HostBatch, device: Union[str, torch.device],
                 feature_dtype: str = "float32") -> DeviceBatch:
    """Copy a host batch to ``device``; features travel in
    ``feature_dtype`` ('float32', 'bfloat16', or 'int8': f32 on the
    device)."""
    cap = hb.cap
    if cap is None:
        cap = np.ones((hb.query.shape[0], 1), dtype=np.int32)
    tok = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)
    fts = tuple(_features(f, device, feature_dtype) for f in hb.fts)
    return DeviceBatch(
        query=tok(hb.query), his=tok(hb.his), cap=tok(cap),
        answer_in=tok(hb.answer_in), answer_out=tok(hb.answer_out),
        fts=fts,
        fts_len=tuple(tok(l) for l in hb.fts_len),
        valid=torch.from_numpy(np.asarray(hb.valid, bool)).to(device),
    )


def blank_like(db: DeviceBatch, pad: int = 1) -> DeviceBatch:
    """An all-padding microbatch shaped like ``db``: no real token, no
    frame, every row invalid. It adds zero loss and zero gradients, and
    fills the ragged tail of an accumulation group."""
    return DeviceBatch(
        query=torch.full_like(db.query, pad),
        his=torch.full_like(db.his, pad),
        cap=torch.full_like(db.cap, pad),
        answer_in=torch.full_like(db.answer_in, pad),
        answer_out=torch.full_like(db.answer_out, pad),
        fts=tuple(torch.zeros_like(f) for f in db.fts),
        fts_len=tuple(torch.zeros_like(l) for l in db.fts_len),
        valid=torch.zeros_like(db.valid))


def accumulated(batches, accum_steps: int, pad: int = 1):
    """Group a stream of device batches into lists of ``accum_steps``
    microbatches, the input of ``Trainer.train_step_accum``; the last,
    ragged group is completed with ``blank_like(pad=pad)`` fillers."""
    group = []
    for db in batches:
        group.append(db)
        if len(group) == accum_steps:
            yield group
            group = []
    if group:
        group += [blank_like(group[0], pad=pad)] * (accum_steps - len(group))
        yield group


def batch_masks(b: DeviceBatch, pad: int
                ) -> Tuple[SourceMasks, torch.Tensor]:
    """Returns (source masks, target mask (B, La, La))."""
    masks = SourceMasks(
        query=pad_mask(b.query, pad),
        his=pad_mask(b.his, pad),
        cap=pad_mask(b.cap, pad),
        vid=tuple(length_mask(l, f.shape[1])
                  for l, f in zip(b.fts_len, b.fts)),
    )
    return masks, target_mask(b.answer_in, pad)
