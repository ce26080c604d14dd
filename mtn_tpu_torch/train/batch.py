"""Device-side batches and their masks (``mtn_tpu/train/batch.py``).

A :class:`DeviceBatch` holds the tokens, features and frame counts of one
host batch as tensors on one device; :func:`batch_masks` derives every
mask from them. Without a separate caption the batch carries a
single-<blank> caption column, whose pad mask is all False. Gradient
accumulation groups equal-shape batches (:func:`accumulated`) and fills a
ragged last group with :func:`blank_like` batches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch

from mtn_tpu_torch.data.batching import HostBatch
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


def device_batch(hb: HostBatch, device: Union[str, torch.device],
                 feature_dtype: str = "float32") -> DeviceBatch:
    """Copy a host batch to ``device``; features travel in
    ``feature_dtype`` ('float32' or 'bfloat16')."""
    if feature_dtype == "int8":
        raise NotImplementedError(
            "int8 feature transfer is not ported yet (ROADMAP: int8)")
    fdt = torch_dtype(feature_dtype)
    cap = hb.cap
    if cap is None:
        cap = np.ones((hb.query.shape[0], 1), dtype=np.int32)
    tok = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)
    return DeviceBatch(
        query=tok(hb.query), his=tok(hb.his), cap=tok(cap),
        answer_in=tok(hb.answer_in), answer_out=tok(hb.answer_out),
        fts=tuple(torch.from_numpy(np.asarray(f, np.float32)).to(
            device=device, dtype=fdt) for f in hb.fts),
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
