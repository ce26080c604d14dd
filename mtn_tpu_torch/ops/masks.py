"""Attention masks as plain functions on tensors (``mtn_tpu/ops/masks.py``).

Mask convention: bool, True = attend. ``(B, 1, Lk)`` for key-padding
masks and ``(B, Lq, Lk)`` for the target mask; attention broadcasts them
over heads.
"""

from __future__ import annotations

import torch


def pad_mask(seq: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, L) int tokens -> (B, 1, L) bool."""
    return (seq != pad)[:, None, :]


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, 1, max_len) bool."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None])[:, None, :]


def attend_first_if_empty(mask: torch.Tensor) -> torch.Tensor:
    """(B, 1, L) key mask: rows with NO valid key attend key 0 only.

    The decode-time law for fully-masked sources (a lone-<blank> history
    or caption): it makes decode independent of the padded length, as in
    ``mtn_tpu``. Training keeps the raw masks."""
    any_valid = mask.any(dim=-1, keepdim=True)
    first = torch.zeros_like(mask)
    first[..., :1] = True
    return torch.where(any_valid, mask, first)


def causal_mask(size: int, device) -> torch.Tensor:
    """(1, size, size) bool lower-triangular."""
    return torch.ones((size, size), dtype=torch.bool,
                      device=device).tril()[None]


def target_mask(tgt: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, L) tokens -> (B, L, L) bool causal+pad mask."""
    return pad_mask(tgt, pad) & causal_mask(tgt.shape[-1], tgt.device)
