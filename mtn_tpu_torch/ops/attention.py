"""Scaled dot-product attention: plain math and the kernel dispatch.

Counterpart of ``mtn_tpu/ops/attention.py``. :func:`sdpa` is the plain
path: scores ``q·kᵀ / sqrt(d_k)`` accumulated in f32 (bf16 GEMMs with f32
output on a GPU: :func:`~mtn_tpu_torch.ops.matmul.matmul_f32`), masked
positions filled with -1e9 (not -inf, so a fully masked row averages
v), an f32 softmax, optional dropout on the probabilities, probabilities
cast to ``v.dtype`` before the PV product, PV accumulated in f32, output
in ``q.dtype``. :func:`multi_head_attention` sends a call to the Hopper
kernel (:mod:`mtn_tpu_torch.ops.attention_kernel`) when the kernel is
selected, dropout is off and the kernel's gate takes the shapes, as
``mtn_tpu``'s dispatch does; in a training forward the kernel runs
behind its autograd wrapper. The dropout mask is this rank's part of the
mask of the whole activation: its heads' slice under tensor parallelism
(``heads``, the model axis), its rows under data parallelism (``data``);
``stack`` > 1 says that the batch axis holds ``stack`` stacked streams,
each with this rank's rows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mtn_tpu_torch.ops import attention_kernel
from mtn_tpu_torch.ops.matmul import matmul_f32
from mtn_tpu_torch.parallel.collectives import Axis, sharded_dropout

NEG_INF = -1e9


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None,
         dropout_rate: float = 0.0,
         heads: Optional[Axis] = None, data: Optional[Axis] = None,
         stack: int = 1) -> torch.Tensor:
    """q (B,H,Lq,Dk), k/v (B,H,Lk,Dk), mask bool broadcastable to
    (B,H,Lq,Lk). Returns (B,H,Lq,Dk) in q.dtype; softmax in float32.
    ``dropout_rate`` > 0 draws from torch's generator; ``heads``: the
    axis the heads are sharded over (H is this rank's); ``data``: the axis
    the rows are cut over, B being ``stack`` streams of this rank's
    rows."""
    d_k = q.shape[-1]
    scores = matmul_f32(q, k.transpose(-1, -2)) / math.sqrt(d_k)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        probs = sharded_dropout(
            probs.unflatten(0, (stack, -1)), dropout_rate, True, heads,
            dim=2, data=data, row_dim=1).flatten(0, 1)
    probs = probs.to(v.dtype)
    return matmul_f32(probs, v).to(q.dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         dropout_rate: float = 0.0,
                         use_kernel: bool = False,
                         heads: Optional[Axis] = None,
                         data: Optional[Axis] = None,
                         stack: int = 1) -> torch.Tensor:
    """Head-batched attention on projected tensors (B, H, L, Dk)."""
    if use_kernel and dropout_rate == 0.0 and \
            attention_kernel.supports(q.shape, k.shape, q.dtype):
        return attention_kernel.attention(q.contiguous(), k.contiguous(),
                                          v.contiguous(), mask)
    return sdpa(q, k, v, mask, dropout_rate, heads, data, stack)
