"""The explicit collectives of the parallel layer.

GSPMD inserts these in ``mtn_tpu`` from the sharding rules; here the
layers call them. Megatron's pairing makes each attention and FFN block
one reduce over ``model``:

- :func:`copy_to_model`: the input of a column-parallel product. The
  identity forward; the backward sums the ranks' input gradients, each
  computed from its column slice.
- :func:`reduce_from_model`: the output of a row-parallel product (and
  of a vocab-parallel lookup). The forward sums the ranks' partials; the
  backward is the identity, the gradient being the same on every rank.
- :func:`gather_last`: the column slices of an output joined along the
  last axis where the next layer needs it whole (the vocabulary head's
  logits, the video projections). The backward keeps this rank's slice
  of the gradient: every rank computes the same replicated loss, so no
  sum.
- :func:`gather_rows`: the rows of every data rank, concatenated in rank
  order (results, with no gradient).

And one draw that is not a collective: :func:`sharded_dropout`, the
dropout of an activation that a rank holds a part of: its rows of the
batch over ``data``, and over ``model`` its slice of a sharded activation
(the FFN's hidden units, the attention probabilities of its heads). Every
rank is seeded alike, so each draws the mask of the whole activation and
keeps its part: the ranks' parts are disjoint pieces of one mask, as
JAX's one draw over the global tensor, and the mesh draws one process's
masks.

A sum over ranks is taken by the backend in one order for all ranks, so
every rank holds the same bits after it.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One mesh axis as seen by this rank: its size, this rank's index on
    it and the process group of the ranks that differ only along it."""

    size: int
    rank: int
    group: Any = None


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a new tensor)."""
    y = x.clone()
    dist.all_reduce(y, group=axis.group)
    return y


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """``x`` of every rank of ``axis``, concatenated along ``dim``."""
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.width = axis, x.shape[-1]
        return all_gather(x, axis, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.axis.rank * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


def copy_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis)


def gather_last(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _GatherLast.apply(x, axis)


def gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The rows (axis 0) of every data rank, in rank order."""
    return all_gather(x, axis, dim=0)


def sharded_dropout(x: torch.Tensor, rate: float, training: bool,
                    axis: Optional[Axis] = None, dim: int = -1,
                    data: Optional[Axis] = None,
                    row_dim: int = 0) -> torch.Tensor:
    """Dropout of ``x``, this rank's part of an activation whose dimension
    ``dim`` is sharded over ``axis`` (the model axis) and whose dimension
    ``row_dim`` holds this rank's rows of the batch over ``data``. The
    mask is this rank's part of one mask drawn over the whole activation.

    One law on every device and mesh, a world of one included: ATen's
    CPU dropout (``bernoulli_(1 - rate)``, ``div_(1 - rate)``). On the CPU
    that is ``F.dropout`` itself; on CUDA ``F.dropout`` is a fused kernel
    whose bits differ, so drawing it there would part a mesh from one
    process."""
    if not training or rate == 0.0:
        return x
    if rate == 1.0:
        return x * 0
    shape, cuts = list(x.shape), []
    for ax, d in ((axis, dim), (data, row_dim)):
        if ax is not None:
            n = shape[d]
            shape[d] = n * ax.size
            cuts.append((d, ax.rank * n, n))
    noise = x.new_empty(shape).bernoulli_(1 - rate).div_(1 - rate)
    for d, start, n in cuts:
        noise = noise.narrow(d, start, n)
    return x * noise
