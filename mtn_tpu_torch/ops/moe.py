"""Routed experts with static shapes: DeepSeek-V3's sigmoid router with
its selection bias (``topk_method: noaux_tc``), and the experts' two
products as grouped GEMMs over the assignments sorted by expert.

Every shape depends on the token count alone and nothing is read to the
host, so a prefix or a step that calls :func:`routed_experts` captures
into a CUDA graph (``decode/graphs.py``). The (token, slot) assignments
are sorted by expert on the device, each expert's end offset is a
``scatter_add_`` and a ``cumsum``, and the gate/up and down products run
as one grouped GEMM each (``torch._grouped_mm``, bf16 on sm90) over the
rows gathered in that order. A token that is not real (a pad slot of a
uniform-shape batch, a row of no turn) goes to no expert: its
assignments sort behind every expert's under the sentinel id ``E`` and
no product reads them. The weighted rows come back to (token, slot)
order through the inverse permutation (``index_copy_``: each row written
once, no atomics, so a replay is bitwise the eager run) and are summed
over the slots in f32.

On the CPU (and for operands other than bf16) the grouped GEMM is a
loop over the experts, their offsets read to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def route(x: Tensor, gate_w: Tensor, bias: Tensor, top_k: int,
          scaling: float, norm: bool) -> Tuple[Tensor, Tensor]:
    """(weights (T, k) f32, experts (T, k) int64) of tokens ``x`` (T, D):
    f32 logits against the (E, D) gate, sigmoid scores; the experts are
    the top-k of the scores plus the correction ``bias`` (selection
    only, lower id first on a tie), weighted by their scores,
    normalised to sum 1 (``norm``) and scaled by ``scaling``."""
    scores = torch.sigmoid(x.float() @ gate_w.float().t())
    _, order = torch.sort(scores + bias, dim=-1, descending=True,
                          stable=True)
    idx = order[:, :top_k]
    w = scores.gather(1, idx)
    if norm:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * scaling, idx


def dispatch(idx: Tensor, real: Optional[Tensor], n_experts: int):
    """The (T, k) assignments ``idx`` sorted by expert: (the order, a
    permutation of the T·k assignments; the rows each expert takes (E,)
    int64; their end offsets (E,) int32; which sorted assignments go to
    an expert). Assignments of tokens that are not ``real`` go to none."""
    T, k = idx.shape
    e = idx.reshape(-1)
    if real is not None:
        e = torch.where(real[:, None].expand(T, k).reshape(-1), e,
                        n_experts)
    e_sorted, order = torch.sort(e, stable=True)
    counts = torch.zeros(n_experts + 1, dtype=torch.int64, device=e.device)
    counts.scatter_add_(0, e, torch.ones_like(e))
    offs = torch.cumsum(counts[:n_experts], 0).to(torch.int32)
    return order, counts[:n_experts], offs, e_sorted < n_experts


def grouped_mm(x: Tensor, w: Tensor, offs: Tensor) -> Tensor:
    """``x`` (N, K) rows grouped by expert times each expert's ``w[e]``
    ((E, N_out, K), a linear weight's (out, in) layout): (N, N_out), row
    i by the expert whose offsets hold it; rows past the last offset are
    not written."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)
    out = x.new_zeros(x.shape[0], w.shape[1])
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[e].t()
        start = end
    return out


def routed_experts(x: Tensor, weights: Tensor, idx: Tensor,
                   real: Optional[Tensor], gate_up: Tensor, down: Tensor,
                   rows_seen: Optional[Tensor] = None) -> Tensor:
    """The routed experts' sum for tokens ``x`` (T, D): each token's k
    experts (``idx``, :func:`route`) applied as ``down(silu(gate(x)) *
    up(x))`` and summed with ``weights`` in f32, cast to x's dtype.
    ``gate_up`` (E, 2F, D) holds each expert's gate rows, then its up
    rows; ``down`` (E, D, F). ``rows_seen`` (E,) int64, if given, gains
    the rows each expert took (in place, so a capture counts each
    replay)."""
    T, D = x.shape
    k, E, Fe = idx.shape[1], gate_up.shape[0], down.shape[2]
    order, counts, offs, live = dispatch(idx, real, E)
    if rows_seen is not None:
        rows_seen.add_(counts)
    h = grouped_mm(x.index_select(0, order // k), gate_up, offs)
    g, u = h.split(Fe, dim=-1)
    y = grouped_mm(F.silu(g) * u, down, offs)
    y = torch.where(live[:, None], y, 0)
    back = torch.empty_like(y).index_copy_(0, order, y)
    return (back.view(T, k, D).float() * weights[..., None]).sum(1) \
        .to(x.dtype)
