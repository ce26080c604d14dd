"""Products with float32 output, as JAX's ``preferred_element_type=float32``.

:func:`matmul_f32` is ``a @ b`` in f32. For bf16 operands on a GPU it is
one GEMM in the operand dtype with f32 accumulation and output
(``aten::mm.dtype`` / ``aten::bmm.dtype``), as ``mtn_tpu``'s
``jnp.einsum(..., preferred_element_type=jnp.float32)`` and
``jnp.dot(...)`` run; elsewhere (the CPU, f32 operands, unequal batch
axes) the operands are widened to f32 first, which gives the same
values up to summation order, since a product of two bf16 values is
exact in f32. PyTorch has no derivative for the f32-output overloads, so
:class:`MatmulF32` supplies one: f32 products cast to each operand's
dtype, which is what autograd of the widened product computes (and the
transpose JAX takes).
"""

from __future__ import annotations

import torch


def _f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One GEMM of same-dtype operands with f32 output (CUDA only)."""
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    batch = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                    b.reshape(-1, *b.shape[-2:]), out_dtype=torch.float32)
    return out.reshape(*batch, a.shape[-2], b.shape[-1])


class MatmulF32(torch.autograd.Function):
    """``_f32_out`` forward; f32 products in the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _f32_out(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(grad, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().transpose(-1, -2), grad).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result; ``a`` (..., M, K), ``b`` (..., K, N)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16 \
            and a.dim() == b.dim() >= 2 and a.shape[:-2] == b.shape[:-2]:
        return MatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float())
