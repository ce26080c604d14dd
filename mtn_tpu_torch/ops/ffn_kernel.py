"""Fused position-wise FFN: the Hopper kernel ``csrc/ffn.cu`` and its
plain PyTorch version.

Counterpart of ``mtn_tpu/ops/pallas_ffn.py`` (``fused_ffn``, gate
``supports``): ``h = relu(x·W1 + b1)`` in f32, rounded to ``W2.dtype``;
``y = h·W2 + b2`` in f32, stored in ``x.dtype``, or in f32 with
``f32_out`` (a tensor-parallel rank's partial sum over its d_ff slice,
which the ranks add in f32 before rounding). Weights keep the JAX
layout, W1 (D, F) and W2 (F, D).

:func:`ffn` calls the op ``mtn_tpu_torch::ffn`` (``torch.library``),
whose CUDA implementation launches the kernel (:func:`launch`) and whose
CPU implementation is the plain version; its fake implementation gives
``torch.export`` the output's shape, so an exported program keeps the op
as one node. Importing this module registers the op. Anything the
kernel cannot take raises before the op is called (a tracer's fake
tensors included) and again in :func:`launch`. Where an input requires
grad, the call goes through :class:`FFNFunction`, whose forward calls
the op and whose backward is the plain math recomputed from the saved
inputs, as ``_fused_bwd`` recomputes ``_xla_ffn`` through ``jax.vjp``;
on the CPU autograd differentiates the plain version itself.
:func:`fused_ffn` is the dispatch of ``FeedForward``: the kernel inside
the gate, the plain version outside it, as the JAX package dispatches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mtn_tpu_torch.ops._build import Kernel, check_cuda
from mtn_tpu_torch.ops.matmul import matmul_f32

ROW_BLOCK = 256       # the TPU gate: one row block of the Pallas grid
ROW_TILE = {2: 32, 4: 16}  # rows per block by itemsize, csrc/ffn.cu
F_TILE = 256          # d_ff columns per slice, csrc/ffn.cu
PAD = 8               # shared row padding, elements
STAGES = 3            # bf16 weight ring: stages of 64 W1 rows or 32 W2 rows
STAGE_ELEMS = max(64 * (F_TILE + PAD), 32 * (512 + PAD))
BARRIERS = 2 * STAGES * 8  # bf16: the ring's full and empty mbarriers
SMEM_LIMIT = 232448   # H100: 227 KB of shared memory per block


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mtn_ffn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.mtn_ffn.restype = ctypes.c_int


KERNEL = Kernel("ffn", _bind)


def _align128(n: int) -> int:
    return (n + 127) // 128 * 128


def smem_bytes(d_model: int, itemsize: int) -> int:
    """Shared memory of one block (``layout`` in csrc/ffn.cu, and the
    ring's mbarriers)."""
    rows = ROW_TILE[itemsize]
    partial = rows * (d_model + PAD) * 4
    if itemsize == 2:
        return (_align128(rows * (d_model + PAD) * 2)
                + _align128(rows * (F_TILE + PAD) * 2)
                + _align128(partial) + _align128(d_model * 2)
                + STAGES * STAGE_ELEMS * 2 + BARRIERS)
    return (_align128(rows * d_model * 4)
            + _align128(rows * F_TILE * 4) + partial)


def supports(n_rows: int, d_model: int, d_ff: int, itemsize: int) -> bool:
    """Dispatch gate: the TPU gate's row term (one 256-row block), with
    the VMEM byte term replaced by this kernel's shared-memory limit and
    tile divisibility."""
    if n_rows > ROW_BLOCK:
        return False
    if d_model % 16 or d_ff % F_TILE:
        return False
    return smem_bytes(d_model, itemsize) <= SMEM_LIMIT


def ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              f32_out: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch; x is (N, D). The products
    have f32 output (bf16 GEMMs on a GPU, as JAX's ``_xla_ffn``)."""
    h = torch.relu(matmul_f32(x, w1) + b1.float())
    y = matmul_f32(h.to(w2.dtype), w2) + b2.float()
    return y if f32_out else y.to(x.dtype)


def ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
        w2: torch.Tensor, b2: torch.Tensor,
        f32_out: bool = False) -> torch.Tensor:
    """x (N, D), w1 (D, F), b1 (F,), w2 (F, D), b2 (D,) -> (N, D), in
    x's dtype or, with ``f32_out``, in f32."""
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (x, w1, b1, w2, b2))
    if x.device.type == "cpu":
        return ffn_plain(x, w1, b1, w2, b2, f32_out) if grad else \
            ffn_op(x, w1, b1, w2, b2, f32_out)
    check(x, w1, b1, w2, b2)
    if grad:
        return FFNFunction.apply(x, w1, b1, w2, b2, f32_out)
    return ffn_op(x, w1, b1, w2, b2, f32_out)


class FFNFunction(torch.autograd.Function):
    """The kernel forward; the backward differentiates ``ffn_plain``
    recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, f32_out=False):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.f32_out = f32_out
        return ffn_op(x, w1, b1, w2, b2, f32_out)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wrt = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ffn_plain(*inputs, f32_out=ctx.f32_out)
            grads = iter(torch.autograd.grad(out, wrt, grad_out))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None,)


def check(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
          w2: torch.Tensor, b2: torch.Tensor) -> None:
    """Raise on anything the kernel cannot take, but the operands'
    alignment (:func:`launch` checks it). Reads shapes, types, devices
    and strides only, so it also runs on a tracer's fake tensors."""
    if x.dim() != 2:
        raise ValueError(f"ffn: x must be (N, D), got {tuple(x.shape)}")
    N, D = x.shape
    F = w1.shape[-1]
    if w1.shape != (D, F) or b1.shape != (F,) or w2.shape != (F, D) \
            or b2.shape != (D,):
        raise ValueError(f"ffn: shapes x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 "
                         f"{tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    if N == 0 or D % 16 or F % F_TILE:
        raise ValueError(f"ffn: needs N > 0, D % 16 == 0 and F % {F_TILE} "
                         f"== 0 (N={N}, D={D}, F={F})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ffn: dtype {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"ffn: no kernel for device {x.device}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        if t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"ffn: {name} must be contiguous {x.dtype} on "
                             f"{x.device}")
    if smem_bytes(D, x.element_size()) > SMEM_LIMIT:
        raise ValueError(f"ffn: D={D} exceeds the kernel's shared memory")


def launch(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
           w2: torch.Tensor, b2: torch.Tensor,
           f32_out: bool = False) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors; raises on anything it
    cannot take."""
    check(x, w1, b1, w2, b2)
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        if t.data_ptr() % 32:
            raise ValueError(f"ffn: {name} must be 32-byte aligned")
    N, D = x.shape
    F = w1.shape[-1]
    out = torch.empty_like(x, dtype=torch.float32 if f32_out else x.dtype)
    rc = KERNEL.lib().mtn_ffn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), N, D, F,
        int(x.dtype == torch.bfloat16), int(f32_out),
        torch.cuda.current_stream(x.device).cuda_stream)
    check_cuda(rc, "ffn kernel launch")
    KERNEL.count((x, w1, b1, w2, b2, f32_out))
    return out


@torch.library.custom_op("mtn_tpu_torch::ffn", mutates_args=(),
                         device_types="cuda")
def ffn_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
           w2: torch.Tensor, b2: torch.Tensor,
           f32_out: bool = False) -> torch.Tensor:
    """The op: one kernel launch on the card (:func:`launch`)."""
    return launch(x, w1, b1, w2, b2, f32_out)


@ffn_op.register_kernel("cpu")
def _ffn_cpu(x, w1, b1, w2, b2, f32_out=False):
    return ffn_plain(x, w1, b1, w2, b2, f32_out)


@ffn_op.register_fake
def _ffn_fake(x, w1, b1, w2, b2, f32_out=False):
    return torch.empty_like(x, dtype=torch.float32 if f32_out else x.dtype,
                            memory_format=torch.contiguous_format)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, f32_out: bool = False,
              gate_rows: Optional[int] = None) -> torch.Tensor:
    """x (..., D): the kernel where the gate takes the shape, else the
    plain version (``pallas_ffn.fused_ffn``'s dispatch). ``gate_rows``:
    the rows the gate's row term sees, x's by default; a data rank passes
    the whole batch's, the global shape JAX's gate sees under GSPMD."""
    D = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, D)
    if supports(gate_rows or x2.shape[0], D, w1.shape[1],
                x.element_size()):
        out = ffn(x2.contiguous(), w1, b1, w2, b2, f32_out)
    else:
        out = ffn_plain(x2, w1, b1, w2, b2, f32_out)
    return out.reshape(*lead, D)
