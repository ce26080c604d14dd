"""Residual add and LayerNorm of a sublayer boundary: the Hopper kernel
``csrc/norm.cu`` and its plain PyTorch version.

``add_norm(x, delta, bias, scale, nbias, eps)`` returns ``(x_new,
normed)`` with ``x_new = x + (delta + bias)`` (``x`` itself without
``delta``; ``bias`` may be None) and ``normed`` the LayerNorm of
``x_new`` as :class:`~mtn_tpu_torch.models.layers.RefLayerNorm` computes
it: in f32, with the unbiased std and eps added to the std, cast back to
x's dtype. ``delta + bias`` and the residual sum each round to x's dtype,
as the sublayer's bias and residual adds do, so ``x_new`` is bitwise the
plain chain's; on the card ``normed`` differs only by the rounding of the
row's two sums (the kernel's in f64, rounded once to f32; the plain
chain's in f32). The JAX package has no such kernel (XLA fuses the chain).

:func:`add_norm` calls the op ``mtn_tpu_torch::add_norm``
(``torch.library``) where :func:`supports` takes its operands and no
operand requires grad: its CUDA implementation launches the kernel
(:func:`launch`), its CPU implementation is the plain version, and its
fake implementation gives ``torch.export`` the outputs' shapes, so an
exported program keeps the op as one node. Elsewhere (autograd, another
device, a width the kernel does not take) the plain version runs.
Importing this module registers the op.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mtn_tpu_torch.ops._build import Kernel, check_cuda

MAX_D = 4096          # csrc/norm.cu: one warp a row, the row in registers
D_MULTIPLE = 128      # a row is whole 16-byte vectors, 32 lanes wide
ALIGN = 16            # bytes: the kernel's vector loads


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mtn_add_norm.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, p]
    lib.mtn_add_norm.restype = ctypes.c_int


KERNEL = Kernel("norm", _bind)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, nbias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """RefLayerNorm's arithmetic: f32, unbiased std, eps on the std."""
    d = x.shape[-1]
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).sum(dim=-1, keepdim=True) / (d - 1)
    y = scale * (xf - mean) / (torch.sqrt(var) + eps) + nbias
    return y.to(x.dtype)


def add_norm_plain(x: torch.Tensor, delta: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], scale: torch.Tensor,
                   nbias: torch.Tensor, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op's arithmetic in plain PyTorch: a sublayer's residual
    ``x + (delta + bias)``, then :func:`layer_norm` of the sum."""
    if delta is not None:
        x = x + (delta if bias is None else delta + bias)
    return x, layer_norm(x, scale, nbias, eps)


def kernel_takes(d: int) -> bool:
    """The kernel's width term: whole vectors across a warp, the row in
    one warp's registers."""
    return d % D_MULTIPLE == 0 and 0 < d <= MAX_D


def supports(x: torch.Tensor, delta: Optional[torch.Tensor],
             bias: Optional[torch.Tensor], scale: torch.Tensor,
             nbias: torch.Tensor) -> bool:
    """Dispatch gate: activations bf16 or f32 (``delta`` and ``bias`` of
    the same type), norm parameters f32 or of that type, on the CPU (the
    plain version) or on CUDA at a width the kernel takes. Reads shapes,
    types and devices only, so it also runs on a tracer's fake
    tensors."""
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16) or x.numel() == 0:
        return False
    if bias is not None and delta is None:
        return False
    if any(t.dtype != dt or t.device != x.device
           for t in (delta, bias) if t is not None):
        return False
    if scale.dtype != nbias.dtype or scale.dtype not in (torch.float32, dt):
        return False
    if delta is not None and delta.shape != x.shape:
        return False
    D = x.shape[-1]
    if any(t.shape != (D,) or t.device != x.device
           for t in (scale, nbias) + ((bias,) if bias is not None else ())):
        return False
    if x.device.type == "cpu":
        return True
    return x.device.type == "cuda" and kernel_takes(D)


def add_norm(x: torch.Tensor, delta: Optional[torch.Tensor],
             bias: Optional[torch.Tensor], scale: torch.Tensor,
             nbias: torch.Tensor, eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x + (delta + bias), its LayerNorm)``: the op inside the gate
    with no operand requiring grad, else the plain version."""
    ts = [t for t in (x, delta, bias, scale, nbias) if t is not None]
    if (torch.is_grad_enabled() and any(t.requires_grad for t in ts)) \
            or not supports(x, delta, bias, scale, nbias):
        return add_norm_plain(x, delta, bias, scale, nbias, eps)
    c = lambda t: None if t is None else t.contiguous()
    return add_norm_op(x.contiguous(), c(delta), c(bias), scale.contiguous(),
                       nbias.contiguous(), float(eps))


def launch(x: torch.Tensor, delta: Optional[torch.Tensor],
           bias: Optional[torch.Tensor], scale: torch.Tensor,
           nbias: torch.Tensor, eps: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on CUDA tensors; raises on anything it
    cannot take."""
    if not supports(x, delta, bias, scale, nbias) or x.device.type != "cuda":
        raise ValueError(
            f"add_norm: no kernel for x {x.dtype} {tuple(x.shape)} on "
            f"{x.device}, delta/bias "
            f"{[None if t is None else t.dtype for t in (delta, bias)]}, "
            f"norm parameters {scale.dtype}")
    ops = [t for t in (x, delta, bias, scale, nbias) if t is not None]
    if any(not t.is_contiguous() or t.data_ptr() % ALIGN for t in ops):
        raise ValueError(f"add_norm: operands must be contiguous and "
                         f"{ALIGN}-byte aligned")
    D = x.shape[-1]
    R = x.numel() // D
    x_out, normed = torch.empty_like(x), torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = KERNEL.lib().mtn_add_norm(
        x.data_ptr(), ptr(delta), ptr(bias), scale.data_ptr(),
        nbias.data_ptr(), x_out.data_ptr(), normed.data_ptr(), R, D,
        int(x.dtype == torch.bfloat16), int(scale.dtype == torch.float32),
        eps, torch.cuda.current_stream(x.device).cuda_stream)
    check_cuda(rc, "add_norm kernel launch")
    KERNEL.count((x, delta, bias, scale, nbias))
    return x_out, normed


@torch.library.custom_op("mtn_tpu_torch::add_norm", mutates_args=(),
                         device_types="cuda")
def add_norm_op(x: torch.Tensor, delta: Optional[torch.Tensor],
                bias: Optional[torch.Tensor], scale: torch.Tensor,
                nbias: torch.Tensor, eps: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op: one kernel launch on the card (:func:`launch`)."""
    return launch(x, delta, bias, scale, nbias, eps)


@add_norm_op.register_kernel("cpu")
def _add_norm_cpu(x, delta, bias, scale, nbias, eps):
    x_new, normed = add_norm_plain(x, delta, bias, scale, nbias, eps)
    # an op's output never aliases an input
    return (x_new.clone() if x_new is x else x_new), normed


@add_norm_op.register_fake
def _add_norm_fake(x, delta, bias, scale, nbias, eps):
    mk = lambda: torch.empty_like(x, memory_format=torch.contiguous_format)
    return mk(), mk()
