"""Fused attention: the Hopper kernel ``csrc/attention.cu`` and its plain
PyTorch version.

Counterpart of ``mtn_tpu/ops/pallas_attention.py`` (``flash_attention``,
gate ``supports``). Both compute, per (batch, head),
``softmax(where(mask, q·kᵀ·(1/√D), -1e9))·v`` with f32 accumulation, an
f32 softmax, probabilities rounded to ``v.dtype`` before the PV product
and the output in ``q.dtype``. The mask is one (B, Lq, Lk) pattern for
all heads: a 4-D mask takes head 0, like ``_canon_mask``.

:func:`attention` calls the op ``mtn_tpu_torch::attention``
(``torch.library``), whose CUDA implementation launches the kernel
(:func:`launch`) and whose CPU implementation is the plain version; its
fake implementation gives ``torch.export`` the output's shape, so an
exported program keeps the op as one node and launches the kernel when
it runs on the card. Importing this module registers the op. Anything
the kernel cannot take raises before the op is called (a tracer's fake
tensors included) and again in :func:`launch`. Where an input requires
grad, the call goes through :class:`AttentionFunction`, whose forward
calls the op and whose backward is the plain math recomputed from the
saved inputs, as ``_flash_bwd`` recomputes ``sdpa_xla`` through
``jax.vjp`` (there is no backward kernel, in either package); on the CPU
autograd differentiates the plain version itself.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from mtn_tpu_torch.ops._build import Kernel, check_cuda

NEG_INF = -1e9
MAX_SEQ = 2048        # the TPU gate's sequence limit
VMEM_LIMIT = 8 * 1024 * 1024  # the TPU gate's VMEM term
MAX_ROWS = 8          # f32: query rows (warps) per block, csrc/attention.cu
KEY_CHUNK = 64        # bf16: keys of a ring stage
MAX_TILES = 4         # bf16: 16-row query tiles (warps) per block
PAD = 8               # bf16: shared row padding, elements
SMEM_LIMIT = 232448   # H100: 227 KB of shared memory per block


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mtn_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, ll, ll,
                                  i, p]
    lib.mtn_attention.restype = ctypes.c_int


KERNEL = Kernel("attention", _bind)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(Lq: int, Lk: int, D: int, itemsize: int) -> int:
    """Shared memory of one block (the layouts in csrc/attention.cu).

    bf16 (``bf16_layout``): the Q tiles and one K/V stage of
    ``KEY_CHUNK`` keys, rows of D rounded up to 16 plus 16 bytes; past one
    chunk, two stages (a double-buffered ring). It does not depend on Lk
    past one chunk. f32: the head's whole K and V, the query rows and
    their score rows."""
    if itemsize == 2:
        ld = _align16(D) + PAD
        tiles = min(MAX_TILES, -(-Lq // 16))
        stages = 2 if Lk > KEY_CHUNK else 1
        return 16 * tiles * ld * 2 + stages * 2 * KEY_CHUNK * ld * 2
    rows = min(Lq, MAX_ROWS)
    return (_align16(Lk * (D + 1) * 4) + _align16(Lk * D * 4)
            + _align16(rows * D * 4) + rows * Lk * 4)


def supports(q_shape: Tuple[int, ...], k_shape: Tuple[int, ...],
             dtype: torch.dtype) -> bool:
    """Dispatch gate. The TPU gate's shape terms (D ≤ 256, Lq, Lk ≤ 2048,
    Lq ≥ 16); then for bf16 its VMEM term as written, so the kernel runs
    on exactly the calls where JAX ran Pallas (every such shape fits the
    block's shared memory), and for f32 this kernel's shared-memory
    limit in place of the VMEM term."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    B, H, Lq, D = q_shape
    Lk = k_shape[2]
    if D > 256 or Lq > MAX_SEQ or Lk > MAX_SEQ:
        return False
    if Lq < 16:
        return False
    if dtype == torch.bfloat16:
        return 4 * (Lq * Lk) + 4 * D * (2 * Lq + 2 * Lk) < VMEM_LIMIT
    itemsize = torch.empty((), dtype=dtype).element_size()
    return smem_bytes(Lq, Lk, D, itemsize) <= SMEM_LIMIT


def _canon_mask(mask: Optional[torch.Tensor], B: int, Lq: int,
                Lk: int) -> Optional[torch.Tensor]:
    """A (B, Lq, Lk) bool view of any (B|1, [1|H,] 1|Lq, Lk) mask; a
    broadcast axis keeps stride 0 (nothing is materialised)."""
    if mask is None:
        return None
    m = mask[:, 0] if mask.dim() == 4 else mask
    if m.dim() != 3:
        raise ValueError(f"attention mask of shape {tuple(mask.shape)}")
    return m.expand(B, Lq, Lk)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * (1.0 / math.sqrt(D))
    m = _canon_mask(mask, B, Lq, Lk)
    if m is not None:
        scores = torch.where(m[:, None], scores, NEG_INF)
    mx = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - mx)
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,H,Lq,D), k/v (B,H,Lk,D), mask bool broadcastable to
    (B,Lq,Lk) or (B,1,Lq,Lk). Returns (B,H,Lq,D) in q.dtype."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask) if grad else \
            attention_op(q, k, v, mask)
    check(q, k, v, mask)
    if grad:
        return AttentionFunction.apply(q, k, v, mask)
    return attention_op(q, k, v, mask)


class AttentionFunction(torch.autograd.Function):
    """The kernel forward; the backward differentiates the plain version
    (``sdpa``) recomputed on the saved inputs. The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return attention_op(q, k, v, mask)

    @staticmethod
    def backward(ctx, grad_out):
        from mtn_tpu_torch.ops.attention import sdpa
        q, k, v, mask = ctx.saved_tensors
        m = _canon_mask(mask, q.shape[0], q.shape[2], k.shape[2])
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip((q, k, v), ctx.needs_input_grad[:3])]
        wrt = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = sdpa(*inputs, None if m is None else m[:, None])
            grads = iter(torch.autograd.grad(out, wrt, grad_out))
        return (*(next(grads) if t.requires_grad else None
                  for t in inputs), None)


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Raise on anything the kernel cannot take; returns the (B, Lq, Lk)
    view of the mask. Reads shapes, types, devices and strides only, so
    it also runs on a tracer's fake tensors."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(f"attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"attention: {name} must be contiguous on "
                             f"{q.device}")
    if q.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {q.device}")
    if smem_bytes(Lq, Lk, D, q.element_size()) > SMEM_LIMIT:
        raise ValueError(f"attention: Lq={Lq}, Lk={Lk}, D={D} exceed the "
                         "kernel's shared memory")
    m = _canon_mask(mask, B, Lq, Lk)
    if m is not None and (m.dtype != torch.bool or m.device != q.device):
        raise TypeError(f"attention: mask must be bool on {q.device}")
    return m


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors; raises on anything it
    cannot take."""
    m = check(q, k, v, mask)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    strides = m.stride() if m is not None else (0, 0, 0)
    out = torch.empty_like(q)
    rc = KERNEL.lib().mtn_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        m.data_ptr() if m is not None else None, out.data_ptr(),
        B, H, Lq, Lk, D, *strides, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_cuda(rc, "attention kernel launch")
    KERNEL.count((q, k, v, mask))
    return out


@torch.library.custom_op("mtn_tpu_torch::attention", mutates_args=(),
                         device_types="cuda")
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The op: one kernel launch on the card (:func:`launch`)."""
    return launch(q, k, v, mask)


@attention_op.register_kernel("cpu")
def _attention_cpu(q, k, v, mask=None):
    return attention_plain(q, k, v, mask)


@attention_op.register_fake
def _attention_fake(q, k, v, mask=None):
    return torch.empty_like(q, memory_format=torch.contiguous_format)
