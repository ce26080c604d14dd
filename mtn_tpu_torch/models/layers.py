"""Transformer building blocks as ``nn.Module``s (``mtn_tpu/models/layers.py``).

Every parameter has the name and layout of its flax counterpart, so a
module's ``state_dict()`` keys are the flax parameter paths joined by
``.`` and a linear ``kernel`` is ``(d_in, d_out)``, applied as
``x @ kernel + bias``. Linear and embedding parameters live in the compute
dtype (loading a checkpoint casts them once; the JAX package casts its f32
params on every call, which gives the same values); norm parameters stay
in ``param_dtype``.

Numerics follow the JAX modules:

- :class:`RefLayerNorm` computes in f32 with the *unbiased* std and adds
  eps to the std (not to the variance), then casts back to x's dtype;
- :class:`ScaledEmbed` multiplies by ``sqrt(d)`` cast to the embedding
  dtype (√512 is 22.625 in bf16);
- :class:`Generator` takes logits in the compute dtype, then an f32
  ``log_softmax``.

Dropout follows ``self.training`` (JAX's ``deterministic`` is eval mode).
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
from torch import nn

from mtn_tpu_torch.ops.attention import multi_head_attention
from mtn_tpu_torch.ops.ffn_kernel import fused_ffn
from mtn_tpu_torch.ops.positional import sinusoidal_table

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype {name!r}: expected one of "
                         f"{sorted(DTYPES)}") from None


class RefLayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(d, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mean).sum(dim=-1, keepdim=True) / (d - 1)
        y = self.scale * (xf - mean) / (torch.sqrt(var) + self.eps) \
            + self.bias
        return y.to(x.dtype)


class Embed(nn.Module):
    """The flax ``nn.Embed`` parameter (``embedding``), gathered in the
    compute dtype."""

    def __init__(self, vocab_size: int, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.zeros(vocab_size, d_model, dtype=dtype))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(tokens, self.embedding)


class ScaledEmbed(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.lut = Embed(vocab_size, d_model, dtype)
        # sqrt(d) in f32, then in the embedding dtype
        self.register_buffer(
            "mult", torch.tensor(float(np.sqrt(np.float32(d_model))),
                                 dtype=torch.float32).to(dtype),
            persistent=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.lut(tokens)
        return emb * self.mult


class PosEncoding(nn.Module):
    def __init__(self, d_model: int, dropout: float, max_len: int,
                 dtype: torch.dtype):
        super().__init__()
        self.register_buffer("pe", sinusoidal_table(max_len, d_model, dtype),
                             persistent=False)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        L = x.shape[-2]
        return self.drop(x + self.pe[offset:offset + L])

    def at(self, x: torch.Tensor, pos) -> torch.Tensor:
        """Add the PE row of one position (single-step decode); ``pos`` an
        ``int`` or a 0-d int64 tensor."""
        if isinstance(pos, int):
            return x + self.pe[pos:pos + 1]
        return x + self.pe.index_select(0, pos.reshape(1))


class ParamLinear(nn.Module):
    """``x @ kernel + bias`` with a (d_in, d_out) kernel in the compute
    dtype (the JAX ``ParamLinear``).

    Also the weight-only int8 read path (``mtn_tpu_torch/utils/
    quantize.py``): after :meth:`load_int8` the kernel is an int8 buffer
    with a float32 per-output-channel ``kernel_scale`` buffer, and the
    layer computes ``(x @ q) * scale + bias`` in the compute dtype, in
    JAX's order (scaling after the product is not ``x @ (q * scale)``
    in bf16)."""

    def __init__(self, d_in: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(d_in, features, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype))

    @property
    def is_int8(self) -> bool:
        return self.kernel.dtype == torch.int8

    def load_int8(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Replace the float kernel by int8 ``q`` (d_in, d_out) and its
        float32 ``scale`` (d_out,), on the layer's device."""
        if q.dtype != torch.int8 or q.shape != self.kernel.shape \
                or scale.shape != (q.shape[1],):
            raise ValueError(f"load_int8: q {q.dtype} {tuple(q.shape)}, "
                             f"scale {tuple(scale.shape)} for a kernel of "
                             f"shape {tuple(self.kernel.shape)}")
        device = self.bias.device
        del self.kernel
        self.register_buffer("kernel", q.to(device))
        self.register_buffer("kernel_scale",
                             scale.to(device, torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.is_int8:
            y = torch.matmul(x, self.kernel.to(self.dtype))
            return y * self.kernel_scale.to(self.dtype) + self.bias
        return torch.matmul(x, self.kernel) + self.bias


class MultiHeadAttention(nn.Module):
    """h-head scaled dot-product attention with decode-time entry points."""

    def __init__(self, n_heads: int, d_model: int, dtype: torch.dtype,
                 attn_dropout: float = 0.1, use_kernel: bool = False):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"{n_heads} heads")
        self.n_heads = n_heads
        self.d_model = d_model
        self.dtype = dtype
        self.attn_dropout = attn_dropout
        self.use_kernel = use_kernel
        self.w_q = ParamLinear(d_model, d_model, dtype)
        self.w_k = ParamLinear(d_model, d_model, dtype)
        self.w_v = ParamLinear(d_model, d_model, dtype)
        self.w_o = ParamLinear(d_model, d_model, dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        d_k = self.d_model // self.n_heads
        return x.reshape(B, L, self.n_heads, d_k).transpose(1, 2)

    def _merge(self, x: torch.Tensor) -> torch.Tensor:
        B, H, L, d_k = x.shape
        return x.transpose(1, 2).reshape(B, L, H * d_k)

    def _attend(self, q, k, v, mask, rate: float) -> torch.Tensor:
        out = multi_head_attention(q, k, v, mask, dropout_rate=rate,
                                   use_kernel=self.use_kernel)
        return self.w_o(self._merge(out))

    def project_kv(self, kv_in: torch.Tensor):
        """(B, Lk, D) -> cached ((B,H,Lk,Dk), (B,H,Lk,Dk))."""
        return self._split(self.w_k(kv_in)), self._split(self.w_v(kv_in))

    def fused_qkv(self, x: torch.Tensor):
        """q/k/v projections of one input as one (D, 3D) product; int8
        kernels concatenate their scales as they concatenate."""
        mods = (self.w_q, self.w_k, self.w_v)
        kernel = torch.cat([m.kernel for m in mods], dim=1).to(self.dtype)
        bias = torch.cat([m.bias for m in mods])
        qkv = torch.matmul(x.to(self.dtype), kernel)
        if mods[0].is_int8:
            qkv = qkv * torch.cat([m.kernel_scale for m in mods]).to(
                self.dtype)
        qkv = qkv + bias
        q, k, v = torch.split(qkv, self.d_model, dim=-1)
        return self._split(q), self._split(k), self._split(v)

    def attend_pre_q(self, q, k, v, mask) -> torch.Tensor:
        """Attention with q already projected and head-split (decode)."""
        return self._attend(q, k, v, mask, 0.0)

    def attend_with_kv(self, q_in, k, v, mask) -> torch.Tensor:
        rate = self.attn_dropout if self.training else 0.0
        return self._attend(self._split(self.w_q(q_in)), k, v, mask, rate)

    def forward(self, q_in, k_in, v_in, mask=None) -> torch.Tensor:
        if mask is not None:
            mask = mask[:, None]  # head axis
        k, v = self._split(self.w_k(k_in)), self._split(self.w_v(v_in))
        return self.attend_with_kv(q_in, k, v, mask)


class FeedForward(nn.Module):
    """Linear -> ReLU -> dropout -> Linear; with ``use_kernel``, no
    active dropout and float weights, the fused FFN (kernel inside its
    gate). int8 weights take the two int8 linears, as in JAX."""

    def __init__(self, d_model: int, d_ff: int, dropout: float,
                 dtype: torch.dtype, use_kernel: bool = False):
        super().__init__()
        self.dropout = dropout
        self.use_kernel = use_kernel
        self.w_1 = ParamLinear(d_model, d_ff, dtype)
        self.w_2 = ParamLinear(d_ff, d_model, dtype)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_kernel and (not self.training or self.dropout == 0.0) \
                and not self.w_1.is_int8:
            dt = self.w_1.dtype
            return fused_ffn(x.to(dt), self.w_1.kernel, self.w_1.bias,
                             self.w_2.kernel, self.w_2.bias)
        h = torch.relu(self.w_1(x))
        return self.w_2(self.drop(h))


class Sublayer(nn.Module):
    """Pre-norm residual connection: ``x + dropout(f(norm(x)))``."""

    def __init__(self, d_model: int, dropout: float,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = RefLayerNorm(d_model, param_dtype=param_dtype)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor,
                f: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        return x + self.drop(f(self.norm(x)))

    def normed(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class Generator(nn.Module):
    """Linear + f32 log_softmax over the vocabulary."""

    def __init__(self, d_model: int, vocab_size: int, dtype: torch.dtype):
        super().__init__()
        self.proj = ParamLinear(d_model, vocab_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self.proj(x).float(), dim=-1)


def named_list(parent: nn.Module, prefix: str,
               mods: List[nn.Module]) -> List[nn.Module]:
    """Register ``mods`` on ``parent`` as ``<prefix>_<i>`` (the flax list
    naming) and return them as a plain list for iteration."""
    for i, m in enumerate(mods):
        parent.add_module(f"{prefix}_{i}", m)
    return mods

