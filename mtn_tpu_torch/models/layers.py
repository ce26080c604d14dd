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

Tensor parallelism (:mod:`mtn_tpu_torch.parallel`): ``Shardings.
shard_model`` cuts a layer's parameters to this rank's slab and sets its
mode. A column-parallel :class:`ParamLinear` holds a slice of the output
axis, a row-parallel one a slice of the input axis: its f32 partial
products are summed over ``model`` and then cast, as the single-device
product rounds its f32 sum once, and its bias is added once after the
sum. An attention then runs ``att_h / model`` heads, the FFN kernel a
``d_ff / model`` slice, a vocab-parallel :class:`Embed` looks up the ids
in its rows, and :class:`Generator` gathers the logits before the
log-softmax, so every rank sees the whole vocabulary.

Dropout draws through ``collectives.sharded_dropout``: a layer's
``data_axis`` (set by ``Shardings.shard_model`` under a data axis) says
that its activations hold this rank's rows of the batch, and the FFN's
hidden units and the attention probabilities are sharded over ``model``,
so every rank keeps its part of the whole activation's mask.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch
from torch import nn

from mtn_tpu_torch.ops.attention import multi_head_attention
from mtn_tpu_torch.ops.ffn_kernel import fused_ffn
from mtn_tpu_torch.ops.matmul import matmul_f32
from mtn_tpu_torch.ops.norm_kernel import add_norm, layer_norm
from mtn_tpu_torch.parallel.collectives import (Axis, copy_to_model,
                                                gather_last,
                                                reduce_from_model,
                                                sharded_dropout)
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
        return layer_norm(x, self.scale, self.bias, self.eps)


def row_product(x: torch.Tensor, kernel: torch.Tensor, axis: Axis,
                dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel ``x @ kernel``: f32 partial products summed over
    ``axis``, then cast to ``dtype``. ``kernel`` is (K, E), or (S, K, E)
    stacked against an ``x`` of (S, ..., K)."""
    K, E = x.shape[-1], kernel.shape[-1]
    lead = (kernel.shape[0], -1) if kernel.dim() == 3 else (-1,)
    y = matmul_f32(x.reshape(*lead, K), kernel)
    return reduce_from_model(y.reshape(*x.shape[:-1], E), axis).to(dtype)


class Embed(nn.Module):
    """The flax ``nn.Embed`` parameter (``embedding``), gathered in the
    compute dtype; vocab-parallel after :meth:`set_parallel`."""

    def __init__(self, vocab_size: int, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.zeros(vocab_size, d_model, dtype=dtype))
        self.axis: Optional[Axis] = None

    def set_parallel(self, axis: Axis) -> None:
        """This rank holds rows ``[rank·V/n, (rank+1)·V/n)``."""
        self.axis = axis

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.axis is None:
            return nn.functional.embedding(tokens, self.embedding)
        rows = self.embedding.shape[0]
        local = tokens - self.axis.rank * rows
        outside = (local < 0) | (local >= rows)
        emb = nn.functional.embedding(local.clamp(0, rows - 1),
                                      self.embedding)
        # one rank holds each id: the sum adds exact zeros to it
        return reduce_from_model(emb.masked_fill(outside[..., None], 0),
                                 self.axis)


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
        self.dropout = dropout
        self.data_axis: Optional[Axis] = None

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        L = x.shape[-2]
        return sharded_dropout(x + self.pe[offset:offset + L], self.dropout,
                               self.training, data=self.data_axis)

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
        self.mode: Optional[str] = None     # None, "column" or "row"
        self.axis: Optional[Axis] = None

    def set_parallel(self, mode: str, axis: Axis) -> None:
        """Column-parallel (the kernel's output axis is this rank's
        slice) or row-parallel (its input axis) over ``axis``."""
        self.mode, self.axis = mode, axis

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

    def prepare(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in the compute dtype; a column-parallel layer's input
        sums its gradient over the ranks."""
        x = x.to(self.dtype)
        return copy_to_model(x, self.axis) if self.mode == "column" else x

    def product(self, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        """``x @ kernel``, summed over the ranks when row-parallel."""
        if self.mode == "row":
            return row_product(x, kernel, self.axis, self.dtype)
        return torch.matmul(x, kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, bias = self.unbiased(x)
        return y + bias

    def unbiased(self, x: torch.Tensor):
        """``(product, bias)`` with ``forward(x) == product + bias``: the
        bias is added last in every mode (after the row-parallel sum and
        the int8 scale), so a caller may add it (:func:`add_norm`)."""
        x = self.prepare(x)
        if self.is_int8:
            y = self.product(x, self.kernel.to(self.dtype))
            return y * self.kernel_scale.to(self.dtype), self.bias
        return self.product(x, self.kernel), self.bias


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
        self.d_k = d_model // n_heads
        self.dtype = dtype
        self.attn_dropout = attn_dropout
        self.use_kernel = use_kernel
        self.data_axis: Optional[Axis] = None
        self.w_q = ParamLinear(d_model, d_model, dtype)
        self.w_k = ParamLinear(d_model, d_model, dtype)
        self.w_v = ParamLinear(d_model, d_model, dtype)
        self.w_o = ParamLinear(d_model, d_model, dtype)

    @property
    def local_heads(self) -> int:
        """Heads this rank runs (``att_h / model`` when sharded)."""
        return self.w_q.kernel.shape[1] // self.d_k

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        return x.reshape(B, L, -1, self.d_k).transpose(1, 2)

    def _merge(self, x: torch.Tensor) -> torch.Tensor:
        B, H, L, d_k = x.shape
        return x.transpose(1, 2).reshape(B, L, H * d_k)

    def _heads(self, q, k, v, mask, rate: float) -> torch.Tensor:
        """The heads' attention, merged: w_o's input."""
        return self._merge(multi_head_attention(
            q, k, v, mask, dropout_rate=rate, use_kernel=self.use_kernel,
            heads=self.w_q.axis, data=self.data_axis))

    def project_kv(self, kv_in: torch.Tensor):
        """(B, Lk, D) -> cached ((B,H,Lk,Dk), (B,H,Lk,Dk))."""
        return self._split(self.w_k(kv_in)), self._split(self.w_v(kv_in))

    def fused_qkv(self, x: torch.Tensor):
        """q/k/v projections of one input as one (D, 3D) product; int8
        kernels concatenate their scales as they concatenate."""
        mods = (self.w_q, self.w_k, self.w_v)
        kernel = torch.cat([m.kernel for m in mods], dim=1).to(self.dtype)
        bias = torch.cat([m.bias for m in mods])
        qkv = torch.matmul(self.w_q.prepare(x), kernel)
        if mods[0].is_int8:
            qkv = qkv * torch.cat([m.kernel_scale for m in mods]).to(
                self.dtype)
        qkv = qkv + bias
        q, k, v = torch.split(qkv, self.w_q.kernel.shape[1], dim=-1)
        return self._split(q), self._split(k), self._split(v)

    def attend_step(self, q_in, k, v, mask, q=None):
        """A decode step's attention of ``q_in`` over cached k/v, or of
        ``q`` already projected and head-split (``fused_qkv``; no
        dropout): w_o's ``(product, bias)`` (:meth:`ParamLinear.
        unbiased`)."""
        rate = 0.0
        if q is None:
            rate = self.attn_dropout if self.training else 0.0
            q = self._split(self.w_q(q_in))
        return self.w_o.unbiased(self._heads(q, k, v, mask, rate))

    def attend_with_kv(self, q_in, k, v, mask) -> torch.Tensor:
        rate = self.attn_dropout if self.training else 0.0
        return self.w_o(self._heads(self._split(self.w_q(q_in)), k, v, mask,
                                    rate))

    def forward(self, q_in, k_in, v_in, mask=None) -> torch.Tensor:
        if mask is not None:
            mask = mask[:, None]  # head axis
        k, v = self._split(self.w_k(k_in)), self._split(self.w_v(v_in))
        return self.attend_with_kv(q_in, k, v, mask)


class FeedForward(nn.Module):
    """Linear -> ReLU -> dropout -> Linear; with ``use_kernel``, no
    active dropout and float weights, the fused FFN (kernel inside its
    gate, which takes the whole batch's rows, :meth:`gate_rows`). int8
    weights take the two int8 linears, as in JAX. Under tensor
    parallelism the kernel runs on this rank's d_ff slice with an f32
    output and b2 = 0; the ranks' sums are added and b2 after them."""

    def __init__(self, d_model: int, d_ff: int, dropout: float,
                 dtype: torch.dtype, use_kernel: bool = False):
        super().__init__()
        self.dropout = dropout
        self.use_kernel = use_kernel
        self.data_axis: Optional[Axis] = None
        self.w_1 = ParamLinear(d_model, d_ff, dtype)
        self.w_2 = ParamLinear(d_ff, d_model, dtype)

    def gate_rows(self, x: torch.Tensor) -> Optional[int]:
        """The rows the kernel's gate takes under a data axis: the whole
        batch's, as JAX's gate sees the global shape (a rank's own rows
        can pass the row term where the batch's do not)."""
        if self.data_axis is None:
            return None
        return x.numel() // x.shape[-1] * self.data_axis.size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_kernel and (not self.training or self.dropout == 0.0) \
                and not self.w_1.is_int8:
            dt = self.w_1.dtype
            if self.w_2.mode == "row":
                y = fused_ffn(self.w_1.prepare(x), self.w_1.kernel,
                              self.w_1.bias, self.w_2.kernel,
                              torch.zeros_like(self.w_2.bias), True,
                              self.gate_rows(x))
                y = reduce_from_model(y, self.w_2.axis)
                return (y + self.w_2.bias.float()).to(dt)
            return fused_ffn(x.to(dt), self.w_1.kernel, self.w_1.bias,
                             self.w_2.kernel, self.w_2.bias, False,
                             self.gate_rows(x))
        h = torch.relu(self.w_1(x))
        return self.w_2(sharded_dropout(h, self.dropout, self.training,
                                        self.w_1.axis, data=self.data_axis))


class Sublayer(nn.Module):
    """Pre-norm residual connection: ``x + dropout(f(norm(x)))``."""

    def __init__(self, d_model: int, dropout: float,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = RefLayerNorm(d_model, param_dtype=param_dtype)
        self.dropout = dropout
        self.data_axis: Optional[Axis] = None

    def forward(self, x: torch.Tensor,
                f: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        return x + sharded_dropout(f(self.norm(x)), self.dropout,
                                   self.training, data=self.data_axis)

    def add_norm(self, x: torch.Tensor, delta: torch.Tensor,
                 bias: Optional[torch.Tensor], norm: RefLayerNorm):
        """:meth:`forward`'s residual for a sublayer output ``delta +
        bias`` (``bias`` may be None), then ``norm`` of the sum, the
        next sublayer's input: ``(x_new, norm(x_new))`` in one
        :func:`add_norm` call."""
        if self.training and self.dropout:
            if bias is not None:
                delta, bias = delta + bias, None
            delta = sharded_dropout(delta, self.dropout, True,
                                    data=self.data_axis)
        return add_norm(x, delta, bias, norm.scale, norm.bias, norm.eps)


class Generator(nn.Module):
    """Linear + f32 log_softmax over the vocabulary."""

    def __init__(self, d_model: int, vocab_size: int, dtype: torch.dtype):
        super().__init__()
        self.proj = ParamLinear(d_model, vocab_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.proj(x)
        if self.proj.mode == "column":
            logits = gather_last(logits, self.proj.axis)
        return torch.log_softmax(logits.float(), dim=-1)


def named_list(parent: nn.Module, prefix: str,
               mods: List[nn.Module]) -> List[nn.Module]:
    """Register ``mods`` on ``parent`` as ``<prefix>_<i>`` (the flax list
    naming) and return them as a plain list for iteration."""
    for i, m in enumerate(mods):
        parent.add_module(f"{prefix}_{i}", m)
    return mods

