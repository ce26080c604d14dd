"""Kimi-VL-A3B's language model as a video-grounded answer decoder
(``ModelConfig.architecture == "kimi_vl"``; the published keys in
:class:`~mtn_tpu_torch.config.LMConfig`).

The decoder is DeepSeek-V3's, as Kimi-VL-A3B-Instruct publishes it:
``num_hidden_layers`` pre-norm layers (RMSNorm, statistics in f32), each
multi-head latent attention (MLA) and an MLP, the first
``first_k_dense_replace`` dense (SwiGLU), the rest mixtures of
``n_routed_experts`` routed experts (``num_experts_per_tok`` a token by
sigmoid scores plus a selection bias, normalised, times
``routed_scaling_factor``; :mod:`mtn_tpu_torch.ops.moe`) beside
``n_shared_experts`` shared ones; then RMSNorm, an untied head and an f32
log-softmax.

MLA (no ``q_lora``): ``q_proj`` gives each head a ``qk_nope_head_dim``
part and a ``qk_rope_head_dim`` part; ``kv_a_proj_with_mqa`` gives the
``kv_lora_rank`` latent ``c`` (then ``kv_a_layernorm``) and one rotary
key ``k_pe`` shared by the heads; ``kv_b_proj`` decompresses ``c`` into
each head's key part ``W_UK·c`` and value ``W_UV·c``; the scale is
``(qk_nope_head_dim + qk_rope_head_dim) ** -0.5``. RoPE (``rope_theta``,
no scaling) rotates the pairs ``(2i, 2i+1)`` and writes them in the
half layout, as DeepSeek-V3's ``apply_rotary_pos_emb`` does.

The prompt of a turn, in this order: each feature stream's frames through
its projector (``Linear(ft, projector_hidden_size) -> GELU ->
Linear(., hidden_size)``; one token a frame: DSTC7-AVSD ships the towers'
outputs, so no vision tower runs), then the caption tokens, the history
tokens and the question tokens. The answer starts from ``<sos>``.

Padding. A batch keeps the data path's uniform shapes; a slot is real
when it is a frame below its stream's length or a token other than
``<blank>``. Pad slots are masked as keys (each still attends itself, so
a row of no turn stays finite) and go to no expert, and the RoPE position
of a real slot is the count of real slots before it, so the program over
padded slots computes what one over exact lengths does.

Two paths. :meth:`KimiVLLM.init_decode_state` is the prefill: the
decompressed form over the prompt (causal, by slot), keeping each layer's
``(c, k_pe)`` for the cache (the last layer's are all its attention
needs, so its attention and MLP over the prompt are skipped).
:meth:`KimiVLLM.decode_step` advances one token in the absorbed form:
``W_UK`` folded into the query (``q·W_UK`` against the latents) and
``W_UV`` applied after the latent-weighted sum, over the prompt's latents
and the generated ones (``self_kv``, written in place at the position)
under one softmax. Products are in the config's dtype; the residual
stream, the router's input and scores, RMSNorm statistics, the step's attention scores
and sums and the log-softmax in f32 (the stream of 27 layers, rounded to
bf16 at each of its 54 additions, would drift from the f32 reference by
more than the products do).

Counters: each MoE layer adds the rows its experts took to
``expert_rows`` (layers, E) on the device, in place, so captured
programs count each replay; ``cli.generate`` reads it once a pass. The
prefill is the span ``lm.prefill`` (host, and a driven device span).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from mtn_tpu_torch.config import LMConfig, ModelConfig
from mtn_tpu_torch.models.layers import named_list, torch_dtype
from mtn_tpu_torch.ops.matmul import matmul_f32
from mtn_tpu_torch.ops.moe import route, routed_experts
from mtn_tpu_torch.utils.profiling import driven_span, span

Tensor = torch.Tensor
Position = Union[int, Tensor]

# the residual stream's dtype (the published model keeps it in bf16; f32
# here, see the module's docstring)
RESIDUAL_DTYPE = torch.float32


@dataclass
class LMState:
    """A turn batch's prompt: each layer's ``(c (B, S, r), k_pe (B, S,
    d_rope))``, which slots are real (B, S), each row's real slots (B,)
    (the answer's first RoPE position) and whether a row holds a turn."""

    latents: Tuple[Tuple[Tensor, Tensor], ...]
    real: Tensor
    base: Tensor
    live: Tensor

    def map(self, fn: Callable[[Tensor], Tensor]) -> "LMState":
        return LMState(tuple((fn(c), fn(k)) for c, k in self.latents),
                       fn(self.real), fn(self.base), fn(self.live))


def prompt_positions(real: Tensor) -> Tuple[Tensor, Tensor]:
    """(each slot's RoPE position (B, S): the real slots before it; each
    row's count of real slots (B,))."""
    before = torch.cumsum(real.to(torch.int64), 1)
    return (before - 1).clamp_min(0), before[:, -1]


def rope(x: Tensor, pos: Tensor, inv_freq: Tensor) -> Tensor:
    """``x`` (..., d) rotated at positions ``pos`` (broadcast against
    x's leading axes): pairs ``(2i, 2i+1)`` by ``pos·inv_freq[i]``, out in
    the half layout (the rotated first members, then the second), in f32,
    rounded once to x's dtype."""
    ang = pos.to(torch.float32)[..., None] * inv_freq
    cos, sin = ang.cos(), ang.sin()
    xf = x.float()
    a, b = xf[..., 0::2], xf[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def f32(self, x: Tensor) -> Tensor:
        """``x`` (any dtype) normalised and weighted, in f32."""
        xf = x.float()
        return self.weight.float() * xf * torch.rsqrt(
            xf.pow(2).mean(-1, keepdim=True) + self.eps)

    def forward(self, x: Tensor) -> Tensor:
        """:meth:`f32` rounded once to the weight's dtype."""
        return self.f32(x).to(self.weight.dtype)


def linear(d_in: int, d_out: int, dtype: torch.dtype,
           bias: bool = False) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=bias, dtype=dtype)


class MLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, d: int, f: int, dtype: torch.dtype):
        super().__init__()
        self.gate_proj = linear(d, f, dtype)
        self.up_proj = linear(d, f, dtype)
        self.down_proj = linear(f, d, dtype)

    def forward(self, x: Tensor, real=None, rows=None) -> Tensor:
        x = x.to(self.gate_proj.weight.dtype)
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Gate(nn.Module):
    def __init__(self, d: int, n: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, d, dtype=dtype))
        self.e_score_correction_bias = nn.Parameter(
            torch.zeros(n, dtype=torch.float32))


class Experts(nn.Module):
    """The routed experts' weights, stacked: ``gate_up_proj`` (E, 2F, D),
    each expert's gate rows then its up rows; ``down_proj`` (E, D, F)."""

    def __init__(self, n: int, d: int, f: int, dtype: torch.dtype):
        super().__init__()
        self.gate_up_proj = nn.Parameter(torch.empty(n, 2 * f, d,
                                                     dtype=dtype))
        self.down_proj = nn.Parameter(torch.empty(n, d, f, dtype=dtype))


class MoE(nn.Module):
    def __init__(self, lm: LMConfig, dtype: torch.dtype):
        super().__init__()
        d, f = lm.hidden_size, lm.moe_intermediate_size
        self.top_k = lm.num_experts_per_tok
        self.scaling = lm.routed_scaling_factor
        self.norm_topk = lm.norm_topk_prob
        self.gate = Gate(d, lm.n_routed_experts, dtype)
        self.experts = Experts(lm.n_routed_experts, d, f, dtype)
        self.shared_experts = MLP(d, f * lm.n_shared_experts, dtype)

    def forward(self, x: Tensor, real: Optional[Tensor] = None,
                rows: Optional[Tensor] = None) -> Tensor:
        """``x`` (T, D) in f32, routed as it is and rounded to the
        experts' dtype for their products; ``real`` (T,) the tokens
        routed (None: all); ``rows`` (E,) the counts this layer adds to."""
        w, idx = route(x, self.gate.weight,
                       self.gate.e_score_correction_bias, self.top_k,
                       self.scaling, self.norm_topk)
        x = x.to(self.gate.weight.dtype)
        out = routed_experts(x, w, idx, real, self.experts.gate_up_proj,
                             self.experts.down_proj, rows)
        return out + self.shared_experts(x)


class MLA(nn.Module):
    def __init__(self, lm: LMConfig, dtype: torch.dtype):
        super().__init__()
        d, h = lm.hidden_size, lm.num_attention_heads
        self.h, self.r = h, lm.kv_lora_rank
        self.dn, self.dr, self.dv = (lm.qk_nope_head_dim,
                                     lm.qk_rope_head_dim, lm.v_head_dim)
        self.scale = (self.dn + self.dr) ** -0.5
        self.q_proj = linear(d, h * (self.dn + self.dr), dtype)
        self.kv_a_proj_with_mqa = linear(d, self.r + self.dr, dtype)
        self.kv_a_layernorm = RMSNorm(self.r, lm.rms_norm_eps, dtype)
        self.kv_b_proj = linear(self.r, h * (self.dn + self.dv), dtype)
        self.o_proj = linear(h * self.dv, d, dtype)

    def latents(self, y: Tensor, pos: Tensor, inv_freq: Tensor):
        """(c, k_pe) of normed inputs ``y`` (..., D) at ``pos`` (...)."""
        c, k_pe = self.kv_a_proj_with_mqa(y).split([self.r, self.dr], -1)
        return self.kv_a_layernorm(c), rope(k_pe, pos, inv_freq)

    def queries(self, y: Tensor, pos: Tensor, inv_freq: Tensor):
        """(q_nope (..., H, dn), q_pe (..., H, dr)) at ``pos`` (...)."""
        q = self.q_proj(y).unflatten(-1, (self.h, self.dn + self.dr))
        q_nope, q_pe = q.split([self.dn, self.dr], -1)
        return q_nope, rope(q_pe, pos[..., None], inv_freq)

    def prefill(self, y, pos, attend, c, k_pe, inv_freq) -> Tensor:
        """The decompressed form over (B, S) slots: keys and values from
        ``kv_b_proj(c)``, ``attend`` (B, S, S) True = attend."""
        B, S, _ = y.shape
        q_nope, q_pe = self.queries(y, pos, inv_freq)
        kv = self.kv_b_proj(c).unflatten(-1, (self.h, self.dn + self.dv))
        k_nope, v = kv.split([self.dn, self.dv], -1)
        q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(
            B, S, self.h, self.dr)], -1).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k, v.transpose(1, 2),
                                           attn_mask=attend[:, None],
                                           scale=self.scale)
        return self.o_proj(o.transpose(1, 2).flatten(2))

    def step(self, y, pos, l, prompt, real, cache, inv_freq) -> Tensor:
        """The absorbed form for one token a row: ``y`` (R, D) at RoPE
        positions ``pos`` (R,), answer position ``l`` (0-d); its (c, k_pe)
        written into ``cache`` at ``l``; attention over the ``prompt``'s
        latents (keys ``real``) and the cache's up to ``l``."""
        (pc, pk), (sc, sk) = prompt, cache
        c, k_pe = self.latents(y, pos, inv_freq)
        at = l.reshape(1)
        sc.index_copy_(1, at, c[:, None])
        sk.index_copy_(1, at, k_pe[:, None])
        q_nope, q_pe = self.queries(y, pos, inv_freq)
        w = self.kv_b_proj.weight.view(self.h, self.dn + self.dv, self.r)
        w_uk, w_uv = w[:, :self.dn], w[:, self.dn:]
        q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk).transpose(0, 1)
        s = torch.cat([
            matmul_f32(q_lat, pc.transpose(1, 2))
            + matmul_f32(q_pe, pk.transpose(1, 2)),
            matmul_f32(q_lat, sc.transpose(1, 2))
            + matmul_f32(q_pe, sk.transpose(1, 2))], -1) * self.scale
        S, M = pc.shape[1], sc.shape[1]
        keys = torch.cat([real, (torch.arange(M, device=l.device) <= l)
                          .expand(real.shape[0], M)], 1)
        p = torch.softmax(s.masked_fill(~keys[:, None], float("-inf")), -1)
        p = p.to(y.dtype)
        o_lat = (matmul_f32(p[..., :S], pc)
                 + matmul_f32(p[..., S:], sc)).to(y.dtype)
        o = torch.bmm(o_lat.transpose(0, 1), w_uv.transpose(1, 2))
        return self.o_proj(o.transpose(0, 1).flatten(1))


class Layer(nn.Module):
    def __init__(self, lm: LMConfig, dense: bool, dtype: torch.dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(lm.hidden_size, lm.rms_norm_eps,
                                       dtype)
        self.self_attn = MLA(lm, dtype)
        self.post_attention_layernorm = RMSNorm(lm.hidden_size,
                                                lm.rms_norm_eps, dtype)
        self.mlp = (MLP(lm.hidden_size, lm.intermediate_size, dtype)
                    if dense else MoE(lm, dtype))


class Projector(nn.Module):
    """One feature stream's frames to prompt tokens."""

    def __init__(self, ft: int, p: int, d: int, dtype: torch.dtype):
        super().__init__()
        self.linear_1 = linear(ft, p, dtype, bias=True)
        self.linear_2 = linear(p, d, dtype, bias=True)

    def forward(self, x: Tensor) -> Tensor:
        return self.linear_2(F.gelu(self.linear_1(x)))


class KimiVLLM(nn.Module):
    """The decoder with the duck-typed decode API that
    :class:`~mtn_tpu_torch.decode.beam.BeamDecoder` calls."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        lm = self.lm = LMConfig.of(cfg)
        if cfg.vocab_size != lm.vocab_size:
            raise ValueError(f"vocab_size {cfg.vocab_size} is not the "
                             f"language model's {lm.vocab_size}")
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        d = lm.hidden_size
        self.projectors = named_list(self, "projector", [
            Projector(ft, lm.projector_hidden_size, d, dt)
            for ft in cfg.ft_sizes])
        self.embed_tokens = nn.Embedding(lm.vocab_size, d, dtype=dt)
        self.layers = nn.ModuleList([
            Layer(lm, i < lm.first_k_dense_replace, dt)
            for i in range(lm.num_hidden_layers)])
        self.norm = RMSNorm(d, lm.rms_norm_eps, dt)
        self.lm_head = linear(d, lm.vocab_size, dt)
        self.make_buffers()

    def make_buffers(self, device=None) -> None:
        """The RoPE frequencies and the routing counters (not saved):
        made again on ``device`` after weights are put in place of a
        model built on the meta device."""
        lm = self.lm
        dr = lm.qk_rope_head_dim
        self.register_buffer("inv_freq", 1.0 / (lm.rope_theta ** (
            torch.arange(0, dr, 2, device=device, dtype=torch.float32)
            / dr)), persistent=False)
        moe = lm.num_hidden_layers - lm.first_k_dense_replace
        self.register_buffer("expert_rows", torch.zeros(
            moe, lm.n_routed_experts, dtype=torch.int64, device=device),
            persistent=False)

    def _rows(self, i: int) -> Optional[Tensor]:
        k = i - self.lm.first_k_dense_replace
        return self.expert_rows[k] if k >= 0 else None

    def _mlp(self, i: int, x: Tensor, real: Tensor) -> Tensor:
        """Layer ``i``'s MLP over the (..., D) stream ``x`` with (...)
        ``real``: its norm in f32, which the router reads."""
        y = self.layers[i].post_attention_layernorm.f32(x)
        flat = y.reshape(-1, y.shape[-1])
        return self.layers[i].mlp(flat, real.reshape(-1),
                                  self._rows(i)).view(y.shape)

    # -- decode-time API ----------------------------------------------------
    def init_decode_state(self, query, his, cap, fts: Sequence[Tensor],
                          masks) -> LMState:
        """The prefill over a turn batch (masks: ``train.batch.
        batch_masks``' source masks)."""
        dt = self.embed_tokens.weight.dtype
        with span("lm.prefill"), driven_span("lm.prefill", query.device):
            x = torch.cat([p(ft.to(dt)) for p, ft in zip(self.projectors,
                                                         fts)]
                          + [self.embed_tokens(t) for t in (cap, his, query)],
                          1).to(RESIDUAL_DTYPE)
            real = torch.cat([m[:, 0] for m in masks.vid]
                             + [masks.cap[:, 0], masks.his[:, 0],
                                masks.query[:, 0]], 1)
            pos, base = prompt_positions(real)
            S = real.shape[1]
            own = torch.eye(S, dtype=torch.bool, device=real.device)
            causal = torch.ones_like(own).tril()
            attend = (real[:, None, :] & causal) | own
            latents = []
            last = len(self.layers) - 1
            for i, layer in enumerate(self.layers):
                y = layer.input_layernorm(x)
                c, k_pe = layer.self_attn.latents(y, pos, self.inv_freq)
                latents.append((c, k_pe))
                if i == last:
                    break
                x = x + layer.self_attn.prefill(y, pos, attend, c, k_pe,
                                                self.inv_freq)
                x = x + self._mlp(i, x, real)
        return LMState(tuple(latents), real, base, base > 0)

    def decode_step(self, state: LMState, tokens: Tensor, pos: Position,
                    self_kv):
        """tokens (R,) at answer position ``pos`` (an ``int`` or a 0-d
        int64 tensor). Returns ((R, V) f32 log-probs, self_kv written in
        place)."""
        x = self.embed_tokens(tokens).to(RESIDUAL_DTYPE)
        l = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
        at = state.base + l
        for i, (layer, prompt, cache) in enumerate(zip(
                self.layers, state.latents, self_kv)):
            y = layer.input_layernorm(x)
            x = x + layer.self_attn.step(y, at, l, prompt, state.real, cache,
                                         self.inv_freq)
            x = x + self._mlp(i, x, state.live)
        logits = matmul_f32(self.norm(x), self.lm_head.weight.t())
        return torch.log_softmax(logits, -1), self_kv

    def init_self_kv(self, batch_size: int, maxlen: int, device=None):
        """Zeroed per-layer latent caches ``(c (R, maxlen, r), k_pe (R,
        maxlen, d_rope))`` of the generated tokens."""
        lm = self.lm
        dt = self.embed_tokens.weight.dtype
        device = device if device is not None else \
            self.embed_tokens.weight.device
        return tuple((torch.zeros(batch_size, maxlen, lm.kv_lora_rank,
                                  dtype=dt, device=device),
                      torch.zeros(batch_size, maxlen, lm.qk_rope_head_dim,
                                  dtype=dt, device=device))
                     for _ in range(lm.num_hidden_layers))


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None
                ) -> dict:
    """Fresh f32 parameters by DeepSeek-V3's law: normal(0, 0.02)
    matrices and embeddings, unit norm weights, zero biases and
    selection biases."""
    from mtn_tpu_torch.weights import param_shapes
    sd = {}
    for key, shape in param_shapes(cfg).items():
        if key.endswith("norm.weight"):
            t = torch.ones(shape)
        elif key.endswith(("bias", "e_score_correction_bias")):
            t = torch.zeros(shape)
        else:
            t = torch.randn(shape, generator=generator) * 0.02
        sd[key] = t
    return sd
