"""Plain PyTorch Kimi-VL-A3B language model as a video-grounded answer
decoder, for the benchmark's comparison (Moonshot AI, Kimi-VL Technical
Report, arXiv:2504.07491; config
https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct/blob/main/config.json,
``text_config``: a DeepSeek-V3 decoder, DeepSeek-AI arXiv:2412.19437).

One dialogue turn at a time over its exact lengths, in float32 with TF32
off, no kernels, no cache and no batching across turns: each hypothesis
is teacher forced as one sequence, the whole prompt and then ``<sos>``
and its tokens, and its tokens and the ``<eos>`` after them are scored
from the log-softmax at the positions that predict them. The model:

- the prompt: each feature stream's frames through its projector
  (``linear_2(GELU(linear_1(x)))``, biases, exact GELU), one token a
  frame; then the caption, history and question tokens (``<blank>``
  tokens left out), through ``embed_tokens``; RoPE positions count from
  0 over the whole sequence;
- each layer: ``x + attn(rmsnorm(x))``, then ``x + mlp(rmsnorm(x))``;
  RMSNorm ``w · x / sqrt(mean(x²) + eps)``;
- attention, multi-head latent attention in its decompressed form:
  ``q = q_proj(y)`` split per head into ``qk_nope_head_dim`` and
  ``qk_rope_head_dim``; ``[c, k_pe] = kv_a_proj_with_mqa(y)``, ``c =
  rmsnorm(c)``, ``[k_nope, v] = kv_b_proj(c)`` per head; RoPE on ``q_pe``
  and on ``k_pe`` (one for all heads); causal softmax of ``q·k`` times
  ``(qk_nope_head_dim + qk_rope_head_dim) ** -0.5``; ``o_proj``;
- the first ``first_k_dense_replace`` MLPs dense (SwiGLU,
  ``intermediate_size``), the others a mixture of experts: sigmoid
  scores of ``y·gate``, the ``num_experts_per_tok`` experts of highest
  score plus ``e_score_correction_bias`` (selection only; lower id first
  on a tie), their scores normalised to sum 1 and times
  ``routed_scaling_factor``, each expert a SwiGLU of width
  ``moe_intermediate_size`` run as a loop over the experts, plus the
  ``n_shared_experts`` shared experts as one SwiGLU of their summed
  width;
- a final RMSNorm, the untied ``lm_head`` and the log-softmax.

Departures from the published description, each an assumption of the
configuration file: no vision tower (DSTC7-AVSD ships the towers'
outputs, I3D and VGGish, and each frame is one prompt token); the
projector is ``Linear(ft, p) -> GELU -> Linear(p, hidden)`` without the
published pre-norm and patch merge, whose input is MoonViT's; RoPE
rotates the pairs ``(2i, 2i+1)`` and writes the half layout
(DeepSeek-V3's ``apply_rotary_pos_emb``), in float32; the DSTC7 words
take the vocabulary's ids, ``<unk> <blank> <sos> <eos>`` the first four.

``precision="fp8"`` is the check's control: both operands of every
product (the linears, the router, the experts, the attention scores and
weighted sums, the head) rounded to float8 e4m3 under one scale a tensor
(:func:`fp8`), the rest in float32.

Weights are the program's, by the port's ``state_dict`` names
(:func:`param_spec`), in any dtype on any device: each layer's are
widened to float32 when the layer runs, and :meth:`KimiVLLMReference.
scores_many` runs every given turn through one layer before the next, so
that a whole model's float32 weights never exist at once. This module
imports nothing but torch and the standard library.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

UNK, BLANK, SOS, EOS = 0, 1, 2, 3
# tokens a gated MLP takes at once (the dense layer's f32 activations of
# 16,384 tokens: 0.74 GB a tensor)
ROWS = 16384


def param_spec(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the model ``cfg`` describes (the published keys
    at its top level, ``ft_sizes`` and ``projector_hidden_size``) and its
    shape, by the port's names."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    E, Fe = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    P = cfg["projector_hidden_size"]
    spec: Dict[str, Tuple[int, ...]] = {}
    for i, ft in enumerate(cfg["ft_sizes"]):
        spec[f"projector_{i}.linear_1.weight"] = (P, ft)
        spec[f"projector_{i}.linear_1.bias"] = (P,)
        spec[f"projector_{i}.linear_2.weight"] = (D, P)
        spec[f"projector_{i}.linear_2.bias"] = (D,)
    spec["embed_tokens.weight"] = (V, D)

    def mlp(p, f):
        spec[f"{p}.gate_proj.weight"] = (f, D)
        spec[f"{p}.up_proj.weight"] = (f, D)
        spec[f"{p}.down_proj.weight"] = (D, f)
    for n in range(cfg["num_hidden_layers"]):
        p = f"layers.{n}"
        spec[f"{p}.input_layernorm.weight"] = (D,)
        spec[f"{p}.self_attn.q_proj.weight"] = (H * (dn + dr), D)
        spec[f"{p}.self_attn.kv_a_proj_with_mqa.weight"] = (r + dr, D)
        spec[f"{p}.self_attn.kv_a_layernorm.weight"] = (r,)
        spec[f"{p}.self_attn.kv_b_proj.weight"] = (H * (dn + dv), r)
        spec[f"{p}.self_attn.o_proj.weight"] = (D, H * dv)
        spec[f"{p}.post_attention_layernorm.weight"] = (D,)
        if n < cfg["first_k_dense_replace"]:
            mlp(f"{p}.mlp", cfg["intermediate_size"])
        else:
            spec[f"{p}.mlp.gate.weight"] = (E, D)
            spec[f"{p}.mlp.gate.e_score_correction_bias"] = (E,)
            spec[f"{p}.mlp.experts.gate_up_proj"] = (E, 2 * Fe, D)
            spec[f"{p}.mlp.experts.down_proj"] = (E, D, Fe)
            mlp(f"{p}.mlp.shared_experts", Fe * cfg["n_shared_experts"])
    spec["norm.weight"] = (D,)
    spec["lm_head.weight"] = (V, D)
    return spec


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448, back in float32."""
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """(N, L, ..., d) rotated at positions 0..L-1: the pair ``(x[2i],
    x[2i+1])`` by the angle ``pos / theta ** (2i / d)``, written as the
    rotated first members, then the rotated second members."""
    N, L, d = x.shape[0], x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    ang = ang.reshape(1, L, *([1] * (x.dim() - 3)), d // 2)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * ang.cos() - b * ang.sin(),
                      b * ang.cos() + a * ang.sin()], -1)


class KimiVLLMReference:
    """The model of ``cfg`` on ``weights`` (name -> tensor on the device
    the reference runs on, widened to float32 layer by layer)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        # float32 products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.W = weights
        self.fp8 = precision == "fp8"
        self.round = fp8 if self.fp8 else (lambda x: x)
        self.eps = cfg["rms_norm_eps"]
        self.H = cfg["num_attention_heads"]
        self.dn, self.dr, self.dv = (cfg["qk_nope_head_dim"],
                                     cfg["qk_rope_head_dim"],
                                     cfg["v_head_dim"])
        self.r = cfg["kv_lora_rank"]

    # -- pieces ---------------------------------------------------------------
    def w(self, name: str) -> torch.Tensor:
        """The weight ``name`` in float32 (rounded to fp8 under the
        control if it is a product's operand)."""
        t = self.W[name].float()
        if self.fp8 and not name.endswith(("norm.weight", "bias")):
            t = fp8(t)
        return t

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.w(f"{name}.weight") * x * torch.rsqrt(
            x.pow(2).mean(-1, keepdim=True) + self.eps)

    def lin(self, name: str, x: torch.Tensor, bias: bool = False):
        y = self.round(x) @ self.w(f"{name}.weight").t()
        return y + self.w(f"{name}.bias") if bias else y

    def swiglu(self, p: str, x: torch.Tensor) -> torch.Tensor:
        """The gated MLP over (T, D) tokens, ``ROWS`` at a time: the dense
        layer's (T, 11,264) f32 activations of every checked turn at once
        would not fit on the card beside the program."""
        return torch.cat([self.lin(f"{p}.down_proj", torch.nn.functional.silu(
            self.lin(f"{p}.gate_proj", x[i:i + ROWS]))
            * self.lin(f"{p}.up_proj", x[i:i + ROWS]))
            for i in range(0, x.shape[0], ROWS)])

    def attention(self, p: str, y: torch.Tensor) -> torch.Tensor:
        """Causal MLA over (N, L, D) sequences, decompressed."""
        N, L, _ = y.shape
        H, dn, dr, dv, r = self.H, self.dn, self.dr, self.dv, self.r
        q = self.lin(f"{p}.q_proj", y).reshape(N, L, H, dn + dr)
        ckv = self.lin(f"{p}.kv_a_proj_with_mqa", y)
        c = self.norm(f"{p}.kv_a_layernorm", ckv[..., :r])
        k_pe = ckv[..., r:]
        kv = self.lin(f"{p}.kv_b_proj", c).reshape(N, L, H, dn + dv)
        theta = self.cfg["rope_theta"]
        q = torch.cat([q[..., :dn], rope(q[..., dn:], theta)], -1)
        k = torch.cat([kv[..., :dn], rope(k_pe, theta)[:, :, None].expand(
            N, L, H, dr)], -1)
        v = kv[..., dn:]
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        s = self.round(q) @ self.round(k).transpose(-1, -2) \
            / math.sqrt(dn + dr)
        causal = torch.ones(L, L, dtype=torch.bool, device=y.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
        o = self.round(torch.softmax(s, -1)) @ self.round(v)
        return self.lin(f"{p}.o_proj", o.transpose(1, 2).reshape(N, L,
                                                                H * dv))

    def moe(self, p: str, x: torch.Tensor) -> torch.Tensor:
        """The mixture of experts over (T, D) tokens, one expert at a
        time."""
        cfg = self.cfg
        scores = torch.sigmoid(self.round(x) @ self.w(f"{p}.gate.weight").t())
        choice = scores + self.W[f"{p}.gate.e_score_correction_bias"].float()
        order = torch.sort(choice, dim=-1, descending=True, stable=True)[1]
        idx = order[:, :cfg["num_experts_per_tok"]]
        wts = scores.gather(1, idx)
        if cfg["norm_topk_prob"]:
            wts = wts / (wts.sum(-1, keepdim=True) + 1e-20)
        wts = wts * cfg["routed_scaling_factor"]
        gate_up = self.w(f"{p}.experts.gate_up_proj")
        down = self.w(f"{p}.experts.down_proj")
        Fe = down.shape[2]
        out = torch.zeros_like(x)
        for e in range(gate_up.shape[0]):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            h = self.round(x[tok]) @ gate_up[e].t()
            a = torch.nn.functional.silu(h[:, :Fe]) * h[:, Fe:]
            out.index_add_(0, tok, (self.round(a) @ down[e].t())
                           * wts[tok, slot, None])
        return out + self.swiglu(f"{p}.shared_experts", x)

    # -- the model --------------------------------------------------------------
    def prompt(self, fts: Sequence[torch.Tensor], cap: Sequence[int],
               his: Sequence[int], query: Sequence[int]) -> torch.Tensor:
        """(P, D) the prompt of one turn: features (T_i, F_i; a stream of
        no frame adds nothing), then the caption, history and question
        tokens without ``<blank>``."""
        parts = [self.lin(f"projector_{i}.linear_2", torch.nn.functional.gelu(
            self.lin(f"projector_{i}.linear_1", f.float(), True)), True)
            for i, f in enumerate(fts) if f.shape[0]]
        toks = [t for t in (*cap, *his, *query) if t != BLANK]
        dev = self.W["embed_tokens.weight"].device
        parts.append(self.W["embed_tokens.weight"][torch.tensor(
            toks, dtype=torch.long, device=dev)].float())
        return torch.cat(parts, 0)

    def logprobs_many(self, turns: Sequence[tuple]) -> List[List[torch.Tensor]]:
        """Each hypothesis's (len + 1, V) log-probabilities at the
        positions from ``<sos>`` on (those that predict its tokens and the
        ``<eos>`` after them), for ``turns`` of ``(fts, cap, his, query,
        hyps)``; every turn goes through a layer before the next layer's
        weights are widened."""
        with torch.no_grad():
            return self._logprobs_many(turns)

    def _logprobs_many(self, turns):
        emb = self.W["embed_tokens.weight"]
        xs, spans = [], []
        for fts, cap, his, query, hyps in turns:
            p = self.prompt(fts, cap, his, query)
            L = p.shape[0] + 1 + max(len(h) for h in hyps)
            x = torch.zeros(len(hyps), L, p.shape[1], device=p.device)
            x[:, :p.shape[0]] = p
            for n, h in enumerate(hyps):
                seq = torch.tensor([SOS, *h], dtype=torch.long,
                                   device=p.device)
                x[n, p.shape[0]:p.shape[0] + len(seq)] = emb[seq].float()
            xs.append(x)
            spans.append(p.shape[0])
        for n in range(self.cfg["num_hidden_layers"]):
            p = f"layers.{n}"
            dense = n < self.cfg["first_k_dense_replace"]
            for i, x in enumerate(xs):
                xs[i] = x + self.attention(f"{p}.self_attn", self.norm(
                    f"{p}.input_layernorm", x))
            flat = torch.cat([x.reshape(-1, x.shape[-1]) for x in xs])
            y = self.norm(f"{p}.post_attention_layernorm", flat)
            flat = flat + (self.swiglu(f"{p}.mlp", y) if dense
                           else self.moe(f"{p}.mlp", y))
            at = 0
            for i, x in enumerate(xs):
                n_rows = x.numel() // x.shape[-1]
                xs[i] = flat[at:at + n_rows].view(x.shape)
                at += n_rows
        return [[torch.log_softmax(self.lin("lm_head", self.norm(
            "norm", x[n, P:P + len(h) + 1])), -1)
            for n, h in enumerate(hyps)]
            for x, P, (*_, hyps) in zip(xs, spans, turns)]

    def scores_many(self, turns: Sequence[tuple], penalty: float
                    ) -> List[List[float]]:
        """Each turn's hypothesis scores (:meth:`hypothesis_scores`), for
        ``turns`` of ``(fts, cap, his, query, hyps)``."""
        out = []
        for logps, (*_, hyps) in zip(self.logprobs_many(turns), turns):
            scores = []
            for logp, h in zip(logps, hyps):
                tgt = torch.tensor([*h, EOS], dtype=torch.long,
                                   device=logp.device)
                scores.append(float(logp.gather(1, tgt[:, None]).double()
                                    .sum()) + penalty * (len(h) + 1))
            out.append(scores)
        return out

    def hypothesis_scores(self, query, his, cap, fts,
                          hyps: List[List[int]], penalty: float
                          ) -> List[float]:
        """The beam score of each hypothesis (token ids, without ``<sos>``
        and ``<eos>``) of one turn, as ``MTNReference.hypothesis_scores``
        takes it (token lists, or tensors with a leading axis of 1; the
        features (T_i, F_i) or (1, T_i, F_i)): the log-probability of its
        tokens and of the ``<eos>`` after them, plus ``penalty`` for each
        of those events."""
        tokens = lambda t: t.reshape(-1).tolist() if torch.is_tensor(t) \
            else list(t)
        fts = [f.reshape(f.shape[-2:]) for f in fts]
        return self.scores_many([(fts, tokens(cap), tokens(his),
                                  tokens(query), hyps)], penalty)[0]
