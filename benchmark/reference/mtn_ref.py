"""Plain PyTorch MTN (Le et al., ACL 2019; henryhungle/MTN) for the
benchmark's comparison.

One dialogue turn at a time, in float32 with TF32 off, no kernels, no
cache and no batching: the encoders run over the turn's exact lengths,
and the decoder runs over the whole target prefix at once (teacher
forcing), which is what a cached one-token step computes position by
position. It follows the reference repository's modules:

- text: ``Embed(x)·sqrt(d) + PE``, then one LayerNorm per stream (query,
  each video stream, caption, history, each auto-encoder stream);
- video: ``ReLU(Linear(feature)) + PE`` per feature type;
- LayerNorm: ``a·(x - mean)/(std + eps) + b`` with the unbiased std;
- each decoder layer, pre-norm residual sublayers: self-attention,
  history attention, then caption and query attention (caption first
  when the auto-encoder reads the query), per video stream the
  query-aware auto-encoder (its self-attention, its attention to the
  video, its FFN) followed by the decoder's attention to the
  auto-encoder's output, and the FFN; the auto-encoder's state passes
  from layer to layer;
- a final LayerNorm and the generator's log-softmax.

Masks: pad tokens (``<blank>``) are masked; a source with no unmasked
key attends its first key only (the decode law for a lone-``<blank>``
history). Masked scores are filled with -1e9.

Parameter names are those of the flax and PyTorch checkpoints of the
port (``decoder.layer_0.sl_self.norm.scale``); :func:`param_spec` lists
them, with their shapes, from a configuration. This module imports
nothing but torch and the standard library.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

UNK, BLANK, SOS, EOS = 0, 1, 2, 3
NEG = -1e9
EPS = 1e-6


def param_spec(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the model ``cfg`` describes and its shape, in
    the checkpoints' order. ``cfg`` keys: vocab_size, nb_blocks, d_model,
    d_ff, ft_sizes, diff_encoder."""
    V, D, F = cfg["vocab_size"], cfg["d_model"], cfg["d_ff"]
    ft = list(cfg["ft_sizes"])
    S = len(ft)
    spec: Dict[str, Tuple[int, ...]] = {}

    def lin(name, i, o):
        spec[f"{name}.kernel"] = (i, o)
        spec[f"{name}.bias"] = (o,)

    def norm(name):
        spec[f"{name}.scale"] = (D,)
        spec[f"{name}.bias"] = (D,)

    def mha(name):
        for w in ("w_q", "w_k", "w_v", "w_o"):
            lin(f"{name}.{w}", D, D)

    def ffn(name):
        lin(f"{name}.w_1", D, F)
        lin(f"{name}.w_2", F, D)

    spec["embed_src.lut.embedding"] = (V, D)
    spec["embed_tgt.lut.embedding"] = (V, D)
    for i, n in enumerate(ft):
        lin(f"vid_encoder_{i}.proj", n, D)
    norm("encoder.norm_query")
    for i in range(S):
        norm(f"encoder.norm_vid_{i}")
    norm("encoder.norm_cap")
    norm("encoder.norm_his")
    if cfg["diff_encoder"]:
        for i in range(S):
            norm(f"encoder.norm_ae_{i}")
    for layer in range(cfg["nb_blocks"]):
        p = f"decoder.layer_{layer}"
        for a in ("self_attn", "his_attn", "cap_attn", "src_attn"):
            mha(f"{p}.{a}")
        for kind in ("ae_self_attn", "ae_vid_attn", "ae_attn"):
            for i in range(S):
                mha(f"{p}.{kind}_{i}")
        for i in range(S):
            ffn(f"{p}.ae_ff_{i}")
        ffn(f"{p}.ff")
        for s in ("sl_self", "sl_his", "sl_cap", "sl_src"):
            norm(f"{p}.{s}.norm")
        for kind in ("sl_ae_self", "sl_ae_vid", "sl_ae_ff", "sl_x_ae"):
            for i in range(S):
                norm(f"{p}.{kind}_{i}.norm")
        norm(f"{p}.sl_ff.norm")
    norm("decoder.norm")
    for i in range(S):
        norm(f"decoder.ae_norm_{i}")
    lin("generator.proj", D, V)
    return spec


def positional_table(length: int, d: int, device) -> torch.Tensor:
    """(length, d) sinusoids: sin on even dimensions, cos on odd ones."""
    pos = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64,
                                 device=device) * -(math.log(10000.0) / d))
    pe = torch.zeros(length, d, dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448, back in float32."""
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


class MTNReference:
    """The model of ``cfg`` on the float32 weights ``weights`` (name ->
    tensor, on the device the reference runs on).

    ``precision="fp8"`` is the check's control: the same model with both
    operands of every product (the linears, the attention scores and the
    weighted sums) rounded to float8 e4m3 (:func:`fp8`), the rest in
    float32."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        self.cfg = cfg
        self.W = {k: v.float() for k, v in weights.items()}
        self.round = fp8 if precision == "fp8" else (lambda x: x)
        if precision == "fp8":
            self.W = {k: fp8(v) if k.endswith(("kernel", "embedding"))
                      else v for k, v in self.W.items()}
        self.D = cfg["d_model"]
        self.H = cfg["att_h"]
        self.S = len(cfg["ft_sizes"])
        dev = next(iter(self.W.values())).device
        self.pe = positional_table(512, self.D, dev)

    # -- pieces ---------------------------------------------------------------
    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        std = x.std(-1, keepdim=True, unbiased=True)
        return self.W[f"{name}.scale"] * (x - mean) / (std + EPS) \
            + self.W[f"{name}.bias"]

    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.round(x) @ self.W[f"{name}.kernel"] \
            + self.W[f"{name}.bias"]

    def embed(self, name: str, tokens: torch.Tensor) -> torch.Tensor:
        e = self.W[f"{name}.lut.embedding"][tokens] * math.sqrt(self.D)
        return e + self.pe[:tokens.shape[-1]]

    def attention(self, name: str, xq, xkv, mask) -> torch.Tensor:
        """xq (N, Lq, D), xkv (N, Lk, D), mask bool broadcastable to
        (N, Lq, Lk), True = attend."""
        N, Lq, D = xq.shape
        Lk, dk = xkv.shape[1], D // self.H
        split = lambda t, L: t.reshape(N, L, self.H, dk).transpose(1, 2)
        q = split(self.lin(f"{name}.w_q", xq), Lq)
        k = split(self.lin(f"{name}.w_k", xkv), Lk)
        v = split(self.lin(f"{name}.w_v", xkv), Lk)
        r = self.round
        scores = r(q) @ r(k).transpose(-1, -2) / math.sqrt(dk)
        scores = scores.masked_fill(~mask[:, None], NEG)
        out = r(torch.softmax(scores, -1)) @ r(v)
        return self.lin(f"{name}.w_o",
                        out.transpose(1, 2).reshape(N, Lq, D))

    def ffn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.lin(f"{name}.w_2", torch.relu(self.lin(f"{name}.w_1", x)))

    def sub(self, name: str, x: torch.Tensor, f) -> torch.Tensor:
        return x + f(self.norm(f"{name}.norm", x))

    @staticmethod
    def key_mask(tokens: torch.Tensor) -> torch.Tensor:
        """(N, L) tokens -> (N, 1, L): pads masked, a row with no key
        left attends its first key only."""
        m = (tokens != BLANK)[:, None, :]
        first = torch.zeros_like(m)
        first[..., 0] = True
        return torch.where(m.any(-1, keepdim=True), m, first)

    # -- the model --------------------------------------------------------------
    def encode(self, query, his, cap, fts: Sequence[torch.Tensor]):
        """One turn's sources, each with a leading axis of 1: tokens
        (1, L) and features (1, T_i, F_i). Returns the encoded sources
        and their masks."""
        vid = [self.embed_video(i, f) for i, f in enumerate(fts)]
        vid = [self.norm(f"encoder.norm_vid_{i}", v) for i, v in enumerate(vid)]
        q = self.embed("embed_src", query)
        c = self.embed("embed_src", cap)
        enc = dict(query=self.norm("encoder.norm_query", q),
                   cap=self.norm("encoder.norm_cap", c),
                   his=self.norm("encoder.norm_his",
                                 self.embed("embed_src", his)),
                   vid=vid)
        masks = dict(query=self.key_mask(query), cap=self.key_mask(cap),
                     his=self.key_mask(his),
                     vid=[torch.ones(1, 1, f.shape[1], dtype=torch.bool,
                                     device=f.device) for f in fts])
        # the auto-encoder reads the query, or the caption
        on_cap = self.cfg["auto_encoder_ft"] in ("caption", "summary")
        source = c if on_cap else q
        enc["ae"] = ([self.norm(f"encoder.norm_ae_{i}", source)
                      for i in range(self.S)] if self.cfg["diff_encoder"]
                     else [enc["cap" if on_cap else "query"]] * self.S)
        masks["ae"] = masks["cap" if on_cap else "query"]
        return enc, masks

    def embed_video(self, i: int, ft: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.lin(f"vid_encoder_{i}.proj", ft.float()))
        return h + self.pe[:h.shape[1]]

    def decode(self, enc, masks, tgt: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder over (N, L) target inputs, all N rows
        for the one encoded turn: (N, L, V) log-probabilities."""
        N, L = tgt.shape
        rows = lambda t: t.expand(N, *t.shape[1:])
        causal = torch.ones(L, L, dtype=torch.bool,
                            device=tgt.device).tril()[None]
        x = self.embed("embed_tgt", tgt)
        ae = [rows(a) for a in enc["ae"]]
        his, cap, query = rows(enc["his"]), rows(enc["cap"]), rows(enc["query"])
        vid = [rows(v) for v in enc["vid"]]
        ae_mask = rows(masks["ae"])
        query_first = self.cfg["auto_encoder_ft"] in ("caption", "summary")
        for layer in range(self.cfg["nb_blocks"]):
            p = f"decoder.layer_{layer}"
            x = self.sub(f"{p}.sl_self", x, lambda y: self.attention(
                f"{p}.self_attn", y, y, causal))
            x = self.sub(f"{p}.sl_his", x, lambda y: self.attention(
                f"{p}.his_attn", y, his, rows(masks["his"])))
            to_cap = lambda x: self.sub(f"{p}.sl_cap", x, lambda y: (
                self.attention(f"{p}.cap_attn", y, cap, rows(masks["cap"]))))
            to_query = lambda x: self.sub(f"{p}.sl_src", x, lambda y: (
                self.attention(f"{p}.src_attn", y, query,
                               rows(masks["query"]))))
            x = to_cap(to_query(x)) if query_first else to_query(to_cap(x))
            for i in range(self.S):
                a = ae[i]
                a = self.sub(f"{p}.sl_ae_self_{i}", a, lambda y: (
                    self.attention(f"{p}.ae_self_attn_{i}", y, y, ae_mask)))
                a = self.sub(f"{p}.sl_ae_vid_{i}", a, lambda y: (
                    self.attention(f"{p}.ae_vid_attn_{i}", y, vid[i],
                                   rows(masks["vid"][i]))))
                a = self.sub(f"{p}.sl_ae_ff_{i}", a,
                             lambda y: self.ffn(f"{p}.ae_ff_{i}", y))
                ae[i] = a
                x = self.sub(f"{p}.sl_x_ae_{i}", x, lambda y: (
                    self.attention(f"{p}.ae_attn_{i}", y, a, ae_mask)))
            x = self.sub(f"{p}.sl_ff", x, lambda y: self.ffn(f"{p}.ff", y))
        x = self.norm("decoder.norm", x)
        return torch.log_softmax(self.lin("generator.proj", x), -1)

    def hypothesis_scores(self, query, his, cap, fts,
                          hyps: List[List[int]], penalty: float
                          ) -> List[float]:
        """The beam score of each hypothesis (token ids, without
        ``<sos>`` and ``<eos>``) of one turn: the log-probability of its
        tokens and of the ``<eos>`` after them, plus ``penalty`` for each
        of those events."""
        with torch.no_grad():
            return self._scores(query, his, cap, fts, hyps, penalty)

    def _scores(self, query, his, cap, fts, hyps, penalty):
        enc, masks = self.encode(query, his, cap, fts)
        L = max(len(h) for h in hyps) + 1
        dev = query.device
        tgt = torch.full((len(hyps), L), BLANK, dtype=torch.long, device=dev)
        out = torch.full((len(hyps), L), BLANK, dtype=torch.long, device=dev)
        for n, h in enumerate(hyps):
            seq = torch.tensor(h, dtype=torch.long, device=dev)
            tgt[n, 0] = SOS
            tgt[n, 1:len(h) + 1] = seq
            out[n, :len(h)] = seq
            out[n, len(h)] = EOS
        logp = self.decode(enc, masks, tgt)
        picked = logp.gather(-1, out[..., None])[..., 0]
        return [float(picked[n, :len(h) + 1].double().sum())
                + penalty * (len(h) + 1) for n, h in enumerate(hyps)]


# -- the data law (the reference's data_handler) ------------------------------
def words2ids(text: str, vocab: Dict[str, int]) -> List[int]:
    """``<sos>`` + the words' ids (``<unk>`` when unknown) + ``<eos>``."""
    return [SOS] + [vocab.get(w, UNK) for w in text.split()] + [EOS]


def turn_tokens(dialog: dict, turn: int, vocab: Dict[str, int],
                include_caption: str = "caption,summary"):
    """(query, history, caption) token lists of ``turn`` of ``dialog``
    with a separate caption and the whole history: the history is a
    ``<blank>`` followed by every earlier question and answer, each
    wrapped in ``<sos>``/``<eos>``; the caption joins the caption and
    summary strings as they are; no caption is a lone ``<blank>``."""
    qa = dialog["dialog"]
    his = [BLANK]
    for t in range(turn):
        his += words2ids(qa[t]["question"], vocab)
        his += words2ids(qa[t]["answer"], vocab)
    if include_caption == "caption,summary":
        cap = words2ids(dialog["caption"] + dialog["summary"], vocab)
    elif include_caption in ("caption", "summary"):
        cap = words2ids(dialog[include_caption], vocab)
    else:
        cap = [BLANK]
    return words2ids(qa[turn]["question"], vocab), his, cap
