"""The MTN encoder-decoder in PyTorch (``mtn_tpu/models/mtn.py``).

Same architecture, parameter names and config branches as the JAX model:

- text encoding is ``Embed·sqrt(d) + PE`` followed by one LayerNorm per
  stream (:class:`NormEncoder`, norm order query, vid_*, cap, his, ae_*);
- video streams are ``Linear + ReLU + PE`` per feature type;
- each decoder layer runs self-attention, history attention, caption and
  query attention (order swapped by ``auto_encoder_ft``), per stream the
  Query-Aware Auto-Encoder (AE self-attn → AE→video attn → AE FFN →
  x→AE attn), and the final FFN, all as pre-norm residual sublayers;
- ``init_decode_state`` runs the AE chain and every cross-attention K/V
  projection once per turn batch; ``decode_step`` advances one token with
  a self-attention KV cache, updated in place.

Training mode follows ``self.training`` (JAX's ``deterministic=False``):
dropout after each positional encoding, on each sublayer's output, inside
the FFNs, and on the attention probabilities (``attn_dropout``). With
``remat`` each decoder layer's training forward under a trainer's
``collectives.Draws`` runs under ``torch.utils.checkpoint``
(``nn.remat(DecoderLayer)``): its activations are recomputed in the
backward, and dropout draws the forward's masks again, since each decoder
layer draws from its own generator and the recomputation from that
generator's twin, seeded alike. No RNG state is saved and restored, so
the step can be captured in a CUDA graph. Remat is for training under a
trainer: without its ``Draws`` the layers run as they are.

With ``batched_ae`` (and more than one stream) the per-stream AE chains
run as one stacked chain over (S, B, L, D), as JAX's
``_ae_streams_batched``: the parameters keep the sequential names and
layout, so checkpoints are interchangeable.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mtn_tpu_torch.config import ModelConfig
from mtn_tpu_torch.models.layers import (FeedForward, Generator,
                                         MultiHeadAttention, ParamLinear,
                                         PosEncoding, RefLayerNorm,
                                         ScaledEmbed, Sublayer, named_list,
                                         row_product, torch_dtype)
from mtn_tpu_torch.ops.attention import multi_head_attention
from mtn_tpu_torch.ops.masks import attend_first_if_empty
from mtn_tpu_torch.parallel.collectives import (active_draws, drawing,
                                                gather_last, sharded_dropout)

Tensor = torch.Tensor
Position = Union[int, Tensor]


def _map(obj, fn: Callable[[Tensor], Tensor]):
    """Apply ``fn`` to every tensor of a (nested) state dataclass/tuple."""
    if isinstance(obj, Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(x, fn) for x in obj)
    if obj is None:
        return None
    return replace(obj, **{f.name: _map(getattr(obj, f.name), fn)
                           for f in fields(obj)})


@dataclass
class Encoded:
    query: Tensor
    vid: Tuple[Tensor, ...]
    cap: Tensor
    his: Tensor
    ae: Optional[Tuple[Tensor, ...]]


@dataclass
class SourceMasks:
    query: Tensor                 # (B, 1, Lq) bool
    his: Tensor                   # (B, 1, Lh)
    cap: Tensor                   # (B, 1, Lc)
    vid: Tuple[Tensor, ...]       # per stream (B, 1, T_i)


@dataclass
class LayerDecodeCache:
    """Per-decoder-layer cross-attention K/V, computed once per batch."""

    his_kv: Tuple[Tensor, Tensor]
    cap_kv: Tuple[Tensor, Tensor]
    src_kv: Tuple[Tensor, Tensor]
    ae_kv: Tuple[Tuple[Tensor, Tensor], ...]


@dataclass
class DecodeState:
    layers: Tuple[LayerDecodeCache, ...]
    masks: SourceMasks
    ae_mask: Tensor               # (B, 1, L_ae)

    def map(self, fn: Callable[[Tensor], Tensor]) -> "DecodeState":
        return _map(self, fn)


class VideoEncoder(nn.Module):
    """Per-stream ``Linear + ReLU + PE(+dropout)``."""

    def __init__(self, ft_dim: int, d_model: int, dropout: float,
                 max_len: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.proj = ParamLinear(ft_dim, d_model, dtype)
        self.pe = PosEncoding(d_model, dropout, max_len, dtype)

    def forward(self, ft: Tensor) -> Tensor:
        h = torch.relu(self.proj(ft.to(self.dtype)))
        if self.proj.mode == "column":   # the next layers need it whole
            h = gather_last(h, self.proj.axis)
        return self.pe(h)


class NormEncoder(nn.Module):
    """One LayerNorm per stream: query, vid_*, cap, his, [ae_*]."""

    def __init__(self, d_model: int, n_streams: int, diff_encoder: bool,
                 param_dtype: torch.dtype):
        super().__init__()
        norm = lambda: RefLayerNorm(d_model, param_dtype=param_dtype)
        self.norm_query = norm()
        self.norm_vid = named_list(self, "norm_vid",
                                   [norm() for _ in range(n_streams)])
        self.norm_cap = norm()
        self.norm_his = norm()
        self.norm_ae = named_list(
            self, "norm_ae",
            [norm() for _ in range(n_streams)] if diff_encoder else [])

    def forward(self, query, vid: Sequence[Tensor], cap, his,
                ae: Optional[Sequence[Tensor]] = None):
        out_vid = tuple(self.norm_vid[i](v) for i, v in enumerate(vid))
        out_ae = None
        if ae is not None:
            out_ae = tuple(self.norm_ae[i](a) for i, a in enumerate(ae))
        return (self.norm_query(query), out_vid, self.norm_cap(cap),
                self.norm_his(his), out_ae)


class DecoderLayer(nn.Module):
    """One MTN decoder block."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.data_axis = None   # the stacked AE chain's rows (dim 1)
        dt = torch_dtype(cfg.dtype)
        pt = torch_dtype(cfg.param_dtype)
        D, s = cfg.d_model, cfg.n_streams
        mha = lambda: MultiHeadAttention(
            cfg.att_h, D, dt, attn_dropout=cfg.attn_dropout,
            use_kernel=cfg.use_pallas_attention)
        ffn = lambda: FeedForward(D, cfg.d_ff, cfg.dropout, dt,
                                  use_kernel=cfg.use_pallas_ffn)
        sub = lambda: Sublayer(D, cfg.dropout, param_dtype=pt)
        self.self_attn = mha()
        self.his_attn = mha()
        self.cap_attn = mha()
        self.src_attn = mha()
        self.ae_self_attn = named_list(self, "ae_self_attn",
                                       [mha() for _ in range(s)])
        self.ae_vid_attn = named_list(self, "ae_vid_attn",
                                      [mha() for _ in range(s)])
        self.ae_attn = named_list(self, "ae_attn", [mha() for _ in range(s)])
        self.ae_ff = named_list(self, "ae_ff", [ffn() for _ in range(s)])
        self.ff = ffn()
        self.sl_self = sub()
        self.sl_his = sub()
        self.sl_cap = sub()
        self.sl_src = sub()
        self.sl_ae_self = named_list(self, "sl_ae_self",
                                     [sub() for _ in range(s)])
        self.sl_ae_vid = named_list(self, "sl_ae_vid",
                                    [sub() for _ in range(s)])
        self.sl_ae_ff = named_list(self, "sl_ae_ff", [sub() for _ in range(s)])
        self.sl_x_ae = named_list(self, "sl_x_ae", [sub() for _ in range(s)])
        self.sl_ff = sub()

    def _ae_source(self, enc: Encoded, masks: SourceMasks):
        if self.cfg.auto_encoder_ft in ("caption", "summary"):
            return enc.cap, masks.cap
        return enc.query, masks.query

    def _ae_streams(self, ae_fts, enc: Encoded, masks: SourceMasks,
                    ae_mask) -> List[Tensor]:
        """Each stream's AE chain: self-attn → vid-attn → FFN; one
        stacked chain under ``cfg.batched_ae`` with more than one
        stream."""
        S = self.cfg.n_streams
        pick = lambda i: (ae_fts[i] if isinstance(ae_fts, (list, tuple))
                          else ae_fts)
        if self.cfg.batched_ae and S > 1:
            stacked = self._ae_streams_batched(
                [pick(i) for i in range(S)], enc.vid, masks.vid, ae_mask)
            return list(stacked.unbind(0))
        out = []
        for i in range(S):
            ae = pick(i)
            vid, vmask = enc.vid[i], masks.vid[i]
            ae = self.sl_ae_self[i](ae, lambda y: self.ae_self_attn[i](
                y, y, y, ae_mask))
            ae = self.sl_ae_vid[i](ae, lambda y: self.ae_vid_attn[i](
                y, vid, vid, vmask))
            ae = self.sl_ae_ff[i](ae, self.ae_ff[i])
            out.append(ae)
        return out

    def _ae_streams_batched(self, ae_list, enc_vid, vid_masks,
                            ae_mask) -> Tensor:
        """The S AE chains as one chain over a stacked (S, B, L, D)
        tensor, each sublayer once (JAX's ``_ae_streams_batched``).

        The streams' weights, biases and norm parameters are stacked per
        call; the video streams are zero-padded to the longest and their
        padded keys masked, which the f32 softmax makes exact. The AE FFN
        is ``relu(lin) → lin`` in plain PyTorch, never the FFN kernel, as
        JAX's stacked einsum never reaches ``fused_ffn``; attention runs
        through ``multi_head_attention`` on (S·B, H, L, Dk) with its
        kernel gate. int8 kernels scale after the product with their
        stacked per-channel scales. In training, dropout draws over the
        stacked shape: JAX's distribution, not its bits; under a data
        axis each stream's rows are this rank's (dimension 1). Under tensor
        parallelism the stacked slabs keep their layers' modes: local
        heads, and the row-parallel w_o and w_2 summed over ``model``."""
        cfg = self.cfg
        S, D, H = cfg.n_streams, cfg.d_model, cfg.att_h
        dt = torch_dtype(cfg.dtype)
        maxT = max(v.shape[1] for v in enc_vid)
        vid = torch.stack([nn.functional.pad(v, (0, 0, 0, maxT - v.shape[1]))
                           for v in enc_vid])                  # (S,B,T,D)
        vmask = torch.stack([nn.functional.pad(m, (0, maxT - m.shape[-1]))
                             for m in vid_masks])              # (S,B,1,T)
        ae = torch.stack(ae_list)                              # (S,B,L,D)
        B = ae.shape[1]
        amask = ae_mask[None].expand((S,) + tuple(ae_mask.shape))
        per_stream = lambda t: t[:, None, None, :]

        def drop(x, axis=None):
            return sharded_dropout(x, cfg.dropout, self.training, axis,
                                   data=self.data_axis, row_dim=1)

        def norm(x, subs):
            a = torch.stack([s.norm.scale for s in subs])
            b = torch.stack([s.norm.bias for s in subs])
            xf = x.float()
            mean = xf.mean(dim=-1, keepdim=True)
            var = torch.square(xf - mean).sum(dim=-1, keepdim=True) / (D - 1)
            y = per_stream(a) * (xf - mean) / (torch.sqrt(var) + 1e-6) \
                + per_stream(b)
            return y.to(x.dtype)

        def lin(x, mods, name):
            subs = [getattr(m, name) for m in mods]
            W = torch.stack([s.kernel for s in subs]).to(dt)   # (S,D,E)
            x = subs[0].prepare(x)
            y = (row_product(x, W, subs[0].axis, dt)
                 if subs[0].mode == "row" else torch.matmul(x, W[:, None]))
            if subs[0].is_int8:
                y = y * per_stream(torch.stack(
                    [s.kernel_scale for s in subs]).to(dt))
            return y + per_stream(torch.stack([s.bias for s in subs]))

        def mha(mods, xq, xkv, mask):
            split = lambda t: t.reshape(S * B, t.shape[2], -1,
                                        D // H).transpose(1, 2)
            out = multi_head_attention(
                split(lin(xq, mods, "w_q")), split(lin(xkv, mods, "w_k")),
                split(lin(xkv, mods, "w_v")),
                mask.reshape(S * B, 1, 1, mask.shape[-1]),
                dropout_rate=cfg.attn_dropout if self.training else 0.0,
                use_kernel=cfg.use_pallas_attention, heads=mods[0].w_q.axis,
                data=self.data_axis, stack=S)
            return lin(out.transpose(1, 2).reshape(S, B, out.shape[2], -1),
                       mods, "w_o")

        y = norm(ae, self.sl_ae_self)
        ae = ae + drop(mha(self.ae_self_attn, y, y, amask))
        ae = ae + drop(mha(self.ae_vid_attn, norm(ae, self.sl_ae_vid), vid,
                           vmask))
        h = torch.relu(lin(norm(ae, self.sl_ae_ff), self.ae_ff, "w_1"))
        return ae + drop(lin(drop(h, self.ae_ff[0].w_1.axis), self.ae_ff,
                             "w_2"))

    # -- full (training) forward -------------------------------------------
    def forward(self, x, enc: Encoded, masks: SourceMasks, tgt_mask, ae_fts):
        x = self.sl_self(x, lambda y: self.self_attn(y, y, y, tgt_mask))
        x = self.sl_his(x, lambda y: self.his_attn(
            y, enc.his, enc.his, masks.his))
        cap = lambda x: self.sl_cap(x, lambda y: self.cap_attn(
            y, enc.cap, enc.cap, masks.cap))
        src = lambda x: self.sl_src(x, lambda y: self.src_attn(
            y, enc.query, enc.query, masks.query))
        if self.cfg.auto_encoder_ft in ("caption", "summary"):
            x = cap(src(x))
        else:  # 'query'
            x = src(cap(x))
        seed, ae_mask = self._ae_source(enc, masks)
        if ae_fts is None:
            ae_fts = seed
        out_ae = self._ae_streams(ae_fts, enc, masks, ae_mask)
        for i, ae in enumerate(out_ae):
            x = self.sl_x_ae[i](x, lambda y, ae=ae, i=i: self.ae_attn[i](
                y, ae, ae, ae_mask))
        x = self.sl_ff(x, self.ff)
        return x, tuple(out_ae)

    # -- decode-time precompute --------------------------------------------
    def precompute(self, enc: Encoded, masks: SourceMasks, ae_fts):
        """Advance the AE chain one layer and cache all cross K/V."""
        seed, ae_mask = self._ae_source(enc, masks)
        if ae_fts is None:
            ae_fts = seed
        out_ae = self._ae_streams(ae_fts, enc, masks, ae_mask)
        cache = LayerDecodeCache(
            his_kv=self.his_attn.project_kv(enc.his),
            cap_kv=self.cap_attn.project_kv(enc.cap),
            src_kv=self.src_attn.project_kv(enc.query),
            ae_kv=tuple(self.ae_attn[i].project_kv(a)
                        for i, a in enumerate(out_ae)),
        )
        return cache, tuple(out_ae)

    # -- single-token decode step ------------------------------------------
    def step(self, x, cache: LayerDecodeCache, masks: SourceMasks, ae_mask,
             self_k, self_v, pos: Position, self_q=None):
        """x: (B, 1, D). ``self_k/v``: (B, H, maxlen, Dk) caches already
        holding this step's K/V at ``pos``. ``self_q``: the current
        position's head-split q from ``fused_self_qkv``, if used."""
        maxlen = self_k.shape[2]
        valid = (torch.arange(maxlen, device=x.device)
                 <= pos)[None, None, None, :]
        if self_q is not None:
            x = self.sl_self(x, lambda y: self.self_attn.attend_pre_q(
                self_q, self_k, self_v, valid))
        else:
            x = self.sl_self(x, lambda y: self.self_attn.attend_with_kv(
                y, self_k, self_v, valid))
        x = self.sl_his(x, lambda y: self.his_attn.attend_with_kv(
            y, *cache.his_kv, masks.his[:, None]))
        cap = lambda x: self.sl_cap(x, lambda y: self.cap_attn.attend_with_kv(
            y, *cache.cap_kv, masks.cap[:, None]))
        src = lambda x: self.sl_src(x, lambda y: self.src_attn.attend_with_kv(
            y, *cache.src_kv, masks.query[:, None]))
        if self.cfg.auto_encoder_ft in ("caption", "summary"):
            x = cap(src(x))
        else:
            x = src(cap(x))
        for i in range(self.cfg.n_streams):
            x = self.sl_x_ae[i](x, lambda y, i=i: self.ae_attn[i].attend_with_kv(
                y, *cache.ae_kv[i], ae_mask[:, None]))
        return self.sl_ff(x, self.ff)

    def self_norm_in(self, x):
        return self.sl_self.normed(x)


class Decoder(nn.Module):
    """N stacked decoder layers + final norms."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        pt = torch_dtype(cfg.param_dtype)
        self.layers = named_list(self, "layer", [
            DecoderLayer(cfg) for _ in range(cfg.nb_blocks)])
        self.norm = RefLayerNorm(cfg.d_model, param_dtype=pt)
        self.ae_norm = named_list(self, "ae_norm", [
            RefLayerNorm(cfg.d_model, param_dtype=pt)
            for _ in range(cfg.n_streams)])

    def forward(self, x, enc: Encoded, masks: SourceMasks, tgt_mask, ae_fts):
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        draws = active_draws()
        for i, layer in enumerate(self.layers):
            args = (x, enc, masks, tgt_mask, ae_fts)
            if draws is None:
                x, ae_fts = layer(*args)
            elif remat:
                fwd, twin = draws.layers[i], draws.recompute[i]
                x, ae_fts = checkpoint(
                    layer, *args, use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=lambda: (drawing(fwd), drawing(twin)))
            else:
                with drawing(draws.layers[i]):
                    x, ae_fts = layer(*args)
        out_ae = tuple(self.ae_norm[i](ft) for i, ft in enumerate(ae_fts))
        return self.norm(x), out_ae

    def precompute(self, enc: Encoded, masks: SourceMasks, ae_fts):
        caches = []
        for layer in self.layers:
            cache, ae_fts = layer.precompute(enc, masks, ae_fts)
            caches.append(cache)
        return tuple(caches)

    def step(self, x, state: DecodeState, self_kv, pos: Position):
        """One decode position through all layers. ``self_kv``: per layer
        (k, v) caches (B, H, maxlen, Dk), written in place at ``pos`` (an
        ``int``, or a 0-d int64 tensor that a traced program takes as an
        input). Returns (normed x, self_kv)."""
        for layer, cache, (k_cache, v_cache) in zip(self.layers,
                                                    state.layers, self_kv):
            y = layer.self_norm_in(x)
            if self.cfg.fused_decode_qkv:
                q_t, k_t, v_t = layer.self_attn.fused_qkv(y)
            else:
                q_t = None
                k_t, v_t = layer.self_attn.project_kv(y)
            if isinstance(pos, int):
                k_cache[:, :, pos:pos + 1] = k_t
                v_cache[:, :, pos:pos + 1] = v_t
            else:
                k_cache.index_copy_(2, pos.reshape(1), k_t)
                v_cache.index_copy_(2, pos.reshape(1), v_t)
            x = layer.step(x, cache, state.masks, state.ae_mask, k_cache,
                           v_cache, pos, self_q=q_t)
        return self.norm(x), self_kv


class MTN(nn.Module):
    """The full encoder-decoder."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        pt = torch_dtype(cfg.param_dtype)
        V, D, s = cfg.vocab_size, cfg.d_model, cfg.n_streams
        embed = lambda: ScaledEmbed(V, D, dt)
        pe = lambda: PosEncoding(D, cfg.dropout, cfg.max_len, dt)
        self.embed_src = embed()
        self.embed_tgt = embed()
        self.pe_src = pe()
        self.pe_tgt = pe()
        if cfg.separate_his_embed:
            self.embed_his = embed()
            self.pe_his = pe()
        if cfg.separate_cap_embed:
            self.embed_cap = embed()
            self.pe_cap = pe()
        # the AE embeddings exist only where encode uses them
        use_ae_embed = cfg.diff_embed and cfg.diff_encoder
        self.ae_embeds = named_list(
            self, "ae_embed", [embed() for _ in range(s)] if use_ae_embed
            else [])
        self.ae_pes = named_list(
            self, "ae_pe", [pe() for _ in range(s)] if use_ae_embed else [])
        self.vid_encoders = named_list(self, "vid_encoder", [
            VideoEncoder(ft, D, cfg.dropout, cfg.max_len, dt)
            for ft in cfg.ft_sizes])
        self.encoder = NormEncoder(D, s, cfg.diff_encoder, pt)
        self.decoder = Decoder(cfg)
        self.generator = Generator(D, V, dt)
        self.ae_generators = named_list(
            self, "ae_generator",
            [Generator(D, V, dt) for _ in range(s)] if cfg.diff_gen else [])

    # -- encoding -----------------------------------------------------------
    def _embed_query(self, tokens):
        return self.pe_src(self.embed_src(tokens))

    def _embed_his(self, tokens):
        if self.cfg.separate_his_embed:
            return self.pe_his(self.embed_his(tokens))
        return self._embed_query(tokens)

    def _embed_cap(self, tokens):
        if self.cfg.separate_cap_embed:
            return self.pe_cap(self.embed_cap(tokens))
        return self._embed_query(tokens)

    def encode(self, query, his, cap, fts: Sequence[Tensor]) -> Encoded:
        cfg = self.cfg
        vid = [self.vid_encoders[i](ft) for i, ft in enumerate(fts)]
        ae = None
        if cfg.diff_encoder:
            src = cap if cfg.auto_encoder_ft in ("caption", "summary") \
                else query
            ae = [self.ae_pes[i](self.ae_embeds[i](src)) if cfg.diff_embed
                  else self._embed_query(src)
                  for i in range(cfg.n_streams)]
        q, v, c, h, a = self.encoder(self._embed_query(query), vid,
                                     self._embed_cap(cap),
                                     self._embed_his(his), ae)
        return Encoded(query=q, vid=v, cap=c, his=h, ae=a)

    # -- training forward ---------------------------------------------------
    def forward(self, query, his, cap, fts, masks: SourceMasks, tgt,
                tgt_mask):
        """Returns (normed decoder output, per-stream AE outputs)."""
        enc = self.encode(query, his, cap, fts)
        x = self.pe_tgt(self.embed_tgt(tgt))
        ae_fts = list(enc.ae) if enc.ae is not None else None
        return self.decoder(x, enc, masks, tgt_mask, ae_fts)

    def generate_logprobs(self, x):
        return self.generator(x)

    def ae_logprobs(self, ae_outs: Sequence[Tensor]):
        if self.cfg.diff_gen:
            return [self.ae_generators[i](a) for i, a in enumerate(ae_outs)]
        return [self.generator(a) for a in ae_outs]

    # -- decode-time API ----------------------------------------------------
    def init_decode_state(self, query, his, cap, fts,
                          masks: SourceMasks) -> DecodeState:
        # a fully-masked source row attends position 0 only (decode law)
        masks = SourceMasks(
            query=attend_first_if_empty(masks.query),
            his=attend_first_if_empty(masks.his),
            cap=attend_first_if_empty(masks.cap),
            vid=tuple(attend_first_if_empty(m) for m in masks.vid))
        enc = self.encode(query, his, cap, fts)
        ae_fts = list(enc.ae) if enc.ae is not None else None
        caches = self.decoder.precompute(enc, masks, ae_fts)
        ae_mask = masks.cap if self.cfg.auto_encoder_ft in (
            "caption", "summary") else masks.query
        return DecodeState(layers=caches, masks=masks, ae_mask=ae_mask)

    def decode_step(self, state: DecodeState, tokens: Tensor, pos: Position,
                    self_kv):
        """tokens: (B,) current input token; pos: position, an ``int`` or a
        0-d int64 tensor (the two give bitwise equal results). Returns
        ((B, V) f32 log-probs, self_kv updated in place)."""
        x = self.pe_tgt.at(self.embed_tgt(tokens[:, None]), pos)
        x, self_kv = self.decoder.step(x, state, self_kv, pos)
        return self.generator(x[:, 0]), self_kv

    def init_self_kv(self, batch_size: int, maxlen: int, device=None):
        """Zeroed per-layer self-attention KV caches (one tensor each)."""
        cfg = self.cfg
        heads = self.decoder.layers[0].self_attn.local_heads
        shape = (batch_size, heads, maxlen, cfg.d_model // cfg.att_h)
        dt = torch_dtype(cfg.dtype)
        device = device if device is not None else \
            self.generator.proj.kernel.device
        return tuple((torch.zeros(shape, dtype=dt, device=device),
                      torch.zeros(shape, dtype=dt, device=device))
                     for _ in range(cfg.nb_blocks))
