"""Batched beam and greedy decoding with KV and auto-encoder caches
(``mtn_tpu/decode/beam.py``).

Same search law as the JAX decoder:

- every step expands every live hypothesis; expansions skip ``<unk>`` and
  ``<eos>``;
- a completion is recorded at every step ``l >= min_len`` with score
  ``lp + logp[<eos>] + penalty·(l+1)``, into a pool of the ``nbest`` best
  completions (pool entries first on ties);
- the next beam is the global top-``beam`` of the (beam × vocab)
  candidates, taken in two stages (top-``beam`` per parent, then over the
  beam² survivors), the self-attention KV cache is reordered by parent;
- with ``early_stop`` the loop ends once no live hypothesis can still
  enter any row's n-best (identical output, fewer steps).

Ties: ``lax.top_k`` puts the lower index first, and both top-k stages and
the completion pool rely on it. ``torch.topk`` promises no tie order, so
:func:`top_k` takes a stable descending sort. The early-stop test runs
on the host here: one device-to-host sync per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from mtn_tpu_torch.config import DecodeConfig
from mtn_tpu_torch.data.vocab import SPECIALS
from mtn_tpu_torch.models.mtn import MTN, DecodeState
from mtn_tpu_torch.train.batch import DeviceBatch, batch_masks

NEG_INF = -1.0e30


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, lower index first among equal values
    (the ``lax.top_k`` order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def detokenize(tokens, vlist, eos: int = SPECIALS["<eos>"]) -> str:
    """Token ids -> space-joined words, cut at <eos>."""
    words = []
    for t in tokens:
        if int(t) == eos:
            break
        words.append(vlist[int(t)])
    return " ".join(words)


@dataclass
class BeamResult:
    """Host-side n-best for one turn."""

    tokens: List[List[int]]   # nbest token lists (no <sos>/<eos>)
    scores: List[float]

    def texts(self, vlist, eos: int = SPECIALS["<eos>"]):
        return [(detokenize(t, vlist, eos), s)
                for t, s in zip(self.tokens, self.scores)]


def completions_to_results(comp_scores, comp_buf, comp_len,
                           valid) -> List[BeamResult]:
    """The completion pool — ``(B, nbest)`` scores, ``(B, nbest,
    maxlen+1)`` token buffers with the <sos> prefix, ``(B, nbest)``
    lengths, as numpy — to one :class:`BeamResult` per valid row; an
    empty pool gives one empty hypothesis scored 0."""
    results = []
    for b in range(comp_scores.shape[0]):
        if not valid[b]:
            continue
        toks, scs = [], []
        for n in range(comp_scores.shape[1]):
            if comp_scores[b, n] <= NEG_INF / 2:
                continue
            L = int(comp_len[b, n])
            toks.append([int(t) for t in comp_buf[b, n, 1:L + 1]])
            scs.append(float(comp_scores[b, n]))
        if not toks:
            toks, scs = [[]], [0.0]
        results.append(BeamResult(tokens=toks, scores=scs))
    return results


@dataclass
class BeamRaw:
    """One decoded batch on the device, before the host conversion."""

    comp_scores: torch.Tensor   # (B, nbest) f32
    comp_buf: torch.Tensor      # (B, nbest, maxlen+1)
    comp_len: torch.Tensor      # (B, nbest)
    n_steps: int                # decode steps run


class BeamDecoder:
    def __init__(self, model: MTN, decode_cfg: DecodeConfig,
                 pad: int = SPECIALS["<blank>"], sos: int = SPECIALS["<sos>"],
                 eos: int = SPECIALS["<eos>"], unk: int = SPECIALS["<unk>"]):
        self.model = model
        self.cfg = decode_cfg
        self.pad, self.sos, self.eos, self.unk = pad, sos, eos, unk

    def _decode_state(self, batch: DeviceBatch) -> DecodeState:
        masks, _ = batch_masks(batch, self.pad)
        return self.model.init_decode_state(batch.query, batch.his,
                                            batch.cap, batch.fts, masks)

    def _step(self, state, tokens, pos: int, self_kv):
        return self.model.decode_step(state, tokens, pos, self_kv)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def beam_batch_raw(self, batch: DeviceBatch) -> BeamRaw:
        cfg = self.cfg
        beam, nbest = cfg.beam, cfg.nbest
        maxlen, min_len, penalty = cfg.maxlen, cfg.min_len, cfg.penalty
        eos, unk = self.eos, self.unk
        dev = batch.query.device
        B = batch.query.shape[0]
        state = self._decode_state(batch)
        # tile every per-turn tensor over the beam: row b*beam+k = turn b
        state = state.map(lambda x: x.repeat_interleave(beam, dim=0))
        self_kv = self.model.init_self_kv(B * beam, maxlen, dev)

        tok_buf = torch.full((B, beam, maxlen + 1), self.pad,
                             dtype=torch.int64, device=dev)
        tok_buf[:, :, 0] = self.sos
        scores = torch.full((B, beam), NEG_INF, dtype=torch.float32,
                            device=dev)
        scores[:, 0] = 0.0  # one live hypothesis at step 0
        comp_scores = torch.full((B, nbest), NEG_INF, dtype=torch.float32,
                                 device=dev)
        comp_buf = torch.full((B, nbest, maxlen + 1), self.pad,
                              dtype=torch.int64, device=dev)
        comp_len = torch.zeros((B, nbest), dtype=torch.int64, device=dev)
        rows = torch.arange(B, device=dev)[:, None] * beam

        # a completion recorded during step l' scores at most
        # score_active + penalty·(l'+1), and active scores only decay
        def future_reward(l: int) -> float:
            return penalty * maxlen if penalty >= 0.0 else penalty * (l + 1.0)

        n_steps = 0
        for l in range(maxlen):
            if cfg.early_stop:
                bound = scores.max(dim=1).values + future_reward(l)
                if not bool((bound >= comp_scores[:, -1]).any()):
                    break
            cur = tok_buf[:, :, l].reshape(B * beam)
            logp, self_kv = self._step(state, cur, l, self_kv)
            V = logp.shape[-1]
            logp = logp.reshape(B, beam, V)
            # -- record completions -----------------------------------
            # the length reward in f32, as JAX multiplies it
            reward = float(np.float32(penalty) * np.float32(l + 1))
            eos_sc = scores + logp[:, :, eos] + reward
            if l < min_len:
                eos_sc = torch.full_like(eos_sc, NEG_INF)
            all_sc = torch.cat([comp_scores, eos_sc], dim=1)
            all_buf = torch.cat([comp_buf, tok_buf], dim=1)
            all_len = torch.cat(
                [comp_len, torch.full((B, beam), l, dtype=torch.int64,
                                      device=dev)], dim=1)
            comp_scores, top = top_k(all_sc, nbest)
            comp_buf = torch.gather(
                all_buf, 1, top[:, :, None].expand(-1, -1, maxlen + 1))
            comp_len = torch.gather(all_len, 1, top)
            # -- expand continuations (skip unk/eos) ------------------
            cand = scores[:, :, None] + logp
            cand[:, :, unk] = NEG_INF
            cand[:, :, eos] = NEG_INF
            v1, i1 = top_k(cand.reshape(B * beam, V), beam)
            scores, idx2 = top_k(v1.reshape(B, beam * beam), beam)
            parent = idx2 // beam
            token = torch.gather(i1.reshape(B, beam * beam), 1, idx2)
            tok_buf = torch.gather(
                tok_buf, 1, parent[:, :, None].expand(-1, -1, maxlen + 1))
            tok_buf[:, :, l + 1] = token
            src_rows = (rows + parent).reshape(B * beam)
            self_kv = tuple((k.index_select(0, src_rows),
                             v.index_select(0, src_rows))
                            for k, v in self_kv)
            n_steps = l + 1
        return BeamRaw(comp_scores, comp_buf, comp_len, n_steps)

    @staticmethod
    def beam_results(raw: BeamRaw, valid) -> List[BeamResult]:
        """Fetch one decoded batch to the host and convert it."""
        return completions_to_results(
            raw.comp_scores.cpu().numpy(), raw.comp_buf.cpu().numpy(),
            raw.comp_len.cpu().numpy(), np.asarray(valid.cpu()))

    def beam_batch(self, batch: DeviceBatch) -> List[BeamResult]:
        """Beam-decode every row; one BeamResult per *valid* row."""
        return self.beam_results(self.beam_batch_raw(batch), batch.valid)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def greedy_tokens(self, batch: DeviceBatch) -> torch.Tensor:
        """(B, maxlen+1) tokens with the <sos> prefix; with early_stop the
        loop ends once every row has emitted <eos>."""
        maxlen = self.cfg.maxlen
        dev = batch.query.device
        B = batch.query.shape[0]
        state = self._decode_state(batch)
        self_kv = self.model.init_self_kv(B, maxlen, dev)
        toks = torch.full((B, maxlen + 1), self.pad, dtype=torch.int64,
                          device=dev)
        toks[:, 0] = self.sos
        for l in range(maxlen):
            if self.cfg.early_stop and \
                    bool((toks[:, 1:] == self.eos).any(dim=1).all()):
                break
            logp, self_kv = self._step(state, toks[:, l], l, self_kv)
            toks[:, l + 1] = torch.argmax(logp, dim=-1)
        return toks

    def greedy_batch(self, batch: DeviceBatch) -> List[List[int]]:
        """Greedy-decode every row; tokens after <sos>, cut at <eos>."""
        toks = self.greedy_tokens(batch).cpu().numpy()
        valid = np.asarray(batch.valid.cpu())
        out = []
        for b in range(toks.shape[0]):
            if not valid[b]:
                continue
            row = []
            for t in toks[b, 1:]:
                if int(t) == self.eos:
                    break
                row.append(int(t))
            out.append(row)
        return out

