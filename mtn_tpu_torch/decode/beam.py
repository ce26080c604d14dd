"""Batched beam, greedy, sample, streaming and rank decoding with KV and
auto-encoder caches (``mtn_tpu/decode/beam.py``).

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

Sampling transforms the step's log-probs exactly as JAX's
``_sample_transform`` does (temperature, top-k, top-p, in f32) and draws
by the law of ``jax.random.categorical``: the argmax of logits plus
Gumbel noise. The noise of step ``l`` comes from a generator on the
batch's device seeded with a 64-bit mix of (``sample_seed``, fold, l), so
a draw depends on the position, not on how many steps ran: early stop
and streaming cannot change it. The draws are not JAX's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mtn_tpu_torch.config import DecodeConfig
from mtn_tpu_torch.data.vocab import SPECIALS
from mtn_tpu_torch.models.mtn import MTN, DecodeState
from mtn_tpu_torch.train.batch import DeviceBatch, batch_masks

NEG_INF = -1.0e30
_MASK64 = (1 << 64) - 1


def _round_up_int(n: int, m: int) -> int:
    return n if m <= 1 else -(-n // m) * m


def draw_seed(seed: int, fold: int, pos: int) -> int:
    """A 64-bit seed mixed from (seed, fold, position): splitmix64's
    finaliser over each integer in turn."""
    h = 0x9E3779B97F4A7C15
    for x in (seed, fold, pos):
        h = ((h ^ (x & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 31)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h


def gumbel_argmax(logits: torch.Tensor, seed: int) -> torch.Tensor:
    """One draw per row from ``softmax(logits)``: the argmax of logits
    plus Gumbel noise from a generator on the logits' device seeded with
    ``seed`` (``jax.random.categorical``'s law; uniforms kept above f32's
    smallest normal, as ``jax.random.gumbel`` keeps them)."""
    gen = torch.Generator(device=logits.device)
    gen.manual_seed(seed)
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


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
    def sample_transform(self, logp: torch.Tensor) -> torch.Tensor:
        """The temperature / top-k / top-p transform of (B, V) f32
        log-probs (JAX's ``_sample_transform``): entries below the k-th
        value and outside the nucleus become ``NEG_INF``; ties at the k-th
        value survive, and the nucleus keeps a token while the mass before
        it, in ``lax.top_k`` order, is below ``top_p``."""
        cfg = self.cfg
        # a 0-d tensor: CUDA divides by a Python scalar as a product with
        # its reciprocal, which is not JAX's division to the bit
        temp = torch.full((), max(cfg.temperature, 1e-6),
                          dtype=torch.float32, device=logp.device)
        logits = logp / temp
        if cfg.top_k and cfg.top_k > 0:
            k = min(int(cfg.top_k), logits.shape[-1])
            kth = top_k(logits, k)[0][:, -1:]
            logits = torch.where(logits < kth, NEG_INF, logits)
        if cfg.top_p and cfg.top_p > 0.0:
            srt, idx = top_k(logits, logits.shape[-1])
            probs = torch.softmax(srt, dim=-1)
            keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < cfg.top_p
            keep = torch.zeros_like(keep_sorted).scatter(1, idx, keep_sorted)
            logits = torch.where(keep, logits, NEG_INF)
        return logits

    def _chooser(self, style: str,
                 fold: int) -> Callable[[torch.Tensor, int], torch.Tensor]:
        """The next-token rule of one decode: argmax for greedy (and for
        sampling at temperature <= 0), else a draw keyed by (seed, fold,
        position)."""
        if style == "greedy" or self.cfg.temperature <= 0.0:
            return lambda logp, l: torch.argmax(logp, dim=-1)
        seed = self.cfg.sample_seed
        return lambda logp, l: gumbel_argmax(self.sample_transform(logp),
                                             draw_seed(seed, fold, l))

    @torch.inference_mode()
    def _token_loop(self, batch: DeviceBatch, choose) -> torch.Tensor:
        """(B, maxlen+1) tokens with the <sos> prefix, one ``choose`` per
        step; with early_stop the loop ends once every row has emitted
        <eos> (tokens after a row's first <eos> are never read)."""
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
            toks[:, l + 1] = choose(logp, l)
        return toks

    def greedy_tokens(self, batch: DeviceBatch) -> torch.Tensor:
        return self._token_loop(batch, self._chooser("greedy", 0))

    def sample_tokens(self, batch: DeviceBatch,
                      fold: int = 0) -> torch.Tensor:
        """Ancestral sampling; ``fold`` (the caller's batch counter) keeps
        batches of one seeded run from reusing the same noise."""
        return self._token_loop(batch, self._chooser("sample", fold))

    def _cut_rows(self, toks: torch.Tensor, valid) -> List[List[int]]:
        """Tokens after <sos> of every valid row, cut at <eos>."""
        toks = toks.cpu().numpy()
        valid = np.asarray(valid.cpu())
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

    def greedy_batch(self, batch: DeviceBatch) -> List[List[int]]:
        """Greedy-decode every row; tokens after <sos>, cut at <eos>."""
        return self._cut_rows(self.greedy_tokens(batch), batch.valid)

    def sample_batch(self, batch: DeviceBatch,
                     fold: int = 0) -> List[List[int]]:
        """Sample one continuation per row (``greedy_batch``'s output)."""
        return self._cut_rows(self.sample_tokens(batch, fold), batch.valid)

    # -- streaming ------------------------------------------------------
    def stream_tokens(self, batch: DeviceBatch, style: str = "greedy",
                      fold: int = 0) -> Iterator[np.ndarray]:
        """Generator of per-step token arrays (one int per *valid* row),
        ending after every valid row has emitted <eos> or at maxlen.

        A row's yields, cut at its first <eos>, equal its greedy_batch /
        sample_batch output (same step, same next-token rule). Each step
        costs one device-to-host copy: tokens appear as they are decoded."""
        if style not in ("greedy", "sample"):
            raise ValueError(f"stream_tokens: style {style!r} "
                             "(beam n-bests cannot stream)")
        choose = self._chooser(style, fold)
        dev = batch.query.device
        B = batch.query.shape[0]
        with torch.inference_mode():
            state = self._decode_state(batch)
            self_kv = self.model.init_self_kv(B, self.cfg.maxlen, dev)
        valid = np.asarray(batch.valid.cpu())
        cur = torch.full((B,), self.sos, dtype=torch.int64, device=dev)
        done = ~valid
        for l in range(self.cfg.maxlen):
            with torch.inference_mode():
                logp, self_kv = self._step(state, cur, l, self_kv)
                cur = choose(logp, l)
            host = cur.cpu().numpy()
            yield host[valid]
            done |= host == self.eos
            if done.all():
                return

    # -- discriminative candidate ranking --------------------------------
    @torch.inference_mode()
    def _rank(self, batch: DeviceBatch, cand: torch.Tensor,
              cand_len: torch.Tensor) -> torch.Tensor:
        """Teacher-forced log-likelihood of (B, N, L) candidates: the
        per-turn state tiled over the N candidates (row b*N+n is turn b),
        ``<sos> + cand[:, :-1]`` fed through the cached decode step, and
        log P(target) summed in f32 over positions l < length."""
        B, N, L = cand.shape
        state = self._decode_state(batch).map(
            lambda x: x.repeat_interleave(N, dim=0))
        self_kv = self.model.init_self_kv(B * N, L, cand.device)
        rows = cand.reshape(B * N, L)
        lens = cand_len.reshape(B * N)
        inputs = torch.cat([torch.full_like(rows[:, :1], self.sos),
                            rows[:, :-1]], dim=1)
        total = torch.zeros(B * N, dtype=torch.float32, device=cand.device)
        for l in range(L):
            logp, self_kv = self._step(state, inputs[:, l], l, self_kv)
            tok_lp = torch.gather(logp, 1, rows[:, l:l + 1])[:, 0]
            total = total + torch.where(l < lens, tok_lp, 0.0)
        return total.reshape(B, N)

    def rank_batch(self, batch: DeviceBatch,
                   candidates: Sequence[Sequence[Sequence[int]]],
                   include_eos: bool = True, len_bucket: int = 8,
                   cand_bucket: int = 8) -> List[List[float]]:
        """Score answer candidates by generative log-likelihood.

        ``candidates[b]`` is the list of candidate token-id sequences for
        batch row b (one entry per row, valid or not). Returns, per
        *valid* row, ``[log P(candidate | context), ...]`` in input order.
        ``include_eos`` appends <eos> to every candidate (the answer event
        the loss trains). N and L round up to ``cand_bucket`` and
        ``len_bucket`` as in JAX, so the decode step sees JAX's shapes;
        padded candidates score 0 and are dropped."""
        raw = self.rank_batch_raw(batch, candidates, include_eos=include_eos,
                                  len_bucket=len_bucket,
                                  cand_bucket=cand_bucket)
        return self.rank_results(raw, batch.valid)

    def rank_batch_raw(self, batch: DeviceBatch,
                       candidates: Sequence[Sequence[Sequence[int]]],
                       include_eos: bool = True, len_bucket: int = 8,
                       cand_bucket: int = 8
                       ) -> Tuple[Optional[torch.Tensor], List[int]]:
        """(device scores (B, N) or None, candidate count per row)."""
        B = batch.query.shape[0]
        if len(candidates) != B:
            raise ValueError(
                f"candidates has {len(candidates)} rows, batch has {B}")
        n_counts = [len(c) for c in candidates]
        n_max = max(n_counts, default=0)
        if n_max == 0:
            return None, n_counts
        extra = 1 if include_eos else 0
        l_max = max((len(t) for c in candidates for t in c), default=0) + extra
        N = max(_round_up_int(n_max, cand_bucket), 1)
        L = max(_round_up_int(max(l_max, 1), len_bucket), 1)
        cand = np.full((B, N, L), self.pad, np.int64)
        clen = np.zeros((B, N), np.int64)
        for b, cands in enumerate(candidates):
            for n, toks in enumerate(cands):
                toks = list(toks) + ([self.eos] if include_eos else [])
                cand[b, n, :len(toks)] = toks
                clen[b, n] = len(toks)
        dev = batch.query.device
        return (self._rank(batch, torch.from_numpy(cand).to(dev),
                           torch.from_numpy(clen).to(dev)), n_counts)

    @staticmethod
    def rank_results(raw, valid) -> List[List[float]]:
        """Fetch one ranked batch and trim it to the valid rows and each
        row's candidate count."""
        scores, n_counts = raw
        valid = np.asarray(valid.cpu())
        if scores is None:  # no candidates anywhere in the batch
            return [[] for b in range(len(n_counts)) if valid[b]]
        scores = scores.cpu().numpy()
        return [[float(s) for s in scores[b][:n_counts[b]]]
                for b in range(len(n_counts)) if valid[b]]
