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
:func:`top_k` takes a stable descending sort. Each loop's body is a
function of :mod:`mtn_tpu_torch.decode.steps` at a 0-d tensor position,
the function that :mod:`mtn_tpu_torch.utils.aot` exports.

Two ways to run a batch. On a CUDA device without a mesh, beam, greedy,
sample and rank batches run as captured device programs
(:mod:`mtn_tpu_torch.decode.graphs`, the counterpart of JAX's jitted
decoders), with the early-stop test on the device and read once every
few steps; a shape's first batch, and a shape the runner's cache does
not admit, runs the eager loop. Everywhere else (the CPU, a mesh, whose
collectives go over gloo and cannot be captured) the eager loops run
(:meth:`BeamDecoder.beam_eager`, :meth:`~BeamDecoder.tokens_eager`,
:meth:`~BeamDecoder.rank_eager`), their early-stop test on the host:
one device-to-host sync per step. The two give bitwise equal results;
streaming is always eager (each step goes to the host anyway).

Sampling transforms the step's log-probs exactly as JAX's
``_sample_transform`` does (temperature, top-k, top-p, in f32) and draws
by the law of ``jax.random.categorical``: the argmax of logits plus
Gumbel noise. The noise of step ``l`` comes from a generator on the
batch's device seeded with a 64-bit mix of (``sample_seed``, fold, l), so
a draw depends on the position, not on how many steps ran: early stop
and streaming cannot change it. The draws are not JAX's bit for bit.

Under a mesh (``shardings``): each data rank decodes its rows of the
turn batch (``Shardings.put_host_batch``), and the results are gathered
so that every rank holds the whole batch's, as JAX's ``_gather``
(``valid`` rows through :meth:`BeamDecoder.gather_rows`). A rank's loop
stops when its own rows are done: a row that the early-stop test has
closed cannot change, so the rows equal the single-device decode's.
Sampling draws the whole batch's noise and takes this rank's rows of it,
so a sample does not depend on the mesh. Under ``model`` every rank
runs the same rows on the same gathered log-probs, so their loops take
the same decisions. A stream gathers each step's tokens over ``data``,
and every rank takes its stop test from the gathered rows: a rank that
stopped on its own rows would leave the others waiting in the gather.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mtn_tpu_torch.config import DecodeConfig
from mtn_tpu_torch.data.vocab import SPECIALS
from mtn_tpu_torch.decode.steps import (NEG_INF, BeamResult,  # noqa: F401
                                        all_ended, beam_init, beam_open,
                                        beam_step, completions_to_results,
                                        cut_rows, detokenize, draw_seed,
                                        gumbel_argmax, gumbel_uniforms,
                                        rank_inputs, rank_step,
                                        sample_transform, token_init,
                                        token_step, top_k)
from mtn_tpu_torch.decode.graphs import GraphRunner
from mtn_tpu_torch.models.mtn import MTN, DecodeState
from mtn_tpu_torch.parallel.collectives import gather_rows
from mtn_tpu_torch.train.batch import DeviceBatch, batch_masks


def _round_up_int(n: int, m: int) -> int:
    return n if m <= 1 else -(-n // m) * m


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
                 eos: int = SPECIALS["<eos>"], unk: int = SPECIALS["<unk>"],
                 shardings=None):
        self.model = model
        self.cfg = decode_cfg
        self.pad, self.sos, self.eos, self.unk = pad, sos, eos, unk
        self.data = shardings.data if shardings is not None else None
        self.model_axis = shardings.model if shardings is not None else None
        self.graphs = GraphRunner()

    def graphed(self, t: torch.Tensor) -> bool:
        """Whether a decode of tensors like ``t`` runs as captured
        programs: on a CUDA device, without a mesh axis (a mesh's
        collectives go over gloo, which a graph cannot hold)."""
        return t.is_cuda and self.data is None and self.model_axis is None

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The rows of every data rank (``t`` itself without a data
        axis)."""
        return t if self.data is None else gather_rows(t, self.data)

    def _local(self, B: int) -> slice:
        """This data rank's rows among the whole batch's."""
        r = self.data.rank if self.data is not None else 0
        return slice(r * B, (r + 1) * B)

    def _decode_state(self, batch: DeviceBatch) -> DecodeState:
        masks, _ = batch_masks(batch, self.pad)
        return self.model.init_decode_state(batch.query, batch.his,
                                            batch.cap, batch.fts, masks)

    def _step(self, state, tokens, pos, self_kv):
        return self.model.decode_step(state, tokens, pos, self_kv)

    def _stepper(self, state):
        """The ``step(tokens, pos, self_kv)`` callable of
        :mod:`~mtn_tpu_torch.decode.steps` on this batch's state."""
        return lambda tokens, pos, self_kv: self._step(state, tokens, pos,
                                                       self_kv)

    @staticmethod
    def _positions(n: int, device) -> torch.Tensor:
        """0-d int64 positions come from this (n,) tensor: one transfer
        per loop, none per step."""
        return torch.arange(n, device=device)

    def token_prefix(self, batch: DeviceBatch):
        """(state, zeroed KV caches) of a greedy, sample or stream
        decode."""
        return (self._decode_state(batch),
                self.model.init_self_kv(batch.query.shape[0],
                                        self.cfg.maxlen, batch.query.device))

    def beam_prefix(self, batch: DeviceBatch):
        """(state, carry) before a beam loop's step 0: the state tiled
        over the beam (row b*beam+k is turn b), and :func:`beam_init`'s
        carry followed by the zeroed KV caches."""
        cfg = self.cfg
        dev = batch.query.device
        B = batch.query.shape[0]
        state = self._decode_state(batch).map(
            lambda x: x.repeat_interleave(cfg.beam, dim=0))
        self_kv = self.model.init_self_kv(B * cfg.beam, cfg.maxlen, dev)
        return state, (*beam_init(B, cfg, dev, self.pad, self.sos), self_kv)

    def rank_prefix(self, batch: DeviceBatch, cand: torch.Tensor,
                    cand_len: torch.Tensor):
        """(state, self_kv, rows, inputs, lens, total) before the rank
        loop over (B, N, L) candidates: the state tiled over the N
        candidates (row b*N+n is turn b), the zeroed KV caches, the
        targets and ``<sos> + cand[:, :-1]`` (:func:`rank_inputs`), the
        lengths by row and the zeroed f32 sums."""
        B, N, L = cand.shape
        state = self._decode_state(batch).map(
            lambda x: x.repeat_interleave(N, dim=0))
        self_kv = self.model.init_self_kv(B * N, L, cand.device)
        rows, inputs = rank_inputs(cand, self.sos)
        total = torch.zeros(B * N, dtype=torch.float32, device=cand.device)
        return state, self_kv, rows, inputs, cand_len.reshape(B * N), total

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def beam_batch_raw(self, batch: DeviceBatch) -> BeamRaw:
        """One beam-decoded batch on the device: captured programs where
        :meth:`graphed`, else :meth:`beam_eager`."""
        if self.graphed(batch.query):
            return self.graphs.beam(self, batch)
        return self.beam_eager(batch)

    @torch.inference_mode()
    def beam_eager(self, batch: DeviceBatch) -> BeamRaw:
        """The eager beam loop, its early-stop test on the host."""
        cfg = self.cfg
        state, (*carry, self_kv) = self.beam_prefix(batch)
        step = self._stepper(state)
        pos = self._positions(cfg.maxlen, batch.query.device)
        n_steps = 0
        for l in range(cfg.maxlen):
            if cfg.early_stop and not beam_open(carry[1], carry[2], pos[l],
                                                cfg):
                break
            *carry, self_kv = beam_step(step, pos[l], *carry, self_kv, cfg,
                                        self.eos, self.unk)
            n_steps = l + 1
        return BeamRaw(*map(self.gather_rows, carry[2:5]), n_steps)

    @staticmethod
    def beam_results(raw: BeamRaw, valid) -> List[BeamResult]:
        """Fetch one decoded batch to the host and convert it."""
        return completions_to_results(
            raw.comp_scores.cpu().numpy(), raw.comp_buf.cpu().numpy(),
            raw.comp_len.cpu().numpy(), np.asarray(valid.cpu()))

    def beam_batch(self, batch: DeviceBatch) -> List[BeamResult]:
        """Beam-decode every row; one BeamResult per *valid* row."""
        return self.beam_results(self.beam_batch_raw(batch),
                                 self.gather_rows(batch.valid))

    # ------------------------------------------------------------------
    def sample_transform(self, logp: torch.Tensor) -> torch.Tensor:
        """:func:`~mtn_tpu_torch.decode.steps.sample_transform` under this
        decoder's config."""
        return sample_transform(logp, self.cfg)

    def _uniforms(self, style: str, fold: int, B: int, device
                  ) -> Callable[[int], Optional[torch.Tensor]]:
        """The noise of one decode by position: None for greedy (and for
        sampling at temperature <= 0, which is argmax), else the (B, V)
        uniforms keyed by (seed, fold, position)."""
        if style == "greedy" or self.cfg.temperature <= 0.0:
            return lambda l: None
        seed, V = self.cfg.sample_seed, self.model.cfg.vocab_size
        rows = B * (self.data.size if self.data is not None else 1)
        return lambda l: gumbel_uniforms((rows, V), draw_seed(seed, fold, l),
                                         device)[self._local(B)]

    @torch.inference_mode()
    def _token_loop(self, batch: DeviceBatch, style: str,
                    fold: int) -> torch.Tensor:
        """(B, maxlen+1) tokens with the <sos> prefix: captured programs
        where :meth:`graphed`, else :meth:`tokens_eager`."""
        if self.graphed(batch.query):
            return self.graphs.tokens(self, batch, style, fold)
        return self.tokens_eager(batch, style, fold)

    @torch.inference_mode()
    def tokens_eager(self, batch: DeviceBatch, style: str,
                     fold: int) -> torch.Tensor:
        """The eager token loop: (B, maxlen+1) tokens with the <sos>
        prefix, one :func:`token_step` per position, gathered over the
        data ranks; with early_stop the loop ends once every row has
        emitted <eos> (tokens after a row's first <eos> are never read)."""
        maxlen = self.cfg.maxlen
        dev = batch.query.device
        B = batch.query.shape[0]
        state, self_kv = self.token_prefix(batch)
        step = self._stepper(state)
        uniforms = self._uniforms(style, fold, B, dev)
        pos = self._positions(maxlen, dev)
        toks = token_init(B, maxlen, dev, self.pad, self.sos)
        for l in range(maxlen):
            if self.cfg.early_stop and all_ended(toks, self.eos):
                break
            toks[:, l + 1] = token_step(step, pos[l], toks[:, l], self_kv,
                                        uniforms(l), self.cfg)
        return self.gather_rows(toks)

    def greedy_tokens(self, batch: DeviceBatch) -> torch.Tensor:
        return self._token_loop(batch, "greedy", 0)

    def sample_tokens(self, batch: DeviceBatch,
                      fold: int = 0) -> torch.Tensor:
        """Ancestral sampling; ``fold`` (the caller's batch counter) keeps
        batches of one seeded run from reusing the same noise."""
        return self._token_loop(batch, "sample", fold)

    def greedy_batch(self, batch: DeviceBatch) -> List[List[int]]:
        """Greedy-decode every row; tokens after <sos>, cut at <eos>."""
        return cut_rows(self.greedy_tokens(batch),
                        self.gather_rows(batch.valid), self.eos)

    def sample_batch(self, batch: DeviceBatch,
                     fold: int = 0) -> List[List[int]]:
        """Sample one continuation per row (``greedy_batch``'s output)."""
        return cut_rows(self.sample_tokens(batch, fold),
                        self.gather_rows(batch.valid), self.eos)

    # -- streaming ------------------------------------------------------
    def stream_tokens(self, batch: DeviceBatch, style: str = "greedy",
                      fold: int = 0) -> Iterator[np.ndarray]:
        """Generator of per-step token arrays (one int per *valid* row),
        ending after every valid row has emitted <eos> or at maxlen.

        A row's yields, cut at its first <eos>, equal its greedy_batch /
        sample_batch output (same step, same next-token rule). Each step
        costs one device-to-host copy: tokens appear as they are decoded.
        Under a data axis the rows are the whole batch's, gathered at
        every step, and every rank yields them."""
        if style not in ("greedy", "sample"):
            raise ValueError(f"stream_tokens: style {style!r} "
                             "(beam n-bests cannot stream)")
        dev = batch.query.device
        B = batch.query.shape[0]
        with torch.inference_mode():
            state, self_kv = self.token_prefix(batch)
            pos = self._positions(self.cfg.maxlen, dev)
        step = self._stepper(state)
        uniforms = self._uniforms(style, fold, B, dev)
        valid = np.asarray(self.gather_rows(batch.valid).cpu())
        cur = torch.full((B,), self.sos, dtype=torch.int64, device=dev)
        done = ~valid
        for l in range(self.cfg.maxlen):
            with torch.inference_mode():
                cur = token_step(step, pos[l], cur, self_kv, uniforms(l),
                                 self.cfg)
                host = self.gather_rows(cur).cpu().numpy()
            yield host[valid]
            done |= host == self.eos
            if done.all():
                return

    # -- discriminative candidate ranking --------------------------------
    @torch.inference_mode()
    def _rank(self, batch: DeviceBatch, cand: torch.Tensor,
              cand_len: torch.Tensor) -> torch.Tensor:
        """(B, N) log-likelihoods of the candidates: captured programs
        where :meth:`graphed`, else :meth:`rank_eager`."""
        if self.graphed(cand):
            return self.graphs.rank(self, batch, cand, cand_len)
        return self.rank_eager(batch, cand, cand_len)

    @torch.inference_mode()
    def rank_eager(self, batch: DeviceBatch, cand: torch.Tensor,
                   cand_len: torch.Tensor) -> torch.Tensor:
        """Teacher-forced log-likelihood of (B, N, L) candidates: the
        per-turn state tiled over the N candidates (row b*N+n is turn b),
        ``<sos> + cand[:, :-1]`` fed through the cached decode step, and
        log P(target) summed in f32 over positions l < length."""
        B, N, L = cand.shape
        state, self_kv, rows, inputs, lens, total = self.rank_prefix(
            batch, cand, cand_len)
        step = self._stepper(state)
        pos = self._positions(L, cand.device)
        for l in range(L):
            total = rank_step(step, pos[l], rows, inputs, lens, total,
                              self_kv)
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
        return self.rank_results(raw, self.gather_rows(batch.valid))

    def rank_batch_raw(self, batch: DeviceBatch,
                       candidates: Sequence[Sequence[Sequence[int]]],
                       include_eos: bool = True, len_bucket: int = 8,
                       cand_bucket: int = 8
                       ) -> Tuple[Optional[torch.Tensor], List[int]]:
        """(device scores (B, N) or None, candidate count per row). Under
        a data axis ``candidates`` has a row for every row of the whole
        batch, and the scores are the whole batch's."""
        B = batch.query.shape[0]
        rows = B * (self.data.size if self.data is not None else 1)
        if len(candidates) != rows:
            raise ValueError(
                f"candidates has {len(candidates)} rows, batch has {rows}")
        n_counts = [len(c) for c in candidates]
        n_max = max(n_counts, default=0)
        if n_max == 0:
            return None, n_counts
        extra = 1 if include_eos else 0
        l_max = max((len(t) for c in candidates for t in c), default=0) + extra
        N = max(_round_up_int(n_max, cand_bucket), 1)
        L = max(_round_up_int(max(l_max, 1), len_bucket), 1)
        cand = np.full((rows, N, L), self.pad, np.int64)
        clen = np.zeros((rows, N), np.int64)
        for b, cands in enumerate(candidates):
            for n, toks in enumerate(cands):
                toks = list(toks) + ([self.eos] if include_eos else [])
                cand[b, n, :len(toks)] = toks
                clen[b, n] = len(toks)
        dev = batch.query.device
        mine = self._local(B)
        return (self.gather_rows(self._rank(
            batch, torch.from_numpy(cand[mine]).to(dev),
            torch.from_numpy(clen[mine]).to(dev))), n_counts)

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
