"""The decode loops' bodies as pure functions of tensors.

One step of each decode mode — beam (:func:`beam_step`), greedy and
sample (:func:`token_step`) and teacher-forced ranking
(:func:`rank_step`) — takes the position as a 0-d int64 tensor and every
carried value as a tensor, and reaches the model only through the
``step(tokens, pos, self_kv) -> (logp, self_kv)`` callable it is given.
:class:`~mtn_tpu_torch.decode.beam.BeamDecoder`'s live loops call these
functions, and :mod:`mtn_tpu_torch.utils.aot` exports the same
functions with ``torch.export``, so an artifact cannot drift from the
live path. The early-stop tests come in two forms: as 0-d bool tensors
on the device (:func:`beam_open_t`, :func:`all_ended_t`), which the
masked steps (:func:`beam_step_masked`, :func:`token_step_at`) carry
as JAX's ``lax.while_loop`` carries its condition, so that
:mod:`mtn_tpu_torch.decode.graphs` runs many steps between two host
reads; and as host booleans (:func:`beam_open`, :func:`all_ended`), one
device-to-host read per step, for the loops that stay eager.

Sampling is split the same way: :func:`gumbel_uniforms` draws the
step's uniforms from a generator seeded with :func:`draw_seed` (on the
host side of an exported program), :func:`gumbel_pick` turns them into
a draw (inside it).

This module imports nothing of the model, so an artifact's session
loads without it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch

from mtn_tpu_torch.config import DecodeConfig
from mtn_tpu_torch.data.vocab import SPECIALS

NEG_INF = -1.0e30
_MASK64 = (1 << 64) - 1

Step = Callable[[torch.Tensor, torch.Tensor, tuple],
                Tuple[torch.Tensor, tuple]]


def draw_seed(seed: int, fold: int, pos: int) -> int:
    """A 64-bit seed mixed from (seed, fold, position): splitmix64's
    finaliser over each integer in turn."""
    h = 0x9E3779B97F4A7C15
    for x in (seed, fold, pos):
        h = ((h ^ (x & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 31)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h


def gumbel_uniforms(shape, seed: int, device) -> torch.Tensor:
    """f32 uniforms in [0, 1) of ``shape`` from a generator on ``device``
    seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32)


def gumbel_pick(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The argmax of logits plus the Gumbel noise of uniforms ``u``
    (kept above f32's smallest normal, as ``jax.random.gumbel`` keeps
    them)."""
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def gumbel_argmax(logits: torch.Tensor, seed: int) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` (``jax.random.
    categorical``'s law), its noise from a generator on the logits'
    device seeded with ``seed``."""
    return gumbel_pick(logits, gumbel_uniforms(logits.shape, seed,
                                               logits.device))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, lower index first among equal values
    (the ``lax.top_k`` order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def sample_transform(logp: torch.Tensor, cfg: DecodeConfig) -> torch.Tensor:
    """The temperature / top-k / top-p transform of (B, V) f32 log-probs
    (JAX's ``_sample_transform``): entries below the k-th value and
    outside the nucleus become ``NEG_INF``; ties at the k-th value
    survive, and the nucleus keeps a token while the mass before it, in
    ``lax.top_k`` order, is below ``top_p``."""
    # a 0-d tensor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which is not JAX's division to the bit
    temp = torch.full((), max(cfg.temperature, 1e-6), dtype=torch.float32,
                      device=logp.device)
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


def cut_rows(toks, valid, eos: int) -> List[List[int]]:
    """Tokens after <sos> of every valid row of (B, maxlen+1) ``toks``,
    cut at <eos> (numpy or tensors)."""
    toks = np.asarray(toks.cpu() if torch.is_tensor(toks) else toks)
    valid = np.asarray(valid.cpu() if torch.is_tensor(valid) else valid)
    out = []
    for b in range(toks.shape[0]):
        if not valid[b]:
            continue
        row = []
        for t in toks[b, 1:]:
            if int(t) == eos:
                break
            row.append(int(t))
        out.append(row)
    return out


# -- beam ----------------------------------------------------------------------
def beam_init(B: int, cfg: DecodeConfig, device, pad: int = SPECIALS[
        "<blank>"], sos: int = SPECIALS["<sos>"]):
    """The beam loop's carry before step 0: ``(tok_buf (B, beam,
    maxlen+1), scores (B, beam), comp_scores (B, nbest), comp_buf (B,
    nbest, maxlen+1), comp_len (B, nbest))``, one live hypothesis a
    row."""
    beam, nbest, width = cfg.beam, cfg.nbest, cfg.maxlen + 1
    tok_buf = torch.full((B, beam, width), pad, dtype=torch.int64,
                         device=device)
    tok_buf[:, :, 0] = sos
    scores = torch.full((B, beam), NEG_INF, dtype=torch.float32,
                        device=device)
    scores[:, 0] = 0.0
    comp_scores = torch.full((B, nbest), NEG_INF, dtype=torch.float32,
                             device=device)
    comp_buf = torch.full((B, nbest, width), pad, dtype=torch.int64,
                          device=device)
    comp_len = torch.zeros((B, nbest), dtype=torch.int64, device=device)
    return tok_buf, scores, comp_scores, comp_buf, comp_len


def beam_open_t(scores: torch.Tensor, comp_scores: torch.Tensor,
                l: torch.Tensor, cfg: DecodeConfig) -> torch.Tensor:
    """Whether a live hypothesis can still enter some row's n-best at
    step ``l`` (a 0-d int64 tensor), as a 0-d bool tensor on the scores'
    device. A completion recorded during step l' scores at most
    score_active + penalty·(l'+1), and active scores only decay: the
    bound adds ``penalty·maxlen`` if ``penalty >= 0``, else
    ``penalty·(l+1)``, each in double and rounded to f32 once, as a
    Python scalar is."""
    if cfg.penalty >= 0.0:
        future = cfg.penalty * cfg.maxlen
    else:
        future = ((l + 1).to(torch.float64) * cfg.penalty).to(torch.float32)
    bound = scores.max(dim=1).values + future
    return (bound >= comp_scores[:, -1]).any()


def beam_open(scores: torch.Tensor, comp_scores: torch.Tensor, l,
              cfg: DecodeConfig) -> bool:
    """:func:`beam_open_t` read to the host (one device-to-host read);
    ``l`` an ``int`` or a 0-d int64 tensor."""
    if not torch.is_tensor(l) and cfg.penalty < 0.0:
        l = torch.tensor(l, dtype=torch.int64, device=scores.device)
    return bool(beam_open_t(scores, comp_scores, l, cfg))


def beam_step(step: Step, l: torch.Tensor, tok_buf, scores, comp_scores,
              comp_buf, comp_len, self_kv, cfg: DecodeConfig,
              eos: int = SPECIALS["<eos>"], unk: int = SPECIALS["<unk>"]):
    """One beam step at position ``l`` (0-d int64): every live hypothesis
    expanded, completions recorded into the n-best pool, the next beam
    taken in two top-k stages and the self-attention KV cache reordered
    by parent. Returns the new ``(tok_buf, scores, comp_scores,
    comp_buf, comp_len, self_kv)``."""
    B, beam, width = tok_buf.shape
    nbest = comp_scores.shape[1]
    pos = l.reshape(1)
    cur = tok_buf.index_select(2, pos).reshape(B * beam)
    logp, self_kv = step(cur, l, self_kv)
    V = logp.shape[-1]
    logp = logp.reshape(B, beam, V)
    # -- record completions -----------------------------------------------
    # the length reward f32(penalty)·f32(l+1), as JAX multiplies it
    reward = (l + 1).to(torch.float32) * float(np.float32(cfg.penalty))
    eos_sc = scores + logp[:, :, eos] + reward
    eos_sc = torch.where(l < cfg.min_len, NEG_INF, eos_sc)
    all_sc = torch.cat([comp_scores, eos_sc], dim=1)
    all_buf = torch.cat([comp_buf, tok_buf], dim=1)
    all_len = torch.cat([comp_len, l.expand(B, beam)], dim=1)
    comp_scores, top = top_k(all_sc, nbest)
    comp_buf = torch.gather(all_buf, 1,
                            top[:, :, None].expand(-1, -1, width))
    comp_len = torch.gather(all_len, 1, top)
    # -- expand continuations (skip unk/eos) ------------------------------
    cand = scores[:, :, None] + logp
    cand[:, :, unk] = NEG_INF
    cand[:, :, eos] = NEG_INF
    v1, i1 = top_k(cand.reshape(B * beam, V), beam)
    scores, idx2 = top_k(v1.reshape(B, beam * beam), beam)
    parent = idx2 // beam
    token = torch.gather(i1.reshape(B, beam * beam), 1, idx2)
    tok_buf = torch.gather(tok_buf, 1,
                           parent[:, :, None].expand(-1, -1, width))
    tok_buf.index_copy_(2, pos + 1, token[:, :, None])
    rows = torch.arange(B, device=tok_buf.device)[:, None] * beam
    src_rows = (rows + parent).reshape(B * beam)
    self_kv = tuple((k.index_select(0, src_rows), v.index_select(0, src_rows))
                    for k, v in self_kv)
    return tok_buf, scores, comp_scores, comp_buf, comp_len, self_kv


def beam_step_masked(step: Step, l: torch.Tensor, tok_buf, scores,
                     comp_scores, comp_buf, comp_len, self_kv,
                     alive: torch.Tensor, n_steps: torch.Tensor,
                     cfg: DecodeConfig, eos: int = SPECIALS["<eos>"],
                     unk: int = SPECIALS["<unk>"]):
    """One step of the early-stopped beam loop with its exit on the
    device, the body of JAX's ``lax.while_loop``: ``alive`` (a 0-d bool
    tensor, or ``True``) becomes ``alive & beam_open_t(l)`` before the
    step, the completion pool takes the step's values only where
    ``alive`` holds, and
    ``n_steps`` (0-d int64) counts the steps run while alive. Once the
    test has failed, the pool stays bitwise what it was at the exit,
    whatever the steps after it compute, and ``n_steps`` is the step
    count of JAX's loop. Returns :func:`beam_step`'s tuple, then
    ``alive`` and ``n_steps``."""
    alive = alive & beam_open_t(scores, comp_scores, l, cfg)
    tok_buf, scores, new_sc, new_buf, new_len, self_kv = beam_step(
        step, l, tok_buf, scores, comp_scores, comp_buf, comp_len, self_kv,
        cfg, eos, unk)
    return (tok_buf, scores, torch.where(alive, new_sc, comp_scores),
            torch.where(alive, new_buf, comp_buf),
            torch.where(alive, new_len, comp_len), self_kv, alive,
            n_steps + alive)


# -- greedy, sample, stream ----------------------------------------------------
def token_init(B: int, maxlen: int, device, pad: int = SPECIALS["<blank>"],
               sos: int = SPECIALS["<sos>"]) -> torch.Tensor:
    """The token loops' (B, maxlen+1) buffer before step 0: ``<sos>``,
    then ``pad``."""
    toks = torch.full((B, maxlen + 1), pad, dtype=torch.int64,
                      device=device)
    toks[:, 0] = sos
    return toks


def all_ended_t(toks: torch.Tensor,
                eos: int = SPECIALS["<eos>"]) -> torch.Tensor:
    """Whether every row of (B, maxlen+1) ``toks`` has emitted <eos> (the
    token loops' early-stop test), as a 0-d bool tensor."""
    return (toks[:, 1:] == eos).any(dim=1).all()


def all_ended(toks: torch.Tensor, eos: int = SPECIALS["<eos>"]) -> bool:
    """:func:`all_ended_t` read to the host (one device-to-host read)."""
    return bool(all_ended_t(toks, eos))


def token_step(step: Step, l: torch.Tensor, cur: torch.Tensor, self_kv,
               u=None, cfg: DecodeConfig = None) -> torch.Tensor:
    """One greedy (``u`` None) or sampled step at position ``l``: the
    next (B,) token after ``cur``. With ``u``, the step's (B, V)
    uniforms, the draw is :func:`gumbel_pick` over ``cfg``'s
    :func:`sample_transform`. ``self_kv`` is written in place."""
    logp, _ = step(cur, l, self_kv)
    if u is None:
        return torch.argmax(logp, dim=-1)
    return gumbel_pick(sample_transform(logp, cfg), u)


def token_step_at(step: Step, l: torch.Tensor, toks: torch.Tensor, self_kv,
                  u=None, cfg: DecodeConfig = None,
                  alive: torch.Tensor = None, pad: int = SPECIALS["<blank>"],
                  eos: int = SPECIALS["<eos>"]):
    """One position of the greedy or sampled loop on its (B, maxlen+1)
    token buffer: :func:`token_step` after ``toks[:, l]``, written in
    place at ``l + 1``. With ``alive`` (a 0-d bool tensor, or ``True``)
    the exit is on the device, as in JAX's ``lax.while_loop``: ``alive``
    becomes ``alive & ~all_ended_t(toks)`` before the step, and the step
    writes ``pad`` where it is false, which is what the eager loop leaves
    there. Returns ``(toks, alive)``."""
    pos = l.reshape(1)
    if alive is not None:
        alive = alive & ~all_ended_t(toks, eos)
    nxt = token_step(step, l, toks.index_select(1, pos)[:, 0], self_kv, u,
                     cfg)
    if alive is not None:
        nxt = torch.where(alive, nxt, pad)
    toks.index_copy_(1, pos + 1, nxt[:, None])
    return toks, alive


# -- rank ----------------------------------------------------------------------
def rank_inputs(cand: torch.Tensor, sos: int = SPECIALS["<sos>"]):
    """(B, N, L) candidates -> (rows (B·N, L) targets, inputs ``<sos> +
    rows[:, :-1]``)."""
    B, N, L = cand.shape
    rows = cand.reshape(B * N, L)
    inputs = torch.cat([torch.full_like(rows[:, :1], sos), rows[:, :-1]],
                       dim=1)
    return rows, inputs


def rank_step(step: Step, l: torch.Tensor, rows: torch.Tensor,
              inputs: torch.Tensor, lens: torch.Tensor, total: torch.Tensor,
              self_kv) -> torch.Tensor:
    """One teacher-forced position: (R,) ``total`` plus log P(rows[:, l])
    of every row with ``l < lens``, after feeding ``inputs[:, l]``.
    ``self_kv`` is written in place."""
    pos = l.reshape(1)
    logp, _ = step(inputs.index_select(1, pos)[:, 0], l, self_kv)
    tok_lp = torch.gather(logp, 1, rows.index_select(1, pos))[:, 0]
    return total + torch.where(l < lens, tok_lp, 0.0)
