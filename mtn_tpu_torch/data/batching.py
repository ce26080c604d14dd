"""Length-bucketed batch planning and host-side batch materialization.

The port's own copy of ``mtn_tpu/data/batching.py`` (same plans, same
bucketing, same padding), so both packages decode identical batches:

- examples are sorted by descending (history len, [caption len],
  first-stream feature len, question len, answer len);
- the batch size shrinks for long histories:
  ``bsize = batchsize // (h_len // max_length + 1)``;
- :func:`make_batch` rounds every sequence axis up to a bucket multiple
  and optionally pads the batch axis with all-<blank> rows (``valid``
  marks the real ones);
- ``cut_a`` truncates answers at random with an explicit
  ``np.random.Generator``;
- features come through ``load_features`` (the C++ loader by default,
  and an optional write-once ``FeatureCache``, whose blocks are padded
  on the batch axis in their transfer form).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mtn_tpu_torch.data.dataset import DialogueDataset
from mtn_tpu_torch.data.feature_cache import BF16Feature, QuantFeature
from mtn_tpu_torch.data.features import load_features
from mtn_tpu_torch.data.vocab import BLANK


@dataclass
class BatchPlan:
    vids: List[str]
    qa_ids: List[int]
    x_len: List[int]     # per-stream max frame counts
    h_len: int
    q_len: int
    a_len: int
    c_len: int           # 0 when captions are not separate
    n_seqs: int


def make_batch_indices(data: DialogueDataset, batchsize: int = 100,
                       max_length: int = 20, separate_caption: bool = False
                       ) -> Tuple[List[BatchPlan], int]:
    idxlist = []
    n_streams = len(data.features) if data.features else 0
    for turn in data.turns:
        if n_streams:
            x_len = [data.features.n_frames(i, turn.vid) for i in range(n_streams)]
        else:
            x_len = [0]
        entry = (turn.vid, turn.qa_id, x_len, len(turn.history),
                 len(turn.question), len(turn.answer_in),
                 len(turn.caption) if separate_caption else 0)
        idxlist.append(entry)
    if batchsize > 1:
        if separate_caption:
            idxlist.sort(key=lambda s: (-s[3], -s[6], -s[2][0], -s[4], -s[5]))
        else:
            idxlist.sort(key=lambda s: (-s[3], -s[2][0], -s[4], -s[5]))
    n_samples = len(idxlist)
    plans: List[BatchPlan] = []
    bs = 0
    while bs < n_samples:
        in_len = idxlist[bs][3]
        bsize = int(batchsize / int(in_len / max_length + 1))
        be = min(bs + bsize, n_samples) if bsize > 0 else bs + 1
        chunk = idxlist[bs:be]
        plans.append(BatchPlan(
            vids=[s[0] for s in chunk],
            qa_ids=[s[1] for s in chunk],
            x_len=[max(s[2][j] for s in chunk) for j in range(len(chunk[0][2]))],
            h_len=max(s[3] for s in chunk),
            q_len=max(s[4] for s in chunk),
            a_len=max(s[5] for s in chunk),
            c_len=max(s[6] for s in chunk) if separate_caption else 0,
            n_seqs=be - bs,
        ))
        bs = be
    return plans, n_samples


def uniform_plans(plans: List[BatchPlan]) -> List[BatchPlan]:
    """Pad every plan's lengths to the global maxima (the generate CLI's
    --uniform-shapes law; bucket rounding happens later in make_batch)."""
    if not plans:
        return plans
    h = max(p.h_len for p in plans)
    q = max(p.q_len for p in plans)
    a = max(p.a_len for p in plans)
    c = max(p.c_len for p in plans)
    x = [max(p.x_len[i] for p in plans)
         for i in range(len(plans[0].x_len))]
    return [replace(p, h_len=h, q_len=q, a_len=a, c_len=c, x_len=list(x))
            for p in plans]


@dataclass
class HostBatch:
    """One padded batch on the host (numpy), ready for the device.

    Text arrays are (B, L) int32 padded with ``<blank>``; features are
    zero-padded (B, T, D) float32 with explicit frame counts, or a
    feature cache's :class:`BF16Feature` / :class:`QuantFeature` blocks.
    ``valid`` marks real rows when the batch axis was padded to a static
    size.
    """

    query: np.ndarray
    his: np.ndarray
    answer_in: np.ndarray
    answer_out: np.ndarray
    cap: Optional[np.ndarray]
    fts: List[np.ndarray]
    fts_len: List[np.ndarray]
    valid: np.ndarray
    qa_ids: List[int] = field(default_factory=list)


def _round_up(n: int, m: int) -> int:
    return n if m <= 1 else -(-n // m) * m


def pad_seqs(seqs: Sequence[np.ndarray], length: int, pad: int,
             rows: int) -> np.ndarray:
    out = np.full((rows, length), pad, dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out


def cut_answer(answer_in: np.ndarray, answer_out: np.ndarray,
               rng: np.random.Generator, cut_a_p: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    if len(answer_in) > 1 and rng.uniform() >= (1.0 - cut_a_p):
        end = int(rng.integers(1, len(answer_in)))
        answer_out = np.concatenate(
            (answer_in[1:end], [answer_in[end]])).astype(np.int32)
        answer_in = answer_in[:end]
    return answer_in, answer_out


def make_batch(data: DialogueDataset, plan: BatchPlan,
               separate_caption: bool = False,
               skip: Sequence[int] = (1, 1, 1), cut_a: bool = False,
               cut_a_p: float = 0.5, rng: Optional[np.random.Generator] = None,
               length_bucket: int = 1, feature_bucket: int = 1,
               pad_rows_to: int = 0, use_native_loader: bool = True,
               feature_cache=None) -> HostBatch:
    pad = data.vocab[BLANK]
    n = plan.n_seqs
    rows = max(n, pad_rows_to) if pad_rows_to else n
    h, q, a_in, a_out, caps = [], [], [], [], []
    for qa_id in plan.qa_ids:
        turn = data.turns[qa_id]
        ain, aout = turn.answer_in, turn.answer_out
        if cut_a:
            ain, aout = cut_answer(ain, aout, rng or np.random.default_rng(),
                                   cut_a_p)
        h.append(turn.history)
        q.append(turn.question)
        a_in.append(ain)
        a_out.append(aout)
        if separate_caption:
            caps.append(turn.caption)
    # cut_a can only shorten answers, so the plan's a_len stays an upper bound
    h_len = _round_up(plan.h_len, length_bucket)
    q_len = _round_up(plan.q_len, length_bucket)
    a_len = _round_up(plan.a_len, length_bucket)
    batch = HostBatch(
        query=pad_seqs(q, q_len, pad, rows),
        his=pad_seqs(h, h_len, pad, rows),
        answer_in=pad_seqs(a_in, a_len, pad, rows),
        answer_out=pad_seqs(a_out, a_len, pad, rows),
        cap=(pad_seqs(caps, _round_up(max(plan.c_len, 1), length_bucket), pad,
                      rows) if separate_caption else None),
        fts=[], fts_len=[],
        valid=(np.arange(rows) < n),
        qa_ids=list(plan.qa_ids),
    )
    if data.features is not None:
        max_frames = [_round_up(x, feature_bucket) for x in plan.x_len]
        fts, lens = load_features(data.features, plan.vids, max_frames, skip,
                                  use_native=use_native_loader,
                                  cache=feature_cache)
        if rows > n:
            fts = [f.pad_rows(rows) if isinstance(f, (QuantFeature,
                                                      BF16Feature))
                   else np.concatenate(
                       [f, np.zeros((rows - n,) + f.shape[1:], f.dtype)])
                   for f in fts]
            lens = [np.concatenate(
                [l, np.zeros((rows - n,), l.dtype)]) for l in lens]
        batch.fts, batch.fts_len = fts, lens
    return batch
