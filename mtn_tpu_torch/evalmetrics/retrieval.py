"""Retrieval metrics for discriminative answer ranking (VisDial protocol).

The reference's visdial branch evaluates MTN discriminatively: at each
test turn the model ranks 100 answer options by generative log-likelihood
(reference readme.md:81-86) and is scored with the standard VisDial
retrieval metrics — Recall@1/5/10, mean rank, and mean reciprocal rank
over the rank of the ground-truth option. This module provides those
metrics over the score lists ``BeamDecoder.rank_batch`` returns.

Tie law (documented choice): the ground truth's rank is
``1 + #{j != gt : score_j > score_gt}`` — candidates scoring strictly
higher than the ground truth outrank it; exact ties do not. This is the
deterministic, candidate-order-independent reading of "rank by score";
implementations that sort with an arbitrary tie order can differ by the
tie count on exactly-tied floats.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def rank_of(scores: Sequence[float], gt_index: int) -> int:
    """1-indexed rank of ``scores[gt_index]`` under descending score."""
    if not 0 <= gt_index < len(scores):
        raise IndexError(f"gt_index {gt_index} out of {len(scores)} options")
    gt = scores[gt_index]
    return 1 + sum(1 for j, s in enumerate(scores)
                   if j != gt_index and s > gt)


def retrieval_metrics(gt_ranks: Sequence[int]) -> Dict[str, float]:
    """VisDial metric block from per-turn ground-truth ranks (1-indexed).

    Returns ``{"r@1", "r@5", "r@10", "mean_rank", "mrr"}``.
    """
    ranks: List[int] = [int(r) for r in gt_ranks]
    if not ranks:
        raise ValueError("no ranks given")
    if any(r < 1 for r in ranks):
        raise ValueError("ranks are 1-indexed; got a rank < 1")
    n = float(len(ranks))
    return {
        "r@1": sum(r <= 1 for r in ranks) / n,
        "r@5": sum(r <= 5 for r in ranks) / n,
        "r@10": sum(r <= 10 for r in ranks) / n,
        "mean_rank": sum(ranks) / n,
        "mrr": sum(1.0 / r for r in ranks) / n,
    }
