"""Label-smoothed KL loss and the composite MTN objective
(``mtn_tpu/train/loss.py``).

- :func:`label_smoothed_kl`: the smoothed target puts ``1 - smoothing`` on
  the gold token and ``smoothing / (V - 2)`` on every other column but the
  pad column; pad-target rows are zero; the sum includes the target's
  ``Σ td·log td`` term (KLDiv(sum) semantics, ``0·log 0 = 0``).
- :func:`mtn_loss`: ``KL(resp)/ntokens + Σ_i λ·KL(ae_i)/ae_ntokens``, with
  an optional ``norm=`` override of the two token counts (gradient
  accumulation passes the macro-batch counts).

Every row of the smoothed target is one of two fixed distributions (or
zero), so the sum is taken in closed form per row: the entropy term is a
constant per non-pad row, and ``Σ td·logp`` needs only the gold column,
the pad column and the row sum of ``logp``. No (N, V) target tensor is
built; the value and the gradient are those of the JAX function.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch


def _xlogx(a: float) -> float:
    return a * math.log(a) if a > 0 else 0.0


def label_smoothed_kl(logp: torch.Tensor, targets: torch.Tensor, pad: int,
                      smoothing: float) -> torch.Tensor:
    """Sum KL divergence (f32 scalar). logp (..., V) log-probabilities,
    targets (...,) token ids."""
    V = logp.shape[-1]
    logp = logp.reshape(-1, V).float()
    targets = targets.reshape(-1).long()
    confidence = 1.0 - smoothing
    low = smoothing / (V - 2)
    row = (targets != pad).float()
    gold = logp.gather(1, targets[:, None])[:, 0]
    others = logp.sum(dim=1) - logp[:, pad] - gold
    entropy = _xlogx(confidence) + (V - 2) * _xlogx(low)
    return (row * (entropy - confidence * gold - low * others)).sum()


def mtn_loss(resp_logp: torch.Tensor, answer_out: torch.Tensor,
             ae_logps: Sequence[torch.Tensor], ae_targets: torch.Tensor,
             pad: int, smoothing: float, loss_l: float,
             norm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (normalised loss, metrics). ``metrics['loss_x_ntok']`` is
    the reference's epoch accumulator (``loss·ntokens``)."""
    if norm is None:
        ntokens = torch.clamp((answer_out != pad).sum().float(), min=1.0)
        ae_ntokens = torch.clamp((ae_targets != pad).sum().float(), min=1.0)
    else:
        ntokens, ae_ntokens = norm
    loss = label_smoothed_kl(resp_logp, answer_out, pad, smoothing) / ntokens
    for ae_logp in ae_logps:
        loss = loss + loss_l * label_smoothed_kl(
            ae_logp, ae_targets, pad, smoothing) / ae_ntokens
    return loss, {"ntokens": ntokens, "loss": loss,
                  "loss_x_ntok": loss * ntokens}
