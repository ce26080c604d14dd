"""Noam learning-rate schedule and Adam, as ``optax`` computes them
(``mtn_tpu/train/schedule.py``).

``rate = d_model^-0.5 · min(step^-0.5, step·warmup^-1.5)`` (the JAX
package's ``factor``, which every caller leaves at 1); the
reference increments its step before computing the rate, so update number
``c`` (optax's count, from 0) takes the rate of step ``c + 1``.

:class:`NoamAdam` is ``optax.adam(noam_schedule(...), b1=0.9, b2=0.98,
eps=1e-9)``, optionally preceded by ``optax.clip_by_global_norm``, on a
list of f32 tensors updated in place:

- ``mu = (1 - b1)·g + b1·mu``, ``nu = (1 - b2)·g² + b2·nu``;
- ``u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)`` with ``t`` the
  update number from 1 (eps outside the square root);
- ``p = p - rate·u``.

Clipping leaves the gradients alone when their global L2 norm is below
the limit and otherwise maps each to ``g / norm · limit``. It is not
``torch.nn.utils.clip_grad_norm_``, which divides by ``norm + 1e-6``. The
choice is made on the device (no host sync), and the whole update runs as
``torch._foreach_*`` calls: a few launches for all tensors, not a few per
tensor. Scalars that depend only on the step (rate, bias corrections) are
computed in f32 on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.98, 1e-9


def noam_rate(step, d_model: int, warmup: int) -> np.float32:
    """The rate of reference step ``step`` (steps below 1 count as 1)."""
    step = np.maximum(np.float32(step), np.float32(1.0))
    return np.float32(d_model ** -0.5) * np.minimum(
        step ** np.float32(-0.5), step * np.float32(warmup ** -1.5))


def noam_schedule(d_model: int, warmup: int):
    """Update number (from 0) -> rate."""
    return lambda count: noam_rate(np.float32(count) + np.float32(1.0),
                                   d_model, warmup)


@dataclass
class AdamState:
    """Adam's moments (f32, one per parameter, in parameter order) and
    the number of updates made."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class NoamAdam:
    def __init__(self, d_model: int, warmup: int, grad_clip: float = 0.0):
        self.schedule = noam_schedule(d_model, warmup)
        self.grad_clip = grad_clip

    @staticmethod
    def init(params: List[torch.Tensor]) -> AdamState:
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    def clip(self, grads: List[torch.Tensor],
             norm: Optional[torch.Tensor] = None) -> None:
        """``optax.clip_by_global_norm`` in place; ``norm`` is the global
        norm where the caller computes it (gradients held as slabs)."""
        if norm is None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.grad_clip
        one = torch.ones((), device=norm.device)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one *
                                               self.grad_clip))

    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState,
               norm: Optional[torch.Tensor] = None) -> None:
        """One update of ``params`` (f32) from ``grads`` (f32, consumed);
        ``norm`` as for :meth:`clip`."""
        if self.grad_clip > 0:
            self.clip(grads, norm)
        t = state.count + 1
        bc1 = np.float32(1.0) - np.float32(B1) ** np.float32(t)
        bc2 = np.float32(1.0) - np.float32(B2) ** np.float32(t)
        rate = self.schedule(state.count)
        torch._foreach_mul_(state.mu, B1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - B2)
        den = torch._foreach_div(state.nu, float(bc2))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(state.mu, float(bc1))
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -float(rate))
        torch._foreach_add_(params, upd)
        state.count = t
