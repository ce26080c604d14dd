"""Noam learning-rate schedule and Adam, as ``optax`` computes them
(``mtn_tpu/train/schedule.py``).

``rate = d_model^-0.5 · min(step^-0.5, step·warmup^-1.5)`` (the JAX
package's ``factor``, which every caller leaves at 1); the
reference increments its step before computing the rate, so update number
``c`` (optax's count, from 0) takes the rate of step ``c + 1``.

:class:`NoamAdam` is ``optax.adam`` at that rate (:func:`noam_rate`),
``b1=0.9, b2=0.98, eps=1e-9``, optionally preceded by
``optax.clip_by_global_norm``, on a list of f32 tensors updated in place
(:meth:`NoamAdam.prepare`, then :meth:`NoamAdam.apply`):

- ``mu = (1 - b1)·g + b1·mu``, ``nu = (1 - b2)·g² + b2·nu``;
- ``u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)`` with ``t`` the
  update number from 1 (eps outside the square root);
- ``p = p - rate·u``.

Clipping leaves the gradients alone when their global L2 norm is below
the limit and otherwise maps each to ``g / norm · limit``. It is not
``torch.nn.utils.clip_grad_norm_``, which divides by ``norm + 1e-6``. The
choice is made on the device (no host sync), and the whole update runs as
``torch._foreach_*`` calls: a few launches for all tensors, not a few per
tensor. The scalars that depend on the update number (rate, bias
corrections) are computed in f32 on the device too, from the 0-d count
``AdamState.t``: no host value enters :meth:`NoamAdam.apply`, so a CUDA
graph that holds it reads each update's count from ``t``, which
:meth:`NoamAdam.prepare` sets from the host's count before the update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

B1, B2, EPS = 0.9, 0.98, 1e-9


def noam_rate(step: torch.Tensor, d_model: int,
              warmup: int) -> torch.Tensor:
    """The rate of reference step ``step`` (an f32 tensor; steps below 1
    count as 1), in f32."""
    step = torch.clamp(step, min=1.0)
    return d_model ** -0.5 * torch.minimum(step ** -0.5,
                                           step * warmup ** -1.5)


@dataclass
class AdamState:
    """Adam's moments (f32, one per parameter, in parameter order), the
    number of updates made (``count``, which checkpoints save) and, on
    the parameters' device, the count the next update reads (``t``, a 0-d
    f32 tensor set by :meth:`NoamAdam.prepare`)."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    t: torch.Tensor


class NoamAdam:
    def __init__(self, d_model: int, warmup: int, grad_clip: float = 0.0):
        self.d_model, self.warmup = d_model, warmup
        self.grad_clip = grad_clip

    @staticmethod
    def init(params: List[torch.Tensor]) -> AdamState:
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params],
                         t=torch.zeros((), dtype=torch.float32,
                                       device=params[0].device))

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

    @staticmethod
    def prepare(state: AdamState) -> None:
        """Set the device count from the host's, before an update."""
        state.t.fill_(state.count)

    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: AdamState, norm: Optional[torch.Tensor] = None) -> None:
        """The update's device work, for update number ``state.t`` (from
        0): the moments and ``params`` in place. ``state.count`` is the
        caller's to advance."""
        if self.grad_clip > 0:
            self.clip(grads, norm)
        t = state.t + 1.0
        bc1 = 1.0 - torch.pow(B1, t)
        bc2 = 1.0 - torch.pow(B2, t)
        rate = noam_rate(t, self.d_model, self.warmup)
        torch._foreach_mul_(state.mu, B1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - B2)
        den = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(state.mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -rate)
        torch._foreach_add_(params, upd)
