"""Each train, accumulation and eval step on a CUDA device as one captured
device program: the counterpart of ``jax.jit`` over ``mtn_tpu``'s
``train_step``, ``accum_step`` (the ``lax.scan`` over microbatches and the
update) and ``eval_step`` (``mtn_tpu/train/trainer.py``).

A :class:`StepGraphs` (one per :class:`~mtn_tpu_torch.train.trainer.
Trainer`) keeps one program set per step shape (:class:`StepPrograms`):
static input buffers, into which each batch (each microbatch) is copied,
and one program, the trainer's step body on them (``_train_body``: the
masters cast into the model, forward, backward and the Noam/Adam update;
``_accum_body``: every microbatch's forward and backward, then the one
update; ``_eval_body``: the loss). The body reads and writes the
trainer's own persistent tensors: the model's parameters, the f32
masters, the gradient buffers, Adam's moments and its device count
(``AdamState.t``); and it draws its dropout masks from the trainer's
generators (``collectives.Draws``), which the graph registers. So a
replay updates the real state in place, and the host's part of a step
stays outside the program, before and after each replay: seeding the
generators and setting the device count (``Trainer._begin``), advancing
the host's counts (``Trainer._end``). Eager and graphed steps run the
same body and give the same bits.

Program sets are keyed by every value that fixes a shape or a branch
(the mode, the batch's tensor shapes and types, the number of
microbatches, the model's config, ``grad_clip``, and the state a train
set updates) and admitted by the decode runner's policy
(:class:`~mtn_tpu_torch.decode.graphs.ProgramCache`): a shape's first
step runs eagerly and a set is built at its second. A training run
without ``--uniform-shapes`` brings one shape for each combination of
its lengths' buckets, dozens of them, each coming back every epoch, so
the sets are many and kept, as ``jax.jit``'s cache keeps every shape it
compiled:

- all sets of a trainer share one memory pool. They replay one at a
  time in stream order, and what outlives a replay (the static inputs,
  the static outputs, the trainer's state) is held and never handed to
  another set, so the pool holds one step's activations, not one per
  set;
- at most ``MAX_PROGRAMS`` sets are kept. A full cache gives the place
  of the set whose shape was seen least often (the least recently used
  of those) only to a shape seen more than twice as often: shapes of
  about equal frequency, as a shuffled epoch brings them, keep the sets
  they have rather than taking turns, and a capture (an eager step and
  ~1 s) is paid for by the replays that follow it.

No update is applied twice or skipped. The step that builds a set runs
once, eagerly, on a side stream: its real update, which also loads the
kernels and warms the allocator and autograd's threads before the
capture. The capture that follows runs nothing (a capture launches no
kernel), and the shape's next step replays the graph. A failure to
capture or to replay raises: nothing falls back to the eager step. On
the CPU the same sets run their body as it is (``capture=False``), the
set's first step included: the CPU tests hold them to the eager trainer
and to JAX, while the trainer's own CPU path stays eager.

The graphs' kernel launches are counted at each replay, as the decode
programs' are (``ops/_build.py``): a capture records them, the
backward's from autograd's device thread too.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from mtn_tpu_torch.decode.graphs import (ProgramCache, ProgramSet,
                                         _signature)

# step sets a trainer keeps (train and eval): stage 2 at DSTC7-AVSD's
# scale brings ~66 train and ~41 eval shapes; at the flagship width, 48
# sets in the shared pool took 2.36 GB of the card beyond the eager run's
# peak and ~59 MB of host memory a set (chip_smoke --train-traffic, H100)
MAX_PROGRAMS = 128
MAX_SEEN = 1024    # step shapes a trainer counts
MARGIN = 2         # how many times as often a shape must be seen to evict


class StepPrograms(ProgramSet):
    """One step shape's static inputs and its program, ``body`` on them.
    With ``capture`` the step that builds the set runs as the capture's
    warm-up, and :meth:`run` returns that step's result once."""

    def __init__(self, body: Callable[[object], Dict[str, torch.Tensor]],
                 batch, capture: bool,
                 generators: Sequence[torch.Generator], pool=None):
        super().__init__(batch, capture, pool)
        self.out: Dict[str, torch.Tensor] = {}
        warm = []

        def program() -> None:
            self.out = body(self.batch)
        self._build([lambda: warm.append(body(self.batch))],
                    {"step": program}, generators)
        self.first: Optional[Dict[str, torch.Tensor]] = (
            warm[0] if warm else None)

    def run(self, batch) -> Dict[str, torch.Tensor]:
        """The step on ``batch``: its metrics, copied out of the static
        outputs (the next replay overwrites them)."""
        if self.first is not None:
            first, self.first = self.first, None
            return first
        self.load(batch)
        self.run_program("step")
        return {k: v.clone() for k, v in self.out.items()}


class StepGraphs(ProgramCache):
    """A trainer's step program sets by key (see the module's
    docstring). ``captures`` counts the sets built, ``eager`` the steps
    refused a set."""

    def __init__(self, capture: bool = True):
        super().__init__(capture, MAX_PROGRAMS, MAX_SEEN, MARGIN)
        self.pool = None

    def _victim(self) -> tuple:
        """The set whose shape was seen least often, the least recently
        used of those."""
        return min(self.sets, key=lambda k: self.seen[k])

    def step(self, key: tuple, batch,
             body: Callable[[object], Dict[str, torch.Tensor]],
             generators: Sequence[torch.Generator] = ()
             ) -> Dict[str, torch.Tensor]:
        """``body(batch)``, through the set of ``key`` and the batch's
        shapes where one is kept or admitted, else eagerly."""
        ps = self._set(key + (_signature(batch),), lambda: StepPrograms(
            body, batch, self.capture, generators, self._pool()))
        if ps is None:
            return body(batch)
        return ps.run(batch)

    def _pool(self):
        """The memory pool every set of this trainer captures into."""
        if self.capture and self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def clear(self) -> None:
        """Drop every set (a new state: the sets update the old one)."""
        self.sets.clear()
