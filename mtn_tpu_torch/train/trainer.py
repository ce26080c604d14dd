"""Training and evaluation steps of MTN on one device
(``mtn_tpu/train/trainer.py``).

Parameters. The trainer keeps **f32 master parameters** and Adam's state
in f32 (:class:`TrainState`, keyed by ``state_dict`` name). The model runs
in the compute dtype: each step casts the masters into it, which gives the
values of JAX's f32 params cast per call. A parameter the model holds in
f32 (every one in an f32 model, the norms in a bf16 one) is its own
master, with no copy. Gradients are taken in the model's dtype and
widened to f32 before the update, as JAX's cotangent of the cast is, into
f32 buffers that the trainer keeps from step to step (an f32 parameter's
gradient is accumulated into its buffer by autograd itself).

Steps. :meth:`Trainer.train_step` is one forward, backward and Noam/Adam
update; :meth:`Trainer.train_step_accum` one update from a list of
microbatches, each normalised by the macro-batch token counts so that the
update is the one-big-batch update; :meth:`Trainer.eval_step` the loss
under ``model.eval()`` and ``torch.no_grad()`` (dropout off, so the
kernels run where selected) of the model as last loaded.

Dropout randomness is a pure function of ``(seed, step[, microbatch])``,
as ``jax.random.fold_in(base_rng, step)`` is: each step seeds torch's
generators, inside a forked RNG state, from those numbers, so a run
resumed at a step draws what an uninterrupted run draws there. (JAX's own
bits cannot be reproduced.)

:meth:`Trainer.run_epoch` keeps each step's loss on the device and reads
it a few steps behind (a pinned copy and an event per step on a GPU), so
the host never waits on the step it has just launched.
"""

from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mtn_tpu_torch.config import ModelConfig, TrainConfig
from mtn_tpu_torch.data.vocab import BLANK, SPECIALS
from mtn_tpu_torch.models.mtn import MTN
from mtn_tpu_torch.train.batch import DeviceBatch, batch_masks
from mtn_tpu_torch.train.loss import mtn_loss
from mtn_tpu_torch.train.schedule import AdamState, NoamAdam
from mtn_tpu_torch.utils.profiling import check_finite, step_annotation
from mtn_tpu_torch.weights import init_params

Tensor = torch.Tensor


@dataclass
class TrainState:
    params: Dict[str, Tensor]   # f32 masters, in the model's parameter order
    opt_state: AdamState
    step: int


class EarlyStopper:
    """Patience on the validation loss. Only a strict improvement resets
    it, as only a strict improvement moves the checkpoint's best pointer;
    ``patience <= 0`` never stops."""

    def __init__(self, patience: int):
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0

    def update(self, val_loss: float) -> bool:
        """Record one epoch's validation loss; True means stop now."""
        if val_loss < self.best:
            self.best = val_loss
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        return self.patience > 0 and self.bad_epochs >= self.patience

    def seed_from_meta(self, meta: dict, start_epoch: int) -> None:
        """Carry the best loss and the epochs since it across a resume
        (``meta.json``'s best pointer is the source of truth)."""
        if meta.get("best_loss") is None:
            return
        self.best = float(meta["best_loss"])
        best_epoch = int(meta.get("best_epoch") or 0)
        done = [e for e in meta.get("epochs", []) if e <= start_epoch]
        self.bad_epochs = sum(1 for e in done if e > best_epoch)


def load_opt_state(state: TrainState, opt_state: dict) -> None:
    """Copy Adam's state by parameter name into ``state``, in place."""
    names = list(state.params)
    if set(opt_state["mu"]) != set(names) or \
            set(opt_state["nu"]) != set(names):
        raise KeyError("optimiser state does not match the parameters")
    with torch.no_grad():
        for dst, src in ((state.opt_state.mu, opt_state["mu"]),
                         (state.opt_state.nu, opt_state["nu"])):
            for t, n in zip(dst, names):
                t.copy_(src[n])
    state.opt_state.count = int(opt_state["count"])


def opt_state_by_name(state: TrainState) -> dict:
    """Adam's state by parameter name (the inverse of
    :func:`load_opt_state`), on the device."""
    names = list(state.params)
    o = state.opt_state
    return {"count": o.count, "mu": dict(zip(names, o.mu)),
            "nu": dict(zip(names, o.nu))}


def step_seed(*key: int) -> int:
    """A 64-bit seed that is a pure function of ``key``."""
    return int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0])


class _Pending:
    """One step's (loss·ntokens, ntokens), copied towards the host
    without waiting; :meth:`get` waits for that step only."""

    def __init__(self, metrics: Dict[str, Tensor]):
        vals = torch.stack([metrics["loss_x_ntok"].detach().float(),
                            metrics["ntokens"].detach().float()])
        self.event = None
        if vals.device.type == "cuda":
            self.host = torch.empty(2, pin_memory=True)
            self.host.copy_(vals, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = vals

    def get(self) -> Tuple[float, float]:
        if self.event is not None:
            self.event.synchronize()
        a, b = self.host.tolist()
        return a, b


class Trainer:
    """``nan_checks``: before each update, raise ``FloatingPointError`` if
    the loss or a gradient is not finite (one host sync per step)."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 device, pad: int = SPECIALS[BLANK],
                 nan_checks: bool = False):
        self.device = torch.device(device)
        self.nan_checks = nan_checks
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.pad = pad
        self.model = MTN(model_cfg).to(self.device)
        self.params = [p for _, p in self.model.named_parameters()]
        self.names = [n for n, _ in self.model.named_parameters()]
        self.grads = [torch.zeros(p.shape, dtype=torch.float32,
                                  device=self.device) for p in self.params]
        self.optimizer = NoamAdam(model_cfg.d_model, train_cfg.warmup_steps,
                                  grad_clip=train_cfg.grad_clip)

    # -- state --------------------------------------------------------------
    def init_state(self, seed: int) -> TrainState:
        """Fresh parameters (``init_params`` from ``seed``) and Adam."""
        return self.state_from(init_params(
            self.model_cfg, torch.Generator().manual_seed(seed)))

    def state_from(self, state_dict, opt_state: Optional[dict] = None,
                   step: int = 0) -> TrainState:
        """A state whose masters hold ``state_dict`` (any dtype, any
        device); f32 model parameters are their own masters.
        ``opt_state`` is Adam's state by parameter name (``{"count",
        "mu", "nu"}``, as ``weights.opt_state_from_optax`` gives it);
        None starts Adam afresh."""
        params = {}
        with torch.no_grad():
            for name, p in zip(self.names, self.params):
                src = state_dict[name]
                if p.dtype == torch.float32:
                    p.copy_(src)
                    params[name] = p.detach()
                else:
                    params[name] = torch.empty(
                        p.shape, dtype=torch.float32,
                        device=self.device).copy_(src)
        state = TrainState(params=params, step=step, opt_state=(
            self.optimizer.init(list(params.values()))))
        if opt_state is not None:
            load_opt_state(state, opt_state)
        return state

    def load(self, params: Dict[str, Tensor]) -> None:
        """Cast the masters into the model (parameters that are their own
        masters are skipped)."""
        dst, src = [], []
        for name, p in zip(self.names, self.params):
            m = params[name]
            if m.data_ptr() != p.data_ptr():
                dst.append(p.detach())
                src.append(m)
        if dst:
            with torch.no_grad():
                torch._foreach_copy_(dst, src)

    # -- loss ---------------------------------------------------------------
    def loss_fn(self, batch: DeviceBatch, norm=None):
        """(loss, metrics) of the model as it stands (train or eval
        mode)."""
        masks, tgt_mask = batch_masks(batch, self.pad)
        x, ae_outs = self.model(batch.query, batch.his, batch.cap, batch.fts,
                                masks, batch.answer_in, tgt_mask)
        resp_logp = self.model.generate_logprobs(x)
        ae_logps = self.model.ae_logprobs(ae_outs) if ae_outs else []
        ae_targets = (batch.cap if self.model_cfg.auto_encoder_ft in
                      ("caption", "summary") else batch.query)
        return mtn_loss(resp_logp, batch.answer_out, ae_logps, ae_targets,
                        self.pad, self.train_cfg.label_smoothing,
                        self.train_cfg.loss_l, norm=norm)

    @contextlib.contextmanager
    def _rng(self, *key: int):
        """Seed torch's generators from ``key`` inside a forked state."""
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(step_seed(*key))
            yield

    def loss_and_grads(self, batch: DeviceBatch, key, norm=None,
                       accumulate: bool = False):
        """Forward and backward in train mode; returns (loss, metrics,
        ``self.grads``): the f32 gradients in parameter order, set to this
        batch's, or with ``accumulate`` added to what they held. The next
        call reuses the buffers."""
        self.model.train()
        own = [g for p, g in zip(self.params, self.grads)
               if p.dtype == torch.float32]
        if not accumulate:
            torch._foreach_zero_(own)
        for p, g in zip(self.params, self.grads):
            p.grad = g if p.dtype == torch.float32 else None
        with self._rng(*key):
            loss, metrics = self.loss_fn(batch, norm)
            loss.backward()
        dst, src = [], []
        for p, g in zip(self.params, self.grads):
            if p.dtype != torch.float32:
                if p.grad is not None:
                    dst.append(g)
                    src.append(p.grad)
                elif not accumulate:
                    g.zero_()
            p.grad = None
        if dst:
            (torch._foreach_add_ if accumulate else torch._foreach_copy_)(
                dst, src)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            self.grads

    def _apply(self, state: TrainState, loss: Tensor,
               grads: List[Tensor]) -> None:
        if self.nan_checks:
            check_finite(state.step, loss, grads)
        with torch.no_grad():
            self.optimizer.update(list(state.params.values()), grads,
                                  state.opt_state)
        state.step += 1

    # -- steps --------------------------------------------------------------
    def train_step(self, state: TrainState, batch: DeviceBatch,
                   base_seed: int) -> Tuple[TrainState, dict]:
        """One update; ``state`` is updated in place and returned."""
        self.load(state.params)
        loss, metrics, grads = self.loss_and_grads(batch,
                                                   (base_seed, state.step))
        self._apply(state, loss, grads)
        return state, metrics

    def train_step_accum(self, state: TrainState,
                         micro: List[DeviceBatch],
                         base_seed: int) -> Tuple[TrainState, dict]:
        """One update from a list of microbatches (``accumulated``);
        gradients are summed in f32."""
        self.load(state.params)
        caption = self.model_cfg.auto_encoder_ft in ("caption", "summary")
        count = lambda ts: torch.clamp(
            sum((t != self.pad).sum() for t in ts).float(), min=1.0)
        ntok = count([b.answer_out for b in micro])
        ae_ntok = count([b.cap if caption else b.query for b in micro])
        total = 0.0
        for i, b in enumerate(micro):
            loss, _, grads = self.loss_and_grads(
                b, (base_seed, state.step, i), norm=(ntok, ae_ntok),
                accumulate=i > 0)
            total = total + loss
        self._apply(state, total, grads)
        return state, {"ntokens": ntok, "loss": total,
                       "loss_x_ntok": total * ntok}

    def eval_step(self, batch: DeviceBatch) -> dict:
        """The loss of the model as last loaded (``load``)."""
        self.model.eval()
        with torch.no_grad():
            _, metrics = self.loss_fn(batch)
        return metrics

    # -- epoch loop ---------------------------------------------------------
    def run_epoch(self, state: TrainState, batches,
                  base_seed: Optional[int] = None, train: bool = True,
                  report_fn: Optional[Callable[[int, float, float],
                                               None]] = None,
                  step_callback: Optional[Callable[[TrainState, int],
                                                   None]] = None,
                  step_callback_every: int = 0) -> Tuple[TrainState, float]:
        """Runs over ``batches``: device batches, or lists of them
        (``accumulated``), one update each. Returns (state, the epoch's
        loss per token). Losses are read a few steps behind the step
        being launched."""
        total_loss = total_tokens = tokens = 0.0
        start = time.time()
        interval = self.train_cfg.report_interval
        pending: "collections.deque[_Pending]" = collections.deque()
        last = [0.0, 1.0]   # the last (loss·ntokens, ntokens) read

        def fetch_one():
            nonlocal total_loss, total_tokens, tokens
            last[0], last[1] = pending.popleft().get()
            total_loss += last[0]
            total_tokens += last[1]
            tokens += last[1]

        if not train:
            self.load(state.params)
        for j, batch in enumerate(batches):
            with step_annotation("train_step" if train else "eval_step", j):
                if not train:
                    metrics = self.eval_step(batch)
                elif isinstance(batch, list):   # microbatches: accumulate
                    state, metrics = self.train_step_accum(state, batch,
                                                           base_seed)
                else:
                    state, metrics = self.train_step(state, batch,
                                                     base_seed)
            pending.append(_Pending(metrics))
            while len(pending) > 4:
                fetch_one()
            if train and report_fn and (j + 1) % interval == 0:
                while pending:
                    fetch_one()
                elapsed = max(time.time() - start, 1e-9)
                report_fn(j + 1, last[0] / max(last[1], 1.0),
                          tokens / elapsed)
                start = time.time()
                tokens = 0.0
            if train and step_callback and step_callback_every > 0 and \
                    (j + 1) % step_callback_every == 0:
                step_callback(state, j + 1)
        while pending:
            fetch_one()
        return state, total_loss / max(total_tokens, 1.0)
