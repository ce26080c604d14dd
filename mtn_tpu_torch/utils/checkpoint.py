"""Training checkpoints with full resume (``mtn_tpu/utils/checkpoint.py``,
same rules, the port's files).

Under ``<prefix>_torch/``:

- ``epoch_<e>.pt``: the f32 ``state_dict``, the file that
  ``weights.load_checkpoint`` and ``python -m mtn_tpu_torch.cli.generate``
  read;
- ``epoch_<e>.opt.pt``: Adam's moments and count and the step;
- ``step_latest.pt``: one rotating mid-epoch slot holding both, written
  to a temporary file and then renamed;
- ``meta.json``: ``epochs``, ``best_epoch`` and ``best_loss`` (the best
  pointer moves only on a strict improvement of the validation loss), and
  for the step slot ``step``, ``step_epoch`` and ``step_batch``.

``save(..., keep=k)`` prunes all but the last ``k`` epochs, never the
best.

With ``async_save`` a save copies the state off the device (so training
may reuse its buffers at once) and writes the files on a background
thread; the ``meta.json`` commit, the step slot's rename and the prune
wait for the next checkpoint operation (any save, restore or meta read)
or :meth:`CheckpointManager.flush`, which the train CLI calls at exit.
The files are those of a blocking save; only what a crash leaves
differs (the last epoch's files on disk, unreferenced by ``meta.json``).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from mtn_tpu_torch.train.trainer import (TrainState, load_opt_state,
                                         opt_state_by_name)
from mtn_tpu_torch.weights import save_conf


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).clone()


class CheckpointManager:
    def __init__(self, model_prefix: str, async_save: bool = False):
        self.prefix = model_prefix
        self.dir = os.path.abspath(model_prefix + "_torch")
        os.makedirs(self.dir, exist_ok=True)
        self._meta_path = os.path.join(self.dir, "meta.json")
        self.async_save = async_save
        # an async save in flight: (writer thread, its errors, the commit)
        self._pending: Optional[Tuple[threading.Thread, List[BaseException],
                                      Callable[[], None]]] = None

    def _write(self, files: List[Tuple[Any, str]],
               commit: Callable[[], None]) -> None:
        """Write ``(object, path)`` pairs, then ``commit``; under
        ``async_save`` the writes run on a thread and the commit waits for
        the next checkpoint operation."""
        self.flush()
        if not self.async_save:
            for obj, path in files:
                self._save_atomic(obj, path)
            commit()
            return
        errors: List[BaseException] = []

        def writer():
            try:
                for obj, path in files:
                    self._save_atomic(obj, path)
            except BaseException as e:   # re-raised by flush()
                errors.append(e)
        thread = threading.Thread(target=writer, daemon=True)
        thread.start()
        self._pending = (thread, errors, commit)

    def flush(self) -> None:
        """Wait for an async save's writes, then run its commit: the last
        save is durable and in ``meta.json`` (call before exit)."""
        if self._pending is None:
            return
        (thread, errors, commit), self._pending = self._pending, None
        thread.join()
        if errors:
            raise errors[0]
        commit()

    # -- sidecars -----------------------------------------------------------
    def save_conf(self, vocab: dict, **config_sections) -> None:
        save_conf(self.prefix, vocab, **config_sections)

    # -- meta ---------------------------------------------------------------
    def meta(self) -> dict:
        self.flush()   # a read sees any save in flight committed
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                return json.load(f)
        return {}

    def _write_meta(self, meta: dict) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path)

    def best_epoch(self):
        return self.meta().get("best_epoch")

    def latest_epoch(self):
        eps = self.meta().get("epochs", [])
        return eps[-1] if eps else None

    # -- files --------------------------------------------------------------
    def _params_path(self, epoch) -> str:
        return os.path.join(self.dir, f"epoch_{epoch}.pt")

    def _opt_path(self, epoch) -> str:
        return os.path.join(self.dir, f"epoch_{epoch}.opt.pt")

    @staticmethod
    def _opt_payload(state: TrainState) -> Dict[str, Any]:
        opt = opt_state_by_name(state)
        return {"step": state.step, "count": opt["count"],
                "mu": {n: _cpu(t) for n, t in opt["mu"].items()},
                "nu": {n: _cpu(t) for n, t in opt["nu"].items()}}

    @staticmethod
    def _params_payload(state: TrainState) -> Dict[str, torch.Tensor]:
        return {n: _cpu(t) for n, t in state.params.items()}

    @staticmethod
    def _save_atomic(obj, path: str) -> None:
        tmp = path + ".tmp"
        torch.save(obj, tmp)
        os.replace(tmp, path)

    @staticmethod
    def _load_into(state: TrainState, params: Dict[str, torch.Tensor],
                   opt: Dict[str, Any]) -> TrainState:
        """Copy a saved state into ``state``'s tensors, in place (a master
        that is a model parameter stays one)."""
        if set(params) != set(state.params):
            raise KeyError("checkpoint parameters do not match the model")
        with torch.no_grad():
            for n, t in state.params.items():
                t.copy_(params[n])
        load_opt_state(state, opt)
        state.step = int(opt["step"])
        return state

    # -- epochs -------------------------------------------------------------
    def save(self, epoch: int, state: TrainState,
             val_loss: Optional[float] = None, keep: int = 0) -> None:
        self._write([(self._params_payload(state), self._params_path(epoch)),
                     (self._opt_payload(state), self._opt_path(epoch))],
                    lambda: self._commit_epoch(epoch, val_loss, keep))

    def _commit_epoch(self, epoch: int, val_loss: Optional[float],
                      keep: int) -> None:
        """The meta/best-pointer update and the prune of a written epoch."""
        meta = self.meta()
        meta["epochs"] = sorted(set(meta.get("epochs", []) + [epoch]))
        if val_loss is not None and (meta.get("best_loss") is None
                                     or val_loss < meta["best_loss"]):
            meta["best_loss"] = val_loss
            meta["best_epoch"] = epoch
        if keep > 0:
            pruned = [e for e in meta["epochs"][:-keep]
                      if e != meta.get("best_epoch")]
            for e in pruned:
                for path in (self._params_path(e), self._opt_path(e)):
                    if os.path.exists(path):
                        os.remove(path)
            meta["epochs"] = [e for e in meta["epochs"] if e not in pruned]
        self._write_meta(meta)

    def restore(self, state: TrainState, epoch="best"
                ) -> Tuple[TrainState, Any]:
        """Load epoch ``epoch`` ("best", "latest" or a number) into
        ``state``; returns (state, epoch)."""
        if epoch == "best":
            epoch = self.best_epoch()
        elif epoch == "latest":
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        epoch = int(epoch)
        load = lambda p: torch.load(p, map_location="cpu", weights_only=True)
        return self._load_into(state, load(self._params_path(epoch)),
                               load(self._opt_path(epoch))), epoch

    # -- the mid-epoch slot ---------------------------------------------------
    def save_step(self, state: TrainState, epoch: int,
                  batch_idx: int = 0) -> None:
        """The rotating step slot: ``batch_idx`` batches of ``epoch`` are
        consumed. The epoch shuffle and the ``cut_a`` draws are keyed by
        (seed, epoch[, batch]) and dropout by (seed, step), so a run
        resumed from it repeats an uninterrupted run."""
        path = os.path.join(self.dir, "step_latest.pt")
        step = state.step

        def commit():
            os.replace(path + ".next", path)
            meta = self.meta()
            meta["step"] = step
            meta["step_epoch"] = epoch
            meta["step_batch"] = int(batch_idx)
            self._write_meta(meta)
        self._write([({"params": self._params_payload(state),
                       "opt": self._opt_payload(state)}, path + ".next")],
                    commit)

    def restore_step(self, state: TrainState):
        """Returns (state, epoch of the interruption, batches consumed)."""
        self.flush()
        path = os.path.join(self.dir, "step_latest.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no step checkpoint under {self.dir}")
        saved = torch.load(path, map_location="cpu", weights_only=True)
        state = self._load_into(state, saved["params"], saved["opt"])
        meta = self.meta()
        return state, meta.get("step_epoch", 0), meta.get("step_batch", 0)
